// The receiver-side walk that kernels D and E share (csrc/pair_fwd.cu,
// csrc/pair_bwd.cu).
//
// One warp per receiver slot row i (bin b).  The half stencil's tables
// (nbr, inv, shift: (S, B)) are walked as the FULL stencil, 2S - 1 offsets
// in this fixed order:
//   o = 0            the zero offset: candidate bin b itself, shift[0, b];
//   o = h, 0 < h < S  upper half:  candidate bin n = nbr[h, b], shift[h, b];
//   o = S - 1 + h     lower half, the mirror of h: n = inv[h, b] (the bin
//                     whose step h has b as its candidate), and the pair is
//                     the half stencil's pair (j receiver, i candidate), so
//                     its displacement is taken from that side,
//                     -((x_i + shift[h, n]) - x_j), rounded as there.
// So each unordered pair is met from both ends and every output is the
// receiver's own row.  An offset whose candidate bin's box of real atoms
// (Args::box) lies beyond the cutoff of the receiver is skipped.  Per offset
// each lane tests one candidate slot of 32 (real, not the zero offset's self
// pair, d < cutoff, with the plain version's rounding: no fused
// multiply-add, and d2 < d2_limit(cutoff) in place of the square root); a
// ballot appends the passing
// (offset, slot) entries to the warp's queue in shared memory in slot
// order.  Whenever 32 entries are queued, the warp hands them to the
// term, one pair a lane; the rest at the end.  Masks are tested, so no slot
// order is assumed; every sum runs in a fixed order and there are no
// atomics, so a repeated call is identical bit for bit.
//
// Per pair (i receiver, j candidate), with c_ij = p_i . r_j (1 for a term
// without vectors) and g = g(d, s_i, s_j) (terms are symmetric in s; s is
// NS scalars an atom, and each has its adjoint):
//   o = 0:      out_i += c_ij g;  the loss holds ct_i c_ij g + ct_j c_ji g
//   o upper:    out_i += c_ij g;  the pair cotangent is ct_i + ct_j on c_ij
//   o lower:    out_i += c_ji g;  the pair cotangent is ct_i + ct_j on c_ji
// so with cp the cotangent on c_ij and cq that on c_ji (cp = ct_i, cq = ct_j
// at o = 0; cp = ct_i + ct_j, cq = 0 upper; cp = 0, cq = ct_i + ct_j lower)
// and e = cp c_ij + cq c_ji, the receiver's adjoints are
//   grad_coord_i -= e dg/dd (x_j' - x_i)/d,   grad_s_i += e dg/ds_i,
//   grad_p_i += cp g r_j,                     grad_r_i += cq g p_j,
// and the lattice-shift adjoint of half offset h (the shift rides on the
// candidate of the half view) gets cp c_ij dg/dd (x_j' - x_i)/d from the
// zero offset and the upper half only; a segmented scan over the batch
// (entries are in offset order) adds each offset's share to a per-warp row
// in shared memory, written out per receiver as (S, 3).
//
// The member form (a term of pair_terms.cuh with kMaxMembers; E members at
// run time, E <= kMaxMembers): the extras are scalars only, [shared, member
// 0, ..., member E-1], and every receiver has E outputs, out (B*C, E) and
// ct (B*C, E).  Per pair the shared factor (geo) is computed once and each
// member's value from it; each lane keeps E partial sums, finished by one
// butterfly per member.  The terms are not bilinear, so every kind of
// offset takes the pair cotangent e_m = ct_i,m + ct_j,m, and
//   grad_coord_i -= sum_m e_m dg_m/dd (x_j' - x_i)/d,
//   grad_m_i,m += e_m dg_m/dm_i,m,   grad_sh_i += sum_m e_m dg_m/dsh_i,
// with the shift rows as above (cp_m = ct_i,m at o = 0, e_m on the upper
// half, 0 on the lower).
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "pair_terms.cuh"

namespace pair_walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // receiver rows a block: one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kQueue = 64;    // one batch of 32 plus one ballot's worth
constexpr int kMaxCols = 3;   // vector columns a lane owns in E: V <= 96
constexpr int kMaxV = 32 * kMaxCols;
constexpr int kAhead = 4;     // candidate rows E loads ahead of their sums

// Whether a term is a member form, and its largest member count (1 for a
// single-model term).
template <class T, class = void>
struct MemberForm {
  static constexpr bool value = false;
  static constexpr int members = 1;
};
template <class T>
struct MemberForm<T, std::void_t<decltype(T::kMaxMembers)>> {
  static constexpr bool value = true;
  static constexpr int members = T::kMaxMembers;
};

// The functor's g and its receiver-side derivatives for NS scalars an atom:
// a functor of one scalar takes floats, one of several arrays.
template <class Term>
__device__ __forceinline__ float term_g(const TermConsts& k, float d, const float* si,
                                        const float* sj) {
  if constexpr (Term::kScalars == 1) {
    return Term::g(k, d, si[0], sj[0]);
  } else {
    return Term::g(k, d, si, sj);
  }
}

template <class Term>
__device__ __forceinline__ void term_grad(const TermConsts& k, float d, const float* si,
                                          const float* sj, float& g, float& gd, float* gsi) {
  if constexpr (Term::kScalars == 1) {
    float gsj;
    Term::grad(k, d, si[0], sj[0], g, gd, gsi[0], gsj);
  } else {
    Term::grad(k, d, si, sj, g, gd, gsi);
  }
}

struct Args {
  TermConsts tc;
  const float* coord;     // (B*C, 3)
  const float* mask;      // (B*C)
  const float* ext;       // (B*C, K) = [p (V), r (V), s (NS)]
  const float* shift;     // (S, B, 3) half stencil
  const int* nbr;         // (S, B) half stencil, -1 = no candidate
  const long long* inv;   // (S, B) inverse of nbr, B (or -1) = none
  const float* box;       // (B, 6) each bin's real atoms' box [lo (3), hi (3)]
  const float* ct;        // (B*C[, E]) cotangent of the sums (E)
  float* out;             // (B*C[, E]) sums (D)
  float* gc;              // (B*C, 3) coordinate adjoint (E)
  float* ge;              // (B*C, K) extras adjoint (E)
  float* gs_rows;         // (B*C, S, 3) lattice-shift adjoint rows (E)
  int* pair_count;        // (B*C) or null: ordered pairs each row contracted
  float d2_max;           // d < cutoff exactly when d^2 < d2_max (d2_limit)
  int B, C, K, S;
  int E;                  // members of a member form (0: a single-model term)
};

// The least float x with sqrtf(x) >= c.  sqrtf is correctly rounded on the
// host and the card, so sqrtf(d2) < c exactly when d2 < d2_limit(c): the
// distance test without a square root.  d2_limit(inf) is inf (the first
// loop stops at once: sqrtf of the largest float is finite), so an
// unbounded sweep tests every finite d2 true and prunes no offset.
inline float d2_limit(float c) {
  float x = c * c;
  while (x > 0.0f && std::sqrt(std::nextafter(x, 0.0f)) >= c) x = std::nextafter(x, 0.0f);
  while (std::sqrt(x) < c) x = std::nextafter(x, INFINITY);
  return x;
}

// 32-bit words of one warp's shared memory; kernels/pair_sweep.py::
// smem_bytes computes the same number.
__host__ __device__ inline int warp_words(int K, int S, bool adjoint) {
  return 5 * kQueue + K + (adjoint ? 3 * S : 0);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The plain version's distance: ((dx dx + dy dy) + dz dz), each rounded.
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <class Term, bool kAdjoint, int M>  // M: vector columns a lane owns in E
__global__ void __launch_bounds__(kThreads) pair_kernel(const Args a) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + w;
  const int B = a.B, C = a.C, K = a.K, S = a.S;
  if (row >= B * C) return;  // whole warps only; no block barrier below
  constexpr int NS = Term::kScalars;
  constexpr bool kMem = MemberForm<Term>::value;  // one output per member
  constexpr int EM = MemberForm<Term>::members;
  const int E = kMem ? a.E : 1;
  const int V = kMem ? 0 : (K - NS) / 2;
  float* qx = smem + w * warp_words(K, S, kAdjoint);
  float* qy = qx + kQueue;
  float* qz = qy + kQueue;
  int* qj = reinterpret_cast<int*>(qz + kQueue);  // candidate slot row
  int* qo = qj + kQueue;                          // full offset index
  float* rec = reinterpret_cast<float*>(qo + kQueue);  // the receiver's extras
  float* srow = rec + K;  // E: (S, 3) shift rows

  if (!(a.mask[row] > 0.5f)) {  // a padding receiver: zeros
    if (kAdjoint) {
      for (int t = lane; t < 3; t += 32) a.gc[size_t(row) * 3 + t] = 0.0f;
      for (int t = lane; t < K; t += 32) a.ge[size_t(row) * K + t] = 0.0f;
      for (int t = lane; t < 3 * S; t += 32) a.gs_rows[size_t(row) * 3 * S + t] = 0.0f;
    } else if (kMem) {
      for (int t = lane; t < E; t += 32) a.out[size_t(row) * E + t] = 0.0f;
    } else if (lane == 0) {
      a.out[row] = 0.0f;
    }
    if (a.pair_count != nullptr && lane == 0) a.pair_count[row] = 0;
    return;
  }

  const int b = row / C;
  const int i = row - b * C;
  const float xi = a.coord[3 * size_t(row) + 0];
  const float yi = a.coord[3 * size_t(row) + 1];
  const float zi = a.coord[3 * size_t(row) + 2];
  const float cti = kAdjoint && !kMem ? a.ct[row] : 0.0f;
  float ctm[EM];  // the member form's receiver cotangents
#pragma unroll
  for (int m = 0; m < EM; ++m) ctm[m] = kAdjoint && kMem && m < E ? a.ct[size_t(row) * E + m] : 0.0f;
  for (int k = lane; k < K; k += 32) rec[k] = a.ext[size_t(row) * K + k];
  if (kAdjoint) {
    for (int t = lane; t < 3 * S; t += 32) srow[t] = 0.0f;
  }
  __syncwarp();
  float si[NS];
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    if constexpr (kMem) {
      si[t] = t < K ? rec[t] : 0.0f;  // K = kShared + E kPer scalars
    } else {
      si[t] = rec[2 * V + t];
    }
  }
  // an offset whose candidate box lies beyond the cutoff is skipped: a
  // margin far above the rounding of the slot tests keeps this exact
  const float prune_d2 = 1.0001f * a.d2_max + 1e-6f;

  // this lane's partial sums over its pairs, finished by one butterfly
  float acc_o = 0.0f, acc_x = 0.0f, acc_y = 0.0f, acc_z = 0.0f, acc_s[NS], acc_m[EM];
#pragma unroll
  for (int t = 0; t < NS; ++t) acc_s[t] = 0.0f;
#pragma unroll
  for (int m = 0; m < EM; ++m) acc_m[m] = 0.0f;
  constexpr int kM = M > 0 ? M : 1;
  float padj[kM], radj[kM];  // E, bilinear: columns lane + 32 m
#pragma unroll
  for (int m = 0; m < kM; ++m) padj[m] = radj[m] = 0.0f;
  int nq = 0;     // queued entries (warp-uniform)
  int npair = 0;  // pairs contracted

  // The term on queue entries [0, nb), one a lane.
  auto batch = [&](const int nb) {
    const bool on = lane < nb;
    const int o = on ? qo[lane] : -1;
    const int jr = on ? qj[lane] : 0;
    float shx = 0.0f, shy = 0.0f, shz = 0.0f, wp = 0.0f, wr = 0.0f;
    if (on) {
      const float dx = qx[lane], dy = qy[lane], dz = qz[lane];
      const float d = sqrtf(dist2(dx, dy, dz));
      const int kind = o == 0 ? 0 : (o < S ? 1 : 2);
      const float* er = a.ext + size_t(jr) * K;  // the candidate's [p, r, s]
      float sj[NS];
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        if constexpr (kMem) {
          sj[t] = t < K ? __ldg(er + t) : 0.0f;
        } else {
          sj[t] = __ldg(er + 2 * V + t);
        }
      }
      if constexpr (kMem) {
        constexpr int NH = Term::kShared, NP = Term::kPer;
        const auto geo = Term::geo(a.tc, d, si, sj);
        if (!kAdjoint) {
#pragma unroll
          for (int m = 0; m < EM; ++m) {
            if (m < E) acc_m[m] += Term::val(geo, si + NH + m * NP, sj + NH + m * NP);
          }
        } else {
          float gdsum = 0.0f, fssum = 0.0f;
#pragma unroll
          for (int m = 0; m < EM; ++m) {
            if (m < E) {
              float g, gd, gm[NP], gh[NH > 0 ? NH : 1];
              Term::grad(geo, si, si + NH + m * NP, sj + NH + m * NP, g, gd, gm, gh);
              const float e = ctm[m] + __ldg(a.ct + size_t(jr) * E + m);
              gdsum += e * gd;
              fssum += (kind == 0 ? ctm[m] : (kind == 1 ? e : 0.0f)) * gd;  // cp_m
#pragma unroll
              for (int t = 0; t < NP; ++t) acc_s[NH + m * NP + t] += e * gm[t];
#pragma unroll
              for (int t = 0; t < NH; ++t) acc_s[t] += e * gh[t];
            }
          }
          const float fd = gdsum / d;
          acc_x -= fd * dx;
          acc_y -= fd * dy;
          acc_z -= fd * dz;
          const float fs = fssum / d;  // 0 on the lower half
          shx = fs * dx;
          shy = fs * dy;
          shz = fs * dz;
        }
      } else {
      float cij = 1.0f, cji = 1.0f;
      if (Term::kBilinear) {  // the products the pair needs: c_ij, c_ji or both
        cij = 0.0f;
        cji = 0.0f;
        if (kAdjoint ? kind < 2 : kind != 2) {
#pragma unroll 4
          for (int k = 0; k < V; ++k) cij = fmaf(rec[k], __ldg(er + V + k), cij);
        }
        if (kAdjoint ? kind != 1 : kind == 2) {
#pragma unroll 4
          for (int k = 0; k < V; ++k) cji = fmaf(__ldg(er + k), rec[V + k], cji);
        }
      }
      if (!kAdjoint) {
        acc_o += (kind == 2 ? cji : cij) * term_g<Term>(a.tc, d, si, sj);
      } else {
        const float ctj = a.ct[jr];
        float g, gd, gsi[NS];
        term_grad<Term>(a.tc, d, si, sj, g, gd, gsi);
        const float cp = kind == 0 ? cti : (kind == 1 ? cti + ctj : 0.0f);  // on c_ij
        const float cq = kind == 0 ? ctj : (kind == 2 ? cti + ctj : 0.0f);  // on c_ji
        const float e = cp * cij + cq * cji;
        const float fd = e * gd / d;
        acc_x -= fd * dx;
        acc_y -= fd * dy;
        acc_z -= fd * dz;
#pragma unroll
        for (int t = 0; t < NS; ++t) acc_s[t] += e * gsi[t];
        const float fs = cp * cij * gd / d;  // 0 on the lower half
        shx = fs * dx;
        shy = fs * dy;
        shz = fs * dz;
        wp = cp * g;
        wr = cq * g;
      }
      }  // single-model term
    }
    if (kAdjoint) {
      // the shift rows: a segmented inclusive scan over runs of one offset
      // (the queue is in offset order), added by each run's last lane
#pragma unroll
      for (int delta = 1; delta < 32; delta <<= 1) {
        const float ux = __shfl_up_sync(kFull, shx, delta);
        const float uy = __shfl_up_sync(kFull, shy, delta);
        const float uz = __shfl_up_sync(kFull, shz, delta);
        const int uo = __shfl_up_sync(kFull, o, delta);
        if (lane >= delta && uo == o) {
          shx += ux;
          shy += uy;
          shz += uz;
        }
      }
      const int next = __shfl_down_sync(kFull, o, 1);
      if (on && o < S && (lane == nb - 1 || next != o)) {
        srow[3 * o + 0] += shx;
        srow[3 * o + 1] += shy;
        srow[3 * o + 2] += shz;
      }
      if (Term::kBilinear) {  // the vector adjoints: lanes over columns
        float bp[kM], br[kM];  // this batch's sums, then the running ones
#pragma unroll
        for (int m = 0; m < kM; ++m) bp[m] = br[m] = 0.0f;
        for (int q0 = 0; q0 < nb; q0 += kAhead) {
          // kAhead pairs' candidate rows (warp-wide contiguous loads) in
          // flight together
          float vp[kAhead][kM], vr[kAhead][kM], wpq[kAhead], wrq[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            const bool live = q0 + u < nb;
            const float* row = a.ext + size_t(__shfl_sync(kFull, jr, q0 + u)) * K;
            wpq[u] = __shfl_sync(kFull, wp, q0 + u);
            wrq[u] = __shfl_sync(kFull, wr, q0 + u);
#pragma unroll
            for (int m = 0; m < kM; ++m) {
              const int col = lane + 32 * m;
              vp[u][m] = live && col < V ? __ldg(row + V + col) : 0.0f;
              vr[u][m] = live && col < V ? __ldg(row + col) : 0.0f;
            }
          }
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
#pragma unroll
            for (int m = 0; m < kM; ++m) {
              bp[m] = fmaf(wpq[u], vp[u][m], bp[m]);
              br[m] = fmaf(wrq[u], vr[u][m], br[m]);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          padj[m] += bp[m];
          radj[m] += br[m];
        }
      }
    }
    __syncwarp();  // the batch's reads are done before the queue moves
  };

  const int O = 2 * S - 1;
  for (int o0 = 0; o0 < O; o0 += 32) {
    // lane t holds offset o0 + t's candidate bin and shift, so the table
    // reads are not a chain of dependent loads
    const int ol = o0 + lane;
    int nl = -1;
    float sl0 = 0.0f, sl1 = 0.0f, sl2 = 0.0f;
    if (ol < O) {
      int h = ol, src = b;
      if (ol < S) {
        nl = a.nbr[size_t(h) * B + b];
      } else {
        h = ol - S + 1;
        const long long v = a.inv[size_t(h) * B + b];
        nl = (v >= 0 && v < B) ? int(v) : -1;
        src = nl;
      }
      if (nl >= 0) {
        const float* sh = a.shift + (size_t(h) * B + src) * 3;
        sl0 = sh[0];
        sl1 = sh[1];
        sl2 = sh[2];
        // the candidate bin's box as seen from i (shifted by -shift on the
        // lower half) against the receiver's position
        const float* bx = a.box + size_t(nl) * 6;
        const float sg = ol < S ? 1.0f : -1.0f;
        const float ex = fmaxf(fmaxf(bx[0] + sg * sl0 - xi, xi - (bx[3] + sg * sl0)), 0.0f);
        const float ey = fmaxf(fmaxf(bx[1] + sg * sl1 - yi, yi - (bx[4] + sg * sl1)), 0.0f);
        const float ez = fmaxf(fmaxf(bx[2] + sg * sl2 - zi, zi - (bx[5] + sg * sl2)), 0.0f);
        if (ex * ex + ey * ey + ez * ez > prune_d2) nl = -1;
      }
    }
    const int o1 = min(O, o0 + 32);
    for (int o = o0; o < o1; ++o) {
      const int n = __shfl_sync(kFull, nl, o - o0);
      const float sx = __shfl_sync(kFull, sl0, o - o0);
      const float sy = __shfl_sync(kFull, sl1, o - o0);
      const float sz = __shfl_sync(kFull, sl2, o - o0);
      if (n < 0) continue;  // no candidate bin (gas phase), or none within the cutoff
      const bool lower = o >= S;
      for (int j0 = 0; j0 < C; j0 += 32) {
        const int j = j0 + lane;
        const int jr = n * C + j;
        bool within = false;
        float dx = 0.0f, dy = 0.0f, dz = 0.0f;
        if (j < C) {
          const float xj = a.coord[3 * size_t(jr) + 0];
          const float yj = a.coord[3 * size_t(jr) + 1];
          const float zj = a.coord[3 * size_t(jr) + 2];
          if (a.mask[jr] > 0.5f && !(o == 0 && j == i)) {
            if (lower) {
              dx = -__fsub_rn(__fadd_rn(xi, sx), xj);
              dy = -__fsub_rn(__fadd_rn(yi, sy), yj);
              dz = -__fsub_rn(__fadd_rn(zi, sz), zj);
            } else {
              dx = __fsub_rn(__fadd_rn(xj, sx), xi);
              dy = __fsub_rn(__fadd_rn(yj, sy), yi);
              dz = __fsub_rn(__fadd_rn(zj, sz), zi);
            }
            within = dist2(dx, dy, dz) < a.d2_max;
          }
        }
        const unsigned live = __ballot_sync(kFull, within);
        if (live == 0u) continue;
        if (within) {
          const int pos = nq + __popc(live & ((1u << lane) - 1u));
          qx[pos] = dx;
          qy[pos] = dy;
          qz[pos] = dz;
          qj[pos] = jr;
          qo[pos] = o;
        }
        nq += __popc(live);
        npair += __popc(live);
        __syncwarp();
        if (nq >= 32) {
          batch(32);
          if (lane < nq - 32) {
            qx[lane] = qx[32 + lane];
            qy[lane] = qy[32 + lane];
            qz[lane] = qz[32 + lane];
            qj[lane] = qj[32 + lane];
            qo[lane] = qo[32 + lane];
          }
          nq -= 32;
          __syncwarp();
        }
      }
    }
  }
  if (nq > 0) batch(nq);

  if (!kAdjoint && kMem) {
#pragma unroll
    for (int m = 0; m < EM; ++m) {
      if (m < E) {
        const float v = warp_sum(acc_m[m]);
        if (lane == 0) a.out[size_t(row) * E + m] = v;
      }
    }
  } else if (!kAdjoint) {
    acc_o = warp_sum(acc_o);
    if (lane == 0) a.out[row] = acc_o;
  } else {
    acc_x = warp_sum(acc_x);
    acc_y = warp_sum(acc_y);
    acc_z = warp_sum(acc_z);
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      if (!kMem || t < K) acc_s[t] = warp_sum(acc_s[t]);
    }
    float* ge = a.ge + size_t(row) * K;
    if (lane == 0) {
      a.gc[3 * size_t(row) + 0] = acc_x;
      a.gc[3 * size_t(row) + 1] = acc_y;
      a.gc[3 * size_t(row) + 2] = acc_z;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        if (!kMem || t < K) ge[2 * V + t] = acc_s[t];
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int col = lane + 32 * m;
      if (col < V) {
        ge[col] = padj[m];
        ge[V + col] = radj[m];
      }
    }
    for (int t = lane; t < 3 * S; t += 32) a.gs_rows[size_t(row) * 3 * S + t] = srow[t];
  }
  if (a.pair_count != nullptr && lane == 0) a.pair_count[row] = npair;
}

// Launch on ``stream``; returns a cudaError_t as int.
template <class Term, bool kAdjoint, int M>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * warp_words(a.K, a.S, kAdjoint);
  Args args = a;
  args.d2_max = d2_limit(a.tc.c[0]);
  cudaError_t err = cudaFuncSetAttribute(pair_kernel<Term, kAdjoint, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int blocks = (a.B * a.C + kWarps - 1) / kWarps;
  pair_kernel<Term, kAdjoint, M><<<blocks, kThreads, smem, stream>>>(args);
  return int(cudaGetLastError());
}

// The build for the term's vector width: E's bilinear adjoints hold
// M = ceil(V / 32) columns a lane.
template <class Term, bool kAdjoint>
int launch_width(const Args& a, cudaStream_t stream) {
  constexpr int NS = Term::kScalars;
  if (a.B < 1 || a.C < 1 || a.S < 1 || a.K < NS || (a.K - NS) % 2 != 0) return int(cudaErrorInvalidValue);
  const int V = (a.K - NS) / 2;
  if (V > kMaxV || (!Term::kBilinear && V != 0)) return int(cudaErrorInvalidValue);
  if (!Term::kBilinear) return launch<Term, kAdjoint, 0>(a, stream);
  if (!kAdjoint || V <= 32) return launch<Term, kAdjoint, 1>(a, stream);
  if (V <= 64) return launch<Term, kAdjoint, 2>(a, stream);
  return launch<Term, kAdjoint, 3>(a, stream);
}

// The member form: one build of kMaxMembers accumulators a lane, E of
// them used (kernels/pair_sweep.py::MAX_MEMBERS).
template <class T, bool kAdjoint>
int launch_members(const Args& a, cudaStream_t stream) {
  if (a.B < 1 || a.C < 1 || a.S < 1 || a.E < 1 || a.E > T::kMaxMembers || a.K != T::kShared + a.E * T::kPer)
    return int(cudaErrorInvalidValue);
  return launch<T, kAdjoint, 0>(a, stream);
}

template <bool kAdjoint>
int launch_term(int term, const Args& a, cudaStream_t stream) {
  if (a.E > 0) {  // the member form
    switch (term) {
      case 0:
        return launch_members<pair_terms::DsfMembers, kAdjoint>(a, stream);
      case 3:
        return launch_members<pair_terms::CoulombSimpleMembers, kAdjoint>(a, stream);
      case 4:
        return launch_members<pair_terms::CoulombSRMembers, kAdjoint>(a, stream);
      case 5:
        return launch_members<pair_terms::EwaldRealMembers, kAdjoint>(a, stream);
      case 7:
        return launch_members<pair_terms::D3TSMembers, kAdjoint>(a, stream);
      default:
        return int(cudaErrorInvalidValue);
    }
  }
  switch (term) {
    case 0:
      return launch_width<pair_terms::DsfTerm, kAdjoint>(a, stream);
    case 1:
      return launch_width<pair_terms::D3CnTerm, kAdjoint>(a, stream);
    case 2:
      return launch_width<pair_terms::D3EnergyTerm, kAdjoint>(a, stream);
    case 3:
      return launch_width<pair_terms::CoulombSimpleTerm, kAdjoint>(a, stream);
    case 4:
      return launch_width<pair_terms::CoulombSRTerm, kAdjoint>(a, stream);
    case 5:
      return launch_width<pair_terms::EwaldRealTerm, kAdjoint>(a, stream);
    case 6:
      return launch_width<pair_terms::SRRepTerm, kAdjoint>(a, stream);
    case 7:
      return launch_width<pair_terms::D3TSTerm, kAdjoint>(a, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace pair_walk
