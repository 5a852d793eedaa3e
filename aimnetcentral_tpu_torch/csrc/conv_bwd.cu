// Kernel B: the fused adjoint of kernel A (csrc/conv_fwd.cu).
//
// Replaces the Pallas TPU kernel aimnetcentral_tpu/kernels/conv_stencil.py
// ::_bwd_kernel (conv_stencil.py:466).  Receiver-centric: atom j of bin jb
// loops over the stencil offsets s and the partner bin p = mnbr[s, jb] whose
// FORWARD step s had jb as its candidate (the forward pair is i in p, j in
// jb, displacement r = x_j + shift[s, p] - x_i).  Given the forward
// cotangent gbar[p, k, i, g, f] it forms, per pair and column c = (g, f),
//     wbar_k   = gbar[p, k, i, c] a[j, c]
//     ubar_k  += wbar_k gs_g,   dbar += (wbar_0 + sum_k wbar_k u_k) dgs_g/dd
// (linear in wbar, so the sum over g and f is one sum over the columns),
// then the chain rule through u and d:
//     rbar_k = dbar u_k + (ubar_k - (ubar . u) u_k) / d.
// Outputs:
//   grad_a[j, c]    = sum_{s, i} gs_g (gbar_0 + sum_k u_k gbar_k)[p, i, c]
//   grad_coord[j]   = sum_{s, i} rbar[i, j]                  (receiver side)
//   pgrad[s, jb, t, k, i] = -sum_{j in tile t} rbar_k[i, j]: the partner-side
//     row sums of each tile of eight atoms; the wrapper sums the tiles (in a
//     fixed order) and one static gather turns them into the partner atoms'
//     coordinate adjoint and the lattice-shift adjoint (stress).
// Only real pairs within rc are walked, so every 1/d term is finite and the
// pairs beyond rc add exact zeros to the partner rows.
//
// Design: one block per (bin, tile of eight atoms), one warp per atom.  Per
// offset each warp tests 32 partner slots at a time, one per lane (masks
// are tested, so no slot order is assumed); a ballot of "real pair within
// rc" gives the pairs it walks, in ascending slot order.  The testing lane
// computes d, fc, fc' and u once and shuffles hand them to the warp.  Lanes
// own columns c = lane + 32 m of the G*F row: a[j, c] and the grad_a sums
// stay in registers across the stencil, each lane forms gs and dgs for its
// columns' g and reads gbar[p, k, i, c] (warp-wide loads of 128 contiguous
// bytes); the ubar and dbar partial sums are added over the warp by a
// shuffle butterfly.  The partner rows go through shared memory, one row
// per warp, and are summed over the eight warps in warp order once per
// offset (one __syncthreads a live offset, double-buffered).  Every output
// element is written by exactly one block and every sum is taken in a
// fixed order: no atomics, deterministic.  FP32 on CUDA cores.
//
// Column tiles, as kernel A's: a third grid axis cuts the G*F row into T
// tiles of W columns, each walking the same pairs on its own columns.
// grad_a is per column, so each tile writes its own; the coordinate and
// shift adjoints sum over every column, so each tile writes its partial,
// grad_coord (T, B*C, 3) and pgrad (T, S, B, NJ, 3, C), and the wrapper adds
// the tiles in a fixed order (still no atomics).  Shared memory depends on
// C alone and is unchanged.
//
// The AEV constants' adjoint (a second build of the kernel, kConst): the
// output depends on the radial shifts s_g, eta and rc through
// gs_g = exp(-eta (d - s_g)^2) fc(d; rc).  With W_c = wbar_0 + sum_k wbar_k
// u_k, the factor dbar already uses, each pair adds
//     sbar_g += W_c 2 eta (d - s_g) gs_g,   etabar += -W_c (d - s_g)^2 gs_g,
//     rcbar  += W_c e_g dfc/drc,  dfc/drc = -fc'(d) d / rc (zero beyond rc).
// A lane keeps its columns' sbar in registers and one etabar and rcbar sum;
// at the end the block adds them in shared memory, in warp and column order,
// and writes its G + 2 partial sums to cbar (B, NJ, G + 2).  The wrapper
// adds the blocks in a fixed order: no atomics, deterministic.  Training
// alone asks for it, at a single model's widths (one column tile).
//
// What bounds it on an H100: like kernel A, the function's least time is
// set by the bytes it moves (gbar, features and outputs, each once); its
// operations are about twice kernel A's per real pair.  This kernel reads
// gbar[p, :, i, :] (four rows of G*F) once per pair from L2/L1 and walks a
// warp's pairs one after the other, so the latency of those loads bounds
// it, with the shuffle butterfly per pair and the warps of a block waiting
// for each other once per offset: the 4 M loads of a pair are issued
// together ahead of the arithmetic, the offsets' table entries are read
// once per 32 offsets, and two blocks an SM keep 16 warps in flight.

#include <cuda_runtime.h>

#include <algorithm>

#include "conv_mma.cuh"

namespace {

constexpr int kWarps = 8;  // atoms a block: one warp each
constexpr int kThreads = 32 * kWarps;
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Two blocks an SM at M = 9 (at most 128 registers a thread, none spilled):
// on an H100 at the flagship's shapes that ran far faster than one block of
// 156 registers.
// The constants' build (kConst) holds M more registers a lane, so it asks
// for one block an SM.
template <int M, bool kConst>  // M: columns of the G*F row a lane owns, c = lane + 32 m, m < M
__global__ void __launch_bounds__(kThreads, (M <= 9 && !kConst) ? 2 : 1)
conv_bwd_kernel(const float* __restrict__ coord,     // (B*C, 3)
                const float* __restrict__ mask,      // (B*C)
                const float* __restrict__ a,         // (B*C, G*F)
                const float* __restrict__ gbar,      // (B, 4, C, G*F)
                const int* __restrict__ mnbr,        // (S, B), -1 = no partner
                const float* __restrict__ shift,     // (S, B, 3) forward frame
                const float* __restrict__ shifts_g,  // (G)
                const float* __restrict__ scal,      // (2) eta, rc
                float* __restrict__ grad_a,          // (B*C, G*F)
                float* __restrict__ grad_coord,      // (T, B*C, 3) receiver side
                float* __restrict__ pgrad,           // (T, S, B, NJ, 3, C) partner side
                int* __restrict__ pair_count,        // (B*C) or null
                float* __restrict__ cbar,            // kConst: (B, NJ, G + 2) partial sums
                int B, int C, int G, int F, int S, int W) {
  extern __shared__ float rows[];  // [2][kWarps][3][C]: partner rows, one per warp
                                   // (kConst: then [kWarps][W + 2], the constants' sums)
  const int jb = blockIdx.x;
  const int jt = blockIdx.y;
  const int NJ = gridDim.y;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = jt * kWarps + w;
  const size_t row = size_t(jb) * C + j;
  const bool real_j = j < C && mask[row] > 0.5f;
  const int GF = G * F;
  const int col0 = blockIdx.z * W;     // this tile's first column
  const int ncol = min(W, GF - col0);  // and its width
  grad_coord += size_t(blockIdx.z) * B * C * 3;
  pgrad += size_t(blockIdx.z) * S * B * NJ * 3 * C;
  const size_t kstride = size_t(C) * GF;  // gbar's k stride
  const float eta = scal[0];
  const float rc = scal[1];
  const float pi_rc = kPi / rc;

  float sg[M], av[M], ga[M], sb[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int cl = lane + 32 * m;
    sg[m] = cl < ncol ? shifts_g[(col0 + cl) / F] : 0.0f;
    av[m] = (real_j && cl < ncol) ? a[row * GF + col0 + cl] : 0.0f;
    ga[m] = 0.0f;
    sb[m] = 0.0f;
  }
  float eb = 0.0f, rb = 0.0f;  // kConst: this lane's etabar and rcbar
  float xj0 = 0.0f, xj1 = 0.0f, xj2 = 0.0f;
  if (real_j) {
    xj0 = coord[3 * row + 0];
    xj1 = coord[3 * row + 1];
    xj2 = coord[3 * row + 2];
  }
  float gc0 = 0.0f, gc1 = 0.0f, gc2 = 0.0f;
  int npair = 0;
  int buf = 0;  // the partner-row buffer of this live offset

  for (int s0 = 0; s0 < S; s0 += 32) {
    // lane t holds offset s0 + t's partner bin and its forward shift, so the
    // offsets' table reads are not a chain of dependent loads
    const int sl = s0 + lane;
    const int pl = sl < S ? mnbr[size_t(sl) * B + jb] : -1;
    float shl0 = 0.0f, shl1 = 0.0f, shl2 = 0.0f;
    if (pl >= 0) {
      const float* sh = shift + (size_t(sl) * B + pl) * 3;
      shl0 = sh[0];
      shl1 = sh[1];
      shl2 = sh[2];
    }
    for (int s = s0; s < min(S, s0 + 32); ++s) {
      const int p = __shfl_sync(0xffffffffu, pl, s - s0);  // the same for the whole block
      float* prow = pgrad + ((size_t(s) * B + jb) * NJ + jt) * 3 * C;
      if (p < 0) {  // gas-phase step without a partner: nothing to send
        for (int t = threadIdx.x; t < 3 * C; t += kThreads) prow[t] = 0.0f;
        continue;
      }
      float* mine = rows + (buf * kWarps + w) * 3 * C;
      const float sh0 = __shfl_sync(0xffffffffu, shl0, s - s0);
      const float sh1 = __shfl_sync(0xffffffffu, shl1, s - s0);
      const float sh2 = __shfl_sync(0xffffffffu, shl2, s - s0);
      for (int i0 = 0; i0 < C; i0 += 32) {
        const int i = i0 + lane;
        float d = 1.0f, fc = 0.0f, fcp = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
        bool within = false;
        if (real_j && i < C) {
          const size_t pr = size_t(p) * C + i;
          const float dx = xj0 - (coord[3 * pr + 0] - sh0);
          const float dy = xj1 - (coord[3 * pr + 1] - sh1);
          const float dz = xj2 - (coord[3 * pr + 2] - sh2);
          const bool vp = mask[pr] > 0.5f && !(s == 0 && i == j);
          d = sqrtf(vp ? dx * dx + dy * dy + dz * dz : 1.0f);
          within = vp && d < rc;
          if (within) {
            const float arg = d * pi_rc;
            fc = 0.5f * (cosf(arg) + 1.0f);
            fcp = -0.5f * pi_rc * sinf(arg);
            ux = dx / d;
            uy = dy / d;
            uz = dz / d;
          }
        }
        float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;  // this lane's partner-row entry
        unsigned live = __ballot_sync(0xffffffffu, within);
        while (live) {  // the same for every lane of the warp
          const int src = __ffs(live) - 1;
          live &= live - 1;
          const float pd = __shfl_sync(0xffffffffu, d, src);
          const float pfc = __shfl_sync(0xffffffffu, fc, src);
          const float pfcp = __shfl_sync(0xffffffffu, fcp, src);
          const float pux = __shfl_sync(0xffffffffu, ux, src);
          const float puy = __shfl_sync(0xffffffffu, uy, src);
          const float puz = __shfl_sync(0xffffffffu, uz, src);
          const float* gb = gbar + (size_t(p) * 4 * C + i0 + src) * GF + col0;
          // the partner's four cotangent rows first: 4 M loads in flight together
          float gv[M][4];
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int cl = lane + 32 * m;
#pragma unroll
            for (int k = 0; k < 4; ++k) gv[m][k] = cl < ncol ? __ldg(gb + k * kstride + cl) : 0.0f;
          }
          float ub0 = 0.0f, ub1 = 0.0f, ub2 = 0.0f, db = 0.0f, we = 0.0f;
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int cl = lane + 32 * m;
            if (cl < ncol) {
              const float dd = pd - sg[m];
              const float e = expf(-eta * dd * dd);
              const float gs = e * pfc;
              const float dgs = e * (pfcp - 2.0f * eta * dd * pfc);
              const float g0 = gv[m][0];
              const float g1 = gv[m][1];
              const float g2 = gv[m][2];
              const float g3 = gv[m][3];
              ga[m] = fmaf(gs, g0 + pux * g1 + puy * g2 + puz * g3, ga[m]);
              const float w0 = g0 * av[m];
              const float w1 = g1 * av[m];
              const float w2 = g2 * av[m];
              const float w3 = g3 * av[m];
              ub0 = fmaf(w1, gs, ub0);
              ub1 = fmaf(w2, gs, ub1);
              ub2 = fmaf(w3, gs, ub2);
              const float wc = w0 + w1 * pux + w2 * puy + w3 * puz;
              db = fmaf(wc, dgs, db);
              if (kConst) {
                sb[m] = fmaf(wc * (2.0f * eta * dd), gs, sb[m]);
                eb = fmaf(-wc * dd * dd, gs, eb);
                we = fmaf(wc, e, we);
              }
            }
          }
          if (kConst) rb = fmaf(we, -pfcp * pd / rc, rb);  // dfc/drc = -fc' d / rc
          ub0 = warp_sum(ub0);
          ub1 = warp_sum(ub1);
          ub2 = warp_sum(ub2);
          db = warp_sum(db);
          const float inv_d = 1.0f / pd;
          const float uu = ub0 * pux + ub1 * puy + ub2 * puz;
          const float rb0 = db * pux + (ub0 - uu * pux) * inv_d;
          const float rb1 = db * puy + (ub1 - uu * puy) * inv_d;
          const float rb2 = db * puz + (ub2 - uu * puz) * inv_d;
          gc0 += rb0;
          gc1 += rb1;
          gc2 += rb2;
          if (lane == src) {
            r0 = -rb0;
            r1 = -rb1;
            r2 = -rb2;
          }
          ++npair;
        }
        if (i < C) {
          mine[i] = r0;
          mine[C + i] = r1;
          mine[2 * C + i] = r2;
        }
      }
      __syncthreads();  // every warp's row of this offset is in place
      // the tile's partner rows: the eight warps' rows added in warp order.
      // The next live offset writes the other buffer; the one after it comes
      // after that offset's __syncthreads, when these reads are done.
      const float* both = rows + buf * kWarps * 3 * C;
      for (int t = threadIdx.x; t < 3 * C; t += kThreads) {
        float sum = 0.0f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) sum += both[v * 3 * C + t];
        prow[t] = sum;
      }
      buf ^= 1;
    }
  }

  if (j < C) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int cl = lane + 32 * m;
      if (cl < ncol) grad_a[row * GF + col0 + cl] = ga[m];
    }
    if (lane == 0) {
      grad_coord[3 * row + 0] = gc0;
      grad_coord[3 * row + 1] = gc1;
      grad_coord[3 * row + 2] = gc2;
      if (pair_count != nullptr && blockIdx.z == 0) pair_count[row] = npair;
    }
  }

  if (kConst) {
    // the block's G + 2 sums: each warp's columns, then the warps in order
    __syncthreads();  // the last offset's partner-row reads are done
    float* red = rows;  // [kWarps][W] column sums, then [kWarps][2]
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int cl = lane + 32 * m;
      if (cl < ncol) red[w * W + cl] = sb[m];
    }
    eb = warp_sum(eb);
    rb = warp_sum(rb);
    if (lane == 0) {
      red[kWarps * W + 2 * w] = eb;
      red[kWarps * W + 2 * w + 1] = rb;
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t < G + 2) {
      float sum = 0.0f;
      for (int v = 0; v < kWarps; ++v) {
        if (t < G) {
          for (int f = 0; f < F; ++f) sum += red[v * W + t * F + f];
        } else {
          sum += red[kWarps * W + 2 * v + (t - G)];
        }
      }
      cbar[(size_t(jb) * NJ + jt) * (G + 2) + t] = sum;
    }
  }
}

template <int M, bool kConst>
int launch(const float* coord, const float* mask, const float* a, const float* gbar,
           const int* mnbr, const float* shift, const float* shifts_g, const float* scal,
           float* grad_a, float* grad_coord, float* pgrad, int* pair_count, float* cbar, int B,
           int C, int G, int F, int S, int W, cudaStream_t stream) {
  // kernels/conv_stencil.py::bwd_smem_bytes computes the same number
  size_t smem = sizeof(float) * 2 * kWarps * 3 * size_t(C);
  if (kConst) smem = std::max(smem, sizeof(float) * kWarps * (size_t(W) + 2));
  cudaError_t err = cudaFuncSetAttribute(
      conv_bwd_kernel<M, kConst>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(B, (C + kWarps - 1) / kWarps, (G * F + W - 1) / W);
  conv_bwd_kernel<M, kConst><<<grid, kThreads, smem, stream>>>(
      coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a, grad_coord, pgrad, pair_count,
      cbar, B, C, G, F, S, W);
  return int(cudaGetLastError());
}

// The tensor-core builds: kernel B in the JAX package's conv precision
// modes, replacing _bwd_kernel (aimnetcentral_tpu/kernels/conv_stencil.py
// :466) with its two _mxu_dot contractions (:574, :590) (csrc/conv_mma.cuh:
// the modes, the design, the exact W).  What bounds them on an H100 is the
// bytes moved (features, cotangent and outputs once); what they add is
// moving each live partner's four cotangent rows from L2 into shared memory
// (once a pass, 8 shifts x F columns of each), the pairs' geometry and
// exps, the FP32 chain rule of every pair within rc, and three barriers a
// batch.  Block (jb, shift-and-column tile z): kBwdGTile radial shifts
// and kFTile feature columns of every real atom of bin jb, in passes of up
// to kRowCap atoms (compacted in slot order).  A pass:
//   1. the live partners: the pass's record of live_scan_kernel (launched
//      just before, conv_mma.cuh): for each (offset s, slot i of the partner
//      bin p = mnbr[s, jb]) holding a real atom, the row tiles with an atom
//      within rc (the forward's displacement x_j + shift[s, p] - x_i), as
//      the entry stream by class (Stream);
//   2. batches of kBwdEntries entries: their cotangent rows gbar[p, k, i]
//      (the block's columns) copied by cp.async, then the geometry and exps
//      of each (atom, entry) pair, into shared memory; then
//      phase 1, warp w: row tile w / 4, shifts g0 + w % 4 and g0 + w % 4 +
//        4: grad_a[j, g, f] += sum_{k, e} W_k[j, e, g] gbar[e, k, g, f] by
//        mma.sync (depth: the tile's entries; 24 accumulators a thread);
//      phase 2, warp w: row tile w / 4, entries 8 ((w / 2) % 2) .. + 8, the
//        shifts of half w % 2: wbar_k[j, e, g] = sum_f a[j, g, f] gbar[e, k,
//        g, f] by mma.sync (depth: the columns), each pair's ubar and dbar
//        summed over the half's shifts in registers, the two halves in
//        order through shared memory;
//      the chain rule per pair in FP32 (rbar), then the atoms' coordinate
//      sums (an atom's entries in order) and the partner rows (the pass's
//      atoms in order) into pgrad[z, s, jb, :, i]: written by the first
//      pass (zeros for the slots it does not reach), added to by later ones.
// The constants' build adds each pair's sbar, etabar and rcbar terms (as
// the FP32 build) and reduces them in warp order at the end.  The column
// sums of several shift-and-column tiles (grad_coord, pgrad, cbar) are
// partials the wrapper adds in a fixed order: no atomics, deterministic.
// The constants' build holds 6 more sums a thread and runs one block an SM
// (no spills); the build without two.
namespace cm = conv_mma;

template <int kMode, bool kConst>
__global__ void __launch_bounds__(cm::kThreads, kConst ? 1 : 2)
conv_bwd_mma_kernel(const float* __restrict__ coord,     // (B*C, 3)
                    const float* __restrict__ mask,      // (B*C)
                    const float* __restrict__ a,         // (B*C, G*F)
                    const float* __restrict__ gbar,      // (B, 4, C, G*F)
                    const int* __restrict__ mnbr,        // (S, B), -1 = no partner
                    const float* __restrict__ shift,     // (S, B, 3) forward frame
                    const float* __restrict__ shifts_g,  // (G)
                    const float* __restrict__ scal,      // (2) eta, rc
                    float* __restrict__ grad_a,          // (B*C, G*F)
                    float* __restrict__ grad_coord,      // (T, B*C, 3) receiver side
                    float* __restrict__ pgrad,           // (T, S, B, 3, C) partner side
                    float* __restrict__ cbar,            // kConst: (B, T, G + 2) partial sums
                    const int* __restrict__ rec,         // (B, passes) scan records (conv_mma.cuh)
                    int B, int C, int G, int F, int S) {
  using M = cm::Mma<kMode>;
  constexpr int EB = cm::kBwdEntries;
  constexpr int Q = cm::kBwdQ;
  constexpr int GT = cm::kBwdGTile;
  constexpr int TPE = cm::kThreads / EB;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const cm::BwdLayout L(C, F, S, kMode);
  float4* const geo4 = smem4 + L.geo4 / 4;  // [kRowCap][Q] (fc, ux, uy, uz)
  float4* const red = smem4 + L.red / 4;    // [2][kRowCap][EB]
  float4* const rows = smem4 + L.rows / 4;
  float2* const geo2 = reinterpret_cast<float2*>(smem + L.geo2);  // [kRowCap][Q] (d, fc')
  float* const exs = smem + L.ex;                                 // [GT][kRowCap][Q]
  float* const stage = smem + L.stage;                            // [EB][Pe]: [k][g][f]
  float* const as = smem + L.as;                                  // [kRowCap][Pr]: [g][f]
  float* const sg = smem + L.sg;
  float* const csum = smem + L.csum;
  float* const gcs = smem + L.gcs;
  float4* const shs = smem4 + L.shs / 4;  // [S] forward shifts of the partner bins
  int* const nbs = reinterpret_cast<int*>(smem + L.nbs);
  unsigned* const masks = reinterpret_cast<unsigned*>(smem + L.masks);
  int* const prefix = reinterpret_cast<int*>(smem + L.prefix);
  int* const slots = reinterpret_cast<int*>(smem + L.slots);
  int* const ent = reinterpret_cast<int*>(smem + L.ent);  // [2][2][EB]: offsets, slots

  const int jb = blockIdx.x;
  const int T = gridDim.z;
  const int z = blockIdx.z;
  const int g0 = (z % cm::bwd_g_tiles(G)) * GT;
  const int f0 = (z / cm::bwd_g_tiles(G)) * cm::kFTile;
  const int ng = min(GT, G - g0);
  const int nfb = min(cm::kFTile, F - f0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const int GF = G * F;
  const size_t kstride = size_t(C) * GF;  // gbar's k stride
  const int Pk = L.Pk, Pe = L.Pe, Pr = L.Pr, W = L.W;
  grad_coord += size_t(z) * B * C * 3;
  pgrad += size_t(z) * S * B * 3 * C;
  const float eta = scal[0];
  const cm::Rc2 rc2 = cm::rc_bounds(scal[1]);
  const float rc = rc2.rc;
  const float pi_rc = __fdiv_rn(cm::kPi, rc);

  if (warp == 0) {
    const int nrow = cm::compact_rows(mask, jb, C, 0, C, slots, lane);
    if (lane == 0) prefix[0] = nrow;
  }
  if (tid < GT) sg[tid] = g0 + tid < G ? shifts_g[g0 + tid] : 0.0f;
  for (int s = tid; s < S; s += cm::kThreads) {
    const int p = mnbr[size_t(s) * B + jb];
    nbs[s] = p;
    if (p >= 0) {
      const float* sh = shift + (size_t(s) * B + p) * 3;
      shs[s] = make_float4(sh[0], sh[1], sh[2], 0.0f);
    }
  }
  // the padding atoms' rows: zero feature adjoint (the block's columns) and
  // coordinate partial, a warp a slot
  const bool one_run = nfb == F;
  for (int j = warp; j < C; j += cm::kWarps) {
    const size_t row = size_t(jb) * C + j;
    if (mask[row] > 0.5f) continue;  // the same for the warp
    for (int c = lane; c < ng * nfb; c += 32)
      grad_a[row * GF + (one_run ? g0 * F + c : (g0 + c / nfb) * F + f0 + c % nfb)] = 0.0f;
    if (lane < 3) grad_coord[3 * row + lane] = 0.0f;
  }
  __syncthreads();
  const int nrow = prefix[0];
  const int npass = max(1, (nrow + cm::kRowCap - 1) / cm::kRowCap);

  // the copies of a cotangent row: 16 bytes a chunk where every run is aligned
  const bool vec = (reinterpret_cast<uintptr_t>(gbar) & 15) == 0 && GF % 4 == 0 && Pe % 4 == 0 && Pk % 4 == 0 &&
                   (one_run ? (g0 * F) % 4 == 0 && (ng * F) % 4 == 0 : F % 4 == 0 && f0 % 4 == 0 && nfb % 4 == 0);

  // phase 1: row tile warp / 4, shifts gl1 and gl1 + 4; phase 2: the same
  // row tile, entry tile (warp / 2) % 2, shifts 4 hh .. 4 hh + 3
  const int tile = warp >> 2;
  const int gl1 = warp & 3;
  const int hh = warp & 1;
  const int et2 = (warp >> 1) & 1;
  float sbm[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // kConst: sbar of the shifts 4 hh + m
  float eb = 0.0f, rbc = 0.0f;              // kConst: etabar and rcbar

  for (int pass = 0; pass < npass; ++pass) {
    const int r0 = pass * cm::kRowCap;
    const int nr = min(cm::kRowCap, nrow - r0);  // 0 only in a bin without real atoms
    const int* ps = slots + r0;                  // the pass's rows' slots
    __syncthreads();  // the previous pass's readers are done
    if (warp == 0) cm::load_rows(coord, jb, C, ps, max(nr, 0), rows, lane);
    if (tid < 3 * cm::kRowCap) gcs[tid] = 0.0f;
    // the pass's features a[j, g, f] (its columns), zero beyond its rows
    for (int t = tid; t < cm::kRowCap * ng * nfb; t += cm::kThreads) {
      const int r = t / (ng * nfb);
      const int c = t % (ng * nfb);
      as[r * Pr + c] = r < nr ? a[(size_t(jb) * C + ps[r]) * GF + size_t(g0 + c / nfb) * F + f0 + c % nfb] : 0.0f;
    }
    // 1. the live partners: this pass's scan record (live_scan_kernel); the
    //    first pass writes zero partner rows where it finds no pair
    const int* src_rec = rec + (size_t(jb) * cm::row_groups(C) + pass) * cm::scan_words(C, S);
    for (int t = tid; t < cm::scan_words(C, S); t += cm::kThreads) reinterpret_cast<int*>(masks)[t] = src_rec[t];
    __syncthreads();
    if (pass == 0) {
      for (int item = warp; item < S * W; item += cm::kWarps) {
        const int s = item / W;
        const int i = (item - s * W) * 32 + lane;
        const unsigned any = masks[item] | masks[S * W + item] | masks[2 * S * W + item];
        if (i < C && !((any >> lane) & 1u)) {
          float* prow = pgrad + (size_t(s) * B + jb) * 3 * C + i;
          prow[0] = prow[C] = prow[2 * C] = 0.0f;
        }
      }
    }
    const cm::Stream stream(masks, prefix, S, W);
    const int nb = (stream.E + EB - 1) / EB;
    const int lo = stream.lo(tile), hi = stream.hi(tile);  // this warp's tile's entries
    const bool tile_on = tile * 16 < nr;

    float ga[2][cm::kNT][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int nt = 0; nt < cm::kNT; ++nt) ga[u][nt][0] = ga[u][nt][1] = ga[u][nt][2] = ga[u][nt][3] = 0.0f;

    for (int t = 0; t < nb; ++t) {
      const int par = t & 1;
      const int base = t * EB;
      const int ne = min(EB, stream.E - base);
      // 2. the batch: copies first, then the geometry beside them
      {
        const int e = tid % EB;
        const int part = tid / EB;
        const int ge = base + e;
        const bool valid = ge < stream.E;
        int s = 0, i = 0, p = 0;
        if (valid) {
          stream.decode(ge, s, i);
          p = nbs[s];
          if (part == 0) {
            ent[(par * 2 + 0) * EB + e] = s;
            ent[(par * 2 + 1) * EB + e] = i;
          }
        }
        const float* src = gbar + (size_t(p) * 4 * C + i) * GF + size_t(g0) * F + f0;
        float* dst = stage + e * Pe;
        if (one_run) {
          cm::stage_runs(dst, src, 4, 1, kstride, 0, Pk, 0, ng * F, vec, valid, part, TPE);
        } else {
          cm::stage_runs(dst, src, 4, ng, kstride, F, Pk, nfb, nfb, vec, valid, part, TPE);
        }
        cm::cp_async_commit();
        float4 sh = make_float4(0.0f, 0.0f, 0.0f, 0.0f), xi = sh;
        if (valid) {
          const size_t pr = size_t(p) * C + i;
          sh = shs[s];
          xi = make_float4(coord[3 * pr + 0], coord[3 * pr + 1], coord[3 * pr + 2], 0.0f);
        }
        // the cheap test of this thread's pairs (rows part + 16 m), zeros
        // where beyond rc; then the pairs within rc packed onto the warp's
        // lanes for the sqrt, cos, divisions and exps
        unsigned inm = 0;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int r = part + 16 * m;
          bool in = false;
          if (valid && r < nr && ge >= stream.lo(m) && ge < stream.hi(m) && !(s == 0 && ps[r] == i)) {
            const float4 xr = rows[r];
            float dx, dy, dz;
            in = rc2.within(cm::pair_d2(xr.x, xr.y, xr.z, sh.x, sh.y, sh.z, xi.x, xi.y, xi.z, dx, dy, dz));
          }
          if (in) {
            inm |= 1u << m;
          } else {
            geo4[r * Q + e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            geo2[r * Q + e] = make_float2(1.0f, 0.0f);
#pragma unroll
            for (int g = 0; g < GT; ++g) exs[(g * cm::kRowCap + r) * Q + e] = 0.0f;
          }
        }
        const unsigned b0 = __ballot_sync(0xffffffffu, inm & 1u), b1 = __ballot_sync(0xffffffffu, inm & 2u);
        const int c0 = __popc(b0), total = c0 + __popc(b1);
        for (int base = 0; base < total; base += 32) {  // the same for the warp
          const int idx = base + lane;
          const int m = idx < c0 ? 0 : 1;
          const int src = idx < total ? cm::nth_set_bit(m == 0 ? b0 : b1, idx - (m == 0 ? 0 : c0)) : lane;
          const float qx = __shfl_sync(0xffffffffu, xi.x, src), qy = __shfl_sync(0xffffffffu, xi.y, src);
          const float qz = __shfl_sync(0xffffffffu, xi.z, src);
          const float sx = __shfl_sync(0xffffffffu, sh.x, src), sy = __shfl_sync(0xffffffffu, sh.y, src);
          const float sz = __shfl_sync(0xffffffffu, sh.z, src);
          if (idx < total) {
            const int r = (warp * 2 + (src >> 4)) + 16 * m;  // the source lane's part, row
            const int ee = src & 15;
            const float4 xr = rows[r];
            const cm::Geom pg = cm::pair_geometry(xr.x, xr.y, xr.z, sx, sy, sz, qx, qy, qz, pi_rc);
            geo4[r * Q + ee] = make_float4(pg.fc, pg.ux, pg.uy, pg.uz);
            geo2[r * Q + ee] = make_float2(pg.d, -0.5f * pi_rc * sinf(pg.d * pi_rc));
#pragma unroll
            for (int g = 0; g < GT; ++g) exs[(g * cm::kRowCap + r) * Q + ee] = cm::gauss(pg.d, sg[g], eta);
          }
        }
        cm::cp_async_wait();
      }
      __syncthreads();

      // phase 1 (the lane's rows' offsets formed here for the batch: kept
      // live across the whole kernel they would crowd the registers)
      int rq = (tile * 16 + gid) * Q;
      asm volatile("" : "+r"(rq));
      if (tile_on) {
#pragma unroll 1
        for (int k0 = 0; k0 < ne; k0 += M::K) {
          if (base + k0 + M::K <= lo || base + k0 >= hi) continue;  // no entry of this tile
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int gl = gl1 + 4 * u;
            if (gl >= ng) continue;
            const float* ex = exs + gl * cm::kRowCap * Q + rq;
            const float* g4 = reinterpret_cast<const float*>(geo4 + rq);
            float gs[2][M::NK];
#pragma unroll
            for (int q = 0; q < M::NK; ++q)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int ix = 8 * r * Q + k0 + M::kidx(t4, q);
                gs[r][q] = __fmul_rn(ex[ix], g4[4 * ix]);
              }
            const float* st = stage + gl * nfb;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float w[2][M::NK];
#pragma unroll
              for (int q = 0; q < M::NK; ++q)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const int ix = 8 * r * Q + k0 + M::kidx(t4, q);
                  w[r][q] = k == 0 ? gs[r][q] : __fmul_rn(gs[r][q], g4[4 * ix + k]);  // u_k
                }
              cm::OpA aop;
              cm::make_a<kMode>(w, aop);
#pragma unroll
              for (int nt = 0; nt < cm::kNT; ++nt) {
                const int fl = nt * 8 + gid;
                if (nt * 8 >= nfb) continue;
                float bv[M::NK];
#pragma unroll
                for (int q = 0; q < M::NK; ++q)
                  bv[q] = fl < nfb ? st[(k0 + M::kidx(t4, q)) * Pe + k * Pk + fl] : 0.0f;
                cm::OpB bop;
                cm::make_b<kMode>(bv, bop);
                cm::mma<kMode>(ga[u][nt], aop, bop);
              }
            }
          }
        }
      }

      // phase 2
      if (tile_on && et2 * 8 < ne && base + et2 * 8 + 8 > lo && base + et2 * 8 < hi) {
        // pairs e (row gid + 8 (e >> 1), entry 2 t4 + (e & 1)): (ubar, dbar)
        // summed over the half's shifts in red[hh], which this unit owns
        float4* const pp = red + hh * cm::kRowCap * EB;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pp[(tile * 16 + gid + 8 * (e >> 1)) * EB + et2 * 8 + 2 * t4 + (e & 1)] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
        for (int m = 0; m < 4; ++m) {
          const int gl = 4 * hh + m;
          if (gl >= ng) break;
          float wacc[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) wacc[k][0] = wacc[k][1] = wacc[k][2] = wacc[k][3] = 0.0f;
          int ro = (tile * 16 + gid) * Pr + gl * nfb, so = (et2 * 8 + gid) * Pe + gl * nfb;
          asm volatile("" : "+r"(ro), "+r"(so));
          const float* ar = as + ro;
          const float* st = stage + so;
#pragma unroll 1
          for (int kf = 0; kf < nfb; kf += M::K) {
            float av[2][M::NK];
#pragma unroll
            for (int q = 0; q < M::NK; ++q) {
              const int fl = kf + M::kidx(t4, q);
#pragma unroll
              for (int r = 0; r < 2; ++r) av[r][q] = fl < nfb ? ar[8 * r * Pr + fl] : 0.0f;
            }
            cm::OpA aop;
            cm::make_a<kMode>(av, aop);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float bv[M::NK];
#pragma unroll
              for (int q = 0; q < M::NK; ++q) {
                const int fl = kf + M::kidx(t4, q);
                bv[q] = fl < nfb ? st[k * Pk + fl] : 0.0f;
              }
              cm::OpB bop;
              cm::make_b<kMode>(bv, bop);
              cm::mma<kMode>(wacc[k], aop, bop);
            }
          }
          const float sgv = sg[gl];
          const float* ex = exs + gl * cm::kRowCap * Q;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ix = rq + 8 * (e >> 1) * Q + et2 * 8 + 2 * t4 + (e & 1);
            const float4 gv = geo4[ix];
            const float fc = gv.x;
            if (fc == 0.0f) continue;
            const float2 dv = geo2[ix];
            const float dd = dv.x - sgv;
            const float exv = ex[ix];
            const float gs = exv * fc;
            const float dgs = exv * (dv.y - 2.0f * eta * dd * fc);
            const float w0 = wacc[0][e], w1 = wacc[1][e], w2 = wacc[2][e], w3 = wacc[3][e];
            float4& acc = pp[(tile * 16 + gid + 8 * (e >> 1)) * EB + et2 * 8 + 2 * t4 + (e & 1)];
            float4 v = acc;
            v.x = fmaf(w1, gs, v.x);
            v.y = fmaf(w2, gs, v.y);
            v.z = fmaf(w3, gs, v.z);
            const float wc = w0 + w1 * gv.y + w2 * gv.z + w3 * gv.w;
            v.w = fmaf(wc, dgs, v.w);
            acc = v;
            if (kConst) {
              const float sv = wc * (2.0f * eta * dd) * gs;  // sbm[m] += sv, m held in registers
              if (m == 0) {
                sbm[0] += sv;
              } else if (m == 1) {
                sbm[1] += sv;
              } else if (m == 2) {
                sbm[2] += sv;
              } else {
                sbm[3] += sv;
              }
              eb = fmaf(-wc * dd * dd, gs, eb);
              rbc = fmaf(wc * exv, -dv.y * dv.x / rc, rbc);  // dfc/drc = -fc' d / rc
            }
          }
        }
      }
      __syncthreads();

      // the chain rule per pair, in place: red[0][row][e] = rbar
      for (int pi = tid; pi < cm::kRowCap * EB; pi += cm::kThreads) {
        const int row = pi / EB;
        const int en = pi % EB;
        float4 rb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row < nr && en < ne) {
          const float4 gv = geo4[row * Q + en];
          if (gv.x != 0.0f) {
            const float4 h0 = red[row * EB + en];
            const float4 h1 = red[(cm::kRowCap + row) * EB + en];
            const float ub0 = h0.x + h1.x, ub1 = h0.y + h1.y, ub2 = h0.z + h1.z, db = h0.w + h1.w;
            const float inv_d = 1.0f / geo2[row * Q + en].x;
            const float uu = ub0 * gv.y + ub1 * gv.z + ub2 * gv.w;
            rb.x = db * gv.y + (ub0 - uu * gv.y) * inv_d;
            rb.y = db * gv.z + (ub1 - uu * gv.z) * inv_d;
            rb.z = db * gv.w + (ub2 - uu * gv.w) * inv_d;
          }
        }
        red[row * EB + en] = rb;
      }
      __syncthreads();

      // the atoms' coordinate sums and the partner rows, in fixed orders
      const float* rbf = reinterpret_cast<const float*>(red);
      if (tid < 3 * cm::kRowCap) {
        const int row = tid / 3;
        const int comp = tid % 3;
        if (row < nr) {
          float sum = gcs[tid];
          for (int en = 0; en < ne; ++en) sum += rbf[(row * EB + en) * 4 + comp];
          gcs[tid] = sum;
        }
      } else if (tid < 3 * cm::kRowCap + 3 * EB) {
        const int en = (tid - 3 * cm::kRowCap) / 3;
        const int comp = (tid - 3 * cm::kRowCap) % 3;
        if (en < ne) {
          float sum = 0.0f;
          for (int r = 0; r < nr; ++r) sum += -rbf[(r * EB + en) * 4 + comp];
          const int s = ent[(par * 2 + 0) * EB + en];
          const int i = ent[(par * 2 + 1) * EB + en];
          float* dst = pgrad + ((size_t(s) * B + jb) * 3 + comp) * C + i;
          *dst = pass == 0 ? sum : *dst + sum;
        }
      }
      // the next batch writes the stage, geometry and entries of the other
      // parity; red is read here and written again after its first barrier
    }

    // the pass's rows: feature adjoint and coordinate partial
    if (tile_on) {
      // the addresses here, not kept in registers from the kernel's start
      int col = (g0 + gl1) * F + f0 + 2 * t4, bj = jb, row0 = tile * 16 + gid;
      asm volatile("" : "+r"(col), "+r"(bj), "+r"(row0));
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int gl = gl1 + 4 * u;
        if (gl >= ng) continue;
#pragma unroll
        for (int nt = 0; nt < cm::kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + 8 * (e >> 1);
            const int fl = nt * 8 + 2 * t4 + (e & 1);
            if (row < nr && fl < nfb)
              grad_a[(size_t(bj) * C + ps[row]) * GF + col + 4 * u * F + nt * 8 + (e & 1)] = ga[u][nt][e];
          }
      }
    }
    __syncthreads();  // the last batch's coordinate sums are in place
    if (tid < 3 * cm::kRowCap && tid / 3 < nr) grad_coord[3 * (size_t(jb) * C + ps[tid / 3]) + tid % 3] = gcs[tid];
  }

  if (kConst) {  // the block's G + 2 partial sums: lanes, then warps in order
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sbm[m] += __shfl_xor_sync(0xffffffffu, sbm[m], o);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      eb += __shfl_xor_sync(0xffffffffu, eb, o);
      rbc += __shfl_xor_sync(0xffffffffu, rbc, o);
    }
    __syncthreads();
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m) csum[warp * 6 + m] = sbm[m];
      csum[warp * 6 + 4] = eb;
      csum[warp * 6 + 5] = rbc;
    }
    __syncthreads();
    if (tid < G + 2) {
      float sum = 0.0f;
      if (tid < G) {  // shift tid: the warps of half (tid - g0) / 4, slot (tid - g0) % 4
        const int gl = tid - g0;
        if (gl >= 0 && gl < ng)
          for (int v = gl / 4; v < cm::kWarps; v += 2) sum += csum[v * 6 + gl % 4];
      } else {
        for (int v = 0; v < cm::kWarps; ++v) sum += csum[v * 6 + 4 + (tid - G)];
      }
      cbar[(size_t(jb) * T + z) * (G + 2) + tid] = sum;
    }
  }
}

template <int kMode, bool kConst>
int launch_mma(const float* coord, const float* mask, const float* a, const float* gbar, const int* mnbr,
               const float* shift, const float* shifts_g, const float* scal, float* grad_a,
               float* grad_coord, float* pgrad, float* cbar, int* rec, int B, int C, int G, int F, int S,
               cudaStream_t stream) {
  const int err0 = cm::launch_scan<true>(coord, mask, mnbr, shift, scal, rec, B, C, S, stream);
  if (err0 != 0) return err0;
  // kernels/conv_stencil.py::mma_bwd_smem_bytes computes the same number
  const int smem = 4 * cm::BwdLayout(C, F, S, kMode).words;
  cudaError_t err = cudaFuncSetAttribute(conv_bwd_mma_kernel<kMode, kConst>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B, 1, cm::bwd_g_tiles(G) * cm::f_tiles(F));
  conv_bwd_mma_kernel<kMode, kConst><<<grid, cm::kThreads, smem, stream>>>(
      coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a, grad_coord, pgrad, cbar, rec, B, C, G, F, S);
  return int(cudaGetLastError());
}

template <bool kConst>
int launch_mma_mode(int mode, const float* coord, const float* mask, const float* a, const float* gbar,
                    const int* mnbr, const float* shift, const float* shifts_g, const float* scal,
                    float* grad_a, float* grad_coord, float* pgrad, float* cbar, int* rec, int B, int C, int G,
                    int F, int S, cudaStream_t st) {
  if (mode == cm::kTF32)
    return launch_mma<cm::kTF32, kConst>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a,
                                         grad_coord, pgrad, cbar, rec, B, C, G, F, S, st);
  if (mode == cm::k3xTF32)
    return launch_mma<cm::k3xTF32, kConst>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a,
                                           grad_coord, pgrad, cbar, rec, B, C, G, F, S, st);
  if (mode == cm::kBF16)
    return launch_mma<cm::kBF16, kConst>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a,
                                         grad_coord, pgrad, cbar, rec, B, C, G, F, S, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// M, the columns a lane owns, and W, the columns a tile owns, are
// kernels/conv_stencil.py::col_tiles.
extern "C" int conv_bwd_launch(const float* coord, const float* mask, const float* a,
                               const float* gbar, const int* mnbr, const float* shift,
                               const float* shifts_g, const float* scal, float* grad_a,
                               float* grad_coord, float* pgrad, int* pair_count, int B, int C,
                               int G, int F, int S, int M, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || W < 1 || W > 32 * M || (G * F + W - 1) / W > 64)
    return int(cudaErrorInvalidValue);
  if (M == 9)
    return launch<9, false>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a, grad_coord,
                            pgrad, pair_count, nullptr, B, C, G, F, S, W, st);
  if (M == 17)
    return launch<17, false>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a, grad_coord,
                             pgrad, pair_count, nullptr, B, C, G, F, S, W, st);
  return int(cudaErrorInvalidValue);
}

// The constants' build: as conv_bwd_launch, plus cbar (B, NJ, G + 2), the
// blocks' partial sums of the adjoints of shifts_g, eta and rc.  One column
// tile only (W == G * F).
extern "C" int conv_bwd_const_launch(const float* coord, const float* mask, const float* a,
                                     const float* gbar, const int* mnbr, const float* shift,
                                     const float* shifts_g, const float* scal, float* grad_a,
                                     float* grad_coord, float* pgrad, int* pair_count, float* cbar,
                                     int B, int C, int G, int F, int S, int M, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || W != G * F || W > 32 * M || G + 2 > kThreads)
    return int(cudaErrorInvalidValue);
  if (M == 9)
    return launch<9, true>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a, grad_coord,
                           pgrad, pair_count, cbar, B, C, G, F, S, W, st);
  if (M == 17)
    return launch<17, true>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a, grad_coord,
                            pgrad, pair_count, cbar, B, C, G, F, S, W, st);
  return int(cudaErrorInvalidValue);
}

// The tensor-core builds: mode 1 TF32, 2 3xTF32, 3 bf16 (conv_mma.cuh);
// kernels/conv_stencil.py::MMA_MODES.  One block a bin and shift-and-column
// tile: grad_coord (T, B*C, 3) and pgrad (T, S, B, 3, C) hold the partials
// of the T = ceil(G / 8) ceil(F / 24) tiles; ``constants`` != 0 also writes
// cbar (B, T, G + 2) and takes G <= 16, F <= 24.  No pair counts.
extern "C" int conv_bwd_mma_launch(const float* coord, const float* mask, const float* a,
                                   const float* gbar, const int* mnbr, const float* shift,
                                   const float* shifts_g, const float* scal, float* grad_a,
                                   float* grad_coord, float* pgrad, float* cbar, int* rec, int B, int C,
                                   int G, int F, int S, int mode, int constants, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = cm::bwd_g_tiles(G) * cm::f_tiles(F);
  if (B < 1 || C < 1 || G < 1 || F < 1 || S < 1 || tiles > 128 ||
      (constants && (G > 2 * cm::kBwdGTile || F > cm::kFTile || cbar == nullptr)))
    return int(cudaErrorInvalidValue);
  if (constants)
    return launch_mma_mode<true>(mode, coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a,
                                 grad_coord, pgrad, cbar, rec, B, C, G, F, S, st);
  return launch_mma_mode<false>(mode, coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a,
                                grad_coord, pgrad, nullptr, rec, B, C, G, F, S, st);
}

// Shared memory of one block of the tensor-core build in `mode` (bytes;
// the constants' build takes the same).
extern "C" int conv_bwd_mma_smem(int C, int F, int S, int mode) { return 4 * cm::BwdLayout(C, F, S, mode).words; }
