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

// The tensor-core builds (csrc/conv_mma.cuh: the modes, the tiles and the
// exact W).  Block (jb, tile of kRows atoms j, shift-and-column tile); for
// each offset s and each kSlots partner slots i of p = mnbr[s, jb]:
//   the geometry pass (one pair a thread, the forward's displacement
//   x_j + shift[s, p] - x_i) into shared memory, the live slots packed;
//   phase 1, warp w the shift g = g0 + w: grad_a[j, g, f] += sum_{k, i}
//     W_k[i, j, g] gbar[p, k, i, g, f] by mma.sync (depth: the live slots);
//   phase 2, warp (q, t): wbar_k[j, i, g] = sum_f a[j, g, f] gbar[p, k, i,
//     g, f] by mma.sync (depth: the tile's columns) for the live slots of
//     tile t (eight) and the shifts g0 + q + 4 m; each pair's ubar and dbar
//     summed over those shifts in registers, then over the four q in order
//     through shared memory;
//   the chain rule per pair in FP32: rbar into the atom's coordinate sum
//     (a warp's butterfly) and the partner rows (the kRows atoms in order).
// The constants' build adds each pair's sbar, etabar and rcbar terms (as
// the FP32 build) and reduces them in warp order at the end.  The column
// sums of several shift-and-column tiles are partials the wrapper adds in a
// fixed order, as the FP32 build's column tiles: no atomics, deterministic.
namespace cm = conv_mma;

constexpr int kGeoPitch = cm::kSlots + 1;  // a padded row of the geometry and partner-row buffers
constexpr int kMmaSmemFloats = 6 * cm::kRows * kGeoPitch                 // geometry: d, fc, fc', ux, uy, uz
                               + 4 * cm::kRows * cm::kSlots * 4          // phase 2's partial sums by q
                               + cm::kRows * cm::kGTile * cm::kFTile     // the tile's features
                               + 3 * cm::kRows * kGeoPitch               // partner rows by atom
                               + cm::kWarps * 6;                         // the constants' warp sums

template <int kMode, bool kConst>
__global__ void __launch_bounds__(cm::kThreads, 1)
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
                    float* __restrict__ pgrad,           // (T, S, B, NJ, 3, C) partner side
                    float* __restrict__ cbar,            // kConst: (B, NJ, G + 2) partial sums
                    int B, int C, int G, int F, int S) {
  using M = cm::Mma<kMode>;
  extern __shared__ float smem[];
  float* geo = smem;                                           // [6][kRows][kGeoPitch]
  float* red = geo + 6 * cm::kRows * kGeoPitch;                // [4][kRows][kSlots][4]
  float* aj = red + 4 * cm::kRows * cm::kSlots * 4;            // [kRows][kGTile][kFTile]
  float* prt = aj + cm::kRows * cm::kGTile * cm::kFTile;       // [3][kRows][kGeoPitch]
  float* csum = prt + 3 * cm::kRows * kGeoPitch;               // [kWarps][6]
  __shared__ unsigned rowmask[cm::kRows];
  __shared__ int live[cm::kSlots];
#define GEO(v, r, c) geo[((v) * cm::kRows + (r)) * kGeoPitch + (c)]

  const int jb = blockIdx.x;
  const int jt = blockIdx.y;
  const int NJ = gridDim.y;
  const int g0 = (blockIdx.z % cm::g_tiles(G)) * cm::kGTile;
  const int f0 = (blockIdx.z / cm::g_tiles(G)) * cm::kFTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const int j0 = jt * cm::kRows;
  const int GF = G * F;
  const size_t kstride = size_t(C) * GF;  // gbar's k stride
  grad_coord += size_t(blockIdx.z) * B * C * 3;
  pgrad += size_t(blockIdx.z) * S * B * NJ * 3 * C;
  const float eta = scal[0];
  const float rc = scal[1];
  const float pi_rc = __fdiv_rn(cm::kPi, rc);

  // the geometry pass's row: atom j0 + warp, partner slot i0 + lane
  const int jr = j0 + warp;
  const size_t jrow = size_t(jb) * C + jr;
  const bool real_j = jr < C && mask[jrow] > 0.5f;
  const float xj0 = real_j ? coord[3 * jrow + 0] : 0.0f;
  const float xj1 = real_j ? coord[3 * jrow + 1] : 0.0f;
  const float xj2 = real_j ? coord[3 * jrow + 2] : 0.0f;

  for (int t = threadIdx.x; t < cm::kRows * cm::kGTile * cm::kFTile; t += cm::kThreads) {
    const int jj = j0 + t / (cm::kGTile * cm::kFTile);
    const int gg = g0 + (t / cm::kFTile) % cm::kGTile;
    const int ff = f0 + t % cm::kFTile;
    const size_t jrw = size_t(jb) * C + jj;
    aj[t] = (jj < C && gg < G && ff < F && mask[jrw] > 0.5f) ? a[jrw * GF + size_t(gg) * F + ff] : 0.0f;
  }
  const bool any_real = __syncthreads_or(real_j);

  // phase 1: warp w, shift g1
  const int g1 = g0 + warp;
  const bool gwarp = g1 < G;
  const float sg1 = gwarp ? shifts_g[g1] : 0.0f;
  float ga[cm::kNT][4];
#pragma unroll
  for (int nt = 0; nt < cm::kNT; ++nt) ga[nt][0] = ga[nt][1] = ga[nt][2] = ga[nt][3] = 0.0f;
  // phase 2: warp 4 q + t
  const int it = warp & 3;
  const int q2 = warp >> 2;
  constexpr int kGq = cm::kGTile / 4;  // shifts a phase-2 warp walks
  float gc0 = 0.0f, gc1 = 0.0f, gc2 = 0.0f;
  float sbm[kGq];
#pragma unroll
  for (int m = 0; m < kGq; ++m) sbm[m] = 0.0f;
  float eb = 0.0f, rbc = 0.0f;  // kConst: etabar and rcbar

  for (int s = 0; s < S; ++s) {
    const int p = mnbr[size_t(s) * B + jb];  // the same for the whole block
    float* prow = pgrad + ((size_t(s) * B + jb) * NJ + jt) * 3 * C;
    if (p < 0 || !any_real) {  // nothing to send
      for (int t = threadIdx.x; t < 3 * C; t += cm::kThreads) prow[t] = 0.0f;
      continue;
    }
    const float* sh = shift + (size_t(s) * B + p) * 3;
    const float sh0 = sh[0], sh1 = sh[1], sh2 = sh[2];
    for (int i0 = 0; i0 < C; i0 += cm::kSlots) {
      __syncthreads();  // the previous step's readers are done
      const int i = i0 + lane;
      bool vp = false;
      float xi0 = 0.0f, xi1 = 0.0f, xi2 = 0.0f;
      if (real_j && i < C) {
        const size_t pr = size_t(p) * C + i;
        vp = mask[pr] > 0.5f && !(s == 0 && i == jr);
        xi0 = coord[3 * pr + 0];
        xi1 = coord[3 * pr + 1];
        xi2 = coord[3 * pr + 2];
      }
      const cm::Geom pg = cm::pair_geometry(xj0, xj1, xj2, sh0, sh1, sh2, xi0, xi1, xi2, vp, rc, pi_rc);
      GEO(0, warp, lane) = pg.d;
      GEO(1, warp, lane) = pg.fc;
      GEO(2, warp, lane) = pg.within ? -0.5f * pi_rc * sinf(pg.d * pi_rc) : 0.0f;
      GEO(3, warp, lane) = pg.ux;
      GEO(4, warp, lane) = pg.uy;
      GEO(5, warp, lane) = pg.uz;
      const unsigned m = __ballot_sync(0xffffffffu, pg.within);
      if (lane == 0) rowmask[warp] = m;
      __syncthreads();
      unsigned livem = 0;
#pragma unroll
      for (int r = 0; r < cm::kRows; ++r) livem |= rowmask[r];
      if (livem == 0) {  // no pair in these slots: their partner rows are zero
        if (threadIdx.x < 3 * cm::kSlots) {
          const int c = threadIdx.x % cm::kSlots;
          if (i0 + c < C) prow[(threadIdx.x / cm::kSlots) * C + i0 + c] = 0.0f;
        }
        continue;  // the same for the whole block
      }
      if (warp == 0 && ((livem >> lane) & 1u)) live[__popc(livem & ((1u << lane) - 1u))] = lane;
      __syncthreads();
      const int nl = __popc(livem);
      const float* gb = gbar + (size_t(p) * 4 * C + i0) * GF;  // gbar[p, 0, i0, 0, 0]

      if (gwarp) {  // phase 1
        for (int k0 = 0; k0 < nl; k0 += M::K) {
          float gsv[2][M::NK], uv[3][2][M::NK];
          int cc[M::NK];
#pragma unroll
          for (int q = 0; q < M::NK; ++q) {
            const int pidx = k0 + M::kidx(t4, q);
            const int c = pidx < nl ? live[pidx] : -1;
            cc[q] = c;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float gs = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
              if (c >= 0) {
                const int row = gid + 8 * r;
                const float fc = GEO(1, row, c);
                if (fc != 0.0f) {
                  gs = __fmul_rn(cm::gauss(GEO(0, row, c), sg1, eta), fc);
                  ux = GEO(3, row, c);
                  uy = GEO(4, row, c);
                  uz = GEO(5, row, c);
                }
              }
              gsv[r][q] = gs;
              uv[0][r][q] = ux;
              uv[1][r][q] = uy;
              uv[2][r][q] = uz;
            }
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float w[2][M::NK];
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int q = 0; q < M::NK; ++q) w[r][q] = k == 0 ? gsv[r][q] : __fmul_rn(gsv[r][q], uv[k - 1][r][q]);
            cm::OpA aop;
            cm::make_a<kMode>(w, aop);
#pragma unroll
            for (int nt = 0; nt < cm::kNT; ++nt) {
              const int f = f0 + nt * 8 + gid;
              float bv[M::NK];
#pragma unroll
              for (int q = 0; q < M::NK; ++q)
                bv[q] = (cc[q] >= 0 && f < F) ? __ldg(gb + size_t(cc[q]) * GF + k * kstride + size_t(g1) * F + f)
                                              : 0.0f;
              cm::OpB bop;
              cm::make_b<kMode>(bv, bop);
              cm::mma<kMode>(ga[nt], aop, bop);
            }
          }
        }
      }

      if (it * 8 < nl) {  // phase 2
        float pp[4][4];   // pairs e (row gid + 8 (e >> 1), live slot it * 8 + 2 t4 + (e & 1)): ubar, dbar
        float wep[4];     // kConst: sum over g of W_c e_g
#pragma unroll
        for (int e = 0; e < 4; ++e) pp[e][0] = pp[e][1] = pp[e][2] = pp[e][3] = wep[e] = 0.0f;
        const int pcol = it * 8 + gid;  // the B operand's column
        const int ccol = pcol < nl ? live[pcol] : -1;
#pragma unroll
        for (int mq = 0; mq < kGq; ++mq) {
          const int gl = q2 + 4 * mq;
          const int gg = g0 + gl;
          if (gg >= G) break;
          float wacc[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) wacc[k][0] = wacc[k][1] = wacc[k][2] = wacc[k][3] = 0.0f;
#pragma unroll
          for (int kf = 0; kf < cm::kFTile; kf += M::K) {
            float av[2][M::NK];
            int fq[M::NK];
#pragma unroll
            for (int q = 0; q < M::NK; ++q) {
              const int fl = kf + M::kidx(t4, q);
              fq[q] = fl;
#pragma unroll
              for (int r = 0; r < 2; ++r)
                av[r][q] = fl < cm::kFTile ? aj[((gid + 8 * r) * cm::kGTile + gl) * cm::kFTile + fl] : 0.0f;
            }
            cm::OpA aop;
            cm::make_a<kMode>(av, aop);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float bv[M::NK];
#pragma unroll
              for (int q = 0; q < M::NK; ++q) {
                const int fl = fq[q];
                bv[q] = (ccol >= 0 && fl < cm::kFTile && f0 + fl < F)
                            ? __ldg(gb + size_t(ccol) * GF + k * kstride + size_t(gg) * F + f0 + fl)
                            : 0.0f;
              }
              cm::OpB bop;
              cm::make_b<kMode>(bv, bop);
              cm::mma<kMode>(wacc[k], aop, bop);
            }
          }
          const float sgv = shifts_g[gg];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gid + 8 * (e >> 1);
            const int pc = it * 8 + 2 * t4 + (e & 1);
            if (pc >= nl) continue;
            const int c = live[pc];
            const float fc = GEO(1, row, c);
            if (fc == 0.0f) continue;
            const float d = GEO(0, row, c);
            const float dd = d - sgv;
            const float ex = expf(-eta * dd * dd);
            const float gs = ex * fc;
            const float dgs = ex * (GEO(2, row, c) - 2.0f * eta * dd * fc);
            const float w0 = wacc[0][e], w1 = wacc[1][e], w2 = wacc[2][e], w3 = wacc[3][e];
            pp[e][0] = fmaf(w1, gs, pp[e][0]);
            pp[e][1] = fmaf(w2, gs, pp[e][1]);
            pp[e][2] = fmaf(w3, gs, pp[e][2]);
            const float wc = w0 + w1 * GEO(3, row, c) + w2 * GEO(4, row, c) + w3 * GEO(5, row, c);
            pp[e][3] = fmaf(wc, dgs, pp[e][3]);
            if (kConst) {
              sbm[mq] = fmaf(wc * (2.0f * eta * dd), gs, sbm[mq]);
              eb = fmaf(-wc * dd * dd, gs, eb);
              wep[e] = fmaf(wc, ex, wep[e]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = gid + 8 * (e >> 1);
          const int pc = it * 8 + 2 * t4 + (e & 1);
          if (pc >= nl) continue;
          const int c = live[pc];
          float* dst = red + ((q2 * cm::kRows + row) * cm::kSlots + c) * 4;
          dst[0] = pp[e][0];
          dst[1] = pp[e][1];
          dst[2] = pp[e][2];
          dst[3] = pp[e][3];
          if (kConst && GEO(1, row, c) != 0.0f)
            rbc = fmaf(wep[e], -GEO(2, row, c) * GEO(0, row, c) / rc, rbc);  // dfc/drc = -fc' d / rc
        }
      }
      __syncthreads();

      // the chain rule per pair: thread (atom j0 + warp, slot lane)
      float rb0 = 0.0f, rb1 = 0.0f, rb2 = 0.0f;
      if (GEO(1, warp, lane) != 0.0f) {
        float ub0 = 0.0f, ub1 = 0.0f, ub2 = 0.0f, db = 0.0f;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const float* src = red + ((qq * cm::kRows + warp) * cm::kSlots + lane) * 4;
          ub0 += src[0];
          ub1 += src[1];
          ub2 += src[2];
          db += src[3];
        }
        const float ux = GEO(3, warp, lane), uy = GEO(4, warp, lane), uz = GEO(5, warp, lane);
        const float inv_d = 1.0f / GEO(0, warp, lane);
        const float uu = ub0 * ux + ub1 * uy + ub2 * uz;
        rb0 = db * ux + (ub0 - uu * ux) * inv_d;
        rb1 = db * uy + (ub1 - uu * uy) * inv_d;
        rb2 = db * uz + (ub2 - uu * uz) * inv_d;
      }
      gc0 += warp_sum(rb0);
      gc1 += warp_sum(rb1);
      gc2 += warp_sum(rb2);
      prt[(0 * cm::kRows + warp) * kGeoPitch + lane] = -rb0;
      prt[(1 * cm::kRows + warp) * kGeoPitch + lane] = -rb1;
      prt[(2 * cm::kRows + warp) * kGeoPitch + lane] = -rb2;
      __syncthreads();
      if (threadIdx.x < 3 * cm::kSlots) {  // the tile's partner rows: its atoms in order
        const int comp = threadIdx.x / cm::kSlots;
        const int c = threadIdx.x % cm::kSlots;
        if (i0 + c < C) {
          float sum = 0.0f;
#pragma unroll
          for (int r = 0; r < cm::kRows; ++r) sum += prt[(comp * cm::kRows + r) * kGeoPitch + c];
          prow[comp * C + i0 + c] = sum;
        }
      }
    }
  }

  if (gwarp) {
#pragma unroll
    for (int nt = 0; nt < cm::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + gid + 8 * (e >> 1);
        const int f = f0 + nt * 8 + 2 * t4 + (e & 1);
        if (j < C && f < F) grad_a[(size_t(jb) * C + j) * GF + size_t(g1) * F + f] = ga[nt][e];
      }
  }
  if (lane == 0 && jr < C) {
    grad_coord[3 * jrow + 0] = gc0;
    grad_coord[3 * jrow + 1] = gc1;
    grad_coord[3 * jrow + 2] = gc2;
  }

  if (kConst) {  // one shift-and-column tile: G <= kGTile, F <= kFTile
    __syncthreads();
#pragma unroll
    for (int mq = 0; mq < kGq; ++mq) sbm[mq] = warp_sum(sbm[mq]);
    eb = warp_sum(eb);
    rbc = warp_sum(rbc);
    if (lane == 0) {
#pragma unroll
      for (int mq = 0; mq < kGq; ++mq) csum[warp * 6 + mq] = sbm[mq];
      csum[warp * 6 + 4] = eb;
      csum[warp * 6 + 5] = rbc;
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t < G + 2) {
      float sum = 0.0f;
      if (t < G) {  // shift t: phase-2 warps 4 (t % 4) + 0..3, slot t / 4
        for (int v = 0; v < 4; ++v) sum += csum[(4 * (t % 4) + v) * 6 + t / 4];
      } else {
        for (int v = 0; v < cm::kWarps; ++v) sum += csum[v * 6 + 4 + (t - G)];
      }
      cbar[(size_t(jb) * NJ + jt) * (G + 2) + t] = sum;
    }
  }
#undef GEO
}

template <int kMode, bool kConst>
int launch_mma(const float* coord, const float* mask, const float* a, const float* gbar, const int* mnbr,
               const float* shift, const float* shifts_g, const float* scal, float* grad_a,
               float* grad_coord, float* pgrad, float* cbar, int B, int C, int G, int F, int S,
               cudaStream_t stream) {
  // kernels/conv_stencil.py::MMA_BWD_SMEM computes the same number
  const int smem = int(sizeof(float)) * kMmaSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(conv_bwd_mma_kernel<kMode, kConst>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B, (C + cm::kRows - 1) / cm::kRows, cm::g_tiles(G) * cm::f_tiles(F));
  conv_bwd_mma_kernel<kMode, kConst><<<grid, cm::kThreads, smem, stream>>>(
      coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a, grad_coord, pgrad, cbar, B, C, G, F, S);
  return int(cudaGetLastError());
}

template <bool kConst>
int launch_mma_mode(int mode, const float* coord, const float* mask, const float* a, const float* gbar,
                    const int* mnbr, const float* shift, const float* shifts_g, const float* scal,
                    float* grad_a, float* grad_coord, float* pgrad, float* cbar, int B, int C, int G,
                    int F, int S, cudaStream_t st) {
  if (mode == cm::kTF32)
    return launch_mma<cm::kTF32, kConst>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a,
                                         grad_coord, pgrad, cbar, B, C, G, F, S, st);
  if (mode == cm::k3xTF32)
    return launch_mma<cm::k3xTF32, kConst>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a,
                                           grad_coord, pgrad, cbar, B, C, G, F, S, st);
  if (mode == cm::kBF16)
    return launch_mma<cm::kBF16, kConst>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a,
                                         grad_coord, pgrad, cbar, B, C, G, F, S, st);
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
// kernels/conv_stencil.py::MMA_MODES.  grad_coord (T, B*C, 3) and pgrad
// (T, S, B, NJ, 3, C) hold the partials of the T = mma_tiles shift-and-
// column tiles, NJ = ceil(C / 16) atom tiles; ``constants`` != 0 also
// writes cbar (B, NJ, G + 2) and takes one tile only.  No pair counts.
extern "C" int conv_bwd_mma_launch(const float* coord, const float* mask, const float* a,
                                   const float* gbar, const int* mnbr, const float* shift,
                                   const float* shifts_g, const float* scal, float* grad_a,
                                   float* grad_coord, float* pgrad, float* cbar, int B, int C, int G,
                                   int F, int S, int mode, int constants, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = cm::g_tiles(G) * cm::f_tiles(F);
  if (B < 1 || C < 1 || G < 1 || F < 1 || (C + cm::kRows - 1) / cm::kRows > 65535 || tiles > 64 ||
      (constants && (tiles != 1 || cbar == nullptr)))
    return int(cudaErrorInvalidValue);
  if (constants)
    return launch_mma_mode<true>(mode, coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a,
                                 grad_coord, pgrad, cbar, B, C, G, F, S, st);
  return launch_mma_mode<false>(mode, coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a,
                                grad_coord, pgrad, nullptr, B, C, G, F, S, st);
}
