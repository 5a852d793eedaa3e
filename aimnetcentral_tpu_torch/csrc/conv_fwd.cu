// Kernel A: the stencil ConvSV contraction on the binned layout.
//
// Replaces the Pallas TPU kernel aimnetcentral_tpu/kernels/conv_stencil.py
// ::_fwd_kernel (conv_stencil.py:289).  For receiver bin b, every stencil
// offset s and every pair (i in b, j in the candidate bin n = nbr[s, b]) it
// forms
//     d = |x_j + shift[s, b] - x_i|,  fc = 0.5 (cos(pi d / rc) + 1) for d < rc,
//     gs_g = exp(-eta (d - s_g)^2) fc,   u = (x_j + shift - x_i) / d,
// and accumulates out[b, k, i, g, f] += W_k[i, j, g] a[n, j, g, f] with
// W = [gs, gs u_x, gs u_y, gs u_z].  The self pair i == j is dropped only at
// the zero offset s = 0 (stencil_offsets puts (0,0,0) first); at other
// offsets the same bin is a real periodic image.  Non-pairs take d2 := 1
// before the sqrt so nothing divides by zero.
//
// Design: one warp per receiver slot row, eight to a block; a warp whose
// receiver is a padding slot writes its zero rows and is done.  Per offset
// the warp tests 32 candidate slots at a time, one per lane (the mask is
// tested, so no slot order is assumed), and a ballot of "real pair within
// rc" gives the pairs it contracts, walked in ascending slot order.  The
// lane that tested a pair computes d, fc and u once; shuffles hand them to
// the warp.  Lanes own columns c = lane + 32 m of the G*F feature row, so
// each lane forms gs for its columns' g (one exp per pair and column), reads
// a[j, c] (each warp-wide load is 128 contiguous bytes) and keeps the four
// rows k of its columns in registers across the whole stencil.  So the work
// is in proportion to the real pairs within rc, not to the C x C slot pairs
// of every offset.  No two warps write the same output and every sum is
// taken in a fixed order: no atomics, deterministic.  FP32 on CUDA cores:
// the exact tier has no TF32.
//
// Column tiles: a row wider than a lane's M columns hold (a fused ensemble
// stacks its members' features, G*F = 1,088 for four flagship members) is
// cut into T tiles of W columns, a second grid axis; a tile's warps run the
// same ballot and pair walk on their own columns c = col0 + lane + 32 m.
// The geometry (d, fc, u) is recomputed per tile, little beside the
// per-column exp that every tile pays anyway.  One tile (T = 1, W = G*F) is
// the single model's launch.
//
// What bounds it on an H100: the function needs 2 * 4 G F FLOP per real
// pair within rc and reads each feature once, so its least time is set by
// the bytes it moves (the output is four times the features).  This kernel
// reads a[j, :] once per pair from L2/L1 (each candidate row is read by the
// ~48 receivers within rc of it), and a warp walks its pairs one after the
// other, so the latency of those loads bounds it: the row's M loads are
// issued together ahead of the arithmetic, and three blocks an SM keep 24
// warps' loads in flight.  The FMAs use a few percent of the FP32 rate.

#include <cuda_runtime.h>

#include "conv_mma.cuh"

namespace {

constexpr int kWarps = 8;  // receiver rows a block: one warp each
constexpr int kThreads = 32 * kWarps;
constexpr float kPi = 3.14159265358979323846f;

// Three blocks an SM at M = 9 (at most 85 registers a thread, a few spilled):
// on an H100 at the flagship's shapes that ran faster than two blocks of
// 112 registers without spills; the loads in flight are what count here.
template <int M>  // columns of the G*F row a lane owns: c = lane + 32 m, m < M
__global__ void __launch_bounds__(kThreads, M <= 9 ? 3 : 1)
conv_fwd_kernel(const float* __restrict__ coord,     // (B*C, 3)
                const float* __restrict__ mask,      // (B*C)
                const float* __restrict__ a,         // (B*C, G*F)
                const int* __restrict__ nbr,         // (S, B), -1 = no candidate
                const float* __restrict__ shift,     // (S, B, 3)
                const float* __restrict__ shifts_g,  // (G)
                const float* __restrict__ scal,      // (2) eta, rc
                float* __restrict__ out,             // (B, 4, C, G*F)
                int* __restrict__ pair_count,        // (B*C) or null
                int B, int C, int G, int F, int S, int W) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // receiver slot b*C + i
  if (row >= B * C) return;  // whole warps only
  const int b = row / C;
  const int i = row - b * C;
  const int GF = G * F;
  const int col0 = blockIdx.y * W;        // this tile's first column
  const int ncol = min(W, GF - col0);     // and its width
  const float eta = scal[0];
  const float rc = scal[1];
  const float pi_rc = kPi / rc;

  float sg[M];
  float acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int cl = lane + 32 * m;
    sg[m] = cl < ncol ? shifts_g[(col0 + cl) / F] : 0.0f;
    acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.0f;
  }
  int npair = 0;

  if (mask[row] > 0.5f) {
    const float xi0 = coord[3 * row + 0];
    const float xi1 = coord[3 * row + 1];
    const float xi2 = coord[3 * row + 2];
    for (int s = 0; s < S; ++s) {
      const int n = nbr[size_t(s) * B + b];
      if (n < 0) continue;  // gas-phase step without a candidate bin
      const float* sh = shift + (size_t(s) * B + b) * 3;
      const float sh0 = sh[0], sh1 = sh[1], sh2 = sh[2];
      for (int j0 = 0; j0 < C; j0 += 32) {
        const int j = j0 + lane;
        float d = 1.0f, fc = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
        bool within = false;
        if (j < C) {
          const size_t cr = size_t(n) * C + j;
          const float dx = coord[3 * cr + 0] + sh0 - xi0;
          const float dy = coord[3 * cr + 1] + sh1 - xi1;
          const float dz = coord[3 * cr + 2] + sh2 - xi2;
          const bool vp = mask[cr] > 0.5f && !(s == 0 && j == i);
          d = sqrtf(vp ? dx * dx + dy * dy + dz * dz : 1.0f);
          within = vp && d < rc;
          if (within) {
            fc = 0.5f * (cosf(d * pi_rc) + 1.0f);
            ux = dx / d;
            uy = dy / d;
            uz = dz / d;
          }
        }
        unsigned live = __ballot_sync(0xffffffffu, within);
        while (live) {  // the same for every lane of the warp
          const int src = __ffs(live) - 1;
          live &= live - 1;
          const float pd = __shfl_sync(0xffffffffu, d, src);
          const float pfc = __shfl_sync(0xffffffffu, fc, src);
          const float pux = __shfl_sync(0xffffffffu, ux, src);
          const float puy = __shfl_sync(0xffffffffu, uy, src);
          const float puz = __shfl_sync(0xffffffffu, uz, src);
          // the candidate's row first, so that its M loads are in flight together
          const float* arow = a + (size_t(n) * C + j0 + src) * GF + col0;
          float avs[M];
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int cl = lane + 32 * m;
            avs[m] = cl < ncol ? __ldg(arow + cl) : 0.0f;
          }
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int cl = lane + 32 * m;
            if (cl < ncol) {
              const float dd = pd - sg[m];
              const float gs = expf(-eta * dd * dd) * pfc;
              const float av = avs[m];
              acc[m][0] = fmaf(gs, av, acc[m][0]);
              acc[m][1] = fmaf(gs * pux, av, acc[m][1]);
              acc[m][2] = fmaf(gs * puy, av, acc[m][2]);
              acc[m][3] = fmaf(gs * puz, av, acc[m][3]);
            }
          }
          ++npair;
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int cl = lane + 32 * m;
    if (cl < ncol) {
#pragma unroll
      for (int k = 0; k < 4; ++k) out[((size_t(b) * 4 + k) * C + i) * GF + col0 + cl] = acc[m][k];
    }
  }
  if (pair_count != nullptr && lane == 0 && blockIdx.y == 0) pair_count[row] = npair;
}

template <int M>
int launch(const float* coord, const float* mask, const float* a, const int* nbr,
           const float* shift, const float* shifts_g, const float* scal, float* out,
           int* pair_count, int B, int C, int G, int F, int S, int W, cudaStream_t stream) {
  const int rows = B * C;
  const dim3 grid((rows + kWarps - 1) / kWarps, (G * F + W - 1) / W);
  conv_fwd_kernel<M><<<grid, kThreads, 0, stream>>>(coord, mask, a, nbr, shift, shifts_g, scal, out,
                                                    pair_count, B, C, G, F, S, W);
  return int(cudaGetLastError());
}

// The tensor-core builds (csrc/conv_mma.cuh: the modes, the tiles and the
// exact W): block (b, receiver tile of kRows slots, shift-and-column tile),
// warp w the radial shift g0 + w.  For each stencil offset and each kSlots
// candidate slots: the geometry pass (one pair a thread) into shared memory,
// the live slots packed, then out[k, i, g, f] += W_k[i, j, g] a[j, g, f] by
// mma.sync over the live slots, four k's a depth step sharing each B
// operand.  Every output element is written once, every sum in a fixed
// order: no atomics, deterministic.
namespace cm = conv_mma;

template <int kMode>
__global__ void __launch_bounds__(cm::kThreads, 1)
conv_fwd_mma_kernel(const float* __restrict__ coord,     // (B*C, 3)
                    const float* __restrict__ mask,      // (B*C)
                    const float* __restrict__ a,         // (B*C, G*F)
                    const int* __restrict__ nbr,         // (S, B), -1 = no candidate
                    const float* __restrict__ shift,     // (S, B, 3)
                    const float* __restrict__ shifts_g,  // (G)
                    const float* __restrict__ scal,      // (2) eta, rc
                    float* __restrict__ out,             // (B, 4, C, G*F)
                    int B, int C, int G, int F, int S) {
  using M = cm::Mma<kMode>;
  __shared__ float geo[5][cm::kRows][cm::kSlots + 1];  // d, fc (0: no pair), ux, uy, uz
  __shared__ unsigned rowmask[cm::kRows];
  __shared__ int live[cm::kSlots];

  const int b = blockIdx.x;
  const int i0 = blockIdx.y * cm::kRows;
  const int gt = blockIdx.z % cm::g_tiles(G);
  const int f0 = (blockIdx.z / cm::g_tiles(G)) * cm::kFTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const int g = gt * cm::kGTile + warp;
  const bool gwarp = g < G;
  const int GF = G * F;
  const float eta = scal[0];
  const float rc = scal[1];
  const float pi_rc = __fdiv_rn(cm::kPi, rc);
  const float sg = gwarp ? shifts_g[g] : 0.0f;

  // the geometry pass: row warp (receiver slot i0 + warp), slot lane
  const int gi = i0 + warp;
  const size_t grow = size_t(b) * C + gi;
  const bool real_i = gi < C && mask[grow] > 0.5f;
  const float xi0 = real_i ? coord[3 * grow + 0] : 0.0f;
  const float xi1 = real_i ? coord[3 * grow + 1] : 0.0f;
  const float xi2 = real_i ? coord[3 * grow + 2] : 0.0f;
  const bool any_real = __syncthreads_or(real_i);

  float acc[4][cm::kNT][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int nt = 0; nt < cm::kNT; ++nt) acc[k][nt][0] = acc[k][nt][1] = acc[k][nt][2] = acc[k][nt][3] = 0.0f;

  for (int s = 0; any_real && s < S; ++s) {
    const int n = nbr[size_t(s) * B + b];
    if (n < 0) continue;  // gas-phase step without a candidate bin
    const float* sh = shift + (size_t(s) * B + b) * 3;
    const float sh0 = sh[0], sh1 = sh[1], sh2 = sh[2];
    for (int j0 = 0; j0 < C; j0 += cm::kSlots) {
      __syncthreads();  // the previous step's readers are done
      const int j = j0 + lane;
      bool vp = false;
      float xj0 = 0.0f, xj1 = 0.0f, xj2 = 0.0f;
      if (real_i && j < C) {
        const size_t cr = size_t(n) * C + j;
        vp = mask[cr] > 0.5f && !(s == 0 && j == gi);
        xj0 = coord[3 * cr + 0];
        xj1 = coord[3 * cr + 1];
        xj2 = coord[3 * cr + 2];
      }
      const cm::Geom pg = cm::pair_geometry(xj0, xj1, xj2, sh0, sh1, sh2, xi0, xi1, xi2, vp, rc, pi_rc);
      geo[0][warp][lane] = pg.d;
      geo[1][warp][lane] = pg.fc;
      geo[2][warp][lane] = pg.ux;
      geo[3][warp][lane] = pg.uy;
      geo[4][warp][lane] = pg.uz;
      const unsigned m = __ballot_sync(0xffffffffu, pg.within);
      if (lane == 0) rowmask[warp] = m;
      __syncthreads();
      unsigned livem = 0;
#pragma unroll
      for (int r = 0; r < cm::kRows; ++r) livem |= rowmask[r];
      if (livem == 0) continue;  // the same for the whole block
      if (warp == 0 && ((livem >> lane) & 1u)) live[__popc(livem & ((1u << lane) - 1u))] = lane;
      __syncthreads();
      const int nl = __popc(livem);
      if (!gwarp) continue;
      for (int k0 = 0; k0 < nl; k0 += M::K) {
        // this lane's pairs: rows gid, gid + 8; depth k0 + kidx(q) -> live slot
        float w[4][2][M::NK];
        float av[cm::kNT][M::NK];
#pragma unroll
        for (int q = 0; q < M::NK; ++q) {
          const int p = k0 + M::kidx(t4, q);
          const int c = p < nl ? live[p] : -1;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float gs = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
            if (c >= 0) {
              const int row = gid + 8 * r;
              const float fc = geo[1][row][c];
              if (fc != 0.0f) {
                gs = __fmul_rn(cm::gauss(geo[0][row][c], sg, eta), fc);
                ux = geo[2][row][c];
                uy = geo[3][row][c];
                uz = geo[4][row][c];
              }
            }
            w[0][r][q] = gs;
            w[1][r][q] = __fmul_rn(gs, ux);
            w[2][r][q] = __fmul_rn(gs, uy);
            w[3][r][q] = __fmul_rn(gs, uz);
          }
          // a live slot holds a real atom (it has a pair within rc)
          const float* arow = a + (size_t(n) * C + j0 + (c >= 0 ? c : 0)) * GF + size_t(g) * F;
#pragma unroll
          for (int nt = 0; nt < cm::kNT; ++nt) {
            const int f = f0 + nt * 8 + gid;
            av[nt][q] = (c >= 0 && f < F) ? __ldg(arow + f) : 0.0f;
          }
        }
        cm::OpB bop[cm::kNT];
#pragma unroll
        for (int nt = 0; nt < cm::kNT; ++nt) cm::make_b<kMode>(av[nt], bop[nt]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          cm::OpA aop;
          cm::make_a<kMode>(w[k], aop);
#pragma unroll
          for (int nt = 0; nt < cm::kNT; ++nt) cm::mma<kMode>(acc[k][nt], aop, bop[nt]);
        }
      }
    }
  }

  if (!gwarp) return;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int nt = 0; nt < cm::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + gid + 8 * (e >> 1);
        const int f = f0 + nt * 8 + 2 * t4 + (e & 1);
        if (i < C && f < F) out[((size_t(b) * 4 + k) * C + i) * GF + size_t(g) * F + f] = acc[k][nt][e];
      }
}

template <int kMode>
int launch_mma(const float* coord, const float* mask, const float* a, const int* nbr, const float* shift,
               const float* shifts_g, const float* scal, float* out, int B, int C, int G, int F, int S,
               cudaStream_t stream) {
  const dim3 grid(B, (C + cm::kRows - 1) / cm::kRows, cm::g_tiles(G) * cm::f_tiles(F));
  conv_fwd_mma_kernel<kMode><<<grid, cm::kThreads, 0, stream>>>(coord, mask, a, nbr, shift, shifts_g, scal,
                                                                out, B, C, G, F, S);
  return int(cudaGetLastError());
}

}  // namespace

// M, the columns a lane owns, and W, the columns a tile owns, are
// kernels/conv_stencil.py::col_tiles.
extern "C" int conv_fwd_launch(const float* coord, const float* mask, const float* a,
                               const int* nbr, const float* shift, const float* shifts_g,
                               const float* scal, float* out, int* pair_count, int B, int C,
                               int G, int F, int S, int M, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || W < 1 || W > 32 * M || (G * F + W - 1) / W > 65535)
    return int(cudaErrorInvalidValue);
  if (M == 9)
    return launch<9>(coord, mask, a, nbr, shift, shifts_g, scal, out, pair_count, B, C, G, F,
                     S, W, st);
  if (M == 17)
    return launch<17>(coord, mask, a, nbr, shift, shifts_g, scal, out, pair_count, B, C, G,
                      F, S, W, st);
  return int(cudaErrorInvalidValue);
}

// The tensor-core builds: mode 1 TF32, 2 3xTF32, 3 bf16 (conv_mma.cuh);
// kernels/conv_stencil.py::MMA_MODES.  No pair counts.
extern "C" int conv_fwd_mma_launch(const float* coord, const float* mask, const float* a,
                                   const int* nbr, const float* shift, const float* shifts_g,
                                   const float* scal, float* out, int B, int C, int G, int F, int S,
                                   int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || G < 1 || F < 1 || (C + cm::kRows - 1) / cm::kRows > 65535 ||
      cm::g_tiles(G) * cm::f_tiles(F) > 65535)
    return int(cudaErrorInvalidValue);
  if (mode == cm::kTF32)
    return launch_mma<cm::kTF32>(coord, mask, a, nbr, shift, shifts_g, scal, out, B, C, G, F, S, st);
  if (mode == cm::k3xTF32)
    return launch_mma<cm::k3xTF32>(coord, mask, a, nbr, shift, shifts_g, scal, out, B, C, G, F, S, st);
  if (mode == cm::kBF16)
    return launch_mma<cm::kBF16>(coord, mask, a, nbr, shift, shifts_g, scal, out, B, C, G, F, S, st);
  return int(cudaErrorInvalidValue);
}
