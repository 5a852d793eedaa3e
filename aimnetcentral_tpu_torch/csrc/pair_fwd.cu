// Kernel D: the half-stencil sweep of a symmetric pair term on the binned
// layout.
//
// Replaces the Pallas TPU kernel aimnetcentral_tpu/kernels/pair_sweep.py
// ::_fwd_kernel_hb (pair_sweep.py:228).  For receiver bin b, every half
// offset s (the zero offset first) and every pair (i in b, j in the
// candidate bin n = nbr[s, b]) with d = |x_j + shift[s, b] - x_i| < cutoff it
// forms e_ij = c_ij g(d, s_i, s_j) (csrc/pair_terms.cuh; c_ij = p_i . r_j for
// a bilinear term, else 1) and adds it to out[b, i] (receiver) and, for
// s > 0, to the mirror row me[s, b, tile, j]; the wrapper sums the row tiles
// in a fixed order and sends the mirror rows home with one static gather
// through the inverse stencil table.  At s = 0 the bin meets itself in both
// orderings, the self pair is dropped, and only the receiver side is summed.
// Non-pairs take d2 := 1 before the sqrt and never reach the term.
//
// Design: one block per (receiver bin, tile of at most 32 rows), 8 warps.
// The block keeps its rows' coordinates and extras in shared memory for the
// whole sweep; per offset it walks the candidate bin in tiles of 32 columns,
// one per lane, each lane holding its candidate in registers.  Warp w takes
// rows w, w+8, ...: a row's sum over the lanes is a butterfly of shuffles
// added by lane 0 to the row's accumulator (each row belongs to one warp);
// a lane's column sum over its warp's rows stays in a register, and the 8
// warps' column sums are added in warp order.  No two threads write one
// output and there are no atomics: the result is deterministic.  Extras rows
// have an odd stride, so the lanes' reads of their candidates' extras are
// free of bank conflicts.  Any capacity fits; only the extras width K is
// bounded by shared memory (kernels/pair_sweep.py::row_tile).
//
// What bounds it on an H100: the function reads each atom's coordinates and
// extras once and writes one sum an atom, so its bytes are small (a few MB
// at 10,000 atoms); its least time is set by the FP32 operations of the real
// pairs within the cutoff, counted per unordered pair as
//     DSF (exp envelope, SR part subtracted)   38
//     D3 coordination number                   18
//     D3(BJ) energy, V = 5 S                   40 + 2 V  (80 at S = 4)
// (geometry 9: three differences, the square sum and the sqrt; a special
// function or a division counts one).  This first version visits every
// slot pair of the half stencil (at the 10,000-atom LR grid, 87 M slot
// pairs against 6.4 M real pairs within 15 A), so it does about 14 times the
// needed geometry; a warp skips the term where none of its pairs is within
// the cutoff.  Skipping empty and distant bin pairs, and sorting atoms
// within a bin, are the next steps.

#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;  // candidate columns per tile: one per lane

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <class Term>
__global__ void __launch_bounds__(kThreads)
pair_fwd_kernel(TermConsts tc,
                const float* __restrict__ coord,  // (B*C, 3)
                const float* __restrict__ mask,   // (B*C)
                const float* __restrict__ ext,    // (B*C, K) = [p (V), r (V), s]
                const float* __restrict__ shift,  // (S, B, 3)
                const int* __restrict__ nbr,      // (S, B), -1 = no candidate
                float* __restrict__ out,          // (B*C) receiver sums
                float* __restrict__ me,           // (S, B, NT, C) mirror sums
                int B, int C, int K, int S, int TI) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const int NT = gridDim.y;
  const int i0 = tile * TI;
  const int ni = min(TI, C - i0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int V = (K - 1) / 2;
  const int KP = K | 1;  // odd row stride of the extras
  float* xi = smem;               // TI*3  receiver coordinates
  float* mi = xi + 3 * TI;        // TI
  float* ei = mi + TI;            // TI*KP receiver extras
  float* xj = ei + TI * KP;       // 32*3  candidate coordinates + shift
  float* mj = xj + 3 * kCols;     // 32
  float* ej = mj + kCols;         // 32*KP candidate extras
  float* racc = ej + kCols * KP;  // TI    receiver sums
  float* cw = racc + TI;          // 8*32  the warps' column sums

  for (int t = tid; t < ni; t += kThreads) {
    const size_t row = size_t(b) * C + i0 + t;
    xi[3 * t + 0] = coord[3 * row + 0];
    xi[3 * t + 1] = coord[3 * row + 1];
    xi[3 * t + 2] = coord[3 * row + 2];
    mi[t] = mask[row];
    racc[t] = 0.0f;
  }
  for (int t = tid; t < ni * K; t += kThreads) {
    const int il = t / K;
    const int k = t - il * K;
    ei[il * KP + k] = ext[(size_t(b) * C + i0 + il) * K + k];
  }
  const float cutoff = tc.c[0];

  for (int s = 0; s < S; ++s) {
    const int n = nbr[size_t(s) * B + b];
    float* mrow = me + ((size_t(s) * B + b) * NT + tile) * C;
    if (n < 0 || s == 0) {  // no mirror: a gas-phase step without a candidate, or s = 0
      for (int t = tid; t < C; t += kThreads) mrow[t] = 0.0f;
      if (n < 0) continue;
    }
    const float sx = shift[(size_t(s) * B + b) * 3 + 0];
    const float sy = shift[(size_t(s) * B + b) * 3 + 1];
    const float sz = shift[(size_t(s) * B + b) * 3 + 2];
    for (int j0 = 0; j0 < C; j0 += kCols) {
      const int nj = min(kCols, C - j0);
      __syncthreads();  // the previous tile's readers of xj, ej and cw are done
      for (int t = tid; t < nj; t += kThreads) {
        const size_t row = size_t(n) * C + j0 + t;
        xj[3 * t + 0] = coord[3 * row + 0] + sx;
        xj[3 * t + 1] = coord[3 * row + 1] + sy;
        xj[3 * t + 2] = coord[3 * row + 2] + sz;
        mj[t] = mask[row];
      }
      for (int t = tid; t < nj * K; t += kThreads) {
        const int jl = t / K;
        const int k = t - jl * K;
        ej[jl * KP + k] = ext[(size_t(n) * C + j0 + jl) * K + k];
      }
      __syncthreads();
      const bool col = lane < nj;
      const float cx = col ? xj[3 * lane + 0] : 0.0f;
      const float cy = col ? xj[3 * lane + 1] : 0.0f;
      const float cz = col ? xj[3 * lane + 2] : 0.0f;
      const bool creal = col && mj[lane] > 0.5f;
      const float* ejl = ej + lane * KP;
      float colsum = 0.0f;
      for (int il = w; il < ni; il += kWarps) {
        float e = 0.0f;
        const float dx = cx - xi[3 * il + 0];
        const float dy = cy - xi[3 * il + 1];
        const float dz = cz - xi[3 * il + 2];
        const bool vp = creal && mi[il] > 0.5f && !(s == 0 && i0 + il == j0 + lane);
        const float d = sqrtf(vp ? dx * dx + dy * dy + dz * dz : 1.0f);
        if (vp && d < cutoff) {
          const float* eil = ei + il * KP;
          float c = 1.0f;
          if (Term::kBilinear) {
            c = 0.0f;
            for (int k = 0; k < V; ++k) c = fmaf(eil[k], ejl[V + k], c);
          }
          e = c * Term::g(tc, d, eil[2 * V], ejl[2 * V]);
        }
        colsum += e;
        const float rsum = warp_sum(e);
        if (lane == 0) racc[il] += rsum;
      }
      cw[w * kCols + lane] = colsum;
      __syncthreads();
      if (s > 0 && tid < nj) {
        float m = 0.0f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) m += cw[ww * kCols + tid];
        mrow[j0 + tid] = m;
      }
    }
  }

  __syncthreads();
  for (int t = tid; t < ni; t += kThreads) out[size_t(b) * C + i0 + t] = racc[t];
}

// Shared-memory bytes of one block; kernels/pair_sweep.py::fwd_smem_bytes
// computes the same number to choose TI.
size_t smem_bytes(int K, int TI) {
  const size_t kp = size_t(K | 1);
  return sizeof(float) *
         (size_t(TI) * (4 + kp) + size_t(kCols) * (4 + kp) + size_t(TI) + size_t(kWarps) * kCols);
}

template <class Term>
int launch(const TermConsts& tc, const float* coord, const float* mask, const float* ext,
           const float* shift, const int* nbr, float* out, float* me, int B, int C, int K, int S,
           int TI, cudaStream_t stream) {
  const size_t smem = smem_bytes(K, TI);
  cudaError_t err = cudaFuncSetAttribute(pair_fwd_kernel<Term>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(B, (C + TI - 1) / TI);
  pair_fwd_kernel<Term><<<grid, kThreads, smem, stream>>>(tc, coord, mask, ext, shift, nbr, out,
                                                          me, B, C, K, S, TI);
  return int(cudaGetLastError());
}

}  // namespace

// term: 0 DSF Coulomb, 1 D3 coordination number, 2 D3(BJ) energy.
// consts: host pointer to 8 floats (the cutoff, then the term's constants).
extern "C" int pair_fwd_launch(const float* consts, const float* coord, const float* mask,
                               const float* ext, const float* shift, const int* nbr, float* out,
                               float* me, int term, int B, int C, int K, int S, int TI,
                               void* stream) {
  if (TI < 1 || TI > C || K < 1 || K % 2 != 1) return int(cudaErrorInvalidValue);
  TermConsts tc;
  for (int i = 0; i < 8; ++i) tc.c[i] = consts[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (term) {
    case 0:
      return launch<pair_terms::DsfTerm>(tc, coord, mask, ext, shift, nbr, out, me, B, C, K, S,
                                         TI, st);
    case 1:
      return launch<pair_terms::D3CnTerm>(tc, coord, mask, ext, shift, nbr, out, me, B, C, K, S,
                                          TI, st);
    case 2:
      return launch<pair_terms::D3EnergyTerm>(tc, coord, mask, ext, shift, nbr, out, me, B, C, K,
                                              S, TI, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
