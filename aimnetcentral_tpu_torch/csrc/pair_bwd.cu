// Kernel E: the fused adjoint of kernel D (csrc/pair_fwd.cu).
//
// Replaces the Pallas TPU kernel aimnetcentral_tpu/kernels/pair_sweep.py
// ::_bwd_kernel_hb (pair_sweep.py:283).  It walks the same half stencil as
// kernel D.  Given the cotangent ct of the per-atom sums, a pair (i in bin
// b, j in n = nbr[s, b]) within the cutoff carries cbar = ct_i + ct_j
// (ct_i alone at s = 0, where the pair reaches only the receiver's sum),
// and with e = c g(d, s_i, s_j), c = p_i . r_j or 1, u = (x_j + shift - x_i)/d:
//     dd = cbar c dg/dd:   receiver coordinates -= dd u, candidate += dd u
//     receiver s_i += cbar c dg/ds_i,  candidate s_j += cbar c dg/ds_j
//     bilinear:  receiver p_i += cbar g r_j,  candidate r_j += cbar g p_i
// Outputs:
//   gc (B*C, 3), ge (B*C, V+1) = [p, s]: the receiver side, resident;
//   gmc (S, B, NT, 3, C), gme (S, B, NT, V+1, C) = [r, s]: the candidate
//     side as per-(offset, bin, row tile) rows.  The wrapper sums the tiles
//     in a fixed order; the lane sums of gmc are the lattice-shift adjoint
//     (the shift rides on the candidate coordinates, so this carries the
//     stress), and one static gather through the inverse stencil table
//     brings the rows home to the candidate atoms.
// Every output element is written by one thread of one block: no atomics,
// and the result is deterministic.  Only valid pairs reach the term, and
// non-pairs take d2 := 1 before the sqrt, so every term stays finite.
//
// Design: the blocks, tiles and warp roles of kernel D.  A row's receiver
// adjoint (3 coordinates + s) is a butterfly of shuffles over the lanes,
// added by lane 0; a lane's candidate adjoint stays in registers over its
// warp's rows, and the 8 warps' partials are added in warp order.  For the
// bilinear term each pair's weight cbar g goes to a (rows x 32) matrix in
// shared memory, and the vector adjoints are two small contractions of it
// after each tile (p with the candidates' r, r with the receivers' p).
//
// What bounds it on an H100: as for kernel D, the bytes are small and the
// least time is set by the FP32 operations of the real pairs within the
// cutoff, counted per unordered pair as
//     DSF (exp envelope, SR part subtracted)   75
//     D3 coordination number                   42
//     D3(BJ) energy, V = 5 S                   115 + 4 V  (195 at S = 4)
// (the forward's operations, the derivatives, and the coordinate chain:
// 1/d, three products, nine adds).  This first version visits every slot
// pair of the half stencil, like kernel D.

#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;  // candidate columns per tile: one per lane
constexpr int kWS = kCols + 1;  // row stride of the bilinear weight matrix

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <class Term>
__global__ void __launch_bounds__(kThreads)
pair_bwd_kernel(TermConsts tc,
                const float* __restrict__ coord,  // (B*C, 3)
                const float* __restrict__ mask,   // (B*C)
                const float* __restrict__ ext,    // (B*C, K) = [p (V), r (V), s]
                const float* __restrict__ shift,  // (S, B, 3)
                const int* __restrict__ nbr,      // (S, B), -1 = no candidate
                const float* __restrict__ ct,     // (B*C) cotangent of the sums
                float* __restrict__ gc,           // (B*C, 3) receiver side
                float* __restrict__ ge,           // (B*C, V+1) receiver side [p, s]
                float* __restrict__ gmc,          // (S, B, NT, 3, C) candidate side
                float* __restrict__ gme,          // (S, B, NT, V+1, C) candidate side [r, s]
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
  const int KP = K | 1;
  float* xi = smem;                 // TI*3
  float* mi = xi + 3 * TI;          // TI
  float* ci = mi + TI;              // TI    receiver cotangents
  float* ei = ci + TI;              // TI*KP
  float* xj = ei + TI * KP;         // 32*3
  float* mj = xj + 3 * kCols;       // 32
  float* cj = mj + kCols;           // 32
  float* ej = cj + kCols;           // 32*KP
  float* ra = ej + kCols * KP;      // TI*4  receiver adjoint: x, y, z, s
  float* rp = ra + 4 * TI;          // TI*V  receiver adjoint of p
  float* wm = rp + TI * V;          // TI*33 bilinear pair weights (V > 0)
  float* cw = wm + (V > 0 ? TI * kWS : 0);  // 8*4*32 the warps' candidate partials

  for (int t = tid; t < ni; t += kThreads) {
    const size_t row = size_t(b) * C + i0 + t;
    xi[3 * t + 0] = coord[3 * row + 0];
    xi[3 * t + 1] = coord[3 * row + 1];
    xi[3 * t + 2] = coord[3 * row + 2];
    mi[t] = mask[row];
    ci[t] = ct[row];
    ra[4 * t + 0] = ra[4 * t + 1] = ra[4 * t + 2] = ra[4 * t + 3] = 0.0f;
  }
  for (int t = tid; t < ni * K; t += kThreads) {
    const int il = t / K;
    const int k = t - il * K;
    ei[il * KP + k] = ext[(size_t(b) * C + i0 + il) * K + k];
  }
  for (int t = tid; t < ni * V; t += kThreads) rp[t] = 0.0f;
  const float cutoff = tc.c[0];

  for (int s = 0; s < S; ++s) {
    const int n = nbr[size_t(s) * B + b];
    const size_t side = (size_t(s) * B + b) * NT + tile;
    float* crow = gmc + side * 3 * C;
    float* erow = gme + side * (V + 1) * C;
    if (n < 0) {  // gas-phase step without a candidate: nothing to send
      for (int t = tid; t < 3 * C; t += kThreads) crow[t] = 0.0f;
      for (int t = tid; t < (V + 1) * C; t += kThreads) erow[t] = 0.0f;
      continue;
    }
    const float sx = shift[(size_t(s) * B + b) * 3 + 0];
    const float sy = shift[(size_t(s) * B + b) * 3 + 1];
    const float sz = shift[(size_t(s) * B + b) * 3 + 2];
    const float mirror = s > 0 ? 1.0f : 0.0f;
    for (int j0 = 0; j0 < C; j0 += kCols) {
      const int nj = min(kCols, C - j0);
      __syncthreads();  // the previous tile's readers of xj, ej, wm and cw are done
      for (int t = tid; t < nj; t += kThreads) {
        const size_t row = size_t(n) * C + j0 + t;
        xj[3 * t + 0] = coord[3 * row + 0] + sx;
        xj[3 * t + 1] = coord[3 * row + 1] + sy;
        xj[3 * t + 2] = coord[3 * row + 2] + sz;
        mj[t] = mask[row];
        cj[t] = ct[row];
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
      const float ctj = col ? mirror * cj[lane] : 0.0f;
      const float* ejl = ej + lane * KP;
      float jx = 0.0f, jy = 0.0f, jz = 0.0f, js = 0.0f;  // this lane's candidate adjoint
      for (int il = w; il < ni; il += kWarps) {
        float fx = 0.0f, fy = 0.0f, fz = 0.0f, fs = 0.0f, wgt = 0.0f;
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
          float g, gd, gsi, gsj;
          Term::grad(tc, d, eil[2 * V], ejl[2 * V], g, gd, gsi, gsj);
          const float cbar = ci[il] + ctj;
          const float dd = cbar * c * gd / d;
          fx = dd * dx;
          fy = dd * dy;
          fz = dd * dz;
          fs = cbar * c * gsi;
          js += cbar * c * gsj;
          wgt = cbar * g;
        }
        jx += fx;
        jy += fy;
        jz += fz;
        fx = warp_sum(fx);
        fy = warp_sum(fy);
        fz = warp_sum(fz);
        fs = warp_sum(fs);
        if (lane == 0) {
          ra[4 * il + 0] -= fx;
          ra[4 * il + 1] -= fy;
          ra[4 * il + 2] -= fz;
          ra[4 * il + 3] += fs;
        }
        if (Term::kBilinear) wm[il * kWS + lane] = wgt;
      }
      float* cwl = cw + w * 4 * kCols + lane;
      cwl[0] = jx;
      cwl[kCols] = jy;
      cwl[2 * kCols] = jz;
      cwl[3 * kCols] = js;
      __syncthreads();
      if (tid < nj) {  // the candidate rows of this tile's columns
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int ww = 0; ww < kWarps; ++ww) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += cw[(ww * 4 + q) * kCols + tid];
        }
        crow[0 * C + j0 + tid] = acc[0];
        crow[1 * C + j0 + tid] = acc[1];
        crow[2 * C + j0 + tid] = acc[2];
        erow[V * C + j0 + tid] = acc[3];
      }
      if (Term::kBilinear) {
        // receiver p_i += sum_j w_ij r_j  (each (i, k) owned by one thread)
        for (int o = tid; o < ni * V; o += kThreads) {
          const int il = o / V;
          const int k = o - il * V;
          float acc = 0.0f;
          for (int jl = 0; jl < nj; ++jl) acc = fmaf(wm[il * kWS + jl], ej[jl * KP + V + k], acc);
          rp[o] += acc;
        }
        // candidate r_j = sum_i w_ij p_i  (lanes on neighbouring columns)
        for (int o = tid; o < nj * V; o += kThreads) {
          const int k = o / nj;
          const int jl = o - k * nj;
          float acc = 0.0f;
          for (int il = 0; il < ni; ++il) acc = fmaf(wm[il * kWS + jl], ei[il * KP + k], acc);
          erow[k * C + j0 + jl] = acc;
        }
      }
    }
  }

  __syncthreads();
  for (int t = tid; t < ni; t += kThreads) {
    const size_t row = size_t(b) * C + i0 + t;
    gc[3 * row + 0] = ra[4 * t + 0];
    gc[3 * row + 1] = ra[4 * t + 1];
    gc[3 * row + 2] = ra[4 * t + 2];
    ge[row * (V + 1) + V] = ra[4 * t + 3];
  }
  for (int t = tid; t < ni * V; t += kThreads) {
    const int il = t / V;
    const int k = t - il * V;
    ge[(size_t(b) * C + i0 + il) * (V + 1) + k] = rp[t];
  }
}

// Shared-memory bytes of one block; kernels/pair_sweep.py::bwd_smem_bytes
// computes the same number to choose TI.
size_t smem_bytes(int K, int TI) {
  const size_t kp = size_t(K | 1);
  const size_t v = size_t((K - 1) / 2);
  const size_t wm = v ? size_t(TI) * kWS : 0;
  return sizeof(float) * (size_t(TI) * (5 + kp) + size_t(kCols) * (5 + kp) + 4 * size_t(TI) +
                          size_t(TI) * v + wm + 4 * size_t(kWarps) * kCols);
}

template <class Term>
int launch(const TermConsts& tc, const float* coord, const float* mask, const float* ext,
           const float* shift, const int* nbr, const float* ct, float* gc, float* ge, float* gmc,
           float* gme, int B, int C, int K, int S, int TI, cudaStream_t stream) {
  const size_t smem = smem_bytes(K, TI);
  cudaError_t err = cudaFuncSetAttribute(pair_bwd_kernel<Term>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(B, (C + TI - 1) / TI);
  pair_bwd_kernel<Term><<<grid, kThreads, smem, stream>>>(tc, coord, mask, ext, shift, nbr, ct, gc,
                                                          ge, gmc, gme, B, C, K, S, TI);
  return int(cudaGetLastError());
}

}  // namespace

// term: 0 DSF Coulomb, 1 D3 coordination number, 2 D3(BJ) energy.
// consts: host pointer to 8 floats (the cutoff, then the term's constants).
extern "C" int pair_bwd_launch(const float* consts, const float* coord, const float* mask,
                               const float* ext, const float* shift, const int* nbr,
                               const float* ct, float* gc, float* ge, float* gmc, float* gme,
                               int term, int B, int C, int K, int S, int TI, void* stream) {
  if (TI < 1 || TI > C || K < 1 || K % 2 != 1) return int(cudaErrorInvalidValue);
  TermConsts tc;
  for (int i = 0; i < 8; ++i) tc.c[i] = consts[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (term) {
    case 0:
      if (K != 1) return int(cudaErrorInvalidValue);
      return launch<pair_terms::DsfTerm>(tc, coord, mask, ext, shift, nbr, ct, gc, ge, gmc, gme,
                                         B, C, K, S, TI, st);
    case 1:
      if (K != 1) return int(cudaErrorInvalidValue);
      return launch<pair_terms::D3CnTerm>(tc, coord, mask, ext, shift, nbr, ct, gc, ge, gmc, gme,
                                          B, C, K, S, TI, st);
    case 2:
      return launch<pair_terms::D3EnergyTerm>(tc, coord, mask, ext, shift, nbr, ct, gc, ge, gmc,
                                              gme, B, C, K, S, TI, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
