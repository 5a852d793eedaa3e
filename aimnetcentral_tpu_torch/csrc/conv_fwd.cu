// Kernel A: the stencil ConvSV contraction on the binned layout.
//
// Replaces the Pallas TPU kernel aimnetcentral_tpu/kernels/conv_stencil.py
// ::_fwd_kernel (conv_stencil.py:289).  For receiver bin b, radial shift g,
// every stencil offset s and every pair (i in b, j in the candidate bin
// n = nbr[s, b]) it forms
//     d = |x_j + shift[s, b] - x_i|,  fc = 0.5 (cos(pi d / rc) + 1) for d < rc,
//     gs = exp(-eta (d - s_g)^2) fc,   u = (x_j + shift - x_i) / d,
// and accumulates out[b, k, i, g, f] += W_k[i, j] a[n, j, g, f] with
// W = [gs, gs u_x, gs u_y, gs u_z].  The self pair i == j is dropped only at
// the zero offset s = 0 (stencil_offsets puts (0,0,0) first); at other
// offsets the same bin is a real periodic image.  Non-pairs take d2 := 1
// before the sqrt so nothing divides by zero.
//
// Design: one block per (receiver bin, g, tile of TI receiver rows); the
// wrapper picks the smallest number of row tiles for which the block's
// (i, f) outputs fit its registers and its pair weights fit shared memory
// (one tile at the flagship's capacity).  Per offset the block stages the
// candidate coordinates and a[n, :, g, :] in shared memory, builds the
// 4 x TI x C pair weights there, and each thread accumulates its (i, f)
// outputs for all four rows k in registers across the whole stencil.  No
// two blocks write the same output, so there are no atomics and the result
// is deterministic.  FP32 on CUDA cores: the exact tier has no TF32.
//
// What bounds it on an H100: the function needs 2 * 4 G F FLOP per real
// pair within rc and reads each feature once, so its least time is set by
// the bytes it moves (the output is four times the features).  This first
// version visits every slot pair of the 27 offsets (about 46x the real
// pairs at the flagship's grid), recomputes the pair geometry once per g,
// and reads both operands of its inner product from shared memory, so it
// is bound by shared-memory loads.  Register tiling over (i, f), sharing
// the geometry across g and skipping empty slot pairs are the next steps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 8;  // (i, f) outputs per thread: TI * F <= 2048
constexpr float kPi = 3.14159265358979323846f;

__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const float* __restrict__ coord,     // (B*C, 3)
                const float* __restrict__ mask,      // (B*C)
                const float* __restrict__ a,         // (B*C, G*F)
                const int* __restrict__ nbr,         // (S, B), -1 = no candidate
                const float* __restrict__ shift,     // (S, B, 3)
                const float* __restrict__ shifts_g,  // (G)
                const float* __restrict__ scal,      // (2) eta, rc
                float* __restrict__ out,             // (B, 4, C, G*F)
                int B, int C, int G, int F, int S, int TI) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int i0 = blockIdx.z * TI;
  const int ni = min(TI, C - i0);  // receiver rows of this tile
  const int tid = threadIdx.x;
  const int PC = ni * C;  // pairs of the tile
  const int GF = G * F;
  float* xi = smem;           // TI*3  receiver coordinates
  float* mi = xi + 3 * TI;    // TI
  float* xj = mi + TI;        // C*3   candidate coordinates + shift
  float* mj = xj + 3 * C;     // C
  float* aj = mj + C;         // C*F   candidate features at g
  float* W = aj + C * F;      // 4*TI*C pair weights, row il, column j

  const float eta = scal[0];
  const float rc = scal[1];
  const float sg = shifts_g[g];
  const float pi_rc = kPi / rc;

  for (int t = tid; t < ni; t += kThreads) {
    const size_t row = size_t(b) * C + i0 + t;
    xi[3 * t + 0] = coord[3 * row + 0];
    xi[3 * t + 1] = coord[3 * row + 1];
    xi[3 * t + 2] = coord[3 * row + 2];
    mi[t] = mask[row];
  }

  float acc[kMaxOut][4];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  }
  const int nout = ni * F;

  for (int s = 0; s < S; ++s) {
    const int n = nbr[size_t(s) * B + b];
    if (n < 0) continue;  // gas-phase step without a candidate bin
    const float* sh = shift + (size_t(s) * B + b) * 3;
    __syncthreads();  // the previous offset's readers are done
    for (int t = tid; t < C; t += kThreads) {
      const size_t row = size_t(n) * C + t;
      xj[3 * t + 0] = coord[3 * row + 0] + sh[0];
      xj[3 * t + 1] = coord[3 * row + 1] + sh[1];
      xj[3 * t + 2] = coord[3 * row + 2] + sh[2];
      mj[t] = mask[row];
    }
    for (int t = tid; t < C * F; t += kThreads) {
      const int j = t / F;
      const int f = t - j * F;
      aj[t] = a[(size_t(n) * C + j) * GF + size_t(g) * F + f];
    }
    __syncthreads();
    for (int p = tid; p < PC; p += kThreads) {
      const int il = p / C;
      const int j = p - il * C;
      const float dx = xj[3 * j + 0] - xi[3 * il + 0];
      const float dy = xj[3 * j + 1] - xi[3 * il + 1];
      const float dz = xj[3 * j + 2] - xi[3 * il + 2];
      const bool vp = mi[il] > 0.5f && mj[j] > 0.5f && !(s == 0 && i0 + il == j);
      const float d = sqrtf(vp ? dx * dx + dy * dy + dz * dz : 1.0f);
      const bool within = vp && d < rc;
      const float fc = within ? 0.5f * (cosf(fminf(d, rc) * pi_rc) + 1.0f) : 0.0f;
      const float dd = d - sg;
      const float gs = expf(-eta * dd * dd) * fc;
      W[p] = gs;
      W[PC + p] = gs * (dx / d);
      W[2 * PC + p] = gs * (dy / d);
      W[3 * PC + p] = gs * (dz / d);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int o = tid + r * kThreads;
      if (o < nout) {
        const int il = o / F;
        const int f = o - il * F;
        const float* w0 = W + il * C;
        const float* w1 = w0 + PC;
        const float* w2 = w1 + PC;
        const float* w3 = w2 + PC;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        for (int j = 0; j < C; ++j) {
          const float av = aj[j * F + f];
          s0 = fmaf(w0[j], av, s0);
          s1 = fmaf(w1[j], av, s1);
          s2 = fmaf(w2[j], av, s2);
          s3 = fmaf(w3[j], av, s3);
        }
        acc[r][0] += s0;
        acc[r][1] += s1;
        acc[r][2] += s2;
        acc[r][3] += s3;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int o = tid + r * kThreads;
    if (o < nout) {
      const int il = o / F;
      const int f = o - il * F;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        out[((size_t(b) * 4 + k) * C + i0 + il) * GF + size_t(g) * F + f] = acc[r][k];
      }
    }
  }
}

// Shared-memory bytes of one block; kernels/conv_stencil.py::fwd_smem_bytes
// computes the same number to choose TI.
size_t smem_bytes(int C, int F, int TI) {
  return sizeof(float) * (4 * size_t(TI) + 4 * size_t(C) + size_t(C) * F + 4 * size_t(TI) * C);
}

}  // namespace

extern "C" int conv_fwd_launch(const float* coord, const float* mask, const float* a,
                               const int* nbr, const float* shift, const float* shifts_g,
                               const float* scal, float* out, int B, int C, int G, int F,
                               int S, int TI, void* stream) {
  if (TI < 1 || TI > C || TI * F > kMaxOut * kThreads) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(C, F, TI);
  cudaError_t err = cudaFuncSetAttribute(
      conv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(B, G, (C + TI - 1) / TI);
  conv_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coord, mask, a, nbr, shift, shifts_g, scal, out, B, C, G, F, S, TI);
  return int(cudaGetLastError());
}
