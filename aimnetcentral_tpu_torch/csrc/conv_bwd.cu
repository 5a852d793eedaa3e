// Kernel B: the fused adjoint of kernel A (csrc/conv_fwd.cu).
//
// Replaces the Pallas TPU kernel aimnetcentral_tpu/kernels/conv_stencil.py
// ::_bwd_kernel (conv_stencil.py:466).  Receiver-centric: one block per
// (bin j, tile of TJ atoms of j), looping over the stencil offsets s and the
// partner bin p = mnbr[s, j] whose FORWARD step s had j as its candidate
// (the forward pair is i in p, j in this bin, displacement
// r = x_j + shift[s, p] - x_i).  Given the forward cotangent
// gbar[p, k, i, g, f] it forms, per pair and g,
//     Wbar_k   = sum_f gbar[p, k, i, g, f] a[j, g, f]
//     gsbar    = Wbar_0 + sum_k Wbar_k u_k
//     ubar_k  += Wbar_k gs,     dbar += gsbar dgs/dd
// summing over all g inside the block before the chain rule through u and d:
//     rbar_k = within (dbar u_k + (ubar_k - (ubar . u) u_k) / d).
// Outputs:
//   grad_a[j, g, f] = sum_{s, k, i} W_k[i, j, g] gbar[p, k, i, g, f]   (resident)
//   grad_coord[j]   = sum_{s, i} rbar[i, j]                          (resident)
//   pgrad[s, j, t, k, i] = -sum_{j in tile t} rbar_k[i, j]: the partner-side
//     row sums of each atom tile; the wrapper sums the tiles (in a fixed
//     order) and one static gather turns them into the partner atoms'
//     coordinate adjoint and the lattice-shift adjoint (stress).
// Every output element is written by exactly one block: no atomics, and the
// result is deterministic.  `within` multiplies rbar before any 1/d term
// reaches a sum, and non-pairs take d2 := 1, so every term stays finite.
//
// Design: the partner rows are walked in tiles of TI atoms.  Per (bin,
// offset, row tile), each thread keeps its pairs' geometry (d, fc, fc', u)
// and chain-rule sums (dbar, ubar) in registers across the G shifts; gs and
// u are also kept in shared memory for the grad_a contraction, and grad_a
// for the block's (j, g, f) is accumulated in shared memory across the
// stencil.  The wrapper picks TJ and TI (one tile each at the flagship's
// capacity).  Row strides of the pair matrices are TJ+1 and of the feature
// tiles odd, so that the row and column walks are free of bank conflicts.
//
// What bounds it on an H100: like kernel A, the function's least time is
// set by the bytes it moves (gbar, features and outputs, each once); its
// operations are about twice kernel A's per real pair.  This first version
// visits every slot pair of the stencil and reads both operands of its two
// contractions from shared memory, so it is bound by shared-memory loads;
// register tiling and skipping empty slot pairs are the next steps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;

// Two blocks per SM (at most 128 registers a thread): left free, ptxas takes
// 181 registers for RP = 8 and one block per SM hides the shared-memory
// latency worse; on an H100 the kernel ran a third faster with the bound.
template <int RP>  // pairs per thread: TI * TJ <= RP * kThreads
__global__ void __launch_bounds__(kThreads, 2)
conv_bwd_kernel(const float* __restrict__ coord,     // (B*C, 3)
                const float* __restrict__ mask,      // (B*C)
                const float* __restrict__ a,         // (B*C, G*F)
                const float* __restrict__ gbar,      // (B, 4, C, G*F)
                const int* __restrict__ mnbr,        // (S, B), -1 = no partner
                const float* __restrict__ shift,     // (S, B, 3) forward frame
                const float* __restrict__ shifts_g,  // (G)
                const float* __restrict__ scal,      // (2) eta, rc
                float* __restrict__ grad_a,          // (B*C, G*F)
                float* __restrict__ grad_coord,      // (B*C, 3) receiver side
                float* __restrict__ pgrad,           // (S, B, NJ, 3, C) partner side
                int B, int C, int G, int F, int S, int TJ, int TI) {
  extern __shared__ float smem[];
  const int jb = blockIdx.x;
  const int jt = blockIdx.y;
  const int NJ = gridDim.y;
  const int j0 = jt * TJ;
  const int nj = min(TJ, C - j0);  // atoms of this block's tile
  const int tid = threadIdx.x;
  const int CP = TJ + 1;  // pair-matrix row stride
  const int FP = F | 1;   // feature-tile row stride (odd)
  const int GF = G * F;
  float* xj = smem;               // TJ*3  this tile (forward candidates)
  float* mj = xj + 3 * TJ;        // TJ
  float* xi = mj + TJ;            // TI*3  partner rows, minus the forward shift
  float* mi = xi + 3 * TI;        // TI
  float* gb = mi + TI;            // 4*TI*FP  gbar[p, k, i, g, :]
  float* aj = gb + 4 * TI * FP;   // TJ*FP    a[j, g, :]
  float* GS = aj + TJ * FP;       // TI*CP    gs at the current g
  float* U = GS + TI * CP;        // 3*TI*CP  u_k, later rbar_k
  float* GA = U + 3 * TI * CP;    // TJ*G*F   grad_a accumulator

  const float eta = scal[0];
  const float rc = scal[1];
  const float pi_rc = kPi / rc;

  for (int t = tid; t < nj; t += kThreads) {
    const size_t row = size_t(jb) * C + j0 + t;
    xj[3 * t + 0] = coord[3 * row + 0];
    xj[3 * t + 1] = coord[3 * row + 1];
    xj[3 * t + 2] = coord[3 * row + 2];
    mj[t] = mask[row];
  }
  for (int t = tid; t < nj * GF; t += kThreads) GA[t] = 0.0f;
  float gc0 = 0.0f, gc1 = 0.0f, gc2 = 0.0f;  // receiver-side adjoint of atom j0 + tid

  for (int s = 0; s < S; ++s) {
    const int p = mnbr[size_t(s) * B + jb];
    float* prow = pgrad + ((size_t(s) * B + jb) * NJ + jt) * 3 * C;
    if (p < 0) {  // gas-phase step without a partner: nothing to send
      for (int t = tid; t < 3 * C; t += kThreads) prow[t] = 0.0f;
      continue;
    }
    const float* sh = shift + (size_t(s) * B + p) * 3;
    for (int i0 = 0; i0 < C; i0 += TI) {
      const int ni = min(TI, C - i0);
      const int npair = ni * nj;
      __syncthreads();  // the previous tile's readers of xi and U are done
      for (int t = tid; t < ni; t += kThreads) {
        const size_t row = size_t(p) * C + i0 + t;
        xi[3 * t + 0] = coord[3 * row + 0] - sh[0];
        xi[3 * t + 1] = coord[3 * row + 1] - sh[1];
        xi[3 * t + 2] = coord[3 * row + 2] - sh[2];
        mi[t] = mask[row];
      }
      __syncthreads();

      float rd[RP], rfc[RP], rfcp[RP], ru[RP][3];
      float dbar[RP], ubar[RP][3];
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        dbar[r] = ubar[r][0] = ubar[r][1] = ubar[r][2] = 0.0f;
        rd[r] = 1.0f;
        rfc[r] = rfcp[r] = ru[r][0] = ru[r][1] = ru[r][2] = 0.0f;
        const int pr = tid + r * kThreads;
        if (pr < npair) {
          const int il = pr / nj;
          const int jl = pr - il * nj;
          const float dx = xj[3 * jl + 0] - xi[3 * il + 0];
          const float dy = xj[3 * jl + 1] - xi[3 * il + 1];
          const float dz = xj[3 * jl + 2] - xi[3 * il + 2];
          const bool vp = mi[il] > 0.5f && mj[jl] > 0.5f && !(s == 0 && i0 + il == j0 + jl);
          const float d = sqrtf(vp ? dx * dx + dy * dy + dz * dz : 1.0f);
          const bool within = vp && d < rc;
          const float arg = fminf(d, rc) * pi_rc;
          rd[r] = d;
          rfc[r] = within ? 0.5f * (cosf(arg) + 1.0f) : 0.0f;
          rfcp[r] = within ? -0.5f * pi_rc * sinf(arg) : 0.0f;
          ru[r][0] = dx / d;
          ru[r][1] = dy / d;
          ru[r][2] = dz / d;
          U[il * CP + jl] = ru[r][0];
          U[TI * CP + il * CP + jl] = ru[r][1];
          U[2 * TI * CP + il * CP + jl] = ru[r][2];
        }
      }

      for (int g = 0; g < G; ++g) {
        __syncthreads();  // the previous g's readers of gb, aj and GS are done
        for (int t = tid; t < 4 * ni * F; t += kThreads) {
          const int kil = t / F;  // k*ni + il
          const int f = t - kil * F;
          const int k = kil / ni;
          const int il = kil - k * ni;
          gb[(k * TI + il) * FP + f] =
              gbar[((size_t(p) * 4 + k) * C + i0 + il) * GF + size_t(g) * F + f];
        }
        for (int t = tid; t < nj * F; t += kThreads) {
          const int jl = t / F;
          const int f = t - jl * F;
          aj[jl * FP + f] = a[(size_t(jb) * C + j0 + jl) * GF + size_t(g) * F + f];
        }
        __syncthreads();
        const float sg = shifts_g[g];
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const int pr = tid + r * kThreads;
          if (pr < npair) {
            const int il = pr / nj;
            const int jl = pr - il * nj;
            const float dd = rd[r] - sg;
            const float e = expf(-eta * dd * dd);
            const float gs = e * rfc[r];
            const float dgs = e * (rfcp[r] - 2.0f * eta * dd * rfc[r]);
            GS[il * CP + jl] = gs;
            const float* g0 = gb + il * FP;
            const float* g1 = g0 + TI * FP;
            const float* g2 = g1 + TI * FP;
            const float* g3 = g2 + TI * FP;
            const float* av = aj + jl * FP;
            float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f, w3 = 0.0f;
            for (int f = 0; f < F; ++f) {
              const float x = av[f];
              w0 = fmaf(g0[f], x, w0);
              w1 = fmaf(g1[f], x, w1);
              w2 = fmaf(g2[f], x, w2);
              w3 = fmaf(g3[f], x, w3);
            }
            const float gsbar = w0 + w1 * ru[r][0] + w2 * ru[r][1] + w3 * ru[r][2];
            ubar[r][0] += w1 * gs;
            ubar[r][1] += w2 * gs;
            ubar[r][2] += w3 * gs;
            dbar[r] += gsbar * dgs;
          }
        }
        __syncthreads();
        // grad_a[j, g, f] += sum_i gs (gbar_0 + sum_k u_k gbar_k)
        for (int o = tid; o < nj * F; o += kThreads) {
          const int jl = o / F;
          const int f = o - jl * F;
          float acc = 0.0f;
          for (int il = 0; il < ni; ++il) {
            const float gsv = GS[il * CP + jl];
            const float t = gb[il * FP + f] + U[il * CP + jl] * gb[(TI + il) * FP + f] +
                            U[TI * CP + il * CP + jl] * gb[(2 * TI + il) * FP + f] +
                            U[2 * TI * CP + il * CP + jl] * gb[(3 * TI + il) * FP + f];
            acc = fmaf(gsv, t, acc);
          }
          GA[(jl * G + g) * F + f] += acc;
        }
      }

      // chain rule through u and d, then rbar replaces u in shared memory
      __syncthreads();  // the last grad_a pass has read U
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int pr = tid + r * kThreads;
        if (pr < npair) {
          const int il = pr / nj;
          const int jl = pr - il * nj;
          const bool vp = mi[il] > 0.5f && mj[jl] > 0.5f && !(s == 0 && i0 + il == j0 + jl);
          const float wf = (vp && rd[r] < rc) ? 1.0f : 0.0f;
          const float inv_d = 1.0f / rd[r];
          const float uu = ubar[r][0] * ru[r][0] + ubar[r][1] * ru[r][1] + ubar[r][2] * ru[r][2];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            U[k * TI * CP + il * CP + jl] =
                wf * (dbar[r] * ru[r][k] + (ubar[r][k] - uu * ru[r][k]) * inv_d);
          }
        }
      }
      __syncthreads();
      if (tid < nj) {  // column sums: atom j0 + tid of this bin
        float col[3] = {0.0f, 0.0f, 0.0f};
        for (int il = 0; il < ni; ++il) {
#pragma unroll
          for (int k = 0; k < 3; ++k) col[k] += U[k * TI * CP + il * CP + tid];
        }
        gc0 += col[0];
        gc1 += col[1];
        gc2 += col[2];
      }
      if (tid < ni) {  // row sums: partner atom i0 + tid, over this tile's j
        float rowsum[3] = {0.0f, 0.0f, 0.0f};
        for (int jl = 0; jl < nj; ++jl) {
#pragma unroll
          for (int k = 0; k < 3; ++k) rowsum[k] += U[k * TI * CP + tid * CP + jl];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) prow[k * C + i0 + tid] = -rowsum[k];
      }
    }
  }

  __syncthreads();
  for (int t = tid; t < nj * GF; t += kThreads) {
    grad_a[(size_t(jb) * C + j0) * GF + t] = GA[t];
  }
  if (tid < nj) {
    const size_t row = size_t(jb) * C + j0 + tid;
    grad_coord[3 * row + 0] = gc0;
    grad_coord[3 * row + 1] = gc1;
    grad_coord[3 * row + 2] = gc2;
  }
}

// Shared-memory bytes of one block; kernels/conv_stencil.py::bwd_smem_bytes
// computes the same number to choose TJ and TI.
size_t smem_bytes(int G, int F, int TJ, int TI) {
  const size_t fp = size_t(F | 1);
  return sizeof(float) * (4 * size_t(TJ) + 4 * size_t(TI) + 4 * size_t(TI) * fp +
                          size_t(TJ) * fp + 4 * size_t(TI) * (TJ + 1) + size_t(TJ) * G * F);
}

template <int RP>
int launch(const float* coord, const float* mask, const float* a, const float* gbar,
           const int* mnbr, const float* shift, const float* shifts_g, const float* scal,
           float* grad_a, float* grad_coord, float* pgrad, int B, int C, int G, int F, int S,
           int TJ, int TI, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, F, TJ, TI);
  cudaError_t err = cudaFuncSetAttribute(
      conv_bwd_kernel<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(B, (C + TJ - 1) / TJ);
  conv_bwd_kernel<RP><<<grid, kThreads, smem, stream>>>(
      coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a, grad_coord, pgrad,
      B, C, G, F, S, TJ, TI);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int conv_bwd_launch(const float* coord, const float* mask, const float* a,
                               const float* gbar, const int* mnbr, const float* shift,
                               const float* shifts_g, const float* scal, float* grad_a,
                               float* grad_coord, float* pgrad, int B, int C, int G, int F,
                               int S, int TJ, int TI, void* stream) {
  const int pairs = TJ * TI;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (TJ < 1 || TJ > C || TI < 1 || TI > C || TJ > kThreads || TI > kThreads)
    return int(cudaErrorInvalidValue);
  if (pairs <= 4 * kThreads)
    return launch<4>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a, grad_coord,
                     pgrad, B, C, G, F, S, TJ, TI, st);
  if (pairs <= 8 * kThreads)
    return launch<8>(coord, mask, a, gbar, mnbr, shift, shifts_g, scal, grad_a, grad_coord,
                     pgrad, B, C, G, F, S, TJ, TI, st);
  return int(cudaErrorInvalidValue);
}
