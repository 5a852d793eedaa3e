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

// The tensor-core builds: kernel A in the JAX package's conv precision
// modes, replacing _fwd_kernel (aimnetcentral_tpu/kernels/conv_stencil.py
// :289) with its _mxu_dot (:373) in "f32" under TF32, "f32x3" and "bf16"
// (csrc/conv_mma.cuh: the modes, the design, the exact W).  What bounds
// them on an H100 is the bytes moved, as for the FP32 build; what they add
// is finding the live candidates, moving each one's feature row from L2
// into shared memory (once a pass, 4 shifts x F columns of it), the pairs'
// geometry and exps, and two barriers a batch.  Block (b, shift-and-column
// tile): kFwdGTile radial shifts and kFTile feature columns of every real
// receiver of bin b, in passes of up to kRowCap receivers (compacted in
// slot order); warp w owns row tile w / 4 and shift g0 + w % 4, with its
// out[k, rows, g, f] in 48 FP32 accumulators (in shared memory between
// batches).  The bin's padding slots get their zero rows first.  A pass:
//   1. the live candidates: the pass's record of live_scan_kernel (launched
//      just before, conv_mma.cuh): for each (offset s, slot j of the
//      candidate bin nbr[s, b]) holding a real atom, the row tiles with a
//      receiver within rc, as the entry stream by class (Stream);
//   2. batches of kFwdEntries entries: batch t+1's feature rows (the
//      block's columns) and coordinates are copied by cp.async while batch
//      t's geometry and exps are computed (the pairs within rc packed onto
//      a warp's lanes) and batch t is contracted:
//      out[k, i, g, f] += W_k[i, e, g] a[e, g, f] by mma.sync over the
//      entries of the warp's tile, four k's sharing each B operand.
// Every output element is written once, every sum in a fixed order (the
// stream's): no atomics.
namespace cm = conv_mma;

template <int kMode>
__global__ void __launch_bounds__(cm::kThreads, 2)
conv_fwd_mma_kernel(const float* __restrict__ coord,     // (B*C, 3)
                    const float* __restrict__ mask,      // (B*C)
                    const float* __restrict__ a,         // (B*C, G*F)
                    const int* __restrict__ nbr,         // (S, B), -1 = no candidate
                    const float* __restrict__ shift,     // (S, B, 3)
                    const float* __restrict__ shifts_g,  // (G)
                    const float* __restrict__ scal,      // (2) eta, rc
                    float* __restrict__ out,             // (B, 4, C, G*F)
                    const int* __restrict__ rec,         // (B, passes) scan records (conv_mma.cuh)
                    int B, int C, int G, int F, int S) {
  using M = cm::Mma<kMode>;
  constexpr int EB = cm::kFwdEntries;
  constexpr int Q = cm::kFwdQ;
  constexpr int GT = cm::kFwdGTile;
  constexpr int TPE = cm::kThreads / EB;  // threads an entry in the copies
  static_assert(EB == 32 && cm::kRowCap == 4 * cm::kWarps, "the geometry: warp w, rows w + 8 m, entry = lane");
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const cm::FwdLayout L(C, F, S, kMode);
  float4* const accs = smem4 + L.accs / 4;  // [12][kThreads]
  float4* const geo4 = smem4 + L.geo4 / 4;  // [kRowCap][Q] (fc, ux, uy, uz)
  float4* const cst = smem4 + L.cst / 4;    // [2][EB] the entries' coordinates
  float4* const rows = smem4 + L.rows / 4;
  float4* const shs = smem4 + L.shs / 4;
  float* const exs = smem + L.ex;       // [GT][kRowCap][Q]
  float* const stage = smem + L.stage;  // [2][EB][P]
  float* const sg = smem + L.sg;
  int* const est = reinterpret_cast<int*>(smem + L.est);  // [2][2][EB] offset, self slot
  int* const nbs = reinterpret_cast<int*>(smem + L.nbs);
  unsigned* const masks = reinterpret_cast<unsigned*>(smem + L.masks);
  int* const prefix = reinterpret_cast<int*>(smem + L.prefix);
  int* const slots = reinterpret_cast<int*>(smem + L.slots);

  const int b = blockIdx.x;
  const int g0 = (blockIdx.z % cm::fwd_g_tiles(G)) * GT;
  const int f0 = (blockIdx.z / cm::fwd_g_tiles(G)) * cm::kFTile;
  const int ng = min(GT, G - g0);
  const int nfb = min(cm::kFTile, F - f0);  // this block's columns of each shift
  const bool one_run = nfb == F;           // the block's columns of its ng shifts are one contiguous run
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const int GF = G * F;
  const int P = L.P;
  const int W = L.W;
  const float eta = scal[0];
  const cm::Rc2 rc2 = cm::rc_bounds(scal[1]);
  const float pi_rc = __fdiv_rn(cm::kPi, rc2.rc);

  if (warp == 0) {
    const int nrow = cm::compact_rows(mask, b, C, 0, C, slots, lane);
    if (lane == 0) prefix[0] = nrow;
  }
  if (tid < GT) sg[tid] = g0 + tid < G ? shifts_g[g0 + tid] : 0.0f;
  for (int s = tid; s < S; s += cm::kThreads) {
    const int n = nbr[size_t(s) * B + b];
    const float* sh = shift + (size_t(s) * B + b) * 3;
    nbs[s] = n;
    shs[s] = make_float4(sh[0], sh[1], sh[2], 0.0f);
  }
  // the padding slots' zero rows (the block's columns), a warp a slot
  for (int j = warp; j < C; j += cm::kWarps) {
    if (mask[size_t(b) * C + j] > 0.5f) continue;  // the same for the warp
    for (int k = 0; k < 4; ++k) {
      float* orow = out + ((size_t(b) * 4 + k) * C + j) * GF;
      for (int c = lane; c < ng * nfb; c += 32) orow[one_run ? g0 * F + c : (g0 + c / nfb) * F + f0 + c % nfb] = 0.0f;
    }
  }
  __syncthreads();
  const int nrow = prefix[0];

  // the copies: 16 bytes a chunk where every run is aligned
  const bool vec = (reinterpret_cast<uintptr_t>(a) & 15) == 0 && GF % 4 == 0 && P % 4 == 0 &&
                   (one_run ? (g0 * F) % 4 == 0 && (ng * F) % 4 == 0 : F % 4 == 0 && f0 % 4 == 0 && nfb % 4 == 0);
  const int tile = warp / GT;  // the warp's row tile and shift
  const int gl = warp % GT;

  for (int r0 = 0; r0 < nrow; r0 += cm::kRowCap) {
    const int nr = min(cm::kRowCap, nrow - r0);
    const int* ps = slots + r0;  // the pass's rows' slots
    __syncthreads();             // the previous pass's readers are done
    if (warp == 0) cm::load_rows(coord, b, C, ps, nr, rows, lane);
    // 1. the live candidates: this pass's scan record (live_scan_kernel)
    const int* src_rec = rec + (size_t(b) * cm::row_groups(C) + r0 / cm::kRowCap) * cm::scan_words(C, S);
    for (int t = tid; t < cm::scan_words(C, S); t += cm::kThreads) reinterpret_cast<int*>(masks)[t] = src_rec[t];
    for (int v = 0; v < 12; ++v) accs[v * cm::kThreads + tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    const cm::Stream stream(masks, prefix, S, W);
    const int nb = (stream.E + EB - 1) / EB;
    const int lo = stream.lo(tile), hi = stream.hi(tile);  // this warp's entries
    const bool active = gl < ng && tile * 16 < nr;         // the same for the warp, all batches

    // batch t's copies into buffer buf: thread tid, entry tid % EB
    auto issue = [&](int t, int buf) {
      const int e = tid % EB;
      const int part = tid / EB;
      const int ge = t * EB + e;
      const bool valid = ge < stream.E;
      int s = 0, j = 0;
      if (valid) stream.decode(ge, s, j);
      const size_t cr = size_t(valid ? nbs[s] : 0) * C + j;
      const float* src = a + cr * GF + size_t(g0) * F + f0;
      float* dst = stage + (buf * EB + e) * P;
      if (one_run) {
        cm::stage_runs(dst, src, 1, 1, 0, 0, 0, 0, ng * F, vec, valid, part, TPE);
      } else {
        cm::stage_runs(dst, src, 1, ng, 0, F, 0, nfb, nfb, vec, valid, part, TPE);
      }
      if (part < 3) cm::cp_async4(reinterpret_cast<float*>(cst + buf * EB + e) + part, coord + 3 * cr + part, valid ? 4 : 0);
      if (part == 0) {
        est[(buf * 2 + 0) * EB + e] = valid ? s : -1;
        est[(buf * 2 + 1) * EB + e] = valid && s == 0 ? j : -1;
      }
      cm::cp_async_commit();
    };

    // batch t's geometry: warp w, rows w + 8 m, entry = lane; the pairs
    // within rc then packed onto the warp's lanes for the sqrt, cos,
    // divisions and exps
    auto geometry = [&](int t, int buf) {
      const int e = lane;
      const int ge = t * EB + e;
      const int s = est[(buf * 2 + 0) * EB + e];
      const int self = est[(buf * 2 + 1) * EB + e];
      const float4 xe = cst[buf * EB + e];
      const float4 sh = s >= 0 ? shs[s] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      unsigned inm = 0;  // bit m: the pair (row warp + 8 m, e) within rc
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = warp + 8 * m;
        bool in = false;
        if (s >= 0 && r < nr && ge >= stream.lo(r >> 4) && ge < stream.hi(r >> 4) && ps[r] != self) {
          const float4 xr = rows[r];
          float dx, dy, dz;
          in = rc2.within(cm::pair_d2(xe.x, xe.y, xe.z, sh.x, sh.y, sh.z, xr.x, xr.y, xr.z, dx, dy, dz));
        }
        if (in) {
          inm |= 1u << m;
        } else {
          geo4[r * Q + e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int g = 0; g < GT; ++g) exs[(g * cm::kRowCap + r) * Q + e] = 0.0f;
        }
      }
      const unsigned b0 = __ballot_sync(0xffffffffu, inm & 1u), b1 = __ballot_sync(0xffffffffu, inm & 2u);
      const unsigned b2 = __ballot_sync(0xffffffffu, inm & 4u), b3 = __ballot_sync(0xffffffffu, inm & 8u);
      const int c0 = __popc(b0), c1 = c0 + __popc(b1), c2 = c1 + __popc(b2), total = c2 + __popc(b3);
      for (int idx = lane; idx < total; idx += 32) {
        const int m = idx < c0 ? 0 : idx < c1 ? 1 : idx < c2 ? 2 : 3;
        const int k = idx - (m == 0 ? 0 : m == 1 ? c0 : m == 2 ? c1 : c2);
        const int ee = cm::nth_set_bit(m == 0 ? b0 : m == 1 ? b1 : m == 2 ? b2 : b3, k);
        const int r = warp + 8 * m;
        const float4 xq = cst[buf * EB + ee];
        const float4 shq = shs[est[(buf * 2 + 0) * EB + ee]];
        const float4 xr = rows[r];
        const cm::Geom pg = cm::pair_geometry(xq.x, xq.y, xq.z, shq.x, shq.y, shq.z, xr.x, xr.y, xr.z, pi_rc);
        geo4[r * Q + ee] = make_float4(pg.fc, pg.ux, pg.uy, pg.uz);
#pragma unroll
        for (int g = 0; g < GT; ++g) exs[(g * cm::kRowCap + r) * Q + ee] = cm::gauss(pg.d, sg[g], eta);
      }
    };

    // 2. the contraction
    if (nb > 0) issue(0, 0);
    for (int t = 0; t < nb; ++t) {
      const int buf = t & 1;
      cm::cp_async_wait();
      __syncthreads();  // batch t's copies in place; batch t-1's readers done
      if (t + 1 < nb) issue(t + 1, buf ^ 1);
      geometry(t, buf);
      __syncthreads();  // batch t's geometry in place
      if (!active) continue;
      const int base = t * EB;
      const int ne = min(EB, stream.E - base);
      float acc[4][cm::kNT][4];  // in registers for the batch, in shared memory between batches
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int nt = 0; nt < cm::kNT; ++nt) {
          const float4 v = accs[(k * cm::kNT + nt) * cm::kThreads + tid];
          acc[k][nt][0] = v.x;
          acc[k][nt][1] = v.y;
          acc[k][nt][2] = v.z;
          acc[k][nt][3] = v.w;
        }
      // the lane's rows' offsets, formed here for the batch (kept live across
      // the whole kernel they would crowd the registers)
      int rq = (tile * 16 + gid) * Q;
      asm volatile("" : "+r"(rq));
      const float* ex = exs + gl * cm::kRowCap * Q + rq;
      const float4* g4 = geo4 + rq;
      const float* st = stage + buf * EB * P + gl * nfb;
#pragma unroll 1
      for (int k0 = 0; k0 < ne; k0 += M::K) {
        if (base + k0 + M::K <= lo || base + k0 >= hi) continue;  // no entry of this tile
        // gs = exp(..) fc and u of the lane's pairs: rows gid, gid + 8; depth kidx(q)
        float gs[2][M::NK];
        float4 gv[2][M::NK];
#pragma unroll
        for (int q = 0; q < M::NK; ++q) {
          const int e = k0 + M::kidx(t4, q);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 8 * r * Q + e;
            gv[r][q] = g4[i];
            gs[r][q] = __fmul_rn(ex[i], gv[r][q].x);
          }
        }
        // B operands: the entries' features a[e, g, f]
        cm::OpB bop[cm::kNT];
#pragma unroll
        for (int nt = 0; nt < cm::kNT; ++nt) {
          const int fl = nt * 8 + gid;
          float bv[M::NK];
#pragma unroll
          for (int q = 0; q < M::NK; ++q) bv[q] = fl < nfb ? st[(k0 + M::kidx(t4, q)) * P + fl] : 0.0f;
          cm::make_b<kMode>(bv, bop[nt]);
        }
        // A operands W_k = gs [1, u]_k, one k at a time
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float w[2][M::NK];
#pragma unroll
          for (int q = 0; q < M::NK; ++q)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float uk = k == 1 ? gv[r][q].y : k == 2 ? gv[r][q].z : gv[r][q].w;
              w[r][q] = k == 0 ? gs[r][q] : __fmul_rn(gs[r][q], uk);
            }
          cm::OpA aop;
          cm::make_a<kMode>(w, aop);
#pragma unroll
          for (int nt = 0; nt < cm::kNT; ++nt)
            if (nt * 8 < nfb) cm::mma<kMode>(acc[k][nt], aop, bop[nt]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int nt = 0; nt < cm::kNT; ++nt)
          accs[(k * cm::kNT + nt) * cm::kThreads + tid] =
              make_float4(acc[k][nt][0], acc[k][nt][1], acc[k][nt][2], acc[k][nt][3]);
    }

    if (active) {
      // the addresses here, not kept in registers from the kernel's start
      int col = (g0 + gl) * F + f0 + 2 * t4, bb = b, row0 = tile * 16 + gid;
      asm volatile("" : "+r"(col), "+r"(bb), "+r"(row0));
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int nt = 0; nt < cm::kNT; ++nt) {
          const float4 v = accs[(k * cm::kNT + nt) * cm::kThreads + tid];
          const float acc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + 8 * (e >> 1);
            const int fl = nt * 8 + 2 * t4 + (e & 1);
            if (row < nr && fl < nfb)
              out[((size_t(bb) * 4 + k) * C + ps[row]) * GF + col + nt * 8 + (e & 1)] = acc[e];
          }
        }
    }
  }
}

template <int kMode>
int launch_mma(const float* coord, const float* mask, const float* a, const int* nbr, const float* shift,
               const float* shifts_g, const float* scal, float* out, int* rec, int B, int C, int G, int F, int S,
               cudaStream_t stream) {
  int err0 = cm::launch_scan<false>(coord, mask, nbr, shift, scal, rec, B, C, S, stream);
  if (err0 != 0) return err0;
  // kernels/conv_stencil.py::mma_fwd_smem_bytes computes the same number
  const int smem = 4 * cm::FwdLayout(C, F, S, kMode).words;
  cudaError_t err = cudaFuncSetAttribute(conv_fwd_mma_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B, 1, cm::fwd_g_tiles(G) * cm::f_tiles(F));
  conv_fwd_mma_kernel<kMode><<<grid, cm::kThreads, smem, stream>>>(coord, mask, a, nbr, shift, shifts_g, scal,
                                                                    out, rec, B, C, G, F, S);
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
                                   const float* scal, float* out, int* rec, int B, int C, int G, int F,
                                   int S, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || G < 1 || F < 1 || S < 1 || cm::fwd_g_tiles(G) * cm::f_tiles(F) > 65535)
    return int(cudaErrorInvalidValue);
  if (mode == cm::kTF32)
    return launch_mma<cm::kTF32>(coord, mask, a, nbr, shift, shifts_g, scal, out, rec, B, C, G, F, S, st);
  if (mode == cm::k3xTF32)
    return launch_mma<cm::k3xTF32>(coord, mask, a, nbr, shift, shifts_g, scal, out, rec, B, C, G, F, S, st);
  if (mode == cm::kBF16)
    return launch_mma<cm::kBF16>(coord, mask, a, nbr, shift, shifts_g, scal, out, rec, B, C, G, F, S, st);
  return int(cudaErrorInvalidValue);
}

// Shared memory of one block of the tensor-core build in `mode` (bytes).
extern "C" int conv_fwd_mma_smem(int C, int F, int S, int mode) { return 4 * cm::FwdLayout(C, F, S, mode).words; }
