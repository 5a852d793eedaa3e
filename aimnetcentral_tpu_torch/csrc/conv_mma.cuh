// The tensor-core builds of kernels A and B in the JAX package's conv
// precision modes: the modes, the staging and the layouts they share.
//
// The Pallas kernels contract through conv_stencil.py::_mxu_dot
// (aimnetcentral_tpu/kernels/conv_stencil.py:171) in one of three modes:
// "f32" (one dot at the ambient precision: one bf16 MXU pass under the JAX
// default), "f32x3" (each operand split into a high and a low part, three
// one-pass dots, hi.hi + hi.lo + lo.hi) and "bf16" (operands cast down).
// Hopper's counterpart of the MXU is the tensor core, so the port's builds
// of kernels A (conv_fwd.cu, replacing _fwd_kernel, conv_stencil.py:289;
// its _mxu_dot at :373) and B (conv_bwd.cu, replacing _bwd_kernel, :466;
// _mxu_dot at :574 and :590) in those modes (kernels/conv_pass.py::
// resolve_conv_mode) contract with mma.sync:
//
//   kTF32   one TF32 pass: W and the features rounded by cvt.rna.tf32.f32
//           (round to nearest, ties away from zero, 10 mantissa bits);
//           the "f32" mode under the `fast` tier's ambient (TF32 on);
//   k3xTF32 hi = tf32(x), lo = tf32(x - hi), lo.hi + hi.lo + hi.hi (the
//           small terms first) into FP32 accumulators: the "f32x3" mode;
//   kBF16   W and the features rounded to bf16 (round to nearest even):
//           the "bf16" mode.
//
// Only the contraction's operands are rounded, as in JAX, where _mxu_dot
// casts its operands alone: the geometry (d, fc, u), the Gaussian basis gs
// and every chain-rule sum stay FP32.  The FP32 builds of conv_fwd.cu and
// conv_bwd.cu run every other case (the `exact` tier).
//
// What bounds these builds on an H100.  The function's least time is the
// bytes it moves (features in, four times as many out; B also the
// cotangent); its contraction at the tensor cores' rate takes a tenth of
// that or less.  What a build spends beyond the bound is data movement and
// latency around the mma: finding the live candidates of each bin, the
// candidates' feature rows (A) or cotangent rows (B) from L2, each row
// feeding every receiver of the bin within rc of it, the geometry (a sqrt,
// a cos and three divisions a pair) and an exp for each (pair within rc,
// radial shift), and the barriers of a block.  Measured on an H100
// (PERF.md), finding the live candidates cost as much as the contraction
// once the operands were staged in shared memory.  This design:
//
// - Whole-bin blocks.  A block takes every real row of one bin (receivers
//   in A, atoms in B), compacted by a ballot on the mask in slot order (no
//   slot order of real and padding atoms is assumed), in passes of
//   kRowCap = 32 (two m16 tiles), for one tile of radial shifts and
//   feature columns.  B's partner rows are then one sum over the whole bin
//   (NJ = 1), added in pass order.
// - The live candidates once a bin.  live_scan_kernel, launched before
//   either build, tests every (offset, candidate slot) holding a real atom
//   against a pass's rows (the rows on a warp's lanes, each candidate's
//   coordinates broadcast, a ballot; d^2 against bounds around rc^2, the
//   exact sqrt of the plain version only near rc) and writes one bit a live
//   candidate, in three classes by the row tiles it pairs with, and their
//   prefix sums.  The blocks of a bin's shift tiles copy that record.
//   Offsets without a candidate bin (nbr = -1 on gas-phase grids), padding
//   slots and slots beyond rc of every row never reach the geometry.  The
//   live candidates of all offsets form one stream of entries (Stream), cut
//   into batches that fill the mma depth with no remainder but the
//   stream's last; each row tile walks only the classes it pairs with.
// - Staged operands.  A batch's feature rows (A) or cotangent rows (B),
//   only the block's columns, go to shared memory by cp.async (16 bytes a
//   copy where the rows are aligned, 4 bytes otherwise).  A double-buffers
//   them with the entries' coordinates: batch t+1's copies are in flight
//   while batch t's geometry is computed and batch t is contracted.  B
//   issues them before the batch's geometry.  Every mma operand is then
//   read from shared memory, at pitches chosen against bank conflicts.
// - Geometry once a pair.  A cheap d^2 test of each (row, entry) pair,
//   then the pairs within rc packed onto a warp's lanes for the sqrt, cos,
//   divisions and the exps of the block's shifts, into shared memory.
// - Two blocks an SM, no spills.  Blocks of 8 warps at most 128 registers
//   a thread.  A warp owns one m16 row tile and one radial shift in A (48
//   FP32 accumulators, kept in shared memory between batches), so A's
//   blocks take kFwdGTile = 4 shifts; B's take kBwdGTile = 8 (24
//   accumulators a thread).  Values formed once and used late (row
//   offsets, output addresses) are formed where they are used, behind an
//   empty asm, so that they do not hold registers across the kernel.  B's
//   constants' build holds six more sums a thread and runs one block an SM.
//
// The pair's W = gs [1, u] is computed exactly as the plain version computes
// it in these modes (kernels/conv_stencil.py::_pair_geometry, _conv_step):
// every operation rounded on its own, none contracted into an FMA, so that
// its bits are the plain version's and a rounding to TF32 or bf16 never
// falls on the other side of a tie from it.  Every sum is taken in a fixed
// order and every output element written by one block: no atomics, the
// same bits on a repeat.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_mma {

constexpr int kTF32 = 1;
constexpr int k3xTF32 = 2;
constexpr int kBF16 = 3;

constexpr int kWarps = 8;  // a block's warps
constexpr int kThreads = 32 * kWarps;
constexpr int kRowCap = 32;  // real rows a block (A) or a pass (B): two m16 tiles
constexpr int kFTile = 24;   // feature columns a block: three n8 tiles
constexpr int kNT = kFTile / 8;
constexpr int kFwdGTile = 4;     // radial shifts an A block: warp w owns tile w / 4, shift w % 4
constexpr int kFwdEntries = 32;  // entries an A batch
constexpr int kFwdQ = kFwdEntries + 4;  // pitch of A's (row, entry) arrays
constexpr int kBwdGTile = 8;     // radial shifts a B block
constexpr int kBwdEntries = 16;  // entries a B batch
constexpr int kBwdQ = kBwdEntries + 4;
constexpr float kPi = 3.14159265358979323846f;

static_assert(kWarps == 2 * kFwdGTile, "A: a warp for each (row tile, shift)");
static_assert(kThreads % kFwdEntries == 0 && kThreads % kBwdEntries == 0, "threads share the entries evenly");
static_assert(kFwdQ % 8 == 4 && kBwdQ % 8 == 4, "(row, entry) pitches against bank conflicts");

// Depth of one mma.sync and the depth indices a lane holds: the PTX ISA's
// fragment layouts of mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16 (A's columns
// and B's rows; A's rows are gid and gid + 8, B's and C's column gid, C's
// columns 2 t4 and 2 t4 + 1, where gid = lane / 4 and t4 = lane % 4).
template <int kMode>
struct Mma {
  static constexpr int K = kMode == kBF16 ? 16 : 8;
  static constexpr int NK = K / 4;
  __device__ static __forceinline__ int kidx(int t4, int q) {
    return kMode == kBF16 ? 2 * t4 + (q & 1) + 8 * (q >> 1) : t4 + 4 * q;
  }
};

struct OpA {  // an A operand (16 x K): hi and, in 3xTF32, lo
  uint32_t hi[4], lo[4];
};
struct OpB {  // a B operand (K x 8)
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the TF32 value as an exact float
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (the lower half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int kMode>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  if (kMode == k3xTF32) lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// v[r][q]: row gid + 8 r, depth kidx(q)
template <int kMode>
__device__ __forceinline__ void make_a(const float (&v)[2][Mma<kMode>::NK], OpA& op) {
  if constexpr (kMode == kBF16) {
    op.hi[0] = bf16x2(v[0][0], v[0][1]);
    op.hi[1] = bf16x2(v[1][0], v[1][1]);
    op.hi[2] = bf16x2(v[0][2], v[0][3]);
    op.hi[3] = bf16x2(v[1][2], v[1][3]);
  } else {
    split_tf32<kMode>(v[0][0], op.hi[0], op.lo[0]);
    split_tf32<kMode>(v[1][0], op.hi[1], op.lo[1]);
    split_tf32<kMode>(v[0][1], op.hi[2], op.lo[2]);
    split_tf32<kMode>(v[1][1], op.hi[3], op.lo[3]);
  }
}

// v[q]: depth kidx(q), column gid
template <int kMode>
__device__ __forceinline__ void make_b(const float (&v)[Mma<kMode>::NK], OpB& op) {
  if constexpr (kMode == kBF16) {
    op.hi[0] = bf16x2(v[0], v[1]);
    op.hi[1] = bf16x2(v[2], v[3]);
  } else {
    split_tf32<kMode>(v[0], op.hi[0], op.lo[0]);
    split_tf32<kMode>(v[1], op.hi[1], op.lo[1]);
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A B in the build's mode
template <int kMode>
__device__ __forceinline__ void mma(float (&c)[4], const OpA& a, const OpB& b) {
  if constexpr (kMode == kBF16) {
    mma_bf16(c, a.hi, b.hi);
  } else {
    if constexpr (kMode == k3xTF32) {
      mma_tf32(c, a.lo, b.hi);
      mma_tf32(c, a.hi, b.lo);
    }
    mma_tf32(c, a.hi, b.hi);
  }
}

// One forward pair's geometry, r = (x_j + shift) - x_i: d, fc and u.
struct Geom {
  float d, fc, ux, uy, uz;
};

__device__ __forceinline__ float pair_d2(float xj, float yj, float zj, float sx, float sy, float sz, float xi,
                                         float yi, float zi, float& dx, float& dy, float& dz) {
  dx = __fsub_rn(__fadd_rn(xj, sx), xi);
  dy = __fsub_rn(__fadd_rn(yj, sy), yi);
  dz = __fsub_rn(__fadd_rn(zj, sz), zi);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Bounds on d^2 around rc^2 (a relative 4e-6, far above the roundings of
// lo2, hi2 and the sqrt): below lo2 the rounded sqrt is below rc, above hi2
// it is not; only between them is the sqrt taken.
struct Rc2 {
  float rc, lo2, hi2;
  // __fsqrt_rn(d2) < rc: the plain version's d < rc
  __device__ __forceinline__ bool within(float d2) const {
    return d2 < lo2 || (d2 <= hi2 && __fsqrt_rn(d2) < rc);
  }
};

__device__ __forceinline__ Rc2 rc_bounds(float rc) {
  Rc2 b;
  b.rc = rc;
  b.lo2 = __fmul_rn(__fmul_rn(rc, rc), 1.0f - 4e-6f);
  b.hi2 = __fmul_rn(__fmul_rn(rc, rc), 1.0f + 4e-6f);
  return b;
}

// The geometry of a pair within rc (Rc2::within of its d^2 is true), every
// operation rounded on its own as the plain version computes it.
__device__ __forceinline__ Geom pair_geometry(float xj, float yj, float zj, float sx, float sy, float sz,
                                              float xi, float yi, float zi, float pi_rc) {
  Geom g;
  float dx, dy, dz;
  g.d = __fsqrt_rn(pair_d2(xj, yj, zj, sx, sy, sz, xi, yi, zi, dx, dy, dz));
  g.fc = __fmul_rn(0.5f, __fadd_rn(cosf(__fmul_rn(g.d, pi_rc)), 1.0f));
  g.ux = __fdiv_rn(dx, g.d);
  g.uy = __fdiv_rn(dy, g.d);
  g.uz = __fdiv_rn(dz, g.d);
  return g;
}

// One scan item: the 32 candidate slots of one offset held by the warp's
// lanes (lane c: real_c, coordinates x_c), tested against the pass's rows
// held by the lanes (lane r < nr: row r at xr, its slot rslot).  For each
// real candidate in turn its coordinates go to every lane, each lane tests
// its row with the plain version's d < rc, and a ballot gives the tiles:
// candidate c's lane returns bit t set when a row of m16 tile t (rows
// 16 t .. 16 t + 15) pairs with it.  kRowIsJ: the row is x_j of r = (x_j +
// shift) - x_i (kernel B); otherwise the candidate is (kernel A).  self:
// the candidate's slot at the zero offset (the self pair is dropped), else
// -1.  The loop is the same for the whole warp: no divergence, and only
// real candidates are walked.
template <bool kRowIsJ>
__device__ __forceinline__ unsigned live_tiles(bool real, float cx, float cy, float cz, int self, float sx, float sy,
                                               float sz, float4 xr, int rslot, int nr, const Rc2& rc2, int lane) {
  unsigned bits = 0;
  unsigned todo = __ballot_sync(0xffffffffu, real);
  while (todo) {
    const int c = __ffs(todo) - 1;
    todo &= todo - 1;
    const float qx = __shfl_sync(0xffffffffu, cx, c);
    const float qy = __shfl_sync(0xffffffffu, cy, c);
    const float qz = __shfl_sync(0xffffffffu, cz, c);
    const int qs = __shfl_sync(0xffffffffu, self, c);
    bool in = false;
    if (lane < nr && rslot != qs) {
      float dx, dy, dz;
      const float d2 = kRowIsJ ? pair_d2(xr.x, xr.y, xr.z, sx, sy, sz, qx, qy, qz, dx, dy, dz)
                               : pair_d2(qx, qy, qz, sx, sy, sz, xr.x, xr.y, xr.z, dx, dy, dz);
      in = rc2.within(d2);
    }
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (lane == c) bits = (m & 0xffffu ? 1u : 0u) | (m >> 16 ? 2u : 0u);
  }
  return bits;
}

// exp(-eta (d - s_g)^2), as the plain version's torch.exp(-eta * dd * dd)
__device__ __forceinline__ float gauss(float d, float sg, float eta) {
  const float dd = __fsub_rn(d, sg);
  return expf(__fmul_rn(__fmul_rn(-eta, dd), dd));
}

// The k-th (from 0) set bit of w, which has more than k set bits.
__device__ __forceinline__ int nth_set_bit(unsigned w, int k) {
  int pos = 0;
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    const unsigned lo = w & ((1u << sh) - 1u);
    const int c = __popc(lo);
    if (k >= c) {
      k -= c;
      w >>= sh;
      pos += sh;
    } else {
      w = lo;
    }
  }
  return pos;
}

// ---------------------------------------------------------------------------
// cp.async: a copy from global to shared memory that the issuing thread
// waits for with cp_async_wait; src_bytes 0 fills zeros.

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// n1 x n2 runs of len floats: run (i1, i2) from src + i1 s1 + i2 s2 to
// dst + i1 d1 + i2 d2, in chunks of 16 bytes (vec: every run start aligned,
// len % 4 == 0) or 4; this thread issues chunks part, part + nparts, ...
// With !valid it fills the runs with zeros (src is not read).
__device__ __forceinline__ void stage_runs(float* dst, const float* src, int n1, int n2, size_t s1, int s2, int d1,
                                           int d2, int len, bool vec, bool valid, int part, int nparts) {
  const int cs = vec ? 4 : 1;
  const int cpr = len / cs;
  const int total = n1 * n2 * cpr;
  for (int c = part; c < total; c += nparts) {
    const int run = c / cpr;
    const int off = (c - run * cpr) * cs;
    const int i1 = run / n2;
    const int i2 = run - i1 * n2;
    float* dp = dst + i1 * d1 + i2 * d2 + off;
    const float* sp = valid ? src + i1 * s1 + size_t(i2) * s2 + off : src;
    if (vec) {
      cp_async16(dp, sp, valid ? 16 : 0);
    } else {
      cp_async4(dp, sp, valid ? 4 : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// The block's rows and its stream of live entries.

// Warp 0: the real slots of bin `bin` in slot order; those of ranks
// [r0, r0 + nslot) go to slots[rank - r0].  Returns the bin's real rows.
__device__ __forceinline__ int compact_rows(const float* __restrict__ mask, int bin, int C, int r0, int nslot,
                                            int* slots, int lane) {
  int base = 0;
  for (int w0 = 0; w0 < C; w0 += 32) {
    const int j = w0 + lane;
    const bool real = j < C && mask[size_t(bin) * C + j] > 0.5f;
    const unsigned m = __ballot_sync(0xffffffffu, real);
    const int rank = base + __popc(m & ((1u << lane) - 1u));
    if (real && rank >= r0 && rank < r0 + nslot) slots[rank - r0] = j;
    base += __popc(m);
  }
  return base;
}

// Warp 0: the rows' coordinates, float4 rows[r] for r < nr <= 32.
__device__ __forceinline__ void load_rows(const float* __restrict__ coord, int bin, int C, const int* slots, int nr,
                                          float4* rows, int lane) {
  if (lane < nr) {
    const size_t r = size_t(bin) * C + slots[lane];
    rows[lane] = make_float4(coord[3 * r + 0], coord[3 * r + 1], coord[3 * r + 2], 0.0f);
  }
}

// The live candidates of a pass of rows, in three classes by the m16 row
// tiles they pair with: tile 0 only, both, tile 1 only.  The entry stream
// is the three classes one after the other (each in offset and slot order),
// so that tile 0's warps take the entries [0, E0 + E01) and tile 1's
// [E0, E0 + E01 + E1): a tile walks only the entries it pairs with, give or
// take a chunk at each end.  masks: [3][S][W] words; prefix: [3][S + 1].
struct Stream {
  const unsigned* masks;
  const int* prefix;
  int S, W, E0, E01, E;
  __device__ __forceinline__ Stream(const unsigned* m, const int* p, int s, int w)
      : masks(m), prefix(p), S(s), W(w) {
    E0 = p[S];
    E01 = p[2 * (S + 1) - 1];
    E = E0 + E01 + p[3 * (S + 1) - 1];
  }
  // entries [lo, hi) of the stream that row tile t walks
  __device__ __forceinline__ int lo(int t) const { return t == 0 ? 0 : E0; }
  __device__ __forceinline__ int hi(int t) const { return t == 0 ? E0 + E01 : E; }
  // entry e's offset and candidate slot
  __device__ __forceinline__ void decode(int e, int& s, int& slot) const {
    int c = 0;
    if (e >= E0) {
      e -= E0;
      c = 1;
      if (e >= E01) {
        e -= E01;
        c = 2;
      }
    }
    const int* p = prefix + c * (S + 1);
    const unsigned* m = masks + c * S * W;
    int lo = 0, hi = S;  // p[lo] <= e < p[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (p[mid] <= e) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    s = lo;
    int k = e - p[lo];
    slot = 0;
    for (int w = 0; w < W; ++w) {
      const unsigned bits = m[lo * W + w];
      const int n = __popc(bits);
      if (k < n) {
        slot = 32 * w + nth_set_bit(bits, k);
        return;
      }
      k -= n;
    }
  }
};

// Warp w < 3, after the masks: class w's prefix[s], the entries before
// offset s, and prefix[S], all of them.
__device__ __forceinline__ void prefix_entries(const unsigned* masks, int S, int W, int* prefix, int lane) {
  int run = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    int cnt = 0;
    if (s < S)
      for (int w = 0; w < W; ++w) cnt += __popc(masks[s * W + w]);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (s < S) prefix[s] = run + incl - cnt;
    run += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) prefix[S] = run;
}

// The scan's ballots for one (offset, 32 slots) item: the three classes.
__device__ __forceinline__ void store_classes(unsigned* masks, int S, int W, int item, unsigned bits, int lane) {
  const unsigned m0 = __ballot_sync(0xffffffffu, bits == 1u);
  const unsigned m01 = __ballot_sync(0xffffffffu, bits == 3u);
  const unsigned m1 = __ballot_sync(0xffffffffu, bits == 2u);
  if (lane == 0) {
    masks[item] = m0;
    masks[S * W + item] = m01;
    masks[2 * S * W + item] = m1;
  }
}

// ---------------------------------------------------------------------------
// Tiles and shared-memory layouts, in 4-byte words (kernels/conv_stencil.py
// mirrors them: mma_fwd_smem_bytes, mma_bwd_smem_bytes).

__host__ __device__ constexpr int f_width(int F) { return F < kFTile ? F : kFTile; }
__host__ __device__ constexpr int f_tiles(int F) { return (F + kFTile - 1) / kFTile; }
__host__ __device__ constexpr int fwd_g_tiles(int G) { return (G + kFwdGTile - 1) / kFwdGTile; }
__host__ __device__ constexpr int bwd_g_tiles(int G) { return (G + kBwdGTile - 1) / kBwdGTile; }
__host__ __device__ constexpr int row_groups(int C) { return (C + kRowCap - 1) / kRowCap; }
// a pitch >= base, congruent to mod modulo 32 banks
__host__ __device__ constexpr int pitch_at(int base, int mod) { return base + ((mod - base) % 32 + 32) % 32; }
// the staged operand rows' pitch: depth (entries) along t4 in TF32, 2 t4 in bf16
__host__ __device__ constexpr int stage_mod(int mode) { return mode == kBF16 ? 4 : 8; }
__host__ __device__ constexpr int align4(int o) { return (o + 3) & ~3; }

struct FwdLayout {
  int P, W, accs, geo4, cst, rows, shs, ex, stage, sg, est, nbs, masks, prefix, slots, words;
  __host__ __device__ FwdLayout(int C, int F, int S, int mode) {
    P = pitch_at(kFwdGTile * f_width(F), stage_mod(mode));
    W = (C + 31) / 32;
    int o = 0;
    accs = o;  // [12][kThreads] float4: each thread's 48 accumulators between its batches
    o += 48 * kThreads;
    geo4 = o;  // [kRowCap][kFwdQ] float4 (fc, ux, uy, uz) of the batch's pairs
    o += kRowCap * kFwdQ * 4;
    cst = o;  // [2][kFwdEntries] float4 the entries' coordinates
    o += 2 * kFwdEntries * 4;
    rows = o;  // [kRowCap] float4 receiver coordinates
    o += 4 * kRowCap;
    shs = o;  // [S] float4 the offsets' lattice shifts
    o += 4 * S;
    ex = o;  // [kFwdGTile][kRowCap][kFwdQ] exp(-eta (d - s_g)^2) within rc, else 0
    o += kFwdGTile * kRowCap * kFwdQ;
    stage = align4(o);  // [2][kFwdEntries][P] the entries' feature rows, the block's columns
    o = stage + 2 * kFwdEntries * P;
    sg = o;
    o += kFwdGTile;
    est = o;  // [2][2][kFwdEntries] the entries' offsets and self slots
    o += 4 * kFwdEntries;
    nbs = o;  // [S] the offsets' candidate bins
    o += S;
    masks = o;  // [3][S][W] the live candidates by class (Stream)
    o += 3 * S * W;
    prefix = o;
    o += 3 * (S + 1);
    slots = o;  // [C] the bin's real slots in order
    o += C;
    words = o;
  }
};

struct BwdLayout {
  int Pk, Pe, Pr, W, geo4, red, rows, shs, geo2, ex, stage, as, sg, csum, gcs, masks, prefix, slots, ent, nbs, words;
  __host__ __device__ BwdLayout(int C, int F, int S, int mode) {
    Pk = kBwdGTile * f_width(F);
    Pe = pitch_at(4 * Pk, stage_mod(mode));
    Pr = pitch_at(kBwdGTile * f_width(F), 4);
    W = (C + 31) / 32;
    int o = 0;
    geo4 = o;  // [kRowCap][kBwdQ] float4 (fc, ux, uy, uz)
    o += kRowCap * kBwdQ * 4;
    red = o;  // [2][kRowCap][kBwdEntries] float4: (ubar, dbar) by half of the shifts; then rbar
    o += 2 * kRowCap * kBwdEntries * 4;
    rows = o;  // [kRowCap] float4 atom coordinates
    o += 4 * kRowCap;
    shs = o;  // [S] float4 the offsets' forward lattice shifts
    o += 4 * S;
    geo2 = o;  // [kRowCap][kBwdQ] float2 (d, fc')
    o += kRowCap * kBwdQ * 2;
    ex = o;  // [kBwdGTile][kRowCap][kBwdQ]
    o += kBwdGTile * kRowCap * kBwdQ;
    stage = align4(o);  // [kBwdEntries][Pe]: [k][g][f] the entries' cotangent rows
    o = stage + kBwdEntries * Pe;
    as = align4(o);  // [kRowCap][Pr]: the rows' features [g][f]
    o = as + kRowCap * Pr;
    sg = o;
    o += kBwdGTile;
    csum = o;  // [kWarps][6] the constants' warp sums
    o += 6 * kWarps;
    gcs = o;  // [kRowCap][3] the pass's atoms' coordinate sums
    o += 3 * kRowCap;
    masks = o;  // [3][S][W]
    o += 3 * S * W;
    prefix = o;
    o += 3 * (S + 1);
    slots = o;  // [C] the bin's real slots in order
    o += C;
    ent = o;  // [2][2][kBwdEntries] the batch's offsets and slots, by batch parity
    o += 4 * kBwdEntries;
    nbs = o;  // [S] the offsets' partner bins
    o += S;
    words = o;
  }
};

// ---------------------------------------------------------------------------
// The live-candidate scan, a kernel of its own that runs before kernels A
// and B: for each (bin, pass of kRowCap real rows) the Stream's masks and
// prefix, written to a scratch array that the main kernel's blocks (one a
// shift-and-column tile of the bin) copy into shared memory.  A block a
// (bin, pass), small and many to an SM, so that its latency-bound walk over
// (offset, candidate) items overlaps other blocks'.

constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;  // items a warp loads together

// words of one (bin, pass) record: masks [3][S][W], prefix [3][S + 1]
__host__ __device__ constexpr int scan_words(int C, int S) { return 3 * S * ((C + 31) / 32) + 3 * (S + 1); }

struct ScanLayout {
  int rows, shs, slots, nbs, rec, words;
  __host__ __device__ ScanLayout(int C, int S) {
    int o = 0;
    rows = o;  // [kRowCap] float4
    o += 4 * kRowCap;
    shs = o;  // [S] float4
    o += 4 * S;
    slots = o;  // [kRowCap] the pass's rows' slots
    o += kRowCap;
    nbs = o;  // [S]
    o += S;
    rec = o;  // the record: masks, then prefix
    o += scan_words(C, S);
    words = o;
  }
};

// kRowIsJ (kernel B): rows are the atoms j of bin `bin`, candidates the
// partner slots i of p = nbr[s, bin] (mnbr), shifted by shift[s, p];
// otherwise (kernel A) rows are receivers, candidates the slots of
// n = nbr[s, bin], shifted by shift[s, bin].  rec: (B, npass) records.
template <bool kRowIsJ>
__global__ void __launch_bounds__(kScanThreads)
live_scan_kernel(const float* __restrict__ coord, const float* __restrict__ mask, const int* __restrict__ nbr,
                 const float* __restrict__ shift, const float* __restrict__ scal, int* __restrict__ rec, int B,
                 int C, int S, int npass) {
  extern __shared__ float4 scan_smem4[];
  float* const smem = reinterpret_cast<float*>(scan_smem4);
  const ScanLayout L(C, S);
  float4* const rows = scan_smem4 + L.rows / 4;
  float4* const shs = scan_smem4 + L.shs / 4;
  int* const slots = reinterpret_cast<int*>(smem + L.slots);
  int* const nbs = reinterpret_cast<int*>(smem + L.nbs);
  int* const out = reinterpret_cast<int*>(smem + L.rec);
  unsigned* const masks = reinterpret_cast<unsigned*>(out);
  int* const prefix = out + 3 * S * ((C + 31) / 32);
  __shared__ int nrow_s;
  const int bin = blockIdx.x;
  const int pass = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int W = (C + 31) / 32;
  const Rc2 rc2 = rc_bounds(scal[1]);

  if (warp == 0) {
    const int nrow = compact_rows(mask, bin, C, pass * kRowCap, kRowCap, slots, lane);
    if (lane == 0) nrow_s = nrow;
  }
  for (int s = tid; s < S; s += kScanThreads) {
    const int n = nbr[size_t(s) * B + bin];
    nbs[s] = n;
    const int sb = kRowIsJ ? n : bin;  // the shift's bin: the forward pair's receiver bin
    if (sb >= 0) {
      const float* sh = shift + (size_t(s) * B + sb) * 3;
      shs[s] = make_float4(sh[0], sh[1], sh[2], 0.0f);
    }
  }
  __syncthreads();
  const int nr = min(kRowCap, max(0, nrow_s - pass * kRowCap));
  if (pass > 0 && nr == 0) return;  // a pass no main block makes (pass 0 always is made)
  if (warp == 0) load_rows(coord, bin, C, slots, nr, rows, lane);
  __syncthreads();
  const float4 xrow = lane < nr ? rows[lane] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // lane's row
  const int rslot = lane < nr ? slots[lane] : -2;

  // a warp per (offset, 32 slots), kScanItems at a time: the loads first
  for (int i0 = warp; i0 < S * W; i0 += kScanItems * (kScanThreads / 32)) {
    float4 xc[kScanItems];
    bool real[kScanItems];
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const int item = i0 + q * (kScanThreads / 32);
      const int s = item / W;
      const int j = (item - s * W) * 32 + lane;
      const int n = item < S * W ? nbs[s] : -1;
      real[q] = false;
      xc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n >= 0 && j < C) {
        const size_t cr = size_t(n) * C + j;
        real[q] = mask[cr] > 0.5f;
        xc[q] = make_float4(coord[3 * cr + 0], coord[3 * cr + 1], coord[3 * cr + 2], 0.0f);
      }
    }
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const int item = i0 + q * (kScanThreads / 32);
      if (item >= S * W) break;  // the same for the warp
      const int s = item / W;
      const int j = (item - s * W) * 32 + lane;
      const float4 sh = shs[s];
      const unsigned bits = live_tiles<kRowIsJ>(real[q], xc[q].x, xc[q].y, xc[q].z, s == 0 ? j : -1, sh.x, sh.y,
                                                sh.z, xrow, rslot, nr, rc2, lane);
      store_classes(masks, S, W, item, bits, lane);
    }
  }
  __syncthreads();
  if (warp < 3) prefix_entries(masks + warp * S * W, S, W, prefix + warp * (S + 1), lane);
  __syncthreads();
  int* dst = rec + (size_t(bin) * npass + pass) * scan_words(C, S);
  for (int t = tid; t < scan_words(C, S); t += kScanThreads) dst[t] = out[t];
}

// Launch the scan for the main kernel's (B, npass) records.
template <bool kRowIsJ>
int launch_scan(const float* coord, const float* mask, const int* nbr, const float* shift, const float* scal,
                int* rec, int B, int C, int S, cudaStream_t stream) {
  const int smem = 4 * ScanLayout(C, S).words;
  cudaError_t err = cudaFuncSetAttribute(live_scan_kernel<kRowIsJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return int(err);
  live_scan_kernel<kRowIsJ><<<dim3(B, row_groups(C)), kScanThreads, smem, stream>>>(coord, mask, nbr, shift, scal,
                                                                                   rec, B, C, S, row_groups(C));
  return int(cudaGetLastError());
}

}  // namespace conv_mma
