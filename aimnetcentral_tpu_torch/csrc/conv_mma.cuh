// The tensor-core contraction of kernels A and B in the JAX package's conv
// precision modes.
//
// The Pallas kernels contract through conv_stencil.py::_mxu_dot
// (aimnetcentral_tpu/kernels/conv_stencil.py:171) in one of three modes:
// "f32" (one dot at the ambient precision: one bf16 MXU pass under the JAX
// default), "f32x3" (each operand split into a high and a low part, three
// one-pass dots, hi.hi + hi.lo + lo.hi) and "bf16" (operands cast down).
// Hopper's counterpart of the MXU is the tensor core, so the port's builds
// of kernels A and B in those modes (kernels/conv_pass.py::resolve_conv_mode)
// contract with mma.sync:
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
// conv_bwd.cu are unchanged and run every other case (the `exact` tier).
//
// Tiles.  JAX forms (4C x C_j) @ (C_j x F) for each block of radial shifts
// over a pair of bins.  Here a block owns a tile of kRows receiver slots
// (kernel A) or atoms (kernel B), kGTile radial shifts (a warp each) and
// kFTile feature columns (F = 17 pads to 24: three n8 tiles, the padding
// columns read as zeros).  It walks the partner bins' slots kSlots at a
// time: a geometry pass computes each (row, slot) pair once into shared
// memory, a ballot marks the slots that have a pair within rc with some row
// of the tile, and only those live slots are packed into the mma's depth
// (W is zero beyond rc, so a dead slot adds nothing).  Wider rows (a fused
// ensemble's member-stacked features, G*F = 1,088) take more blocks along a
// third grid axis, one for each (kGTile shifts, kFTile columns) tile.
//
// The pair's W = gs [1, u] is computed exactly as the plain version computes
// it in these modes (kernels/conv_stencil.py::_pair_geometry, _conv_step):
// every operation rounded on its own, none contracted into an FMA, so that
// its bits are the plain version's and a rounding to TF32 or bf16 never
// falls on the other side of a tie from it.
//
// What bounds it on an H100: as for the FP32 builds, the function's least
// time is the bytes it moves; its operations at the tensor cores' rate take
// far less.  These builds spend their time around the mma: the geometry pass
// of each (row tile, kSlots) step with its three barriers, an exp for every
// (row, live slot, shift) rather than for the real pairs alone, the B
// operands' loads from L2, and in kernel B spills at 128 registers a thread.
// So they run slower than the FP32 builds (PERF.md's kernel table); wgmma,
// TMA and a tighter packing of the live slots are the later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_mma {

constexpr int kTF32 = 1;
constexpr int k3xTF32 = 2;
constexpr int kBF16 = 3;

constexpr int kRows = 16;   // receiver slots (A) or atoms (B) a block: one m16 tile
constexpr int kWarps = 16;  // a block's warps
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 32;  // partner slots a step: one a lane of the geometry pass
constexpr int kGTile = 16;  // radial shifts a block, one a warp
constexpr int kFTile = 24;  // feature columns a block: three n8 tiles
constexpr int kNT = kFTile / 8;
constexpr float kPi = 3.14159265358979323846f;

static_assert(kGTile == kWarps, "a warp owns one radial shift of the block's tile");
static_assert(kRows * kSlots == kThreads, "the geometry pass: one pair a thread");

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

// One forward pair's geometry, r = (x_j + shift) - x_i, as the plain version
// computes it.  Beyond rc (or not a pair) fc = 0 and u = 0.
struct Geom {
  float d, fc, ux, uy, uz;
  bool within;
};

__device__ __forceinline__ Geom pair_geometry(float xj, float yj, float zj, float sx, float sy, float sz,
                                              float xi, float yi, float zi, bool vp, float rc,
                                              float pi_rc) {
  Geom g;
  const float dx = __fsub_rn(__fadd_rn(xj, sx), xi);
  const float dy = __fsub_rn(__fadd_rn(yj, sy), yi);
  const float dz = __fsub_rn(__fadd_rn(zj, sz), zi);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  g.d = __fsqrt_rn(vp ? d2 : 1.0f);
  g.within = vp && g.d < rc;
  g.fc = 0.0f;
  g.ux = g.uy = g.uz = 0.0f;
  if (g.within) {
    g.fc = __fmul_rn(0.5f, __fadd_rn(cosf(__fmul_rn(g.d, pi_rc)), 1.0f));
    g.ux = __fdiv_rn(dx, g.d);
    g.uy = __fdiv_rn(dy, g.d);
    g.uz = __fdiv_rn(dz, g.d);
  }
  return g;
}

// exp(-eta (d - s_g)^2), as the plain version's torch.exp(-eta * dd * dd)
__device__ __forceinline__ float gauss(float d, float sg, float eta) {
  const float dd = __fsub_rn(d, sg);
  return expf(__fmul_rn(__fmul_rn(-eta, dd), dd));
}

// Blocks along the third grid axis: (G / kGTile) x (F / kFTile) tiles.
__host__ __device__ __forceinline__ int g_tiles(int G) { return (G + kGTile - 1) / kGTile; }
__host__ __device__ __forceinline__ int f_tiles(int F) { return (F + kFTile - 1) / kFTile; }

}  // namespace conv_mma
