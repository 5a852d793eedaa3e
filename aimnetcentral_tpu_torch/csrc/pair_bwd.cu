// Kernel E: the fused adjoint of kernel D (csrc/pair_fwd.cu).
//
// Replaces the Pallas TPU kernel aimnetcentral_tpu/kernels/pair_sweep.py
// ::_bwd_kernel_hb (pair_sweep.py:283, its pallas_call :474) and the
// reassembly of _pair_acc_hb_bwd.  Given the cotangent ct of the per-atom
// sums it gives, per receiver slot row, the coordinate adjoint, the extras
// adjoint [p (V), r (V), s] and the lattice-shift adjoint rows: the VJP of
// kernels/pair_sweep.py::pair_forward_plain, with the half stencil's
// conventions (csrc/pair_walk.cuh sets them out: at the zero offset the
// cotangent ct_i on c_ij and ct_j on c_ji; elsewhere ct_i + ct_j on the c
// the half stencil forms).  Every output is the receiver's own row, written
// by its warp:
//   gc (B*C, 3), ge (B*C, K) in the extras' layout, and
//   gs_rows (B*C, S, 3): each receiver's share of the shift adjoint of every
//     half offset, which the wrapper adds over a bin's atoms in a fixed
//     order (13 MB at the 10,000-atom LR grid, B*C = 17,280, S = 63).
// No atomics; deterministic.
//
// Design: the walk of kernel D.  Per batch of 32 queued pairs each lane
// forms its pair's term and derivatives and adds the receiver-side scalars
// (3 coordinates, s) to its own partial sums, finished by one butterfly per
// receiver; the shift adjoint goes through a segmented scan over runs of
// one offset (the queue is in offset order) into a per-warp (S, 3) row in
// shared memory; for a bilinear term the V-wide adjoints of p_i (weights
// cp g against the candidates' r) and r_i (cq g against their p) are summed
// with the lanes over columns, each lane owning columns lane + 32 m
// (V <= 96, one build for each of M = 1, 2, 3 columns) in registers, the
// pair weights handed out by shuffles and the candidate rows read with
// warp-wide contiguous loads, four pairs' rows in flight together; each
// batch's sums are added to the running ones, so no column sums more than
// 32 terms in one chain.  Nothing is paid per slot pair beyond the distance
// test and its ballot.
//
// What bounds it on an H100: as for kernel D, the bytes are small (inputs,
// the adjoints and the shift rows, about 20 MB at the 10,000-atom LR grid)
// and the least time is set by the FP32 operations of the real pairs within
// the cutoff, counted per unordered pair as
//     DSF (exp envelope, SR part subtracted)   75
//     simple Coulomb (the same envelope)       51
//     short-range Coulomb (the same envelope)  47, in FP64
//     D3 coordination number                   42
//     D3(BJ) energy, V = 5 S                   115 + 4 V  (195 at S = 4)
//     real-space Ewald (SR part subtracted)    70
//     GFN1 repulsion (cosine cutoff)           60
//     D3 with the TS combination rule          104 (three scalar adjoints)
// (the forward's operations, the derivatives, and the coordinate chain:
// 1/d, three products, nine adds).  The full stencil does the term twice
// per unordered pair, and the vector adjoints cost two loads, two FMAs and
// three shuffles a column per real ordered pair, waiting on L2 for the
// candidates' rows: for the D3 energy that part, not the term, sets the
// time.
//
// The member form: the receiver's E cotangents are read once and the
// candidate's per pair; each member's derivatives come from the shared
// factor, and the coordinate and shift adjoints take the sum over the
// members of (ct_i,m + ct_j,m) dg_m/dd, so the scan and the butterflies
// are the single term's; the extras adjoint holds the shared scalars' and
// every member's own (17 at E = 8 for D3TS) in registers.

#include <cuda_runtime.h>

#include "pair_walk.cuh"

// term: 0 DSF Coulomb, 1 D3 coordination number, 2 D3(BJ) energy,
// 3 simple Coulomb, 4 short-range Coulomb, 5 real-space Ewald, 6 GFN1
// repulsion, 7 D3 with the TS combination rule.
// consts: host pointer to 8 floats (the cutoff, then the term's constants).
// members: 0 for the single-model term; E > 0 for its member form (terms 0,
// 3, 4, 5 and 7; E <= 8), whose sums and cotangents are (B*C, E).
extern "C" int pair_bwd_launch(const float* consts, const float* coord, const float* mask,
                               const float* ext, const float* shift, const int* nbr,
                               const long long* inv, const float* box, const float* ct,
                               float* gc, float* ge, float* gs_rows, int* pair_count, int term,
                               int members, int B, int C, int K, int S, void* stream) {
  pair_walk::Args a{};
  for (int t = 0; t < 8; ++t) a.tc.c[t] = consts[t];
  a.coord = coord;
  a.mask = mask;
  a.ext = ext;
  a.shift = shift;
  a.nbr = nbr;
  a.inv = inv;
  a.box = box;
  a.ct = ct;
  a.gc = gc;
  a.ge = ge;
  a.gs_rows = gs_rows;
  a.pair_count = pair_count;
  a.B = B;
  a.C = C;
  a.K = K;
  a.S = S;
  a.E = members;
  return pair_walk::launch_term<true>(term, a, static_cast<cudaStream_t>(stream));
}
