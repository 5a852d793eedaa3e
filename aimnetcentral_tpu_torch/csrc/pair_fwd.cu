// Kernel D: the per-atom sums of a symmetric pair term on the binned layout.
//
// Replaces the Pallas TPU kernel aimnetcentral_tpu/kernels/pair_sweep.py
// ::_fwd_kernel_hb (pair_sweep.py:228, its pallas_call :436) and the mirror
// gather after it.  For every receiver slot row i it sums
// e = c g(d, s_i, s_j) (csrc/pair_terms.cuh) over every pair within the
// cutoff, with c = p_i . r_j on the zero offset and the upper half of the
// half stencil and c = p_j . r_i on its mirror, the lower half: exactly what
// the half-stencil sweep sends to atom i (kernels/pair_sweep.py::
// pair_forward_plain).  The walk (csrc/pair_walk.cuh): one warp per receiver
// over the full stencil, a ballot over 32 candidate slots queues the real
// pairs within the cutoff, and the term runs on 32 queued pairs at a time,
// one a lane; each lane keeps its partial sum, and one butterfly per
// receiver finishes it.  No candidate-side rows: the output is the (B*C)
// sums itself.  No atomics; deterministic.
//
// What bounds it on an H100: its bytes are small (coordinates, extras and
// one sum an atom, a few MB at 10,000 atoms); its least time is set by the
// FP32 operations of the real pairs within the cutoff, counted per
// unordered pair as
//     DSF (exp envelope, SR part subtracted)   38
//     simple Coulomb (the same envelope)       22
//     short-range Coulomb (the same envelope)  21, in FP64
//     D3 coordination number                   18
//     D3(BJ) energy, V = 5 S                   40 + 2 V  (80 at S = 4)
//     real-space Ewald (SR part subtracted)    35
//     GFN1 repulsion (cosine cutoff)           26
//     D3 with the TS combination rule          40
// (geometry 9: three differences, the square sum and the sqrt; a special
// function or a division counts one).  The full stencil meets every pair
// from both ends, so it does that work twice, and it tests each real
// receiver against every slot of 2S - 1 candidate bins (cheap: four loads,
// nine operations and a ballot a slot, the slot rows shared through L1 by
// the receivers of one bin); in exchange there are no mirror rows, no
// gather and no per-slot-pair reduction.  An offset whose candidate bin's
// box of real atoms lies beyond the cutoff of the receiver is skipped (about
// half of them at the 10,000-atom LR grid), and the slot test compares d^2
// with an exact limit instead of taking a square root: the walk is bound by
// instruction issue.  A bilinear term's lane reads its candidate's row
// straight from L1/L2 for the one dot product the pair needs.
//
// The member form (a fused ensemble's E members, E <= 8): the walk is the
// same and the pair's geometry and member-independent factor (the erfc
// kernel and envelope, the D3TS damping) are computed once; each member
// adds its product (3 operations for a charge term, 11 for D3TS's TS
// combination) to one of E partial sums a lane, finished by one butterfly
// per member.  Its least time is still set by operations: the shared
// term's plus E products a pair.

#include <cuda_runtime.h>

#include "pair_walk.cuh"

// term: 0 DSF Coulomb, 1 D3 coordination number, 2 D3(BJ) energy,
// 3 simple Coulomb, 4 short-range Coulomb, 5 real-space Ewald, 6 GFN1
// repulsion, 7 D3 with the TS combination rule.
// consts: host pointer to 8 floats (the cutoff, then the term's constants).
// members: 0 for the single-model term; E > 0 for its member form (terms 0,
// 3, 4, 5 and 7; E <= 8), whose sums and cotangents are (B*C, E).
extern "C" int pair_fwd_launch(const float* consts, const float* coord, const float* mask,
                               const float* ext, const float* shift, const int* nbr,
                               const long long* inv, const float* box, float* out,
                               int* pair_count, int term, int members, int B, int C, int K, int S,
                               void* stream) {
  pair_walk::Args a{};
  for (int t = 0; t < 8; ++t) a.tc.c[t] = consts[t];
  a.coord = coord;
  a.mask = mask;
  a.ext = ext;
  a.shift = shift;
  a.nbr = nbr;
  a.inv = inv;
  a.box = box;
  a.out = out;
  a.pair_count = pair_count;
  a.B = B;
  a.C = C;
  a.K = K;
  a.S = S;
  a.E = members;
  return pair_walk::launch_term<false>(term, a, static_cast<cudaStream_t>(stream));
}
