"""The stencil ConvSV contraction and its adjoint: CUDA kernels and plain versions.

Replaces the two Pallas TPU kernels of aimnetcentral_tpu/kernels/conv_stencil.py:

- ``conv_stencil_forward`` (kernel A, csrc/conv_fwd.cu) replaces
  ``_fwd_kernel`` (conv_stencil.py:289).  For every receiver bin b, stencil
  offset s and pair (i in b, j in the candidate bin nbr[s, b]) within rc:
  ``gs_g = exp(-eta (d - s_g)^2) fc(d)``, ``u = r_ij / d`` and
  ``out[b, k, i, g, f] += W_k[i, j, g] a[j, g, f]`` with
  ``W = [gs, gs u_x, gs u_y, gs u_z]``.  The self pair is dropped only at
  the zero offset (s = 0): in a box with fewer than 2r+1 bins per axis the
  same bin recurs at other offsets as a real periodic image.
- ``conv_stencil_backward`` (kernel B, csrc/conv_bwd.cu plus one gather)
  replaces ``_bwd_kernel`` (conv_stencil.py:466) and the reassembly in
  conv_pallas.py::conv_bwd_acc.  Given the output cotangent it returns the
  feature, coordinate and lattice-shift adjoints.
  ``conv_stencil_backward_constants`` is the same kernel's second build,
  which also returns the adjoints of the AEV constants (the radial shifts,
  eta and rc): training differentiates them, as the JAX package's XLA
  engine does; inference never asks for them.

Both kernels run one warp per receiver atom and contract only the real
pairs within rc, which a ballot over the candidate slots picks out; FP32 on
CUDA cores (the exact tier has no TF32) with no float atomics: every output
element is owned by one block and every sum has a fixed order, so results
are deterministic.  What bounds them on an H100 and what the design does about
it is in the notes at the top of each source.  A G*F row wider than one
build's lanes hold (a fused ensemble's member-stacked features) is cut into
column tiles, a grid axis of both kernels (``col_tiles``).

Each wrapper takes its plain PyTorch version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.  ``launches`` on each
wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from aimnetcentral_tpu_torch.kernels.build import bind as _bind
from aimnetcentral_tpu_torch.kernels.build import ptr as _ptr

WARPS = 8  # receiver atoms a block of kernels A and B, one warp each
LANE_COLUMNS = (9, 17)  # columns of the G*F row a lane may own (the kernels' builds)
MAX_COL_TILES = 8  # column tiles of one launch: G*F <= 8 x 544 = 4,352
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper


@dataclasses.dataclass(frozen=True)
class ConvStatic:
    """Static shapes of one stencil conv: B bins of capacity C, G radial
    shifts, F feature columns per shift, S stencil offsets."""

    b_tot: int
    c: int
    g: int
    f: int
    s_tot: int


# ---------------------------------------------------------------------------
# plain versions


def _conv_step(st: ConvStatic, s: int, a_gmajor, coord, mask, shift_s, nbr_s, shifts_g, scal):
    """One stencil offset of the plain forward: (B, 4, C, G, F)."""
    c = st.c
    eta, rc = scal[0], scal[1]
    ci = coord
    cj = coord[nbr_s] + shift_s[:, None, :]
    diff = cj[:, None, :, :] - ci[:, :, None, :]  # (B, Ci, Cj, 3)
    d2 = (diff * diff).sum(-1)
    real_i = (mask > 0.5)[:, :, None]
    real_j = (mask[nbr_s] > 0.5)[:, None, :]
    vp = real_i & real_j
    if s == 0:  # the zero offset: drop the self pair
        vp = vp & ~torch.eye(c, dtype=torch.bool, device=coord.device)[None]
    d = torch.sqrt(torch.where(vp, d2, torch.ones_like(d2)))
    within = vp & (d < rc)
    fc = torch.where(within, 0.5 * (torch.cos(torch.minimum(d, rc) * (math.pi / rc)) + 1.0), 0.0)
    dd = d[..., None] - shifts_g
    gs = torch.exp(-eta * dd * dd) * fc[..., None]  # (B, Ci, Cj, G)
    u = diff / d[..., None]
    w = torch.stack([gs] + [gs * u[..., k, None] for k in range(3)], dim=1)  # (B, 4, Ci, Cj, G)
    a_cand = a_gmajor[nbr_s].reshape(st.b_tot, c, st.g, st.f)
    return torch.einsum("bkijg,bjgf->bkigf", w, a_cand)


def conv_forward_plain(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, shifts_g, scal):
    """Plain version of kernel A (the twin of conv_pallas._conv_acc_xla).

    a_gmajor (B, C, G*F), coord (B, C, 3), mask (B, C), shift (S, B, 3)
    cartesian lattice shifts added to the candidates, nbr (S, B) candidate
    bins (-1 for a gas-phase step without one; its shift pushes the
    candidates out of range), shifts_g (G,), scal (2,) = [eta, rc].
    Returns (B, 4, C, G*F).  Each offset is checkpointed so a backward holds
    one offset's pair tensors at a time.
    """
    acc = torch.zeros((st.b_tot, 4, st.c, st.g, st.f), dtype=a_gmajor.dtype, device=a_gmajor.device)
    nbr = nbr.clamp(min=0).long()
    for s in range(st.s_tot):
        acc = acc + checkpoint(
            _conv_step, st, s, a_gmajor, coord, mask, shift[s], nbr[s], shifts_g, scal,
            use_reentrant=False,
        )
    return acc.reshape(st.b_tot, 4, st.c, st.g * st.f)


def conv_backward_plain(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, gbar,
                        create_graph: bool = False, constants: bool = False):
    """Plain version of kernel B: the VJP of :func:`conv_forward_plain`
    through torch.autograd, in B's output frame ``(grad_a (B, C, G*F),
    grad_coord (B, C, 3), grad_shift (S, B, 3))``, and with ``constants``
    also ``grad_shifts_g (G,)`` and ``grad_scal (2,)`` (the plain version of
    :func:`conv_stencil_backward_constants`).

    With ``create_graph`` the caller's ``a_gmajor``, ``coord``, ``shift``
    and ``gbar`` (and with ``constants`` ``shifts_g`` and ``scal``; leaves
    that require grad) stay in the graph, so the adjoint can be
    differentiated again: the tangents of ConvAcc's second order
    (kernels/conv_pass.py::ConvAccBwd)."""
    with torch.enable_grad():
        if not create_graph:
            a_gmajor, coord, shift = (x.detach().requires_grad_(True) for x in (a_gmajor, coord, shift))
            if constants:
                shifts_g, scal = (x.detach().requires_grad_(True) for x in (shifts_g, scal))
        out = conv_forward_plain(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal)
        wrt = (a_gmajor, coord, shift) + ((shifts_g, scal) if constants else ())
        return torch.autograd.grad(out, wrt, gbar, create_graph=create_graph)


def pair_counts_plain(st: ConvStatic, coord, mask, shift, nbr, scal):
    """The real pairs within rc of each receiver row over the stencil,
    (B*C,) int64: what the kernels' ``pair_counts`` diagnostic reads."""
    rc = scal[1]
    nn = nbr.clamp(min=0).long()
    real = mask > 0.5
    total = torch.zeros((st.b_tot, st.c), dtype=torch.int64, device=coord.device)
    for s in range(st.s_tot):
        cj = coord[nn[s]] + shift[s][:, None, :]
        d = torch.sqrt(((cj[:, None, :, :] - coord[:, :, None, :]) ** 2).sum(-1))
        ok = real[:, :, None] & real[nn[s]][:, None, :] & (nbr[s] >= 0)[:, None, None] & (d < rc)
        if s == 0:
            ok &= ~torch.eye(st.c, dtype=torch.bool, device=coord.device)[None]
        total += ok.sum(-1)
    return total.reshape(-1)


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(st: ConvStatic, **tensors) -> None:
    """Refuse what the kernels do not take: wrong device, dtype, shape or a
    non-contiguous layout."""
    shapes = {
        "a_gmajor": (st.b_tot, st.c, st.g * st.f),
        "coord": (st.b_tot, st.c, 3),
        "mask": (st.b_tot, st.c),
        "shift": (st.s_tot, st.b_tot, 3),
        "nbr": (st.s_tot, st.b_tot),
        "mnbr": (st.s_tot, st.b_tot),
        "shifts_g": (st.g,),
        "scal": (2,),
        "gbar": (st.b_tot, 4, st.c, st.g * st.f),
    }
    for name, t in tensors.items():
        want = torch.int32 if name in ("nbr", "mnbr") else torch.float32
        if t.device.type != "cuda" or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous {want} CUDA tensor")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shapes[name]}")


def col_tiles(st: ConvStatic) -> tuple[int, int, int]:
    """``(T, W, M)``: kernels A and B cut the G*F row into T column tiles
    of W columns (the last may be narrower), each lane owning M of a tile's
    columns (c = col0 + lane + 32 m, the smallest build that holds W).  A
    row that one build holds is one tile of W = G*F, the single model's
    launch; a wider one takes the fewest tiles of at most 32 x 17 columns,
    of equal width (a fused ensemble's 1,088 columns: two of 544; the NSE
    model's 1,152: three of 384)."""
    gf = st.g * st.f
    need = -(-gf // 32)
    tiles = -(-need // LANE_COLUMNS[-1])
    if tiles > MAX_COL_TILES:
        raise ValueError(f"conv kernels A and B take G*F <= {MAX_COL_TILES * 32 * LANE_COLUMNS[-1]}, not {gf}")
    lanes = -(-need // tiles)
    m = next(m for m in LANE_COLUMNS if lanes <= m)
    return tiles, (gf if tiles == 1 else 32 * lanes), m


def lane_columns(st: ConvStatic) -> int:
    """Columns of a tile each lane of kernels A and B owns (``col_tiles``)."""
    return col_tiles(st)[2]


def fwd_blocks(st: ConvStatic) -> int:
    """Kernel A's blocks: one warp per receiver slot row, WARPS rows a block."""
    return -(-st.b_tot * st.c // WARPS)


def bwd_tiles(st: ConvStatic) -> int:
    """Kernel B's atom tiles a bin: one block per (bin, tile of WARPS atoms)."""
    return -(-st.c // WARPS)


def bwd_scratch_bytes(st: ConvStatic) -> int:
    """Kernel B's device scratch: the partner rows (T, S, B, tiles of
    WARPS atoms, 3, C) and receiver rows (T, B, C, 3) of its T column tiles."""
    tiles = col_tiles(st)[0]
    return 4 * tiles * (st.s_tot * st.b_tot * bwd_tiles(st) * 3 * st.c + st.b_tot * st.c * 3)


def bwd_smem_bytes(st: ConvStatic, constants: bool = False) -> int:
    """Shared memory of one kernel-B block: two buffers of one partner row
    (3 x C) per warp; the constants' build reuses them for its per-warp
    column sums (G*F + 2 a warp) where those are larger
    (csrc/conv_bwd.cu::launch)."""
    rows = 4 * 2 * WARPS * 3 * st.c
    return max(rows, 4 * WARPS * (st.g * st.f + 2)) if constants else rows


def _counts_arg(st: ConvStatic, pair_counts):
    """The optional per-row pair-count output of a kernel, as a pointer."""
    if pair_counts is None:
        return ctypes.c_void_p(0)
    if pair_counts.dtype != torch.int32 or tuple(pair_counts.shape) != (st.b_tot * st.c,) \
            or pair_counts.device.type != "cuda" or not pair_counts.is_contiguous():
        raise ValueError(f"pair_counts: the kernel takes a contiguous int32 CUDA tensor of "
                         f"shape ({st.b_tot * st.c},)")
    return _ptr(pair_counts)


def conv_stencil_forward(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, shifts_g, scal,
                         pair_counts=None):
    """Kernel A: the stencil ConvSV contraction, (B, 4, C, G*F).  Arguments
    as :func:`conv_forward_plain`; ``nbr`` is int32 on the card.

    ``pair_counts``, a (B*C,) int32 CUDA tensor, receives the pairs each
    receiver row contracted (a diagnostic; the plain version has none).
    """
    if a_gmajor.device.type == "cpu":
        if pair_counts is not None:
            raise ValueError("pair_counts: only the kernel counts its pairs")
        return conv_forward_plain(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal)
    _check(st, a_gmajor=a_gmajor, coord=coord, mask=mask, shift=shift, nbr=nbr,
           shifts_g=shifts_g, scal=scal)
    _tiles, width, cols = col_tiles(st)
    counts = _counts_arg(st, pair_counts)
    out = torch.empty((st.b_tot, 4, st.c, st.g * st.f), dtype=torch.float32, device=a_gmajor.device)
    launch = _bind("conv_fwd", "conv_fwd_launch", 9, 7)
    err = launch(
        _ptr(coord), _ptr(mask), _ptr(a_gmajor), _ptr(nbr), _ptr(shift), _ptr(shifts_g),
        _ptr(scal), _ptr(out), counts, st.b_tot, st.c, st.g, st.f, st.s_tot, cols, width,
        ctypes.c_void_p(torch.cuda.current_stream(a_gmajor.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"conv kernel A launch failed: cudaError {err}")
    conv_stencil_forward.launches += 1
    return out


conv_stencil_forward.launches = 0


def gather_partner_adjoints(st: ConvStatic, nbr, dc_recv, pgrad):
    """Turn kernel B's receiver-side coordinate adjoint and its partner-side
    row sums into the full coordinate adjoint and the lattice-shift adjoint.

    ``pgrad[s, j, k, i]`` is the k-th coordinate adjoint of atom i of the
    bin whose forward step s had bin j as its candidate.  On a grid that is
    the bin ``p`` with ``nbr[s, p] == j``, so one static gather through
    ``nbr`` (no scatter) brings it home: ``dc = dc_recv + sum_s taken`` and
    ``ds[s, p] = -sum_i taken[s, p, :, i]`` (the pair displacement is
    x_j + shift - x_i).  Gas-phase steps without a candidate (nbr = -1)
    take nothing.
    """
    s_idx = torch.arange(st.s_tot, device=pgrad.device)[:, None]
    valid = (nbr >= 0).to(pgrad.dtype)[:, :, None, None]
    taken = pgrad[s_idx, nbr.clamp(min=0).long()] * valid  # (S, B, 3, C)
    dc = dc_recv + taken.sum(0).transpose(1, 2)
    ds = -taken.sum(-1)
    return dc, ds


def _launch_backward(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar,
                     pair_counts, constants: bool):
    """Kernel B's launch (``constants``: its constants' build) and the
    fixed-order sums after it; the caller counts the launch."""
    _check(st, a_gmajor=a_gmajor, coord=coord, mask=mask, shift=shift, nbr=nbr, mnbr=mnbr,
           shifts_g=shifts_g, scal=scal, gbar=gbar)
    tiles, width, cols = col_tiles(st)
    if constants and tiles > 1:
        raise ValueError(f"the AEV constants' adjoint takes one column tile (G*F <= "
                         f"{32 * LANE_COLUMNS[-1]}), not G*F = {st.g * st.f}")
    counts = _counts_arg(st, pair_counts)
    if bwd_smem_bytes(st, constants) > SMEM_LIMIT:
        raise ValueError(f"conv kernel B does not take C={st.c}")
    dev = a_gmajor.device
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    grad_a = torch.empty((st.b_tot, st.c, st.g * st.f), dtype=torch.float32, device=dev)
    dc_recv = torch.empty((tiles, st.b_tot, st.c, 3), dtype=torch.float32, device=dev)
    pgrad = torch.empty((tiles, st.s_tot, st.b_tot, bwd_tiles(st), 3, st.c), dtype=torch.float32, device=dev)
    args = [_ptr(coord), _ptr(mask), _ptr(a_gmajor), _ptr(gbar), _ptr(mnbr), _ptr(shift),
            _ptr(shifts_g), _ptr(scal), _ptr(grad_a), _ptr(dc_recv), _ptr(pgrad), counts]
    cbar = None
    if constants:
        cbar = torch.empty((st.b_tot, bwd_tiles(st), st.g + 2), dtype=torch.float32, device=dev)
        err = _bind("conv_bwd", "conv_bwd_const_launch", 13, 7)(
            *args, _ptr(cbar), st.b_tot, st.c, st.g, st.f, st.s_tot, cols, width, stream)
    else:
        err = _bind("conv_bwd", "conv_bwd_launch", 12, 7)(
            *args, st.b_tot, st.c, st.g, st.f, st.s_tot, cols, width, stream)
    if err != 0:
        raise RuntimeError(f"conv kernel B launch failed: cudaError {err}")
    # the column tiles' partials, then the atom tiles' partial row sums,
    # each added in a fixed order
    if tiles > 1:
        dc_recv, pgrad = dc_recv.sum(0), pgrad.sum(0)
    else:
        dc_recv, pgrad = dc_recv[0], pgrad[0]
    dc, ds = gather_partner_adjoints(st, nbr, dc_recv, pgrad.sum(2))
    if not constants:
        return grad_a, dc, ds
    cb = cbar.reshape(-1, st.g + 2).sum(0)  # the blocks' partial sums
    return grad_a, dc, ds, cb[: st.g], cb[st.g :]


def conv_stencil_backward(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar,
                          pair_counts=None):
    """Kernel B: ``(grad_a (B, C, G*F), grad_coord (B, C, 3), grad_shift
    (S, B, 3))`` for the output cotangent ``gbar`` (B, 4, C, G*F).

    ``mnbr`` (S, B) is the receiver-centric mirror of ``nbr``
    (ops/binned.py::mirror_stencil_tables), -1 where a step has no partner.
    ``pair_counts`` as in :func:`conv_stencil_forward`, per receiver atom j.
    """
    if a_gmajor.device.type == "cpu":
        if pair_counts is not None:
            raise ValueError("pair_counts: only the kernel counts its pairs")
        return conv_backward_plain(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, gbar)
    out = _launch_backward(st, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar, pair_counts,
                           constants=False)
    conv_stencil_backward.launches += 1
    return out


conv_stencil_backward.launches = 0


def conv_stencil_backward_constants(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal,
                                    gbar, pair_counts=None):
    """Kernel B's constants' build: :func:`conv_stencil_backward`'s three
    adjoints and those of the AEV constants, ``grad_shifts_g (G,)`` and
    ``grad_scal (2,)`` = (eta, rc).  Each block writes its G + 2 partial
    sums and they are added here in a fixed order (no float atomics).  One
    column tile only (G*F <= 544, a single model's widths): a wider row
    raises ``ValueError``."""
    if a_gmajor.device.type == "cpu":
        if pair_counts is not None:
            raise ValueError("pair_counts: only the kernel counts its pairs")
        return conv_backward_plain(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, gbar, constants=True)
    out = _launch_backward(st, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar, pair_counts,
                           constants=True)
    conv_stencil_backward_constants.launches += 1
    return out


conv_stencil_backward_constants.launches = 0
