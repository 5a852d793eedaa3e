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

Both kernels are FP32 on CUDA cores (the exact tier has no TF32) with no
float atomics: every output element is owned by one block, so results are
deterministic.  What bounds them on an H100 and what the design does about
it is in the notes at the top of each source.

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

from aimnetcentral_tpu_torch.kernels.build import LIBRARIES

THREADS = 256
MAX_OUT_PER_THREAD = 8  # kernel A keeps TI*F <= 8*256 (i, f) sums in registers
MAX_PAIRS_PER_THREAD = 8  # kernel B keeps TI*TJ <= 8*256 pairs' geometry in registers
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


def conv_backward_plain(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, gbar):
    """Plain version of kernel B: the VJP of :func:`conv_forward_plain`
    through torch.autograd, in B's output frame ``(grad_a (B, C, G*F),
    grad_coord (B, C, 3), grad_shift (S, B, 3))``."""
    with torch.enable_grad():
        a_ = a_gmajor.detach().requires_grad_(True)
        c_ = coord.detach().requires_grad_(True)
        s_ = shift.detach().requires_grad_(True)
        out = conv_forward_plain(st, a_, c_, mask, s_, nbr, shifts_g, scal)
        return torch.autograd.grad(out, (a_, c_, s_), gbar)


# ---------------------------------------------------------------------------
# kernel wrappers


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _bind(name: str, symbol: str, n_ptr: int, n_int: int):
    fn = getattr(LIBRARIES.get(name), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def fwd_smem_bytes(st: ConvStatic, ti: int) -> int:
    """Shared memory of one kernel-A block (csrc/conv_fwd.cu::smem_bytes)."""
    return 4 * (4 * ti + 4 * st.c + st.c * st.f + 4 * ti * st.c)


def bwd_smem_bytes(st: ConvStatic, tj: int, ti: int) -> int:
    """Shared memory of one kernel-B block (csrc/conv_bwd.cu::smem_bytes)."""
    fp = st.f | 1
    return 4 * (4 * tj + 4 * ti + 4 * ti * fp + tj * fp + 4 * ti * (tj + 1) + tj * st.g * st.f)


def _balanced(c: int, most: int) -> int:
    """The tile size that splits c rows into the fewest tiles of at most
    ``most`` rows, as evenly as possible."""
    n = -(-c // max(1, most))
    return -(-c // n)


def fwd_tile(st: ConvStatic) -> int:
    """Kernel A's receiver rows per block: its (i, f) outputs fit the
    threads' registers and its pair weights fit shared memory."""
    ti = _balanced(st.c, MAX_OUT_PER_THREAD * THREADS // st.f)
    while ti > 1 and fwd_smem_bytes(st, ti) > SMEM_LIMIT:
        ti = _balanced(st.c, ti - 1)
    if st.f > MAX_OUT_PER_THREAD * THREADS or fwd_smem_bytes(st, ti) > SMEM_LIMIT:
        raise ValueError(f"conv kernel A does not take C={st.c}, F={st.f}")
    return ti


def bwd_tiles(st: ConvStatic) -> tuple[int, int]:
    """Kernel B's (TJ receiver atoms per block, TI partner rows per step):
    at most 64 resident atoms and 8 pairs per thread."""
    tj = _balanced(st.c, 64)
    ti = _balanced(st.c, MAX_PAIRS_PER_THREAD * THREADS // tj)
    if bwd_smem_bytes(st, tj, ti) > SMEM_LIMIT:
        raise ValueError(f"conv kernel B does not take C={st.c}, F={st.f}, G={st.g}")
    return tj, ti


def conv_stencil_forward(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, shifts_g, scal):
    """Kernel A: the stencil ConvSV contraction, (B, 4, C, G*F).  Arguments
    as :func:`conv_forward_plain`; ``nbr`` is int32 on the card."""
    if a_gmajor.device.type == "cpu":
        return conv_forward_plain(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal)
    _check(st, a_gmajor=a_gmajor, coord=coord, mask=mask, shift=shift, nbr=nbr,
           shifts_g=shifts_g, scal=scal)
    ti = fwd_tile(st)
    out = torch.empty((st.b_tot, 4, st.c, st.g * st.f), dtype=torch.float32, device=a_gmajor.device)
    launch = _bind("conv_fwd", "conv_fwd_launch", 8, 6)
    err = launch(
        _ptr(coord), _ptr(mask), _ptr(a_gmajor), _ptr(nbr), _ptr(shift), _ptr(shifts_g),
        _ptr(scal), _ptr(out), st.b_tot, st.c, st.g, st.f, st.s_tot, ti,
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


def conv_stencil_backward(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar):
    """Kernel B: ``(grad_a (B, C, G*F), grad_coord (B, C, 3), grad_shift
    (S, B, 3))`` for the output cotangent ``gbar`` (B, 4, C, G*F).

    ``mnbr`` (S, B) is the receiver-centric mirror of ``nbr``
    (ops/binned.py::mirror_stencil_tables), -1 where a step has no partner.
    """
    if a_gmajor.device.type == "cpu":
        return conv_backward_plain(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, gbar)
    _check(st, a_gmajor=a_gmajor, coord=coord, mask=mask, shift=shift, nbr=nbr, mnbr=mnbr,
           shifts_g=shifts_g, scal=scal, gbar=gbar)
    tj, ti = bwd_tiles(st)
    n_tiles = -(-st.c // tj)
    dev = a_gmajor.device
    grad_a = torch.empty((st.b_tot, st.c, st.g * st.f), dtype=torch.float32, device=dev)
    dc_recv = torch.empty((st.b_tot, st.c, 3), dtype=torch.float32, device=dev)
    pgrad = torch.empty((st.s_tot, st.b_tot, n_tiles, 3, st.c), dtype=torch.float32, device=dev)
    launch = _bind("conv_bwd", "conv_bwd_launch", 11, 7)
    err = launch(
        _ptr(coord), _ptr(mask), _ptr(a_gmajor), _ptr(gbar), _ptr(mnbr), _ptr(shift),
        _ptr(shifts_g), _ptr(scal), _ptr(grad_a), _ptr(dc_recv), _ptr(pgrad),
        st.b_tot, st.c, st.g, st.f, st.s_tot, tj, ti,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"conv kernel B launch failed: cudaError {err}")
    conv_stencil_backward.launches += 1
    # the atom tiles' partial row sums, added in a fixed order
    dc, ds = gather_partner_adjoints(st, nbr, dc_recv, pgrad.sum(2))
    return grad_a, dc, ds


conv_stencil_backward.launches = 0
