"""One ConvSV message pass on the binned layout, through the stencil kernels.

Counterpart of aimnetcentral_tpu/kernels/conv_pallas.py: the stencil
tables (``build_conv_tables``), the ``torch.autograd.Function`` around the
two kernels of kernels/conv_stencil.py (kernel A forward, kernel B
backward), and ``conv_pass``: the g-major layout prep and the ``agh``
combine.  The TPU's block-diagonal gamma packing and banded z-row grid
exist for its 128-lane tiles and sequential grid; the port keeps the
per-offset tables and lets the kernels run one block per bin.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from aimnetcentral_tpu_torch.kernels.conv_stencil import (
    ConvStatic,
    conv_stencil_backward,
    conv_stencil_forward,
)
from aimnetcentral_tpu_torch.ops import binned as B
from aimnetcentral_tpu_torch.ops.math import cellmul
from aimnetcentral_tpu_torch.system import System


@functools.lru_cache(maxsize=16)
def build_conv_tables(grid: B.BinGrid, radius: int) -> dict[str, np.ndarray]:
    """Host tables for the stencil conv: ``nbr``/``mnbr`` (S, B) int32
    (forward candidate and receiver-centric partner bins, -1 off a gas-phase
    grid), ``wraps`` (S, B, 3) lattice wraps and ``push`` (S, B, 3): +1e6 on
    steps without a candidate, which moves them out of range."""
    nbr, wraps, _zero = B.stencil_tables(grid, radius)
    mnbr, _mwrap = B.mirror_stencil_tables(grid, radius)
    push = np.repeat((nbr < 0)[..., None], 3, axis=-1).astype(np.float32) * 1e6
    return {"nbr": nbr, "mnbr": mnbr, "wraps": wraps, "push": push}


class ConvAcc(torch.autograd.Function):
    """The stencil contraction with its fused adjoint (conv_pallas.conv_acc).

    Differentiable in ``a_gmajor``, ``coord`` and ``shift`` (the lattice
    shifts carry the cell and strain gradients, i.e. stress).  The backward
    is first order only: a second-order call (HVP, Hessian, force loss)
    raises instead of giving a wrong answer until the K3 rules are ported.
    """

    @staticmethod
    def forward(ctx, a_gmajor, coord, shift, st, mask, nbr, mnbr, shifts_g, scal):
        ctx.st = st
        ctx.save_for_backward(a_gmajor, coord, shift, mask, nbr, mnbr, shifts_g, scal)
        return conv_stencil_forward(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        a_gmajor, coord, shift, mask, nbr, mnbr, shifts_g, scal = ctx.saved_tensors
        grad_a, grad_coord, grad_shift = conv_stencil_backward(
            ctx.st, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar.contiguous()
        )
        return grad_a, grad_coord, grad_shift, None, None, None, None, None, None


def conv_pass(
    system: System,
    aev: dict[str, torch.Tensor],
    a: torch.Tensor,  # (L, F, G)
    q: torch.Tensor | None,  # (L, Cq) charges, None on pass 0
    agh_a: torch.Tensor,
    agh_q: torch.Tensor | None,
    rc_static: float,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """ConvSV(a) [and ConvSV(q)] for one message pass (conv_pallas.
    conv_pass_pallas): the charge channels ride in each g block of the
    features, so one contraction serves both."""
    grid = system.bins
    dev = system.device
    cell0 = system.cell[0] if system.cell is not None else None
    radius = B.stencil_radius(rc_static, grid)
    tables = build_conv_tables(grid, radius)
    b_tot, c = grid.total_bins, grid.capacity
    lshape, f_dim, g_dim = a.shape
    cq = q.shape[1] if q is not None else 0
    f_tot = f_dim + cq
    st = ConvStatic(b_tot=b_tot, c=c, g=g_dim, f=f_tot, s_tot=tables["nbr"].shape[0])

    wraps = torch.as_tensor(tables["wraps"], device=dev)
    shift = torch.as_tensor(tables["push"], device=dev)
    if cell0 is not None:
        shift = shift + cellmul(wraps, cell0)
    nbr = torch.as_tensor(tables["nbr"], device=dev)
    mnbr = torch.as_tensor(tables["mnbr"], device=dev)

    coord = system.coord.reshape(b_tot, c, 3)
    mask = (system.numbers > 0).to(a.dtype).reshape(b_tot, c)
    a_gm = a.transpose(1, 2)  # (L, G, F)
    if q is not None:
        a_gm = torch.cat([a_gm, q[:, None, :].expand(lshape, g_dim, cq)], dim=-1)
    a_gmajor = a_gm.reshape(b_tot, c, g_dim * f_tot)
    scal = torch.stack([aev["eta_s"], aev["rc_s"]]).to(a.dtype)
    shifts_g = aev["shifts_s"].contiguous()

    acc = ConvAcc.apply(
        a_gmajor.contiguous(), coord.contiguous(), shift.contiguous(), st, mask, nbr, mnbr,
        shifts_g, scal,
    )
    acc = acc.reshape(b_tot, 4, c, g_dim, f_tot)

    def combine(lo: int, hi: int, agh: torch.Tensor) -> torch.Tensor:
        nch = hi - lo
        avf = acc[..., lo:hi]  # (B, 4, C, G, nch)
        avf_s = avf[:, 0].reshape(lshape, g_dim, nch).transpose(1, 2)  # (L, nch, G)
        avf_v = avf[:, 1:4].movedim(1, -1).reshape(lshape, g_dim, nch, 3).transpose(1, 2)
        comb = torch.einsum("fgh,lfgd->lfhd", agh, avf_v)
        vv = (comb * comb).sum(-1)
        return torch.cat([avf_s.reshape(lshape, -1), vv.reshape(lshape, -1)], dim=-1)

    out_a = combine(0, f_dim, agh_a)
    out_q = combine(f_dim, f_tot, agh_q) if q is not None else None
    return out_a, out_q
