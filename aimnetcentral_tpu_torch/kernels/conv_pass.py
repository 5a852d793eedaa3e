"""One ConvSV message pass on the binned layout, through the stencil kernels.

Counterpart of aimnetcentral_tpu/kernels/conv_pallas.py: the stencil
tables (``build_conv_tables``), the ``torch.autograd.Function`` around the
two kernels of kernels/conv_stencil.py (kernel A forward, kernel B
backward), and ``conv_pass``: the g-major layout prep and the ``agh``
combine.  The TPU's block-diagonal gamma packing and banded z-row grid
exist for its 128-lane tiles and sequential grid; the port keeps the
per-offset tables and lets the kernels run one block per bin.

``resolve_conv_mode`` maps the JAX package's ``conv_precision`` to the
build of kernels A and B a pass launches (conv_stencil.CONV_MODES), and
``ConvAcc`` runs its backward in the mode its forward ran.
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch

from aimnetcentral_tpu_torch.kernels.conv_stencil import (
    ConvStatic,
    conv_backward_plain,
    conv_stencil_backward,
    conv_stencil_backward_constants,
    conv_stencil_forward,
)
from aimnetcentral_tpu_torch.ops import binned as B
from aimnetcentral_tpu_torch.ops.math import cellmul
from aimnetcentral_tpu_torch.system import System


CONV_PRECISIONS = ("f32", "f32x3", "bf16")


def resolve_conv_mode(conv_precision: str | None, device) -> str:
    """The build of kernels A and B that a conv pass on ``device`` runs for
    the JAX package's ``conv_precision`` (``None`` reads
    ``AIMNET_CONV_PRECISION``, default "f32"; conv_pallas.py:594):

    - on the card, "f32" runs "tf32" when ``torch.backends.cuda.matmul.
      allow_tf32`` is on (the ``fast`` tier's ambient; JAX's "f32" is one
      dot at the ambient precision, one bf16 MXU pass under its default)
      and "fp32" otherwise; "f32x3" runs "3xtf32"; "bf16" runs "bf16";
    - on the CPU the plain versions run in "fp32", the ambient there (as
      JAX's XLA engine on the CPU), and the variable is not read.

    Any other mode raises JAX's ``ValueError`` (conv_stencil._mxu_dtype)."""
    if torch.device(device).type != "cuda":
        return "fp32"
    prec = conv_precision if conv_precision is not None else os.environ.get("AIMNET_CONV_PRECISION", "f32")
    if prec not in CONV_PRECISIONS:
        raise ValueError(f"precision must be 'f32', 'f32x3' or 'bf16', got {prec!r}")
    if prec == "f32x3":
        return "3xtf32"
    if prec == "bf16":
        return "bf16"
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "fp32"


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


@functools.lru_cache(maxsize=16)
def device_conv_tables(grid: B.BinGrid, radius: int, device: torch.device) -> dict[str, torch.Tensor]:
    """``build_conv_tables`` uploaded to ``device`` once per (grid, radius,
    device): a force evaluation, an MD step above all, copies no table from
    the host.  A regrown or shrunk grid is another key (``BinGrid`` is
    frozen and hashable)."""
    return {k: torch.as_tensor(v, device=device) for k, v in build_conv_tables(grid, radius).items()}


class ConvAcc(torch.autograd.Function):
    """The stencil contraction with its fused adjoint (conv_pallas.conv_acc).

    Differentiable in ``a_gmajor``, ``coord`` and ``shift`` (the lattice
    shifts carry the cell and strain gradients, i.e. stress), to second
    order: the backward is ``ConvAccBwd``, kernel B on the card, whose own
    backward differentiates :func:`conv_stencil.conv_backward_plain` by
    autograd.  These are the K3 rules of the JAX package
    (``conv_pallas._conv_fwd_acc_jvp``, ``_conv_bwd_acc_jvp``) in reverse
    mode: the primal and the first adjoint stay on kernels A and B, and the
    second-order tangents (an HVP, a dense Hessian, a force loss) run the
    plain version, as JAX's run its XLA twin.  That is the reference's
    design, not a fallback: nothing catches a kernel failure, a first-order
    request never runs a plain version on the card, and a first-order
    backward (no ``create_graph``) calls kernel B alone, as before.  An HVP
    by double backward runs each conv pass's first adjoint (kernel B) in
    both of its backward passes: the second carries cotangents that depend
    on the pass's output back through the forward graph.

    Where the AEV constants ``shifts_g`` and ``scal`` = (eta, rc) require
    grad (training, which differentiates them as the JAX package's XLA
    engine does), the first adjoint is kernel B's constants' build
    (``conv_stencil_backward_constants``) and returns their adjoints too;
    inference never asks for them, and runs the build without.

    ``mode`` (``resolve_conv_mode``) is the build both kernels run: the
    forward's, saved for the backward, as JAX's mode is static in its
    ``ConvStatic``.  The second-order tangents run the plain version at
    the ambient precision, and exact at "3xtf32", as JAX's twin pins
    HIGHEST at "f32x3" (conv_pallas.py:94).
    """

    @staticmethod
    def forward(ctx, a_gmajor, coord, shift, st, mask, nbr, mnbr, shifts_g, scal, mode="fp32"):
        ctx.st, ctx.mode = st, mode
        ctx.save_for_backward(a_gmajor, coord, shift, mask, nbr, mnbr, shifts_g, scal)
        return conv_stencil_forward(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, mode=mode)

    @staticmethod
    def backward(ctx, gbar):
        a_gmajor, coord, shift, mask, nbr, mnbr, shifts_g, scal = ctx.saved_tensors
        gbar = gbar.contiguous()
        constants = ctx.needs_input_grad[7] or ctx.needs_input_grad[8]
        if torch.is_grad_enabled():  # create_graph: the adjoint must itself be differentiable
            grads = ConvAccBwd.apply(a_gmajor, coord, shift, gbar, ctx.st, mask, nbr, mnbr, shifts_g, scal,
                                     constants, ctx.mode)
        else:  # first order: kernel B alone, no node to record
            kernel = conv_stencil_backward_constants if constants else conv_stencil_backward
            grads = kernel(ctx.st, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar, mode=ctx.mode)
        consts = tuple(grads[3:]) if constants else (None, None)
        return (*grads[:3], None, None, None, None, *consts, None)


class ConvAccBwd(torch.autograd.Function):
    """ConvAcc's adjoint as a differentiable function of ``a_gmajor``,
    ``coord``, ``shift`` and the cotangent ``gbar`` (and, with
    ``constants``, of ``shifts_g`` and ``scal``, whose adjoints it then
    returns too): kernel B (or its plain version on the CPU) forward;
    backward the VJP of ``conv_backward_plain`` in all of them, the
    reverse-mode form of ``jax.jvp`` of the twin's VJP in
    ``_conv_bwd_acc_jvp`` (conv_pallas.py:378-412).  The shift's tangent is
    complete: it carries the cell and the strain."""

    @staticmethod
    def forward(ctx, a_gmajor, coord, shift, gbar, st, mask, nbr, mnbr, shifts_g, scal, constants=False,
                mode="fp32"):
        ctx.st, ctx.constants, ctx.mode = st, constants, mode
        ctx.save_for_backward(a_gmajor, coord, shift, gbar, mask, nbr, shifts_g, scal)
        kernel = conv_stencil_backward_constants if constants else conv_stencil_backward
        return kernel(st, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar, mode=mode)

    @staticmethod
    def backward(ctx, *tangents):
        a_gmajor, coord, shift, gbar, mask, nbr, shifts_g, scal = ctx.saved_tensors
        with_consts = ctx.needs_input_grad[8] or ctx.needs_input_grad[9]
        # calculators import this module: the tier context comes in late
        from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context

        exact = ambient_matmul_context("highest") if ctx.mode == "3xtf32" else contextlib.nullcontext()
        with torch.enable_grad(), exact:
            leaves = [x.detach().requires_grad_(True) for x in (a_gmajor, coord, shift, gbar)]
            sg, sc = shifts_g, scal
            if with_consts:
                sg, sc = (x.detach().requires_grad_(True) for x in (shifts_g, scal))
            adj = conv_backward_plain(ctx.st, leaves[0], leaves[1], mask, leaves[2], nbr, sg, sc, leaves[3],
                                      create_graph=True, constants=ctx.constants)
            wrt = leaves + ([sg, sc] if with_consts else [])
            grads = torch.autograd.grad(adj, wrt, tangents, allow_unused=True)
        consts = tuple(grads[4:]) if with_consts else (None, None)
        return (*grads[:4], None, None, None, None, *consts, None, None)


def conv_pass(
    system: System,
    aev: dict[str, torch.Tensor],
    a: torch.Tensor,  # (L, F, G), or (L, F) for a model without d2features
    q: torch.Tensor | None,  # (L, Cq) charges, None on pass 0
    agh_a: torch.Tensor,
    agh_q: torch.Tensor | None,
    rc_static: float,
    conv_precision: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """ConvSV(a) [and ConvSV(q)] for one message pass (conv_pallas.
    conv_pass_pallas): the charge channels ride in each g block of the
    features, so one contraction serves both.  Features without a G axis
    (no ``d2features``) are broadcast along it, as the charges are: the
    contraction is then JAX's ``einsum("nmc,nmgd->ncgd")``, and autograd
    of the broadcast sums the adjoint over G.  ``conv_precision``: JAX's
    mode, resolved by :func:`resolve_conv_mode`."""
    grid = system.bins
    dev = system.device
    cell0 = system.cell[0] if system.cell is not None else None
    radius = B.stencil_radius(rc_static, grid)
    tables = device_conv_tables(grid, radius, dev)
    b_tot, c = grid.total_bins, grid.capacity
    g_dim = aev["shifts_s"].shape[0]
    if a.dim() == 2:
        a = a[:, :, None].expand(a.shape[0], a.shape[1], g_dim)
    lshape, f_dim, _g = a.shape
    cq = q.shape[1] if q is not None else 0
    f_tot = f_dim + cq
    st = ConvStatic(b_tot=b_tot, c=c, g=g_dim, f=f_tot, s_tot=tables["nbr"].shape[0])

    shift = tables["push"]
    if cell0 is not None:
        shift = shift + cellmul(tables["wraps"], cell0)
    nbr, mnbr = tables["nbr"], tables["mnbr"]

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
        shifts_g, scal, resolve_conv_mode(conv_precision, dev),
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
