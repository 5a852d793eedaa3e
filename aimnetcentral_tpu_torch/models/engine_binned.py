"""Binned pair sums: counterpart of aimnetcentral_tpu/models/engine_binned.py.

``pair_energy_binned`` is the half-stencil sweep of a symmetric pair term
(each unordered pair computed once, its value sent to both ends), here on
the coarse long-range twin layout for DSF Coulomb.  It is plain torch: no
kernel of the JAX package's default path reaches it (its Pallas pair sweep
is opt-in there, and is still to be ported).  The ConvSV message pass lives
in kernels/conv_pass.py.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from aimnetcentral_tpu_torch.models.lr import FACTOR
from aimnetcentral_tpu_torch.ops import binned as B
from aimnetcentral_tpu_torch.ops.binned import stencil_radius
from aimnetcentral_tpu_torch.ops.math import cellmul, erfc_approx
from aimnetcentral_tpu_torch.ops.nb import mol_sum
from aimnetcentral_tpu_torch.system import System


def _pair_geometry(self_blocks, cand_blocks, shift_cart, valid, not_self):
    """Per-offset block geometry: ``(diff (B, Ci, Cc, 3), d (B, Ci, Cc),
    valid_pair)``.  Non-pairs get d2 := 1 before the sqrt so that 1/d and
    its gradient stay finite."""
    ci = self_blocks["coord"]
    cj = cand_blocks["coord"] + shift_cart
    diff = cj[:, None, :, :] - ci[:, :, None, :]
    real_i = (self_blocks["numbers"] > 0)[:, :, None]
    real_j = (cand_blocks["numbers"] > 0)[:, None, :]
    valid_pair = valid & real_i & real_j & not_self
    d2 = (diff * diff).sum(-1)
    d = torch.sqrt(torch.where(valid_pair, d2, torch.ones_like(d2)))
    return diff, d, valid_pair


@functools.lru_cache(maxsize=16)
def _half_tables(grid: B.BinGrid, radius: int):
    """Host tables of the half stencil: the zero offset plus every offset
    lexicographically above it.  ``inv[s]`` inverts ``nbr[s]`` (sentinel B
    for bins no step-s source points at), so the mirror sums arrive by a
    gather instead of a scatter-add (``index_add_`` is a float atomic on
    CUDA, and not deterministic)."""
    nbr, wraps, is_zero = B.stencil_tables(grid, radius)
    offs = B.stencil_offsets(radius)
    half = np.array([bool(z) or tuple(o) > (0, 0, 0) for o, z in zip(offs, is_zero)])
    nbr, wraps, is_zero = nbr[half], wraps[half], is_zero[half]
    b_tot = grid.total_bins
    inv = np.full(nbr.shape, b_tot, np.int64)
    for s in range(nbr.shape[0]):
        ok = nbr[s] >= 0
        inv[s, nbr[s][ok]] = np.arange(b_tot)[ok]
    return nbr, wraps, is_zero, inv


def pair_energy_binned(
    system: System,
    cutoff: float,
    e_pair_fn: Callable,
    extra_blocks: dict[str, torch.Tensor] | None = None,
    layout: str = "sr",
) -> torch.Tensor:
    """Sum a SYMMETRIC pair term over all pairs within ``cutoff``: per-atom
    (ordered-pair convention) sums (L,) in the SR slot layout.

    ``e_pair_fn(d, valid_pair, self_b, cand_b)`` gives the (B, Ci, Cc) pair
    values.  ``layout="lr"`` sweeps the coarse twin layout when attached.
    Each step is checkpointed, so the backward recomputes one step's pair
    tensors at a time instead of holding all of them.
    """
    grid = system.bins
    lr_slot = None
    if layout == "lr" and system.lr_bins is not None:
        grid = system.lr_bins
        lr_slot = system.lr_slot
    cell0 = system.cell[0] if system.cell is not None else None
    radius = stencil_radius(cutoff, grid)
    dev = system.device

    blocks = {"coord": system.coord, "numbers": system.numbers, **(extra_blocks or {})}
    if lr_slot is not None:
        blocks = {k: v[lr_slot] for k, v in blocks.items()}
    b_tot, c = grid.total_bins, grid.capacity
    keys = list(blocks)
    self_list = [blocks[k].reshape((b_tot, c) + blocks[k].shape[1:]) for k in keys]

    nbr_np, wrap_np, zero_np, inv_np = _half_tables(grid, radius)
    nbr = torch.as_tensor(nbr_np, dtype=torch.int64, device=dev)
    wraps = torch.as_tensor(wrap_np, device=dev)
    inv = torch.as_tensor(inv_np, device=dev)
    diag = torch.eye(c, dtype=torch.bool, device=dev)[None]
    dtype = system.coord.dtype

    def step(s: int, *tensors):
        self_b = dict(zip(keys, tensors[: len(keys)]))
        cell = tensors[len(keys)] if cell0 is not None else None
        nbr_s = nbr[s]
        safe = nbr_s.clamp(min=0)
        cand = {k: v[safe] for k, v in self_b.items()}
        if grid.periodic:
            shift_cart = cellmul(wraps[s], cell)[:, None, :]
            valid = torch.ones((b_tot, 1, 1), dtype=torch.bool, device=dev)
        else:
            shift_cart = torch.zeros((b_tot, 1, 3), dtype=dtype, device=dev)
            valid = (nbr_s >= 0)[:, None, None]
        not_self = ~(diag & bool(zero_np[s]))
        _diff, d, valid_pair = _pair_geometry(self_b, cand, shift_cart, valid, not_self)
        valid_pair = valid_pair & (d < cutoff)
        e = torch.where(valid_pair, e_pair_fn(d, valid_pair, self_b, cand), 0.0)
        out = e.sum(-1)  # self side (B, C)
        if not zero_np[s]:
            # mirror side, back to the candidate bin (the zero offset's
            # within-bin enumeration already covers both sides)
            mirror = torch.cat([e.sum(-2), torch.zeros((1, c), dtype=dtype, device=dev)])
            out = out + mirror[inv[s]]
        return out

    args = self_list + ([cell0] if cell0 is not None else [])
    acc = torch.zeros((b_tot, c), dtype=dtype, device=dev)
    for s in range(nbr.shape[0]):
        acc = acc + checkpoint(step, s, *args, use_reentrant=False)
    acc = acc.reshape(-1)
    if lr_slot is not None:
        # back to SR slot order through the inverse map: a gather
        acc = torch.cat([acc, acc.new_zeros(1)])[system.lr_inv]
    return acc


def coulomb_dsf_binned(
    system: System,
    q: torch.Tensor,
    rc: float,
    dsf_alpha: float,
    dsf_rc: float,
    envelope: str,
    subtract_sr: bool,
) -> torch.Tensor:
    """Damped-shifted-force Coulomb on the LR twin layout, with the SR
    envelope part subtracted in the same sweep (per-molecule energies)."""
    alpha = dsf_alpha
    erfc_rc = math.erfc(alpha * dsf_rc)
    shift_val = erfc_rc / dsf_rc
    shift_slope = erfc_rc / dsf_rc**2 + (
        2.0 * alpha / math.sqrt(math.pi) * math.exp(-((alpha * dsf_rc) ** 2)) / dsf_rc
    )

    def e_fn(d, valid, self_b, cand_b):
        qq = self_b["q"][:, :, None] * cand_b["q"][:, None, :]
        e_pair = erfc_approx(alpha * d) / d - shift_val + (d - dsf_rc) * shift_slope
        if subtract_sr:
            # the SR envelope is zero beyond rc << dsf_rc: exact on this stencil
            if envelope == "exp":
                x = torch.clamp(d / rc, 0.0, 1.0 - 1e-6)
                fc = torch.exp(-1.0 / (1.0 - x * x)) / 0.36787944117144233
            else:
                fc = torch.where(
                    d < rc,
                    0.5 * (torch.cos(torch.clamp(d, 1e-6, rc) * (math.pi / rc)) + 1.0),
                    0.0,
                )
            e_pair = e_pair - fc / d
        return qq * e_pair

    e_i = pair_energy_binned(system, dsf_rc, e_fn, {"q": q}, layout="lr")
    e = FACTOR * mol_sum(e_i, system.mol_idx, system.num_mol)
    self_coeff = -(shift_val / 2.0 + alpha / math.sqrt(math.pi))
    q_real = torch.where(system.numbers > 0, q, 0.0)
    return e + 2.0 * FACTOR * mol_sum(self_coeff * q_real * q_real, system.mol_idx, system.num_mol)
