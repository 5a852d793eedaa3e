"""Geometry and physics math (counterpart of aimnetcentral_tpu/ops/math.py)."""

from __future__ import annotations

import math

import torch

from aimnetcentral_tpu_torch.ops.nb import expand_mol, gather_nb, mol_sum, pair_mask


def cellmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact-f32 geometry contraction ``a @ b`` (wraps @ cell, coord @
    inv_cell, strain): ``a`` (..., k) or (..., n, k) against ``b`` (k, m) or
    (..., k, m).  Written as k multiply-adds per output, not as a matmul,
    so it stays exact f32 whatever the TF32 flag of the ``fast`` tier: a
    TF32 product would keep about three decimal digits and displace
    periodic images."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def calc_distances(
    coord: torch.Tensor,
    nbmat: torch.Tensor,
    shifts: torch.Tensor | None = None,
    cell: torch.Tensor | None = None,
    mol_idx: torch.Tensor | None = None,
    pad_value: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Displacements and distances to the neighbors of the indexed layout:
    ``(d_ij (N, M), r_ij (N, M, 3))`` with ``r_ij = coord[j] + shift @ cell
    - coord[i]``.  Fill pairs get ``pad_value`` in every component BEFORE
    the norm (so their d_ij is sqrt(3) * pad_value), which keeps gradients
    free of NaN without a ``where`` around a square root.  ``shifts`` are
    integer lattice image counts against the per-molecule ``cell``
    (num_mol, 3, 3), row vectors; padding atoms read the identity."""
    coord_j = gather_nb(coord, nbmat)  # (N, M, 3)
    if shifts is not None:
        if cell is None or mol_idx is None:
            raise ValueError("cell and mol_idx are required with shifts")
        cell_ext = torch.cat([cell, torch.eye(3, dtype=cell.dtype, device=cell.device)[None]], dim=0)
        atom_cell = cell_ext[mol_idx]  # (N, 3, 3)
        coord_j = coord_j + cellmul(shifts.to(coord.dtype), atom_cell)  # exact f32 at every tier
    r_ij = coord_j - coord[:, None, :]
    r_ij = torch.where(pair_mask(nbmat)[..., None], r_ij, torch.full_like(r_ij, pad_value))
    d_ij = torch.linalg.vector_norm(r_ij, dim=-1)
    return d_ij, r_ij


def cosine_cutoff(d_ij: torch.Tensor, rc) -> torch.Tensor:
    """0.5*(cos(pi*d/rc)+1) with d clamped to [1e-6, rc]."""
    rc = torch.as_tensor(rc, dtype=d_ij.dtype, device=d_ij.device)
    d = torch.minimum(torch.clamp(d_ij, min=1e-6), rc)
    return 0.5 * (torch.cos(d * (math.pi / rc)) + 1.0)


def exp_cutoff(d: torch.Tensor, rc) -> torch.Tensor:
    """Mollifier cutoff exp(-1/(1-(d/rc)^2))/e^-1."""
    rc = torch.as_tensor(rc, dtype=d.dtype, device=d.device)
    x = torch.clamp(d / rc, 0.0, 1.0 - 1e-6)
    return torch.exp(-1.0 / (1.0 - x * x)) / 0.36787944117144233


def exp_expand(d_ij: torch.Tensor, shifts: torch.Tensor, eta) -> torch.Tensor:
    """Gaussian radial basis: (..., m) -> (..., m, nshifts)."""
    diff = d_ij[..., None] - shifts
    return torch.exp(-eta * diff * diff)


def nse(
    Q: torch.Tensor,
    q_u: torch.Tensor,
    f_u: torch.Tensor,
    mol_idx: torch.Tensor,
    num_mol: int,
    epsilon: float = 1.0e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Charge equilibration with exact total-charge constraint:
    ``q = q_u + (f_u / sum_mol f_u) * (Q - sum_mol q_u)`` per channel.
    Returns ``(q, dQ)``.  Shapes: Q (num_mol, C), q_u/f_u (N, C)."""
    F_u = mol_sum(f_u, mol_idx, num_mol) + epsilon
    Q_u = mol_sum(q_u, mol_idx, num_mol)
    dQ = Q - Q_u
    f = f_u / expand_mol(F_u, mol_idx).clamp(min=epsilon * 0.5)
    q = q_u + f * expand_mol(dQ, mol_idx)
    return q, dQ


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """The Huber loss: 0.5 x^2 inside |x| < delta, linear beyond."""
    ax = torch.abs(x)
    return torch.where(ax < delta, 0.5 * x * x, delta * (ax - 0.5 * delta))


def bumpfn(x: torch.Tensor, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """Smooth 0 -> 1 transition over [low, high] (reference aimnet/ops.py:280-287)."""
    x = torch.clamp((x - low) / (high - low), 1e-6, 1 - 1e-6)
    a = torch.exp(-1.0 / x)
    b = torch.exp(-1.0 / (1.0 - x))
    return a / (a + b)


def smoothstep(x: torch.Tensor, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """Quintic smoothstep 0 -> 1 over [low, high] (reference aimnet/ops.py:289-294)."""
    x = torch.clamp((x - low) / (high - low), 0.0, 1.0)
    return x**3 * (x * (x * 6.0 - 15.0) + 10.0)


def expstep(x: torch.Tensor, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """exp(-1 / (1 - x^2)) over [low, high], 1 at ``low``."""
    x = torch.clamp((x - low) / (high - low), 1e-6, 1 - 1e-6)
    return torch.exp(-1.0 / (1.0 - x * x)) / 0.36787944117144233


def erfc_approx(x: torch.Tensor) -> torch.Tensor:
    """f32-grade erfc for x >= 0 (Abramowitz & Stegun 7.1.26, |error| <
    1.5e-7); the same rational form as the JAX package's DSF term."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (
        0.254829592
        + t
        * (
            -0.284496736
            + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429))
        )
    )
    return poly * torch.exp(-x * x)


def coulomb_matrix_dsf(d_ij: torch.Tensor, Rc: float, alpha: float, valid: torch.Tensor) -> torch.Tensor:
    """Damped-shifted-force Coulomb kernel matrix, 0 beyond ``Rc`` and on
    invalid pairs."""
    c1 = torch.special.erfc(alpha * d_ij) / d_ij
    c2 = math.erfc(alpha * Rc) / Rc
    c3 = c2 / Rc
    c4 = 2 * alpha * math.exp(-((alpha * Rc) ** 2)) / (Rc * math.pi**0.5)
    j = c1 - c2 + (d_ij - Rc) * (c3 + c4)
    return torch.where(valid & (d_ij <= Rc), j, torch.zeros_like(j))
