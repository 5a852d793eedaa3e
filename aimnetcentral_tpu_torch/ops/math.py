"""Geometry and physics math (counterpart of aimnetcentral_tpu/ops/math.py)."""

from __future__ import annotations

import math

import torch

from aimnetcentral_tpu_torch.ops.nb import expand_mol, mol_sum


def cellmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact-f32 geometry contraction ``a @ b`` (wraps @ cell, coord @
    inv_cell, strain).  Exact because TF32 is off (device.resolve_device):
    a TF32 product would displace periodic images."""
    return torch.matmul(a, b)


def cosine_cutoff(d_ij: torch.Tensor, rc) -> torch.Tensor:
    """0.5*(cos(pi*d/rc)+1) with d clamped to [1e-6, rc]."""
    rc = torch.as_tensor(rc, dtype=d_ij.dtype, device=d_ij.device)
    d = torch.minimum(torch.clamp(d_ij, min=1e-6), rc)
    return 0.5 * (torch.cos(d * (math.pi / rc)) + 1.0)


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
