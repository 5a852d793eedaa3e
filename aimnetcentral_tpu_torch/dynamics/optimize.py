"""Geometry relaxation by FIRE (counterpart of
aimnetcentral_tpu/dynamics/optimize.py).

The JAX package fuses the whole relaxation into one ``lax.while_loop``; here
it is a Python loop of eager steps whose scalars (time step, mixing,
uphill count) stay on the device, and the loop reads the largest force norm
on the host once per step to decide whether to go on.  The layout is fixed:
the neighbor structure is not rebuilt inside the loop (relaxations move
atoms far less than the skin; the molecule-bin layout holds whatever the
move); for large displacements, re-invoke on a rebuilt system.
"""

from __future__ import annotations

from typing import Any

import torch

from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config, aimnet2_apply
from aimnetcentral_tpu_torch.system import System


def fire_relax(
    params: Any,
    cfg: AIMNet2Config,
    system: System,
    fmax: float = 0.05,
    max_steps: int = 1000,
    dt_start: float = 0.1,
    dt_max: float = 0.5,
    n_min: int = 5,
    f_inc: float = 1.1,
    f_dec: float = 0.5,
    alpha_start: float = 0.1,
    f_alpha: float = 0.99,
) -> tuple[System, dict[str, Any]]:
    """FIRE relaxation (Bitzek et al. 2006) of a ``System`` on its device,
    on any layout: binned, molecule-bin or indexed.  Returns (relaxed
    system, info with ``steps``, ``fmax`` and ``converged``)."""
    real = (system.numbers > 0)[:, None]

    def force_of(coord: torch.Tensor) -> torch.Tensor:
        c = coord.detach().requires_grad_(True)
        e = aimnet2_apply(params, cfg, system.replace(coord=c), sae_external=True)["energy"].sum()
        (g,) = torch.autograd.grad(e, c)
        return torch.where(real, -g, 0.0)

    def scalar(x, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(x, dtype=dtype, device=system.device)

    coord = system.coord.detach()
    v = torch.zeros_like(coord)
    dt, alpha, npos = scalar(dt_start), scalar(alpha_start), scalar(0, torch.int32)
    step, fnorm = 0, float("inf")
    while fnorm > fmax and step < max_steps:
        f = force_of(coord)
        p = (f * v).sum()
        f_unit = f / torch.clamp(torch.linalg.norm(f), min=1e-10)
        v_mixed = (1.0 - alpha) * v + alpha * torch.linalg.norm(v) * f_unit

        uphill = p <= 0.0
        grow = npos > n_min
        v = torch.where(uphill, 0.0, v_mixed)
        dt = torch.where(uphill, dt * f_dec, torch.where(grow, torch.clamp(dt * f_inc, max=dt_max), dt))
        alpha = torch.where(uphill, alpha_start, torch.where(grow, alpha * f_alpha, alpha))
        npos = torch.where(uphill, 0, npos + 1)

        v = v + dt * f
        coord = coord + dt * v
        fnorm = float(torch.sqrt((f * f).sum(dim=-1).max()))  # the step's one host read
        step += 1

    f_final = force_of(coord)
    fmax_final = float(torch.sqrt((f_final * f_final).sum(dim=-1).max()))
    info = {"steps": step, "fmax": fmax_final, "converged": fmax_final <= fmax}
    return system.replace(coord=coord), info
