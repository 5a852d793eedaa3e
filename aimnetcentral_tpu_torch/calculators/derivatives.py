"""Forces and stress by autograd (counterpart of
aimnetcentral_tpu/calculators/derivatives.py).

Forces are ``-dE/dcoord``; stress is the gradient with respect to a
per-molecule row-vector strain over the cell volume.  The conv kernels'
backward is first order only, so Hessians and HVPs are still to come.
"""

from __future__ import annotations

from typing import Callable

import torch

from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config, aimnet2_apply
from aimnetcentral_tpu_torch.ops.math import cellmul
from aimnetcentral_tpu_torch.system import System


def apply_strain(system: System, scaling: torch.Tensor) -> System:
    """coord' = coord @ S[mol], cell' = cell @ S.  ``scaling`` is
    (num_mol, 3, 3); padding atoms read the identity."""
    eye = torch.eye(3, dtype=scaling.dtype, device=scaling.device)[None]
    atom_scaling = torch.cat([scaling, eye], dim=0)[system.mol_idx]  # (N, 3, 3)
    coord = torch.einsum("ni,nij->nj", system.coord, atom_scaling)
    cell = cellmul(system.cell, scaling) if system.cell is not None else None
    return system.replace(coord=coord, cell=cell)


_KEEP = ("charges", "spin_charges", "mol_element_counts")


def make_eval_fn(
    cfg: AIMNet2Config,
    *,
    forces: bool = False,
    stress: bool = False,
    hessian: bool = False,
    sae_external: bool = True,
) -> Callable[[dict, System], dict]:
    """``f(params, system) -> outputs``: ``energy`` (num_mol,), plus
    ``forces`` (N, 3) and ``stress`` (num_mol, 3, 3) as requested, and
    ``charges`` (and ``mol_element_counts`` under SAE externalization)."""
    if hessian:
        raise NotImplementedError(
            "Hessians need the conv kernels' second-order rules (ROADMAP.md, "
            "queue 1: K3 second order)"
        )

    def collect(data: dict) -> dict:
        out = {"energy": data["energy"].detach()}
        for k in _KEEP:
            if data.get(k) is not None:
                out[k] = data[k].detach()
        return out

    def eval_fn(params: dict, system: System) -> dict:
        if not (forces or stress):
            with torch.no_grad():
                return collect(aimnet2_apply(params, cfg, system, sae_external=sae_external))
        coord = system.coord.detach().requires_grad_(True)
        inputs = [coord]
        sys2 = system.replace(coord=coord)
        if stress:
            if system.cell is None:
                raise ValueError("stress requires a periodic cell")
            scaling = (
                torch.eye(3, dtype=coord.dtype, device=coord.device)
                .expand(system.num_mol, 3, 3)
                .clone()
                .requires_grad_(True)
            )
            inputs.append(scaling)
            sys2 = apply_strain(sys2, scaling)
        data = aimnet2_apply(params, cfg, sys2, sae_external=sae_external)
        grads = torch.autograd.grad(data["energy"].sum(), inputs)
        out = collect(data)
        if forces:
            out["forces"] = -grads[0]
        if stress:
            volume = torch.abs(torch.linalg.det(system.cell))[:, None, None]
            out["stress"] = grads[1] / volume
        return out

    return eval_fn
