"""Multi-target training loss (counterpart of aimnetcentral_tpu/train/loss.py).

A weighted sum over targets with padding-aware per-atom terms: a plain
function of (predictions, labels, system), no module state.
"""

from __future__ import annotations

import dataclasses

import torch

from aimnetcentral_tpu_torch.ops.nb import mol_sum
from aimnetcentral_tpu_torch.system import System


@dataclasses.dataclass(frozen=True)
class LossTerm:
    kind: str  # "energy" | "peratom" | "permol" | "charge_conservation"
    key_pred: str
    key_true: str
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class LossConfig:
    terms: tuple[LossTerm, ...] = (
        LossTerm(kind="energy", key_pred="energy", key_true="energy", weight=1.0),
        LossTerm(kind="peratom", key_pred="forces", key_true="forces", weight=0.1),
        LossTerm(kind="peratom", key_pred="charges", key_true="charges", weight=0.05),
    )


class MTLoss:
    """Weighted multi-target loss; returns (total, per-term dict)."""

    def __init__(self, cfg: LossConfig):
        self.cfg = cfg

    def __call__(self, pred: dict, true: dict, system: System) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        real_atom = (system.numbers > 0).to(torch.float32)
        mol_sizes = mol_sum(real_atom, system.mol_idx, system.num_mol)

        components: dict[str, torch.Tensor] = {}
        total = torch.zeros((), dtype=torch.float32, device=system.device)
        for term in self.cfg.terms:
            if term.key_true not in true and term.kind != "charge_conservation":
                continue
            if term.kind == "energy":
                # MSE of the energy over sqrt(natoms), squared
                diff = pred[term.key_pred] - true[term.key_true]
                val = torch.mean(diff * diff / torch.clamp(mol_sizes, min=1.0))
            elif term.kind == "peratom":
                # padding-aware per-atom MSE
                diff = pred[term.key_pred] - true[term.key_true]
                if diff.dim() == 1:
                    diff = diff[:, None]
                se = torch.sum(diff * diff, dim=-1) * real_atom
                val = torch.sum(se) / torch.clamp(torch.sum(real_atom), min=1.0)
            elif term.kind == "permol":
                diff = pred[term.key_pred] - true[term.key_true]
                val = torch.mean(torch.sum(diff.reshape(system.num_mol, -1) ** 2, dim=-1))
            elif term.kind == "charge_conservation":
                dq = pred.get("_delta_Q")
                val = torch.mean(dq * dq) if dq is not None else torch.zeros((), device=system.device)
            else:
                raise ValueError(f"unknown loss term kind {term.kind}")
            components[f"{term.kind}:{term.key_pred}"] = val
            total = total + term.weight * val
        return total, components
