"""Output heads (counterpart of aimnetcentral_tpu/models/heads.py).

Each head is a frozen spec plus ``head_init``/``head_apply`` over an
explicit parameter dict; ``head_apply`` takes and returns the data dict.
This slice carries the flagship's heads: the energy MLP, the atomic shift
(SAE, applied in float64 by the calculator), the atomic sum, and long-range
Coulomb on the binned DSF branch.
"""

from __future__ import annotations

import dataclasses

import torch

from aimnetcentral_tpu_torch.models import engine_binned as eb
from aimnetcentral_tpu_torch.models.modules import MLPSpec, mlp_apply, mlp_init
from aimnetcentral_tpu_torch.ops.nb import mask_pad_atoms, mol_sum
from aimnetcentral_tpu_torch.system import System


@dataclasses.dataclass(frozen=True)
class OutputHead:
    """MLP head reading ``key_in`` -> ``key_out``."""

    n_in: int
    n_out: int
    key_in: str
    key_out: str
    mlp: MLPSpec = MLPSpec()
    kind: str = dataclasses.field(default="output", init=False)


@dataclasses.dataclass(frozen=True)
class AtomicShiftHead:
    """Per-element additive shift (SAE).  The calculator applies the
    float64 table on the host from the per-molecule element counts this head
    emits, so the device graph stays float32."""

    key_in: str
    key_out: str
    num_types: int = 64
    reduce_sum: bool = False
    kind: str = dataclasses.field(default="atomic_shift", init=False)


@dataclasses.dataclass(frozen=True)
class AtomicSumHead:
    key_in: str
    key_out: str
    kind: str = dataclasses.field(default="atomic_sum", init=False)


@dataclasses.dataclass(frozen=True)
class LRCoulombHead:
    key_in: str = "charges"
    key_out: str = "energy"
    rc: float = 4.6
    method: str = "simple"  # simple | dsf (ewald and pme are still to be ported)
    dsf_alpha: float = 0.2
    dsf_rc: float = 15.0
    ewald_accuracy: float = 1e-6
    subtract_sr: bool = True
    envelope: str = "exp"
    kind: str = dataclasses.field(default="lrcoulomb", init=False)

    def __post_init__(self):
        if self.envelope not in ("exp", "cosine"):
            raise ValueError(f"Unknown envelope {self.envelope!r}, must be 'exp' or 'cosine'")
        if self.method not in ("simple", "dsf", "ewald", "pme"):
            raise ValueError(f"Unknown method {self.method!r}")


HeadSpec = OutputHead | AtomicShiftHead | AtomicSumHead | LRCoulombHead


def auto_switch_simple_to_dsf(cfg):
    """Replace simple -> DSF Coulomb for periodic systems: bare 1/r pair
    sums are truncated by the neighbor stencil under PBC."""
    outputs = tuple(
        (
            name,
            dataclasses.replace(h, method="dsf")
            if isinstance(h, LRCoulombHead) and h.method == "simple"
            else h,
        )
        for name, h in cfg.outputs
    )
    return dataclasses.replace(cfg, outputs=outputs)


def head_init(gen: torch.Generator, head: HeadSpec, device: torch.device) -> dict:
    if head.kind == "output":
        return {"mlp": mlp_init(gen, head.n_in, head.n_out, head.mlp, device)}
    if head.kind == "atomic_shift":
        return {"weight": torch.zeros(head.num_types, device=device)}
    return {}


def _add_energy(data: dict, key_out: str, e: torch.Tensor) -> dict:
    if key_out in data:
        return {**data, key_out: data[key_out] + e}
    return {**data, key_out: e}


def head_apply(head: HeadSpec, params: dict, data: dict, system: System) -> dict:
    if head.kind == "output":
        v = mlp_apply(params["mlp"], data[head.key_in], head.mlp)
        if head.n_out == 1:
            v = v.squeeze(-1)
        return {**data, head.key_out: mask_pad_atoms(v, system.numbers)}

    if head.kind == "atomic_shift":
        if data.get("_sae_external", False):
            # exact integer histogram (integer adds are order-independent)
            counts = torch.zeros(
                (system.num_mol + 1, head.num_types), dtype=torch.int64, device=system.device
            )
            counts.index_put_(
                (system.mol_idx, system.numbers),
                torch.ones_like(system.numbers),
                accumulate=True,
            )
            return {**data, "mol_element_counts": counts[: system.num_mol]}
        shifts = params["weight"][system.numbers]
        if head.reduce_sum:
            shifts = mol_sum(shifts, system.mol_idx, system.num_mol)
        return {**data, head.key_out: data[head.key_in] + shifts}

    if head.kind == "atomic_sum":
        return {**data, head.key_out: mol_sum(data[head.key_in], system.mol_idx, system.num_mol)}

    if head.kind == "lrcoulomb":
        if system.bins is None:
            raise NotImplementedError(
                "Coulomb on the indexed layout is not ported yet (ROADMAP.md, "
                "queue 1: the indexed / gas-phase path)"
            )
        if head.method != "dsf":
            raise NotImplementedError(
                f"Coulomb method {head.method!r} on the binned engine is not ported "
                "(periodic simple Coulomb switches to dsf; ewald and pme: ROADMAP.md "
                "queue 1, the rest of long range)"
            )
        e = eb.coulomb_dsf_binned(
            system,
            data[head.key_in],
            head.rc,
            head.dsf_alpha,
            head.dsf_rc,
            head.envelope,
            head.subtract_sr,
        )
        return _add_energy(data, head.key_out, e)

    raise ValueError(f"unknown head kind {head.kind}")
