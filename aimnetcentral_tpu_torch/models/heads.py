"""Output heads (counterpart of aimnetcentral_tpu/models/heads.py).

Each head is a frozen spec plus ``head_init``/``head_apply`` over an
explicit parameter dict; ``head_apply`` takes and returns the data dict.
This port carries the heads of the flagship and of the released v2
artifacts: the energy MLP, the atomic shift (SAE, applied in float64 by the
calculator), the atomic sum, long-range Coulomb (DSF, Ewald and PME on both
layouts, simple on the indexed and the molecule-bin layouts), the
short-range Coulomb that a v2 artifact embeds (on every layout), GFN1
short-range repulsion (SRRep), the network's dispersion parameters
(DispParam) and D3 with the TS combination rule over them (D3TS), the
external DFT-D3(BJ) head of the ``-d3`` families on both layouts, and the
rxn family's dipole and quadrupole.  The binned branches sweep through the
pair kernels (models/engine_binned.py), the indexed ones run models/lr.py
over the neighbor matrices; Ewald's and PME's reciprocal parts are
models/ewald.py and models/pme.py on either layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aimnetcentral_tpu_torch import constants
from aimnetcentral_tpu_torch.models import engine_binned as eb
from aimnetcentral_tpu_torch.models import ewald, lr
from aimnetcentral_tpu_torch.models.modules import MLPSpec, mlp_apply, mlp_init
from aimnetcentral_tpu_torch.ops.nb import expand_mol, mask_pad_atoms, mol_sum
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
class DipoleHead:
    key_in: str = "charges"
    key_out: str = "dipole"
    center_coord: bool = False
    kind: str = dataclasses.field(default="dipole", init=False)


@dataclasses.dataclass(frozen=True)
class QuadrupoleHead:
    key_in: str = "charges"
    key_out: str = "quadrupole"
    center_coord: bool = False
    kind: str = dataclasses.field(default="quadrupole", init=False)


@dataclasses.dataclass(frozen=True)
class SRRepHead:
    key_out: str = "e_rep"
    cutoff_fn: str = "none"
    rc: float = 5.2
    reduce_sum: bool = True
    kind: str = dataclasses.field(default="srrep", init=False)


@dataclasses.dataclass(frozen=True)
class LRCoulombHead:
    key_in: str = "charges"
    key_out: str = "energy"
    rc: float = 4.6
    method: str = "simple"  # simple | dsf | ewald | pme
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


@dataclasses.dataclass(frozen=True)
class SRCoulombHead:
    """Subtracts the embedded short-range Coulomb when the full Coulomb is
    computed outside the model."""

    rc: float = 4.6
    key_in: str = "charges"
    key_out: str = "energy"
    envelope: str = "exp"
    kind: str = dataclasses.field(default="srcoulomb", init=False)

    def __post_init__(self):
        if self.envelope not in ("exp", "cosine"):
            raise ValueError(f"Unknown envelope {self.envelope!r}, must be 'exp' or 'cosine'")


@dataclasses.dataclass(frozen=True)
class DispParamHead:
    key_in: str = "disp_param"
    key_out: str = "disp_param"
    kind: str = dataclasses.field(default="disp_param", init=False)


@dataclasses.dataclass(frozen=True)
class D3TSHead:
    a1: float
    a2: float
    s8: float
    s6: float = 1.0
    key_in: str = "disp_param"
    key_out: str = "energy"
    kind: str = dataclasses.field(default="d3ts", init=False)


@dataclasses.dataclass(frozen=True)
class DFTD3Head:
    """External DFT-D3(BJ) dispersion with an S5 switch-off over the last
    ``smoothing_fraction`` of ``cutoff``; its parameters carry the D3
    reference tables."""

    s8: float
    a1: float
    a2: float
    s6: float = 1.0
    cutoff: float = 15.0
    smoothing_fraction: float = 0.2
    key_out: str = "energy"
    kind: str = dataclasses.field(default="dftd3", init=False)


HeadSpec = (
    OutputHead
    | AtomicShiftHead
    | AtomicSumHead
    | DipoleHead
    | QuadrupoleHead
    | SRRepHead
    | LRCoulombHead
    | SRCoulombHead
    | DispParamHead
    | D3TSHead
    | DFTD3Head
)


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
    if head.kind == "srrep":
        tab = np.zeros((87, 2), dtype=np.float32)
        tab[:, 0], tab[:, 1] = constants.get_gfn1_rep()
        return {"gfn1_ab": torch.tensor(tab, device=device)}
    if head.kind in ("dipole", "quadrupole"):
        return {"mass": torch.tensor(constants.get_masses(), dtype=torch.float32, device=device)}
    if head.kind == "disp_param":
        ref = np.zeros((87, 2), dtype=np.float32)
        ref[0, 1] = 1.0
        return {"disp_param0": torch.tensor(ref, device=device)}
    if head.kind == "d3ts":
        return {"r4r2": torch.tensor(constants.get_r4r2(), dtype=torch.float32, device=device)}
    if head.kind == "dftd3":
        return {k: torch.tensor(v, device=device) for k, v in constants.get_d3_tables().items()}
    return {}


def _center_coordinates(coord: torch.Tensor, system: System, masses: torch.Tensor | None) -> torch.Tensor:
    """Coordinates relative to each molecule's centre of mass (or centroid
    without ``masses``)."""
    if masses is not None:
        m = masses[..., None]
        center = mol_sum(coord * m, system.mol_idx, system.num_mol) / mol_sum(m, system.mol_idx, system.num_mol)
    else:
        sizes = mol_sum((system.numbers > 0).to(coord.dtype), system.mol_idx, system.num_mol)
        center = mol_sum(coord, system.mol_idx, system.num_mol) / sizes[:, None]
    return coord - expand_mol(center, system.mol_idx)


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

    if head.kind in ("dipole", "quadrupole"):
        q, r = data[head.key_in], system.coord
        if head.center_coord:
            r = _center_coordinates(r, system, params["mass"][system.numbers])
        if head.kind == "dipole":
            return {**data, head.key_out: mol_sum(q[..., None] * r, system.mol_idx, system.num_mol)}
        x = torch.cat([r * r, r * torch.roll(r, -1, dims=-1)], dim=-1)
        quad = mol_sum(q[..., None] * x, system.mol_idx, system.num_mol)
        x1, x2 = quad[..., :3], quad[..., 3:]
        return {**data, head.key_out: torch.cat([x1 - x1.mean(dim=-1, keepdim=True), x2], dim=-1)}

    if head.kind == "srrep":
        if system.bins is not None:
            e = eb.srrep_binned(system, params["gfn1_ab"], head.rc, head.cutoff_fn)
        else:
            e = lr.srrep_energy(data, system, params, head.rc, head.cutoff_fn)
        return _add_energy(data, head.key_out, e)

    if head.kind == "disp_param":
        return lr.disp_param_apply(data, params, system.numbers, head.key_in, head.key_out)

    if head.kind == "d3ts":
        if system.bins is not None:
            e = eb.d3ts_binned(system, params, data[head.key_in], head.a1, head.a2, head.s8, head.s6)
        else:
            e = lr.d3ts_energy(data, system, params, head.a1, head.a2, head.s8, head.s6, head.key_in)
        return _add_energy(data, head.key_out, e)

    if head.kind == "lrcoulomb":
        if head.method in ("ewald", "pme"):
            if system.bins is not None:  # PME when attach_ewald sized a mesh; the SR part in the sweep
                e = ewald.coulomb_periodic_binned(data, system, head.key_in, head.subtract_sr, head.rc, head.envelope)
            else:
                e = ewald.coulomb_periodic(data, system, head.method, head.key_in)
                if head.subtract_sr:
                    e = e - lr.coulomb_sr(lr.ensure_dij(data, system, ""), system, head.rc, head.envelope,
                                          head.key_in)
        elif system.bins is not None and head.method == "simple" and system.bins.molecule_bins:
            # one molecule a bin: the radius-0 sweep is every pair of a molecule
            e = eb.coulomb_simple_binned(system, data[head.key_in], head.rc, head.envelope, head.subtract_sr)
        elif system.bins is not None:
            if head.method != "dsf":  # JAX's ValueError: a definition, not a missing port
                raise ValueError(
                    f"Coulomb method {head.method!r} is not supported on a spatial binned grid: the stencil "
                    "would cut 1/r off (periodic simple Coulomb switches to dsf; gas-phase batches take the "
                    "molecule-bin layout, where simple Coulomb runs)"
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
        elif head.method == "simple":
            e = lr.coulomb_simple(data, system, head.rc, head.envelope, head.subtract_sr, head.key_in)
        else:
            e = lr.coulomb_dsf(
                data, system, head.rc, head.dsf_alpha, head.dsf_rc, head.envelope, head.subtract_sr,
                head.key_in,
            )
        return _add_energy(data, head.key_out, e)

    if head.kind == "srcoulomb":
        if system.bins is not None:  # spatial and molecule-bin grids alike
            e_sr = eb.coulomb_sr_binned(system, data[head.key_in], head.rc, head.envelope)
        else:
            e_sr = lr.coulomb_sr(data, system, head.rc, head.envelope, head.key_in)
        return _add_energy(data, head.key_out, -e_sr)

    if head.kind == "dftd3":
        smoothing_on = head.cutoff * (1.0 - head.smoothing_fraction)
        if system.bins is not None:
            e = eb.dftd3_binned(
                system, params, head.a1, head.a2, head.s8, head.s6,
                smoothing_on=smoothing_on, smoothing_off=head.cutoff,
            )
        else:
            e = lr.dftd3_energy(
                data, system, params, head.a1, head.a2, head.s8, head.s6,
                smoothing_on=smoothing_on, smoothing_off=head.cutoff,
            )
        return _add_energy(data, head.key_out, e)

    raise ValueError(f"unknown head kind {head.kind}")
