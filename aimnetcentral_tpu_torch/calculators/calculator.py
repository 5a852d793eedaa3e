"""AIMNet2Calculator: the inference facade (counterpart of
aimnetcentral_tpu/calculators/calculator.py, cut down to this port's slice).

Inputs are one molecule or periodic box, a list of molecule dicts, or a
dense (B, N, 3) batch.  One structure at or above ``binned_threshold`` atoms
goes onto the binned layout (SR grid plus the coarse LR twin grid, planned
on the cell or on a gas-phase cluster's extent, with a capacity-regrow loop
on bin overflow) when it is periodic or its Coulomb is DSF or absent; a
gas-phase batch at or above it goes onto the molecule-bin layout (one
molecule a bin, every sweep at radius 0) unless its slots would be less
than a quarter full; molecules, other batches and small boxes go onto the
indexed layout (host neighbor matrices).  ``eval`` returns per-molecule
energies and charges, forces and stress in input atom order, with the
self-atomic energies added in float64 on the host (and the dipole and
quadrupole of models that carry those heads).  ``model`` is a parameter
tuple, a ``LoadedModel`` or a registry name, alias, ``.pt`` path, trusted
legacy ``.jpt`` path or Hugging Face directory (models/loader.py), whose
metadata decides the external long-range heads and the species and charge
checks of ``eval``.  While the topology is
unchanged and no atom moved farther than ``reuse_skin / 2``, the prepared
layout is reused (grids and lists reach the skin beyond every cutoff, so
the result is exact); the molecule-bin layout is reused after any move (its
bins are the molecules).  Every force evaluation runs inside its precision
tier's context (``precision_tiers``).  Hessians (``eval(hessian=True)``,
per structure for a batch) and Hessian-vector products
(``hessian_vector_product``) run on the indexed layout, as in JAX, and never
reuse a binned or packed layout.  Ewald and PME (``set_lrcoulomb_method``)
run on periodic inputs of every layout: the binned LR grid and the indexed
Coulomb list reach the real-space cutoff that ``models/ewald.py::
estimate_ewald_parameters`` gives for the head's accuracy, and the
discretisation (``attach_ewald``) rides on the prepared System, so a reused
layout keeps it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from aimnetcentral_tpu_torch.builders import system_from_molecules, system_molecule_bins
from aimnetcentral_tpu_torch.calculators import derivatives
from aimnetcentral_tpu_torch.device import resolve_device
from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config
from aimnetcentral_tpu_torch.models.bridge import params_to
from aimnetcentral_tpu_torch.models.ewald import (  # noqa: F401  (EWALD_ATOM_GUIDANCE_LIMIT: JAX's calculator's name)
    EWALD_ATOM_GUIDANCE_LIMIT,
    attach_ewald,
    estimate_ewald_parameters,
    warn_ewald_above_limit,
)
from aimnetcentral_tpu_torch.models.heads import DFTD3Head, LRCoulombHead, auto_switch_simple_to_dsf
from aimnetcentral_tpu_torch.models.loader import LoadedModel, attach_external_lr, init_missing_heads, load_model
from aimnetcentral_tpu_torch.models.validation import validate_runtime_model_metadata
from aimnetcentral_tpu_torch.ops import binned as B
from aimnetcentral_tpu_torch.system import System

ATOM_BUCKET = 16  # the compact atom count is padded to a multiple of this


def precision_tiers(precision: str) -> tuple[str, str | None]:
    """Map a precision tier to ``(matmul_precision, conv_precision)``, the
    JAX package's mapping (calculators/calculator.py::precision_tiers), the
    one source shared by the calculators, MD, spatial MD and training:

    - ``exact``    -> ("highest", None): TF32 off everywhere; kernels A and
      B run their FP32 builds;
    - ``balanced`` -> ("highest", "f32x3"): TF32 off outside the conv
      kernels, which split each operand into a TF32 high and low part for
      three tensor-core passes (the "3xtf32" builds, JAX's hand-split
      ``_mxu_dot``);
    - ``fast``     -> ("default", None): TF32 matmuls, and kernels A and B
      in one TF32 pass (conv_pass.resolve_conv_mode: "f32" under TF32).
    """
    if precision not in ("exact", "balanced", "fast"):
        raise ValueError(f"precision must be 'exact', 'balanced' or 'fast', got {precision!r}")
    return "default" if precision == "fast" else "highest", "f32x3" if precision == "balanced" else None


@contextlib.contextmanager
def ambient_matmul_context(matmul_precision: str) -> Iterator[None]:
    """Set ``torch.backends.cuda.matmul.allow_tf32`` for a tier's matmuls
    (on for "default", off for "highest") and restore the caller's value on
    the way out, exception or not.  It must wrap the forward AND
    ``torch.autograd.grad``: the backward's GEMMs run when the gradient is
    pulled.  The geometry contractions are exact either way
    (``ops/math.py::cellmul``); CPU matmuls are exact f32 at every tier."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_precision == "default"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _as_molecules(data: Mapping[str, Any] | list | tuple) -> list[dict]:
    """Normalize user input into a list of molecule dicts.

    Accepted: one structure (coord (N, 3)), a dense batch (coord (B, N, 3),
    padding atoms with ``numbers == 0``), or a list / tuple of per-molecule
    dicts (sizes and cells may differ); charge and mult scalar or (B,),
    cell (3, 3) or (B, 3, 3)."""
    if isinstance(data, (list, tuple)):
        mols = []
        for m in data:
            mol = {
                "coord": np.asarray(m["coord"], dtype=np.float32),
                "numbers": np.asarray(m["numbers"]),
                "charge": float(np.asarray(m.get("charge", 0.0)).reshape(())),
            }
            if m.get("mult") is not None:
                mol["mult"] = float(np.asarray(m["mult"]).reshape(()))
            if m.get("cell") is not None:
                mol["cell"] = np.asarray(m["cell"], dtype=np.float32)
            mols.append(mol)
        return mols
    coord = np.asarray(data["coord"], dtype=np.float32)
    numbers = np.asarray(data["numbers"])
    if coord.ndim == 2:
        coord, numbers = coord[None], numbers[None]
    b = coord.shape[0]
    charge = np.broadcast_to(np.asarray(data.get("charge", 0.0), dtype=np.float32).reshape(-1), (b,))
    mult = data.get("mult")
    if mult is not None:
        mult = np.broadcast_to(np.asarray(mult, dtype=np.float32).reshape(-1), (b,))
    cell = data.get("cell")
    if cell is not None:
        cell = np.asarray(cell, dtype=np.float32)
        if cell.ndim == 2:
            cell = np.broadcast_to(cell[None], (b, 3, 3))
    mols = []
    for i in range(b):
        real = numbers[i] > 0
        mol = {"coord": coord[i][real], "numbers": numbers[i][real], "charge": float(charge[i])}
        if mult is not None:
            mol["mult"] = float(mult[i])
        if cell is not None:
            mol["cell"] = cell[i]
        mols.append(mol)
    return mols


def _prep_key(mols: list[dict], allow_binned: bool) -> tuple:
    """What a reused layout must share with the new input: the routing's
    ``allow_binned`` and the numbers, charge, mult and cell of every
    molecule."""
    return allow_binned, tuple(
        (
            np.asarray(m["numbers"]).tobytes(),
            float(m.get("charge", 0.0)),
            None if m.get("mult") is None else float(m["mult"]),
            None if m.get("cell") is None else np.asarray(m["cell"]).tobytes(),
        )
        for m in mols
    )


def _builder_wrap(mols: list[dict], n_pad: int) -> np.ndarray | None:
    """The Cartesian lattice offset ``system_from_molecules`` subtracts from
    each atom of a periodic molecule to wrap it into its cell, in float64
    and computed as the builder computes it; None without a cell."""
    if not any(m.get("cell") is not None for m in mols):
        return None
    wrap = np.zeros((n_pad, 3), np.float64)
    off = 0
    for m in mols:
        c = np.asarray(m["coord"], np.float32).astype(np.float64)
        if m.get("cell") is not None:
            cb = np.asarray(m["cell"], np.float64)
            wrap[off : off + len(c)] = np.floor(c @ np.linalg.inv(cb)) @ cb
        off += len(c)
    return wrap


def _apply_external_lr_flags(
    params: dict, cfg: AIMNet2Config, metadata: Mapping[str, Any], needs_coulomb: bool, needs_dispersion: bool
) -> tuple[dict, AIMNet2Config]:
    """Strip or attach the external long-range heads so that the model
    matches the calculator's resolved flags; the metadata itself is never
    changed."""
    outputs = tuple(
        (n, h)
        for n, h in cfg.outputs
        if not (n == "external_coulomb" and not needs_coulomb) and not (n == "external_dftd3" and not needs_dispersion)
    )
    cfg = dataclasses.replace(cfg, outputs=outputs)
    names = {n for n, _ in outputs}
    attach_c = needs_coulomb and "external_coulomb" not in names
    attach_d = needs_dispersion and "external_dftd3" not in names
    if attach_c or attach_d:
        cfg = attach_external_lr(cfg, {**metadata, "needs_coulomb": attach_c, "needs_dispersion": attach_d})
    kept = {n: p for n, p in params.get("outputs", {}).items() if n in {n for n, _ in cfg.outputs}}
    return init_missing_heads({**params, "outputs": kept}, cfg), cfg


def _ewald_real_cutoff(head: LRCoulombHead, mols: list[dict]) -> float:
    """The largest real-space cutoff of the molecules' cells at the head's
    accuracy, which the LR layout must reach; exact Ewald warns above
    ``EWALD_ATOM_GUIDANCE_LIMIT`` atoms."""
    if head.method == "ewald":
        warn_ewald_above_limit(sum(len(m["numbers"]) for m in mols))
    return max(
        estimate_ewald_parameters(np.asarray(m["cell"]), len(m["numbers"]), head.ewald_accuracy).r_cutoff for m in mols
    )


class AIMNet2Calculator:
    """Single-point energy / forces / stress of molecules, batches and
    periodic boxes.

    ``model`` is ``(params, cfg)``, ``(params, cfg, aux)``, a
    ``LoadedModel`` or a registry name, alias, ``.pt`` or trusted ``.jpt``
    path or Hugging Face directory; ``aux['sae']`` holds float64
    self-atomic-energy tables applied on the host, ``aux['metadata']`` the
    artifact's metadata.
    ``needs_coulomb`` / ``needs_dispersion`` override the metadata's
    external long-range heads (None follows it).  Runs on
    ``device`` ("cuda" unless the caller asks for "cpu"); CUDA tensors run
    the hand-written conv and pair kernels, CPU tensors their plain versions.
    ``binned_threshold`` is the atom count from which one structure goes
    onto the binned layout; ``precision`` is a tier of ``precision_tiers``;
    ``reuse_skin`` (Angstrom) the Verlet skin of the prepared-layout reuse,
    0 to rebuild every call.
    """

    def __init__(
        self,
        model: tuple | str | LoadedModel,
        device: str | torch.device = "cuda",
        binned_threshold: int = 1024,
        reuse_skin: float = 0.6,
        precision: str = "exact",
        needs_coulomb: bool | None = None,
        needs_dispersion: bool | None = None,
    ):
        precision_tiers(precision)  # validate
        self.precision = precision
        self.device = resolve_device(device)
        if isinstance(model, str):
            from aimnetcentral_tpu_torch.calculators.registry import registry_family, resolve_model

            model = load_model(resolve_model(model), registry_family=registry_family(model))
        if isinstance(model, LoadedModel):
            model = model.as_calculator_model()
        if len(model) == 2:
            params, cfg = model
            aux: dict = {"sae": {}}
        else:
            params, cfg, aux = model
        self.aux = aux
        self.metadata: dict = dict(aux.get("metadata") or {})
        # the effective external long-range flags: an explicit override,
        # else the metadata, else the heads the config already has
        names = {n for n, _ in cfg.outputs}
        eff_coulomb = bool(self.metadata.get("needs_coulomb", "external_coulomb" in names))
        eff_dispersion = bool(self.metadata.get("needs_dispersion", "external_dftd3" in names))
        eff_coulomb = eff_coulomb if needs_coulomb is None else bool(needs_coulomb)
        eff_dispersion = eff_dispersion if needs_dispersion is None else bool(needs_dispersion)
        if self.metadata or needs_coulomb is not None or needs_dispersion is not None:
            validate_runtime_model_metadata(
                self.metadata, needs_coulomb=eff_coulomb, needs_dispersion=eff_dispersion
            )
        if (eff_coulomb, eff_dispersion) != ("external_coulomb" in names, "external_dftd3" in names):
            params, cfg = _apply_external_lr_flags(params, cfg, self.metadata, eff_coulomb, eff_dispersion)
        self.params = params_to(params, self.device)
        self.cfg: AIMNet2Config = cfg
        self.binned_threshold = binned_threshold
        self.reuse_skin = reuse_skin
        self._last_perm: np.ndarray | None = None
        self._prep_cache: dict | None = None
        self._lr_cutoff_override: float | None = None
        self._dftd3_cutoff_override: float | None = None
        self._species_cache: tuple | None = None
        self._mult_warned = False

    @property
    def cutoff(self) -> float:
        return self.cfg.aev.rc_s

    @property
    def is_nse(self) -> bool:
        """True for two-channel (spin-resolved NSE) models."""
        return self.cfg.num_charge_channels == 2

    @classmethod
    def from_legacy_jit(cls, path: str, **calculator_kwargs: Any) -> "AIMNet2Calculator":
        """A calculator of a trusted legacy ``.jpt`` TorchScript archive
        (``models.loader.load_jpt_model``), with the calculator's keywords
        (``device``, ``precision``, ...); ``path`` is the model, so a
        ``model`` keyword raises ``TypeError``."""
        if "model" in calculator_kwargs:
            raise TypeError("from_legacy_jit() does not accept a model keyword argument.")
        return cls(load_model(path), **calculator_kwargs)

    @property
    def has_external_coulomb(self) -> bool:
        """True when long-range Coulomb is an external head (v2 artifacts
        with ``needs_coulomb``)."""
        return any(n == "external_coulomb" for n, _h in self.cfg.outputs)

    @property
    def has_external_dftd3(self) -> bool:
        """True when D3 dispersion is an external head."""
        return any(n == "external_dftd3" for n, _h in self.cfg.outputs)

    @property
    def coulomb_method(self) -> str | None:
        """The external Coulomb head's configured method, or None without
        one (the per-request periodic switch to DSF is not reflected)."""
        return next((h.method for n, h in self.cfg.outputs if n == "external_coulomb"), None)

    @property
    def coulomb_cutoff(self) -> float | None:
        """The external Coulomb's real-space cutoff: inf for simple, the
        DSF cutoff (or ``set_lr_cutoff``'s) for DSF, None for Ewald / PME."""
        method = self.coulomb_method
        if method == "simple":
            return float("inf")
        if method == "dsf":
            h = self._lr_head()
            return self._lr_cutoff_override or (h.dsf_rc if h else None)
        return None

    @property
    def dftd3_cutoff(self) -> float | None:
        """The D3 cutoff in Angstrom, or None without a D3 head."""
        d3 = self._d3_head()
        return None if d3 is None else self._dftd3_cutoff_override or d3.cutoff

    def _lr_head(self) -> LRCoulombHead | None:
        return next((h for _n, h in self.cfg.outputs if isinstance(h, LRCoulombHead)), None)

    def _replace_heads(self, kind: type, **changes: Any) -> None:
        """Every head of type ``kind`` with ``changes``; drops the prepared
        layout, whose reach followed the old cutoffs."""
        outputs = tuple(
            (n, dataclasses.replace(h, **changes) if isinstance(h, kind) else h) for n, h in self.cfg.outputs
        )
        self.cfg = dataclasses.replace(self.cfg, outputs=outputs)
        self._prep_cache = None

    def set_lrcoulomb_method(self, method: str, **kwargs: Any) -> None:
        """Switch the Coulomb method ("simple", "dsf", "ewald" or "pme";
        Ewald and PME need a periodic cell)."""
        valid = ("simple", "dsf", "ewald", "pme")
        if method not in valid:
            raise ValueError(f"unknown Coulomb method {method!r}; expected one of {valid}")
        self._replace_heads(LRCoulombHead, method=method, **kwargs)

    def set_lr_cutoff(self, cutoff: float) -> None:
        """One long-range list cutoff for the Coulomb and D3 sweeps."""
        self._lr_cutoff_override = float(cutoff)
        self._dftd3_cutoff_override = float(cutoff)
        self._prep_cache = None

    def set_dftd3_cutoff(self, cutoff: float | None = None, smoothing_fraction: float | None = None) -> None:
        """Set the D3 cutoff and its smoothing window (this changes the
        dispersion energy, not only the list)."""
        cutoff = 15.0 if cutoff is None else float(cutoff)
        smoothing_fraction = 0.2 if smoothing_fraction is None else float(smoothing_fraction)
        self._replace_heads(DFTD3Head, cutoff=cutoff, smoothing_fraction=smoothing_fraction)
        self._dftd3_cutoff_override = cutoff

    def _validate_species_and_charge(self, data: Mapping[str, Any] | list | tuple) -> None:
        """Atomic numbers against the metadata's ``implemented_species`` and
        net charge against the family policy; a warning (once per
        calculator) for ``mult`` on a closed-shell model.  Nothing to check
        without metadata."""
        if isinstance(data, (list, tuple)):
            for m in data:
                self._validate_species_and_charge(m)
            return
        if (
            data.get("mult") is not None
            and self.cfg.num_charge_channels == 1
            and not self._mult_warned
            and np.any(np.asarray(data["mult"], dtype=np.float64) != 1.0)
        ):
            warnings.warn("mult is ignored by this closed-shell (non-NSE) model", stacklevel=3)
            self._mult_warned = True
        impl = self.metadata.get("implemented_species") or []
        if impl and "numbers" in data:
            numbers = data["numbers"]
            key = None
            if isinstance(numbers, np.ndarray):
                # a content fingerprint, not identity alone: numpy arrays
                # change in place under the same id
                key = (id(numbers), numbers.shape, str(numbers.dtype), hash(numbers.tobytes()))
            if key is None or self._species_cache != key:
                seen = {int(z) for z in np.unique(np.asarray(numbers)) if int(z) > 0}
                unsupported = sorted(seen - {int(z) for z in impl})
                if unsupported:
                    raise ValueError(
                        f"Atomic numbers {unsupported} are not in this model's "
                        f"implemented_species {sorted(int(z) for z in impl)}. "
                        "Evaluating untrained elements yields undefined output. "
                        "Pass validate_species=False to bypass."
                    )
                self._species_cache = key
        if self.metadata.get("supports_charged_systems") is False:
            charge = np.atleast_1d(np.asarray(data.get("charge", 0.0), dtype=np.float64))
            if charge.size and np.abs(charge).max() > 1e-6:
                bad = charge[np.abs(charge) > 1e-6].tolist()
                raise ValueError(
                    "This model does not support net-charged systems (got "
                    f"non-zero charge(s) {bad}). Net-neutral zwitterions are "
                    "supported. Pass validate_species=False to bypass."
                )

    def _effective_cfg(self, has_cell: bool) -> AIMNet2Config:
        """Periodic cells switch simple -> DSF Coulomb."""
        return auto_switch_simple_to_dsf(self.cfg) if has_cell else self.cfg

    def _d3_head(self) -> DFTD3Head | None:
        return next((h for _n, h in self.cfg.outputs if isinstance(h, DFTD3Head)), None)

    # -- Verlet-style prepared-system reuse ---------------------------------

    def _store_prep(
        self,
        mols: list[dict],
        allow_binned: bool,
        system: System,
        kind: str,
        n_pad: int,
        perm: np.ndarray | None = None,
    ) -> None:
        """Keep the prepared layout (``kind`` "binned", "packed" or
        "indexed") with the input it was built from, the slot permutation of
        a binned or packed layout (slot -> row of the input atoms padded to
        ``n_pad`` rows of 1.0), and the lattice wrap the builder applied as
        a float64 Cartesian offset per atom (None in the gas phase)."""
        if self.reuse_skin <= 0:
            return
        self._prep_cache = {
            "key": _prep_key(mols, allow_binned), "kind": kind, "system": system,
            "ref": np.concatenate([np.asarray(m["coord"], np.float32) for m in mols]),
            "n_pad": n_pad, "perm": perm, "wrap": _builder_wrap(mols, n_pad),
        }

    def _reuse_prepared(self, mols: list[dict], allow_binned: bool) -> System | None:
        """The cached layout with the new coordinates in it, while the
        routing (``allow_binned``) and the topology are unchanged and no
        atom moved farther than ``reuse_skin / 2`` since the build; None
        otherwise.  Lists and grids reach
        ``reuse_skin`` beyond every cutoff and every term masks at its own
        cutoff, so the result is exact: a pair's distance changes by at
        most the sum of its two atoms' moves.  The move is the Euclidean
        length of each atom's displacement (a per-coordinate test lets an
        atom move sqrt(3) times as far along a diagonal, or along the plane
        normal of a skewed cell, and drop pairs); the JAX package tests each
        coordinate, so the port rebuilds where it reuses.  The molecule-bin
        layout ("packed") holds whatever the move: its bins are the
        molecules, and every sweep on it meets every pair of a molecule."""
        c = self._prep_cache
        if c is None or self.reuse_skin <= 0 or c["key"] != _prep_key(mols, allow_binned):
            return None
        new = np.concatenate([np.asarray(m["coord"], np.float32) for m in mols])
        if new.shape != c["ref"].shape:
            return None
        if c["kind"] != "packed" and np.linalg.norm(new - c["ref"], axis=1).max() > 0.5 * self.reuse_skin:
            return None
        compact = np.ones((c["n_pad"], 3), np.float32)
        compact[: len(new)] = new
        if c["wrap"] is not None:
            # periodic systems live in the wrapped frame: the wrap CACHED at
            # build time, subtracted in float64 as the builder does, keeps an
            # atom that crossed the box boundary since continuous (its bin is
            # stale by less than the skin, which the grids' margin covers, and
            # the indexed shift matrices stay exact)
            compact = (compact.astype(np.float64) - c["wrap"]).astype(np.float32)
        self._last_perm = c["perm"]
        if c["kind"] != "indexed":
            compact = compact[c["perm"]]
        return c["system"].replace(coord=torch.as_tensor(compact, device=self.device))

    # -- layouts ------------------------------------------------------------

    def prepare_system(self, data: Mapping[str, Any] | list | tuple, allow_binned: bool = True) -> System:
        """The System a request runs on, following the JAX package's
        routing: one structure at or above ``binned_threshold`` atoms goes
        onto the binned layout when it is periodic or its Coulomb is DSF or
        absent (a gas-phase grid then spans the atoms' extent); a gas-phase
        batch at or above it goes onto the molecule-bin layout when its
        slots are at least a quarter full; everything else, and everything
        when ``allow_binned`` is false (Hessians and HVPs), goes onto the
        indexed layout."""
        mols = _as_molecules(data)
        reused = self._reuse_prepared(mols, allow_binned)
        if reused is not None:
            return reused
        n_real = sum(len(m["numbers"]) for m in mols)
        n_pad = _round_up(n_real + 1, ATOM_BUCKET)
        has_cell = any("cell" in m for m in mols)
        self._last_perm = None
        h_eff = next(
            (h for _n, h in self._effective_cfg(has_cell).outputs if isinstance(h, LRCoulombHead)), None
        )
        if allow_binned and not has_cell and len(mols) > 1 and n_real >= self.binned_threshold:
            cap = max(8, _round_up(max(len(m["numbers"]) for m in mols), 8))
            if cap * len(mols) <= 4 * n_real:
                return self._prepare_packed(mols, n_real, cap)
        binned_ok = has_cell or h_eff is None or h_eff.method == "dsf"
        if allow_binned and binned_ok and len(mols) == 1 and n_real >= self.binned_threshold:
            return self._prepare_binned(mols[0], n_real, n_pad, h_eff)
        return self._prepare_indexed(mols, n_real, n_pad, has_cell, h_eff, allow_binned)

    def _prepare_packed(self, mols: list[dict], n_real: int, cap: int) -> System:
        """A gas-phase batch on the molecule-bin layout (capacity ``cap``):
        no neighbor build and no pair gathers; ``perm`` maps each slot to
        its input atom, padding slots to the row after the last."""
        system = system_molecule_bins(mols, self.device, capacity=cap)
        perm = np.full(system.natoms, n_real, dtype=np.int64)
        off = 0
        for k, m in enumerate(mols):
            n = len(m["numbers"])
            perm[k * cap : k * cap + n] = np.arange(off, off + n)
            off += n
        self._last_perm = perm
        self._store_prep(mols, True, system, "packed", n_real + 1, perm=perm)
        return system

    def _prepare_binned(self, mol: dict, n_real: int, n_pad: int, h_eff: LRCoulombHead | None) -> System:
        """One structure on the binned layout: SR grid plus the coarse LR
        twin, planned on the cell or, in the gas phase, on the extent of the
        atoms, with a capacity-regrow loop on bin overflow."""
        system = system_from_molecules([mol], self.device, n_pad=n_pad)
        if "cell" in mol:
            cell_np, extent = np.asarray(mol["cell"]), None
        else:
            coord_np = np.asarray(mol["coord"])
            cell_np, extent = None, (coord_np.min(axis=0), coord_np.max(axis=0))
        # the coarse LR twin layout is sized by the largest LR cutoff, so its
        # stencil stays at radius 2
        ewald_on = h_eff is not None and h_eff.method in ("ewald", "pme")  # periodic: binned_ok
        lr_cuts = []
        if h_eff is not None and h_eff.method == "dsf":
            lr_cuts.append(self._lr_cutoff_override or h_eff.dsf_rc)
        if ewald_on:
            lr_cuts.append(_ewald_real_cutoff(h_eff, [mol]))
        d3 = self._d3_head()
        lr_cuts += [self._dftd3_cutoff_override or d3.cutoff] if d3 is not None else []
        lr_cut = max(lr_cuts) if lr_cuts else None

        safety = lr_safety = 1.5
        skin = max(self.reuse_skin, 0.0)
        while True:
            grid = dataclasses.replace(
                B.plan_bins(cell_np, n_real, self.cutoff + skin, extent=extent, safety=safety), margin=skin
            )
            lr_grid = (
                B.plan_lr_bins(cell_np, n_real, lr_cut, extent=extent, safety=lr_safety, margin=skin)
                if lr_cut is not None
                else None
            )
            sysb, perm, ovf = B.to_binned_system(system, grid, lr_grid)
            if not bool(ovf.any()):  # one host sync per prepare
                break
            safety *= 1.5
            lr_safety *= 1.5
            if safety > 32:
                raise RuntimeError("bin capacity planning failed")
        self._last_perm = perm.cpu().numpy()
        if ewald_on:
            sysb = attach_ewald(sysb, h_eff.ewald_accuracy, pme=h_eff.method == "pme")
        self._store_prep([mol], True, sysb, "binned", n_pad, perm=self._last_perm)
        return sysb

    def _prepare_indexed(
        self,
        mols: list[dict],
        n_real: int,
        n_pad: int,
        has_cell: bool,
        h_eff: LRCoulombHead | None,
        allow_binned: bool,
    ) -> System:
        """Molecules, batches and small boxes on the indexed layout.  The SR
        list is all intra-molecular pairs for gas-phase inputs up to 2,048
        atoms, else bounded by the cutoff (host cell list above 512 atoms).
        Long-range terms read one shared list, or a Coulomb and a D3 list
        when their cutoffs differ by more than 20%; simple Coulomb on a
        cutoff-bounded SR list needs all pairs (cutoff 1e6).  Every list
        reaches ``reuse_skin`` beyond its cutoff."""
        cutoff = self.cutoff if (has_cell or n_real > 2048) else None
        d3 = self._d3_head()
        d3_cut = (self._dftd3_cutoff_override or d3.cutoff) if d3 is not None else None
        coul_cut = None
        ewald_on = h_eff is not None and h_eff.method in ("ewald", "pme")
        if h_eff is not None:
            if h_eff.method == "dsf":
                coul_cut = self._lr_cutoff_override or h_eff.dsf_rc
            elif ewald_on:
                if not has_cell:
                    raise ValueError(f"{h_eff.method} Coulomb requires a periodic cell")
                # attach_ewald carries each molecule's eta and cutoffs
                coul_cut = _ewald_real_cutoff(h_eff, mols)
            elif cutoff is not None:  # simple Coulomb on a cutoff-bounded base list
                coul_cut = self._lr_cutoff_override or 1e6
        lr_cutoff = coulomb_cutoff = dftd3_cutoff = None
        if cutoff is not None:
            if d3_cut is not None and coul_cut is not None and max(d3_cut, coul_cut) / min(d3_cut, coul_cut) > 1.2:
                coulomb_cutoff, dftd3_cutoff = coul_cut, d3_cut
            elif d3_cut is not None or coul_cut is not None:
                lr_cutoff = max(c for c in (d3_cut, coul_cut) if c is not None)

        skin = max(self.reuse_skin, 0.0)

        def reach(c: float | None) -> float | None:
            return None if c is None else c + skin

        system = system_from_molecules(
            mols, self.device, n_pad=n_pad, cutoff=reach(cutoff), lr_cutoff=reach(lr_cutoff),
            coulomb_cutoff=reach(coulomb_cutoff), dftd3_cutoff=reach(dftd3_cutoff), build_nbmat=True,
        )
        if ewald_on:
            system = attach_ewald(system, h_eff.ewald_accuracy, pme=h_eff.method == "pme")
        self._store_prep(mols, allow_binned, system, "indexed", n_pad)
        return system

    def eval(
        self,
        data: Mapping[str, Any] | list | tuple,
        forces: bool = False,
        stress: bool = False,
        hessian: bool = False,
        *,
        validate_species: bool = True,
    ) -> dict[str, np.ndarray]:
        """Energy (per molecule, with the float64 SAE), charges, and forces,
        stress and the dense Hessian (n_real, 3, n_real, 3) as requested, in
        input atom order.  A Hessian runs on the indexed layout; for a batch
        it is taken per structure, and every key but ``energy`` is then a
        list over the structures, as in JAX."""
        if validate_species:
            self._validate_species_and_charge(data)
        if hessian:
            mols = _as_molecules(data)
            if len(mols) > 1:
                outs = [self.eval(m, forces=forces, stress=stress, hessian=True, validate_species=False)
                        for m in mols]
                res: dict[str, Any] = {"energy": np.concatenate([o["energy"] for o in outs])}
                for k in outs[0]:
                    if k != "energy":
                        res[k] = [o[k] for o in outs]
                return res
        system = self.prepare_system(data, allow_binned=not hessian)
        cfg_eff = self._effective_cfg(system.cell is not None)
        fn = self._get_fn(cfg_eff, forces, stress, hessian)
        out = fn(self.params, system)  # at the tier's precisions (``_get_fn``)
        return self._postprocess(out, system)

    __call__ = eval

    def _get_fn(self, cfg: AIMNet2Config, forces: bool, stress: bool, hessian: bool):
        """The evaluation ``f(params, system) -> outputs`` of a request, at
        the calculator's tier."""
        mm_prec, conv_prec = precision_tiers(self.precision)
        return derivatives.make_eval_fn(cfg, forces=forces, stress=stress, hessian=hessian, sae_external=True,
                                        matmul_precision=mm_prec, conv_precision=conv_prec)

    def hessian_vector_product(
        self, data: Mapping[str, Any] | list | tuple, v: np.ndarray, *, validate_species: bool = True
    ) -> np.ndarray:
        """Matrix-free ``H v`` (n_real, 3) on the indexed layout, ``v``
        (n_real, 3) in input atom order; the same Hamiltonian as
        ``eval(hessian=True)`` (periodic inputs switch simple Coulomb to
        DSF), at the calculator's precision tier."""
        if validate_species:
            self._validate_species_and_charge(data)
        system = self.prepare_system(data, allow_binned=False)
        cfg_eff = self._effective_cfg(system.cell is not None)
        n_real = int((system.numbers > 0).sum())
        v_pad = torch.zeros((system.natoms, 3), dtype=system.coord.dtype, device=self.device)
        v_pad[:n_real] = torch.as_tensor(np.asarray(v, dtype=np.float32).reshape(n_real, 3), device=self.device)
        mm_prec = precision_tiers(self.precision)[0]
        hv = derivatives.make_hvp_fn(cfg_eff, matmul_precision=mm_prec)(self.params, system, v_pad)
        return hv[:n_real].cpu().numpy()

    def _postprocess(self, out: Mapping[str, torch.Tensor], system: System) -> dict[str, np.ndarray]:
        """Host copies in input atom order (through ``perm`` on the binned
        layout; the indexed layout keeps it, real atoms first), per-molecule
        energies with the float64 SAE from the element counts."""
        fetched = {k: v.cpu().numpy() for k, v in out.items()}
        numbers_np = system.numbers.cpu().numpy()
        valid = numbers_np > 0
        n_real = int(valid.sum())
        res: dict[str, np.ndarray] = {}
        energy = fetched["energy"].astype(np.float64)
        if "mol_element_counts" in fetched:
            counts = fetched["mol_element_counts"].astype(np.float64)
            for sae64 in self.aux.get("sae", {}).values():
                k = min(counts.shape[1], len(sae64))
                energy = energy + counts[:, :k] @ np.asarray(sae64[:k], dtype=np.float64)
        res["energy"] = energy
        for k in ("charges", "spin_charges", "forces"):
            if k in fetched:
                res[k] = self._slots_to_compact(fetched[k], valid)
        for k in ("stress", "dipole", "quadrupole"):
            if k in fetched:
                res[k] = fetched[k]
        if "hessian" in fetched:  # the indexed layout: real atoms first
            res["hessian"] = derivatives.real_atom_hessian(fetched["hessian"], n_real)
        return res

    def _slots_to_compact(self, x: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Per-slot rows (``valid`` marks the real atoms) in input atom
        order: through ``perm`` on the binned layouts; the indexed layout
        keeps it, real atoms first."""
        n_real = int(valid.sum())
        if self._last_perm is None:
            return x[:n_real]
        compact = np.zeros((n_real,) + x.shape[1:], dtype=x.dtype)
        compact[self._last_perm[valid]] = x[valid]
        return compact
