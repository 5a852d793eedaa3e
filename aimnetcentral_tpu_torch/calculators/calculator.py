"""AIMNet2Calculator: the inference facade (counterpart of
aimnetcentral_tpu/calculators/calculator.py, cut down to this port's slice).

One periodic structure at or above ``binned_threshold`` atoms goes onto the
binned layout (SR grid plus the coarse LR twin for DSF Coulomb), with a
capacity-regrow loop on bin overflow; ``eval`` returns energy, charges,
forces and stress in input atom order, with the self-atomic energies added
in float64 on the host.  The LR twin grid is planned on the largest
long-range cutoff (DSF Coulomb, DFT-D3).  While the topology is unchanged
and no atom moved more than ``reuse_skin / 2``, the prepared layout is
reused (the grids carry the skin as their stencil margin, so the result is
exact).  Every force evaluation runs inside its precision tier's context
(``precision_tiers``).  Gas-phase inputs, batches, the molecule-bin layout,
Hessians and Ewald/PME raise with a pointer to ROADMAP.md.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from aimnetcentral_tpu_torch.builders import system_from_molecules
from aimnetcentral_tpu_torch.calculators import derivatives
from aimnetcentral_tpu_torch.device import resolve_device
from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config
from aimnetcentral_tpu_torch.models.bridge import params_to
from aimnetcentral_tpu_torch.models.heads import DFTD3Head, LRCoulombHead, auto_switch_simple_to_dsf
from aimnetcentral_tpu_torch.ops import binned as B
from aimnetcentral_tpu_torch.system import System

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1)"
ATOM_BUCKET = 16  # the compact atom count is padded to a multiple of this


def precision_tiers(precision: str) -> str:
    """Map a precision tier to the matmul precision of its force
    evaluation, after the JAX package's mapping
    (calculators/calculator.py::precision_tiers):

    - ``exact``    -> "highest": full f32 matmuls (TF32 off);
    - ``balanced`` -> "highest": exact outside the conv kernels, which on
      the TPU split each operand for three bf16 passes.  The port's conv
      kernels contract in FP32 on the CUDA cores, at least as exact as that
      split, so ``balanced`` computes what ``exact`` does until a kernel
      uses the tensor cores (and then reads a conv precision of its own);
    - ``fast``     -> "default": TF32 matmuls.
    """
    if precision not in ("exact", "balanced", "fast"):
        raise ValueError(f"precision must be 'exact', 'balanced' or 'fast', got {precision!r}")
    return "default" if precision == "fast" else "highest"


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


def _as_molecules(data: Mapping[str, Any]) -> list[dict]:
    """One structure: coord (N, 3) or (1, N, 3), numbers, charge, mult, cell."""
    if isinstance(data, (list, tuple)):
        raise NotImplementedError(f"batched inputs: the molecule-bin layout {_NOT_PORTED}")
    coord = np.asarray(data["coord"], dtype=np.float32)
    numbers = np.asarray(data["numbers"])
    if coord.ndim == 3:
        if coord.shape[0] != 1:
            raise NotImplementedError(f"batched inputs: the molecule-bin layout {_NOT_PORTED}")
        coord, numbers = coord[0], numbers[0]
    real = numbers > 0
    mol = {
        "coord": coord[real],
        "numbers": numbers[real],
        "charge": float(np.asarray(data.get("charge", 0.0)).reshape(())),
    }
    if data.get("mult") is not None:
        mol["mult"] = float(np.asarray(data["mult"]).reshape(()))
    if data.get("cell") is not None:
        mol["cell"] = np.asarray(data["cell"], dtype=np.float32).reshape(3, 3)
    return [mol]


def _prep_key(mols: list[dict]) -> tuple:
    """What a reused layout must share with the new input: numbers, charge,
    mult and cell of every molecule."""
    return tuple(
        (
            np.asarray(m["numbers"]).tobytes(),
            float(m.get("charge", 0.0)),
            None if m.get("mult") is None else float(m["mult"]),
            None if m.get("cell") is None else np.asarray(m["cell"]).tobytes(),
        )
        for m in mols
    )


class AIMNet2Calculator:
    """Single-point energy / forces / stress on the binned periodic path.

    ``model`` is ``(params, cfg)`` or ``(params, cfg, aux)``; ``aux['sae']``
    holds float64 self-atomic-energy tables applied on the host.  Runs on
    ``device`` ("cuda" unless the caller asks for "cpu"); CUDA tensors run
    the hand-written conv and pair kernels, CPU tensors their plain versions.
    ``precision`` is a tier of ``precision_tiers``; ``reuse_skin`` (Angstrom)
    the Verlet skin of the prepared-layout reuse, 0 to rebuild every call.
    """

    def __init__(
        self,
        model: tuple,
        device: str | torch.device = "cuda",
        binned_threshold: int = 1024,
        reuse_skin: float = 0.6,
        precision: str = "exact",
    ):
        precision_tiers(precision)  # validate
        self.precision = precision
        self.device = resolve_device(device)
        if len(model) == 2:
            params, cfg = model
            aux: dict = {"sae": {}}
        else:
            params, cfg, aux = model
        self.params = params_to(params, self.device)
        self.cfg: AIMNet2Config = cfg
        self.aux = aux
        self.binned_threshold = binned_threshold
        self.reuse_skin = reuse_skin
        self._last_perm: np.ndarray | None = None
        self._prep_cache: dict | None = None

    @property
    def cutoff(self) -> float:
        return self.cfg.aev.rc_s

    def _effective_cfg(self, has_cell: bool) -> AIMNet2Config:
        """Periodic cells switch simple -> DSF Coulomb."""
        return auto_switch_simple_to_dsf(self.cfg) if has_cell else self.cfg

    # -- Verlet-style prepared-system reuse ---------------------------------

    def _store_prep(self, mols: list[dict], system: System, n_pad: int, perm: np.ndarray) -> None:
        """Keep the binned layout with the input it was built from and the
        per-atom lattice wrap of that input (padding rows at 1, as the
        builder fills them)."""
        if self.reuse_skin <= 0:
            return
        ref = np.concatenate([np.asarray(m["coord"], np.float32) for m in mols])
        cell = np.asarray(mols[0]["cell"], np.float32)
        compact0 = np.ones((n_pad, 3), np.float32)
        compact0[: len(ref)] = ref
        wrap = np.floor(compact0 @ np.linalg.inv(cell)).astype(np.float32)
        self._prep_cache = {
            "key": _prep_key(mols), "system": system, "ref": ref, "n_pad": n_pad,
            "perm": perm, "wrap": wrap, "cell": cell,
        }

    def _reuse_prepared(self, mols: list[dict]) -> System | None:
        """The cached layout with the new coordinates slotted in, while the
        topology is unchanged and no coordinate moved more than
        ``reuse_skin / 2`` since the build (the grids reach ``reuse_skin``
        beyond every cutoff, and every term masks at its own cutoff, so the
        result is exact); None otherwise."""
        c = self._prep_cache
        if c is None or self.reuse_skin <= 0 or c["key"] != _prep_key(mols):
            return None
        new = np.concatenate([np.asarray(m["coord"], np.float32) for m in mols])
        if new.shape != c["ref"].shape or np.abs(new - c["ref"]).max() > 0.5 * self.reuse_skin:
            return None
        compact = np.ones((c["n_pad"], 3), np.float32)
        compact[: len(new)] = new
        # the wrap CACHED at build time keeps an atom that crossed the box
        # boundary since continuous (its bin is stale by less than the skin,
        # which the grids' margin covers)
        compact = compact - c["wrap"] @ c["cell"]
        self._last_perm = c["perm"]
        return c["system"].replace(coord=torch.as_tensor(compact[c["perm"]], device=self.device))

    def prepare_system(self, data: Mapping[str, Any]) -> System:
        mols = _as_molecules(data)
        reused = self._reuse_prepared(mols)
        if reused is not None:
            return reused
        mol = mols[0]
        n_real = len(mol["numbers"])
        if "cell" not in mol:
            raise NotImplementedError(f"gas-phase inputs: the indexed layout {_NOT_PORTED}")
        if n_real < self.binned_threshold:
            raise NotImplementedError(
                f"{n_real} atoms is below binned_threshold={self.binned_threshold}: "
                f"the indexed layout {_NOT_PORTED}"
            )
        h_eff = next(
            (h for _n, h in self._effective_cfg(True).outputs if isinstance(h, LRCoulombHead)),
            None,
        )
        if h_eff is not None and h_eff.method != "dsf":
            raise NotImplementedError(f"{h_eff.method} Coulomb {_NOT_PORTED}")
        n_pad = _round_up(n_real + 1, ATOM_BUCKET)
        system = system_from_molecules(mols, self.device, n_pad=n_pad)
        cell_np = np.asarray(mol["cell"])
        # the coarse LR twin layout is sized by the largest LR cutoff, so its
        # stencil stays at radius 2
        lr_cuts = [h_eff.dsf_rc] if h_eff is not None else []
        lr_cuts += [h.cutoff for _n, h in self.cfg.outputs if isinstance(h, DFTD3Head)]
        lr_cut = max(lr_cuts) if lr_cuts else None

        safety = lr_safety = 1.5
        skin = max(self.reuse_skin, 0.0)
        while True:
            grid = dataclasses.replace(
                B.plan_bins(cell_np, n_real, self.cutoff + skin, safety=safety), margin=skin
            )
            lr_grid = (
                B.plan_lr_bins(cell_np, n_real, lr_cut, safety=lr_safety, margin=skin)
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
        self._store_prep(mols, sysb, n_pad, self._last_perm)
        return sysb

    def eval(
        self,
        data: Mapping[str, Any],
        forces: bool = False,
        stress: bool = False,
        hessian: bool = False,
    ) -> dict[str, np.ndarray]:
        system = self.prepare_system(data)
        cfg_eff = self._effective_cfg(system.cell is not None)
        fn = derivatives.make_eval_fn(
            cfg_eff, forces=forces, stress=stress, hessian=hessian, sae_external=True
        )
        with ambient_matmul_context(precision_tiers(self.precision)):
            out = fn(self.params, system)
        return self._postprocess(out, system)

    __call__ = eval

    def _postprocess(self, out: Mapping[str, torch.Tensor], system: System) -> dict[str, np.ndarray]:
        """Host copies in input atom order (through ``perm``), plus the
        float64 SAE from the per-molecule element counts."""
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
                x = fetched[k]
                compact = np.zeros((n_real,) + x.shape[1:], dtype=x.dtype)
                compact[self._last_perm[valid]] = x[valid]
                res[k] = compact
        if "stress" in fetched:
            res["stress"] = fetched["stress"]
        return res
