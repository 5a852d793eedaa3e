"""AIMNet2Calculator: the inference facade (counterpart of
aimnetcentral_tpu/calculators/calculator.py, cut down to this port's slice).

One periodic structure at or above ``binned_threshold`` atoms goes onto the
binned layout (SR grid plus the coarse LR twin for DSF Coulomb), with a
capacity-regrow loop on bin overflow; ``eval`` returns energy, charges,
forces and stress in input atom order, with the self-atomic energies added
in float64 on the host.  The LR twin grid is planned on the largest
long-range cutoff (DSF Coulomb, DFT-D3).  Gas-phase inputs, batches, the
molecule-bin layout, Hessians, the ``fast``/``balanced`` tiers and
Ewald/PME raise with a pointer to ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

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


class AIMNet2Calculator:
    """Single-point energy / forces / stress on the binned periodic path.

    ``model`` is ``(params, cfg)`` or ``(params, cfg, aux)``; ``aux['sae']``
    holds float64 self-atomic-energy tables applied on the host.  Runs on
    ``device`` ("cuda" unless the caller asks for "cpu"); CUDA tensors run
    the hand-written conv and pair kernels, CPU tensors their plain versions.
    """

    def __init__(
        self,
        model: tuple,
        device: str | torch.device = "cuda",
        binned_threshold: int = 1024,
        reuse_skin: float = 0.6,
        precision: str = "exact",
    ):
        if precision in ("fast", "balanced"):
            raise NotImplementedError(f"precision={precision!r} {_NOT_PORTED}")
        if precision != "exact":
            raise ValueError(f"precision must be 'exact', 'balanced' or 'fast', got {precision!r}")
        self.device = resolve_device(device)  # also pins TF32 off: the exact tier
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

    @property
    def cutoff(self) -> float:
        return self.cfg.aev.rc_s

    def _effective_cfg(self, has_cell: bool) -> AIMNet2Config:
        """Periodic cells switch simple -> DSF Coulomb."""
        return auto_switch_simple_to_dsf(self.cfg) if has_cell else self.cfg

    def prepare_system(self, data: Mapping[str, Any]) -> System:
        mols = _as_molecules(data)
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
            if int(ovf) == 0:  # one host sync per prepare
                break
            safety *= 1.5
            lr_safety *= 1.5
            if safety > 32:
                raise RuntimeError("bin capacity planning failed")
        self._last_perm = perm.cpu().numpy()
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
