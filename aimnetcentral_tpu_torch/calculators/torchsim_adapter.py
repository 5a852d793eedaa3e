"""TorchSim model adapter (counterpart of
aimnetcentral_tpu/calculators/torchsim_adapter.py), import-gated on
``torch_sim``.

Maps a TorchSim ``SimState`` (positions, cell, atomic_numbers, system_idx:
torch tensors) onto the calculator: a state of several systems becomes one
zero-padded (B, N, 3) batch (``system_idx`` picks each system's atoms),
per-system charge and multiplicity ride in ``extras``, and stress needs a
periodic cell.  The results come back as tensors on the state's device
(energy, forces and stress in float64), detached from any graph.
"""

from __future__ import annotations

import numpy as np
import torch

try:
    import torch_sim  # noqa: F401

    TORCHSIM_AVAILABLE = True
except ImportError:  # pragma: no cover
    TORCHSIM_AVAILABLE = False


class AIMNet2TorchSim:
    """Duck-typed on the SimState attributes (positions, cell, pbc,
    atomic_numbers, system_idx, extras): torch_sim itself is needed only by
    the simulation loop around it, so construction works without it."""

    def __init__(self, base_calc, compute_stress: bool = False):
        self.base_calc = base_calc
        self.compute_stress = compute_stress

    @staticmethod
    def _state_to_data(state) -> dict:
        pos = state.positions.detach().cpu().numpy().astype(np.float32)
        numbers = state.atomic_numbers.detach().cpu().numpy()
        sys_idx = (
            state.system_idx.detach().cpu().numpy()
            if getattr(state, "system_idx", None) is not None
            else np.zeros(len(numbers), dtype=np.int64)
        )
        n_sys = int(sys_idx.max()) + 1 if len(sys_idx) else 1
        coords, zss = [], []
        for b in range(n_sys):
            sel = sys_idx == b
            coords.append(pos[sel])
            zss.append(numbers[sel])
        nmax = max(len(z) for z in zss)
        coord = np.zeros((n_sys, nmax, 3), dtype=np.float32)
        zs = np.zeros((n_sys, nmax), dtype=np.int64)
        for b in range(n_sys):
            coord[b, : len(zss[b])] = coords[b]
            zs[b, : len(zss[b])] = zss[b]
        data = {"coord": coord, "numbers": zs}
        cell = getattr(state, "cell", None)
        if cell is not None and getattr(state, "pbc", None) is not None:
            pbc = state.pbc
            if (hasattr(pbc, "any") and pbc.any()) or pbc is True:
                c = cell.detach().cpu().numpy().astype(np.float32)
                # TorchSim's cells hold the lattice vectors as columns; ours as rows
                data["cell"] = np.swapaxes(c, -1, -2) if c.ndim == 3 else c.T
        extras = getattr(state, "extras", None) or {}
        if "charge" in extras:
            charge = np.asarray(extras["charge"], dtype=np.float32).reshape(-1)
            if charge.shape[0] != n_sys:
                raise ValueError(f"extras['charge'] has {charge.shape[0]} entries for {n_sys} systems")
            data["charge"] = charge
        # "mult" (AIMNet2 style) and "spin" (MACE style) both name the
        # multiplicity; mult wins when both are given
        mult = extras.get("mult", extras.get("spin"))
        if mult is not None:
            mult = np.asarray(mult, dtype=np.float32).reshape(-1)
            if mult.shape[0] != n_sys:
                raise ValueError(f"extras['mult'] has {mult.shape[0]} entries for {n_sys} systems")
            data["mult"] = mult
        return data

    def __call__(self, state) -> dict:
        data = self._state_to_data(state)
        if self.compute_stress and "cell" not in data:
            raise ValueError("stress requires a periodic cell")
        out = self.base_calc(data, forces=True, stress=self.compute_stress)
        dev = state.positions.device
        res = {
            "energy": torch.as_tensor(out["energy"], device=dev),
            "forces": torch.as_tensor(np.asarray(out["forces"], dtype=np.float64), device=dev),
        }
        if "stress" in out:
            s = np.asarray(out["stress"], dtype=np.float64)
            res["stress"] = torch.as_tensor(np.ascontiguousarray(np.swapaxes(s, -1, -2)), device=dev)
        return res
