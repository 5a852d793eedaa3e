"""Stand-ins for the integrations' outside packages, shared by the CPU tests
and ``chip_smoke.py`` (neither ASE nor TorchSim is installed where they
run).  Imports neither JAX nor either package.

- ``fake_ase(*modules)``: a minimal ``ase.calculators.calculator``
  (``Calculator`` with ``results``/``atoms``, ``all_changes``) installed in
  ``sys.modules`` while the named adapter modules are imported against it;
- ``FakeAtoms``: the ``ase.Atoms`` surface the adapters read;
- ``FakeSimState``: the TorchSim ``SimState`` surface;
- ``RecordingCalc``: a spy at the adapter's seam, recording each data dict,
  the keyword arguments and the call's wall time;
- ``CountingCalc``, ``SpyCalc``: canned results for the unit conversions
  and the data mapping.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
import time
import types

import numpy as np

_ASE_MODULES = ("ase", "ase.calculators", "ase.calculators.calculator")


class _Calculator:
    def __init__(self):
        self.results = {}
        self.atoms = None

    def calculate(self, atoms=None, properties=(), system_changes=None):
        if atoms is not None:
            self.atoms = atoms
        self.results = {}


@contextlib.contextmanager
def fake_ase(*module_names: str):
    """Install the fake ``ase`` package, import (or reload) each module of
    ``module_names`` against it and yield them; on exit restore
    ``sys.modules`` and reload the modules without it."""
    calc_mod = types.ModuleType("ase.calculators.calculator")
    calc_mod.Calculator = _Calculator
    calc_mod.all_changes = ["positions", "numbers", "cell", "pbc"]
    saved = {k: sys.modules.get(k) for k in _ASE_MODULES}
    sys.modules["ase"] = types.ModuleType("ase")
    sys.modules["ase.calculators"] = types.ModuleType("ase.calculators")
    sys.modules["ase.calculators.calculator"] = calc_mod
    mods = [importlib.reload(importlib.import_module(name)) for name in module_names]
    try:
        yield mods
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        for mod in mods:
            importlib.reload(mod)


class FakeAtoms:
    def __init__(self, positions, numbers, info=None, cell=None, pbc=False):
        self.positions = np.asarray(positions, dtype=np.float64)
        self.numbers = np.asarray(numbers)
        self.info = dict(info or {})
        self.cell = np.asarray(cell) if cell is not None else np.zeros((3, 3))
        self.pbc = np.asarray([pbc] * 3)

    def get_positions(self):
        return self.positions

    def get_atomic_numbers(self):
        return self.numbers

    def get_cell(self):
        return self.cell

    def __len__(self):
        return len(self.numbers)


def water_atoms(info=None, **kw) -> FakeAtoms:
    return FakeAtoms(
        positions=[[0.0, 0.0, 0.119], [0.0, 0.763, -0.477], [0.0, -0.763, -0.477]],
        numbers=[8, 1, 1],
        info=info,
        **kw,
    )


@dataclasses.dataclass
class FakeSimState:
    positions: object  # torch.Tensor (N, 3)
    atomic_numbers: object  # torch.Tensor (N,)
    system_idx: object = None  # torch.Tensor (N,) or None
    cell: object = None  # torch.Tensor (3, 3) or (B, 3, 3), lattice vectors as columns
    pbc: object = False
    extras: dict | None = None


class RecordingCalc:
    """Spy wrapper: records the data dict the adapter hands over, its
    keyword arguments and the wall time of the inner call."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []
        self.seconds = []

    def __call__(self, data, **kw):
        self.calls.append((dict(data), dict(kw)))
        t0 = time.perf_counter()
        out = self.inner(data, **kw)
        self.seconds.append(time.perf_counter() - t0)
        return out


class CountingCalc:
    """Stands in for a calculator: records calls, returns canned eV/A
    results sized to the input."""

    def __init__(self):
        self.calls = []

    def __call__(self, data, **kw):
        self.calls.append((np.asarray(data["coord"]).copy(), dict(kw)))
        n = len(data["numbers"])
        out = {"energy": np.array([-2.0]), "charges": np.zeros(n)}
        if kw.get("forces"):
            out["forces"] = np.full((n, 3), 0.5)
        if kw.get("hessian"):
            out["hessian"] = np.eye(3 * n).reshape(n, 3, n, 3) * 4.0
        return out


class SpyCalc:
    """Records the last data dict; returns zeros of the batch's shapes."""

    def __init__(self):
        self.last = None

    def __call__(self, data, **kw):
        self.last = dict(data)
        n_sys, n = np.asarray(data["coord"]).shape[:2]
        out = {"energy": np.zeros(n_sys), "forces": np.zeros((n_sys * n, 3))}
        if kw.get("stress"):
            out["stress"] = np.zeros((n_sys, 3, 3))
        return out
