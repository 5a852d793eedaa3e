"""Numerics validation across versions and devices (counterpart of
aimnetcentral_tpu/validation/observables.py).

A deterministic energy / force / charge dump for a fixed set of systems,
and a comparer with tolerances that returns a pass/fail report.  The dump's
header names the PyTorch version and the device it ran on; the comparer
reads a dump written by either package, so ``compare_observables(jax_dump,
port_dump)`` holds the port to the JAX package.  Across devices (CPU and
card) use the reference's tolerances: energy 1e-5 eV, forces 1e-4 eV/A.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

import numpy as np


def reference_systems() -> dict[str, dict[str, Any]]:
    """Fixed validation geometries: water, methane, a charged ion pair and a
    synthetic NaCl lattice (the JAX package's, number for number)."""
    water = {
        "coord": [[0.0, 0.0, 0.1193], [0.0, 0.7632, -0.4770], [0.0, -0.7632, -0.4770]],
        "numbers": [8, 1, 1],
    }
    methane = {
        "coord": [
            [0.0, 0.0, 0.0],
            [0.6293, 0.6293, 0.6293],
            [-0.6293, -0.6293, 0.6293],
            [-0.6293, 0.6293, -0.6293],
            [0.6293, -0.6293, -0.6293],
        ],
        "numbers": [6, 1, 1, 1, 1],
    }
    ion_pair = {
        "coord": [[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [5.5, 1.0, 0.0]],
        "numbers": [8, 1, 7],
        "charge": -1.0,
    }
    a = 5.64
    frac = np.array(
        [
            [0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5],
            [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [0.5, 0.5, 0.5],
        ]
    )
    nacl = {
        "coord": (frac * a).tolist(),
        "numbers": [11, 11, 11, 11, 17, 17, 17, 17],
        "cell": (np.eye(3) * a).tolist(),
    }
    return {"water": water, "methane": methane, "ion_pair": ion_pair, "nacl": nacl}


def _backend(calc) -> tuple[str, str]:
    """The calculator's device kind (``cuda`` or ``cpu``) and its name."""
    import torch

    dev = torch.device(getattr(calc, "device", "cpu"))
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(dev)
    return dev.type, "cpu"


def dump_observables(calc, path: str | None = None) -> dict[str, Any]:
    """Energy, forces and charges of every reference system."""
    import torch

    backend, device_name = _backend(calc)
    out: dict[str, Any] = {"torch_version": torch.__version__, "backend": backend, "device": device_name}
    for name, data in reference_systems().items():
        res = calc(dict(data), forces=True)
        out[name] = {
            "energy": res["energy"].tolist(),
            "forces": np.asarray(res["forces"]).tolist(),
            "charges": np.asarray(res["charges"]).tolist(),
        }
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    return out


def _origin(d: Mapping[str, Any]) -> str:
    """Which package and device wrote a dump: the port's header
    (``torch_version``, ``device``) or the JAX package's (``jax_version``)."""
    if "torch_version" in d:
        dev = d.get("device")
        where = d.get("backend") if dev in (None, d.get("backend")) else f"{d.get('backend')} {dev}"
        return f"{where} (torch {d['torch_version']})"
    return f"{d.get('backend')} (jax {d.get('jax_version')})"


def compare_observables(
    a: Mapping[str, Any] | str,
    b: Mapping[str, Any] | str,
    energy_atol: float = 1e-4,
    force_atol: float = 1e-4,
    charge_atol: float | None = None,
) -> tuple[bool, str]:
    """Tolerance comparison of two dumps (either package's); returns (ok,
    report).  ``charge_atol`` also compares the charges, where both dumps
    carry them."""

    def load(x):
        if isinstance(x, str):
            with open(x) as f:
                return json.load(f)
        return x

    da, db = load(a), load(b)
    lines = [f"backends: {_origin(da)} vs {_origin(db)}"]
    ok = True
    for name in reference_systems():
        if name not in da or name not in db:
            lines.append(f"{name}: MISSING")
            ok = False
            continue
        de = abs(np.asarray(da[name]["energy"]) - np.asarray(db[name]["energy"])).max()
        df = np.abs(np.asarray(da[name]["forces"]) - np.asarray(db[name]["forces"])).max()
        this_ok = de <= energy_atol and df <= force_atol
        line = f"{name}: dE={de:.2e} eV (atol {energy_atol}), max|dF|={df:.2e} eV/A (atol {force_atol})"
        if charge_atol is not None and "charges" in da[name] and "charges" in db[name]:
            dq = np.abs(np.asarray(da[name]["charges"]) - np.asarray(db[name]["charges"])).max()
            this_ok = this_ok and dq <= charge_atol
            line += f", max|dq|={dq:.2e} e (atol {charge_atol})"
        ok &= this_ok
        lines.append(f"{line} {'OK' if this_ok else 'FAIL'}")
    return ok, "\n".join(lines)
