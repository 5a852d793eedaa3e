"""Version-drift harness of the PyTorch port: the observables dump of
tools/validate.py's model, with its committed weights, against the
committed baseline.

The baseline (tools/validate_baseline.json) and the weights
(tools/validate_weights.npz) are the JAX package's, written by
``tools/validate.py --pin``; this tool never rewrites them.  The weights
load into the port's parameter template without JAX: the template is
flattened as JAX flattens a tree (dict keys sorted, lists in order) and
leaf ``i`` of the file fills slot ``i``.

Usage:
    python tools/validate_torch.py --check                 # on the card
    python tools/validate_torch.py --check --device cpu    # plain versions
    python tools/validate_torch.py --dump out.json [--device cpu]

Tolerances are tools/validate.py's: energy 1e-5 eV, max-abs force
difference 1e-4 eV/A; charges 1e-5 e.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

WEIGHTS = os.path.join(_HERE, "validate_weights.npz")
BASELINE = os.path.join(_HERE, "validate_baseline.json")

ENERGY_ATOL = 1e-5
FORCE_ATOL = 1e-4
CHARGE_ATOL = 1e-5


def validation_model():
    """tools/validate.py's architecture in the port's classes: embedding,
    three message passes, energy MLP, atomic shift, DSF Coulomb, DFT-D3."""
    from aimnetcentral_tpu_torch.models.aimnet2 import AEVConfig, AIMNet2Config
    from aimnetcentral_tpu_torch.models.heads import (
        AtomicShiftHead,
        AtomicSumHead,
        DFTD3Head,
        LRCoulombHead,
        OutputHead,
    )
    from aimnetcentral_tpu_torch.models.modules import MLPSpec

    return AIMNet2Config(
        aev=AEVConfig(rc_s=5.0, nshifts_s=8),
        nfeature=4,
        d2features=True,
        ncomb_v=4,
        hidden=((32,), (32,), (32, 32)),
        aim_size=32,
        outputs=(
            (
                "energy_mlp",
                OutputHead(n_in=32, n_out=1, key_in="aim", key_out="energy",
                           mlp=MLPSpec(hidden=(16,), last_linear=True)),
            ),
            ("atomic_shift", AtomicShiftHead(key_in="energy", key_out="energy")),
            ("atomic_sum", AtomicSumHead(key_in="energy", key_out="energy")),
            ("lrcoulomb", LRCoulombHead(method="dsf", dsf_rc=10.0)),
            ("dftd3", DFTD3Head(s8=1.2, a1=0.4, a2=4.8, cutoff=10.0)),
        ),
    )


def _flatten(tree: Any) -> list:
    """The leaves in JAX's order: dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(tree: Any, leaves: list) -> Any:
    """``tree`` with its leaves replaced, in ``_flatten``'s order, from
    ``leaves`` (consumed from the front)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return leaves.pop(0)


def load_params(cfg, device: str = "cuda"):
    """The committed weights in the port's parameter tree of ``cfg``."""
    import numpy as np

    from aimnetcentral_tpu_torch.models import aimnet2_init
    from aimnetcentral_tpu_torch.models.bridge import params_from_numpy

    template = aimnet2_init(cfg, seed=0, device="cpu")
    slots = _flatten(template)
    with np.load(WEIGHTS) as z:
        if int(z["__n__"]) != len(slots):
            raise ValueError(f"{WEIGHTS} holds {int(z['__n__'])} leaves; the validation model has {len(slots)}")
        leaves = [np.asarray(z[f"p{i}"]) for i in range(len(slots))]
    for i, (slot, leaf) in enumerate(zip(slots, leaves)):
        if tuple(slot.shape) != leaf.shape:
            raise ValueError(f"leaf {i} of {WEIGHTS} has shape {leaf.shape}, the template {tuple(slot.shape)}")
    return params_from_numpy(_unflatten(template, leaves), device=device)


def build_calculator(device: str = "cuda"):
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator

    cfg = validation_model()
    return AIMNet2Calculator((load_params(cfg, device), cfg, {"sae": {}}), device=device)


def check(dump_path: str | None = None, device: str = "cuda") -> bool:
    """Dump on ``device`` and compare with the committed baseline; prints
    the report."""
    from aimnetcentral_tpu_torch.validation import compare_observables, dump_observables

    current = dump_observables(build_calculator(device), dump_path)
    ok, report = compare_observables(
        BASELINE, current, energy_atol=ENERGY_ATOL, force_atol=FORCE_ATOL, charge_atol=CHARGE_ATOL
    )
    print(report)
    return ok


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="compare with the committed baseline (the default)")
    ap.add_argument("--dump", metavar="PATH", help="write the dump here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.check or not args.dump:
        return 0 if check(args.dump, args.device) else 1
    from aimnetcentral_tpu_torch.validation import dump_observables

    dump_observables(build_calculator(args.device), args.dump)
    print(f"wrote {args.dump}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
