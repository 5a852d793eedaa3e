"""Hand-made legacy ``.jpt`` archives for the tests of both packages and for
chip_smoke.py (imports no JAX).

A released v1 archive is a scripted reference model.  What a loader reads
of it is its ``state_dict()`` (the reference's keys), the root's
``cutoff`` and each output head's class name and constructor attributes,
which TorchScript keeps.  ``make_introspectable_jpt`` scripts stand-in
modules that carry exactly these: the parameters as buffers at the
reference's paths, heads named after the reference's classes with the
YAML's scalar keyword arguments as attributes.  ``rc``, ``n_in``,
``n_out`` and ``num_types`` stay out of the attributes, as in a real
archive, where they are buffers or shapes.  The stand-ins' ``forward``
does nothing; no loader calls it.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


class Skeleton(torch.nn.Module):
    def __init__(self, **attrs: Any):
        super().__init__()
        for k, v in attrs.items():
            setattr(self, k, v)

    def forward(self) -> int:
        return 0


class AIMNet2(Skeleton):
    pass


class Output(Skeleton):
    pass


class AtomicShift(Skeleton):
    pass


class AtomicSum(Skeleton):
    pass


class LRCoulomb(Skeleton):
    pass


class SRCoulomb(Skeleton):
    pass


class Dipole(Skeleton):
    pass


class Quadrupole(Skeleton):
    pass


class SRRep(Skeleton):
    pass


class DispParam(Skeleton):
    pass


class D3TS(Skeleton):
    pass


class DFTD3(Skeleton):
    pass


class Weird(Skeleton):
    """A head class outside the v1 set."""


HEAD_CLASSES = {c.__name__: c for c in (Output, AtomicShift, AtomicSum, LRCoulomb, SRCoulomb, Dipole, Quadrupole,
                                        SRRep, DispParam, D3TS, DFTD3, Weird)}
NOT_ATTRIBUTES = ("rc", "n_in", "n_out", "num_types")


def _tensor(val) -> torch.Tensor:
    """A state-dict value (a tensor or a numpy array) as a tensor of its
    own dtype (the atomic shifts stay float64)."""
    if isinstance(val, torch.Tensor):
        return val.detach().clone()
    return torch.from_numpy(np.array(val))


def _place_buffer(root: torch.nn.Module, key: str, val) -> None:
    parts = key.split(".")
    mod = root
    for p in parts[:-1]:
        if not hasattr(mod, p) or not hasattr(getattr(mod, p), "add_module"):
            mod.add_module(p, Skeleton())
        mod = getattr(mod, p)
    mod.register_buffer(parts[-1], _tensor(val))


def make_introspectable_jpt(sd: Mapping[str, Any], yaml_cfg: Mapping[str, Any], cutoff: float, path: str,
                            head_class_override: Mapping[str, str] | None = None) -> None:
    """Script and save at ``path`` an archive shaped like a v1 ``.jpt`` of
    the model YAML tree ``yaml_cfg`` with the reference-layout state dict
    ``sd`` (tensors or numpy arrays) and the root ``cutoff``.
    ``head_class_override`` maps a head's name to another class name of
    ``HEAD_CLASSES`` (``"Weird"``: a class outside the v1 set)."""
    kw = yaml_cfg["kwargs"]
    root = AIMNet2(
        cutoff=float(cutoff),
        nfeature=int(kw["nfeature"]),
        d2features=bool(kw.get("d2features", False)),
        num_charge_channels=int(kw.get("num_charge_channels", 1)),
    )
    for key, val in sd.items():
        if not key.startswith("outputs."):
            _place_buffer(root, key, val)
    outs = Skeleton()
    for name, hcfg in kw["outputs"].items():
        cls_name = hcfg["class"].rsplit(".", 1)[-1]
        cls_name = (head_class_override or {}).get(name, cls_name)
        hkw = dict(hcfg.get("kwargs", {}))
        mlp = hkw.pop("mlp", None)
        attrs = {k: v for k, v in hkw.items()
                 if isinstance(v, (bool, int, float, str)) and k not in NOT_ATTRIBUTES}
        head = HEAD_CLASSES[cls_name](**attrs)
        if mlp is not None:
            head.add_module("mlp", Skeleton(last_linear=bool(mlp.get("last_linear", True))))
        prefix = f"outputs.{name}."
        for key, val in sd.items():
            if key.startswith(prefix):
                _place_buffer(head, key[len(prefix):], val)
        outs.add_module(name, head)
    root.add_module("outputs", outs)
    torch.jit.script(root).save(path)
