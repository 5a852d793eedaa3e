"""Conversion of AIMNet2 v2 artifacts (model YAML plus a torch state dict)
into the port's config dataclasses and parameter dicts (counterpart of
aimnetcentral_tpu/models/convert.py).

The model YAML is a ``class:/kwargs:`` tree; state-dict tensors map one to
one onto the parameter dict, Linear weights transposed to (in, out).  The
float64 atomic shifts (the baked self-atomic energies) are kept as float64
numpy tables in ``aux["sae"]``, which the calculator applies on the host.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Mapping

import numpy as np
import torch

from aimnetcentral_tpu_torch.models.aimnet2 import AEVConfig, AIMNet2Config
from aimnetcentral_tpu_torch.models.heads import (
    AtomicShiftHead,
    AtomicSumHead,
    D3TSHead,
    DFTD3Head,
    DipoleHead,
    DispParamHead,
    HeadSpec,
    LRCoulombHead,
    OutputHead,
    QuadrupoleHead,
    SRCoulombHead,
    SRRepHead,
)
from aimnetcentral_tpu_torch.models.modules import MLPSpec


def _mlp_spec_from_cfg(mlp_cfg: Mapping[str, Any] | None) -> MLPSpec:
    mlp_cfg = mlp_cfg or {}
    act = mlp_cfg.get("activation_fn", "gelu")
    if isinstance(act, str) and act.endswith("GELU"):
        act = "gelu"
    return MLPSpec(
        hidden=tuple(mlp_cfg.get("hidden", ()) or ()),
        activation=act if isinstance(act, str) else "gelu",
        last_linear=bool(mlp_cfg.get("last_linear", True)),
    )


_HEAD_BUILDERS = {
    "Output": lambda kw: OutputHead(
        n_in=kw["n_in"],
        n_out=kw["n_out"],
        key_in=kw["key_in"],
        key_out=kw["key_out"],
        mlp=_mlp_spec_from_cfg(kw.get("mlp")),
    ),
    "AtomicShift": lambda kw: AtomicShiftHead(
        key_in=kw["key_in"],
        key_out=kw["key_out"],
        num_types=kw.get("num_types", 64),
        reduce_sum=kw.get("reduce_sum", False),
    ),
    "AtomicSum": lambda kw: AtomicSumHead(key_in=kw["key_in"], key_out=kw["key_out"]),
    "LRCoulomb": lambda kw: LRCoulombHead(
        key_in=kw.get("key_in", "charges"),
        key_out=kw.get("key_out", "e_h"),
        rc=kw.get("rc", 4.6),
        method=kw.get("method", "simple"),
        dsf_alpha=kw.get("dsf_alpha", 0.2),
        dsf_rc=kw.get("dsf_rc", 15.0),
        ewald_accuracy=kw.get("ewald_accuracy", 1e-6),
        subtract_sr=kw.get("subtract_sr", True),
        envelope=kw.get("envelope", "exp"),
    ),
    "SRCoulomb": lambda kw: SRCoulombHead(
        rc=kw.get("rc", 4.6),
        key_in=kw.get("key_in", "charges"),
        key_out=kw.get("key_out", "energy"),
        envelope=kw.get("envelope", "exp"),
    ),
    "DFTD3": lambda kw: DFTD3Head(
        s8=kw["s8"],
        a1=kw["a1"],
        a2=kw["a2"],
        s6=kw.get("s6", 1.0),
        cutoff=kw.get("cutoff", 15.0),
        smoothing_fraction=kw.get("smoothing_fraction", 0.2),
        key_out=kw.get("key_out", "energy"),
    ),
    "D3TS": lambda kw: D3TSHead(
        a1=kw["a1"],
        a2=kw["a2"],
        s8=kw["s8"],
        s6=kw.get("s6", 1.0),
        key_in=kw.get("key_in", "disp_param"),
        key_out=kw.get("key_out", "energy"),
    ),
    "DispParam": lambda kw: DispParamHead(
        key_in=kw.get("key_in", "disp_param"), key_out=kw.get("key_out", "disp_param")
    ),
    "Dipole": lambda kw: DipoleHead(
        key_in=kw.get("key_in", "charges"),
        key_out=kw.get("key_out", "dipole"),
        center_coord=kw.get("center_coord", False),
    ),
    "Quadrupole": lambda kw: QuadrupoleHead(
        key_in=kw.get("key_in", "charges"),
        key_out=kw.get("key_out", "quadrupole"),
        center_coord=kw.get("center_coord", False),
    ),
    "SRRep": lambda kw: SRRepHead(
        key_out=kw.get("key_out", "e_rep"),
        cutoff_fn=kw.get("cutoff_fn", "none"),
        rc=kw.get("rc", 5.2),
        reduce_sum=kw.get("reduce_sum", True),
    ),
}


def register_head_builder(name: str, builder) -> None:
    """Register a third-party output-head builder so that artifacts naming
    it convert (pair it with ``model_import_paths`` on load: the import
    policy gates which class paths are accepted, this registry what they
    construct)."""
    if name in _HEAD_BUILDERS:
        raise ValueError(f"head builder {name!r} is already registered")
    _HEAD_BUILDERS[name] = builder


def head_from_config(class_path: str, kwargs: Mapping[str, Any]) -> HeadSpec:
    name = class_path.rsplit(".", 1)[-1]
    if name not in _HEAD_BUILDERS:
        raise ValueError(f"unsupported output head class {class_path!r}")
    return _HEAD_BUILDERS[name](dict(kwargs))


def config_from_yaml(model_cfg: Mapping[str, Any]) -> AIMNet2Config:
    """Build the port's AIMNet2Config from a model YAML tree.

    The dual-basis AEV keys (``rc_v``, ``eta_v``, ``shifts_v``) are accepted
    and inert, as in the reference, whose forward reads the scalar basis
    only; ``nshifts_v`` different from ``nshifts_s`` is refused, since the
    reference cannot run such a model either."""
    cls = model_cfg.get("class", "aimnet.models.AIMNet2")
    if not cls.rsplit(".", 1)[-1].startswith("AIMNet2"):
        raise ValueError(f"unsupported model class {cls!r}")
    kw = model_cfg["kwargs"]
    aev_kw = dict(kw.get("aev", {}))
    nshifts_s = aev_kw.get("nshifts_s", 16)
    nshifts_v = aev_kw.get("nshifts_v") or nshifts_s
    if nshifts_v != nshifts_s:
        raise ValueError(
            "nshifts_v must equal nshifts_s (the reference cannot run such "
            "models either: ConvSV's agh contraction requires matching shift counts)"
        )
    aev = AEVConfig(
        rmin=aev_kw.get("rmin", 0.8),
        rc_s=aev_kw.get("rc_s", 5.0),
        nshifts_s=nshifts_s,
        eta_s=aev_kw.get("eta_s"),
    )
    outputs_cfg = kw.get("outputs", {})
    if isinstance(outputs_cfg, Mapping):
        items = list(outputs_cfg.items())
    else:  # list form
        items = [(f"head_{i}", h) for i, h in enumerate(outputs_cfg)]
    outputs = tuple((name, head_from_config(h["class"], h.get("kwargs", {}))) for name, h in items)
    return AIMNet2Config(
        aev=aev,
        nfeature=kw["nfeature"],
        d2features=kw.get("d2features", False),
        ncomb_v=kw.get("ncomb_v", 12),
        hidden=tuple(tuple(h) for h in kw["hidden"]),
        aim_size=kw["aim_size"],
        num_charge_channels=kw.get("num_charge_channels", 1),
        outputs=outputs,
    )


def convert_state_dict(sd: Mapping[str, Any], cfg: AIMNet2Config) -> tuple[dict, dict]:
    """Map a v2 state dict (numpy valued) onto the port's
    parameter dict: float32 tensors on the CPU, ready for ``params_to``.

    Returns ``(params, aux)``; ``aux["sae"]`` maps atomic-shift head names
    to float64 per-element numpy tables, applied on the host by the
    calculator.  A checked load: a missing parameter raises ``ValueError``
    naming it; keys the config does not consume give ONE warning listing
    them (the inert dual-basis ``aev.*_v`` buffers, leftover dipole and
    quadrupole masses and the Coulomb heads' ``rc`` buffers stay silent).
    """
    raw = {k: np.asarray(v) for k, v in sd.items()}
    consumed: set[str] = set()

    class _Tracking(dict):
        def __getitem__(self, k):
            try:
                v = dict.__getitem__(self, k)
            except KeyError:
                raise ValueError(
                    f"state dict is missing parameter {k!r} required by this model config"
                ) from None
            consumed.add(k)
            return v

    sd = _Tracking(raw)

    def f32(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # keeps 0-d leaves 0-d

    params: dict = {
        "afv": {"weight": f32(sd["afv.weight"])},
        "aev": {
            "rc_s": f32(sd["aev.rc_s"]),
            "eta_s": f32(sd["aev.eta_s"]),
            "shifts_s": f32(sd["aev.shifts_s"]),
        },
        "conv_a": {"agh": f32(sd["conv_a.agh"])},
        "conv_q": {"agh": f32(sd["conv_q.agh"])},
    }

    def convert_mlp(prefix: str) -> list[dict]:
        idxs = sorted(
            {int(m.group(1)) for k in sd if (m := re.match(re.escape(prefix) + r"\.(\d+)\.weight$", k))}
        )
        return [{"w": f32(sd[f"{prefix}.{i}.weight"].T), "b": f32(sd[f"{prefix}.{i}.bias"])} for i in idxs]

    params["mlps"] = [convert_mlp(f"mlps.{i}") for i in range(len(cfg.hidden))]

    aux: dict = {"sae": {}}
    outputs: dict = {}
    for name, head in cfg.outputs:
        p = f"outputs.{name}"
        if head.kind == "output":
            outputs[name] = {"mlp": convert_mlp(f"{p}.mlp")}
        elif head.kind == "atomic_shift":
            w64 = np.asarray(sd[f"{p}.shifts.weight"], dtype=np.float64).reshape(-1)
            aux["sae"][name] = w64
            outputs[name] = {"weight": f32(w64)}
        elif head.kind == "srrep":
            outputs[name] = {"gfn1_ab": f32(sd[f"{p}.params.weight"])}
        elif head.kind in ("dipole", "quadrupole"):
            outputs[name] = {"mass": f32(sd[f"{p}.mass"])}
        elif head.kind == "disp_param":
            outputs[name] = {"disp_param0": f32(sd[f"{p}.disp_param0"])}
        elif head.kind == "d3ts":
            outputs[name] = {"r4r2": f32(sd[f"{p}.r4r2"])}
        elif head.kind == "dftd3":
            outputs[name] = {k: f32(sd[f"{p}.{k}"]) for k in ("rcov", "r4r2", "c6ab", "cn_ref")}
        else:
            outputs[name] = {}
    params["outputs"] = outputs
    ignored = (
        "aev.rc_v", "aev.eta_v", "aev.shifts_v",  # inert dual basis
        "outputs.dipole.mass", "outputs.quadrupole.mass",  # heads older artifacts no longer declare
    )
    unexpected = sorted(
        k
        for k in raw
        if k not in consumed
        and k not in ignored
        # the Coulomb heads' rc buffers repeat the YAML config
        and not (k.startswith("outputs.") and k.endswith(".rc"))
    )
    if unexpected:
        warnings.warn(
            f"state dict has {len(unexpected)} parameter(s) this model config "
            f"does not consume: {unexpected[:8]}" + (" ..." if len(unexpected) > 8 else ""),
            stacklevel=2,
        )
    return params, aux
