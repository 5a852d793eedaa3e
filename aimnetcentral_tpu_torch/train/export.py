"""Export the port's parameters to a v2 ``.pt`` artifact (counterpart of
aimnetcentral_tpu/train/export.py).

The embedded long-range Coulomb is externalised (an SRCoulomb head stays in
the model and the metadata asks for an external Coulomb head), the
self-atomic energies are baked into the float64 atomic shifts, the
embedding rows of unimplemented species become NaN, the metadata is
validated before the file exists, and the save is atomic.  The state-dict
keys are the reference's, so an artifact written here loads in both
packages and in the reference.
"""

from __future__ import annotations

import dataclasses
import os
import stat
import tempfile
from typing import Any, Mapping

import numpy as np
import torch
import yaml

from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config
from aimnetcentral_tpu_torch.models.heads import (
    AtomicShiftHead,
    D3TSHead,
    DFTD3Head,
    LRCoulombHead,
    SRCoulombHead,
)
from aimnetcentral_tpu_torch.models.validation import validate_model_metadata


def _np(x: Any) -> np.ndarray:
    """A parameter leaf (a tensor on any device, or an array) as numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def params_to_state_dict(params: Mapping[str, Any], cfg: AIMNet2Config) -> dict:
    """The inverse of models/convert.py::convert_state_dict: the port's
    parameters in the reference's state-dict layout (numpy valued)."""
    sd: dict[str, np.ndarray] = {
        "afv.weight": _np(params["afv"]["weight"]),
        "aev.rc_s": _np(params["aev"]["rc_s"]),
        "aev.eta_s": _np(params["aev"]["eta_s"]),
        "aev.shifts_s": _np(params["aev"]["shifts_s"]),
        # a single-basis model mirrors _s into the dual basis's _v slots
        "aev.rc_v": _np(params["aev"]["rc_s"]),
        "aev.eta_v": _np(params["aev"]["eta_s"]),
        "aev.shifts_v": _np(params["aev"]["shifts_s"]),
        "conv_a.agh": _np(params["conv_a"]["agh"]),
        "conv_q.agh": _np(params["conv_q"]["agh"]),
    }

    def put_mlp(prefix: str, layers: list) -> None:
        for i, layer in enumerate(layers):
            sd[f"{prefix}.{2 * i}.weight"] = _np(layer["w"]).T
            sd[f"{prefix}.{2 * i}.bias"] = _np(layer["b"])

    for i, layers in enumerate(params["mlps"]):
        put_mlp(f"mlps.{i}", layers)

    for name, head in cfg.outputs:
        p = params["outputs"].get(name, {})
        if head.kind == "output":
            put_mlp(f"outputs.{name}.mlp", p["mlp"])
        elif head.kind == "atomic_shift":
            sd[f"outputs.{name}.shifts.weight"] = _np(p["weight"]).astype(np.float64).reshape(-1, 1)
        elif head.kind == "srrep":
            sd[f"outputs.{name}.params.weight"] = _np(p["gfn1_ab"])
        elif head.kind in ("dipole", "quadrupole"):
            sd[f"outputs.{name}.mass"] = _np(p["mass"])
        elif head.kind == "disp_param":
            sd[f"outputs.{name}.disp_param0"] = _np(p["disp_param0"])
        elif head.kind == "d3ts":
            sd[f"outputs.{name}.r4r2"] = _np(p["r4r2"])
        elif head.kind == "dftd3":
            for k in ("rcov", "r4r2", "c6ab", "cn_ref"):
                sd[f"outputs.{name}.{k}"] = _np(p[k])
        elif head.kind in ("srcoulomb", "lrcoulomb"):
            sd[f"outputs.{name}.rc"] = np.asarray(head.rc, dtype=np.float32)
    return sd


_HEAD_YAML = {
    "atomic_shift": ("AtomicShift", lambda h: {"key_in": h.key_in, "key_out": h.key_out}),
    "atomic_sum": ("AtomicSum", lambda h: {"key_in": h.key_in, "key_out": h.key_out}),
    "dipole": ("Dipole", lambda h: {"key_in": h.key_in, "key_out": h.key_out}),
    "quadrupole": ("Quadrupole", lambda h: {"key_in": h.key_in, "key_out": h.key_out}),
    "srrep": ("SRRep", lambda h: {"key_out": h.key_out, "rc": h.rc, "cutoff_fn": h.cutoff_fn}),
    "srcoulomb": (
        "SRCoulomb",
        lambda h: {"rc": h.rc, "key_in": h.key_in, "key_out": h.key_out, "envelope": h.envelope},
    ),
    "lrcoulomb": ("LRCoulomb", lambda h: {"rc": h.rc, "key_in": h.key_in, "key_out": h.key_out, "method": h.method}),
    # DispParam's only allowlisted path is the submodule spelling
    "disp_param": ("lr.DispParam", lambda h: {"key_in": h.key_in, "key_out": h.key_out}),
    "d3ts": (
        "D3TS",
        lambda h: {"a1": h.a1, "a2": h.a2, "s8": h.s8, "s6": h.s6, "key_in": h.key_in, "key_out": h.key_out},
    ),
    "dftd3": (
        "DFTD3",
        lambda h: {"s8": h.s8, "a1": h.a1, "a2": h.a2, "s6": h.s6, "cutoff": h.cutoff,
                   "smoothing_fraction": h.smoothing_fraction, "key_out": h.key_out},
    ),
}


def _head_to_yaml(head) -> dict:
    if head.kind == "output":
        return {
            "class": "aimnet.modules.Output",
            "kwargs": {
                "n_in": head.n_in,
                "n_out": head.n_out,
                "key_in": head.key_in,
                "key_out": head.key_out,
                "mlp": {
                    "hidden": list(head.mlp.hidden),
                    "activation_fn": "torch.nn.GELU",
                    "last_linear": head.mlp.last_linear,
                },
            },
        }
    cls, kw_fn = _HEAD_YAML[head.kind]
    return {"class": f"aimnet.modules.{cls}", "kwargs": kw_fn(head)}


def config_to_yaml(cfg: AIMNet2Config) -> dict:
    """The model YAML tree of ``cfg`` (the inverse of
    models/convert.py::config_from_yaml)."""
    return {
        "class": "aimnet.models.AIMNet2",
        "kwargs": {
            "nfeature": cfg.nfeature,
            "d2features": cfg.d2features,
            "ncomb_v": cfg.ncomb_v,
            "hidden": [list(h) for h in cfg.hidden],
            "aim_size": cfg.aim_size,
            "num_charge_channels": cfg.num_charge_channels,
            "aev": {"rc_s": cfg.aev.rc_s, "nshifts_s": cfg.aev.nshifts_s},
            "outputs": {name: _head_to_yaml(head) for name, head in cfg.outputs},
        },
    }


def _save_atomic(obj: Any, output: str) -> None:
    """``torch.save`` through a temporary file and a rename: a failure never
    replaces an existing destination, a re-export keeps the destination's
    mode, and a new file stays private (``mkstemp``'s 0600)."""
    d = os.path.dirname(os.path.abspath(output)) or "."
    os.makedirs(d, exist_ok=True)
    dest_mode = stat.S_IMODE(os.stat(output).st_mode) if os.path.exists(output) else None
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".pt.tmp")
    try:
        if dest_mode is not None:
            os.fchmod(fd, dest_mode)
        with os.fdopen(fd, "wb") as stream:
            fd = None
            torch.save(obj, stream)
        os.replace(tmp, output)
    except BaseException:
        if fd is not None:
            os.close(fd)
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def export_model(
    params: Mapping[str, Any],
    cfg: AIMNet2Config,
    output: str,
    sae: Mapping[int, float] | None = None,
    implemented_species: list[int] | None = None,
    shift_tables: Mapping[str, Any] | None = None,
    extra_metadata: Mapping[str, Any] | None = None,
) -> dict:
    """Write a v2 ``.pt`` artifact of ``(params, cfg)`` to ``output`` and
    return the artifact dict.

    An embedded LRCoulomb head becomes an SRCoulomb head with its ``rc`` and
    envelope, and the metadata asks for an external Coulomb head
    (``coulomb_mode: sr_embedded``); a DFTD3 head becomes ``d3_params``.
    ``sae`` (atomic number -> eV) is added to the first atomic-shift head's
    table in float64; ``shift_tables`` (the float64 tables of a converted
    legacy model) replace whole tables first.  With
    ``implemented_species`` the embedding rows of every other species
    (padding row 0 excepted) are NaN; without it the species are ``sae``'s.
    """
    lr_heads = [h for _n, h in cfg.outputs if isinstance(h, LRCoulombHead)]
    coulomb_mode, coulomb_sr_rc, coulomb_sr_envelope = "none", None, None
    outputs = list(cfg.outputs)
    if lr_heads:
        lr = lr_heads[0]
        coulomb_mode, coulomb_sr_rc, coulomb_sr_envelope = "sr_embedded", lr.rc, lr.envelope
        outputs = [(n, h) for n, h in outputs if not isinstance(h, LRCoulombHead)]
        outputs.append(
            ("srcoulomb", SRCoulombHead(rc=lr.rc, key_in=lr.key_in, key_out="energy", envelope=lr.envelope))
        )
    d3_heads = [h for _n, h in cfg.outputs if isinstance(h, DFTD3Head)]
    d3_params = None
    if d3_heads:
        h = d3_heads[0]
        d3_params = {"s6": h.s6, "s8": h.s8, "a1": h.a1, "a2": h.a2}
        outputs = [(n, hh) for n, hh in outputs if not isinstance(hh, DFTD3Head)]
    has_d3ts = any(isinstance(h, D3TSHead) for _n, h in cfg.outputs)
    export_cfg = dataclasses.replace(cfg, outputs=tuple(outputs))

    # the self-atomic energies, baked into the atomic shifts in float64
    params = {**params, "outputs": dict(params["outputs"])}
    shift_heads = [n for n, h in export_cfg.outputs if isinstance(h, AtomicShiftHead)]
    for name, table in (shift_tables or {}).items():
        if name in params["outputs"]:
            params["outputs"][name] = {**params["outputs"][name], "weight": np.asarray(table, dtype=np.float64)}
    if sae and shift_heads:
        name = shift_heads[0]
        w = _np(params["outputs"][name]["weight"]).astype(np.float64)
        for z, e in sae.items():
            w[z] += e
        params["outputs"][name] = {**params["outputs"][name], "weight": w}

    sd_np = params_to_state_dict(params, export_cfg)
    if implemented_species:
        # NaN rows for the species the model was not trained on, so that
        # evaluating one cannot pass unnoticed
        afv = sd_np["afv.weight"].copy()
        mask = np.ones(afv.shape[0], dtype=bool)
        mask[0] = False
        mask[[z for z in implemented_species if z < afv.shape[0]]] = False
        afv[mask] = np.nan
        sd_np["afv.weight"] = afv
    else:
        implemented_species = sorted(sae.keys()) if sae else []

    state_dict = {
        k: torch.tensor(v, dtype=torch.float64 if v.dtype == np.float64 else torch.float32) for k, v in sd_np.items()
    }
    artifact = {
        "format_version": 2,
        "model_yaml": yaml.safe_dump(config_to_yaml(export_cfg), sort_keys=False),
        "cutoff": float(cfg.aev.rc_s),
        "needs_coulomb": bool(lr_heads),
        "needs_dispersion": bool(d3_params),
        "coulomb_mode": coulomb_mode,
        "coulomb_sr_rc": coulomb_sr_rc,
        "coulomb_sr_envelope": coulomb_sr_envelope,
        "d3_params": d3_params,
        "has_embedded_lr": coulomb_mode == "sr_embedded" or has_d3ts,
        "has_embedded_d3ts": has_d3ts,
        "implemented_species": list(implemented_species),
        "state_dict": state_dict,
    }
    if extra_metadata:
        artifact.update(dict(extra_metadata))

    # the canonical validation, before the artifact can exist on disk
    meta_view = {k: v for k, v in artifact.items() if k not in ("state_dict", "model_yaml")}
    validate_model_metadata(
        meta_view,
        require_cutoff=True,
        require_structural_consistency=True,
        require_cross_field_consistency=True,
    )
    _save_atomic(artifact, output)
    return artifact
