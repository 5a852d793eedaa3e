"""Legacy v1 ``.jpt`` (TorchScript) archives: the architecture read back from
the scripted module, and the conversion to a v2 ``.pt`` artifact
(counterpart of aimnetcentral_tpu/models/convert_v1.py).

An archive is read on the host with ``torch.jit.load(..., map_location=
"cpu")``: its ``state_dict()``, the root's ``cutoff`` and each output head's
class name and attributes.  Its ``forward`` is never called.  A TorchScript
archive holds executable code: load only archives whose source you trust.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
import yaml

from aimnetcentral_tpu_torch.models.convert import config_from_yaml, convert_state_dict
from aimnetcentral_tpu_torch.models.loader import LoadedModel
from aimnetcentral_tpu_torch.train.export import export_model


def extract_species_from_afv(afv_weight: np.ndarray) -> list[int]:
    """The implemented species: embedding rows that hold no NaN and are not
    all zero, the padding row 0 excepted."""
    ok = ~np.isnan(afv_weight).any(axis=-1)
    nonzero = np.abs(afv_weight).sum(axis=-1) > 0
    return [int(z) for z in np.nonzero(ok & nonzero)[0] if z > 0]


def _jattr(mod: Any, name: str, default: Any = None) -> Any:
    """A Python attribute kept on a (scripted) module, or ``default``; a
    one-element tensor comes back as its number."""
    try:
        v = getattr(mod, name)
    except (AttributeError, RuntimeError):
        return default
    if hasattr(v, "item") and getattr(v, "numel", lambda: 2)() == 1:
        return v.item()
    return v


def _original_name(mod: Any) -> str:
    """The class name of a scripted submodule (``RecursiveScriptModule``
    keeps the original's; a plain module gives its type's)."""
    return str(getattr(mod, "original_name", "") or type(mod).__name__)


def _mlp_layer_shapes(sd: Mapping[str, np.ndarray], prefix: str) -> list[tuple[int, int]]:
    """(out, in) shapes of the Linear layers ``{prefix}.{i}.weight`` in order."""
    idxs = sorted(int(m.group(1)) for k in sd if (m := re.match(re.escape(prefix) + r"\.(\d+)\.weight$", k)))
    if not idxs:
        raise ValueError(f"no MLP layers found under {prefix!r}")
    return [tuple(sd[f"{prefix}.{i}.weight"].shape) for i in idxs]


def _head_config_from_scripted(name: str, mod: Any, sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """One output head's ``class:/kwargs:`` entry, from the scripted head's
    class name and attributes and its buffers in the state dict (``rc`` is
    a float32 buffer, so it comes back rounded to float32)."""
    cls = _original_name(mod)
    p = f"outputs.{name}"
    kw: dict[str, Any] = {}

    def keys(default_in: str, default_out: str) -> None:
        kw["key_in"] = str(_jattr(mod, "key_in", default_in))
        kw["key_out"] = str(_jattr(mod, "key_out", default_out))

    def buffer_rc() -> float:
        return float(np.asarray(sd[f"{p}.rc"]).reshape(()))

    if cls == "Output":
        shapes = _mlp_layer_shapes(sd, f"{p}.mlp")
        keys("aim", "energy")
        kw.update(
            n_in=shapes[0][1],
            n_out=shapes[-1][0],
            mlp={
                "activation_fn": "torch.nn.GELU",
                "last_linear": bool(_jattr(getattr(mod, "mlp", None), "last_linear", True)),
                "hidden": [s[0] for s in shapes[:-1]],
            },
        )
    elif cls == "AtomicShift":
        keys("energy", "energy")
        kw["num_types"] = int(sd[f"{p}.shifts.weight"].shape[0])
        kw["reduce_sum"] = bool(_jattr(mod, "reduce_sum", False))
    elif cls == "AtomicSum":
        keys("energy", "energy")
    elif cls == "LRCoulomb":
        keys("charges", "energy")
        kw.update(
            rc=buffer_rc(),
            method=str(_jattr(mod, "method", "simple")),
            dsf_alpha=float(_jattr(mod, "dsf_alpha", 0.2)),
            dsf_rc=float(_jattr(mod, "dsf_rc", 15.0)),
            ewald_accuracy=float(_jattr(mod, "ewald_accuracy", 1e-6)),
            subtract_sr=bool(_jattr(mod, "subtract_sr", True)),
            envelope=str(_jattr(mod, "envelope", "exp")),
        )
    elif cls == "SRCoulomb":
        keys("charges", "energy")
        kw["rc"] = buffer_rc()
        kw["envelope"] = str(_jattr(mod, "envelope", "exp"))
    elif cls in ("Dipole", "Quadrupole"):
        keys("charges", "dipole" if cls == "Dipole" else "quadrupole")
        kw["center_coord"] = bool(_jattr(mod, "center_coord", False))
    elif cls == "SRRep":
        kw["key_out"] = str(_jattr(mod, "key_out", "e_rep"))
        kw["cutoff_fn"] = str(_jattr(mod, "cutoff_fn", "none"))
        kw["rc"] = buffer_rc()
        kw["reduce_sum"] = bool(_jattr(mod, "reduce_sum", True))
    elif cls == "DispParam":
        keys("disp_param", "disp_param")
    elif cls in ("D3TS", "DFTD3", "D3BJ"):
        for attr in ("s8", "a1", "a2"):
            v = _jattr(mod, attr)
            if v is None:
                raise ValueError(
                    f"head {name!r} ({cls}): damping parameter {attr!r} is not "
                    "recoverable from this TorchScript archive; convert with an "
                    "explicit architecture YAML instead"
                )
            kw[attr] = float(v)
        kw["s6"] = float(_jattr(mod, "s6", 1.0))
        if cls == "D3TS":
            keys("disp_param", "energy")
        else:
            cls = "DFTD3"
            kw["key_out"] = str(_jattr(mod, "key_out", "energy"))
            cutoff = _jattr(mod, "cutoff")
            if cutoff is not None:
                kw["cutoff"] = float(cutoff)
    else:
        raise ValueError(
            f"output head {name!r} has unrecognized class {cls!r}; this "
            ".jpt cannot be loaded by introspection — convert it with an "
            "explicit architecture YAML (`aimnet-torch convert --model-yaml`)"
        )
    return {"class": f"aimnet.modules.{cls}", "kwargs": kw}


def infer_model_yaml_from_scripted(jit_model: Any) -> dict[str, Any]:
    """The model YAML tree (``class:/kwargs:``) of a legacy TorchScript
    model: the core's widths from its parameters' shapes (``conv_*.agh`` is
    (nchannel, nshifts, ncomb), the ``afv`` width tells ``d2features``, the
    MLPs' Linear shapes give ``hidden`` and ``aim_size``), each head from
    its class name and attributes.  ``ValueError`` for a head outside the
    closed v1 set: convert such an archive with an explicit YAML."""
    sd = {k: v.detach().cpu().numpy() for k, v in jit_model.state_dict().items()}

    nfeature, _nshifts_v, ncomb_v = sd["conv_a.agh"].shape
    nshifts_s = int(sd["aev.shifts_s"].shape[-1])
    num_charge_channels = int(_jattr(jit_model, "num_charge_channels", sd["conv_q.agh"].shape[0]))
    afv_width = int(sd["afv.weight"].shape[-1])
    d2features = bool(_jattr(jit_model, "d2features", afv_width == nfeature * nshifts_s and nshifts_s > 1))

    n_mlps = len({int(m.group(1)) for k in sd if (m := re.match(r"mlps\.(\d+)\.", k))})
    hidden = [[s[0] for s in _mlp_layer_shapes(sd, f"mlps.{i}")[:-1]] for i in range(n_mlps)]
    aim_size = int(_mlp_layer_shapes(sd, f"mlps.{n_mlps - 1}")[-1][0])

    # the heads in their registration order
    outputs = {
        str(name): _head_config_from_scripted(str(name), mod, sd)
        for name, mod in jit_model.outputs.named_children()
    }
    return {
        "class": "aimnet.models.AIMNet2",
        "kwargs": {
            "nfeature": int(nfeature),
            "d2features": d2features,
            "ncomb_v": int(ncomb_v),
            "hidden": hidden,
            "aim_size": aim_size,
            "num_charge_channels": num_charge_channels,
            "aev": {"rc_s": float(np.asarray(sd["aev.rc_s"]).reshape(())), "nshifts_s": nshifts_s},
            "outputs": outputs,
        },
    }


def convert_v1_model(
    jpt_path: str,
    yaml_config_path: str | None = None,
    output_path: str | None = None,
    implemented_species: list[int] | None = None,
    family: str | None = None,
    supports_charged_systems: bool | None = None,
):
    """Convert a trusted legacy TorchScript model; returns ``(LoadedModel,
    artifact)``, the artifact dict None without ``output_path``.

    ``yaml_config_path=None`` reads the architecture from the archive
    (:func:`infer_model_yaml_from_scripted`).  The v2 file is written by
    ``train.export.export_model``: the embedded long-range Coulomb becomes
    an SR Coulomb head and an external one, a DFTD3 head ``d3_params``.
    With ``implemented_species`` the other embedding rows are NaN."""
    jit_model = torch.jit.load(jpt_path, map_location="cpu")
    cutoff = float(jit_model.cutoff)
    sd = {k: v.detach().numpy() for k, v in jit_model.state_dict().items()}

    if yaml_config_path is None:
        model_yaml = infer_model_yaml_from_scripted(jit_model)
    else:
        with open(yaml_config_path, encoding="utf-8") as f:
            model_yaml = yaml.safe_load(f)
    cfg = config_from_yaml(model_yaml)
    params, aux = convert_state_dict(sd, cfg)

    if implemented_species is None:
        implemented_species = extract_species_from_afv(np.asarray(sd["afv.weight"]))
    else:
        implemented_species = sorted(set(implemented_species))
        afv = np.asarray(sd["afv.weight"]).copy()
        mask = np.ones(afv.shape[0], dtype=bool)
        mask[0] = False
        mask[[z for z in implemented_species if z < afv.shape[0]]] = False
        afv[mask] = np.nan
        params["afv"]["weight"] = torch.from_numpy(afv.astype(np.float32))

    extra_md: dict[str, Any] = {"cutoff": cutoff}
    if family is not None:
        extra_md["family"] = family
    if supports_charged_systems is not None:
        extra_md["supports_charged_systems"] = supports_charged_systems

    artifact = None
    if output_path:
        artifact = export_model(
            params,
            cfg,
            output_path,
            sae=None,
            implemented_species=implemented_species,
            shift_tables=aux.get("sae"),
            extra_metadata=extra_md,
        )

    metadata = {
        "format_version": 2,
        "cutoff": cutoff,
        "implemented_species": implemented_species,
        "family": family,
        "supports_charged_systems": supports_charged_systems,
    }
    return LoadedModel(params=params, cfg=cfg, aux=aux, metadata=metadata), artifact
