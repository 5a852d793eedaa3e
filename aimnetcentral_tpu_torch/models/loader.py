"""Model artifact loading: v2 ``.pt`` files, Hugging Face style directories
and repos, registry names (counterpart of aimnetcentral_tpu/models/loader.py).

- v2 ``.pt``: ``torch.load(weights_only=True)``, which refuses pickled
  objects; the embedded ``model_yaml`` passes the import policy and the
  forbidden-kwarg check of models/validation.py before anything is built,
  and the config parser (models/convert.py) constructs nothing outside its
  registry.
- The metadata drives the external long-range heads: ``needs_coulomb`` and
  ``needs_dispersion`` append a simple Coulomb head and a DFT-D3 head after
  the model's own output chain.
- The float64 self-atomic-energy tables go to ``aux["sae"]``.

- Legacy ``.jpt`` TorchScript archives (``load_jpt_model``): the
  architecture is read back from the scripted module
  (models/convert_v1.py), the embedded long-range heads stay in the model
  (``coulomb_mode: full_embedded``).

Parameters come back as float32 tensors on the CPU; the calculator moves
them to its device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Literal, Mapping, NamedTuple

import numpy as np
import torch
import yaml

from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config
from aimnetcentral_tpu_torch.models.convert import config_from_yaml, convert_state_dict
from aimnetcentral_tpu_torch.models.heads import DFTD3Head, LRCoulombHead, head_init
from aimnetcentral_tpu_torch.models.validation import (
    FORBIDDEN_CONSTRUCTOR_KEYS,
    LEGACY_JPT_IMPORT_POLICY,
    REGISTRY_IMPORT_POLICY,
    ModelImportPolicy,
    resolve_model_import_policy,
    validate_model_metadata,
    validate_model_yaml_tree,
)

FORBIDDEN_KWARGS = tuple(sorted(FORBIDDEN_CONSTRUCTOR_KEYS))  # JAX's loader names them so


class LoadedModel(NamedTuple):
    params: dict
    cfg: AIMNet2Config
    aux: dict
    metadata: dict

    def as_calculator_model(self) -> tuple:
        return (self.params, self.cfg, self.aux)


def _metadata_from_artifact(data: Mapping[str, Any]) -> dict:
    return {
        "format_version": data.get("format_version", 2),
        "cutoff": float(data["cutoff"]),
        "needs_coulomb": bool(data.get("needs_coulomb", False)),
        "needs_dispersion": bool(data.get("needs_dispersion", False)),
        "coulomb_mode": data.get("coulomb_mode", "none"),
        "coulomb_sr_rc": data.get("coulomb_sr_rc"),
        "coulomb_sr_envelope": data.get("coulomb_sr_envelope"),
        "d3_params": data.get("d3_params"),
        "has_embedded_lr": bool(data.get("has_embedded_lr", False)),
        "has_embedded_d3ts": bool(data.get("has_embedded_d3ts", False)),
        "implemented_species": list(data.get("implemented_species", [])),
        "family": data.get("family"),
        "supports_charged_systems": data.get("supports_charged_systems"),
    }


def apply_family_defaults(metadata: Mapping[str, Any], registry_family: str | None = None) -> dict:
    """Reconcile artifact metadata with the registry family policy: rxn
    models must refuse net-charged systems; families with post-hoc D3 get
    dispersion parameters attached when the artifact does not embed D3TS."""
    from aimnetcentral_tpu_torch.calculators.registry import get_family_policy

    metadata = dict(metadata)
    if registry_family is not None:
        fam = metadata.get("family")
        if fam is None:
            metadata["family"] = registry_family
        elif fam != registry_family:
            raise ValueError(
                f"Registry family {registry_family!r} does not match model "
                f"metadata family {fam!r}. Refusing to load ambiguous energy scale."
            )
    policy = get_family_policy(metadata.get("family"))
    if policy.supports_charged_systems is not None:
        declared = metadata.get("supports_charged_systems")
        if declared is None:
            metadata["supports_charged_systems"] = policy.supports_charged_systems
        elif bool(declared) is not policy.supports_charged_systems:
            raise ValueError(
                f"{metadata.get('family')} models must declare "
                f"supports_charged_systems={policy.supports_charged_systems}."
            )
    if policy.posthoc_d3_params is not None and not metadata.get("has_embedded_d3ts", False):
        metadata["needs_dispersion"] = True
        if metadata.get("d3_params") is None:
            metadata["d3_params"] = dict(policy.posthoc_d3_params)
    return metadata


def attach_external_lr(cfg: AIMNet2Config, metadata: Mapping[str, Any]) -> AIMNet2Config:
    """Append the external Coulomb and D3 heads the metadata asks for.  The
    Coulomb head subtracts no SR part when the model embeds it
    (``coulomb_mode: sr_embedded``)."""
    outputs = list(cfg.outputs)
    if metadata.get("needs_coulomb"):
        rc = metadata.get("coulomb_sr_rc") or 4.6
        envelope = metadata.get("coulomb_sr_envelope") or "exp"
        subtract_sr = metadata.get("coulomb_mode") != "sr_embedded"
        outputs.append((
            "external_coulomb",
            LRCoulombHead(rc=float(rc), method="simple", envelope=envelope, subtract_sr=subtract_sr,
                          key_in="charges", key_out="energy"),
        ))
    if metadata.get("needs_dispersion") and metadata.get("d3_params"):
        p = metadata["d3_params"]
        outputs.append((
            "external_dftd3",
            DFTD3Head(s8=float(p["s8"]), a1=float(p["a1"]), a2=float(p["a2"]), s6=float(p.get("s6", 1.0)),
                      key_out="energy"),
        ))
    return dataclasses.replace(cfg, outputs=tuple(outputs))


def init_missing_heads(params: dict, cfg: AIMNet2Config) -> dict:
    """``params`` with every head of ``cfg`` that has none initialised on
    the CPU.  External heads carry constant tables only, no learned weights,
    so the result does not depend on the generator."""
    gen = torch.Generator().manual_seed(0)
    outputs = dict(params.get("outputs", {}))
    for name, head in cfg.outputs:
        if name not in outputs:
            outputs[name] = head_init(gen, head, torch.device("cpu"))
    return {**params, "outputs": outputs}


def load_v2_artifact(
    path: str,
    attach_lr: bool = True,
    registry_family: str | None = None,
    model_import_paths: tuple[str, ...] | None = None,
    model_import_mode: Literal["extend", "replace", "unsafe"] = "extend",
) -> LoadedModel:
    """Load a v2 ``.pt`` artifact.

    ``model_import_paths`` / ``model_import_mode`` set the trust boundary
    (which class paths the model YAML may name, models/validation.py).
    ``attach_lr=False`` returns the bare network; the calculator still
    attaches the external heads the metadata asks for unless it is built
    with ``needs_coulomb=False`` / ``needs_dispersion=False``."""
    policy = resolve_model_import_policy(model_import_paths, model_import_mode)
    data = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(data, dict) or "model_yaml" not in data or "state_dict" not in data:
        raise ValueError(f"{path}: not a v2 AIMNet2 artifact")
    model_cfg = yaml.safe_load(data["model_yaml"])
    validate_model_yaml_tree(model_cfg, policy)
    cfg = config_from_yaml(model_cfg)
    sd = {k: v.numpy() for k, v in data["state_dict"].items()}
    params, aux = convert_state_dict(sd, cfg)
    metadata = apply_family_defaults(_metadata_from_artifact(data), registry_family)
    validate_model_metadata(metadata, require_cutoff=True)
    aux["metadata"] = metadata
    if attach_lr:
        cfg = attach_external_lr(cfg, metadata)
        params = init_missing_heads(params, cfg)
    return LoadedModel(params=params, cfg=cfg, aux=aux, metadata=metadata)


def _check_member(member: int | str) -> int:
    """Refuse an invalid ensemble member before any file is touched."""
    if not isinstance(member, (int, str)) or isinstance(member, bool):
        raise ValueError(f"ensemble member must be a non-negative integer, got {member!r}")
    try:
        idx = int(member)
    except ValueError:
        raise ValueError(f"ensemble member must be a non-negative integer, got {member!r}") from None
    if idx < 0:
        raise ValueError(f"ensemble member must be >= 0, got {idx}")
    return idx


def fetch_hf_snapshot(
    repo_id: str,
    member: int | str = 0,
    revision: str | None = None,
    token: str | None = None,
    policy: ModelImportPolicy | None = None,
) -> str:
    """Fetch an AIMNet2 Hugging Face repo, its metadata validated before any
    weights are downloaded:

    1. download only ``config.json`` (at ``revision``),
    2. validate its metadata and the ``model_yaml`` import policy,
    3. only then download the member's ``ensemble_N.safetensors``.

    Returns the local snapshot directory.  A family-level ``config.json``
    without ``model_yaml`` falls back to the model registry through its
    ``member_names`` list; the result is then the registry ``.pt`` file."""
    member = _check_member(member)

    from huggingface_hub import hf_hub_download

    policy = policy or REGISTRY_IMPORT_POLICY
    cfg_path = hf_hub_download(repo_id, "config.json", revision=revision, token=token)
    with open(cfg_path) as f:
        config = json.load(f)
    if not isinstance(config, Mapping):
        raise TypeError("config.json root must be a mapping.")
    validate_model_metadata(config)

    model_yaml = config.get("model_yaml")
    if model_yaml is None:
        member_names = config.get("member_names")
        if not isinstance(member_names, list) or not member_names:
            raise ValueError(
                f"config.json in {repo_id!r} has no 'model_yaml' and no "
                "'member_names' list for a registry fallback; re-upload the "
                "repo with a complete config.json."
            )
        if member >= len(member_names):
            raise ValueError(f"ensemble member {member} out of range for {len(member_names)} members")
        from aimnetcentral_tpu_torch.calculators.registry import download_model

        return download_model(member_names[member])

    tree = yaml.safe_load(model_yaml) if isinstance(model_yaml, str) else model_yaml
    validate_model_yaml_tree(tree, policy)
    w_path = hf_hub_download(repo_id, f"ensemble_{member}.safetensors", revision=revision, token=token)
    return os.path.dirname(w_path)


def load_hf_repo(repo_dir: str, member: int | str = 0, registry_family: str | None = None) -> LoadedModel:
    """Load a Hugging Face style directory: ``config.json`` and
    ``ensemble_N.safetensors`` (a local snapshot; ``load_model`` fetches a
    repo id first)."""
    member = _check_member(member)

    from safetensors.numpy import load_file

    with open(os.path.join(repo_dir, "config.json")) as f:
        config = json.load(f)
    model_yaml = config.get("model_yaml")
    model_cfg = yaml.safe_load(model_yaml) if isinstance(model_yaml, str) else model_yaml
    validate_model_yaml_tree(model_cfg, REGISTRY_IMPORT_POLICY)
    cfg = config_from_yaml(model_cfg)
    sd = load_file(os.path.join(repo_dir, f"ensemble_{member}.safetensors"))
    params, aux = convert_state_dict(sd, cfg)
    metadata = apply_family_defaults(_metadata_from_artifact(config), registry_family)
    aux["metadata"] = metadata
    cfg = attach_external_lr(cfg, metadata)
    return LoadedModel(params=init_missing_heads(params, cfg), cfg=cfg, aux=aux, metadata=metadata)


def load_jpt_model(path: str, registry_family: str | None = None) -> LoadedModel:
    """Load a trusted legacy ``.jpt`` TorchScript model.

    A TorchScript archive holds executable code: load ``.jpt`` files only
    from sources whose code and provenance you trust.  The archive is read on the host
    (``torch.jit.load(..., map_location="cpu")``) and never run: the
    architecture comes from its scripted heads
    (``convert_v1.infer_model_yaml_from_scripted``), checked against
    ``LEGACY_JPT_IMPORT_POLICY``, and the state dict maps onto the port's
    parameters.  The embedded long-range heads stay embedded
    (``coulomb_mode: full_embedded``); ``convert_v1_model`` (the
    ``convert`` command) writes the v2 artifact with them externalised.
    """
    from aimnetcentral_tpu_torch.models.convert_v1 import extract_species_from_afv, infer_model_yaml_from_scripted

    jit_model = torch.jit.load(path, map_location="cpu")
    tree = infer_model_yaml_from_scripted(jit_model)
    # the inferred tree names only v1 classes; the allowlist checks it anyway
    validate_model_yaml_tree(tree, LEGACY_JPT_IMPORT_POLICY)
    cfg = config_from_yaml(tree)
    sd = {k: v.detach().cpu().numpy() for k, v in jit_model.state_dict().items()}
    params, aux = convert_state_dict(sd, cfg)

    # the D3 parameters come from a tabulated DFTD3 head only, never D3TS
    d3_params = next(
        ({"s8": h.s8, "a1": h.a1, "a2": h.a2, "s6": h.s6} for _n, h in cfg.outputs if h.kind == "dftd3"), None
    )
    has_lr = any(h.kind == "lrcoulomb" for _, h in cfg.outputs)
    metadata = apply_family_defaults(
        {
            "format_version": 1,
            "cutoff": float(jit_model.cutoff),
            "needs_coulomb": False,
            "needs_dispersion": False,
            "coulomb_mode": "full_embedded" if has_lr else "none",
            "coulomb_sr_rc": None,
            "coulomb_sr_envelope": None,
            "d3_params": d3_params,
            "has_embedded_lr": has_lr,
            "has_embedded_d3ts": any(h.kind == "d3ts" for _, h in cfg.outputs),
            "implemented_species": extract_species_from_afv(np.asarray(sd["afv.weight"])),
            "family": None,
            "supports_charged_systems": None,
        },
        registry_family,
    )
    aux["metadata"] = metadata
    return LoadedModel(params=params, cfg=cfg, aux=aux, metadata=metadata)


def load_model(
    path: str,
    registry_family: str | None = None,
    model_import_paths: tuple[str, ...] | None = None,
    model_import_mode: Literal["extend", "replace", "unsafe"] = "extend",
) -> LoadedModel:
    """Dispatch on the artifact's kind: a v2 ``.pt`` file, a Hugging Face
    style directory or a repo id, or a trusted legacy ``.jpt`` archive
    (``load_jpt_model``; import settings do not apply to it)."""
    if os.path.isdir(path):
        return load_hf_repo(path, registry_family=registry_family)
    if not os.path.exists(path) and "/" in path and not path.endswith(".pt"):
        # a Hugging Face repo id, e.g. "isayevlab/aimnet2-wb97m-d3"
        policy = resolve_model_import_policy(model_import_paths, model_import_mode)
        local = fetch_hf_snapshot(path, policy=policy)
        if os.path.isdir(local):
            return load_hf_repo(local, registry_family=registry_family)
        return load_v2_artifact(local, registry_family=registry_family)
    if path.lower().endswith(".jpt"):
        if model_import_paths is not None or model_import_mode != "extend":
            raise ValueError("Import settings are not supported for .jpt sources.")
        return load_jpt_model(path, registry_family=registry_family)
    return load_v2_artifact(
        path,
        registry_family=registry_family,
        model_import_paths=model_import_paths,
        model_import_mode=model_import_mode,
    )
