"""Model registry: name and alias resolution, checksum-verified cached
downloads, family policies (a copy of aimnetcentral_tpu/calculators/
registry.py, which imports no JAX; the port keeps its own, with its own
copy of the registry data in ``aimnetcentral_tpu_torch/data/
model_registry.yaml``).

Downloads are atomic (temporary file and rename) with one-shot replacement
of a corrupt cache; the cache directory is ``$AIMNET_CACHE_DIR`` or
``~/.cache/aimnet`` (the reference's layout, so existing caches are
reused).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import tempfile
from typing import Any

import yaml

_REGISTRY_FILE = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "data", "model_registry.yaml"
)


@dataclasses.dataclass(frozen=True)
class FamilyPolicy:
    supports_charged_systems: bool | None = None
    posthoc_d3_params: dict | None = None


def _load_registry() -> dict[str, Any]:
    with open(_REGISTRY_FILE) as f:
        return yaml.safe_load(f)


def cache_dir() -> str:
    return os.environ.get(
        "AIMNET_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache", "aimnet")
    )


def available_models() -> list[str]:
    reg = _load_registry()
    return sorted(reg["models"]) + sorted(reg.get("aliases", {}))


def resolve_name(name: str) -> tuple[str, dict]:
    """Resolve a model name or alias to its registry entry."""
    reg = _load_registry()
    aliases = reg.get("aliases", {}) or {}
    canonical = name
    if name in aliases:
        canonical = aliases[name]
    # family shorthand: 'aimnet2' -> ensemble member 0 of the default family
    if canonical not in reg["models"] and f"{canonical}_0" in reg["models"]:
        canonical = f"{canonical}_0"
    if canonical not in reg["models"]:
        raise KeyError(f"model {name!r} not in registry; known: {available_models()}")
    return canonical, reg["models"][canonical]


def ensemble_members(name: str) -> list[str]:
    """All registry member names of the ensemble family ``name`` belongs to.

    Resolves aliases and the family shorthand first, then enumerates the
    ``{base}_{i}`` members (the registry's naming scheme for the 4-member
    families, reference aimnet/calculators/model_registry.yaml)."""
    canonical, _ = resolve_name(name)
    stem, _, tail = canonical.rpartition("_")
    base = stem if tail.isdigit() else canonical
    reg = _load_registry()
    members = []
    i = 0
    while f"{base}_{i}" in reg["models"]:
        members.append(f"{base}_{i}")
        i += 1
    return members or [canonical]


def get_family_policy(family: str | None) -> FamilyPolicy:
    if family is None:
        return FamilyPolicy()
    fam = (_load_registry().get("families", {}) or {}).get(family)
    if fam is None:
        return FamilyPolicy()
    return FamilyPolicy(
        supports_charged_systems=fam.get("supports_charged_systems"),
        posthoc_d3_params=fam.get("posthoc_d3_params"),
    )


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_model(name: str, force: bool = False) -> str:
    """Fetch (or reuse) the artifact for a registry name; returns local path.

    Atomic download with checksum verification and one-shot corrupt-cache
    replacement (reference aimnet/calculators/model_registry.py:201-228).
    """
    canonical, entry = resolve_name(name)
    dest = os.path.join(cache_dir(), entry["file"])
    expected = entry.get("sha256")

    if os.path.exists(dest) and not force:
        if expected is None or _sha256(dest) == expected:
            return dest
        os.remove(dest)  # corrupt cache: re-download once

    try:
        import requests
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("downloading models requires the 'requests' package") from e

    os.makedirs(cache_dir(), exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=cache_dir(), delete=False) as tmp:
        tmp_path = tmp.name
        with requests.get(entry["url"], stream=True, timeout=120) as r:
            r.raise_for_status()
            for chunk in r.iter_content(1 << 20):
                tmp.write(chunk)
    if expected is not None and _sha256(tmp_path) != expected:
        os.remove(tmp_path)
        raise RuntimeError(f"checksum mismatch downloading {canonical}")
    shutil.move(tmp_path, dest)
    return dest


def clear_model_cache() -> None:
    d = cache_dir()
    if os.path.isdir(d):
        shutil.rmtree(d)


def registry_family(model: str) -> str | None:
    """Family declared in the registry for a name/alias (None for local paths
    or unknown names) — feeds family-policy reconciliation at load time
    (reference aimnet/calculators/resolve.py:36-66)."""
    if os.path.exists(model):
        return None
    try:
        _canonical, entry = resolve_name(model)
    except KeyError:
        return None
    return entry.get("family")


def resolve_model(model: str) -> str:
    """Registry name/alias -> cached artifact path; or pass through an
    existing local path (reference aimnet/calculators/resolve.py:69-120)."""
    if os.path.exists(model):
        return model
    return download_model(model)
