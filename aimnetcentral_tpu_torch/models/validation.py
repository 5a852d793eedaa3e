"""The artifact trust boundary: import policy and metadata validation
(a copy of aimnetcentral_tpu/models/validation.py, which imports no JAX;
the port keeps its own so that it imports nothing of the JAX package).

Two layers of defense, and they are NOT the same thing:

1. **Structural** (always on): the config parser (models/convert.py) is a
   closed registry: a ``class:`` path it does not recognize cannot
   construct anything, and no artifact content is ever imported or executed
   (``torch.load(weights_only=True)`` refuses pickled objects; the state
   dict holds tensors only).  Forbidden constructor kwargs (``ptfile``) are
   rejected anywhere in the tree.

2. **Policy** (this module): which class paths an artifact is *allowed to
   name* at all, in the reference's ``ModelImportPolicy`` modes:

   - ``extend`` (default): the frozen default allowlist plus any
     user-supplied paths (for third-party artifacts whose head builders were
     registered via ``models.convert.register_head_builder``),
   - ``replace``: exactly the user-supplied paths,
   - ``unsafe``: skip the allowlist (the structural layer still applies:
     "unsafe" here never grants code execution, only schema acceptance).
"""

from __future__ import annotations

import dataclasses
import keyword
import math
from numbers import Real
from typing import Any, Collection, Literal, Mapping

# The reference's frozen default allowlist (artifact_validation.py:46-78);
# kept identical so every registry artifact that loads there loads here.
DEFAULT_CLASS_IMPORT_PATHS = frozenset(
    {
        "aimnet.models.AIMNet2",
        "aimnet.models.aimnet2.AIMNet2",
        "aimnet.modules.AtomicShift",
        "aimnet.modules.AtomicSum",
        "aimnet.modules.Dipole",
        "aimnet.modules.Output",
        "aimnet.modules.Quadrupole",
        "aimnet.modules.SRCoulomb",
        "aimnet.modules.D3TS",
        "aimnet.modules.lr.D3TS",
        "aimnet.modules.lr.DispParam",
    }
)
DEFAULT_ACTIVATION_IMPORT_PATHS = frozenset({"torch.nn.GELU"})

FORBIDDEN_CONSTRUCTOR_KEYS = frozenset({"ptfile"})
_D3TS_CLASS_PATHS = frozenset({"aimnet.modules.D3TS", "aimnet.modules.lr.D3TS"})


@dataclasses.dataclass(frozen=True)
class ModelImportPolicy:
    class_paths: frozenset[str]
    activation_paths: frozenset[str]
    unsafe: bool = False

    def require_allowed(self, path: str, role: str = "class") -> None:
        if self.unsafe:
            return
        allowed = self.class_paths if role == "class" else self.activation_paths
        if not any(_matches_pattern(path, pat) for pat in allowed):
            raise ValueError(f"Untrusted import path for {role!r}: {path!r}.")


REGISTRY_IMPORT_POLICY = ModelImportPolicy(
    class_paths=DEFAULT_CLASS_IMPORT_PATHS,
    activation_paths=DEFAULT_ACTIVATION_IMPORT_PATHS,
)

# Legacy v1 archives embed their long-range modules (full LRCoulomb, tabulated
# DFTD3, SRRep) — classes the v2 allowlist deliberately omits because v2
# artifacts externalize them.  The reference applies NO import policy to
# ``.jpt`` at all (TorchScript is trusted-source, aimnet/models/base.py:92-97);
# validating the introspection-reconstructed tree under this closed superset
# is defense in depth beyond the reference's contract.
LEGACY_JPT_CLASS_IMPORT_PATHS = DEFAULT_CLASS_IMPORT_PATHS | frozenset(
    {
        "aimnet.modules.LRCoulomb",
        "aimnet.modules.lr.LRCoulomb",
        "aimnet.modules.DFTD3",
        "aimnet.modules.lr.DFTD3",
        "aimnet.modules.SRRep",
        "aimnet.modules.DispParam",
    }
)
LEGACY_JPT_IMPORT_POLICY = ModelImportPolicy(
    class_paths=LEGACY_JPT_CLASS_IMPORT_PATHS,
    activation_paths=DEFAULT_ACTIVATION_IMPORT_PATHS,
)


def _matches_pattern(path: str, pattern: str) -> bool:
    if pattern.endswith(".*"):
        return path.startswith(pattern[:-1]) and path != pattern[:-2]
    return path == pattern


def _validate_import_pattern(path: object) -> str:
    if not isinstance(path, str):
        raise ValueError("Model import paths must be a collection of strings.")
    if not path or path != path.strip():
        raise ValueError(f"Invalid model import path: {path!r}.")
    is_namespace = path.endswith(".*")
    fixed = path[:-2] if is_namespace else path
    if "*" in fixed or "?" in path or "[" in path or "]" in path:
        raise ValueError(f"Invalid model import path: {path!r}.")
    segments = fixed.split(".")
    if len(segments) < (1 if is_namespace else 2) or any(not s for s in segments):
        raise ValueError(f"Invalid model import path: {path!r}.")
    if any(not s.isidentifier() or keyword.iskeyword(s) for s in segments):
        raise ValueError(f"Invalid model import path: {path!r}.")
    return path


def resolve_model_import_policy(
    model_import_paths: Collection[str] | None = None,
    model_import_mode: Literal["extend", "replace", "unsafe"] = "extend",
) -> ModelImportPolicy:
    """(reference artifact_validation.py:208-241)"""
    if model_import_mode not in {"extend", "replace", "unsafe"}:
        raise ValueError(f"Invalid model_import_mode: {model_import_mode!r}.")
    if model_import_mode == "unsafe":
        if model_import_paths is not None:
            raise ValueError(
                "model_import_paths cannot be used with unsafe model_import_mode."
            )
        return ModelImportPolicy(frozenset(), frozenset(), unsafe=True)
    if model_import_paths is not None and (
        isinstance(model_import_paths, (str, bytes, Mapping))
        or not isinstance(model_import_paths, Collection)
    ):
        raise ValueError("model_import_paths must be a collection of strings.")
    paths = (
        frozenset(_validate_import_pattern(p) for p in model_import_paths)
        if model_import_paths is not None
        else frozenset()
    )
    if model_import_mode == "replace":
        if not paths:
            raise ValueError(
                "replace model_import_mode requires a non-empty "
                "model_import_paths collection."
            )
        return ModelImportPolicy(paths, paths)
    return ModelImportPolicy(
        DEFAULT_CLASS_IMPORT_PATHS | paths,
        DEFAULT_ACTIVATION_IMPORT_PATHS | paths,
    )


def validate_model_yaml_tree(
    tree: Any, policy: ModelImportPolicy, _seen: set[int] | None = None
) -> None:
    """Walk a parsed model-yaml tree: enforce the import policy on every
    ``class:``/``activation_fn:`` entry, reject forbidden constructor kwargs,
    and sanity-check D3TS damping parameters
    (reference artifact_validation.py:100-127, 242-330).

    Rejects cyclic YAML alias structures (``a: &x [*x]``) up front — PyYAML's
    safe loader constructs genuinely recursive containers, which would
    otherwise crash the walk (reference
    tests/test_model_artifact_security.py:401)."""
    if _seen is None:
        _seen = set()
        # the TOP level must be a class-mapping — a list/scalar model_yaml
        # would crash downstream construction with an opaque AttributeError
        # (reference artifact_validation.py rejects non-mapping model_yaml
        # structurally, tests/test_model_artifact_security.py:406)
        if not isinstance(tree, Mapping):
            raise ValueError(
                f"model yaml must be a mapping, got {type(tree).__name__}"
            )
    if isinstance(tree, (Mapping, list, tuple)):
        if id(tree) in _seen:
            raise ValueError(
                "model yaml contains a cyclic alias structure; refusing to load"
            )
        _seen = _seen | {id(tree)}
    if isinstance(tree, Mapping):
        cls = tree.get("class")
        if isinstance(cls, str):
            policy.require_allowed(cls, "class")
            kw = tree.get("kwargs") or {}
            if isinstance(kw, Mapping):
                for bad in FORBIDDEN_CONSTRUCTOR_KEYS:
                    if bad in kw:
                        raise ValueError(
                            f"forbidden constructor kwarg {bad!r} in model yaml "
                            f"(class {cls!r})"
                        )
                if cls in _D3TS_CLASS_PATHS:
                    for k in ("a1", "a2", "s8", "s6"):
                        if k in kw:
                            v = kw[k]
                            if (
                                isinstance(v, bool)
                                or not isinstance(v, Real)
                                or not math.isfinite(float(v))
                                or float(v) < 0
                            ):
                                raise ValueError(
                                    f"D3TS damping kwarg {k!r} must be a finite "
                                    f"non-negative number, got {v!r}"
                                )
        act = tree.get("activation_fn")
        if isinstance(act, str):
            policy.require_allowed(act, "activation")
        for v in tree.values():
            validate_model_yaml_tree(v, policy, _seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            validate_model_yaml_tree(v, policy, _seen)


# ---------------------------------------------------------------------------
# metadata validation (reference artifact_validation.py:394-533)


def _require_positive_real(metadata: Mapping[str, Any], key: str) -> None:
    v = metadata[key]
    if isinstance(v, bool) or not isinstance(v, Real) or not math.isfinite(float(v)) or v <= 0:
        raise ValueError(
            f"model metadata field {key!r} must be a finite positive real number."
        )


def validate_model_metadata(
    metadata: Mapping[str, Any],
    *,
    require_cutoff: bool = False,
    require_structural_consistency: bool = False,
    require_cross_field_consistency: bool = False,
) -> None:
    """Validate the scalar metadata the calculator consumes; with the
    consistency flags this is the canonical (export-time) validator."""
    if require_cutoff and "cutoff" not in metadata:
        raise ValueError("model metadata requires a 'cutoff' field.")
    if "cutoff" in metadata:
        _require_positive_real(metadata, "cutoff")
    if "format_version" in metadata and (
        type(metadata["format_version"]) is not int
        or metadata["format_version"] not in {1, 2}
    ):
        raise ValueError("model metadata field 'format_version' must be integer 1 or 2.")

    for key in ("needs_coulomb", "needs_dispersion", "has_embedded_lr", "has_embedded_d3ts"):
        if key in metadata and type(metadata[key]) is not bool:
            raise ValueError(f"model metadata field {key!r} must be a bool.")
    scs = metadata.get("supports_charged_systems")
    if "supports_charged_systems" in metadata and scs is not None and type(scs) is not bool:
        raise ValueError(
            "model metadata field 'supports_charged_systems' must be a bool or null."
        )
    if "coulomb_mode" in metadata and metadata["coulomb_mode"] not in {
        "none",
        "sr_embedded",
        "full_embedded",
    }:
        raise ValueError("model metadata field 'coulomb_mode' has an unsupported value.")
    if metadata.get("coulomb_sr_rc") is not None:
        _require_positive_real(metadata, "coulomb_sr_rc")
    env = metadata.get("coulomb_sr_envelope")
    if "coulomb_sr_envelope" in metadata and env is not None and env not in {"exp", "cosine"}:
        raise ValueError(
            "model metadata field 'coulomb_sr_envelope' has an unsupported value."
        )

    d3 = metadata.get("d3_params")
    if "d3_params" in metadata and d3 is not None:
        if not isinstance(d3, Mapping):
            raise ValueError("model metadata field 'd3_params' must be a mapping or null.")
        for key in ("s6", "s8", "a1", "a2"):
            if key in d3:
                v = d3[key]
                if isinstance(v, bool) or not isinstance(v, Real) or not math.isfinite(float(v)):
                    raise ValueError(f"d3_params[{key!r}] must be a finite real number.")

    if "implemented_species" in metadata:
        sp = metadata["implemented_species"]
        if not isinstance(sp, list) or any(type(z) is not int or z <= 0 for z in sp):
            raise ValueError(
                "model metadata field 'implemented_species' must be a list of "
                "positive integers."
            )
    fam = metadata.get("family")
    if "family" in metadata and fam is not None and not isinstance(fam, str):
        raise ValueError("model metadata field 'family' must be a string or null.")

    if require_structural_consistency or require_cross_field_consistency:
        mode = metadata.get("coulomb_mode", "none")
        has_lr = metadata.get("has_embedded_lr", False)
        if mode == "sr_embedded":
            if metadata.get("coulomb_sr_rc") is None or metadata.get("coulomb_sr_envelope") is None:
                raise ValueError(
                    "sr_embedded Coulomb metadata requires cutoff and envelope fields."
                )
            if not has_lr:
                raise ValueError("sr_embedded Coulomb metadata requires embedded LR metadata.")
            if (
                metadata.get("cutoff") is not None
                and metadata.get("coulomb_sr_rc") is not None
                and metadata["coulomb_sr_rc"] > metadata["cutoff"]
            ):
                raise ValueError("coulomb_sr_rc cannot exceed model cutoff.")
        if mode == "full_embedded" and not has_lr:
            raise ValueError("full_embedded Coulomb metadata requires embedded LR metadata.")
        if metadata.get("has_embedded_d3ts", False) and not has_lr:
            raise ValueError("embedded D3TS metadata requires embedded LR metadata.")

    if require_cross_field_consistency:
        mode = metadata.get("coulomb_mode", "none")
        if mode == "sr_embedded" and not metadata.get("needs_coulomb", False):
            raise ValueError("sr_embedded Coulomb metadata requires external Coulomb.")
        if metadata.get("needs_coulomb", False) and mode == "full_embedded":
            raise ValueError("full_embedded Coulomb metadata cannot request external Coulomb.")
        if metadata.get("needs_dispersion", False):
            if d3 is None:
                raise ValueError("needs_dispersion metadata requires d3_params.")
            missing = {"s8", "a1", "a2"} - set(d3)
            if missing:
                raise ValueError(
                    f"needs_dispersion metadata is missing d3_params: {sorted(missing)}."
                )
            if metadata.get("has_embedded_d3ts", False):
                raise ValueError("needs_dispersion cannot be combined with embedded D3TS.")


def validate_runtime_model_metadata(
    metadata: Mapping[str, Any],
    *,
    needs_coulomb: bool,
    needs_dispersion: bool,
) -> None:
    """Validate metadata after the calculator resolved its runtime flags
    (reference artifact_validation.py:503-533)."""
    effective = dict(metadata)
    effective["needs_coulomb"] = needs_coulomb
    effective["needs_dispersion"] = needs_dispersion
    if "format_version" in metadata:
        legacy = type(effective.get("format_version")) is int and effective["format_version"] == 1
        validate_model_metadata(
            effective,
            require_cutoff=not legacy,
            require_structural_consistency=not legacy,
        )
    if needs_coulomb and effective.get("coulomb_mode") == "full_embedded":
        raise ValueError("full_embedded Coulomb metadata cannot request external Coulomb.")
    if needs_dispersion:
        d3 = effective.get("d3_params")
        if not isinstance(d3, Mapping):
            raise ValueError("needs_dispersion metadata requires d3_params.")
        missing = {"s8", "a1", "a2"} - set(d3)
        if missing:
            raise ValueError(
                f"needs_dispersion metadata is missing d3_params: {sorted(missing)}."
            )
        if effective.get("has_embedded_d3ts", False):
            raise ValueError("needs_dispersion cannot be combined with embedded D3TS.")
