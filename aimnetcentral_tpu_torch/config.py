"""Config loading: YAML with Jinja2 hyperparameter templates and nested-file
expansion (a copy of aimnetcentral_tpu/config.py, which imports no JAX; the
port keeps its own so that it imports nothing of the JAX package).

For TRUSTED training and plugin configs only: the artifact loaders
(models/loader.py) parse embedded ``model_yaml`` strings with plain
``yaml.safe_load`` and never expand file references.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterator

import yaml


def _walk_bottomup(
    tree: dict | list,
) -> Iterator[tuple[dict | list, Any, Any]]:
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (list, dict)):
            yield from _walk_bottomup(v)
        yield tree, k, v


def load_yaml(
    config: dict | list | str,
    hyperpar: dict | str | None = None,
    *,
    basedir: str | None = None,
    allow_file_references: bool = True,
) -> dict | list:
    """Load a YAML config with optional Jinja2 hyperparameters.

    - ``config`` may be a path or an already-parsed tree.
    - ``hyperpar`` (dict or path to a YAML dict) is rendered into every
      ``{{ ... }}`` template occurrence (whole-file render for paths,
      per-string render for trees).
    - with ``allow_file_references``, string values ending in .yml/.yaml are
      replaced by the parsed content of that file (resolved against
      ``basedir``, which defaults to the directory of ``config``).
    """
    from jinja2 import Template

    if isinstance(hyperpar, str):
        hyperpar = load_yaml(hyperpar, allow_file_references=allow_file_references)
        if not isinstance(hyperpar, dict):
            raise TypeError("hyperpar file must contain a YAML mapping")

    if isinstance(config, (list, dict)):
        config = copy.deepcopy(config)
        if hyperpar:
            for parent, k, v in _walk_bottomup(config):
                if isinstance(v, str) and "{{" in v:
                    rendered = Template(v).render(**hyperpar)
                    # templated scalars come back as strings: re-parse
                    parent[k] = yaml.safe_load(rendered)
    else:
        if basedir is None:
            basedir = os.path.dirname(os.path.abspath(config))
        with open(config, encoding="utf-8") as f:
            text = f.read()
        if hyperpar:
            text = Template(text).render(**hyperpar)
        config = yaml.safe_load(text)

    if allow_file_references and isinstance(config, (list, dict)):
        for parent, k, v in _walk_bottomup(config):
            if isinstance(v, str) and v.endswith((".yml", ".yaml")):
                path = v
                if not os.path.isfile(path) and basedir is not None:
                    path = os.path.join(basedir, v)
                if not os.path.isfile(path):
                    raise FileNotFoundError(
                        f"nested config reference {v!r} not found"
                    )
                parent[k] = load_yaml(
                    path, hyperpar, allow_file_references=True
                )
    return config
