"""Shared pieces of the training tests: the JAX package's test models and
data carried into the port (imports JAX; the port's own modules never do)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax

from aimnetcentral_tpu_torch.models.bridge import params_from_numpy


def port_object(obj):
    """A config dataclass of the JAX package as the port's class of the same
    name and module, field by field (nested dataclasses and tuples too)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        module = importlib.import_module(type(obj).__module__.replace("aimnetcentral_tpu.", "aimnetcentral_tpu_torch.", 1))
        cls = getattr(module, type(obj).__name__)
        return cls(**{f.name: port_object(getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(port_object(x) for x in obj)
    return obj


def port_params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def jax_leaves(tree):
    """``{path: numpy leaf}`` with the port's ``tree_leaves`` paths."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(x)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while the importing module runs: test files run side
    by side in worker processes, and the plain versions are many small ops,
    which several threads per worker only slow down on shared cores (the
    same fixture as test_torch_md.py's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
