"""Carry parameters of the JAX package into the port.

``params_from_numpy`` takes the JAX parameter tree with its leaves already
turned into numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX
side; the port never imports JAX) and returns the same nested structure of
torch tensors.  Both packages store MLP weights as (n_in, n_out), so no leaf
is transposed, and both then compute the same function.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from aimnetcentral_tpu_torch.device import resolve_device


def params_from_numpy(tree: Any, device: str | torch.device = "cuda") -> Any:
    """Nested dicts / lists / tuples of numpy arrays -> the same nesting of
    tensors on ``device`` (floating leaves as float32)."""
    dev = resolve_device(device)

    def conv(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        arr = np.asarray(x)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        return torch.as_tensor(np.array(arr, order="C"), device=dev)  # keeps 0-d leaves 0-d

    return conv(tree)


def params_to(tree: Any, device: torch.device) -> Any:
    """Move a port parameter tree to ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to(v, device) for v in tree)
    return tree.to(device)
