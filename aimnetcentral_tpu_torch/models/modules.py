"""MLP building block (counterpart of aimnetcentral_tpu/models/modules.py).

Parameters are plain dictionaries of tensors with the JAX package's layout:
each layer is ``{"w": (n_in, n_out), "b": (n_out,)}``, so the forward is
``x @ w + b`` and the weights bridge across unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Static MLP description: hidden sizes, activation, last-layer linearity."""

    hidden: tuple[int, ...] = ()
    activation: str = "gelu"
    last_linear: bool = True


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in ("gelu", "torch.nn.GELU"):
        return lambda x: F.gelu(x, approximate="none")  # exact erf form
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if name in ("silu", "torch.nn.SiLU"):
        return F.silu
    raise ValueError(f"unknown activation {name!r}")


def orthogonal_embedding_init(gen: torch.Generator, num: int, dim: int, device: torch.device) -> torch.Tensor:
    """Orthogonal rows 1.. with a zero padding row 0 (reference
    aimnet/modules/core.py:64-68)."""
    w = torch.empty((num, dim), device=device)
    torch.nn.init.orthogonal_(w, generator=gen)
    w[0] = 0.0
    return w


def mlp_init(
    gen: torch.Generator, n_in: int, n_out: int, spec: MLPSpec, device: torch.device
) -> list[dict[str, torch.Tensor]]:
    """Xavier-normal weights, zero biases."""
    sizes = [n_in, *[h for h in spec.hidden if h > 0], n_out]
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        std = math.sqrt(2.0 / (fan_in + fan_out))
        w = torch.randn((fan_in, fan_out), generator=gen, device=device) * std
        layers.append({"w": w, "b": torch.zeros(fan_out, device=device)})
    return layers


def mlp_apply(layers: list[dict[str, torch.Tensor]], x: torch.Tensor, spec: MLPSpec) -> torch.Tensor:
    act = get_activation(spec.activation)
    n = len(layers)
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if not (spec.last_linear and i == n - 1):
            x = act(x)
    return x
