"""Device selection for the port's entry points.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Return the torch device an entry point runs on.

    Also pins the exact-f32 tier (``precision="exact"`` of the JAX
    calculator): TF32 would keep about three decimal digits in matmuls and
    convolutions, and it would move periodic images in the geometry
    contractions (``ops/math.py::cellmul``).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
