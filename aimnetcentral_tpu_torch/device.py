"""Device selection for the port's entry points.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Return the torch device an entry point runs on.

    The matmul precision is not set here: each force evaluation runs inside
    its precision tier's context (``calculators/calculator.py::
    ambient_matmul_context``), and the geometry contractions are exact
    whatever the TF32 flag (``ops/math.py::cellmul``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
