"""Host-side System builder (counterpart of aimnetcentral_tpu/builders.py).

Only the path that feeds the binned engine is ported (``build_nbmat=False``
there): no neighbor matrices are built; the caller converts the compact
System into the slot layout with ops/binned.py::to_binned_system.
"""

from __future__ import annotations

import numpy as np
import torch

from aimnetcentral_tpu_torch.system import System


def system_from_molecules(
    molecules: list[dict], device: torch.device, n_pad: int | None = None
) -> System:
    """Pack molecules into one flat padded System on ``device``.

    Each molecule dict: ``coord`` (n, 3), ``numbers`` (n,), optional
    ``charge``, ``mult`` and ``cell`` (3, 3).  Periodic molecules are stored
    in the wrapped frame (coordinates inside the cell), as in the JAX
    package.
    """
    coords = [np.asarray(m["coord"], dtype=np.float32) for m in molecules]
    numbers = [np.asarray(m["numbers"], dtype=np.int64) for m in molecules]
    n_real = sum(len(c) for c in coords)
    n_pad = n_pad or (n_real + 1)
    if n_pad <= n_real:
        raise ValueError("need at least one padding row")
    num_mol = len(molecules)

    coord = np.ones((n_pad, 3), dtype=np.float32)
    zs = np.zeros(n_pad, dtype=np.int64)
    mol_idx = np.full(n_pad, num_mol, dtype=np.int64)
    off = 0
    for i, (c, z) in enumerate(zip(coords, numbers)):
        coord[off : off + len(c)] = c
        zs[off : off + len(c)] = z
        mol_idx[off : off + len(c)] = i
        off += len(c)

    charge = np.array([m.get("charge", 0.0) for m in molecules], dtype=np.float32)
    mult = None
    if any("mult" in m for m in molecules):
        mult = np.array([m.get("mult", 1.0) for m in molecules], dtype=np.float32)

    cells = [m.get("cell") for m in molecules]
    cell = None
    if any(c is not None for c in cells):
        cell = np.stack(
            [np.asarray(c if c is not None else np.eye(3), dtype=np.float32) for c in cells]
        )
        off = 0
        for i, c in enumerate(coords):
            if cells[i] is not None:
                cb = np.asarray(cells[i], dtype=np.float64)
                w = np.floor(c.astype(np.float64) @ np.linalg.inv(cb))
                if w.any():
                    coord[off : off + len(c)] = (c.astype(np.float64) - w @ cb).astype(np.float32)
            off += len(c)

    def t(x):
        return torch.as_tensor(x, device=device)

    return System(
        coord=t(coord),
        numbers=t(zs),
        charge=t(charge),
        mol_idx=t(mol_idx),
        mult=t(mult) if mult is not None else None,
        cell=t(cell) if cell is not None else None,
        species=tuple(sorted(int(z) for z in np.unique(zs) if z > 0)),
    )
