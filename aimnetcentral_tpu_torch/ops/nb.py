"""Per-atom / per-molecule primitives (counterpart of aimnetcentral_tpu/ops/nb.py).

Sums over molecules are one-hot matrix products: deterministic on every
device (``index_add_`` on CUDA is a float atomic whose order changes from
run to run), and the slot layout interleaves molecules, so ``mol_idx`` is
not sorted there.
"""

from __future__ import annotations

import torch


def mask_pad_atoms(x: torch.Tensor, numbers: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Zero (or fill) entries belonging to padding atoms (numbers == 0)."""
    mask = (numbers == 0).reshape(numbers.shape + (1,) * (x.ndim - 1))
    return torch.where(mask, torch.full_like(x, fill), x)


def mol_onehot(mol_idx: torch.Tensor, num_mol: int, dtype: torch.dtype) -> torch.Tensor:
    """(num_mol, N) membership matrix; padding rows (``mol_idx == num_mol``)
    belong to no molecule."""
    ids = torch.arange(num_mol, device=mol_idx.device)
    return (mol_idx[None, :] == ids[:, None]).to(dtype)


def mol_sum(x: torch.Tensor, mol_idx: torch.Tensor, num_mol: int) -> torch.Tensor:
    """Per-molecule sum: (N, ...) -> (num_mol, ...)."""
    onehot = mol_onehot(mol_idx, num_mol, x.dtype)
    return (onehot @ x.reshape(x.shape[0], -1)).reshape((num_mol,) + x.shape[1:])


def expand_mol(x_mol: torch.Tensor, mol_idx: torch.Tensor) -> torch.Tensor:
    """Broadcast per-molecule values back to atoms: (num_mol, ...) -> (N, ...).
    Padding atoms read an appended zero row."""
    ext = torch.cat([x_mol, torch.zeros_like(x_mol[:1])], dim=0)
    return ext[mol_idx]
