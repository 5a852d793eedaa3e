"""Per-atom / per-molecule primitives (counterpart of aimnetcentral_tpu/ops/nb.py).

Neighbor gathers are advanced indexing, ``x[nbmat]``: its backward on CUDA
is PyTorch's sort-based deterministic accumulation, where ``index_select``,
``gather`` or ``take`` would differentiate through float atomics.

Sums over molecules are one-hot matrix products: deterministic on every
device (``index_add_`` on CUDA is a float atomic whose order changes from
run to run), and the slot layout interleaves molecules, so ``mol_idx`` is
not sorted there.  The product runs in f64 and is rounded to the input's
type once: no precision tier's TF32 flag reaches it, and the order in which
a device's GEMM adds leaves the f32 result as it is.
"""

from __future__ import annotations

import torch


def gather_nb(x: torch.Tensor, nbmat: torch.Tensor) -> torch.Tensor:
    """Per-neighbor values ``x[nbmat]`` -> (N, M, ...).  The fill value
    N - 1 points at the guaranteed padding row, so every index is in range
    and unused slots read the padding atom's values."""
    return x[nbmat]


def pair_mask(nbmat: torch.Tensor) -> torch.Tensor:
    """(N, M) bool, True for real pairs (fill entries ``N - 1`` are False)."""
    return nbmat != (nbmat.shape[0] - 1)


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
    """Per-molecule sum: (N, ...) -> (num_mol, ...).  Padding rows are
    dropped, not multiplied by zero, so an inf or NaN there (the zero
    distances of a padded molecule's stacked atoms) stays out of the sums
    and their gradients, as in JAX's segment sum."""
    x2d = torch.where((mol_idx < num_mol)[:, None], x.reshape(x.shape[0], -1), 0.0)
    out = mol_onehot(mol_idx, num_mol, torch.float64) @ x2d.double()
    return out.to(x.dtype).reshape((num_mol,) + x.shape[1:])


def expand_mol(x_mol: torch.Tensor, mol_idx: torch.Tensor) -> torch.Tensor:
    """Broadcast per-molecule values back to atoms: (num_mol, ...) -> (N, ...).
    Padding atoms read an appended zero row."""
    ext = torch.cat([x_mol, torch.zeros_like(x_mol[:1])], dim=0)
    return ext[mol_idx]
