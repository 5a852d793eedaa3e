"""The ``System`` dataclass: one flat padded atom layout, as tensors.

Counterpart of aimnetcentral_tpu/system.py.  Atoms are a flat padded array;
padding atoms have ``numbers == 0`` and ``mol_idx == num_mol``.  This port
carries only the binned (stencil) layout: ``bins`` describes the SR bin grid
the slot rows are sorted into, and ``lr_bins``/``lr_slot``/``lr_inv`` the
coarse long-range twin grid (see ops/binned.py).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

import torch

if TYPE_CHECKING:
    from aimnetcentral_tpu_torch.ops.binned import BinGrid


@dataclasses.dataclass(frozen=True)
class System:
    coord: torch.Tensor  # (N, 3) float32
    numbers: torch.Tensor  # (N,) int64, 0 = padding
    charge: torch.Tensor  # (num_mol,) float32 total molecular charge
    mol_idx: torch.Tensor  # (N,) int64 in [0, num_mol]
    mult: torch.Tensor | None = None  # (num_mol,) float32 (NSE models)
    cell: torch.Tensor | None = None  # (num_mol, 3, 3) float32, row vectors
    bins: "BinGrid | None" = None  # static SR grid of the slot layout
    lr_bins: "BinGrid | None" = None  # static coarse LR twin grid
    lr_slot: torch.Tensor | None = None  # (lr num_slots,) LR slot -> SR slot
    lr_inv: torch.Tensor | None = None  # (num_slots,) SR slot -> LR slot

    @property
    def natoms(self) -> int:
        return self.coord.shape[0]

    @property
    def num_mol(self) -> int:
        return self.charge.shape[0]

    @property
    def device(self) -> torch.device:
        return self.coord.device

    def replace(self, **kwargs: Any) -> "System":
        return dataclasses.replace(self, **kwargs)

    def to(self, device: torch.device | str) -> "System":
        """Move every tensor field to ``device`` (static fields stay)."""
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return self.replace(**moved)
