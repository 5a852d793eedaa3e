"""The ``System`` dataclass: one flat padded atom layout, as tensors.

Counterpart of aimnetcentral_tpu/system.py.  Atoms are a flat padded array;
padding atoms have ``numbers == 0`` and ``mol_idx == num_mol``.  Two
layouts:

- indexed: pair terms run over neighbor matrices ``nbmat`` (N, M) int64
  whose fill value ``N - 1`` points at the guaranteed padding last row, with
  integer lattice image counts ``shifts`` (N, M, 3) under PBC, and optional
  long-range matrices (``nbmat_lr``, ``nbmat_coulomb``, ``nbmat_dftd3``)
  picked by ``resolve_nb``;
- binned (stencil): ``bins`` describes the SR bin grid the slot rows are
  sorted into, and ``lr_bins``/``lr_slot``/``lr_inv`` the coarse long-range
  twin grid (see ops/binned.py).

Ewald and PME carry their discretisation on the System (models/ewald.py::
attach_ewald): the integer k-grid ``ewald_kpts`` and per-molecule
``ewald_eta``, ``ewald_r_cutoff`` and ``ewald_k_cutoff`` as tensors, and
the host values that size layouts and meshes or enter a kernel launch,
``ewald_r_static`` (the largest real-space cutoff), ``ewald_eta_static``
and ``pme_mesh``.
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
    nbmat: torch.Tensor | None = None  # (N, M) int64, fill N - 1 (indexed layout)
    shifts: torch.Tensor | None = None  # (N, M, 3) int8 lattice image counts
    nbmat_lr: torch.Tensor | None = None  # (N, M_lr) shared long-range list
    shifts_lr: torch.Tensor | None = None
    nbmat_coulomb: torch.Tensor | None = None  # split lists, when the Coulomb
    shifts_coulomb: torch.Tensor | None = None  # and D3 cutoffs differ by > 20%
    nbmat_dftd3: torch.Tensor | None = None
    shifts_dftd3: torch.Tensor | None = None
    bins: "BinGrid | None" = None  # static SR grid of the slot layout
    lr_bins: "BinGrid | None" = None  # static coarse LR twin grid
    lr_slot: torch.Tensor | None = None  # (lr num_slots,) LR slot -> SR slot
    lr_inv: torch.Tensor | None = None  # (num_slots,) SR slot -> LR slot
    # atomic numbers present (sorted, static; set by builders): D3's C6
    # references become a small dense bilinear form over these species
    species: tuple[int, ...] | None = None
    ewald_kpts: torch.Tensor | None = None  # (K, 3) integer reciprocal points, zero excluded
    ewald_eta: torch.Tensor | None = None  # (num_mol,) screening width
    ewald_r_cutoff: torch.Tensor | None = None  # (num_mol,) real-space cutoff
    ewald_k_cutoff: torch.Tensor | None = None  # (num_mol,) reciprocal cutoff
    ewald_r_static: float | None = None  # host copy of the largest real-space cutoff
    ewald_eta_static: tuple[float, ...] | None = None  # host copy of ewald_eta (a launch constant of D, E)
    pme_mesh: tuple[int, int, int] | None = None  # PME's FFT mesh, when PME is asked for

    @property
    def natoms(self) -> int:
        return self.coord.shape[0]

    @property
    def num_mol(self) -> int:
        return self.charge.shape[0]

    @property
    def device(self) -> torch.device:
        return self.coord.device

    @property
    def pad_idx(self) -> int:
        """Index of the guaranteed padding row (the neighbor fill value)."""
        return self.coord.shape[0] - 1

    def mask_i(self) -> torch.Tensor:
        """(N,) bool, True for padding atoms."""
        return self.numbers == 0

    def resolve_nb(self, *suffixes: str) -> tuple[torch.Tensor, torch.Tensor | None, str]:
        """The first (nbmat, shifts, suffix) present among ``suffixes``;
        suffix "" is the base SR matrices."""
        for s in suffixes:
            nb = getattr(self, f"nbmat{s}")
            if nb is not None:
                return nb, getattr(self, f"shifts{s}"), s
        raise KeyError(f"no neighbor matrix found for suffixes {suffixes}")

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
