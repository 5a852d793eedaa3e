"""On-device cell-list neighbor matrices (counterpart of
aimnetcentral_tpu/ops/cell_list.py).

The indexed MD engine rebuilds its neighbor matrices inside the step, on the
device and without a host sync: every shape is static (bins, bin capacity and
row width chosen on the host from density by ``plan_cell_list``), and the
overflow counts come back as a device scalar that the driver reads once per
chunk.

Algorithm (orthorhombic or triclinic cells through fractional coordinates;
gas-phase systems on a bounding box without wrapping):

1. bin the atoms into an (nx, ny, nz) grid;
2. the bin -> atom table by one stable sort and the rank in each bin;
3. per atom, the candidates of the 27 neighbouring bins with their lattice
   shifts, kept within the cutoff, compacted to the left by a second stable
   sort.

``torch.argsort(..., stable=True)`` sorts as ``jnp.argsort`` does, so every
row of ``nbmat`` is the JAX package's, entry for entry.  The table is
written by a scatter whose in-capacity entries have unique slots; every
dropped entry lands on one discarded slot, so the table repeats under
``torch.use_deterministic_algorithms``.  (The JAX package writes dropped
entries as the fill value into a row it resets afterwards.)  The build
carries no gradient: forces reach the coordinates through ``calc_distances``
on the list.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from aimnetcentral_tpu_torch.ops.math import cellmul


@dataclasses.dataclass(frozen=True)
class CellListSpec:
    """Static discretization of a cell-list build (chosen on the host)."""

    nbins: tuple[int, int, int]
    bin_capacity: int
    max_neighbors: int
    cutoff: float
    periodic: bool

    @property
    def total_bins(self) -> int:
        return self.nbins[0] * self.nbins[1] * self.nbins[2]


def plan_cell_list(
    cell: np.ndarray | None,
    n_atoms: int,
    cutoff: float,
    extent: float | None = None,
    density_safety: float = 2.0,
    max_neighbors: int | None = None,
) -> CellListSpec:
    """Bins of edge >= ``cutoff`` over the cell's perpendicular heights (or
    the gas-phase ``extent``, a cube's edge), and the bin capacity and row
    width from the density times ``density_safety``."""
    if cell is not None:
        cell = np.asarray(cell, dtype=np.float64)
        vol = abs(np.linalg.det(cell))
        heights = vol / np.linalg.norm(np.cross(np.roll(cell, -1, axis=0), np.roll(cell, -2, axis=0)), axis=1)
        nbins = tuple(max(1, int(h // cutoff)) for h in heights)
        density = n_atoms / vol
    else:
        if extent is None:
            raise ValueError("a gas-phase cell list needs the bounding box's extent")
        nbins = tuple(max(1, int(extent // cutoff)) for _ in range(3))
        density = n_atoms / max(extent**3, 1.0)
    total_bins = nbins[0] * nbins[1] * nbins[2]
    per_bin = n_atoms / total_bins
    bin_capacity = max(8, int(math.ceil(per_bin * density_safety / 8)) * 8)
    if max_neighbors is None:
        sphere = 4.0 / 3.0 * math.pi * cutoff**3
        max_neighbors = max(16, int(math.ceil(density * sphere * density_safety / 16)) * 16)
        if cell is None:
            # gas phase: at most n_atoms - 1 neighbors (under PBC the
            # periodic images make the sphere estimate the bound)
            max_neighbors = min(max_neighbors, max(1, n_atoms - 1))
    return CellListSpec(
        nbins=nbins, bin_capacity=bin_capacity, max_neighbors=max_neighbors, cutoff=cutoff,
        periodic=cell is not None,
    )


_NEIGHBOR_OFFSETS = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1).reshape(27, 3)


@torch.no_grad()
def build_cell_list(
    coord: torch.Tensor,
    numbers: torch.Tensor,
    spec: CellListSpec,
    cell: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """``(nbmat (N, M) int64, shifts (N, M, 3) | None, overflow ())`` on the
    device of ``coord``.

    ``coord`` (N, 3) in the padded layout (last row padding, padding atoms
    with ``numbers == 0``), possibly unwrapped; ``cell`` (3, 3) for a
    periodic spec.  ``shifts`` (lattice image counts, float) is None in the
    gas phase.  ``overflow`` counts the dropped candidates (bin and row
    overflow); the caller reads it outside the step."""
    n = coord.shape[0]
    dev = coord.device
    fill = n - 1
    nx, ny, nz = spec.nbins
    nbins = torch.tensor(spec.nbins, dtype=torch.int64, device=dev)
    real = numbers > 0

    if spec.periodic:
        if cell is None:
            raise ValueError("a periodic cell list needs the cell")
        frac_raw = cellmul(coord, torch.linalg.inv_ex(cell).inverse)
        atom_wrap = torch.floor(frac_raw)  # each atom's wrap count (coordinates may be unwrapped)
        bin_idx3 = torch.clamp(((frac_raw - atom_wrap) * nbins).to(torch.int64), min=torch.zeros_like(nbins),
                               max=nbins - 1)
    else:
        lo = torch.where(real[:, None], coord, math.inf).amin(0)
        rel = (coord - lo) / spec.cutoff
        bin_idx3 = torch.clamp(rel.to(torch.int64), min=torch.zeros_like(nbins), max=nbins - 1)

    bin_id = (bin_idx3[:, 0] * ny + bin_idx3[:, 1]) * nz + bin_idx3[:, 2]
    bin_id = torch.where(real, bin_id, spec.total_bins)  # padding -> the overflow bin

    # the bin -> atom table: one stable sort and the rank within each bin
    order = torch.argsort(bin_id, stable=True)
    sorted_bins = bin_id[order]
    ar = torch.arange(n, device=dev)
    same = torch.zeros_like(sorted_bins)
    same[1:] = (sorted_bins[1:] == sorted_bins[:-1]).to(same.dtype)
    rank = ar - torch.cummax(torch.where(same == 0, ar, 0), dim=0).values
    in_grid = sorted_bins < spec.total_bins
    in_cap = (rank < spec.bin_capacity) & in_grid
    # row total_bins stays all fill: out-of-grid probes read it
    n_table = (spec.total_bins + 1) * spec.bin_capacity
    table = torch.full((n_table + 1,), fill, dtype=torch.int64, device=dev)
    table[torch.where(in_cap, sorted_bins * spec.bin_capacity + rank, n_table)] = order
    table = table[:n_table].reshape(spec.total_bins + 1, spec.bin_capacity)
    bin_overflow = ((~in_cap) & in_grid).sum()

    # the candidates of the 27 neighbouring bins
    offsets = torch.as_tensor(_NEIGHBOR_OFFSETS, dtype=torch.int64, device=dev)
    nb_bins3 = bin_idx3[:, None, :] + offsets[None, :, :]  # (N, 27, 3)
    if spec.periodic:
        wrap = torch.div(nb_bins3, nbins, rounding_mode="floor")  # lattice wrap count
        nb_bins3 = nb_bins3 - wrap * nbins
        valid_bin = torch.ones(nb_bins3.shape[:2], dtype=torch.bool, device=dev)
    else:
        valid_bin = ((nb_bins3 >= 0) & (nb_bins3 < nbins)).all(-1)
        nb_bins3 = torch.clamp(nb_bins3, min=torch.zeros_like(nbins), max=nbins - 1)
    nb_bin_id = (nb_bins3[..., 0] * ny + nb_bins3[..., 1]) * nz + nb_bins3[..., 2]
    nb_bin_id = torch.where(valid_bin, nb_bin_id, spec.total_bins)
    cand = table[nb_bin_id].reshape(n, 27 * spec.bin_capacity)  # (N, 27C)

    cand_coord = coord[cand]
    shift = None
    if spec.periodic:
        # the probed bin's wrap, corrected by both atoms' own wrap counts: the
        # shift in the caller's (possibly unwrapped) frame
        shift = wrap.to(coord.dtype).repeat_interleave(spec.bin_capacity, dim=1)
        shift = shift - atom_wrap[cand] + atom_wrap[:, None, :]
        cand_coord = cand_coord + cellmul(shift, cell)
    d2 = ((cand_coord - coord[:, None, :]) ** 2).sum(-1)
    is_self = cand == ar[:, None]
    if spec.periodic:
        is_self = is_self & (shift == 0).all(-1)
    ok = (cand != fill) & ~is_self & (d2 < spec.cutoff**2) & real[:, None]

    # the valid candidates compacted to the left, in candidate order
    key = torch.where(ok, torch.arange(cand.shape[1], device=dev)[None, :], 1 << 30)
    sel = torch.argsort(key, dim=1, stable=True)[:, : spec.max_neighbors]
    sel_ok = torch.gather(ok, 1, sel)
    nbmat = torch.where(sel_ok, torch.gather(cand, 1, sel), fill)
    nb_overflow = torch.clamp(ok.sum(1) - spec.max_neighbors, min=0).sum()
    shifts = None
    if spec.periodic:
        picked = torch.gather(shift, 1, sel[..., None].expand(-1, -1, 3))
        shifts = torch.where(sel_ok[..., None], picked, 0.0)
    return nbmat, shifts, bin_overflow + nb_overflow
