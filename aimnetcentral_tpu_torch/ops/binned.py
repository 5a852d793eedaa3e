"""The binned (stencil) layout: counterpart of aimnetcentral_tpu/ops/binned.py.

Atoms are sorted into an (nx, ny, nz) bin grid with bin edge >= the SR
cutoff and a static per-bin capacity C; the slot array has length
L = nx*ny*nz*C and bin b owns slot rows [b*C, (b+1)*C).  A pair term with
cutoff r visits the constant set of bin offsets within radius
ceil(r/edge); host tables give, for every offset and bin, the candidate bin
and the lattice wrap its atoms are shifted by.

The host tables are numpy copies of the JAX package's; the device part
(``bin_atoms``, ``to_slots``, ``to_binned_system``, ``invert_slot_map``) is
torch.  ``torch.argsort(..., stable=True)`` matches ``jnp.argsort``, so the
slot permutation equals the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from aimnetcentral_tpu_torch.ops.math import cellmul


@dataclasses.dataclass(frozen=True)
class BinGrid:
    """Static bin-grid metadata (hashable)."""

    nbins: tuple[int, int, int]
    capacity: int
    edge_hint: float  # targeted bin edge (Angstrom); a lower bound on the true edge
    periodic: bool
    margin: float = 0.0  # extra stencil reach for stale binnings (the reuse skin)
    # per-axis override of ``periodic`` (a spatial-decomposition shard's
    # extended grid is bounded along its sharded axes, whose halo planes
    # supply the neighbours, and periodic along the others); None = every
    # axis follows ``periodic``
    periodic_axes: tuple[bool, bool, bool] | None = None
    # one molecule per bin (builders.system_molecule_bins): every pair is
    # within its bin, so every sweep runs at radius 0
    molecule_bins: bool = False

    @property
    def axes_periodic(self) -> tuple[bool, bool, bool]:
        if self.periodic_axes is not None:
            return self.periodic_axes
        return (self.periodic,) * 3

    @property
    def total_bins(self) -> int:
        return self.nbins[0] * self.nbins[1] * self.nbins[2]

    @property
    def num_slots(self) -> int:
        return self.total_bins * self.capacity


def plan_bins(
    cell: np.ndarray | None,
    n_atoms: int,
    edge: float,
    extent: tuple[np.ndarray, np.ndarray] | None = None,
    safety: float = 2.0,
) -> BinGrid:
    """Choose a static grid: bin edge >= ``edge``, capacity from density
    (relative safety factor AND a mean + 3.5 sqrt(mean) + 2 fluctuation
    tail, rounded up to a multiple of 8)."""
    if cell is not None:
        cell = np.asarray(cell, dtype=np.float64)
        vol = abs(np.linalg.det(cell))
        heights = vol / np.linalg.norm(
            np.cross(np.roll(cell, -1, axis=0), np.roll(cell, -2, axis=0)), axis=1
        )
        nbins = tuple(max(1, int(h // edge)) for h in heights)
    else:
        if extent is None:
            raise ValueError("plan_bins needs a cell or an extent")
        lo, hi = extent
        span = np.maximum(np.asarray(hi) - np.asarray(lo), 1e-3)
        nbins = tuple(max(1, int(s // edge) + 1) for s in span)
    total = nbins[0] * nbins[1] * nbins[2]
    per_bin = n_atoms / total
    need = max(per_bin * safety, per_bin + 3.5 * math.sqrt(per_bin) + 2.0)
    capacity = max(8, int(math.ceil(need / 8)) * 8)
    return BinGrid(nbins=nbins, capacity=capacity, edge_hint=edge, periodic=cell is not None)


def plan_lr_bins(
    cell: np.ndarray | None,
    n_atoms: int,
    lr_cutoff: float,
    extent: tuple[np.ndarray, np.ndarray] | None = None,
    safety: float = 1.6,
    margin: float = 0.0,
) -> BinGrid:
    """Coarse grid for long-range sweeps: bin edge ~ (cutoff+margin)/2 keeps
    the stencil at radius 2."""
    edge = max((lr_cutoff + margin) / 2.0, 1e-3)
    grid = plan_bins(cell, n_atoms, edge, extent=extent, safety=safety)
    return dataclasses.replace(grid, margin=margin)


def stencil_radius(cutoff: float, grid: BinGrid) -> int:
    """Offsets needed to cover ``cutoff`` plus the grid's stale-binning
    margin (engine_binned.py::stencil_radius in the JAX package);
    ``edge_hint`` is a lower bound on the true bin edge.  Molecule-bin
    grids sweep at radius 0 whatever the cutoff: each molecule sits in its
    own frame, so a neighbouring bin holds another molecule, never a
    neighbour (and ``cutoff`` may be inf there)."""
    if grid.molecule_bins:
        return 0
    return max(1, int(math.ceil((cutoff + grid.margin) / grid.edge_hint)))


def stencil_offsets(radius: int) -> np.ndarray:
    """All integer offsets in [-radius, radius]^3, ordered with (0,0,0) first."""
    r = np.arange(-radius, radius + 1)
    pts = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    order = np.argsort((pts != 0).any(axis=1), stable=True)
    return pts[order].astype(np.int32)


def stencil_tables(grid: BinGrid, radius: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host tables for a stencil sweep: ``(nbr (S, B) int32, wraps (S, B, 3)
    f32, is_zero (S,) bool)``.  For step s, bin b's candidate bin is
    ``nbr[s, b]``, whose atoms are shifted by ``wraps[s, b] @ cell``.
    Periodic axes wrap; out-of-grid targets along a bounded axis (gas
    phase, or a spatial shard's sharded axis) are -1."""
    nx, ny, nz = grid.nbins
    offs = stencil_offsets(radius)
    bx, by, bz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    bin3 = np.stack([bx, by, bz], axis=-1).reshape(-1, 3)
    target = bin3[None, :, :] + offs[:, None, :]  # (S, B, 3)
    nbins = np.array(grid.nbins)
    per = np.array(grid.axes_periodic)
    wrap = np.where(per, np.floor_divide(target, nbins), 0)
    t = np.where(per, target - wrap * nbins, np.clip(target, 0, nbins - 1))
    inside = np.all(per | ((target >= 0) & (target < nbins)), axis=-1)
    nbr = np.where(inside, (t[..., 0] * ny + t[..., 1]) * nz + t[..., 2], -1)
    is_zero = (offs == 0).all(axis=1)
    return nbr.astype(np.int32), wrap.astype(np.float32), is_zero


def mirror_stencil_tables(grid: BinGrid, radius: int) -> tuple[np.ndarray, np.ndarray]:
    """Receiver-centric tables for adjoint sweeps: ``mnbr[s, b]`` is the bin
    b' whose FORWARD step s had b as its candidate (nbr[s, b'] == b), and
    ``mwrap[s, b]`` the wrap that forward step applied, seen from b.
    Built from the offset mirror: b' = nbr(-offset, b), mwrap =
    -wrap(-offset, b).  Out-of-grid entries along a bounded axis are -1."""
    offs = stencil_offsets(radius)
    key = {tuple(o): i for i, o in enumerate(offs)}
    mirror = np.array([key[tuple(-o)] for o in offs], dtype=np.int64)
    nbr, wrap, _zero = stencil_tables(grid, radius)
    return nbr[mirror].astype(np.int32), (-wrap[mirror]).astype(np.float32)


def bin_atoms(
    coord: torch.Tensor,
    numbers: torch.Tensor,
    grid: BinGrid,
    cell: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot permutation for the bin-sorted layout.

    Returns ``(perm (L,) int64, wrap (N, 3) float32, overflow ())``: the
    compact atom feeding each slot (empty slots read the first padding
    atom), the per-atom lattice wrap (slot coordinate = coord - wrap @
    cell), and the count of atoms whose bin exceeded capacity.
    """
    n = coord.shape[0]
    dev = coord.device
    real = numbers > 0
    # Python scalars and inv_ex (no singularity check) keep this free of
    # host copies and host syncs: it runs inside MD steps
    if grid.periodic:
        if cell is None:
            raise ValueError("a periodic grid needs the cell")
        frac = cellmul(coord, torch.linalg.inv_ex(cell).inverse)
        wrap = torch.floor(frac)
        cols = [((frac[:, k] - wrap[:, k]) * grid.nbins[k]).to(torch.int64) for k in range(3)]
    else:
        inf = torch.full_like(coord, math.inf)
        lo = torch.where(real[:, None], coord, inf).amin(dim=0)
        wrap = torch.zeros_like(coord)
        cols = [((coord[:, k] - lo[k]) / grid.edge_hint).to(torch.int64) for k in range(3)]
    ix, iy, iz = (c.clamp(0, nb - 1) for c, nb in zip(cols, grid.nbins))
    ny, nz = grid.nbins[1], grid.nbins[2]
    bin_id = (ix * ny + iy) * nz + iz
    bin_id = torch.where(real, bin_id, torch.full_like(bin_id, grid.total_bins))

    order = torch.argsort(bin_id, stable=True)
    sorted_bins = bin_id[order]
    ar = torch.arange(n, device=dev)
    same = torch.zeros_like(sorted_bins)
    same[1:] = (sorted_bins[1:] == sorted_bins[:-1]).to(same.dtype)
    seg_start = torch.cummax(torch.where(same == 0, ar, torch.zeros_like(ar)), dim=0).values
    rank = ar - seg_start
    in_grid = sorted_bins < grid.total_bins
    in_cap = (rank < grid.capacity) & in_grid
    slot = torch.where(in_cap, sorted_bins * grid.capacity + rank, grid.num_slots)
    pad_src = torch.argmin(real.to(torch.int32))
    perm = torch.full((grid.num_slots + 1,), 0, dtype=torch.int64, device=dev) + pad_src
    # slots of in-capacity atoms are unique; every dropped atom lands on the
    # discarded last entry (a scatter of every row: no boolean indexing, so
    # no host sync inside an MD step)
    perm[slot] = order
    overflow = ((~in_cap) & in_grid).sum()
    return perm[: grid.num_slots], wrap.to(coord.dtype), overflow


def to_slots(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Permute a compact per-atom array into the slot layout."""
    return x[perm]


def invert_slot_map(lr_perm: torch.Tensor, lr_real: torch.Tensor, n_src: int) -> torch.Tensor:
    """Invert an (L_dst,) slot->source map: (n_src,) destination slot of each
    source row, sentinel L_dst for rows no REAL destination reads.

    Only real destination slots are scattered (their sources are unique),
    so the result is deterministic; the JAX package also scatters empty
    destinations, which all read the same padding row, to an unspecified
    winner.  Both give padding rows a slot whose pair sums are zero.
    """
    l_dst = lr_perm.shape[0]
    inv = torch.full((n_src + 1,), l_dst, dtype=torch.int64, device=lr_perm.device)
    dst = torch.arange(l_dst, device=lr_perm.device)
    # empty destinations write to the discarded last entry: no boolean
    # indexing, so no host sync
    inv[torch.where(lr_real, lr_perm, n_src)] = dst
    return inv[:n_src]


def to_binned_system(system, grid: BinGrid, lr_grid: BinGrid | None = None):
    """Convert a flat System into the slot-padded binned layout.

    Returns ``(binned_system, perm, overflow)``: ``perm`` maps the new slots
    to rows of ``system``, ``overflow`` is the (2,) int64 pair of dropped
    atoms ``[sr, lr]``.  Coordinates are wrapped into the cell.  ``lr_grid``
    attaches the coarse long-range twin layout.  Single shared cell only.
    ``system`` may itself be binned: MD re-bins its slot layout this way and
    carries its other per-atom arrays through ``perm``.
    """
    cell0 = system.cell[0] if system.cell is not None else None
    perm, wrap, overflow = bin_atoms(system.coord, system.numbers, grid, cell0)
    coord = system.coord
    if cell0 is not None:
        coord = coord - cellmul(wrap, cell0)
    binned = system.replace(
        coord=to_slots(coord, perm),
        numbers=to_slots(system.numbers, perm),
        mol_idx=to_slots(system.mol_idx, perm),
        bins=grid,
        lr_bins=None,
        lr_slot=None,
        lr_inv=None,
    )
    lr_ovf = torch.zeros_like(overflow)
    if lr_grid is not None:
        lr_perm, _lr_wrap, lr_ovf = bin_atoms(binned.coord, binned.numbers, lr_grid, cell0)
        lr_real = binned.numbers[lr_perm] > 0
        binned = binned.replace(
            lr_bins=lr_grid,
            lr_slot=lr_perm,
            lr_inv=invert_slot_map(lr_perm, lr_real, binned.coord.shape[0]),
        )
    return binned, perm, torch.stack([overflow, lr_ovf])
