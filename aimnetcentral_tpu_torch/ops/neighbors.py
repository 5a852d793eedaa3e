"""Neighbor-matrix builders (counterpart of aimnetcentral_tpu/ops/neighbors.py).

Host numpy builders for the indexed layout, copied from the JAX package:
capacity is a static shape chosen from the pairs found (or a density
heuristic), and builders report the largest row count so that callers can
rebuild on overflow.  ``nbmat_within_cutoff`` is the on-device O(N^2)
builder in torch.

Conventions (see system.py): flat padded atoms, nbmat ``(N, M)`` with fill
``N - 1`` (the last row is guaranteed padding), ordered pairs (both (i, j)
and (j, i) present), int8 lattice image counts against the ORIGINAL
coordinates.  The host builders return int32 index arrays; the System
stores them as int64 tensors.  scipy is imported inside the kd-tree build
only.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def density_max_neighbors(cutoff: float, n_atoms_hint: int | None = None, density: float = 0.2) -> int:
    """Density-based capacity heuristic, rounded up to 16
    (reference aimnet/calculators/neighbors.py:56-58)."""
    sphere = 4.0 / 3.0 * math.pi * cutoff**3
    m = max(16, ((int(density * sphere) + 15) // 16) * 16)
    if n_atoms_hint is not None:
        m = min(m, max(1, n_atoms_hint - 1))
    return m


def allpairs_nbmat(mol_sizes: list[int], n_pad: int, max_mol_size: int | None = None) -> np.ndarray:
    """All-pairs intra-molecular neighbor matrix for a packed batch.

    ``mol_sizes`` are the real atom counts per molecule (packed contiguously);
    ``n_pad`` is the total padded atom count (>= sum + 1).  Capacity
    M = max(mol_sizes) - 1 unless overridden.
    """
    fill = n_pad - 1
    m_cap = (max_mol_size or max(mol_sizes)) - 1
    m_cap = max(m_cap, 1)
    nbmat = np.full((n_pad, m_cap), fill, dtype=np.int32)
    off = 0
    for sz in mol_sizes:
        idx = np.arange(sz)
        # row i: all other atoms of the molecule
        others = (idx[None, :] + idx[:, None] + 1) % sz + off  # cyclic enumeration, excludes self
        nbmat[off : off + sz, : sz - 1] = others[:, : sz - 1]
        off += sz
    return nbmat


def brute_force_nbmat(
    coord: np.ndarray,
    mol_idx: np.ndarray,
    cutoff: float,
    max_neighbors: int | None = None,
    cell: np.ndarray | None = None,
    n_pad: int | None = None,
    pbc_mol: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray | None, int]:
    """O(N^2) host-side neighbor matrix builder (tests + calculator fallback).

    Returns ``(nbmat, shifts_frac_or_None, max_seen)``.  For PBC, enumerates
    lattice images within the cutoff (single cell shared by all molecules, or
    per-molecule cells (B,3,3)).  ``pbc_mol`` (B,) bool marks which molecules
    are actually periodic in a mixed batch (the reference takes per-system
    pbc flags, aimnet/calculators/neighbors.py:309-321); cells of non-periodic
    molecules are placeholders and ignored.  ``coord`` holds real atoms only
    (n_real,3); the returned matrices have ``n_pad`` rows (default n_real+1).
    """
    n_real = coord.shape[0]
    n_pad = n_pad or (n_real + 1)
    fill = n_pad - 1

    pairs_i: list[np.ndarray] = []
    pairs_j: list[np.ndarray] = []
    pairs_s: list[np.ndarray] = []
    if cell is None:
        d = np.linalg.norm(coord[:, None, :] - coord[None, :, :], axis=-1)
        same_mol = mol_idx[:, None] == mol_idx[None, :]
        mask = (d < cutoff) & same_mol & ~np.eye(n_real, dtype=bool)
        ii, jj = np.nonzero(mask)
        pairs_i.append(ii)
        pairs_j.append(jj)
    else:
        cells = cell if cell.ndim == 3 else cell[None]
        # generous image range from cell heights
        for b in np.unique(mol_idx):
            sel = np.nonzero(mol_idx == b)[0]
            if pbc_mol is not None and not pbc_mol[b]:
                # gas-phase molecule inside a mixed batch: no images,
                # zero shifts (keeps the batch shift array aligned)
                xyz = coord[sel]
                d = np.linalg.norm(xyz[:, None, :] - xyz[None, :, :], axis=-1)
                mask = (d < cutoff) & ~np.eye(len(sel), dtype=bool)
                ii, jj = np.nonzero(mask)
                if len(ii):
                    pairs_i.append(sel[ii])
                    pairs_j.append(sel[jj])
                    pairs_s.append(np.zeros((len(ii), 3), dtype=np.int8))
                continue
            cb = cells[b if cells.shape[0] > 1 else 0]
            inv = np.linalg.inv(cb).T
            nrep = np.ceil(cutoff * np.linalg.norm(inv, axis=-1)).astype(int)
            # atoms may sit OUTSIDE the home cell; the image range must cover
            # the wrap span, not just the cutoff (pair needs shift s with
            # s + wrap_j - wrap_i within the cutoff range)
            xyz = coord[sel]
            wrap = np.floor(xyz.astype(np.float64) @ np.linalg.inv(cb))
            wspan = (wrap.max(axis=0) - wrap.min(axis=0)).astype(int)
            nrep = nrep + wspan
            rng = [np.arange(-r, r + 1) for r in nrep]
            shifts = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, 3)
            for s in shifts:
                disp = xyz[None, :, :] + (s.astype(np.float64) @ cb) - xyz[:, None, :]
                d = np.linalg.norm(disp, axis=-1)
                mask = d < cutoff
                if (s == 0).all():
                    mask &= ~np.eye(len(sel), dtype=bool)
                ii, jj = np.nonzero(mask)
                if len(ii):
                    pairs_i.append(sel[ii])
                    pairs_j.append(sel[jj])
                    pairs_s.append(np.broadcast_to(s, (len(ii), 3)))

    ii = np.concatenate(pairs_i) if pairs_i else np.zeros(0, dtype=int)
    jj = np.concatenate(pairs_j) if pairs_j else np.zeros(0, dtype=int)
    ss = np.concatenate(pairs_s) if pairs_s else None
    return _fill_nbmat(ii, jj, ss, n_pad, max_neighbors)


def _fill_nbmat(
    ii: np.ndarray,
    jj: np.ndarray,
    ss: np.ndarray | None,
    n_pad: int,
    max_neighbors: int | None,
) -> tuple[np.ndarray, np.ndarray | None, int]:
    """Scatter a (i, j[, shift]) pair list into the padded (n_pad, M) neighbor
    matrix.  Fully vectorized (sort by row + within-row rank) — the per-pair
    Python loop this replaces dominated host prep at 10k atoms.  Shifts are
    emitted as int8 (lattice image counts are tiny ints; the engines cast at
    use — ops/math.py calc_distances — and the 4x smaller array matters on
    bandwidth-starved hosts: the 10k-atom 15 A list is 170 MB in f32)."""
    fill = n_pad - 1
    counts = np.bincount(ii, minlength=n_pad) if len(ii) else np.zeros(n_pad, int)
    max_seen = int(counts.max()) if len(ii) else 0
    m_cap = max_neighbors or max(1, ((max_seen + 15) // 16) * 16)

    nbmat = np.full((n_pad, m_cap), fill, dtype=np.int32)
    shifts_out = np.zeros((n_pad, m_cap, 3), dtype=np.int8) if ss is not None else None
    if len(ii):
        order = np.argsort(ii, kind="stable")
        ii_s, jj_s = ii[order], jj[order]
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        rank = np.arange(len(ii_s)) - starts[ii_s]
        keep = rank < m_cap
        nbmat[ii_s[keep], rank[keep]] = jj_s[keep]
        if shifts_out is not None:
            shifts_out[ii_s[keep], rank[keep]] = ss[order][keep]
    return nbmat, shifts_out, max_seen


def cell_list_nbmat(
    coord: np.ndarray,
    mol_idx: np.ndarray,
    cutoff: float,
    max_neighbors: int | None = None,
    cell: np.ndarray | None = None,
    n_pad: int | None = None,
    pbc_mol: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray | None, int]:
    """O(N) host-side neighbor builder with the contract of
    ``brute_force_nbmat``: a scipy cKDTree over wrapped coordinates plus
    ghost periodic images (the JAX package's ``_cell_list_nbmat_kdtree``;
    its numpy fallback for machines without scipy is not carried, since
    scipy is on every machine the port runs on).  Per-molecule cells;
    gas-phase molecules use the tree directly.  Returns ``(nbmat,
    shifts_frac, max_seen)`` with shifts defined against the ORIGINAL
    (unwrapped) coordinates, matching brute_force_nbmat exactly (pair sets
    equal; slot order may differ).
    """
    from scipy.spatial import cKDTree

    n_real = coord.shape[0]
    n_pad = n_pad or (n_real + 1)
    coord = np.asarray(coord, dtype=np.float64)
    has_cell = cell is not None
    cells = None if cell is None else (cell if cell.ndim == 3 else cell[None])

    all_i: list[np.ndarray] = []
    all_j: list[np.ndarray] = []
    all_s: list[np.ndarray] = []
    for b in np.unique(mol_idx):
        sel = np.nonzero(mol_idx == b)[0]
        xyz = coord[sel]
        if not has_cell or (pbc_mol is not None and not pbc_mol[b]):
            tree = cKDTree(xyz)
            res = tree.sparse_distance_matrix(tree, cutoff, output_type="ndarray")
            # structured-field views are strided; cast-copy once to int32
            ri = res["i"].astype(np.int32)
            rj = res["j"].astype(np.int32)
            keep = ri != rj
            ri, rj = ri[keep], rj[keep]
            all_i.append(sel[ri] if len(sel) < n_real else ri)
            all_j.append(sel[rj] if len(sel) < n_real else rj)
            if has_cell:
                # mixed batch: zero shifts keep the batch shift array aligned
                all_s.append(np.zeros((len(ri), 3), np.int8))
            continue
        cb = np.asarray(cells[b if cells.shape[0] > 1 else 0], dtype=np.float64)
        inv = np.linalg.inv(cb)
        fr = xyz @ inv
        wrap = np.floor(fr)
        already_wrapped = not wrap.any()  # builders wrap periodic coords
        xw = (fr - wrap) @ cb if not already_wrapped else xyz
        vol = abs(np.linalg.det(cb))
        heights = vol / np.linalg.norm(
            np.cross(np.roll(cb, -1, axis=0), np.roll(cb, -2, axis=0)), axis=1
        )
        reach = np.ceil(cutoff / heights).astype(int)
        assert (reach < 127).all(), "cell too thin for int8 image shifts"
        offs = np.stack(
            np.meshgrid(*[np.arange(-r, r + 1) for r in reach], indexing="ij"),
            axis=-1,
        ).reshape(-1, 3)
        offs = offs[(offs != 0).any(axis=1)]
        # ghost images clipped to the cutoff-expanded bounding box
        lo, hi = xw.min(axis=0) - cutoff, xw.max(axis=0) + cutoff
        nloc = len(sel)
        g_pts, g_src, g_sft = [xw], [np.arange(nloc, dtype=np.int32)], [
            np.zeros((nloc, 3), np.int8)
        ]
        for s in offs:
            g = xw + s @ cb
            keep = ((g >= lo) & (g <= hi)).all(axis=1)
            if keep.any():
                g_pts.append(g[keep])
                g_src.append(np.nonzero(keep)[0].astype(np.int32))
                g_sft.append(
                    np.broadcast_to(s.astype(np.int8), (int(keep.sum()), 3))
                )
        allpts = np.concatenate(g_pts)
        src = np.concatenate(g_src)
        sft = np.ascontiguousarray(np.concatenate(g_sft))
        res = cKDTree(xw).sparse_distance_matrix(
            cKDTree(allpts), cutoff, output_type="ndarray"
        )
        # structured-field views are strided; cast-copy once to int32 (every
        # later pass over the multi-million-row pair list is bandwidth-bound)
        ri = res["i"].astype(np.int32)
        rj = res["j"].astype(np.int32)
        keep = (rj != ri) | (rj >= nloc)  # drop self (zero-image, home block)
        ri, rj = ri[keep], rj[keep]
        lj, s_w = src[rj], sft[rj]
        all_i.append(sel[ri] if len(sel) < n_real else ri)
        all_j.append(sel[lj] if len(sel) < n_real else lj)
        # shift vs ORIGINAL coords: r_ij = (x_j - wrap_j cb + s_w cb) -
        # (x_i - wrap_i cb), so the image count is s_w - wrap_j + wrap_i;
        # when inputs arrive pre-wrapped the ghost image IS the shift and the
        # two per-pair wrap gathers are skipped entirely
        if already_wrapped:
            all_s.append(s_w)
        else:
            all_s.append(
                (s_w.astype(np.float64) - wrap[lj] + wrap[ri]).astype(np.int8)
            )

    ii = np.concatenate(all_i) if all_i else np.zeros(0, dtype=int)
    jj = np.concatenate(all_j) if all_j else np.zeros(0, dtype=int)
    ss = np.concatenate(all_s) if all_s else None
    return _fill_nbmat(ii, jj, ss, n_pad, max_neighbors)


def nbmat_within_cutoff(
    coord: torch.Tensor,
    mol_idx: torch.Tensor,
    numbers: torch.Tensor,
    cutoff: float,
    max_neighbors: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """On-device O(N^2) neighbor matrix (gas phase).

    Returns ``(nbmat (N, max_neighbors) int64, overflow_count ())``: pairs
    beyond capacity are dropped and counted, and the caller rebuilds with a
    larger capacity.  Suitable up to a few thousand atoms.
    """
    n = coord.shape[0]
    fill = n - 1
    d2 = ((coord[:, None, :] - coord[None, :, :]) ** 2).sum(-1)
    same = mol_idx[:, None] == mol_idx[None, :]
    real = (numbers > 0)[:, None] & (numbers > 0)[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=coord.device)
    ok = (d2 < cutoff * cutoff) & same & real & ~eye
    # stable top-M selection: valid candidates first, in index order
    idx = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)[:, :max_neighbors]
    taken_ok = torch.take_along_dim(ok, idx, dim=1)
    nbmat = torch.where(taken_ok, idx, torch.full_like(idx, fill))
    overflow = (ok.sum(dim=1) - max_neighbors).clamp(min=0).sum()
    return nbmat, overflow
