"""Host-side System builders (counterpart of aimnetcentral_tpu/builders.py).

``system_molecule_bins`` packs gas-phase molecules one to a bin (the
molecule-bin layout of batches and training).  ``system_from_molecules``
packs molecules into one flat padded System and, with ``build_nbmat=True``,
builds the indexed layout's neighbor matrices on the host (``host_nbmat``:
brute force for small systems, the O(N) cell list above
``_HOST_CELL_LIST_THRESHOLD`` atoms).  Without it the caller converts
the compact System into the slot layout with ops/binned.py::to_binned_system.
The JAX builder builds the matrices unless told not to; the port's default is
the other way round because its binned callers (calculator, MD driver) are
the older ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aimnetcentral_tpu_torch.ops.binned import BinGrid
from aimnetcentral_tpu_torch.ops.neighbors import allpairs_nbmat, brute_force_nbmat, cell_list_nbmat
from aimnetcentral_tpu_torch.system import System

# above this atom count, host neighbor builds use the O(N) cell list
_HOST_CELL_LIST_THRESHOLD = 512


def host_nbmat(coord, mol_idx, cutoff, max_neighbors=None, cell=None, n_pad=None, pbc_mol=None):
    """Dispatch host neighbor builds: the O(N) cell list for large systems,
    brute force below the threshold (lower constant cost)."""
    build = cell_list_nbmat if coord.shape[0] > _HOST_CELL_LIST_THRESHOLD else brute_force_nbmat
    return build(
        coord, mol_idx, cutoff, max_neighbors=max_neighbors, cell=cell, n_pad=n_pad, pbc_mol=pbc_mol
    )


def system_from_molecules(
    molecules: list[dict],
    device: torch.device,
    n_pad: int | None = None,
    *,
    cutoff: float | None = None,
    lr_cutoff: float | None = None,
    coulomb_cutoff: float | None = None,
    dftd3_cutoff: float | None = None,
    max_neighbors: int | None = None,
    build_nbmat: bool = False,
) -> System:
    """Pack molecules into one flat padded System on ``device``.

    Each molecule dict: ``coord`` (n, 3), ``numbers`` (n,), optional
    ``charge``, ``mult`` and ``cell`` (3, 3).  Periodic molecules are stored
    in the wrapped frame (coordinates inside the cell), as in the JAX
    package.  With ``build_nbmat``: ``cutoff=None`` on a gas-phase input
    gives the intra-molecular all-pairs matrix, otherwise a cutoff-bounded
    build; ``lr_cutoff`` adds the shared long-range list ``nbmat_lr``,
    ``coulomb_cutoff`` and ``dftd3_cutoff`` the split ones.
    """
    coords = [np.asarray(m["coord"], dtype=np.float32) for m in molecules]
    numbers = [np.asarray(m["numbers"], dtype=np.int64) for m in molecules]
    sizes = [len(c) for c in coords]
    n_real = sum(sizes)
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
    has_cell = any(c is not None for c in cells)
    cell = None
    if has_cell:
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
        return None if x is None else torch.as_tensor(x, device=device)

    def t_nb(nb):
        return None if nb is None else torch.as_tensor(nb.astype(np.int64), device=device)

    system = System(
        coord=t(coord),
        numbers=t(zs),
        charge=t(charge),
        mol_idx=t(mol_idx),
        mult=t(mult),
        cell=t(cell),
        species=tuple(sorted(int(z) for z in np.unique(zs) if z > 0)),
    )
    if not build_nbmat:
        return system

    # per-molecule periodicity for mixed batches
    pbc_mol = np.array([c is not None for c in cells]) if has_cell else None
    real_mol_idx = mol_idx[:n_real]
    if cutoff is None and not has_cell:
        nbmat, shifts = allpairs_nbmat(sizes, n_pad), None
    else:
        if cutoff is None:
            raise ValueError("periodic systems need an explicit cutoff")
        nbmat, shifts, _ = host_nbmat(
            coord[:n_real], real_mol_idx, cutoff, max_neighbors=max_neighbors,
            cell=cell, n_pad=n_pad, pbc_mol=pbc_mol,
        )

    def lr_build(rc):
        if rc is None:
            return None, None
        nb, sh, _ = host_nbmat(coord[:n_real], real_mol_idx, rc, cell=cell, n_pad=n_pad, pbc_mol=pbc_mol)
        return t_nb(nb), t(sh)

    # a shared LR list, or split per-module lists when the Coulomb and D3
    # cutoffs diverge (the caller decides which)
    nbmat_lr, shifts_lr = lr_build(lr_cutoff)
    nbmat_coulomb, shifts_coulomb = lr_build(coulomb_cutoff)
    nbmat_dftd3, shifts_dftd3 = lr_build(dftd3_cutoff)
    return dataclasses.replace(
        system,
        nbmat=t_nb(nbmat),
        shifts=t(shifts),
        nbmat_lr=nbmat_lr,
        shifts_lr=shifts_lr,
        nbmat_coulomb=nbmat_coulomb,
        shifts_coulomb=shifts_coulomb,
        nbmat_dftd3=nbmat_dftd3,
        shifts_dftd3=shifts_dftd3,
    )


def system_molecule_bins(
    molecules: list[dict],
    device: torch.device,
    capacity: int | None = None,
    pad_mols: int | None = None,
) -> System:
    """Pack gas-phase molecules into the molecule-bin layout: a
    (num_mol, 1, 1) grid whose bin k holds molecule k, of capacity C = the
    largest molecule rounded up to a multiple of 8.  Rows are molecule-major,
    each molecule's padded to C (coordinate 1.0, number 0, ``mol_idx`` =
    num_mol).  Every pair is within its bin, so every sweep runs at radius 0
    (``ops/binned.py::stencil_radius``) and an unbounded pair term (simple
    Coulomb) sums every pair of a molecule.  ``capacity`` and ``pad_mols``
    fix the shapes across batches; padding molecules hold no atoms.  With
    ``pad_mols``, ``molecules`` may be empty (a data-parallel rank's part of
    a short batch): ``pad_mols`` empty bins of ``capacity`` (8 without one).
    JAX's ``system_molecule_bins`` raises there."""
    num_real = len(molecules)
    if not num_real and not pad_mols:
        raise ValueError("no molecules and no pad_mols: the layout's shape is unknown")
    num_mol = pad_mols or num_real
    if num_mol < num_real:
        raise ValueError(f"pad_mols={num_mol} is below the {num_real} molecules given")
    sizes = [len(np.asarray(m["numbers"])) for m in molecules]
    largest = max(sizes, default=0)
    c = capacity or max(8, int(np.ceil(largest / 8)) * 8)
    if largest > c:
        raise ValueError(f"a molecule of {largest} atoms exceeds capacity {c}")
    if any(m.get("cell") is not None for m in molecules):
        raise ValueError("the molecule-bin layout is for gas-phase molecules")

    n_slots = num_mol * c
    coord = np.ones((n_slots, 3), dtype=np.float32)
    zs = np.zeros(n_slots, dtype=np.int64)
    mol_idx = np.full(n_slots, num_mol, dtype=np.int64)
    for i, m in enumerate(molecules):
        n = sizes[i]
        coord[i * c : i * c + n] = np.asarray(m["coord"], dtype=np.float32)
        zs[i * c : i * c + n] = np.asarray(m["numbers"], dtype=np.int64)
        mol_idx[i * c : i * c + n] = i

    charge = np.zeros(num_mol, dtype=np.float32)
    charge[:num_real] = [float(m.get("charge", 0.0)) for m in molecules]
    mult = None
    if any("mult" in m for m in molecules):
        mult = np.ones(num_mol, dtype=np.float32)
        mult[:num_real] = [float(m.get("mult", 1.0)) for m in molecules]
    # edge_hint is not read: the radius is 0 whatever the cutoff
    grid = BinGrid(nbins=(num_mol, 1, 1), capacity=c, edge_hint=1e30, periodic=False, molecule_bins=True)
    return System(
        coord=torch.as_tensor(coord, device=device),
        numbers=torch.as_tensor(zs, device=device),
        charge=torch.as_tensor(charge, device=device),
        mol_idx=torch.as_tensor(mol_idx, device=device),
        mult=None if mult is None else torch.as_tensor(mult, device=device),
        species=tuple(sorted(int(z) for z in np.unique(zs) if z > 0)),
        bins=grid,
    )


def stack_systems(systems: list[System]) -> System:
    """Stack same-shape Systems on a leading microbatch axis (counterpart of
    the JAX ``stack_systems``): every tensor field gains a leading axis, and
    the species sets are unified so that all microbatches share one static
    structure.  Static fields other than ``species`` must agree."""
    all_species = sorted({z for s in systems for z in (s.species or ())})
    species = tuple(all_species) if all_species else None
    out = {}
    for f in dataclasses.fields(System):
        vals = [getattr(s, f.name) for s in systems]
        if f.name == "species":
            out[f.name] = species
        elif all(v is None for v in vals):
            out[f.name] = None
        elif all(isinstance(v, torch.Tensor) for v in vals):
            out[f.name] = torch.stack(vals)
        elif all(v == vals[0] for v in vals):
            out[f.name] = vals[0]
        else:
            raise ValueError(f"cannot stack Systems whose {f.name} differ")
    return System(**out)
