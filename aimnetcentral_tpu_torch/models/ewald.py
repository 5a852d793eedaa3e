"""Periodic Coulomb by Ewald summation (counterpart of
aimnetcentral_tpu/models/ewald.py), differentiable by autograd to second
order, so forces, stress, Hessians and HVPs need nothing of their own.

Conventions: coordinates in Angstrom, charges in e, energies in eV, the
screening width ``eta`` of the real-space kernel ``erfc(d / (sqrt(2) eta))
/ d``.  The real-space sum runs over a neighbor list (indexed layout, the
exact ``erfc``) or through the pair kernels D and E on the binned layout's
LR grid (``engine_binned.ewald_real_binned``, the rational ``erfc_approx``
as in JAX); the reciprocal, self and background terms are layout-agnostic
plain torch (JAX leaves them to XLA too).  PME replaces the k-point sum by
models/pme.py when ``attach_ewald(pme=True)`` sized a mesh.

Exact products at every tier: the phase ``k . r`` reaches tens of radians
on a large box, where a TF32 coordinate (10 bits) would move it by
hundredths, and the structure factors sum thousands of terms.  So every
contraction here is written as multiplies and a sum, never as a matmul, and
no precision tier's TF32 flag reaches it (as ops/math.py::cellmul).  For
one cell the phase matrix is ``coord (N, 3) . kvec (K, 3)`` directly; for a
batch of cells each atom reads its own molecule's k-vectors (JAX's
``kdir`` (N, K, 3)).
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from aimnetcentral_tpu_torch import constants
from aimnetcentral_tpu_torch.ops import nb as nbops
from aimnetcentral_tpu_torch.ops.math import calc_distances, cellmul
from aimnetcentral_tpu_torch.system import System

KE = constants.Hartree * constants.Bohr  # e^2/Angstrom -> eV

# Above this atom count the exact Ewald's (N, K) phase matrix approaches the
# card's memory at fixed accuracy (K grows with N); the calculator warns and
# points at PME (the JAX package's calculators/calculator.py keeps the same
# limit).
EWALD_ATOM_GUIDANCE_LIMIT = 25_000


def warn_ewald_above_limit(n_total: int) -> None:
    """A warning instead of an out-of-memory failure for exact Ewald on
    very large systems."""
    if n_total > EWALD_ATOM_GUIDANCE_LIMIT:
        logging.getLogger(__name__).warning(
            "ewald at %d atoms will likely exhaust device memory (the (N, K) phase matrix grows "
            "with N at fixed accuracy); use set_lrcoulomb_method('pme') - it matches Ewald "
            "accuracy and scales linearly",
            n_total,
        )


@dataclasses.dataclass(frozen=True)
class EwaldParams:
    """Host-side Ewald discretisation."""

    eta: float
    r_cutoff: float
    k_cutoff: float
    kmax: tuple[int, int, int]


def estimate_ewald_parameters(cell: np.ndarray, n_atoms: int, accuracy: float = 1e-6) -> EwaldParams:
    """Balance real- and reciprocal-space work for ``accuracy``."""
    volume = abs(np.linalg.det(np.asarray(cell, dtype=np.float64)))
    eta = (volume**2 / max(n_atoms, 1)) ** (1.0 / 6.0) / math.sqrt(2.0 * math.pi)
    w = math.sqrt(-2.0 * math.log(accuracy))
    r_cutoff = w * eta
    k_cutoff = w / eta
    recip = 2.0 * math.pi * np.linalg.inv(np.asarray(cell, dtype=np.float64)).T
    b_norm = np.linalg.norm(recip, axis=1)
    kmax = tuple(int(np.ceil(k_cutoff / b)) for b in b_norm)
    return EwaldParams(eta=eta, r_cutoff=r_cutoff, k_cutoff=k_cutoff, kmax=kmax)


def _k_grid(kmax: tuple[int, int, int]) -> np.ndarray:
    """Integer reciprocal lattice points in the box ``kmax``, zero excluded."""
    rng = [np.arange(-k, k + 1) for k in kmax]
    pts = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, 3)
    return pts[np.any(pts != 0, axis=1)].astype(np.float32)


def _param_views(eta, r_cutoff, num_mol: int, mol_idx: torch.Tensor, dtype: torch.dtype):
    """Scalar-or-(num_mol,) parameters as per-molecule (B,) and per-atom
    (N,) views; padding atoms (``mol_idx == B``) read eta 1 and cutoff 0.
    A host number becomes a fill on the device, never a copy (which would
    wait for the stream)."""
    ones_b = torch.ones((num_mol,), dtype=dtype, device=mol_idx.device)

    def per_mol(x):
        return x.to(dtype).reshape(-1) * ones_b if isinstance(x, torch.Tensor) else ones_b * float(x)

    eta_b, rcut_b = per_mol(eta), per_mol(r_cutoff)
    eta_at = torch.cat([eta_b, ones_b[:1]])[mol_idx]
    rcut_at = torch.cat([rcut_b, torch.zeros_like(rcut_b[:1])])[mol_idx]
    return eta_b, rcut_b, eta_at, rcut_at


def _real_erfc_st(coord, q_st, cell, mol_idx, num_mol: int, nbmat, shifts, eta_at, rcut_at) -> torch.Tensor:
    """Real-space erfc pair sum on the indexed layout -> (num_mol, E), no
    k_e: one pair kernel for every member, each member one charge
    contraction (ordered pairs, factor 1/2)."""
    d_ij, _ = calc_distances(coord, nbmat, shifts, cell, mol_idx)
    valid = nbops.pair_mask(nbmat) & (d_ij < rcut_at[:, None])
    kern = torch.special.erfc(d_ij / (math.sqrt(2.0) * eta_at[:, None])) / d_ij
    e_pair = torch.where(valid, kern, torch.zeros_like(kern))  # (N, M)
    q_nb = nbops.gather_nb(q_st, nbmat)  # (N, M, E)
    e_real_i = (e_pair[..., None] * q_nb).sum(1) * q_st
    return 0.5 * nbops.mol_sum(e_real_i, mol_idx, num_mol)


def _self_bg_st(q_st, eta_b, eta_at, mol_idx, num_mol: int, volume) -> torch.Tensor:
    """Self-interaction and neutralising-background terms -> (num_mol, E),
    no k_e.  The background ``-pi Q^2 eta^2 / V`` makes a charged cell
    finite."""
    e_self = -nbops.mol_sum(q_st * q_st / eta_at[:, None], mol_idx, num_mol) / math.sqrt(2.0 * math.pi)
    q_tot = nbops.mol_sum(q_st, mol_idx, num_mol)  # (B, E)
    e_bg = -math.pi * q_tot * q_tot * (eta_b * eta_b)[:, None] / volume[:, None]
    return e_self + e_bg


def _phase(coord: torch.Tensor, kvec: torch.Tensor, mol_idx: torch.Tensor, num_mol: int) -> torch.Tensor:
    """The phase matrix ``k . r`` (N, K) in exact f32: one cell's k-vectors
    (K, 3) for every atom, or each atom its molecule's (padding atoms
    zero)."""
    if num_mol == 1:
        kd = kvec[0]  # (K, 3)
    else:
        kd = torch.cat([kvec, torch.zeros_like(kvec[:1])])[mol_idx]  # (N, K, 3)
    return (coord[:, 0:1] * kd[..., 0] + coord[:, 1:2] * kd[..., 1]) + coord[:, 2:3] * kd[..., 2]


def ewald_nonreal_multi(coord, q_st, cell, mol_idx, num_mol: int, eta, k_cutoff, k_pts) -> torch.Tensor:
    """Reciprocal, self and background terms (no k_e) -> (num_mol, E).  The
    phase matrix, its cos and sin and the Green weights are computed once;
    each member pays one charge contraction of them."""
    n_e = q_st.shape[1]
    eta_b, kcut_b, eta_at, _ = _param_views(eta, k_cutoff, num_mol, mol_idx, coord.dtype)
    recip = 2.0 * math.pi * torch.linalg.inv_ex(cell).inverse.transpose(1, 2)  # (B, 3, 3), no host sync
    kvec = cellmul(k_pts.to(coord.dtype), recip)  # (B, K, 3)
    k2 = (kvec * kvec).sum(-1)  # (B, K)
    kmask = (k2 > 1e-12) & (k2 < (kcut_b * kcut_b)[:, None])
    phase = _phase(coord, kvec, mol_idx, num_mol)
    cos_p, sin_p = torch.cos(phase), torch.sin(phase)
    volume = torch.abs(torch.linalg.det(cell))  # (B,)
    green = torch.exp(-0.5 * (eta_b * eta_b)[:, None] * k2) / torch.where(kmask, k2, torch.ones_like(k2))
    w = torch.where(kmask, green, torch.zeros_like(green))
    if num_mol == 1:
        # one cell: the structure factors are column sums of the shared trig images
        s2 = torch.stack(
            [(cos_p * q_st[:, e : e + 1]).sum(0) ** 2 + (sin_p * q_st[:, e : e + 1]).sum(0) ** 2 for e in range(n_e)],
            dim=-1,
        )  # (K, E)
        e_recip = (2.0 * math.pi / volume)[:, None] * (w[0][:, None] * s2).sum(0)[None]
    else:
        e_recip = torch.stack(
            [
                (
                    w
                    * (
                        nbops.mol_sum(q_st[:, e, None] * cos_p, mol_idx, num_mol) ** 2
                        + nbops.mol_sum(q_st[:, e, None] * sin_p, mol_idx, num_mol) ** 2
                    )
                ).sum(-1)
                * (2.0 * math.pi / volume)
                for e in range(n_e)
            ],
            dim=-1,
        )  # (B, E)
    return e_recip + _self_bg_st(q_st, eta_b, eta_at, mol_idx, num_mol, volume)


def ewald_energy_multi(
    coord, q_st, cell, mol_idx, num_mol: int, numbers, nbmat, shifts, eta, r_cutoff, k_cutoff, k_pts
) -> torch.Tensor:
    """Ewald on the indexed layout for member-stacked charges (N, E) ->
    (num_mol, E) in eV."""
    q_st = torch.where((numbers > 0)[:, None], q_st, torch.zeros_like(q_st))
    _eta_b, _rcut_b, eta_at, rcut_at = _param_views(eta, r_cutoff, num_mol, mol_idx, coord.dtype)
    e_real = _real_erfc_st(coord, q_st, cell, mol_idx, num_mol, nbmat, shifts, eta_at, rcut_at)
    e_other = ewald_nonreal_multi(coord, q_st, cell, mol_idx, num_mol, eta, k_cutoff, k_pts)
    return KE * (e_real + e_other)


def ewald_energy(
    coord, charges, cell, mol_idx, num_mol: int, numbers, nbmat, shifts, eta, r_cutoff, k_cutoff, k_pts
) -> torch.Tensor:
    """Total Ewald energy per molecule (num_mol,) in eV: the real-space sum
    over the cutoff-bounded list ``nbmat``, the reciprocal sum over
    ``k_pts``, self and background terms.  ``eta``, ``r_cutoff`` and
    ``k_cutoff`` are scalars or per-molecule (num_mol,)."""
    return ewald_energy_multi(
        coord, charges[:, None], cell, mol_idx, num_mol, numbers, nbmat, shifts, eta, r_cutoff, k_cutoff, k_pts
    )[:, 0]


def coulomb_periodic_multi(q_st: torch.Tensor, system: System, method: str = "ewald") -> torch.Tensor:
    """Periodic Coulomb on the indexed layout for member-stacked charges
    (N, E) -> (num_mol, E) in eV: Ewald, or PME's reciprocal sum when
    ``method`` is "pme" and a mesh is attached."""
    if system.cell is None:
        raise ValueError(f"{method} Coulomb requires a periodic cell")
    if system.ewald_kpts is None:
        raise ValueError("System lacks Ewald parameters; call models.ewald.attach_ewald first")
    nb, sh, _sfx = system.resolve_nb("_coulomb", "_lr", "")
    if sh is None:
        raise ValueError("periodic Coulomb requires a PBC neighbor matrix with shifts")
    if method == "pme" and system.pme_mesh is not None:
        from aimnetcentral_tpu_torch.models.pme import pme_reciprocal_energy_batched_multi

        num_mol, mol_idx = system.num_mol, system.mol_idx
        q_st = torch.where((system.numbers > 0)[:, None], q_st, torch.zeros_like(q_st))
        eta_b, _rcut_b, eta_at, rcut_at = _param_views(
            system.ewald_eta, system.ewald_r_cutoff, num_mol, mol_idx, system.coord.dtype
        )
        e_real = _real_erfc_st(system.coord, q_st, system.cell, mol_idx, num_mol, nb, sh, eta_at, rcut_at)
        e_recip = pme_reciprocal_energy_batched_multi(
            system.coord, q_st, system.cell, mol_idx, num_mol, eta_b, system.pme_mesh
        )
        volume = torch.abs(torch.linalg.det(system.cell))
        e_sb = _self_bg_st(q_st, eta_b, eta_at, mol_idx, num_mol, volume)
        return KE * (e_real + e_recip + e_sb)
    return ewald_energy_multi(
        system.coord, q_st, system.cell, system.mol_idx, system.num_mol, system.numbers, nb, sh,
        system.ewald_eta, system.ewald_r_cutoff, system.ewald_k_cutoff, system.ewald_kpts,
    )


def coulomb_periodic(data: dict, system: System, method: str = "ewald", key_in: str = "charges") -> torch.Tensor:
    """Periodic Coulomb per molecule (num_mol,) on the indexed layout; the
    discretisation, at the head's accuracy, comes from ``attach_ewald``."""
    return coulomb_periodic_multi(data[key_in][:, None], system, method=method)[:, 0]


def coulomb_periodic_binned(
    data: dict,
    system: System,
    key_in: str = "charges",
    subtract_sr: bool = False,
    rc: float = 4.6,
    envelope: str = "exp",
) -> torch.Tensor:
    """Ewald (or PME, with a mesh attached) on the binned layout: the
    real-space sum through kernels D and E on the LR grid, the rest
    layout-agnostic.  A binned System holds one molecule.  With
    ``subtract_sr`` the result is JAX's ``coulomb_periodic_binned`` minus
    ``coulomb_sr_binned``: the SR part leaves in the real-space sweep."""
    from aimnetcentral_tpu_torch.models.engine_binned import ewald_real_binned

    if system.cell is None:
        raise ValueError("periodic Coulomb requires a cell")
    if system.ewald_kpts is None or system.ewald_r_static is None:
        raise ValueError("call models.ewald.attach_ewald on the System first")
    q = torch.where(system.numbers > 0, data[key_in], torch.zeros_like(data[key_in]))
    eta = system.ewald_eta.reshape(-1)[0]
    k_cutoff = system.ewald_k_cutoff.reshape(-1)[0]
    e_real = ewald_real_binned(
        system, q, system.ewald_eta_static[0], system.ewald_r_static, subtract_sr, rc, envelope
    )
    if system.pme_mesh is not None:
        from aimnetcentral_tpu_torch.models.pme import pme_reciprocal_energy_batched

        eta_b, _r, eta_at, _rc = _param_views(eta, 0.0, system.num_mol, system.mol_idx, system.coord.dtype)
        e_recip = pme_reciprocal_energy_batched(
            system.coord, q, system.cell, system.mol_idx, system.num_mol, eta.reshape(1), system.pme_mesh
        )
        volume = torch.abs(torch.linalg.det(system.cell))
        e_sb = _self_bg_st(q[:, None], eta_b, eta_at, system.mol_idx, system.num_mol, volume)[:, 0]
        return KE * (e_real + e_recip + e_sb)
    e_other = ewald_nonreal_multi(
        system.coord, q[:, None], system.cell, system.mol_idx, system.num_mol, eta, k_cutoff, system.ewald_kpts
    )[:, 0]
    return KE * (e_real + e_other)


def coulomb_periodic_binned_multi(
    system: System,
    q_st: torch.Tensor,
    subtract_sr: bool = False,
    rc: float = 4.6,
    envelope: str = "exp",
) -> torch.Tensor:
    """Member-stacked :func:`coulomb_periodic_binned`: charges (L, E) ->
    (num_mol, E) in eV.  One real-space sweep of the member form of kernels
    D and E (the SR part inside with ``subtract_sr``), the phase matrix
    (Ewald) or the spread geometry (PME) shared by the members."""
    from aimnetcentral_tpu_torch.models.engine_binned import ewald_real_binned_multi

    if system.cell is None:
        raise ValueError("periodic Coulomb requires a cell")
    if system.ewald_kpts is None or system.ewald_r_static is None:
        raise ValueError("call models.ewald.attach_ewald on the System first")
    q_st = torch.where((system.numbers > 0)[:, None], q_st, torch.zeros_like(q_st))
    eta = system.ewald_eta.reshape(-1)[0]
    k_cutoff = system.ewald_k_cutoff.reshape(-1)[0]
    e_real = ewald_real_binned_multi(
        system, q_st, system.ewald_eta_static[0], system.ewald_r_static, subtract_sr, rc, envelope
    )
    if system.pme_mesh is not None:
        from aimnetcentral_tpu_torch.models.pme import pme_reciprocal_energy_batched_multi

        eta_b, _r, eta_at, _rc = _param_views(eta, 0.0, system.num_mol, system.mol_idx, system.coord.dtype)
        e_recip = pme_reciprocal_energy_batched_multi(
            system.coord, q_st, system.cell, system.mol_idx, system.num_mol, eta.reshape(1), system.pme_mesh
        )
        volume = torch.abs(torch.linalg.det(system.cell))
        e_sb = _self_bg_st(q_st, eta_b, eta_at, system.mol_idx, system.num_mol, volume)
        return KE * (e_real + e_recip + e_sb)
    e_other = ewald_nonreal_multi(
        system.coord, q_st, system.cell, system.mol_idx, system.num_mol, eta, k_cutoff, system.ewald_kpts
    )
    return KE * (e_real + e_other)


def attach_ewald(system: System, accuracy: float = 1e-6, pme: bool = False) -> System:
    """Estimate the discretisation from the cells on the host and attach it.

    Heterogeneous batches get per-molecule eta and cutoffs; the shared
    integer k-grid covers the largest per-molecule kmax and each molecule
    masks it at its own k cutoff, so the accuracy holds for every cell.
    With ``pme=True`` also one FFT mesh covering every molecule's (a finer
    mesh is only more accurate)."""
    if system.cell is None:
        raise ValueError("Ewald needs a periodic cell")
    cells = system.cell.detach().cpu().numpy()
    numbers = system.numbers.cpu().numpy()
    mol_idx = system.mol_idx.cpu().numpy()
    etas, r_cuts, k_cuts = [], [], []
    kmax = (1, 1, 1)
    for m in range(system.num_mol):
        n_at = max(int(((mol_idx == m) & (numbers > 0)).sum()), 1)
        p = estimate_ewald_parameters(cells[m], n_at, accuracy)
        etas.append(p.eta)
        r_cuts.append(p.r_cutoff)
        k_cuts.append(p.k_cutoff)
        kmax = tuple(max(a, b) for a, b in zip(kmax, p.kmax))
    pme_mesh = None
    if pme:
        from aimnetcentral_tpu_torch.models.pme import estimate_pme_mesh

        meshes = [estimate_pme_mesh(cells[m], accuracy) for m in range(system.num_mol)]
        pme_mesh = tuple(max(mm[i] for mm in meshes) for i in range(3))
    dev = system.device
    eta32 = np.array(etas, dtype=np.float32)
    return system.replace(
        ewald_kpts=torch.as_tensor(_k_grid(kmax), device=dev),
        ewald_eta=torch.as_tensor(eta32, device=dev),
        ewald_r_cutoff=torch.as_tensor(np.array(r_cuts, dtype=np.float32), device=dev),
        ewald_k_cutoff=torch.as_tensor(np.array(k_cuts, dtype=np.float32), device=dev),
        ewald_r_static=float(max(r_cuts)),
        ewald_eta_static=tuple(float(e) for e in eta32),
        pme_mesh=pme_mesh,
    )
