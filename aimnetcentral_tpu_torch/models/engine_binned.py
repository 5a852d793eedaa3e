"""Binned pair sums: counterpart of aimnetcentral_tpu/models/engine_binned.py.

``pair_energy_binned`` is the half-stencil sweep of a symmetric pair term
(each unordered pair computed once, its value sent to both ends) through
kernels/pair_sweep.py: the CUDA kernels D and E for CUDA tensors, their plain
versions for CPU tensors.  On it sit DSF Coulomb and DFT-D3(BJ): the
coordination-number sweep, the factorised per-atom C6 vectors, and the
energy sweep, all on the coarse long-range twin layout; the short-range
Coulomb of v2 artifacts and GFN1 repulsion on the SR layout; the
real-space Ewald sum and D3 with the TS combination rule on the LR twin
layout; and simple Coulomb on the molecule-bin layout, which has no twin
(the sweeps fall back to its one grid, at radius 0).  The ConvSV message pass lives in
kernels/conv_pass.py.

The ``_multi`` sweeps are the fused ensemble's (models/ensemble_fused.py):
member-stacked charges or dispersion parameters (L, E) in, per-member
energies (num_mol, E) out, through the member forms of kernels D and E
(``pair_sweep.MemberTerm``): the pair's geometry and its member-independent
factor are computed once and each member's product from it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from aimnetcentral_tpu_torch import constants
from aimnetcentral_tpu_torch.kernels.pair_sweep import (
    CoulombSimpleTerm,
    CoulombSRTerm,
    D3CNTerm,
    D3EnergyTerm,
    D3TSTerm,
    DSFTerm,
    EwaldRealTerm,
    MemberTerm,
    PairAcc,
    PairStatic,
    PairTerm,
    SRRepTerm,
    pack_extras,
)
from aimnetcentral_tpu_torch.models.lr import FACTOR
from aimnetcentral_tpu_torch.ops import binned as B
from aimnetcentral_tpu_torch.ops.binned import stencil_radius
from aimnetcentral_tpu_torch.ops.math import cellmul
from aimnetcentral_tpu_torch.ops.nb import mol_sum
from aimnetcentral_tpu_torch.system import System


@functools.lru_cache(maxsize=16)
def _half_tables(grid: B.BinGrid, radius: int):
    """Host tables of the half stencil: the zero offset plus every offset
    lexicographically above it.  ``inv[s]`` inverts ``nbr[s]`` (sentinel B
    for bins no step-s source points at): the plain sweep's mirror sums
    arrive through it by a gather instead of a scatter-add (``index_add_``
    is a float atomic on CUDA, and not deterministic), and kernels D and E
    read it as the candidate bins of the lower half of the full stencil."""
    nbr, wraps, is_zero = B.stencil_tables(grid, radius)
    offs = B.stencil_offsets(radius)
    half = np.array([bool(z) or tuple(o) > (0, 0, 0) for o, z in zip(offs, is_zero)])
    nbr, wraps = nbr[half], wraps[half]
    b_tot = grid.total_bins
    inv = np.full(nbr.shape, b_tot, np.int64)
    for s in range(nbr.shape[0]):
        ok = nbr[s] >= 0
        inv[s, nbr[s][ok]] = np.arange(b_tot)[ok]
    return nbr, wraps, inv


@functools.lru_cache(maxsize=16)
def _device_half_tables(grid: B.BinGrid, radius: int, device: torch.device):
    """``_half_tables`` uploaded to ``device`` once per (grid, radius,
    device), so that a force evaluation copies no table from the host."""
    return tuple(torch.as_tensor(t, device=device) for t in _half_tables(grid, radius))


def pair_operands(
    system: System,
    cutoff: float,
    term: PairTerm,
    extra_blocks: dict[str, torch.Tensor],
    layout: str = "sr",
) -> tuple[PairStatic, dict[str, torch.Tensor]]:
    """The sweep's static shapes and operands in the kernels' layout:
    ``coord`` (B, C, 3), ``ext`` (B, C, K), ``shift`` (S, B, 3) (both
    differentiable), ``mask`` (B, C), ``nbr`` (S, B) int32, ``inv`` (S, B).
    ``layout="lr"`` takes the coarse twin layout when attached."""
    grid, lr_slot = system.bins, None
    if layout == "lr" and system.lr_bins is not None:
        grid, lr_slot = system.lr_bins, system.lr_slot
    radius = stencil_radius(cutoff, grid)
    dev = system.device
    nbr, wraps, inv = _device_half_tables(grid, radius, dev)
    coord, numbers, ext = system.coord, system.numbers, pack_extras(term, extra_blocks)
    if lr_slot is not None:
        coord, numbers, ext = coord[lr_slot], numbers[lr_slot], ext[lr_slot]
    b_tot, c = grid.total_bins, grid.capacity
    s_tot = nbr.shape[0]
    if system.cell is not None and grid.periodic:
        shift = cellmul(wraps, system.cell[0])
    else:
        shift = torch.zeros((s_tot, b_tot, 3), dtype=coord.dtype, device=dev)
    st = PairStatic(
        b_tot=b_tot, c=c, s_tot=s_tot, k=ext.shape[-1], cutoff=float(cutoff), ns=len(term.scalar_keys),
        members=term.n if isinstance(term, MemberTerm) else 0,
    )
    ops = {
        "coord": coord.reshape(b_tot, c, 3).contiguous(),
        "ext": ext.reshape(b_tot, c, -1).to(coord.dtype).contiguous(),
        "shift": shift.contiguous(),
        "mask": (numbers > 0).to(coord.dtype).reshape(b_tot, c).contiguous(),
        "nbr": nbr,
        "inv": inv,
    }
    return st, ops


def pair_energy_binned(
    system: System,
    cutoff: float,
    term: PairTerm,
    extra_blocks: dict[str, torch.Tensor],
    layout: str = "sr",
) -> torch.Tensor:
    """Sum a SYMMETRIC pair term over all pairs within ``cutoff``: per-atom
    (ordered-pair convention) sums (L,) in the SR slot layout, (L, E) for
    a member form (JAX's ``n_out=E``).

    ``term`` is a term spec of kernels/pair_sweep.py and ``extra_blocks``
    its per-atom extras in SR slot order.  ``layout="lr"`` sweeps the coarse
    twin layout when attached.  The sweep runs kernel D (its backward kernel
    E) for CUDA tensors and the plain version for CPU tensors.
    """
    st, ops = pair_operands(system, cutoff, term, extra_blocks, layout)
    out = PairAcc.apply(ops["coord"], ops["ext"], ops["shift"], st, term, ops["mask"], ops["nbr"], ops["inv"])
    acc = out.reshape((st.b_tot * st.c,) + out.shape[2:])
    if layout == "lr" and system.lr_bins is not None:
        # back to SR slot order through the inverse map: a gather
        acc = torch.cat([acc, acc.new_zeros((1,) + acc.shape[1:])])[system.lr_inv]
    return acc


def pair_sum_binned(
    system: System,
    cutoff: float,
    term: PairTerm,
    extra_blocks: dict[str, torch.Tensor],
    layout: str = "sr",
) -> torch.Tensor:
    """Alias of :func:`pair_energy_binned` for non-energy per-atom pair sums
    (coordination numbers)."""
    return pair_energy_binned(system, cutoff, term, extra_blocks, layout)


def coulomb_dsf_binned(
    system: System,
    q: torch.Tensor,
    rc: float,
    dsf_alpha: float,
    dsf_rc: float,
    envelope: str,
    subtract_sr: bool,
) -> torch.Tensor:
    """Damped-shifted-force Coulomb on the LR twin layout, with the SR
    envelope part subtracted in the same sweep (per-molecule energies)."""
    term = DSFTerm(alpha=dsf_alpha, dsf_rc=dsf_rc, rc=rc, envelope=envelope, subtract_sr=subtract_sr)
    e_i = pair_energy_binned(system, dsf_rc, term, {"q": q}, layout="lr")
    e = FACTOR * mol_sum(e_i, system.mol_idx, system.num_mol)
    self_coeff = -(term.shift_val / 2.0 + dsf_alpha / math.sqrt(math.pi))
    q_real = torch.where(system.numbers > 0, q, 0.0)
    return e + 2.0 * FACTOR * mol_sum(self_coeff * q_real * q_real, system.mol_idx, system.num_mol)


def coulomb_dsf_binned_multi(
    system: System,
    q: torch.Tensor,
    rc: float,
    dsf_alpha: float,
    dsf_rc: float,
    envelope: str,
    subtract_sr: bool,
) -> torch.Tensor:
    """Member-stacked :func:`coulomb_dsf_binned`: charges (L, E) ->
    per-member energies (num_mol, E), one sweep of DSF's member form."""
    term = DSFTerm(alpha=dsf_alpha, dsf_rc=dsf_rc, rc=rc, envelope=envelope, subtract_sr=subtract_sr)
    e_i = pair_energy_binned(system, dsf_rc, MemberTerm(term, q.shape[1]), {"q": q}, layout="lr")
    e = FACTOR * mol_sum(e_i, system.mol_idx, system.num_mol)
    self_coeff = -(term.shift_val / 2.0 + dsf_alpha / math.sqrt(math.pi))
    q_real = torch.where((system.numbers > 0)[:, None], q, 0.0)
    return e + 2.0 * FACTOR * mol_sum(self_coeff * q_real * q_real, system.mol_idx, system.num_mol)


def coulomb_sr_binned(system: System, q: torch.Tensor, rc: float, envelope: str) -> torch.Tensor:
    """Short-range Coulomb ``fc(d) q_i q_j / d`` within ``rc`` on the SR
    layout, spatial or molecule bins (per-molecule energies; the
    counterpart of models/lr.py::coulomb_sr).  The SR grid's stencil reaches
    the model cutoff, at or beyond ``rc``."""
    e_i = pair_energy_binned(system, float(rc), CoulombSRTerm(rc=rc, envelope=envelope), {"q": q})
    return FACTOR * mol_sum(e_i, system.mol_idx, system.num_mol)


def coulomb_sr_binned_multi(system: System, q: torch.Tensor, rc: float, envelope: str) -> torch.Tensor:
    """Member-stacked :func:`coulomb_sr_binned`: (L, E) -> (num_mol, E)."""
    term = MemberTerm(CoulombSRTerm(rc=rc, envelope=envelope), q.shape[1])
    e_i = pair_energy_binned(system, float(rc), term, {"q": q})
    return FACTOR * mol_sum(e_i, system.mol_idx, system.num_mol)


def coulomb_simple_binned(
    system: System, q: torch.Tensor, rc: float, envelope: str, subtract_sr: bool
) -> torch.Tensor:
    """Unbounded pairwise Coulomb, optionally minus the SR-envelope part
    (per-molecule energies; the counterpart of models/lr.py::coulomb_simple).
    Exact only on the molecule-bin layout, where the radius-0 sweep at
    cutoff inf meets every pair of a molecule; on a spatial grid the stencil
    would cut 1/r off (periodic systems switch to DSF)."""
    if system.bins is None or not system.bins.molecule_bins:
        raise ValueError("simple Coulomb on the binned engine needs the molecule-bin layout")
    term = CoulombSimpleTerm(rc=rc, envelope=envelope, subtract_sr=subtract_sr)
    e_i = pair_energy_binned(system, math.inf, term, {"q": q})
    return FACTOR * mol_sum(e_i, system.mol_idx, system.num_mol)


def coulomb_simple_binned_multi(
    system: System, q: torch.Tensor, rc: float, envelope: str, subtract_sr: bool
) -> torch.Tensor:
    """Member-stacked :func:`coulomb_simple_binned` (molecule bins only):
    (L, E) -> (num_mol, E)."""
    if system.bins is None or not system.bins.molecule_bins:
        raise ValueError("simple Coulomb on the binned engine needs the molecule-bin layout")
    term = MemberTerm(CoulombSimpleTerm(rc=rc, envelope=envelope, subtract_sr=subtract_sr), q.shape[1])
    e_i = pair_energy_binned(system, math.inf, term, {"q": q})
    return FACTOR * mol_sum(e_i, system.mol_idx, system.num_mol)


def ewald_real_binned(
    system: System,
    q: torch.Tensor,
    eta: float,
    r_cutoff_static: float,
    subtract_sr: bool = False,
    rc: float = 4.6,
    envelope: str = "exp",
) -> torch.Tensor:
    """The real-space Ewald sum on the LR twin layout, per molecule and
    without k_e (the counterpart of JAX's ewald_real_binned).  ``eta`` and
    the cutoff are host floats: a launch constant and the stencil's reach.
    With ``subtract_sr`` the same sweep takes off the SR-envelope part
    ``fc(d) q_i q_j / d`` within ``rc``, which is ``coulomb_sr_binned / k_e``:
    one launch of D and E where JAX sweeps twice."""
    term = EwaldRealTerm(eta=float(eta), rc=float(rc), envelope=envelope, subtract_sr=subtract_sr)
    e_i = pair_energy_binned(system, float(r_cutoff_static), term, {"q": q}, layout="lr")
    return 0.5 * mol_sum(e_i, system.mol_idx, system.num_mol)


def ewald_real_binned_multi(
    system: System,
    q: torch.Tensor,
    eta: float,
    r_cutoff_static: float,
    subtract_sr: bool = False,
    rc: float = 4.6,
    envelope: str = "exp",
) -> torch.Tensor:
    """Member-stacked :func:`ewald_real_binned`: (L, E) -> (num_mol, E),
    no k_e, with the SR part inside the same sweep when ``subtract_sr``."""
    term = EwaldRealTerm(eta=float(eta), rc=float(rc), envelope=envelope, subtract_sr=subtract_sr)
    e_i = pair_energy_binned(system, float(r_cutoff_static), MemberTerm(term, q.shape[1]), {"q": q}, layout="lr")
    return 0.5 * mol_sum(e_i, system.mol_idx, system.num_mol)


def srrep_binned(system: System, gfn1_ab: torch.Tensor, rc: float, cutoff_fn: str) -> torch.Tensor:
    """GFN1 short-range repulsion within ``rc`` on the SR layout (per
    molecule; the counterpart of models/lr.py::srrep_energy, which sums the
    SR list instead)."""
    p = gfn1_ab[system.numbers]  # (L, 2) = (alpha, zeff)
    term = SRRepTerm(rc=float(rc), cutoff_fn=cutoff_fn)
    e_i = pair_energy_binned(system, float(rc), term, {"alpha": p[:, 0], "zeff": p[:, 1]})
    return mol_sum(e_i, system.mol_idx, system.num_mol)


def d3ts_binned(
    system: System,
    params: dict[str, torch.Tensor],
    disp_param: torch.Tensor,
    a1: float,
    a2: float,
    s8: float,
    s6: float = 1.0,
    cutoff: float = 15.0,
) -> torch.Tensor:
    """D3 dispersion with the TS combination rule over the network's
    per-atom C6 and alpha (``disp_param`` (L, 2)) on the LR twin layout at
    ``cutoff``, no switch (the counterpart of models/lr.py::d3ts_energy)."""
    extras = {"c6": disp_param[:, 0], "alpha": disp_param[:, 1], "rr": params["r4r2"][system.numbers]}
    e_i = pair_energy_binned(system, cutoff, D3TSTerm(a1=a1, a2=a2, s8=s8, s6=s6), extras, layout="lr")
    return constants.half_Hartree * mol_sum(e_i, system.mol_idx, system.num_mol)


def d3ts_binned_multi(
    system: System,
    params: dict[str, torch.Tensor],
    disp_param: torch.Tensor,
    a1: float,
    a2: float,
    s8: float,
    s6: float = 1.0,
    cutoff: float = 15.0,
) -> torch.Tensor:
    """Member-stacked :func:`d3ts_binned`: ``disp_param`` (L, E, 2) ->
    (num_mol, E); r4r2, rr, r0 and the damping are shared, each member pays
    its TS combination."""
    term = MemberTerm(D3TSTerm(a1=a1, a2=a2, s8=s8, s6=s6), disp_param.shape[1])
    extras = {"c6": disp_param[..., 0], "alpha": disp_param[..., 1], "rr": params["r4r2"][system.numbers]}
    e_i = pair_energy_binned(system, cutoff, term, extras, layout="lr")
    return constants.half_Hartree * mol_sum(e_i, system.mol_idx, system.num_mol)


def dftd3_binned(
    system: System,
    tables: dict[str, torch.Tensor],
    a1: float,
    a2: float,
    s8: float,
    s6: float = 1.0,
    smoothing_on: float = 12.0,
    smoothing_off: float = 15.0,
) -> torch.Tensor:
    """DFT-D3(BJ) on the binned layout through an exactly factorised C6
    (per-molecule energies).

    The D3 reference tables factorise: ``c6_ij = P_i^T M P_j`` with
    ``P_i = weights(cn_i) x onehot(species_i)`` and M a constant (5S x 5S)
    matrix over the S species present (static on the System).  Two sweeps
    on the LR twin layout: the coordination numbers, then the energy with
    ``c6_ij = p_i . r_j``, r = M p.
    """
    if system.species is None:
        raise ValueError("binned D3 needs System.species (set by builders)")
    if not system.species:  # no real atom (a data-parallel rank's empty part)
        return system.coord.new_zeros(system.num_mol)
    cn = pair_sum_binned(
        system, smoothing_off, D3CNTerm(), {"rcov": tables["rcov"][system.numbers]}, layout="lr"
    )
    extras = d3_pair_extras(system.species, system.numbers, cn, tables)
    term = D3EnergyTerm(a1=a1, a2=a2, s8=s8, s6=s6, r_on=smoothing_on, r_off=smoothing_off)
    e_i = pair_energy_binned(system, smoothing_off, term, extras, layout="lr")
    return constants.half_Hartree * mol_sum(e_i, system.mol_idx, system.num_mol)


@functools.lru_cache(maxsize=16)
def _d3_species_tables(species: tuple[int, ...]):
    """Host factorisation over the species present: ``nref`` (S,) reference
    counts, ``cnref`` (S, 5) reference coordination numbers and M (5S, 5S),
    M[(k, a), (l, b)] = c6ab[a, b, k, l]."""
    s_count = len(species)
    sp = np.asarray(species)
    t = constants.get_d3_tables()
    c6_sp = t["c6ab"][sp[:, None], sp[None, :]]  # (S, S, 5, 5)
    cn_sp = t["cn_ref"][sp[:, None], sp[None, :]]
    nz = c6_sp != 0
    nref = nz.any(axis=(1, 3)).sum(axis=1).astype(np.int64)
    cnref = np.zeros((s_count, 5), dtype=np.float32)
    for a in range(s_count):
        for k in range(5):
            vals = cn_sp[a, :, k, :][nz[a, :, k, :]]
            cnref[a, k] = vals[0] if len(vals) else 0.0
    m_mat = np.transpose(c6_sp, (2, 0, 3, 1)).reshape(5 * s_count, 5 * s_count)
    return nref, cnref, np.ascontiguousarray(m_mat, dtype=np.float32)


@functools.lru_cache(maxsize=16)
def _d3_device_tables(species: tuple[int, ...], device: torch.device):
    """The species map (95,) and ``_d3_species_tables`` on ``device``,
    uploaded once per (species, device)."""
    zmap = np.zeros(95, dtype=np.int64)
    for i, z in enumerate(species):
        zmap[z] = i
    return tuple(torch.as_tensor(t, device=device) for t in (zmap, *_d3_species_tables(species)))


def d3_pair_extras(
    species: tuple[int, ...], numbers: torch.Tensor, cn: torch.Tensor, tables: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Factorised per-atom D3 vectors from the coordination numbers:
    ``p`` (L, 5S) Gaussian reference weights placed at the atom's species,
    ``r = p M^T`` (so ``c6_ij = p_i . r_j``) and ``rr`` = r4r2 (L,)."""
    s_count = len(species)
    dev = numbers.device
    zmap_t, nref, cnref, m_mat = _d3_device_tables(tuple(species), dev)
    spec_idx = zmap_t[numbers]
    k_ids = torch.arange(5, device=dev)
    w = torch.exp(-4.0 * (cn[:, None] - cnref[spec_idx]) ** 2)
    w = torch.where(k_ids[None, :] < nref[spec_idx][:, None], w, 0.0)
    wsum = w.sum(-1)
    v = w / torch.clamp(wsum, min=1e-12)[:, None]
    v = torch.where((wsum > 1e-12)[:, None], v, 0.0)
    onehot = (spec_idx[:, None] == torch.arange(s_count, device=dev)).to(v.dtype)  # no host sync
    p_vec = (v[:, :, None] * onehot[:, None, :]).reshape(-1, 5 * s_count)
    r_vec = p_vec @ m_mat.T
    return {"p": p_vec, "r": r_vec, "rr": tables["r4r2"][numbers]}
