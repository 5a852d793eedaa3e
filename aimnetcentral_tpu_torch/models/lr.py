"""Long-range physics on the indexed layout (counterpart of
aimnetcentral_tpu/models/lr.py): Coulomb (short-range part, simple, DSF),
GFN1 short-range repulsion, DFT-D3(BJ) dispersion and D3 with the TS
combination rule over the neighbor matrices, plus the constants and switch
the binned terms share.  Ewald and PME live in models/ewald.py and
models/pme.py.

Each term is written once and differentiated by autograd.  Per-molecule
sums are ``mol_sum``'s one-hot product; no ``index_add_``, ``scatter_add_``
or float atomic is used, so the results repeat bit for bit on the card.
Energies in eV, distances in Angstrom; ordered-pair sums carry the factor
``half_Hartree * Bohr``.
"""

from __future__ import annotations

import math

import torch

from aimnetcentral_tpu_torch import constants
from aimnetcentral_tpu_torch.ops import math as aops
from aimnetcentral_tpu_torch.ops import nb as nbops
from aimnetcentral_tpu_torch.system import System

FACTOR = constants.half_Hartree * constants.Bohr  # ordered-pair Coulomb prefactor


def ensure_dij(data: dict, system: System, suffix: str) -> dict:
    """Compute and cache d_ij for a neighbor-matrix suffix."""
    key = f"d_ij{suffix}"
    if key not in data:
        nb, sh, _ = system.resolve_nb(suffix)
        d, _ = aops.calc_distances(system.coord, nb, sh, system.cell, system.mol_idx)
        data = {**data, key: d}
    return data


def _pair_sum_energy(e_ij: torch.Tensor, valid: torch.Tensor, mol_idx: torch.Tensor, num_mol: int) -> torch.Tensor:
    """Masked ordered-pair energy -> per-molecule sum: the neighbor sum
    first, then the molecule sum."""
    e_i = torch.where(valid, e_ij, torch.zeros_like(e_ij)).sum(dim=-1)
    return nbops.mol_sum(e_i, mol_idx, num_mol)


def coulomb_sr(data: dict, system: System, rc, envelope: str, key_in: str = "charges") -> torch.Tensor:
    """Envelope-weighted short-range Coulomb on the base (SR) neighbor matrix."""
    data = ensure_dij(data, system, "")
    d_ij = data["d_ij"]
    q = data[key_in]
    q_ij = q[:, None] * nbops.gather_nb(q, system.nbmat)
    fc = aops.exp_cutoff(d_ij, rc) if envelope == "exp" else aops.cosine_cutoff(d_ij, rc)
    e_ij = fc * q_ij / d_ij
    valid = nbops.pair_mask(system.nbmat)
    return FACTOR * _pair_sum_energy(e_ij, valid, system.mol_idx, system.num_mol)


def coulomb_sr_multi(data: dict, system: System, rc, envelope: str, q_st: torch.Tensor) -> torch.Tensor:
    """Member-stacked :func:`coulomb_sr`: the envelope kernel once, each
    member's charge products (N, E) -> (num_mol, E)."""
    data = ensure_dij(data, system, "")
    d_ij = data["d_ij"]
    fc = aops.exp_cutoff(d_ij, rc) if envelope == "exp" else aops.cosine_cutoff(d_ij, rc)
    kernel = torch.where(nbops.pair_mask(system.nbmat), fc / d_ij, torch.zeros_like(d_ij))  # (N, M)
    q_nb = nbops.gather_nb(q_st, system.nbmat)  # (N, M, E)
    e_i = (kernel[..., None] * q_nb).sum(1) * q_st
    return FACTOR * nbops.mol_sum(e_i, system.mol_idx, system.num_mol)


def coulomb_simple(
    data: dict,
    system: System,
    rc,
    envelope: str = "exp",
    subtract_sr: bool = True,
    key_in: str = "charges",
) -> torch.Tensor:
    """Full pairwise Coulomb over the LR neighbor matrix, optionally minus
    the SR part the network has learned."""
    nb, _sh, suffix = system.resolve_nb("_coulomb", "_lr", "")
    data = ensure_dij(data, system, suffix)
    d_ij = data[f"d_ij{suffix}"]
    q = data[key_in]
    q_ij = q[:, None] * nbops.gather_nb(q, nb)
    e = FACTOR * _pair_sum_energy(q_ij / d_ij, nbops.pair_mask(nb), system.mol_idx, system.num_mol)
    if subtract_sr:
        e = e - coulomb_sr(data, system, rc, envelope, key_in)
    return e


def coulomb_dsf(
    data: dict,
    system: System,
    rc,
    dsf_alpha: float,
    dsf_rc: float,
    envelope: str = "exp",
    subtract_sr: bool = True,
    key_in: str = "charges",
) -> torch.Tensor:
    """Damped-shifted-force (Fennell-Gezelter) Coulomb in closed form, with
    the self-energy term; C^1 at the cutoff."""
    nb, _sh, suffix = system.resolve_nb("_coulomb", "_lr", "")
    data = ensure_dij(data, system, suffix)
    d_ij = data[f"d_ij{suffix}"]
    q = data[key_in]
    q_ij = q[:, None] * nbops.gather_nb(q, nb)

    alpha = dsf_alpha
    erfc_rc = math.erfc(alpha * dsf_rc)
    shift_val = erfc_rc / dsf_rc
    shift_slope = erfc_rc / dsf_rc**2 + (
        2.0 * alpha / math.sqrt(math.pi) * math.exp(-((alpha * dsf_rc) ** 2)) / dsf_rc
    )
    e_pair = torch.special.erfc(alpha * d_ij) / d_ij - shift_val + (d_ij - dsf_rc) * shift_slope
    valid = nbops.pair_mask(nb) & (d_ij < dsf_rc)
    e = FACTOR * _pair_sum_energy(q_ij * e_pair, valid, system.mol_idx, system.num_mol)

    # self-energy: -(erfc(a*rc)/(2 rc) + a/sqrt(pi)) * q_i^2, full k_e factor
    self_coeff = -(shift_val / 2.0 + alpha / math.sqrt(math.pi))
    q_real = nbops.mask_pad_atoms(q, system.numbers)
    e_self = nbops.mol_sum(self_coeff * q_real * q_real, system.mol_idx, system.num_mol)
    e = e + 2.0 * FACTOR * e_self
    if subtract_sr:
        e = e - coulomb_sr(data, system, rc, envelope, key_in)
    return e


def srrep_energy(
    data: dict, system: System, params: dict[str, torch.Tensor], rc: float, cutoff_fn: str = "none"
) -> torch.Tensor:
    """GFN1-style short-range repulsion over the SR list ``nbmat``, per
    molecule: ``exp(-a_i a_j d^1.5) z_i z_j / d`` times the optional exp or
    cosine cutoff at ``rc``; every ordered pair of the list is summed."""
    data = ensure_dij(data, system, "")
    d_ij = data["d_ij"]
    p = params["gfn1_ab"][system.numbers]  # (N, 2) = (alpha, zeff)
    p_ij = p[:, None, :] * nbops.gather_nb(p, system.nbmat)
    e = torch.exp(-p_ij[..., 0] * d_ij**1.5) * p_ij[..., 1] / d_ij
    e = torch.where(nbops.pair_mask(system.nbmat), e, torch.zeros_like(e))
    if cutoff_fn == "exp_cutoff":
        e = e * aops.exp_cutoff(d_ij, rc)
    elif cutoff_fn == "cosine_cutoff":
        e = e * aops.cosine_cutoff(d_ij, rc)
    return nbops.mol_sum(e.sum(-1), system.mol_idx, system.num_mol)


def disp_param_apply(
    data: dict, params: dict[str, torch.Tensor], numbers: torch.Tensor, key_in: str, key_out: str
) -> dict:
    """The network-scaled dispersion parameters (C6, alpha) per atom:
    ``disp_param0[Z] * exp(clip(x, -4, 4))``."""
    mult = torch.exp(torch.clamp(data[key_in], -4.0, 4.0))
    return {**data, key_out: params["disp_param0"][numbers] * mult}


def d3ts_energy(
    data: dict,
    system: System,
    params: dict[str, torch.Tensor],
    a1: float,
    a2: float,
    s8: float,
    s6: float = 1.0,
    key_in: str = "disp_param",
) -> torch.Tensor:
    """D3-like pairwise dispersion with the TS combination rule over the
    network's C6 and alpha, on the D3 (or shared LR) list, per molecule."""
    nb, _sh, suffix = system.resolve_nb("_dftd3", "_lr", "")
    data = ensure_dij(data, system, suffix)
    valid = nbops.pair_mask(nb)
    dp = data[key_in]  # (N, 2)
    dp_j = nbops.gather_nb(dp, nb)
    c6_i, alpha_i = dp[:, None, 0], dp[:, None, 1]
    c6_j, alpha_j = dp_j[..., 0], dp_j[..., 1]
    denom = torch.clamp(c6_i * alpha_j / alpha_i + c6_j * alpha_i / alpha_j, min=1e-4)
    c6ij = 2.0 * c6_i * c6_j / denom
    c6ij = torch.where(valid, c6ij, torch.zeros_like(c6ij))
    rr = params["r4r2"][system.numbers]
    rrij = 3.0 * rr[:, None] * nbops.gather_nb(rr, nb)
    rrij = torch.where(valid, rrij, torch.ones_like(rrij))
    r0ij = a1 * torch.sqrt(rrij) + a2
    d_ij = data[f"d_ij{suffix}"] * constants.Bohr_inv
    e_ij = c6ij * (s6 / (d_ij**6 + r0ij**6) + s8 * rrij / (d_ij**8 + r0ij**8))
    return -constants.half_Hartree * nbops.mol_sum(e_ij.sum(-1), system.mol_idx, system.num_mol)


def _s5_switch(d_bohr: torch.Tensor, r_on_bohr: float, r_off_bohr: float) -> torch.Tensor:
    """Quintic S5 switch-off from 1 at ``r_on`` to 0 at ``r_off`` (Bohr)."""
    if r_off_bohr <= r_on_bohr:
        return torch.ones_like(d_bohr)
    t = torch.clamp((d_bohr - r_on_bohr) / (r_off_bohr - r_on_bohr), 0.0, 1.0)
    switch = 1.0 - (10.0 * t**3 - 15.0 * t**4 + 6.0 * t**5)
    return torch.where(d_bohr <= r_on_bohr, torch.ones_like(switch), switch)


def dftd3_energy(
    data: dict,
    system: System,
    tables: dict[str, torch.Tensor],
    a1: float,
    a2: float,
    s8: float,
    s6: float = 1.0,
    smoothing_on: float = 12.0,
    smoothing_off: float = 15.0,
) -> torch.Tensor:
    """DFT-D3(BJ) dispersion (C6 + C8, no three-body) on the indexed
    layout: sigmoid coordination numbers, Gaussian-weighted C6
    interpolation over the (5, 5) reference grid, quintic S5 switch.
    Distances in Angstrom in, D3 math in Bohr and Hartree inside.

    Every ``where`` here selects between finite values: the reference grid
    is shifted by its largest exponent only where that maximum is finite
    (a pair with no reference C6, such as a padding row, has -inf there),
    and divisions run on clamped denominators, so the backward meets no
    0 * inf on padding rows or isolated atoms."""
    nb, _sh, suffix = system.resolve_nb("_dftd3", "_lr", "")
    data = ensure_dij(data, system, suffix)
    d_bohr = torch.clamp(data[f"d_ij{suffix}"], min=1e-12) * constants.Bohr_inv
    valid = nbops.pair_mask(nb)

    z = system.numbers
    z_j = nbops.gather_nb(z, nb)  # (N, M)
    rcov = tables["rcov"]
    rcov_sum = rcov[z][:, None] + rcov[z_j]
    cn_ij = torch.sigmoid(16.0 * (rcov_sum / d_bohr - 1.0))
    cn = torch.where(valid, cn_ij, torch.zeros_like(cn_ij)).sum(dim=-1)  # (N,)

    # C6 interpolation over reference coordination numbers
    zi = z[:, None].expand_as(z_j)
    c6ref = tables["c6ab"][zi, z_j]  # (N, M, 5, 5)
    cnref_i = tables["cn_ref"][zi, z_j]
    cnref_j = tables["cn_ref"][z_j, zi].transpose(-1, -2)
    cn_i = cn[:, None, None, None]
    cn_j = nbops.gather_nb(cn, nb)[..., None, None]
    ok = c6ref != 0
    exp_arg = -4.0 * ((cn_i - cnref_i) ** 2 + (cn_j - cnref_j) ** 2)
    neg_inf = torch.full_like(exp_arg, -math.inf)
    max_exp = torch.where(ok, exp_arg, neg_inf).amax(dim=(-1, -2), keepdim=True)
    finite = torch.isfinite(max_exp)
    shifted = torch.where(finite, exp_arg - torch.where(finite, max_exp, torch.zeros_like(max_exp)),
                          torch.zeros_like(exp_arg))
    w = torch.where(ok & finite & (shifted >= -12.0), torch.exp(shifted), torch.zeros_like(shifted))
    w_sum = w.sum(dim=(-1, -2))
    c6_sum = (c6ref * w).sum(dim=(-1, -2))
    c6ij = torch.where(w_sum > 1e-12, c6_sum / torch.clamp(w_sum, min=1e-12), torch.zeros_like(w_sum))

    r4r2 = tables["r4r2"]
    r4r2_ij = 3.0 * r4r2[z][:, None] * r4r2[z_j]
    r0 = a1 * torch.sqrt(r4r2_ij) + a2
    d2 = d_bohr * d_bohr
    d6 = d2 * d2 * d2
    d8 = d6 * d2
    r0_2 = r0 * r0
    r0_6 = r0_2 * r0_2 * r0_2
    r0_8 = r0_6 * r0_2
    damping = s6 / (d6 + r0_6) + s8 * r4r2_ij / (d8 + r0_8)
    switch = _s5_switch(d_bohr, smoothing_on * constants.Bohr_inv, smoothing_off * constants.Bohr_inv)
    e_ij = torch.where(valid, -c6ij * damping * switch, torch.zeros_like(damping))
    return constants.half_Hartree * nbops.mol_sum(e_ij.sum(dim=-1), system.mol_idx, system.num_mol)
