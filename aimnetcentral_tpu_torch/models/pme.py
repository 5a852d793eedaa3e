"""Particle-mesh Ewald (counterpart of aimnetcentral_tpu/models/pme.py):
order-4 cardinal B-spline charge spreading, a 3D FFT (``torch.fft.fftn``)
and the reciprocal energy with the Gaussian screen and the B-spline
deconvolution (smooth PME, Essmann et al. 1995).  The real-space, self and
background terms are Ewald's (models/ewald.py).  Differentiable by
autograd to second order.

The spread adds N * 64 weighted charges into the mesh.  It is
``index_put(..., accumulate=True)``, whose CUDA implementation sorts the
indices and sums each mesh point's values in a fixed order: deterministic,
where ``index_add_`` would be a float atomic.  JAX's ``.at[].add`` sums in
its own order, so the two agree to float32 rounding, not bit for bit.  The
fractional coordinates are exact f32 products (ops/math.py::cellmul) at
every precision tier.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from aimnetcentral_tpu_torch import constants
from aimnetcentral_tpu_torch.ops.math import cellmul

SPLINE_ORDER = 4  # the cardinal B-spline's order: each charge spreads over 4^3 mesh points


def bspline4_weights(u: torch.Tensor) -> torch.Tensor:
    """Order-4 cardinal B-spline weights (..., 4) of the mesh points
    floor(u) - 1 .. floor(u) + 2 for the fractional offset u in [0, 1)."""
    w0 = (1.0 - u) ** 3 / 6.0
    w1 = (3.0 * u**3 - 6.0 * u**2 + 4.0) / 6.0
    w2 = (-3.0 * u**3 + 3.0 * u**2 + 3.0 * u + 1.0) / 6.0
    w3 = u**3 / 6.0
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _bspline_moduli(k: int) -> np.ndarray:
    """|b(m)|^2 deconvolution factors of one mesh dimension (host)."""
    m4 = np.zeros(k)
    m4[1 % k] = 1.0 / 6.0
    m4[2 % k] = 2.0 / 3.0
    m4[3 % k] = 1.0 / 6.0
    mod = np.abs(np.fft.fft(m4)) ** 2
    # the spline's transform vanishes at some points of odd meshes
    tiny = mod < 1e-7
    if tiny.any():
        mod[tiny] = (np.roll(mod, 1)[tiny] + np.roll(mod, -1)[tiny]) / 2.0
    return mod


def estimate_pme_mesh(cell: np.ndarray, accuracy: float = 1e-6) -> tuple[int, int, int]:
    """Mesh dimensions: about one point per Angstrom scaled by the
    accuracy, each a product of 2, 3 and 5."""
    lengths = np.linalg.norm(np.asarray(cell, dtype=np.float64), axis=1)
    scale = max(1.0, (math.log10(1.0 / max(accuracy, 1e-12)) / 6.0))

    def nice(n: int) -> int:
        n = max(8, n)
        while True:
            m = n
            for p in (2, 3, 5):
                while m % p == 0:
                    m //= p
            if m == 1:
                return n
            n += 1

    return tuple(nice(int(np.ceil(length * scale))) for length in lengths)


@functools.lru_cache(maxsize=16)
def _mesh_constants(mesh: tuple[int, int, int], dtype: torch.dtype, device: torch.device):
    """The mesh's dimensions (float and int64, (3,)) and its deconvolution
    moduli (K1, K2, K3) on ``device``, uploaded once per (mesh, dtype,
    device): a request copies nothing from the host (a copy would wait for
    the stream)."""
    k1, k2, k3 = mesh
    bmod = (
        _bspline_moduli(k1)[:, None, None] * _bspline_moduli(k2)[None, :, None] * _bspline_moduli(k3)[None, None, :]
    )
    return (
        torch.tensor(mesh, dtype=dtype, device=device),
        torch.tensor(mesh, dtype=torch.int64, device=device),
        torch.as_tensor(bmod.astype(np.float32), dtype=dtype, device=device),
    )


def _fft_freqs(k: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.fft.fftfreq(k, device=device).to(dtype) * k


def _spread_geometry(frac: torch.Tensor, mesh: tuple[int, int, int]):
    """Flat mesh indices (N, 4, 4, 4) and spline weights (N, 4, 4, 4) of
    each atom's 64 mesh points, from fractional coordinates."""
    k1, k2, k3 = mesh
    mesh_f, mesh_i, _bmod = _mesh_constants(mesh, frac.dtype, frac.device)
    frac = frac - torch.floor(frac)  # [0, 1)
    scaled = frac * mesh_f
    base = torch.floor(scaled)
    w = bspline4_weights(scaled - base)  # (N, 3, 4)
    offs = torch.arange(-1, SPLINE_ORDER - 1, device=frac.device)
    idx = (base.to(torch.int64)[:, :, None] + offs) % mesh_i[None, :, None]
    w3 = w[:, 0, :, None, None] * w[:, 1, None, :, None] * w[:, 2, None, None, :]
    flat = (idx[:, 0, :, None, None] * k2 + idx[:, 1, None, :, None]) * k3 + idx[:, 2, None, None, :]
    return flat, w3


def _green(kk: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    mask = kk > 1e-12
    g = torch.exp(-0.5 * eta * eta * kk) / torch.where(mask, kk, torch.ones_like(kk))
    return torch.where(mask, g, torch.zeros_like(g))


def pme_reciprocal_energy(coord, charges, cell, eta, mesh: tuple[int, int, int]) -> torch.Tensor:
    """Reciprocal-space PME energy of one system (no k_e)."""
    k1, k2, k3 = mesh
    inv_cell = torch.linalg.inv_ex(cell).inverse
    flat, w3 = _spread_geometry(cellmul(coord, inv_cell), mesh)
    vals = charges[:, None, None, None] * w3
    rho = torch.zeros((k1 * k2 * k3,), dtype=coord.dtype, device=coord.device)
    rho = rho.index_put((flat.reshape(-1),), vals.reshape(-1), accumulate=True).reshape(mesh)
    rho_k = torch.fft.fftn(rho)
    recip = 2.0 * math.pi * inv_cell.T  # rows b_i
    dt, dev = coord.dtype, coord.device
    fx, fy, fz = (_fft_freqs(k, dt, dev) for k in mesh)
    kx = (
        fx[:, None, None, None] * recip[0]
        + fy[None, :, None, None] * recip[1]
        + fz[None, None, :, None] * recip[2]
    )  # (k1, k2, k3, 3)
    kk = (kx * kx).sum(-1)
    volume = torch.abs(torch.linalg.det(cell))
    s2 = rho_k.real**2 + rho_k.imag**2
    green = _green(kk, torch.as_tensor(eta, dtype=dt, device=dev))
    return (2.0 * math.pi / volume) * (green * s2 / _mesh_constants(mesh, dt, dev)[2]).sum()


def pme_spread_charges(coord, charges, inv_cells_at, mol_idx, num_mol: int, mesh: tuple[int, int, int]) -> torch.Tensor:
    """Charges spread onto per-molecule meshes of one shared shape:
    (num_mol, K1, K2, K3).  Padding atoms (``mol_idx == num_mol``) land in a
    dropped mesh."""
    return pme_spread_charges_multi(coord, charges[:, None], inv_cells_at, mol_idx, num_mol, mesh)[:, 0]


def pme_reciprocal_from_rho(rho, cells, eta_b, mesh: tuple[int, int, int]) -> torch.Tensor:
    """Reciprocal energies (B,) from spread meshes (B, K1, K2, K3), no k_e."""
    rho_k = torch.fft.fftn(rho, dim=(1, 2, 3))
    recip = 2.0 * math.pi * torch.linalg.inv_ex(cells).inverse.transpose(1, 2)  # (B, 3, 3)
    dt, dev = rho.dtype, rho.device
    fx, fy, fz = (_fft_freqs(k, dt, dev) for k in mesh)
    fgrid = torch.stack(torch.meshgrid(fx, fy, fz, indexing="ij"), dim=-1)  # (K1, K2, K3, 3)
    kvec = cellmul(fgrid[None], recip[:, None, None])  # (B, K1, K2, K3, 3), exact f32
    kk = (kvec * kvec).sum(-1)
    volume = torch.abs(torch.linalg.det(cells))
    green = _green(kk, torch.as_tensor(eta_b, dtype=dt, device=dev).reshape(-1, 1, 1, 1))
    s2 = rho_k.real**2 + rho_k.imag**2
    return (2.0 * math.pi / volume) * (green * s2 / _mesh_constants(mesh, dt, dev)[2][None]).sum(dim=(1, 2, 3))


def _inverse_cells_at(cells: torch.Tensor, mol_idx: torch.Tensor) -> torch.Tensor:
    inv_cells = torch.linalg.inv_ex(cells).inverse  # no host sync
    eye = torch.eye(3, dtype=cells.dtype, device=cells.device)[None]
    return torch.cat([inv_cells, eye], dim=0)[mol_idx]  # (N, 3, 3)


def pme_reciprocal_energy_batched(coord, charges, cells, mol_idx, num_mol: int, eta_b, mesh) -> torch.Tensor:
    """Batched reciprocal PME (B,): per-molecule meshes of one shared
    shape, one batched FFT, a per-molecule Green function."""
    return pme_reciprocal_energy_batched_multi(coord, charges[:, None], cells, mol_idx, num_mol, eta_b, mesh)[:, 0]


def pme_spread_charges_multi(coord, q_st, inv_cells_at, mol_idx, num_mol: int, mesh) -> torch.Tensor:
    """One set of spline weights and mesh indices for every member, spread
    with an E-wide value -> (num_mol, E, K1, K2, K3)."""
    k1, k2, k3 = mesh
    ktot = k1 * k2 * k3
    n_e = q_st.shape[1]
    frac = cellmul(coord[:, None, :], inv_cells_at)[:, 0]  # exact f32 at every tier
    flat, w3 = _spread_geometry(frac, mesh)
    flat = (flat + mol_idx[:, None, None, None] * ktot).reshape(-1)
    vals = (q_st[:, None, None, None, :] * w3[..., None]).reshape(-1, n_e)
    rho = torch.zeros(((num_mol + 1) * ktot, n_e), dtype=coord.dtype, device=coord.device)
    rho = rho.index_put((flat,), vals, accumulate=True)
    return rho[: num_mol * ktot].reshape(num_mol, k1, k2, k3, n_e).movedim(-1, 1)


def pme_reciprocal_energy_batched_multi(coord, q_st, cells, mol_idx, num_mol: int, eta_b, mesh) -> torch.Tensor:
    """Member-stacked batched reciprocal PME -> (num_mol, E): shared spread
    geometry, one batched FFT over the (M * E) meshes."""
    n_e = q_st.shape[1]
    rho = pme_spread_charges_multi(coord, q_st, _inverse_cells_at(cells, mol_idx), mol_idx, num_mol, mesh)
    rho_flat = rho.reshape((num_mol * n_e,) + tuple(mesh))
    cells_rep = torch.repeat_interleave(cells, n_e, dim=0)
    eta_rep = torch.repeat_interleave(torch.as_tensor(eta_b, dtype=coord.dtype, device=coord.device).reshape(-1), n_e)
    return pme_reciprocal_from_rho(rho_flat, cells_rep, eta_rep, mesh).reshape(num_mol, n_e)


def pme_energy(coord, charges, cell, numbers, eta, mesh, e_real) -> torch.Tensor:
    """Total PME energy in eV of ONE periodic system: the caller's
    real-space sum ``e_real`` plus reciprocal, self and background."""
    q = torch.where(numbers > 0, charges, torch.zeros_like(charges))
    eta = torch.as_tensor(eta, dtype=coord.dtype, device=coord.device)
    e_recip = pme_reciprocal_energy(coord, q, cell, eta, mesh)
    e_self = -(q * q).sum() / (math.sqrt(2.0 * math.pi) * eta)
    volume = torch.abs(torch.linalg.det(cell))
    q_tot = q.sum()
    e_bg = -math.pi * q_tot * q_tot * (eta * eta) / volume
    return constants.Hartree * constants.Bohr * (e_real + e_recip + e_self + e_bg)
