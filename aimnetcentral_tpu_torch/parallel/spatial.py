"""Spatial domain decomposition: ONE large periodic box sharded over ranks.

Counterpart of aimnetcentral_tpu/parallel/spatial.py.  The binned slot
layout is x-major, so a ring of ``n_sp`` ranks (mesh axis ``sp``) owns
contiguous slabs of x-planes, and a 2-D torus (``n_spy > 1``, axes ``sp``
and ``spy``) owns (x, y) tiles of bin columns.  Each rank evaluates the
whole model on its EXTENDED grid, its core planes plus ``halo`` planes of
each neighbour along every sharded axis, where ``halo`` covers the largest
cutoff of the model.  The extended grid is bounded along the sharded axes
and periodic along the others (``BinGrid.periodic_axes``), so the port's
kernels run on it unchanged: A and B for the message passes, D and E for
DSF, the real-space Ewald sum and both D3 sweeps, all at the halo's
stencil radius on the one grid (as JAX plans it; D3's extras at radius 3
take 14 KB of a block's shared memory, far inside the card's 227 KB).

Halo atoms are real pair candidates; every accumulated quantity (molecular
sums, NSE's charge conservation, energies) is a sum over core atoms,
reduced over the mesh.  Halo atoms carry ``mol_idx = 1``, the padding
segment of the one molecule, so the molecular sums drop them.  Before
every message pass the owners' features ``a`` and charges are exchanged
again: halo copies are never trusted across passes.  Each rank
differentiates its own core energy (parallel/collectives.py): the halo
exchanges' backward sends the halo atoms' force contributions home, and
the all-reduces carry the cross-rank terms (NSE's molecular sums, Ewald's
structure factors, PME's mesh; D3 refreshes the halo atoms' coordination
numbers from their owners).  The wrap of coordinates that cross the box
edge is an exact f32 ``cellmul`` of the halo rows' lattice wraps, so it
carries the cell's gradient (stress).

Entry points: :func:`plan_spatial` (the decomposition's geometry),
:func:`make_spatial_energy_fn` (JAX's signature: the global slot arrays go
in, each rank reads its own tile, the total energy comes out on every
rank), :func:`spatial_forces` (global forces, cell gradient and stress on
every rank) and :class:`SpatialMDDriver`.  Every rank of the mesh calls
each of them with the same arguments.

Ensembles compose with the decomposition on an ``(ens, sp)`` or ``(ens,
sp, spy)`` mesh (``make_spatial_mesh(..., n_ens=E)``, ``ens_axis="ens"``):
each slice along ``ens`` evaluates one member of parameters stacked on a
leading member axis over its own ring or torus, every spatial collective
runs on that slice (``Mesh.sub``), and the member energies are gathered
over ``ens``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from aimnetcentral_tpu_torch import constants
from aimnetcentral_tpu_torch.kernels.conv_pass import conv_pass
from aimnetcentral_tpu_torch.kernels.pair_sweep import D3CNTerm, D3EnergyTerm
from aimnetcentral_tpu_torch.models import engine_binned as eb
from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config, mlp_spec_for_pass
from aimnetcentral_tpu_torch.models.ewald import KE
from aimnetcentral_tpu_torch.models.heads import (
    AtomicShiftHead,
    AtomicSumHead,
    DFTD3Head,
    DipoleHead,
    LRCoulombHead,
    OutputHead,
    QuadrupoleHead,
    auto_switch_simple_to_dsf,
)
from aimnetcentral_tpu_torch.models.modules import mlp_apply
from aimnetcentral_tpu_torch.ops import binned as B
from aimnetcentral_tpu_torch.ops.math import cellmul
from aimnetcentral_tpu_torch.ops.nb import expand_mol, mask_pad_atoms, mol_sum
from aimnetcentral_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_sum,
    halo_exchange,
    sum_replicated,
)
from aimnetcentral_tpu_torch.parallel.mesh import Mesh, make_spatial_mesh
from aimnetcentral_tpu_torch.system import System

ROUTED_HEADS = (OutputHead, AtomicShiftHead, AtomicSumHead, LRCoulombHead, DFTD3Head, DipoleHead, QuadrupoleHead)


@dataclasses.dataclass(frozen=True)
class SpatialSpec:
    """Static decomposition geometry.

    ``n_spy == 1``: the ring of x-slabs; ``n_spy > 1``: the torus of (x, y)
    tiles, whose y halos are exchanged over the x-extended tile and so carry
    the corner halos too.  The y periodicity moves from the in-grid stencil
    wrap onto the y ring, as x's does."""

    grid: B.BinGrid  # the GLOBAL grid (x-major slot layout)
    n_sp: int
    halo: int  # halo depth in bin planes (covers every model cutoff)
    species: tuple | None = None  # species present (D3's factorised tables)
    # Ewald's parameters, frozen at plan time (one molecule: scalars)
    ewald_eta: float | None = None
    ewald_k_cutoff: float | None = None
    ewald_r_static: float | None = None
    pme_mesh: tuple[int, int, int] | None = None
    n_spy: int = 1

    @property
    def nx_local(self) -> int:
        return self.grid.nbins[0] // self.n_sp

    @property
    def ny_local(self) -> int:
        return self.grid.nbins[1] // self.n_spy

    @property
    def hy(self) -> int:
        """y halo depth: 0 on the ring (y periodicity stays in the grid)."""
        return self.halo if self.n_spy > 1 else 0

    @property
    def col_slots(self) -> int:
        """Slots per (x, y) bin column."""
        return self.grid.nbins[2] * self.grid.capacity

    @property
    def nx_ext(self) -> int:
        return self.nx_local + 2 * self.halo

    @property
    def ny_ext(self) -> int:
        return self.ny_local + 2 * self.hy

    @property
    def ext_grid(self) -> B.BinGrid:
        return dataclasses.replace(
            self.grid,
            nbins=(self.nx_ext, self.ny_ext, self.grid.nbins[2]),
            periodic_axes=(False, self.n_spy == 1, True),
        )

    def _blocks(self, arr: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
        return arr.reshape((nx, ny, self.col_slots) + arr.shape[1:])

    def tile(self, arr: torch.Tensor, coords: tuple[int, ...]) -> torch.Tensor:
        """The rank at mesh ``coords``' tile of a GLOBAL slot array
        ((L, ...) -> (core slots, ...), x-major)."""
        x0 = coords[0] * self.nx_local
        y0 = (coords[1] if self.n_spy > 1 else 0) * self.ny_local
        t = self._blocks(arr, *self.grid.nbins[:2])[x0 : x0 + self.nx_local, y0 : y0 + self.ny_local]
        return t.reshape((-1,) + arr.shape[1:])

    def untile(self, tiles: list[torch.Tensor]) -> torch.Tensor:
        """The global slot array from every rank's tile, in mesh rank order
        (x-major over the mesh)."""
        t = torch.stack([self._blocks(x, self.nx_local, self.ny_local) for x in tiles])
        t = t.reshape((self.n_sp, self.n_spy) + t.shape[1:])
        t = t.transpose(1, 2)  # (n_sp, nx_local, n_spy, ny_local, col, ...)
        return t.reshape((-1,) + tiles[0].shape[1:])

    def take_core(self, arr: torch.Tensor) -> torch.Tensor:
        """The core slots of an extended-grid slot array ((ext_slots, ...)
        -> (core slots, ...))."""
        t = self._blocks(arr, self.nx_ext, self.ny_ext)
        t = t[self.halo : self.halo + self.nx_local, self.hy : self.hy + self.ny_local]
        return t.reshape((-1,) + arr.shape[1:])

    def core_mask(self, device: torch.device) -> torch.Tensor:
        """Boolean (ext_slots,) mask of the core slots."""
        m = torch.zeros((self.nx_ext, self.ny_ext, self.col_slots), dtype=torch.bool, device=device)
        m[self.halo : self.halo + self.nx_local, self.hy : self.hy + self.ny_local] = True
        return m.reshape(-1)

    def halo_wraps(self, coords: tuple[int, ...], device: torch.device) -> torch.Tensor:
        """(ext_slots, 3) lattice wraps of the extended grid's rows: a halo
        row that crossed the box edge (the first rank's lower halo, the last
        rank's upper halo, along each sharded axis) is its owner's atom one
        cell vector away."""
        w = torch.zeros((self.nx_ext, self.ny_ext, self.col_slots, 3), device=device)
        h, hy = self.halo, self.hy
        if coords[0] == 0:
            w[:h, :, :, 0] -= 1.0
        if coords[0] == self.n_sp - 1:
            w[h + self.nx_local :, :, :, 0] += 1.0
        if self.n_spy > 1:
            if coords[1] == 0:
                w[:, :hy, :, 1] -= 1.0
            if coords[1] == self.n_spy - 1:
                w[:, hy + self.ny_local :, :, 1] += 1.0
        return w.reshape(-1, 3)


def plan_spatial(system: System, cfg: AIMNet2Config, n_sp: int, n_spy: int = 1) -> SpatialSpec:
    """Choose the halo depth from the model's largest cutoff.  ``n_spy > 1``
    plans the torus: the shard count scales as (nx/halo) (ny/halo) instead
    of the ring's nx/halo."""
    cfg = auto_switch_simple_to_dsf(cfg)
    grid = system.bins
    if grid is None or grid.molecule_bins:
        raise ValueError("spatial decomposition runs on the binned layout of a periodic box")
    if not grid.periodic:
        raise ValueError("spatial decomposition targets periodic boxes")
    if grid.nbins[0] % n_sp:
        raise ValueError(f"nx={grid.nbins[0]} must divide by n_sp={n_sp} (plan_bins the box with a compatible grid)")
    if grid.nbins[1] % n_spy:
        raise ValueError(f"ny={grid.nbins[1]} must divide by n_spy={n_spy}")
    cutoffs = [cfg.aev.rc_s]
    ewald_eta = ewald_k_cutoff = ewald_r_static = None
    pme_mesh = None
    for _name, head in cfg.outputs:
        if isinstance(head, LRCoulombHead):
            if head.method in ("ewald", "pme"):
                if system.ewald_r_static is None:
                    raise ValueError("spatial Ewald needs models.ewald.attach_ewald on the System first")
                if head.method == "pme":
                    pme_mesh = system.pme_mesh
                ewald_eta = float(system.ewald_eta_static[0])
                ewald_k_cutoff = float(system.ewald_k_cutoff.reshape(-1)[0])
                ewald_r_static = float(system.ewald_r_static)
                cutoffs.append(ewald_r_static)
            else:
                cutoffs.append(float(head.dsf_rc if head.method == "dsf" else head.rc))
        elif isinstance(head, DFTD3Head):
            cutoffs.append(float(head.cutoff))
    halo = max(B.stencil_radius(c, grid) for c in cutoffs)
    if halo > grid.nbins[0] // n_sp:
        raise ValueError(f"halo {halo} planes exceeds the local slab of {grid.nbins[0] // n_sp}; use fewer shards")
    if n_spy > 1 and halo > grid.nbins[1] // n_spy:
        raise ValueError(f"halo {halo} planes exceeds the local y tile of {grid.nbins[1] // n_spy}; use fewer y shards")
    return SpatialSpec(
        grid=grid, n_sp=n_sp, halo=halo, species=system.species, ewald_eta=ewald_eta,
        ewald_k_cutoff=ewald_k_cutoff, ewald_r_static=ewald_r_static, pme_mesh=pme_mesh, n_spy=n_spy,
    )


def _member(tree, m: int):
    """Member ``m`` of a tree stacked on a leading member axis."""
    if isinstance(tree, dict):
        return {k: _member(v, m) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_member(v, m) for v in tree)
    return tree[m]


class SpatialEnergy:
    """``fn(params, coord, numbers, charge, cell, mult=None)`` -> the total
    energy (1,), the same on every rank (:func:`make_spatial_energy_fn`);
    with ``ens_axis``, the members' energies (n_ens,).  ``tile_energy``
    takes this rank's tile (and one member's parameters) instead of the
    global arrays.  ``sp`` is the mesh of this rank's ring or torus, which
    every spatial collective runs on; ``member`` is this rank's member."""

    def __init__(self, cfg: AIMNet2Config, spec: SpatialSpec, mesh: Mesh, ewald_kpts=None,
                 ens_axis: str | None = None, observables: bool = False, conv_precision: str | None = None):
        cfg = auto_switch_simple_to_dsf(cfg)
        if observables and ens_axis is not None:
            raise ValueError("observables mode returns single-model outputs; run it per member")
        sp_axes = ("sp",) if spec.n_spy == 1 else ("sp", "spy")
        if ens_axis is None:
            self.sp, self.ens, self.member = mesh, None, 0
        else:
            if mesh.axis_names != (ens_axis,) + sp_axes:
                raise ValueError(f"an ensemble over {ens_axis!r} needs a mesh on {(ens_axis,) + sp_axes}, "
                                 f"not {mesh.axis_names}")
            self.sp, self.ens, self.member = mesh.sub(sp_axes), mesh.sub((ens_axis,)), mesh.coords[0]
        if tuple(self.sp.shape) != ((spec.n_sp,) if spec.n_spy == 1 else (spec.n_sp, spec.n_spy)):
            raise ValueError(f"the mesh {self.sp.shape} does not match the plan ({spec.n_sp}, {spec.n_spy})")
        for name, head in cfg.outputs:
            if not isinstance(head, ROUTED_HEADS):
                raise ValueError(f"head {name!r} is not routed spatially")
            if isinstance(head, LRCoulombHead) and head.method in ("ewald", "pme") and (
                ewald_kpts is None or spec.ewald_eta is None
            ):
                raise ValueError("Ewald/PME heads need plan_spatial on an attach_ewald'd System and its ewald_kpts")
        self.cfg, self.spec, self.mesh, self.observables = cfg, spec, mesh, observables
        self.conv_precision = conv_precision
        dev = mesh.device
        self.kpts = None if ewald_kpts is None else torch.as_tensor(ewald_kpts, dtype=torch.float32, device=dev)
        self.core = spec.core_mask(dev)
        self.wraps = spec.halo_wraps(self.sp.coords, dev)
        # a replicated term enters the share of its ring's lead rank only
        self.lead = 1.0 if self.sp.lead else 0.0

    def tile(self, arr: torch.Tensor) -> torch.Tensor:
        return self.spec.tile(arr, self.sp.coords)

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """A tile's slot array (core slots, ...) -> the extended grid's
        (ext_slots, ...): the halo planes from the ring neighbours (on the
        torus the y halos over the x-extended tile, corners included)."""
        spec = self.spec
        t = x.reshape((spec.nx_local, spec.ny_local, spec.col_slots) + x.shape[1:])
        t = halo_exchange(t, self.sp, "sp", 0, spec.halo)
        if spec.n_spy > 1:
            t = halo_exchange(t, self.sp, "spy", 1, spec.hy)
        return t.reshape((-1,) + x.shape[1:])

    def __call__(self, params: dict, coord, numbers, charge, cell, mult=None):
        if self.ens is None:
            return self.tile_energy(params, self.tile(coord), self.tile(numbers), charge, cell, mult)
        e = self.tile_energy(_member(params, self.member), self.tile(coord), self.tile(numbers), charge, cell, mult)
        # every member's energy on every rank; only this rank's own member
        # carries its graph, so a backward gives its member's gradient
        others = all_gather(e, self.ens)
        return torch.cat([e if m == self.member else others[m] for m in range(len(others))])

    def _mol_sum(self, x: torch.Tensor, mol_idx_core: torch.Tensor) -> torch.Tensor:
        """The molecule's sum over every rank's core atoms."""
        return all_reduce_sum(mol_sum(x, mol_idx_core, 1), self.sp)

    def _nse(self, big_q, q_u, f_u, mol_idx_core, epsilon: float = 1e-6):
        """ops/math.py::nse with the molecule's sums over every rank."""
        f_sum = self._mol_sum(f_u, mol_idx_core) + epsilon
        dq = big_q - self._mol_sum(q_u, mol_idx_core)
        f = f_u / expand_mol(f_sum, mol_idx_core).clamp(min=epsilon * 0.5)
        return q_u + f * expand_mol(dq, mol_idx_core)

    def tile_energy(self, params: dict, coord_t, numbers_t, charge, cell, mult=None):
        """The total energy from this rank's tile (the core slot rows of
        the global slot arrays); with ``observables`` a dict (module
        docstring of :func:`make_spatial_energy_fn`)."""
        cfg, spec, mesh = self.cfg, self.spec, self.sp
        c = cfg.num_charge_channels
        n_core = numbers_t.shape[0]
        numbers_ext = self.exchange(numbers_t)
        coord_ext = self.exchange(coord_t) + cellmul(self.wraps, cell)
        mol_idx_ext = torch.where((numbers_ext > 0) & self.core, 0, 1)
        mol_idx_core = spec.take_core(mol_idx_ext)
        sys_ext = System(coord=coord_ext, numbers=numbers_ext, charge=charge, mol_idx=mol_idx_ext, mult=mult,
                         cell=cell[None], bins=spec.ext_grid, species=spec.species)

        a = params["afv"]["weight"][numbers_t]
        if cfg.d2features:
            a = a.reshape(n_core, cfg.nfeature, cfg.nshifts)
        if c == 2:
            mult = torch.ones_like(charge) if mult is None else mult  # closed shell, as JAX's default
            half_spin = 0.5 * (mult - 1.0)
            big_q = torch.stack([0.5 * charge + half_spin, 0.5 * charge - half_spin], dim=-1)
        else:
            big_q = charge[:, None]

        charges = None
        npass = len(cfg.hidden)
        for ipass in range(npass):
            a_flat = a.reshape(n_core, -1)
            a_ext = self.exchange(a_flat).reshape((-1,) + a.shape[1:])
            q_ext = self.exchange(charges) if charges is not None else None
            conv_a, conv_q = conv_pass(sys_ext, params["aev"], a_ext, q_ext, params["conv_a"]["agh"],
                                       params["conv_q"]["agh"], rc_static=cfg.aev.rc_s,
                                       conv_precision=self.conv_precision)
            if ipass == 0:
                x = torch.cat([a_flat, spec.take_core(conv_a)], dim=-1)
            else:
                x = torch.cat([a_flat, spec.take_core(conv_a), charges, spec.take_core(conv_q)], dim=-1)
            out = mask_pad_atoms(mlp_apply(params["mlps"][ipass], x, mlp_spec_for_pass(cfg, ipass)), numbers_t)
            if ipass == npass - 1:
                aim = out
            else:
                _q, _f, delta_a = out[..., :c], out[..., c : 2 * c], out[..., 2 * c :]
                q = _q if ipass == 0 else charges + _q
                charges = self._nse(big_q, q, _f * _f, mol_idx_core)
                a = a + delta_a.reshape(a.shape)

        # heads: channels collapse to the total charge
        q_core = charges.sum(dim=-1)
        q_ext = self.exchange(q_core)
        real = numbers_t > 0
        e_atom = torch.zeros((n_core,), dtype=coord_t.dtype, device=coord_t.device)
        e_local = torch.zeros((1,), dtype=coord_t.dtype, device=coord_t.device)
        obs: dict = {}
        data = {"aim": aim, "charges": q_core}
        for name, head in cfg.outputs:
            p = params["outputs"].get(name)
            if isinstance(head, OutputHead):
                val = mlp_apply(p["mlp"], data[head.key_in], head.mlp)
                e_atom = e_atom + torch.where(real, val[..., 0], 0.0)
            elif isinstance(head, AtomicShiftHead):
                pass  # the float64 SAE is applied on the host (sae_external), as in MD
            elif isinstance(head, AtomicSumHead):
                e_local = e_local + mol_sum(e_atom, mol_idx_core, 1)
                e_atom = torch.zeros_like(e_atom)
            elif isinstance(head, LRCoulombHead) and head.method in ("ewald", "pme"):
                e_local = e_local + self._ewald(head, sys_ext, q_ext, cell)
            elif isinstance(head, LRCoulombHead):
                e_local = e_local + eb.coulomb_dsf_binned(sys_ext, q_ext, head.rc, head.dsf_alpha, head.dsf_rc,
                                                          head.envelope, head.subtract_sr)
            elif isinstance(head, DFTD3Head):
                e_local = e_local + self._dftd3(head, p, sys_ext)
            elif self.observables:  # dipole, quadrupole: no energy
                obs[head.key_out] = self._multipole(head, p, coord_t, numbers_t, q_core)
        energy = sum_replicated(e_local, mesh)
        if not self.observables:
            return energy
        obs["energy"] = energy
        obs["charges"] = self._gather(q_core)
        if c == 2:
            obs["spin_charges"] = self._gather(charges[..., 0] - charges[..., 1])
        return obs

    def _gather(self, tile: torch.Tensor) -> torch.Tensor:
        """A per-slot quantity in global slot order, on every rank."""
        return self.spec.untile(all_gather(tile, self.sp))

    def _multipole(self, head, p, coord_t, numbers_t, q_core):
        """Dipole or quadrupole of the box from every rank's core charges
        (models/heads.py's, with the sums over the mesh)."""
        mesh = self.sp
        real = numbers_t > 0
        r = coord_t
        if head.center_coord:
            m_at = torch.where(real, p["mass"][numbers_t], 0.0)
            m_sum = all_reduce_sum(m_at.sum(), mesh)
            mr = all_reduce_sum((m_at[:, None] * coord_t).sum(0), mesh)
            r = coord_t - mr / torch.clamp(m_sum, min=1e-9)
        qc = torch.where(real, q_core, 0.0)
        if isinstance(head, DipoleHead):
            return all_reduce_sum((qc[:, None] * r).sum(0), mesh)
        x = torch.cat([r * r, r * torch.roll(r, -1, dims=-1)], dim=-1)
        quad = all_reduce_sum((qc[:, None] * x).sum(0), mesh)
        x1, x2 = quad[:3], quad[3:]
        return torch.cat([x1 - x1.mean(), x2])

    def _ewald(self, head: LRCoulombHead, sys_ext: System, q_ext, cell):
        """Ewald (or PME with a mesh) on the decomposition: the real-space
        sum (its SR part inside, as the port's binned Ewald) through D and E
        on the extended grid; the structure factors S(k), or PME's spread
        mesh, summed over the ranks, so k-space needs no halo."""
        spec, mesh = self.spec, self.sp
        eta = spec.ewald_eta
        q_ext = torch.where(sys_ext.numbers > 0, q_ext, 0.0)
        e_real = eb.ewald_real_binned(sys_ext, q_ext, eta, spec.ewald_r_static, head.subtract_sr, head.rc,
                                      head.envelope)[0]
        coord = spec.take_core(sys_ext.coord)
        q = spec.take_core(q_ext)
        volume = torch.abs(torch.linalg.det(cell))
        inv_cell = torch.linalg.inv_ex(cell).inverse
        if head.method == "pme" and spec.pme_mesh is not None:
            from aimnetcentral_tpu_torch.models.pme import pme_reciprocal_from_rho, pme_spread_charges

            inv_at = inv_cell[None].expand(coord.shape[0], 3, 3)
            mol0 = torch.zeros_like(sys_ext.numbers[: coord.shape[0]])
            rho = all_reduce_sum(pme_spread_charges(coord, q, inv_at, mol0, 1, spec.pme_mesh), mesh)
            eta_t = torch.full((1,), eta, dtype=coord.dtype, device=coord.device)
            e_recip = pme_reciprocal_from_rho(rho, cell[None], eta_t, spec.pme_mesh)[0]
        else:
            kvec = cellmul(self.kpts, 2.0 * math.pi * inv_cell.T)  # (K, 3), exact f32
            k2 = (kvec * kvec).sum(-1)
            kmask = (k2 > 1e-12) & (k2 < spec.ewald_k_cutoff**2)
            phase = (coord[:, 0:1] * kvec[:, 0] + coord[:, 1:2] * kvec[:, 1]) + coord[:, 2:3] * kvec[:, 2]
            s_re = all_reduce_sum((q[:, None] * torch.cos(phase)).sum(0), mesh)
            s_im = all_reduce_sum((q[:, None] * torch.sin(phase)).sum(0), mesh)
            w = torch.where(kmask, torch.exp(-0.5 * eta * eta * k2) / torch.where(kmask, k2, 1.0), 0.0)
            e_recip = (2.0 * math.pi / volume) * (w * (s_re * s_re + s_im * s_im)).sum()
        e_self = -(q * q).sum() / (math.sqrt(2.0 * math.pi) * eta)
        q_tot = all_reduce_sum(q.sum(), mesh)
        e_bg = -math.pi * q_tot * q_tot * (eta * eta) / volume
        return KE * (e_real + e_self + self.lead * (e_recip + e_bg))[None]

    def _dftd3(self, head: DFTD3Head, tables: dict, sys_ext: System):
        """DFT-D3(BJ): the coordination numbers on the extended grid
        (complete for core atoms), the halo rows' refreshed from their
        owners, then the energy sweep over the factorised C6."""
        spec = self.spec
        if not spec.species:
            raise ValueError("spatial D3 needs the species set (plan_spatial)")
        off = float(head.cutoff)
        on = off * (1.0 - float(head.smoothing_fraction))
        numbers = sys_ext.numbers
        cn = eb.pair_sum_binned(sys_ext, off, D3CNTerm(), {"rcov": tables["rcov"][numbers]})
        cn = self.exchange(spec.take_core(cn))
        extras = eb.d3_pair_extras(spec.species, numbers, cn, tables)
        term = D3EnergyTerm(a1=head.a1, a2=head.a2, s8=head.s8, s6=head.s6, r_on=on, r_off=off)
        e_i = eb.pair_energy_binned(sys_ext, off, term, extras)
        return constants.half_Hartree * mol_sum(e_i, sys_ext.mol_idx, 1)


def make_spatial_energy_fn(cfg: AIMNet2Config, spec: SpatialSpec, mesh: Mesh, ewald_kpts=None,
                           ens_axis: str | None = None, observables: bool = False,
                           conv_precision: str | None = None) -> SpatialEnergy:
    """Build ``fn(params, coord, numbers, charge, cell, mult=None)`` -> the
    total energy (1,), on every rank of ``mesh``.

    ``coord`` (L, 3) and ``numbers`` (L,) are the GLOBAL slot arrays of the
    binned system (each rank reads its own tile), ``charge`` (1,) and
    ``cell`` (3, 3) the same on every rank.  Differentiable in ``coord``
    and ``cell``: every rank calls ``torch.autograd.grad`` on the energy
    (:func:`spatial_forces` does, and assembles the global forces).
    ``ewald_kpts`` is the System's ``ewald_kpts`` (Ewald and PME heads).

    ``ens_axis`` (``"ens"``): ``mesh`` is ``make_spatial_mesh(n_sp, n_spy,
    n_ens=E)``'s, ``params`` are stacked on a leading member axis
    (``calculators.ensemble.stack_params``), and the function returns the
    members' energies (E,), the same on every rank; each slice along
    ``ens_axis`` evaluates its member on its own ring or torus.

    ``observables=True`` returns a dict: ``energy``, ``charges`` (global
    slot order, on every rank) and, where the config has the heads,
    ``dipole``/``quadrupole`` (``spin_charges`` for NSE models), each summed
    over the mesh as the energy is.  It takes no ``ens_axis``
    (``ValueError``): run it per member.

    ``conv_precision``: the shard convs' mode, as ``aimnet2_apply``'s (JAX's
    shard-local conv takes none: its ``balanced`` is ``exact`` there)."""
    return SpatialEnergy(cfg, spec, mesh, ewald_kpts, ens_axis, observables, conv_precision)


def spatial_forces(efn: SpatialEnergy, params: dict, coord, numbers, charge, cell, mult=None,
                   stress: bool = False) -> dict[str, torch.Tensor]:
    """Energy (1,), global forces (L, 3) and, with ``stress``, the cell
    gradient dE/dcell (3, 3) and the stress (3, 3), on every rank (and an
    observables function's other outputs).  Each rank's backward gives the
    forces on its own tile; one all-gather assembles them, an all-reduce
    the cell gradient.  On an ensemble function every output has a leading
    member axis: energies (E,), forces (E, L, 3), each member's the
    gradient of its own energy (gathered over ``ens``)."""
    sp = efn.sp
    coord = coord.detach().requires_grad_(True)
    cell = cell.detach().requires_grad_(stress)
    res = efn(params, coord, numbers, charge, cell, mult)
    out = {k: v.detach() for k, v in res.items()} if isinstance(res, dict) else {"energy": res.detach()}
    e = res["energy"] if isinstance(res, dict) else res
    wrt = [coord, cell] if stress else [coord]
    grads = torch.autograd.grad(e.sum(), wrt)
    forces = -efn.spec.untile(all_gather(efn.tile(grads[0]), sp))
    members = (lambda x: torch.stack(all_gather(x, efn.ens))) if efn.ens is not None else (lambda x: x)
    out["forces"] = members(forces)
    if stress:
        g_cell = all_reduce_sum(grads[1], sp)
        # dE/dS for coord' = coord S, cell' = cell S, over the volume
        virial = cellmul(coord.detach().T, -forces) + cellmul(cell.detach().T, g_cell)
        out["cell_grad"] = members(g_cell)
        out["stress"] = members(virial / torch.abs(torch.linalg.det(cell.detach())))
    return out


class SpatialMDDriver:
    """MD on ONE spatially sharded periodic box.

    Each rank integrates its own tile (velocity Verlet, the port's
    MDDriver step without its Verlet-skin test; Langevin or none) with
    forces from its tile energy's backward.  The re-bin after every chunk
    is global: every rank gathers the tiles, runs the deterministic
    ``ops/binned.py::bin_atoms`` on the whole box (so every rank computes
    the same permutation) and takes its new tile; an overflow raises, as
    JAX's driver does.  Velocities and Langevin noise are drawn for the
    whole box from one ``torch.Generator`` on every rank, each rank keeping
    its tile, so the trajectory does not depend on the decomposition; they
    are not JAX's numbers (agreement in distribution only).

    Every rank of the world constructs it (the mesh's process
    groups are created collectively) and calls ``run`` alike."""

    def __init__(self, params: dict, cfg: AIMNet2Config, system: System, md, n_sp: int, seed: int = 0,
                 n_spy: int = 1, device: torch.device | None = None):
        from aimnetcentral_tpu_torch.calculators.calculator import precision_tiers
        from aimnetcentral_tpu_torch.dynamics.md import maxwell_boltzmann_velocities

        if system.bins is None or system.cell is None:
            raise ValueError("SpatialMDDriver needs a binned periodic System")
        self.params, self.md = params, md
        self.spec = plan_spatial(system, cfg, n_sp, n_spy)
        self.mesh = make_spatial_mesh(n_sp, n_spy, device)
        if self.mesh is None:
            raise ValueError("this rank is outside the spatial mesh")
        dev = self.mesh.device
        system = system.to(dev)
        self.efn = make_spatial_energy_fn(cfg, self.spec, self.mesh, ewald_kpts=system.ewald_kpts,
                                          conv_precision=precision_tiers(md.precision or "fast")[1])
        self.grid = system.bins
        self.system = system
        self.cell = system.cell[0]
        mass_table = torch.as_tensor(np.clip(constants.get_masses(), 1e-6, None).astype(np.float32), device=dev)
        masses = mass_table[system.numbers]
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        n = system.numbers.shape[0]
        veloc = maxwell_boltzmann_velocities(self._gen, masses, system.numbers, md.temperature_K,
                                             torch.arange(n, device=dev), n)
        tile = self.efn.tile
        self.coord, self.veloc, self.numbers, self.masses = (
            tile(system.coord), tile(veloc), tile(system.numbers), tile(masses))
        self.forces = None  # primed by the first run()
        self.epot = None

    def _force(self, coord: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Forces on this rank's tile and the total energy, under the
        MDConfig precision tier (it wraps the backward too)."""
        from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context, precision_tiers

        sysb = self.system
        with ambient_matmul_context(precision_tiers(self.md.precision or "fast")[0]):
            c = coord.detach().requires_grad_(True)
            e = self.efn.tile_energy(self.params, c, self.numbers, sysb.charge, self.cell, sysb.mult)
            (g,) = torch.autograd.grad(e.sum(), c)
        return -g, e.detach()

    def _noise(self) -> torch.Tensor:
        """This rank's tile of one whole-box standard normal draw."""
        from aimnetcentral_tpu_torch.dynamics.md import _normal

        numbers = self.system.numbers
        n = numbers.shape[0]
        return self.efn.tile(_normal(self._gen, numbers, torch.arange(n, device=numbers.device), n))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """A per-slot quantity of every rank's tile in global slot order."""
        return self.spec.untile(all_gather(x, self.mesh))

    def _rebin(self) -> None:
        """The global re-bin: a slot permutation of the gathered box, with
        wrapped coordinates; each rank keeps its new tile."""
        coord, veloc, forces = (self.gather(x) for x in (self.coord, self.veloc, self.forces))
        numbers, masses = self.gather(self.numbers), self.gather(self.masses)
        perm, wrap, ovf = B.bin_atoms(coord, numbers, self.grid, self.cell)
        if int(ovf) > 0:
            raise RuntimeError(f"spatial re-bin overflow ({int(ovf)} atoms); re-plan the grid with more capacity slack")
        coord = coord - cellmul(wrap, self.cell)
        sysb = self.system
        self.system = sysb.replace(coord=B.to_slots(coord, perm), numbers=B.to_slots(numbers, perm),
                                   mol_idx=B.to_slots(sysb.mol_idx, perm))
        tile = self.efn.tile
        self.coord, self.numbers = tile(self.system.coord), tile(self.system.numbers)
        self.veloc, self.forces, self.masses = (tile(B.to_slots(x, perm)) for x in (veloc, forces, masses))

    def run(self, n_steps: int, chunk: int = 10) -> dict[str, np.ndarray]:
        """``n_steps`` steps in chunks of ``chunk``, a global re-bin after
        each; returns the potential energy after every step.  The first
        call computes the initial forces (``run(0)`` only that)."""
        from aimnetcentral_tpu_torch.dynamics.md import langevin_velocities

        md = self.md
        dt = float(np.float32(md.dt_fs) * np.float32(constants.fs))
        if self.forces is None:
            self.forces, self.epot = self._force(self.coord)
        epots = []
        done = 0
        while done < n_steps:
            k = min(chunk, n_steps - done)
            for _ in range(k):
                m = self.masses[:, None]
                real = (self.numbers > 0)[:, None]
                v_half = self.veloc + 0.5 * dt * torch.where(real, self.forces / m, 0.0)
                self.coord = self.coord + dt * v_half
                self.forces, self.epot = self._force(self.coord)
                veloc = v_half + 0.5 * dt * torch.where(real, self.forces / m, 0.0)
                if md.thermostat == "langevin":
                    veloc = langevin_velocities(veloc, m, real, dt, md.friction_fs, md.temperature_K, self._noise())
                elif md.thermostat != "nve":
                    raise ValueError(f"SpatialMDDriver runs nve or langevin, not {md.thermostat!r}")
                self.veloc = veloc
                epots.append(self.epot)
            self._rebin()
            done += k
        return {"epot": torch.cat(epots).cpu().numpy() if epots else np.zeros(0, np.float32)}
