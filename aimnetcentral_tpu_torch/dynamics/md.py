"""Molecular dynamics (counterpart of aimnetcentral_tpu/dynamics/md.py).

Two engines, as in the JAX package:

- ``binned`` (the default for periodic systems; gas-phase clusters on
  request, on a grid planned over the atoms' extent): the slot layout of
  ops/binned.py.  A rebuild re-bins the SR and LR layouts, carrying
  velocities, masses and ``atom_id`` through the permutation.  Every step
  launches the conv kernels A and B three times each and the pair kernels
  D and E once per long-range sweep (DSF or the Ewald real-space sum; D3
  adds two).
- ``indexed`` (the default without a cell): neighbor matrices built on the
  device by ops/cell_list.py (an SR list at ``rc + skin``, an LR list at
  the largest long-range cutoff plus ``lr_skin``); a rebuild writes new
  lists and permutes nothing, so ``atom_id`` is the identity.  No kernel of
  the port runs: the conv is ``_conv_sv``'s gather, as on the calculator's
  indexed layout.

One step is velocity Verlet: a half kick, the drift, the Verlet-skin test,
the rebuild when an atom moved more than ``skin / 2`` since the last one,
the forces, the second half kick, then the thermostat (Langevin, Berendsen
or none) and the optional isotropic Berendsen barostat.  The forces come
from ``aimnet2_apply(..., sae_external=True)`` through autograd, inside the
precision tier's context, with the tier's conv precision.

The JAX driver fuses a chunk of steps into one ``lax.scan`` executable and
decides the re-bin on the device (``lax.cond``).  Here a chunk is a Python
loop of eager steps: the skin test's one-byte answer is read on the host
once per step, the only host sync inside a chunk; the overflow counter and
the observables reach the host once per chunk.  A chunk whose re-binning
overflowed a bin is retried from the last good state after growing the
capacity (on the indexed engine, whose list shapes are fixed, an overflow
raises ``RuntimeError``); after every good chunk the binned engine's
shrink-back hysteresis may re-plan the capacity down.  Each step builds new
tensors and never updates the carried ones in place, so the chunk-start
state stays valid for that retry; every carried tensor is detached, so no
autograd graph outlives its step.

Random numbers (initial velocities, Langevin noise) come from a
``torch.Generator`` on the device and are drawn per compact atom, then
gathered through ``atom_id``: the stream does not depend on the slot layout
or the capacity, so a restored checkpoint continues the same trajectory.
The JAX package draws other numbers, so Langevin runs of the two packages
agree only in distribution.

Ewald and PME heads run on both engines: the discretisation is attached
at construction and the LR layout reaches its real-space cutoff.

Ensembles (``ensemble=True``, member-stacked parameters of
calculators/ensemble.py::stack_params): the forces are those of the
members' mean energy, and ``epot_std``, the members' spread of the
potential, is an observable.  The fused forward (models/ensemble_fused.py:
one geometry, one member-stacked conv pass, the member forms of the pair
sweeps) runs unless ``AIMNET_ENSEMBLE_FUSED=0`` asks for one forward per
member, as in the JAX driver; the fused path needs the members' AEV
constants to agree.  Units: Angstrom / eV / amu; ``dt`` in fs via the ASE
time conversion.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import tempfile
from typing import Any

import numpy as np
import torch

from aimnetcentral_tpu_torch import constants
from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context, precision_tiers
from aimnetcentral_tpu_torch.device import resolve_device
from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config, aimnet2_apply
from aimnetcentral_tpu_torch.models.bridge import params_to
from aimnetcentral_tpu_torch.models.ensemble_fused import aimnet2_apply_ensemble, member_params
from aimnetcentral_tpu_torch.models.ewald import attach_ewald
from aimnetcentral_tpu_torch.models.heads import DFTD3Head, LRCoulombHead, auto_switch_simple_to_dsf
from aimnetcentral_tpu_torch.ops import binned as B
from aimnetcentral_tpu_torch.ops.cell_list import build_cell_list, plan_cell_list
from aimnetcentral_tpu_torch.system import System

_GEN_KEY = "torch_generator_state"  # the checkpoint's generator state (JAX: key_data)
_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MDConfig:
    dt_fs: float = 0.5
    temperature_K: float = 300.0
    thermostat: str = "langevin"  # langevin | nve | berendsen
    friction_fs: float = 0.01  # Langevin gamma in 1/fs
    berendsen_tau_fs: float = 100.0
    skin: float = 1.0  # Verlet skin (Angstrom)
    lr_skin: float = 1.0  # the indexed engine's LR list reaches this beyond the LR cutoff
    # capacity shrink-back hysteresis: after a transient occupancy excursion
    # grew the bin capacity, shrink back once the observed max occupancy
    # (+ shrink_margin slots) has fit in a smaller capacity for
    # shrink_patience consecutive chunks.  shrink_patience <= 0 disables it.
    shrink_patience: int = 8
    shrink_margin: int = 4
    # NPT (isotropic Berendsen barostat; DSF/D3 models): cell and
    # coordinates rescale toward the target pressure each step
    barostat: str | None = None  # None | "berendsen"
    pressure_eV_A3: float = 0.0  # target pressure (1 GPa = 6.2415e-3 eV/A^3)
    barostat_tau_fs: float = 1000.0
    compressibility_eV_A3: float = 73.2  # ~water (4.57e-5 / bar)
    # force-eval precision tier (calculators/calculator.py::precision_tiers):
    # None (= "fast": TF32 matmuls and one TF32 pass in kernels A and B,
    # fine for thermostatted MD), "balanced" (full f32 matmuls, A and B on
    # the 3xTF32 split: ~1e-6 eV/A of exact forces) or "exact" (full f32
    # everywhere, for NVE and drift-sensitive runs)
    precision: str | None = None


@dataclasses.dataclass(frozen=True)
class MDState:
    coord: torch.Tensor
    veloc: torch.Tensor  # ASE velocity units (Angstrom / ASE-time)
    forces: torch.Tensor  # forces at `coord` (velocity-Verlet carry: 1 eval/step)
    masses: torch.Tensor  # (N,) amu, carried so a re-bin permutes them with the atoms
    system: System  # current layout: binned slots, or the indexed lists
    ref_coord: torch.Tensor  # coordinates at the last re-bin
    rng_state: torch.Tensor  # the driver's torch.Generator state (JAX: the key)
    overflow: torch.Tensor  # (2,) accumulated dropped-atom counts [sr, lr]
    epot: torch.Tensor  # last potential energy per molecule
    atom_id: torch.Tensor  # (N,) slot -> compact row, carried through every re-bin (indexed: identity)


def maxwell_boltzmann_velocities(
    gen: torch.Generator,
    masses: torch.Tensor,
    numbers: torch.Tensor,
    temperature_K: float,
    atom_id: torch.Tensor,
    n_compact: int,
) -> torch.Tensor:
    """Velocities at ``temperature_K`` in the slot layout; padding rows
    zero."""
    kT = constants.kB * temperature_K
    sigma = torch.sqrt(kT / masses)[:, None]
    return sigma * _normal(gen, numbers, atom_id, n_compact)


def _normal(gen: torch.Generator, numbers, atom_id, n_compact: int) -> torch.Tensor:
    """Standard normal f32 draws, one row per compact atom (``n_compact``)
    gathered into the slot layout through ``atom_id``, so that they do not
    depend on the layout; zero on padding rows."""
    z = torch.randn((n_compact, 3), generator=gen, device=numbers.device, dtype=torch.float32)
    return torch.where((numbers > 0)[:, None], z[atom_id], 0.0)


def langevin_velocities(veloc: torch.Tensor, masses: torch.Tensor, real: torch.Tensor, dt: float,
                        friction_fs: float, temperature_K: float, noise: torch.Tensor) -> torch.Tensor:
    """The Langevin (BAOAB "O") update of velocity-Verlet velocities:
    ``c1 v + sigma noise`` with ``c1 = exp(-gamma dt)`` and ``sigma =
    sqrt((1 - c1^2) kT / m)``; ``masses`` (N, 1), ``real`` (N, 1), ``dt``
    in internal time units, padding rows zero."""
    c1 = math.exp(-(friction_fs / constants.fs) * dt)
    sigma = torch.sqrt((1.0 - c1 * c1) * (constants.kB * temperature_K) / masses)
    return torch.where(real, c1 * veloc + sigma * noise, 0.0)


def kinetic_temperature(veloc: torch.Tensor, masses: torch.Tensor, numbers: torch.Tensor) -> torch.Tensor:
    real = numbers > 0
    ke = 0.5 * torch.where(real[:, None], masses[:, None] * veloc**2, 0.0).sum()
    ndof = 3 * real.sum()
    return 2.0 * ke / (ndof * constants.kB)


def _max_bin_occupancy(numbers: torch.Tensor, capacity: int) -> int:
    """Max real-atom count over the bins of a slot-layout ``numbers`` array."""
    return int((numbers > 0).reshape(-1, capacity).sum(dim=1).max())


def _volume(cell: torch.Tensor) -> torch.Tensor:
    """|det| of a (3, 3) cell as the triple product: no host sync."""
    return torch.abs(torch.dot(cell[0], torch.linalg.cross(cell[1], cell[2])))


def _grown(grid: B.BinGrid, factor: float) -> B.BinGrid:
    """``grid`` with its capacity times ``factor``, in multiples of 8."""
    return dataclasses.replace(grid, capacity=int(np.ceil(grid.capacity * factor / 8.0)) * 8)


def _fitted_spec(system: System, cell_np, n_real: int, cutoff: float, extent: float | None):
    """The indexed engine's cell-list plan at ``cutoff``: the JAX package's
    ``plan_cell_list`` where its lists hold the initial geometry, else
    re-planned with 1.5 times the density safety until they do (as the
    binned engine's planning grows its bin safety).  The gas-phase plan
    takes the density over the extent's cube, about half a compact
    molecule's own, so JAX's driver overflows at construction on a
    113-atom cluster cut from a 0.09 atoms/A^3 box; the port plans again.
    Returns the plan and the ``(nbmat, shifts)`` of its build."""
    cell0 = system.cell[0] if system.cell is not None else None
    safety = 2.0  # plan_cell_list's density_safety
    while True:
        spec = plan_cell_list(cell_np, n_real, cutoff, extent=extent, density_safety=safety)
        nbmat, shifts, ovf = build_cell_list(system.coord, system.numbers, spec, cell0)
        if int(ovf) == 0:  # one host sync per plan
            return spec, nbmat, shifts
        safety *= 1.5
        if safety > 32:
            raise RuntimeError(f"cell-list planning failed at cutoff {cutoff}")


def _with_lists(system: System, coord, nbmat, shifts, nb_lr, sh_lr) -> System:
    """``system`` at ``coord`` with the indexed engine's SR and shared LR
    lists; split lists a caller built are dropped, since they would go
    stale."""
    return system.replace(
        coord=coord, nbmat=nbmat, shifts=shifts, nbmat_lr=nb_lr, shifts_lr=sh_lr,
        nbmat_coulomb=None, shifts_coulomb=None, nbmat_dftd3=None, shifts_dftd3=None,
    )


class MDDriver:
    """MD over a fixed-size system.

    Parameters
    ----------
    params : the port's model parameters (moved to ``device``), stacked on a
        leading member axis with ``ensemble=True``
    cfg : AIMNet2Config (SAE externalized; absolute offsets don't move atoms)
    system : initial compact System (defines shapes; the last row padding);
        converted to the binned layout, or given cell lists on the indexed
        engine
    engine : "auto" (binned with a cell, indexed without), "binned" or
        "indexed"
    device : "cuda" unless the caller asks for "cpu"; CUDA tensors run the
        hand-written kernels, CPU tensors their plain versions
    """

    def __init__(
        self,
        params: Any,
        cfg: AIMNet2Config,
        system: System,
        md: MDConfig = MDConfig(),
        ensemble: bool = False,
        seed: int = 0,
        engine: str = "auto",
        bin_safety: float = 1.5,
        device: str | torch.device = "cuda",
    ):
        if engine == "auto":
            engine = "binned" if system.cell is not None else "indexed"
        if engine not in ("binned", "indexed"):
            raise ValueError(f"engine must be 'auto', 'binned' or 'indexed', got {engine!r}")
        if system.cell is not None:
            cfg = auto_switch_simple_to_dsf(cfg)
        elif md.barostat is not None:
            raise ValueError("the barostat needs a periodic cell")
        precision_tiers(md.precision or "fast")  # validate
        self.device = resolve_device(device)
        self.cfg = cfg
        self.md = md
        self.params = params_to(params, self.device)
        self.engine = engine
        self.ensemble = ensemble
        self.ensemble_fused = ensemble and os.environ.get("AIMNET_ENSEMBLE_FUSED", "1") != "0"
        if self.ensemble_fused:
            # the fused forward reads member 0's AEV constants for all
            for k, v in self.params["aev"].items():
                if not torch.allclose(v, v[0:1].expand_as(v), atol=0.0):
                    raise ValueError(
                        f"ensemble members disagree on AEV constant {k!r}; the fused ensemble path requires "
                        "one architecture (set AIMNET_ENSEMBLE_FUSED=0 for heterogeneous ensembles)"
                    )

        system = system.to(self.device)
        # Ewald and PME: the discretisation is attached once, before the
        # first layout, and stays fixed over the trajectory (under the
        # Berendsen barostat too: the energy follows the instantaneous cell,
        # only the split between real and reciprocal space drifts with the
        # volume), as in the JAX driver
        self._ewald_rc = None
        ew_head = next(
            (h for _n, h in cfg.outputs if isinstance(h, LRCoulombHead) and h.method in ("ewald", "pme")), None
        )
        if ew_head is not None and system.cell is not None:
            if system.ewald_kpts is None:
                system = attach_ewald(system, ew_head.ewald_accuracy, pme=ew_head.method == "pme")
            self._ewald_rc = float(system.ewald_r_static)
        n_real = int((system.numbers > 0).sum())
        cell_np = system.cell[0].cpu().numpy() if system.cell is not None else None
        self._compact_system = system  # kept for checkpoint restore (rebuild)
        mass_table = np.clip(constants.get_masses(), 1e-6, None).astype(np.float32)
        self._mass_table = torch.as_tensor(mass_table, device=self.device)

        lr_cut = self._lr_cutoff()
        if engine == "binned":
            edge = cfg.aev.rc_s + md.skin
            extent = self._extent(system) if cell_np is None else None
            safety = bin_safety
            lr_safety = 1.5
            while True:
                grid = dataclasses.replace(
                    B.plan_bins(cell_np, n_real, edge, extent=extent, safety=safety), margin=md.skin
                )
                lr_grid = (
                    B.plan_lr_bins(cell_np, n_real, lr_cut, extent=extent, safety=lr_safety, margin=md.skin)
                    if lr_cut is not None
                    else None
                )
                sysb, atom_id, ovf = B.to_binned_system(system, grid, lr_grid)
                if not bool(ovf.any()):
                    break
                safety *= 1.5
                lr_safety *= 1.5
                if safety > 32:
                    raise RuntimeError("bin capacity planning failed")
        else:
            grid = lr_grid = None
            extent = None
            if cell_np is None:  # a cube over the atoms' span, 1 A of margin a side
                c = system.coord[:n_real].cpu().numpy()
                extent = float((c.max(0) - c.min(0)).max()) + 2.0
            self.sr_spec, nbmat, shifts = _fitted_spec(system, cell_np, n_real, cfg.aev.rc_s + md.skin, extent)
            self.lr_spec, nb_lr, sh_lr = (
                _fitted_spec(system, cell_np, n_real, lr_cut + md.lr_skin, extent)
                if lr_cut is not None
                else (None, None, None)
            )
            sysb = _with_lists(system, system.coord, nbmat, shifts, nb_lr, sh_lr)
            atom_id = torch.arange(sysb.natoms, device=self.device)
        self.grid = grid
        self.lr_grid = lr_grid
        self._n_compact = system.natoms
        masses = self._mass_table[sysb.numbers]
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        veloc = maxwell_boltzmann_velocities(
            self._gen, masses, sysb.numbers, md.temperature_K, atom_id, self._n_compact
        )
        # Initial forces are computed at the first ``run()`` or read of
        # ``.state``, one eager evaluation that leaves the generator as it is
        self._primed = False
        self._state = MDState(
            coord=sysb.coord,
            veloc=veloc,
            forces=torch.zeros_like(sysb.coord),
            masses=masses,
            system=sysb,
            ref_coord=sysb.coord,
            rng_state=self._gen.get_state(),
            overflow=torch.zeros((2,), dtype=torch.int64, device=self.device),
            epot=torch.zeros((sysb.num_mol,), dtype=torch.float32, device=self.device),
            atom_id=atom_id,
        )
        # per-chunk (sr, lr) max-occupancy history for shrink-back hysteresis
        self._occ_window: list[tuple[int, int]] = []
        # ctor plan capacities: the shrink floor (never shrink below plan)
        self._plan_capacity = (
            grid.capacity if grid is not None else 0, lr_grid.capacity if lr_grid is not None else 0
        )
        # what run() did, for measurement: re-binnings inside good chunks,
        # and chunks retried after a capacity regrow
        self.rebins = 0
        self.regrows = 0

    @property
    def state(self) -> MDState:
        """Current MD state; forces/epot at ``coord`` are always valid (the
        first read evaluates them)."""
        if not self._primed:
            forces0, epot0, _std = self._force_fn(self.params, self._state.system)
            self._state = dataclasses.replace(self._state, forces=forces0, epot=epot0)
            self._primed = True
        return self._state

    @state.setter
    def state(self, value: MDState) -> None:
        self._state = value
        self._primed = True

    @staticmethod
    def _extent(system: System) -> tuple[np.ndarray, np.ndarray]:
        """The real atoms' box with 0.5 A of margin a side: a gas-phase
        grid's plan."""
        c = system.coord.cpu().numpy()
        real = system.numbers.cpu().numpy() > 0
        return c[real].min(0) - 0.5, c[real].max(0) + 0.5

    def _lr_cutoff(self) -> float | None:
        """The LR layout's reach: the largest of the DSF, the D3 and (from
        the attached discretisation) the Ewald real-space cutoffs."""
        cuts = []
        for _n, h in self.cfg.outputs:
            if isinstance(h, LRCoulombHead):
                if h.method not in ("ewald", "pme"):
                    cuts.append(h.dsf_rc)
                elif self._ewald_rc is not None:
                    cuts.append(self._ewald_rc)
            elif isinstance(h, DFTD3Head):
                cuts.append(h.cutoff)
        return max(cuts) if cuts else None

    # -- the indexed engine's lists -------------------------------------------

    def _build_nb_indexed(self, coord: torch.Tensor, system: System) -> tuple[System, torch.Tensor]:
        """``system`` at ``coord`` with new cell lists (SR, and the shared LR
        list when a long-range head exists), and their overflow count."""
        cell0 = system.cell[0] if system.cell is not None else None
        nbmat, shifts, ovf = build_cell_list(coord, system.numbers, self.sr_spec, cell0)
        nb_lr = sh_lr = None
        if self.lr_spec is not None:
            nb_lr, sh_lr, ovf_lr = build_cell_list(coord, system.numbers, self.lr_spec, cell0)
            ovf = ovf + ovf_lr
        return _with_lists(system, coord, nbmat, shifts, nb_lr, sh_lr), ovf

    def _rebuild_indexed(self, system: System) -> System:
        """``system`` with new cell lists; an overflow raises."""
        new, ovf = self._build_nb_indexed(system.coord, system)
        if int(ovf) > 0:
            raise RuntimeError(f"neighbor capacity overflow at initialization ({int(ovf)} pairs)")
        return new

    # -- energy/forces ------------------------------------------------------

    def _tier(self) -> tuple[str, str | None]:
        """The MDConfig tier's ``(matmul_precision, conv_precision)``."""
        return precision_tiers(self.md.precision or "fast")

    def _tier_context(self):
        """The tier's matmul context; it wraps the forward and
        ``torch.autograd.grad``, whose backward GEMMs run when the gradient
        is pulled."""
        return ambient_matmul_context(self._tier()[0])

    def _energy_members(self, params: Any, system: System) -> torch.Tensor:
        """Per-member energies (E, num_mol) of an ensemble (the fused
        forward, or one forward per member), (num_mol,) of a single model;
        kernels A and B in the tier's conv mode."""
        conv_prec = self._tier()[1]
        if not self.ensemble:
            return aimnet2_apply(params, self.cfg, system, sae_external=True, conv_precision=conv_prec)["energy"]
        if self.ensemble_fused:
            return aimnet2_apply_ensemble(params, self.cfg, system, sae_external=True,
                                          conv_precision=conv_prec)["energy"]
        n_e = params["afv"]["weight"].shape[0]
        return torch.stack([
            aimnet2_apply(member_params(params, e), self.cfg, system, sae_external=True,
                          conv_precision=conv_prec)["energy"]
            for e in range(n_e)
        ])

    def _energy(self, params: Any, system: System) -> torch.Tensor:
        e = self._energy_members(params, system)
        return e.mean(0) if self.ensemble else e

    def _force_fn(self, params: Any, system: System) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """Forces of the (member-mean) energy, the per-molecule potential
        and, for an ensemble, the members' spread of it (population
        standard deviation, JAX's ``std``)."""
        coord = system.coord.detach().requires_grad_(True)
        with self._tier_context():
            e_m = self._energy_members(params, system.replace(coord=coord))
            e = e_m.mean(0) if self.ensemble else e_m
            (g,) = torch.autograd.grad(e.sum(), coord)
        if self.ensemble:
            return -g, e.detach(), e_m.detach().std(dim=0, correction=0)
        return -g, e.detach(), None

    def _force_virial_fn(self, params: Any, system: System) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Forces, potential and the strain-derivative trace tr(dE/dS)
        (row-vector convention coord @ (1+S), cell @ (1+S), as in
        calculators/derivatives.py) for barostat coupling.  The cell is a
        leaf that requires grad; its gradient arrives through the lattice
        shifts, i.e. the shift adjoints of kernels B and E."""
        coord = system.coord.detach().requires_grad_(True)
        cell = system.cell.detach().requires_grad_(True)
        with self._tier_context():
            e = self._energy(params, system.replace(coord=coord, cell=cell))
            g_c, g_cell = torch.autograd.grad(e.sum(), (coord, cell))
        real = (system.numbers > 0)[:, None]
        tr_w = torch.where(real, system.coord * g_c, 0.0).sum() + (system.cell * g_cell).sum()
        return -g_c, e.detach(), tr_w

    # -- one MD step --------------------------------------------------------

    def _rebin(self, state: MDState, coord: torch.Tensor) -> tuple[MDState, torch.Tensor]:
        """``state`` re-binned at ``coord`` into the current ``self.grid`` and
        ``self.lr_grid`` (``to_binned_system`` on the slot layout, which
        carries velocities, forces, masses and ``atom_id`` through its
        permutation), and the (2,) ``[sr, lr]`` overflow of that binning."""
        sysb, perm, ovf = B.to_binned_system(state.system.replace(coord=coord), self.grid, self.lr_grid)
        return dataclasses.replace(
            state,
            coord=sysb.coord,
            veloc=B.to_slots(state.veloc, perm),
            forces=B.to_slots(state.forces, perm),
            masses=B.to_slots(state.masses, perm),
            system=sysb,
            ref_coord=sysb.coord,
            atom_id=B.to_slots(state.atom_id, perm),
        ), ovf

    def _step(self, state: MDState) -> tuple[MDState, dict, bool]:
        """One velocity-Verlet step; returns the new state, the step's
        observables (device scalars) and whether it rebuilt the layout."""
        md = self.md
        dt_fs = md.dt_fs
        dt = float(np.float32(dt_fs) * np.float32(constants.fs))  # f32, as the JAX driver's traced dt
        m = state.masses[:, None]
        real = (state.system.numbers > 0)[:, None]

        acc = torch.where(real, state.forces / m, 0.0)
        v_half = state.veloc + 0.5 * dt * acc
        coord = state.coord + dt * v_half

        disp2 = ((coord - state.ref_coord) ** 2).sum(dim=-1)
        need = torch.where(real[:, 0], disp2, 0.0).max() > (md.skin * 0.5) ** 2
        rebinned = bool(need)  # the step's one host sync
        if rebinned and self.engine == "indexed":
            system, ovf_sr = self._build_nb_indexed(coord, state.system)
            masses, ref_coord, atom_id = state.masses, coord, state.atom_id
            ovf = torch.stack([ovf_sr, torch.zeros_like(ovf_sr)])
        elif rebinned:
            moved, ovf = self._rebin(dataclasses.replace(state, veloc=v_half), coord)
            system, v_half, masses = moved.system, moved.veloc, moved.masses
            coord, ref_coord, atom_id = moved.coord, moved.ref_coord, moved.atom_id
        else:
            system = state.system.replace(coord=coord)
            masses, ref_coord, atom_id = state.masses, state.ref_coord, state.atom_id
            ovf = torch.zeros_like(state.overflow)

        m = masses[:, None]
        real = (system.numbers > 0)[:, None]
        epot_std = None
        if md.barostat == "berendsen":
            forces2, epot, tr_w = self._force_virial_fn(self.params, system)
        else:
            forces2, epot, epot_std = self._force_fn(self.params, system)
        acc2 = torch.where(real, forces2 / m, 0.0)
        veloc = v_half + 0.5 * dt * acc2

        rng_state = state.rng_state
        if md.thermostat == "langevin":
            self._gen.set_state(rng_state)
            noise = _normal(self._gen, system.numbers, atom_id, self._n_compact)
            rng_state = self._gen.get_state()
            veloc = langevin_velocities(veloc, m, real, dt, md.friction_fs, md.temperature_K, noise)
        elif md.thermostat == "berendsen":
            t_now = kinetic_temperature(veloc, masses, system.numbers)
            lam = torch.sqrt(
                1.0 + (dt_fs / md.berendsen_tau_fs) * (md.temperature_K / torch.clamp(t_now, min=1.0) - 1.0)
            )
            veloc = torch.where(real, veloc * lam, 0.0)

        obs = {"epot": epot.sum(), "temperature": kinetic_temperature(veloc, masses, system.numbers)}
        if epot_std is not None:  # the ensemble's uncertainty, free with the members' energies
            obs["epot_std"] = epot_std.sum()
        if md.barostat == "berendsen":
            # instantaneous pressure P = (2 KE - tr(dE/dS)) / (3 V), then the
            # Berendsen volume rescale mu^3 = 1 - beta (dt/tau) (P0 - P);
            # fractional coordinates are preserved (coord and cell scale
            # together), so the binned layout stays valid within the skin
            two_ke = torch.where(real, m * veloc**2, 0.0).sum()
            volume = _volume(system.cell[0])
            pressure = (two_ke - tr_w) / (3.0 * volume)
            mu3 = 1.0 - (md.compressibility_eV_A3 * dt_fs / md.barostat_tau_fs) * (md.pressure_eV_A3 - pressure)
            mu = torch.clamp(mu3, 0.97, 1.03) ** (1.0 / 3.0)
            coord = coord * mu
            ref_coord = ref_coord * mu
            system = system.replace(coord=coord, cell=system.cell * mu)
            obs["pressure"] = pressure
            obs["volume"] = volume

        new_state = MDState(
            coord=coord,
            veloc=veloc,
            forces=forces2,
            masses=masses,
            system=system,
            ref_coord=ref_coord,
            rng_state=rng_state,
            overflow=state.overflow + ovf,
            epot=epot,
            atom_id=atom_id,
        )
        return new_state, obs, rebinned

    def _run_chunk(self, state: MDState, n: int) -> tuple[MDState, dict[str, torch.Tensor], int]:
        """``n`` steps from ``state``: the end state, the observables stacked
        per step (still on the device) and the number of re-binnings."""
        steps, rebins = [], 0
        for _ in range(n):
            state, obs, rebinned = self._step(state)
            steps.append(obs)
            rebins += rebinned
        return state, {k: torch.stack([o[k] for o in steps]) for k in steps[0]}, rebins

    # -- host API -----------------------------------------------------------

    def _grow_capacity(
        self, state: MDState, factor: float = 1.25, grow_sr: bool = True, grow_lr: bool = False
    ) -> MDState:
        """Re-plan the binned grid with more slot capacity and re-bin the
        carried state (across chunk boundaries; the chunk is then retried).
        The indexed engine's list shapes are fixed: an overflow raises."""
        if self.engine != "binned":
            raise RuntimeError(
                "neighbor capacity overflow on the indexed engine; reconstruct the driver with a larger plan"
            )
        if grow_sr:
            # growing the SR grid makes every conv pair block bigger: only
            # when the SR layout actually overflowed
            self.grid = _grown(self.grid, factor)
        if grow_lr and self.lr_grid is not None:
            self.lr_grid = _grown(self.lr_grid, factor)
        state2 = self._rebin_state(state)
        if state2 is None:  # re-bin overflowed the new plan: grow harder
            return self._grow_capacity(state, factor * 1.5, grow_sr=True, grow_lr=grow_lr)
        return state2

    def _rebin_state(self, state: MDState) -> MDState | None:
        """Re-bin the carried dynamical state into the CURRENT ``self.grid``/
        ``self.lr_grid`` layouts.  Returns None if either layout overflows
        (the caller decides how to re-plan)."""
        state2, ovf = self._rebin(state, state.coord)
        if bool(ovf.any()):
            return None
        self._occ_window.clear()
        return dataclasses.replace(state2, overflow=torch.zeros_like(state.overflow))

    def _maybe_shrink(self, state: MDState) -> MDState:
        """Shrink-back hysteresis, called after every good chunk: records the
        chunk's max bin occupancy, and once ``shrink_patience`` consecutive
        chunks would have fit (with ``shrink_margin`` spare slots) in a
        capacity at least one 8-slot step smaller, re-plans down (never
        below the constructor's plan) and re-bins the carried state."""
        md = self.md
        if self.engine != "binned" or md.shrink_patience <= 0:
            return state
        occ_sr = _max_bin_occupancy(state.system.numbers, self.grid.capacity)
        occ_lr = 0
        if self.lr_grid is not None:
            occ_lr = _max_bin_occupancy(state.system.numbers[state.system.lr_slot], self.lr_grid.capacity)
        self._occ_window.append((occ_sr, occ_lr))
        if len(self._occ_window) < md.shrink_patience:
            return state
        self._occ_window = self._occ_window[-md.shrink_patience :]

        def _target(max_occ: int, floor: int) -> int:
            return max(floor, int(np.ceil((max_occ + md.shrink_margin) / 8.0)) * 8)

        sr_t = _target(max(o[0] for o in self._occ_window), self._plan_capacity[0])
        lr_t = (
            _target(max(o[1] for o in self._occ_window), self._plan_capacity[1])
            if self.lr_grid is not None
            else None
        )
        shrink_sr = sr_t < self.grid.capacity
        shrink_lr = lr_t is not None and lr_t < self.lr_grid.capacity
        if not (shrink_sr or shrink_lr):
            return state
        old_grid, old_lr = self.grid, self.lr_grid
        if shrink_sr:
            self.grid = dataclasses.replace(self.grid, capacity=sr_t)
        if shrink_lr:
            self.lr_grid = dataclasses.replace(self.lr_grid, capacity=lr_t)
        _log.info(
            "bin occupancy settled: shrinking capacity sr %d->%d lr %s->%s",
            old_grid.capacity, self.grid.capacity,
            None if old_lr is None else old_lr.capacity,
            None if self.lr_grid is None else self.lr_grid.capacity,
        )
        state2 = self._rebin_state(state)
        if state2 is None:  # raced an excursion between stat and re-bin
            self.grid, self.lr_grid = old_grid, old_lr
            self._occ_window.clear()
            return state
        return state2

    def snapshot(self, state: MDState | None = None) -> dict[str, np.ndarray]:
        """Current frame in the CALLER's atom order (undoes the slot
        permutation via the carried ``atom_id``): coord (wrapped on the
        binned engine), numbers, velocities, plus the cell if periodic."""
        state = self._state if state is None else state
        numbers = state.system.numbers.cpu().numpy()
        real = numbers > 0
        n = self._n_compact
        out = {
            "coord": np.zeros((n, 3), np.float32),
            "veloc": np.zeros((n, 3), np.float32),
            "numbers": np.zeros((n,), numbers.dtype),
        }
        ids = state.atom_id.cpu().numpy()[real]
        out["coord"][ids] = state.coord.cpu().numpy()[real]
        out["veloc"][ids] = state.veloc.cpu().numpy()[real]
        out["numbers"][ids] = numbers[real]
        if state.system.cell is not None:
            out["cell"] = state.system.cell[0].cpu().numpy()
        return out

    # -- checkpoint / resume -------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Write the dynamical state (coord/veloc in CALLER atom order, the
        cell if periodic, the generator state) as one .npz,
        layout-independent: restore rebuilds the layout from scratch.  Atomic
        write (temp file + ``os.replace``)."""
        snap = self.snapshot()
        payload = {
            "coord": snap["coord"],
            "veloc": snap["veloc"],
            "numbers": snap["numbers"],
            _GEN_KEY: self.state.rng_state.cpu().numpy(),
        }
        if "cell" in snap:
            payload["cell"] = snap["cell"]
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
        os.close(fd)
        try:
            np.savez(tmp, **payload)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def restore_checkpoint(self, path: str) -> None:
        """Resume from ``save_checkpoint``: rebuilds the layout from the
        restored coordinates and cell (the binned engine grows its capacity
        if the new geometry overflows; the indexed engine raises), injects
        the velocities into the new layout and restores the generator;
        forces are evaluated again at the next ``run``."""
        with np.load(path) as d:
            ckpt = {k: d[k] for k in d.files}
        numbers_now = self._compact_system.numbers.cpu().numpy()
        if not np.array_equal(ckpt["numbers"], numbers_now):
            raise ValueError(
                "checkpoint was written for a different atom set "
                "(numbers mismatch); construct the driver over the same system"
            )
        if _GEN_KEY not in ckpt:
            raise ValueError(
                f"checkpoint has no {_GEN_KEY!r}: it was not written by this port's MDDriver "
                "(a JAX checkpoint's 'key_data' cannot seed a torch.Generator)"
            )
        dev = self.device
        compact = self._compact_system.replace(coord=torch.as_tensor(ckpt["coord"], dtype=torch.float32, device=dev))
        if "cell" in ckpt:
            compact = compact.replace(cell=torch.as_tensor(ckpt["cell"], dtype=torch.float32, device=dev)[None])
        if self.engine == "indexed":
            sysb = self._rebuild_indexed(compact)
            atom_id = torch.arange(sysb.natoms, device=dev)
        while self.engine == "binned":
            sysb, atom_id, ovf = B.to_binned_system(compact, self.grid, self.lr_grid)
            if not bool(ovf.any()):
                break
            self.grid = _grown(self.grid, 1.25)
            if self.lr_grid is not None:
                self.lr_grid = _grown(self.lr_grid, 1.25)
        masses = self._mass_table[sysb.numbers]
        veloc_compact = torch.as_tensor(ckpt["veloc"], dtype=torch.float32, device=dev)
        veloc = torch.where((sysb.numbers > 0)[:, None], veloc_compact[atom_id], 0.0)
        self._state = MDState(
            coord=sysb.coord,
            veloc=veloc,
            forces=torch.zeros_like(sysb.coord),
            masses=masses,
            system=sysb,
            ref_coord=sysb.coord,
            rng_state=torch.as_tensor(ckpt[_GEN_KEY], dtype=torch.uint8),
            overflow=torch.zeros((2,), dtype=torch.int64, device=dev),
            epot=torch.zeros((sysb.num_mol,), dtype=torch.float32, device=dev),
            atom_id=atom_id,
        )
        self._occ_window.clear()
        self._primed = False  # the next run() evaluates the forces again

    def run(self, n_steps: int, chunk: int = 50, traj=None) -> dict[str, np.ndarray]:
        """Run ``n_steps`` of MD; returns stacked per-step observables.

        ``traj``: optional ``dynamics.trajectory.TrajectoryWriter``: one
        frame (caller atom order, wrapped coordinates) is appended after
        every completed chunk, stamped with the chunk-end potential energy.

        The driver executes ``ceil(n_steps / chunk)`` WHOLE chunks
        (observables are truncated to ``n_steps``).  The host reads the
        overflow counter and the observables once per chunk.  On an
        overflow the driver grows the bin capacity, re-bins the carried
        state and RETRIES the chunk from the last good state (the generator
        state included), at most 6 times in a run.
        """
        all_obs = []
        state = self.state  # evaluates the initial forces once if needed
        n_chunks = int(np.ceil(n_steps / chunk))
        i = 0
        retries = 0
        while i < n_chunks:
            new_state, obs, rebins = self._run_chunk(state, chunk)
            ovf = new_state.overflow.cpu().numpy()
            if ovf.sum() > 0:
                retries += 1
                if retries > 6:
                    raise RuntimeError("neighbor capacity overflow persists after repeated growth")
                _log.warning(
                    "bin capacity overflow (sr=%d, lr=%d): growing %s and retrying the chunk",
                    int(ovf[0]), int(ovf[1]),
                    "+".join(n for n, g in (("sr", ovf[0] > 0), ("lr", ovf[1] > 0)) if g),
                )
                state = self._grow_capacity(state, grow_sr=bool(ovf[0] > 0), grow_lr=bool(ovf[1] > 0))
                self.regrows += 1
                continue  # retry this chunk with the grown capacity
            self.rebins += rebins
            state = self._maybe_shrink(new_state)
            all_obs.append({k: v.cpu().numpy() for k, v in obs.items()})
            i += 1
            if traj is not None:
                frame = self.snapshot(state)
                real = frame["numbers"] > 0  # drop padding rows from output
                traj.write(
                    frame["numbers"][real], frame["coord"][real],
                    cell=frame.get("cell"),
                    comment={"step": min(i * chunk, n_steps),
                             "epot_eV": float(state.epot.sum().cpu())},
                )
        self.state = state
        return {k: np.concatenate([o[k] for o in all_obs])[:n_steps] for k in all_obs[0]}
