"""Rank bodies of the spatial-decomposition tests.  Spawned ranks import
this module and the port only, never JAX: ``run`` executes a list of tasks
on one rank of a gloo world and pickles that rank's results to
``<out_dir>/rank<r>.pkl``, which the test process reads."""

import os
import pickle

import numpy as np
import torch

from aimnetcentral_tpu_torch.models.bridge import params_to
from aimnetcentral_tpu_torch.parallel import collectives
from aimnetcentral_tpu_torch.parallel.mesh import make_spatial_mesh
from aimnetcentral_tpu_torch.parallel.spatial import (
    SpatialMDDriver,
    make_spatial_energy_fn,
    plan_spatial,
    spatial_forces,
)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def task_energy(device, system, cfg, params, n_sp, n_spy=1, observables=False):
    """Energy, forces, the cell gradient and the stress of the box on the
    mesh (and, with ``observables``, the observables)."""
    spec = plan_spatial(system, cfg, n_sp, n_spy)
    mesh = make_spatial_mesh(n_sp, n_spy, device)
    if mesh is None:
        return None
    s, params = system.to(device), params_to(params, device)
    efn = make_spatial_energy_fn(cfg, spec, mesh, ewald_kpts=s.ewald_kpts, observables=observables)
    out = spatial_forces(efn, params, s.coord, s.numbers, s.charge, s.cell[0], s.mult, stress=True)
    return {k: _np(v) for k, v in out.items()} | {"halo": spec.halo, "ext_nbins": spec.ext_grid.nbins}


def task_md(device, system, cfg, params, n_sp, n_spy, md, steps, chunk):
    """``steps`` steps of SpatialMDDriver; its initial velocities and masses
    in global slot order for a reference loop."""
    drv = SpatialMDDriver(params_to(params, device), cfg, system, md, n_sp, seed=0, n_spy=n_spy, device=device)
    veloc0, masses = drv.gather(drv.veloc), drv.gather(drv.masses)
    out = drv.run(steps, chunk=chunk)
    return {"epot": out["epot"], "veloc0": _np(veloc0), "masses": _np(masses)}


def task_collectives(device, n_sp, n_spy, rows, width, h, seed):
    """The halo exchange (both axes), the all-reduce and the replicated sum
    of a seeded global array's blocks; this rank's loss share and its
    gradient, for a one-process reference; the collectives' clock over the
    forward and backward (and off before them)."""
    mesh = make_spatial_mesh(n_sp, n_spy, device)
    if mesh is None:
        return None
    clock = collectives.clock
    clock.reset()
    collectives.all_reduce_sum(torch.ones(1, device=device), mesh)
    clock_off = (clock.exchange, clock.all_reduce)
    clock.on = True
    rng = np.random.default_rng(seed)
    ny = rows if n_spy > 1 else 1
    g = rng.normal(size=(n_sp * rows, n_spy * ny, width)).astype(np.float32)
    w_ext = rng.normal(size=(mesh.size, rows + 2 * h, ny + (2 * h if n_spy > 1 else 0), width)).astype(np.float32)
    v = rng.normal(size=(mesh.size, width)).astype(np.float32)
    ix, iy = mesh.coords[0], (mesh.coords[1] if n_spy > 1 else 0)
    me = mesh.ranks.index(torch.distributed.get_rank())
    block = torch.tensor(g[ix * rows : (ix + 1) * rows, iy * ny : (iy + 1) * ny], device=device, requires_grad=True)
    ext = collectives.halo_exchange(block, mesh, "sp", 0, h)
    if n_spy > 1:
        ext = collectives.halo_exchange(ext, mesh, "spy", 1, h)
    z = collectives.all_reduce_sum(block.sum((0, 1)), mesh)
    share = (torch.tensor(w_ext[me], device=device) * ext).sum() + (torch.tensor(v[me], device=device) * z).sum()
    total = collectives.sum_replicated(share[None], mesh)
    (grad,) = torch.autograd.grad(total.sum(), block)
    clock.on = False
    return {"total": _np(total), "grad": _np(grad), "ext": _np(ext), "coords": mesh.coords,
            "g": g, "w_ext": w_ext, "v": v, "clock_off": clock_off, "clock": (clock.exchange, clock.all_reduce)}


def task_dp_mesh(device, batch):
    """``make_mesh`` over the world (``dp``), the first rank's parameters
    replicated, and this rank's block of a stacked System batch."""
    from aimnetcentral_tpu_torch.parallel.mesh import batch_sharding, make_mesh, replicate, shard_system

    mesh = make_mesh(device=device)
    rank = torch.distributed.get_rank()
    tree = replicate(mesh, {"w": torch.full((3,), float(rank)), "mlps": [torch.arange(4) + rank]})
    mine = shard_system(mesh, batch)
    sharding = batch_sharding(mesh)
    return {"axis_names": mesh.axis_names, "shape": mesh.shape, "coords": mesh.coords, "w": _np(tree["w"]),
            "mlps": _np(tree["mlps"][0]), "coord": _np(mine.coord), "numbers": _np(mine.numbers),
            "block": (sharding.index, sharding.count)}


TASKS = {"energy": task_energy, "md": task_md, "collectives": task_collectives, "dp_mesh": task_dp_mesh}


def run(rank: int, device: torch.device, tasks: list, out_dir: str) -> None:
    torch.set_num_threads(1)
    results = {}
    for name, kind, kwargs in tasks:
        results[name] = TASKS[kind](device, **kwargs)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(results, fh)


def run_world(world_size: int, tasks: list, out_dir: str, device: str = "cpu") -> list[dict]:
    """Run ``tasks`` on a new world of ``world_size`` ranks (gloo on the
    CPU; on the card the backend the hardware gives); every rank's results,
    in rank order."""
    from aimnetcentral_tpu_torch.parallel.mesh import spawn

    spawn(run, world_size, args=(tasks, out_dir), device=device)
    out = []
    for r in range(world_size):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out
