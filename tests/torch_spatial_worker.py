"""Rank bodies of the spatial-decomposition and data-parallel training
tests.  Spawned ranks import this module and the port only, never JAX:
``run`` executes a list of tasks on one rank of a gloo world and pickles
that rank's results to ``<out_dir>/rank<r>.pkl``, which the test process
reads."""

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


def task_energy(device, system, cfg, params, n_sp, n_spy=1, observables=False, n_ens=1):
    """Energy, forces, the cell gradient and the stress of the box on the
    mesh (and, with ``observables``, the observables).  ``n_ens > 1``: an
    ``(ens, sp[, spy])`` mesh and ``params`` stacked on a member axis, every
    output per member."""
    spec = plan_spatial(system, cfg, n_sp, n_spy)
    mesh = make_spatial_mesh(n_sp, n_spy, device, n_ens=n_ens)
    if mesh is None:
        return None
    s, params = system.to(device), params_to(params, device)
    efn = make_spatial_energy_fn(cfg, spec, mesh, ewald_kpts=s.ewald_kpts, observables=observables,
                                 ens_axis="ens" if n_ens > 1 else None)
    out = spatial_forces(efn, params, s.coord, s.numbers, s.charge, s.cell[0], s.mult, stress=True)
    return {k: _np(v) for k, v in out.items()} | {"halo": spec.halo, "ext_nbins": spec.ext_grid.nbins,
                                                 "coords": mesh.coords, "member": efn.member}


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


def task_train_step(device, cfg, params, sample, size, layout, with_forces, precision, lr):
    """One data-parallel train step on ``make_mesh``'s mesh over the world:
    this rank's microbatch of ``sample`` (the trainer's split), the
    averaged gradients the optimizer took, the metrics and the parameters
    after the step."""
    from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset
    from aimnetcentral_tpu_torch.parallel.mesh import make_mesh
    from aimnetcentral_tpu_torch.train import step as tstep
    from aimnetcentral_tpu_torch.train.loss import LossConfig, MTLoss
    from aimnetcentral_tpu_torch.train.trainer import Trainer, TrainerConfig

    mesh = make_mesh(device=device)
    ds = SizeGroupedDataset({size: sample})
    trainer = Trainer(cfg, params, ds, tcfg=TrainerConfig(layout=layout, learning_rate=lr), device=device,
                      mesh=mesh)
    system, labels = trainer._batch(ds, size, sample)
    taken = []

    class Capturing(tstep.Optimizer):
        def apply(self, adam, leaves, grads):
            taken.extend(g.clone() for g in grads)
            return super().apply(adam, leaves, grads)

    opt = Capturing(learning_rate=lr)
    state = tstep.init_train_state(trainer.state.params, opt)
    step = tstep.make_train_step(cfg, MTLoss(LossConfig()), opt, with_forces=with_forces, precision=precision,
                                 mesh=mesh)
    state, metrics = step(state, system, labels)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {p: _np(g) for (p, _leaf), g in zip(state.trainable, taken)},
            "params": [_np(x) for _p, x in tstep.tree_leaves(state.params)],
            "n_mol": int((labels["energy"].numel())), "index": mesh.index}


def task_stats(device, pred, true, mask):
    """``batch_stats`` of this rank's block summed over ``dp``
    (``reduce_stats``), and the host accumulators summed over the world
    (``RegMultiMetric.compute(multihost=True)``)."""
    from aimnetcentral_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from aimnetcentral_tpu_torch.train import metrics as tm

    mesh = make_mesh(device=device)
    take = batch_sharding(mesh).take
    p, t, m = (take(torch.as_tensor(x)) for x in (pred, true, mask))
    stats = tm.reduce_stats({"f": tm.batch_stats(p, t, m)}, mesh, "dp")
    metric = tm.RegMultiMetric([tm.MetricConfig("f", "f")])
    metric.update({"f": p.numpy()}, {"f": t.numpy()}, weights={"f": m.numpy()})
    return {"stats": {k: float(v) for k, v in stats["f"].items()}, "compute": metric.compute(multihost=True)}


def task_trainer(device, cfg, params, train, val, tcfg, loss_cfg):
    """``Trainer(mesh=make_mesh())`` fitted on every rank; the history and
    the state after it."""
    from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset
    from aimnetcentral_tpu_torch.parallel.mesh import make_mesh
    from aimnetcentral_tpu_torch.train.step import tree_leaves
    from aimnetcentral_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, params, SizeGroupedDataset(train), SizeGroupedDataset(val), tcfg=tcfg, loss_cfg=loss_cfg,
                      device=device, mesh=make_mesh(device=device))
    out = trainer.fit()
    return {"history": out["history"], "best_val": out["best_val"], "lead": trainer.lead,
            "params": [_np(x) for _p, x in tree_leaves(trainer.state.params)]}


TASKS = {"energy": task_energy, "md": task_md, "collectives": task_collectives, "dp_mesh": task_dp_mesh,
         "train_step": task_train_step, "stats": task_stats, "trainer": task_trainer}


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
