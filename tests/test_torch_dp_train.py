"""The port's data-parallel training (train/step.py and train/trainer.py
with a mesh, train/metrics.py's reductions) against the JAX package's on
its eight virtual CPU devices.

One gloo world of two CPU ranks (``tests/torch_spatial_worker.py``, which
imports no JAX) runs every case while the test process runs JAX's:

- the train step with the force loss on JAX's layout test's model
  (simple Coulomb), on molecule bins and on the indexed layout, at both
  tiers: JAX's ``make_train_step`` on ``make_mesh(n_dp=2)``-sharded
  stacked microbatches (split as JAX's ``Trainer._device_batch`` splits)
  against the port's step on two ranks, each taking its microbatch through
  ``Trainer._batch``: the loss, its components and ``grad_norm`` within
  1e-5, every trainable leaf's averaged gradient within 1e-5 of that
  leaf's largest magnitude (floor 1e-7), and the parameters after the
  step the same bits on both ranks.  Four molecules over two ranks, an
  uneven split (three: two and one padded to two) and one with an empty
  microbatch (one: one and none, padded to one), each on both layouts.
  JAX's ``system_molecule_bins`` raises on a part with no molecules, where the
  port's gives empty bins (ROADMAP.md section 3): there the port's
  molecule-bin step is held to JAX's step on the same microbatches on the
  indexed layout.  Where an indexed microbatch
  holds padded molecules, JAX's gradient is NaN (their stacked atoms at
  zero distance, ROADMAP.md section 3) and the port's trainer spreads
  those atoms apart (``trainer.spread_padding``): its loss is held to
  JAX's on JAX's own microbatches, its gradient to JAX's on the
  microbatches spread the same way;
- ``batch_stats`` summed over ``dp`` by ``reduce_stats`` against JAX's
  ``psum`` inside ``shard_map`` and against the host accumulation of the
  whole batch (JAX's ``test_metrics_psum_matches_host_accumulation``),
  and ``compute(multihost=True)`` against the host's;
- ``Trainer(mesh=make_mesh())`` for two epochs with validation against
  JAX's ``Trainer(mesh=make_mesh(n_dp=2))``: every history record within
  ``test_torch_trainer.py::test_fit_history_matches_jax``'s limit, the
  same on both ranks, only the lead rank writing the checkpoint and the
  log; the lead's checkpoint resumed in one port process and in JAX's
  mesh trainer, each training one more epoch (the same record within that
  limit);
- an epoch of ``Trainer(mesh=...)`` on the default layout (molecule bins)
  whose last batch, a size group of one molecule, leaves a rank with no
  molecule: it finishes, finite, the same on both ranks, and gives the
  indexed layout's record within that limit.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.builders import stack_systems as j_stack_systems  # noqa: E402
from aimnetcentral_tpu.data.sgdataset import SizeGroupedDataset as JDataset  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.parallel import batch_sharding as j_batch_sharding  # noqa: E402
from aimnetcentral_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from aimnetcentral_tpu.train import loss as jloss  # noqa: E402
from aimnetcentral_tpu.train import metrics as jmetrics  # noqa: E402
from aimnetcentral_tpu.train import step as jstep  # noqa: E402
from aimnetcentral_tpu.train import trainer as jtrainer  # noqa: E402
from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset as TDataset  # noqa: E402
from aimnetcentral_tpu_torch.train import loss as tloss  # noqa: E402
from aimnetcentral_tpu_torch.train import trainer as ttrainer  # noqa: E402
from test_packed_train import _cfg_with_coulomb  # noqa: E402
from test_torch_train_step import SIZE, _one_torch_thread, _sample, capturing  # noqa: E402, F401  (a fixture)
from test_torch_trainer import _data, _loss, _same_record, _tcfg  # noqa: E402
from torch_spatial_helpers import World  # noqa: E402
from torch_train_helpers import jax_leaves, port_object, port_params  # noqa: E402

LR = 1e-3
N_DEV = 2
SIZE_SHORT = 5  # atoms of the short epoch's one-molecule size group
# (layout, molecules): an even split, an uneven one, one with an empty part
# (indexed first: it is the reference of the molecule-bin step there)
SPLITS = [("packed", 4), ("indexed", 4), ("packed", 3), ("indexed", 3), ("indexed", 1), ("packed", 1)]
STEPS = [(layout, n, precision) for layout, n in SPLITS for precision in ("fast", "exact")]


def _take(sample, n):
    return {k: v[:n] for k, v in sample.items()}


def _spread(system, n_mol):
    """JAX's indexed microbatch with the padded molecules' atoms moved as
    the port's ``trainer.spread_padding`` moves them: 1, 2, 3, ... A along
    x from where ``make_batch_system`` stacks them."""
    lo, hi = n_mol * SIZE, system.num_mol * SIZE
    return system.replace(coord=system.coord.at[lo:hi, 0].add(jnp.arange(1, hi - lo + 1, dtype=jnp.float32)))


def _jax_parts_step(jcfg, jparams, layout, parts, per_dev, step_fns, spread=False):
    """JAX's step on ``parts`` stacked and sharded over ``make_mesh``'s dp
    axis (``spread``: the indexed parts' padded atoms moved apart):
    metrics, and the gradients it took."""
    ds = JDataset({SIZE: parts[0]})
    make = ds.make_batch_system_packed if layout == "packed" else ds.make_batch_system
    built = [make(SIZE, part, pad_mols=per_dev) for part in parts]
    if spread:
        built = [(_spread(b[0], len(part["numbers"])), b[1]) for b, part in zip(built, parts)]
    batch = j_stack_systems([b[0] for b in built])
    labs = {k: jnp.stack([jnp.asarray(b[1][k]) for b in built]) for k in built[0][1]}
    sh = j_batch_sharding(j_make_mesh(n_dp=len(parts)))
    batch = jax.tree.map(lambda x: jax.device_put(x, sh) if hasattr(x, "ndim") else x, batch)
    labs = jax.tree.map(lambda x: jax.device_put(x, sh), labs)
    opt = capturing(jstep.make_optimizer(learning_rate=LR))
    if layout not in step_fns:
        step_fns[layout] = jax.jit(jstep.make_train_step(jcfg, jloss.MTLoss(jloss.LossConfig()), opt))
    new, metrics = step_fns[layout](jstep.init_train_state(jparams, opt), batch, labs)
    return {k: float(v) for k, v in metrics.items()}, jax_leaves(new.opt_state[1])


def _jax_step(jcfg, jparams, layout, n, step_fns):
    """JAX's step on the split of ``n`` molecules over ``make_mesh(n_dp=2)``
    (as ``Trainer._device_batch`` splits them).  Where an indexed part
    holds padded molecules, JAX's gradient is NaN (ROADMAP.md section 3):
    the loss and its components stay JAX's on its own microbatches, and
    the gradients and ``grad_norm`` are JAX's on the microbatches with the
    padded atoms spread apart, as the port's trainer takes them."""
    sample = _take(_sample(True), n)
    per_dev = int(np.ceil(n / N_DEV))
    parts = [{k: v[d * per_dev : (d + 1) * per_dev] for k, v in sample.items()} for d in range(N_DEV)]
    metrics, grads = _jax_parts_step(jcfg, jparams, layout, parts, per_dev, step_fns)
    if layout == "indexed" and n < N_DEV * per_dev:
        assert not np.isfinite(metrics["grad_norm"])  # JAX's fault, not the port's
        spread, grads = _jax_parts_step(jcfg, jparams, layout, parts, per_dev, step_fns, spread=True)
        assert {k: v for k, v in spread.items() if k != "grad_norm"} == {
            k: v for k, v in metrics.items() if k != "grad_norm"}  # the spread leaves the loss as it was
        metrics["grad_norm"] = spread["grad_norm"]
    return metrics, grads


def _short_last_batch(train):
    """``train`` plus a size group of one molecule (the first five atoms of
    its last molecule, with their labels): a batch that leaves one of the
    two ranks with no molecule."""
    (g,) = train.values()
    return {**train, SIZE_SHORT: {k: (v[-1:, :SIZE_SHORT] if v.ndim > 1 else v[-1:]) for k, v in g.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's tasks and JAX's references, computed side by side."""
    d = tmp_path_factory.mktemp("dp")
    jcfg = _cfg_with_coulomb()
    jparams = j_init(jax.random.key(0), jcfg)
    tcfg, tparams = port_object(jcfg), port_params(jparams)
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(16, 3)).astype(np.float32)
    true = rng.normal(size=(16, 3)).astype(np.float32)
    mask = rng.random(size=(16,)) > 0.25
    train, val = _data()
    tasks = [(("step",) + key, "train_step",
              dict(cfg=tcfg, params=tparams, sample=_take(_sample(True), key[1]), size=SIZE, layout=key[0],
                   with_forces=True, precision=key[2], lr=LR)) for key in STEPS]
    tasks.append(("stats", "stats", dict(pred=pred, true=true, mask=mask)))
    tasks.append(("trainer", "trainer", dict(
        cfg=tcfg, params=tparams, train=train, val=val, loss_cfg=_loss(tloss),
        tcfg=_tcfg(ttrainer.TrainerConfig, d / "t", log_file=str(d / "t.jsonl")))))
    for layout in ("packed", "indexed"):
        tasks.append((("short", layout), "trainer", dict(
            cfg=tcfg, params=tparams, train=_short_last_batch(train), val=val, loss_cfg=_loss(tloss),
            tcfg=dataclasses.replace(_tcfg(ttrainer.TrainerConfig, d / f"short-{layout}"), max_epochs=1,
                                     layout=layout))))
    world = World(N_DEV, tasks)

    step_fns = {}
    steps = {}
    for layout, n in SPLITS:
        if layout == "packed" and n < N_DEV:
            # a part holds no molecule, where JAX's system_molecule_bins
            # raises: JAX's step on the same microbatches, indexed
            steps[layout, n] = steps["indexed", n]
        else:
            steps[layout, n] = _jax_step(jcfg, jparams, layout, n, step_fns)
    jt = jtrainer.Trainer(jcfg, jparams, JDataset(train), JDataset(val), tcfg=_tcfg(jtrainer.TrainerConfig, d / "j"),
                          loss_cfg=_loss(jloss), mesh=j_make_mesh(n_dp=N_DEV))
    fit = jt.fit()
    ranks = world.results()

    def more(trainer, path):
        trainer.resume(path)
        return {**trainer.train_epoch(2), **trainer.validate(), "step": int(trainer.state.step)}

    ckpt = str(d / "t" / "best.npz")
    tt = ttrainer.Trainer(tcfg, tparams, TDataset(train), TDataset(val), tcfg=_tcfg(ttrainer.TrainerConfig, d / "t2"),
                          loss_cfg=_loss(tloss), device="cpu")
    # JAX resumes on its mesh trainer (its step and evaluation compiled):
    # two equal microbatches of whole molecules give the whole batch's loss
    resumed = {"jax": more(jt, ckpt), "port": more(tt, ckpt)}
    return {"ranks": ranks, "steps": steps, "fit": fit, "resumed": resumed, "dir": d,
            "stats_in": (pred, true, mask)}


@pytest.mark.parametrize("layout,n,precision", STEPS, ids=[f"{a}-{n}mol-{p}" for a, n, p in STEPS])
def test_dp_step_matches_jax(runs, layout, n, precision):
    j_metrics, j_grads = runs["steps"][layout, n]
    outs = [r[("step", layout, n, precision)] for r in runs["ranks"]]
    assert [o["index"] for o in outs] == [0, 1]
    per_dev = int(np.ceil(n / N_DEV))
    assert [o["n_mol"] for o in outs] == [per_dev, per_dev]
    for out in outs:
        assert set(out["metrics"]) == set(j_metrics)
        for k, v in j_metrics.items():
            assert out["metrics"][k] == pytest.approx(v, abs=1e-5), k
        assert set(out["grads"]) == set(j_grads)
        for name, got in out["grads"].items():
            want = j_grads[name]
            scale = max(float(np.abs(want).max()), 1e-7)
            np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0, err_msg=name)
    # the averaged gradient and so the update are the same bits on every rank
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        np.testing.assert_array_equal(a, b)
    for name in outs[0]["grads"]:
        np.testing.assert_array_equal(outs[0]["grads"][name], outs[1]["grads"][name])


def test_reduce_stats_match_jax_and_host(runs):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    pred, true, mask = runs["stats_in"]
    mesh = j_make_mesh(n_dp=N_DEV)

    def sharded(p, t, m):
        return jmetrics.reduce_stats({"f": jmetrics.batch_stats(p, t, m)}, "dp")

    fn = jax.jit(shard_map(sharded, mesh=mesh, in_specs=(P("dp"),) * 3, out_specs=P()))
    sh = NamedSharding(mesh, P("dp"))
    js = fn(*(jax.device_put(jnp.asarray(x), sh) for x in (pred, true, mask)))["f"]
    host = jmetrics.RegMultiMetric([jmetrics.MetricConfig("f", "f")])
    host.update({"f": pred}, {"f": true}, weights={"f": mask})
    for out in (r["stats"] for r in runs["ranks"]):
        for k, v in out["stats"].items():
            assert v == pytest.approx(float(js[k]), rel=1e-6), k
            assert v == pytest.approx(host._acc["f"][k], rel=1e-5, abs=1e-5), k
        assert out["compute"] == pytest.approx(host.compute(), rel=1e-12)


def test_dp_trainer_matches_jax(runs):
    hj = runs["fit"]["history"]
    outs = [r["trainer"] for r in runs["ranks"]]
    assert [o["lead"] for o in outs] == [True, False]
    for out in outs:
        ht = out["history"]
        assert len(ht) == len(hj) == 2
        for rt, rj in zip(ht, hj):
            assert rt["epoch"] == rj["epoch"] and rt["lr"] == rj["lr"]
            _same_record(rt, rj)
        assert out["best_val"] == pytest.approx(runs["fit"]["best_val"], rel=1e-5)
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        np.testing.assert_array_equal(a, b)
    # the lead alone writes: one record an epoch in the log
    d = runs["dir"]
    assert len((d / "t.jsonl").read_text().splitlines()) == 2
    assert sorted(p.name for p in (d / "t").iterdir()) == ["best.npz"]


def test_dp_checkpoint_resumes_in_both_packages(runs):
    got, want = runs["resumed"]["port"], runs["resumed"]["jax"]
    assert got["step"] == want["step"] > 0
    _same_record(got, want)


def test_dp_epoch_with_an_empty_rank(runs):
    """The default layout's epoch whose last batch leaves rank 1 with no
    molecule finishes on both ranks, finite and the same bits, and gives
    the indexed layout's record (whose empty microbatch adds a zero loss
    and gradient)."""
    for layout in ("packed", "indexed"):
        outs = [r[("short", layout)] for r in runs["ranks"]]
        assert len(outs[0]["history"]) == 1 and outs[0]["history"] == outs[1]["history"]
        assert all(np.isfinite(v) for v in outs[0]["history"][0].values())
        for a, b in zip(outs[0]["params"], outs[1]["params"]):
            np.testing.assert_array_equal(a, b)
    _same_record(runs["ranks"][0][("short", "packed")]["history"][0],
                 runs["ranks"][0][("short", "indexed")]["history"][0])
