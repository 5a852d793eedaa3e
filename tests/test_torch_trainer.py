"""The port's Trainer, checkpoints, metrics and trackers against the JAX
package's (CPU).

- ``Trainer.fit`` for two epochs on molecule bins with JAX's layout test's
  model (simple Coulomb), random JAX weights carried across, on a
  synthetic dataset of JAX's tests (one size group, with force and charge
  labels), an energy and charge loss (the force loss's step is held to
  JAX's in tests/test_torch_train_step.py; validation takes the forces
  either way): every history record (``train_loss``, ``val_loss`` and
  the MAE / RMSE / R^2 of energy, forces and charges; R^2 as 1 - R^2)
  within 1e-5 relative of JAX's;
- checkpoints cross between the packages: JAX's best checkpoint resumed by
  the port and the port's by JAX, each then training one more epoch as the
  package that wrote it does (the same record within 1e-5 relative);
  the npz keys and the optimizer leaves' shapes and dtypes are JAX's;
- the plateau scheduler and TerminateOnLowLR driven by fixed scores in both
  packages (the learning rate, the patience counter, the best score);
- ``RegMultiMetric`` and ``batch_stats``, and the trackers, against JAX's.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.data.sgdataset import SizeGroupedDataset as JDataset  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.train import loss as jloss  # noqa: E402
from aimnetcentral_tpu.train import metrics as jmetrics  # noqa: E402
from aimnetcentral_tpu.train import trackers as jtrackers  # noqa: E402
from aimnetcentral_tpu.train import trainer as jtrainer  # noqa: E402
from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset as TDataset  # noqa: E402
from aimnetcentral_tpu_torch.train import loss as tloss  # noqa: E402
from aimnetcentral_tpu_torch.train import metrics as tmetrics  # noqa: E402
from aimnetcentral_tpu_torch.train import trackers as ttrackers  # noqa: E402
from aimnetcentral_tpu_torch.train import trainer as ttrainer  # noqa: E402
from test_packed_train import _cfg_with_coulomb  # noqa: E402
from test_torch_train_step import _one_torch_thread  # noqa: E402, F401  (a fixture)
from test_train import _synthetic_ds  # noqa: E402
from torch_train_helpers import port_object, port_params  # noqa: E402

KEYS = ("train_loss", "val_loss", "energy_mae", "energy_rmse", "energy_r2", "forces_mae", "forces_rmse",
        "forces_r2", "charges_mae", "charges_rmse", "charges_r2")


def _data():
    """Twelve training and six validation molecules of six atoms, with
    energy, force and charge labels."""
    ds = _synthetic_ds(np.random.default_rng(0), sizes=(6,), n_per=18)
    g = ds[6]
    rng = np.random.default_rng(1)
    g["forces"] = (rng.normal(size=(18, 6, 3)) * 0.3).astype(np.float32)
    g["charges"] = (rng.normal(size=(18, 6)) * 0.1).astype(np.float32)
    g["coord"] = (g["coord"] * 0.8).astype(np.float32)
    train = {6: {k: v[:12] for k, v in g.items()}}
    val = {6: {k: v[12:] for k, v in g.items()}}
    return train, val


def _tcfg(cls, ckpt_dir, **kw):
    return cls(max_epochs=2, batch_size=6, learning_rate=1e-3, checkpoint_dir=str(ckpt_dir), with_forces=False, **kw)


def _loss(mod):
    return mod.LossConfig(terms=(mod.LossTerm(kind="energy", key_pred="energy", key_true="energy"),
                                 mod.LossTerm(kind="peratom", key_pred="charges", key_true="charges", weight=0.05)))


def _same_record(got, want, rel=1e-5):
    """Each key within ``rel`` of JAX's; R^2 as 1 - R^2 (the squared error
    over the labels' variance), since R^2 itself passes through zero on
    random weights, where a relative limit on it measures nothing."""
    for k in KEYS:
        if k.endswith("_r2"):
            assert 1 - got[k] == pytest.approx(1 - want[k], rel=rel), k
        else:
            assert got[k] == pytest.approx(want[k], rel=rel), k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two epochs of ``fit`` in each package, then each resuming the other's
    best checkpoint and its own for one more epoch."""
    d = tmp_path_factory.mktemp("trainer")
    jcfg = _cfg_with_coulomb()
    jparams = j_init(jax.random.key(0), jcfg)
    train, val = _data()
    jt = jtrainer.Trainer(jcfg, jparams, JDataset(train), JDataset(val), tcfg=_tcfg(jtrainer.TrainerConfig, d / "j"),
                          loss_cfg=_loss(jloss))
    tt = ttrainer.Trainer(port_object(jcfg), port_params(jparams), TDataset(train), TDataset(val),
                          tcfg=_tcfg(ttrainer.TrainerConfig, d / "t"), loss_cfg=_loss(tloss), device="cpu")
    out = {"jax": jt.fit(), "port": tt.fit(), "dir": d}

    def more(trainer, path):
        trainer.resume(path)
        step = int(trainer.state.step)
        return {**trainer.train_epoch(2), **trainer.validate(), "step": step}

    t2 = ttrainer.Trainer(port_object(jcfg), port_params(jparams), TDataset(train), TDataset(val),
                          tcfg=_tcfg(ttrainer.TrainerConfig, d / "t2"), loss_cfg=_loss(tloss), device="cpu")
    out["port from jax"] = more(t2, str(d / "j" / "best.npz"))
    out["jax from jax"] = more(jt, str(d / "j" / "best.npz"))
    out["jax from port"] = more(jt, str(d / "t" / "best.npz"))
    out["port from port"] = more(tt, str(d / "t" / "best.npz"))
    return out


def test_fit_history_matches_jax(runs):
    hj, ht = runs["jax"]["history"], runs["port"]["history"]
    assert len(hj) == len(ht) == 2
    for rj, rt in zip(hj, ht):
        assert rt["epoch"] == rj["epoch"] and rt["lr"] == rj["lr"]
        _same_record(rt, rj)
    assert ht[1]["train_loss"] < ht[0]["train_loss"]
    assert runs["port"]["best_val"] == pytest.approx(runs["jax"]["best_val"], rel=1e-5)


def test_checkpoints_cross_between_packages(runs):
    for got, want in (("port from jax", "jax from jax"), ("jax from port", "port from port")):
        assert runs[got]["step"] == runs[want]["step"] > 0
        _same_record(runs[got], runs[want])
    with np.load(runs["dir"] / "j" / "best.npz") as zj, np.load(runs["dir"] / "t" / "best.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k


@pytest.mark.parametrize("scores", [[1.0, 2.0, 3.0, 0.5, 4.0], [3.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
def test_plateau_scheduler_and_low_lr_stop_match_jax(scores, tmp_path, monkeypatch):
    """Fixed validation scores drive both packages' schedulers (no step
    runs): the same learning rates by epoch, best score and early stop."""
    jcfg = _cfg_with_coulomb()
    jparams = j_init(jax.random.key(0), jcfg)
    train, val = _data()
    kw = dict(max_epochs=len(scores), batch_size=6, lr_patience=1, lr_factor=0.5, terminate_low_lr=2e-4)
    jt = jtrainer.Trainer(jcfg, jparams, JDataset(train), JDataset(val), tcfg=jtrainer.TrainerConfig(**kw))
    tt = ttrainer.Trainer(port_object(jcfg), port_params(jparams), TDataset(train), TDataset(val),
                          tcfg=ttrainer.TrainerConfig(**kw), device="cpu")
    hist = {}
    for name, trainer in (("jax", jt), ("port", tt)):
        it = iter(scores)
        monkeypatch.setattr(trainer, "train_epoch", lambda epoch: {"train_loss": 0.0})
        monkeypatch.setattr(trainer, "validate", lambda: {"val_loss": next(it)})
        out = trainer.fit()
        hist[name] = ([(r["epoch"], r["lr"]) for r in out["history"]], out["best_val"], trainer._plateau)
    assert hist["port"] == hist["jax"]
    assert len(hist["port"][0]) < len(scores) or scores[0] == 1.0


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    configs = [("energy", False), ("forces", True), ("charges", True)]
    jm = jmetrics.RegMultiMetric([jmetrics.MetricConfig(k, k, peratom=p) for k, p in configs])
    tm = tmetrics.RegMultiMetric([tmetrics.MetricConfig(k, k, peratom=p) for k, p in configs])
    for _ in range(3):
        true = {"energy": rng.normal(size=7), "forces": rng.normal(size=(20, 3)), "charges": rng.normal(size=20)}
        pred = {k: v + rng.normal(size=v.shape) * 0.1 for k, v in true.items()}
        mask = {"forces": rng.random(20) > 0.2, "charges": rng.random(20) > 0.2}
        jm.update(pred, true, weights=mask)
        tm.update(pred, true, weights=mask)
    assert tm.compute() == pytest.approx(jm.compute(), rel=1e-12)
    # device-side contributions merged on the host
    p, t, m = rng.normal(size=(10, 3)), rng.normal(size=(10, 3)), rng.random(10) > 0.3
    js = jmetrics.batch_stats(jax.numpy.asarray(p), jax.numpy.asarray(t), jax.numpy.asarray(m))
    ts = tmetrics.batch_stats(torch.tensor(p), torch.tensor(t), torch.tensor(m))
    for k in js:
        assert float(ts[k]) == pytest.approx(float(js[k]), rel=1e-6), k
    jm2 = jmetrics.RegMultiMetric([jmetrics.MetricConfig("forces", "forces")])
    tm2 = tmetrics.RegMultiMetric([tmetrics.MetricConfig("forces", "forces")])
    jm2.update_from_stats({"forces": js})
    tm2.update_from_stats({"forces": ts})
    assert tm2.compute() == pytest.approx(jm2.compute(), rel=1e-6)


def test_trackers_match_jax(tmp_path):
    config = {"lr": 1e-3, "layout": "packed"}
    for mod, name in ((jtrackers, "j.jsonl"), (ttrackers, "t.jsonl")):
        tr = mod.make_tracker("jsonl", path=str(tmp_path / name), config=config)
        tr.log({"epoch": 0, "train_loss": 0.5}, step=0)
        tr.log({"epoch": 1, "train_loss": 0.25})
        tr.finish()
        assert mod.make_tracker(None) is None
        with pytest.raises(ValueError, match="path"):
            mod.make_tracker("jsonl")
        with pytest.raises(ValueError, match="unknown"):
            mod.make_tracker("csv", path="x")
        with pytest.raises(RuntimeError, match="wandb"):
            mod.make_tracker("wandb")
    lines = [(tmp_path / n).read_text().splitlines() for n in ("j.jsonl", "t.jsonl")]
    assert [json.loads(x) for x in lines[1]] == [json.loads(x) for x in lines[0]]
    assert ttrackers.DEFAULT_PROJECT == "aimnet2-torch"
