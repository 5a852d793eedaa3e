"""The port's ``train``, ``export`` and ``calc-sae`` commands against the JAX
package's (CPU, click's test runner, ``--device cpu``).

- JAX's ``test_cli_train_multi_config_and_dotted_overrides`` and
  ``test_cli_calc_sae_journey`` (tests/test_cli.py) on the port: two
  ``--config`` files merged in order, dotted overrides applied last, two
  epochs on an npz-directory dataset, the exported artifact serving ``sp``;
  the SAE regression's YAML equal to JAX's;
- ``train --load`` of a checkpoint written by JAX's ``train``: the port
  resumes it in full and reaches JAX's ``best_val`` (1e-5 relative);
- ``export`` of that checkpoint: the port's artifact in the port's
  ``AIMNet2Calculator`` gives the energies of JAX's artifact in JAX's
  calculator (1e-5 eV).
"""

import json
import os

import numpy as np
import pytest
import yaml

pytest.importorskip("jax")  # the card's machine has no JAX
from click.testing import CliRunner  # noqa: E402

from aimnetcentral_tpu import cli as jcli  # noqa: E402
from aimnetcentral_tpu.calculators import AIMNet2Calculator as JCalculator  # noqa: E402
from aimnetcentral_tpu_torch import cli as tcli  # noqa: E402
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator  # noqa: E402

MODEL_TREE = {
    "class": "aimnet.models.AIMNet2",
    "kwargs": {
        "nfeature": 4, "d2features": True, "ncomb_v": 4,
        "hidden": [[16], [16], [16]], "aim_size": 16,
        "aev": {"rc_s": 5.0, "nshifts_s": 8},
        "outputs": {
            "energy_mlp": {"class": "aimnet.modules.Output",
                           "kwargs": {"n_in": 16, "n_out": 1, "key_in": "aim", "key_out": "energy",
                                      "mlp": {"hidden": [8], "last_linear": True}}},
            "atomic_shift": {"class": "aimnet.modules.AtomicShift",
                             "kwargs": {"key_in": "energy", "key_out": "energy"}},
            "atomic_sum": {"class": "aimnet.modules.AtomicSum",
                           "kwargs": {"key_in": "energy", "key_out": "energy"}},
        },
    },
}


def _run(pkg, args):
    if pkg == "jax":
        r = CliRunner().invoke(jcli.cli, args)
    else:
        r = CliRunner().invoke(tcli.cli, ["--device", "cpu", *args])
    assert r.exit_code == 0, (pkg, args, r.output, r.exception)
    return r.output


def _dataset(ddir, size=6, n=16, seed=0):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(-2.5, 2.5, size=(n, size, 3)).astype(np.float32)
    numbers = rng.choice([1, 8], size=(n, size))
    energy = coord.sum((1, 2)).astype(np.float32) * 0.01
    ddir.mkdir()
    np.savez(ddir / f"{size:03d}.npz", coord=coord, numbers=numbers, energy=energy, charge=np.zeros(n, np.float32))


def _base(train_dir="WRONG-overridden-below", **trainer):
    return {
        "model": MODEL_TREE,
        "data": {"train": train_dir, "sae": False},
        "trainer": {"max_epochs": 99, "batch_size": 8, "with_forces": False, **trainer},
        "loss": {"terms": [{"kind": "energy", "key_pred": "energy", "key_true": "energy", "weight": 1.0}]},
    }


def test_cli_train_multi_config_and_dotted_overrides(tmp_path):
    """JAX's journey on the port: extra.yaml's max_epochs wins over
    base.yaml's, the dotted overrides set the data and the export."""
    ddir = tmp_path / "data"
    _dataset(ddir)
    p_base, p_extra = tmp_path / "base.yaml", tmp_path / "extra.yaml"
    p_base.write_text(yaml.safe_dump(_base(), sort_keys=False))
    p_extra.write_text(yaml.safe_dump({"trainer": {"max_epochs": 2}}, sort_keys=False))
    exported = str(tmp_path / "trained.pt")
    out = _run("torch", ["train", "--config", str(p_base), "--config", str(p_extra),
                         f"data.train={ddir}", f"export={exported}"])
    res = json.loads(out.strip().splitlines()[-2])
    assert res["epochs"] == 2
    assert np.isfinite(res["best_val"])
    assert os.path.exists(exported)
    xyz = tmp_path / "mol.xyz"
    xyz.write_text("2\n\nO 0 0 0\nH 0 0 0.97\n")
    sp_out = _run("torch", ["sp", exported, str(xyz)])
    assert np.isfinite(float(sp_out.split("energy (eV):")[1].split()[0]))
    with pytest.raises(tcli.UsageError, match="KEY.PATH"):
        tcli._apply_dotted_overrides({}, ("no-equals-sign",))


def test_cli_calc_sae_journey(tmp_path):
    rng = np.random.default_rng(1)
    size, n = 4, 32
    ddir = tmp_path / "data"
    ddir.mkdir()
    numbers = rng.choice([1, 8], size=(n, size))
    true_sae = {1: -13.6, 8: -2042.6}
    energy = np.array([sum(true_sae[int(z)] for z in row) for row in numbers], dtype=np.float32) + rng.normal(
        scale=1e-3, size=n
    ).astype(np.float32)
    np.savez(ddir / f"{size:03d}.npz", coord=rng.uniform(-2, 2, size=(n, size, 3)).astype(np.float32),
             numbers=numbers, energy=energy, charge=np.zeros(n, np.float32))
    outs = {}
    for pkg in ("jax", "torch"):
        path = str(tmp_path / f"sae-{pkg}.yaml")
        printed = _run(pkg, ["calc-sae", str(ddir), path])
        assert printed.strip() == f"wrote SAE for 2 elements to {path}"
        outs[pkg] = yaml.safe_load(open(path))
    assert outs["torch"] == outs["jax"]
    assert abs(outs["torch"][1] - true_sae[1]) < 0.1 and abs(outs["torch"][8] - true_sae[8]) < 0.1


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """One epoch of JAX's ``train`` writing its best checkpoint."""
    d = tmp_path_factory.mktemp("load")
    _dataset(d / "data", n=16, seed=3)
    cfg = _base(str(d / "data"), max_epochs=1, checkpoint_dir=str(d / "jax-ckpt"))
    (d / "first.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    _run("jax", ["train", "--config", str(d / "first.yaml")])
    (d / "model.yaml").write_text(yaml.safe_dump(MODEL_TREE, sort_keys=False))
    return d, str(d / "jax-ckpt" / "best.npz")


def test_cli_train_load_resumes_a_jax_checkpoint(jax_checkpoint):
    d, ckpt = jax_checkpoint
    best = {}
    for pkg in ("jax", "torch"):
        cfg = _base(str(d / "data"), max_epochs=2, checkpoint_dir=str(d / f"{pkg}-more"))
        (d / f"more-{pkg}.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
        out = _run(pkg, ["train", "--config", str(d / f"more-{pkg}.yaml"), "--load", ckpt])
        best[pkg] = json.loads(out.strip().splitlines()[-1])
    assert best["torch"]["epochs"] == best["jax"]["epochs"] == 2
    with np.load(ckpt) as z:
        assert best["jax"]["best_val"] < float(z["__sched_best_val__"])  # the resumed run improved on it
    assert best["torch"]["best_val"] == pytest.approx(best["jax"]["best_val"], rel=1e-5)


def test_cli_export_of_a_jax_checkpoint(jax_checkpoint, tmp_path):
    d, ckpt = jax_checkpoint
    sae = tmp_path / "sae.yaml"
    sae.write_text(yaml.safe_dump({1: -13.6, 8: -2042.6}))
    paths = {}
    for pkg in ("jax", "torch"):
        paths[pkg] = str(tmp_path / f"{pkg}.pt")
        printed = _run(pkg, ["export", ckpt, "--model-yaml", str(d / "model.yaml"), "--output", paths[pkg],
                             "--sae", str(sae), "--species", "1,8"])
        assert printed.strip() == f"exported {paths[pkg]}"
    rng = np.random.default_rng(5)
    mols = [{"coord": rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32),
             "numbers": rng.choice([1, 8], size=n)} for n in (3, 5)]
    want = JCalculator(paths["jax"])(mols, forces=True)
    got = TCalculator(paths["torch"], device="cpu")(mols, forces=True)
    np.testing.assert_allclose(got["energy"], np.asarray(want["energy"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["forces"], np.asarray(want["forces"]), atol=1e-5, rtol=0)
