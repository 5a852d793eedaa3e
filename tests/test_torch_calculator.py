"""The port's AIMNet2Calculator against the JAX package's (CPU).

A narrow model (nfeature=4, ncomb_v=4, hidden (32, 16), aim_size=16, the
four flagship heads) with JAX parameters carried across by the weights
bridge, on a 60-atom 12 A periodic box through the binned engine.
Tolerances: energy 1e-5 relative, charges 1e-5, forces 1e-5 eV/A, stress
1e-6 eV/A^3."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator
from aimnetcentral_tpu.models import AIMNet2Config as JConfig
from aimnetcentral_tpu.models import aimnet2_init as j_init
from aimnetcentral_tpu.models import heads as jheads
from aimnetcentral_tpu.models import modules as jmodules
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator
from aimnetcentral_tpu_torch.models import AIMNet2Config as TConfig
from aimnetcentral_tpu_torch.models import aimnet2_init as t_init
from aimnetcentral_tpu_torch.models import heads as theads
from aimnetcentral_tpu_torch.models import modules as tmodules
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy

NARROW = dict(nfeature=4, ncomb_v=4, hidden=((32, 16), (32, 16), (32, 16)), aim_size=16)


def _config(cfg_cls, heads, modules):
    outputs = (
        (
            "energy_mlp",
            heads.OutputHead(
                n_in=16, n_out=1, key_in="aim", key_out="energy",
                mlp=modules.MLPSpec(hidden=(16, 16), last_linear=True),
            ),
        ),
        ("atomic_shift", heads.AtomicShiftHead(key_in="energy", key_out="energy")),
        ("atomic_sum", heads.AtomicSumHead(key_in="energy", key_out="energy")),
        ("lrcoulomb", heads.LRCoulombHead(rc=4.6, key_in="charges", key_out="energy")),
    )
    return cfg_cls(outputs=outputs, **NARROW)


def _box(n=60, a=12.0, seed=0):
    """Jittered lattice (minimum separation), CHNO, some atoms outside the cell."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)[:n]
    coord = (grid + 0.5) * (a / m) + rng.uniform(-0.15, 0.15, size=(n, 3)) * (a / m)
    coord[: n // 6] += a  # periodic images of some atoms
    numbers = rng.choice([1, 6, 7, 8], size=n, p=[0.5, 0.35, 0.05, 0.1])
    return {"coord": coord.astype(np.float32), "numbers": numbers, "cell": np.eye(3, dtype=np.float32) * a}


@pytest.fixture(scope="module")
def models():
    jcfg = _config(JConfig, jheads, jmodules)
    tcfg = _config(TConfig, theads, tmodules)
    jparams = j_init(jax.random.key(0), jcfg)
    # non-zero SAE so the host float64 shift is exercised
    sae = {"atomic_shift": np.linspace(-10.0, -1.0, 64)}
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jparams, jcfg, {"sae": sae}), (tparams, tcfg, {"sae": sae})


@pytest.fixture(scope="module")
def results(models):
    jmodel, tmodel = models
    data = _box()
    ref = JCalculator(jmodel, binned_threshold=0).eval(data, forces=True, stress=True)
    got = TCalculator(tmodel, device="cpu", binned_threshold=0).eval(data, forces=True, stress=True)
    return got, ref


def test_energy_matches(results):
    got, ref = results
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)


def test_charges_match(results):
    got, ref = results
    np.testing.assert_allclose(got["charges"], ref["charges"], atol=1e-5)


def test_forces_match(results):
    got, ref = results
    np.testing.assert_allclose(got["forces"], ref["forces"], atol=1e-5)
    assert np.abs(got["forces"].sum(0)).max() < 1e-4  # translation invariance


def test_stress_matches(results):
    got, ref = results
    np.testing.assert_allclose(got["stress"], ref["stress"], atol=1e-6)


def test_energy_only_matches_forces_call(models, results):
    _jmodel, tmodel = models
    got, _ref = results
    plain = TCalculator(tmodel, device="cpu", binned_threshold=0).eval(_box())
    np.testing.assert_allclose(plain["energy"], got["energy"], rtol=1e-6)
    assert "forces" not in plain


def test_init_builds_the_same_tree(models):
    """The port's own init draws other numbers but the same structure."""
    jmodel, tmodel = models
    mine = t_init(tmodel[1], seed=0, device="cpu")
    ref = tmodel[0]
    assert jax.tree.structure(jax.tree.map(lambda x: 0, mine)) == jax.tree.structure(
        jax.tree.map(lambda x: 0, ref)
    )
    assert [tuple(x.shape) for x in jax.tree.leaves(mine)] == [
        tuple(x.shape) for x in jax.tree.leaves(ref)
    ]


@pytest.mark.parametrize("precision", ["fast", "balanced"])
def test_unported_tiers_raise(models, precision):
    with pytest.raises(NotImplementedError):
        TCalculator(models[1], device="cpu", precision=precision)


def test_unported_inputs_raise(models):
    calc = TCalculator(models[1], device="cpu", binned_threshold=0)
    gas = {k: v for k, v in _box().items() if k != "cell"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        calc.eval(gas, forces=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        calc.eval(_box(), hessian=True)
    small = TCalculator(models[1], device="cpu")  # 60 atoms < binned_threshold 1024
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        small.eval(_box())


def test_no_card_raises_unless_cpu_asked(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TCalculator(models[1])
