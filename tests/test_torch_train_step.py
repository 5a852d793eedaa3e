"""The port's train step against the JAX package's (CPU).

- ``make_train_step`` on JAX's test model with simple Coulomb
  (tests/test_packed_train.py::_cfg_with_coulomb), random JAX weights
  carried across by the weights bridge, on molecule bins (the indexed
  layout in tests/test_torch_train_step_indexed.py, which imports this
  module's pieces), with and without forces, at both tiers: loss and components
  within 1e-5 of JAX's step metrics, ``grad_norm`` too; every leaf's
  gradient (the AEV constants ``rc_s``, ``eta_s``, ``shifts_s`` included)
  within 1e-4 of that leaf's largest |g| (floor 1e-7); the parameters after
  one step within 2e-5 (JAX's own layout test's tolerance).  JAX's
  gradients are read from its real step through an optax wrapper that keeps
  them in its state.  On the CPU both packages' tiers give the same numbers,
  so the port's ``fast`` and ``exact`` steps are each held to JAX's.
- the AEV constants' gradient on molecule bins against JAX's XLA engine
  (kernel B's constants' build on the card; here its plain version).

tests/test_torch_train_optim.py holds the optimizer and the constants'
adjoint of ``ConvAcc`` on their own.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from aimnetcentral_tpu.data.sgdataset import SizeGroupedDataset as JDataset  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.train import step as jstep  # noqa: E402
from aimnetcentral_tpu.train.loss import LossConfig as JLossConfig  # noqa: E402
from aimnetcentral_tpu.train.loss import MTLoss as JMTLoss  # noqa: E402
from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset as TDataset  # noqa: E402
from aimnetcentral_tpu_torch.train import step as tstep  # noqa: E402
from aimnetcentral_tpu_torch.train.loss import LossConfig as TLossConfig  # noqa: E402
from aimnetcentral_tpu_torch.train.loss import MTLoss as TMTLoss  # noqa: E402
from test_packed_train import _cfg_with_coulomb  # noqa: E402
from torch_train_helpers import jax_leaves, port_object, port_params  # noqa: E402

CPU = torch.device("cpu")
SIZE, B = 6, 5
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(with_forces: bool, seed: int = 0) -> dict:
    """JAX's layout test's batch (five molecules of six H/C/O atoms), with
    charge labels, and force labels when the step takes forces."""
    rng = np.random.default_rng(seed)
    s = {
        "coord": rng.uniform(-2.5, 2.5, size=(B, SIZE, 3)).astype(np.float32),
        "numbers": rng.choice([1, 6, 8], size=(B, SIZE)),
        "energy": rng.normal(size=B).astype(np.float32),
        "forces": (rng.normal(size=(B, SIZE, 3)) * 0.1).astype(np.float32),
        "charges": (rng.normal(size=(B, SIZE)) * 0.1).astype(np.float32),
        "charge": np.zeros(B, dtype=np.float32),
    }
    if not with_forces:
        del s["forces"]
    return s


def capturing(inner: optax.GradientTransformation) -> optax.GradientTransformation:
    """``inner`` with the gradients of its last update kept in its state."""

    def init(params):
        return inner.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, new = inner.update(grads, state[0], params)
        return updates, (new, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def model():
    jcfg = _cfg_with_coulomb()
    jparams = j_init(jax.random.key(0), jcfg)
    return jcfg, jparams, port_object(jcfg), port_params(jparams)


LAYOUTS = ("packed",)  # test_torch_train_step_indexed.py: ("indexed",)


@pytest.fixture(scope="module")
def jax_steps(model):
    return run_jax_steps(model, LAYOUTS)


def run_jax_steps(model, layouts):
    """JAX's step, once per (layout, forces): metrics, parameters after the
    step and the gradients it took."""
    jcfg, jparams, _tcfg, _tparams = model
    out = {}
    for layout in layouts:
        for with_forces in (True, False):
            sample = _sample(with_forces)
            ds = JDataset({SIZE: sample})
            make = ds.make_batch_system_packed if layout == "packed" else ds.make_batch_system
            system, labels = make(SIZE, sample, pad_mols=B)
            batch = jax.tree.map(lambda x: x[None] if hasattr(x, "ndim") else x, system)
            labs = {k: jnp.asarray(v)[None] for k, v in labels.items()}
            opt = capturing(jstep.make_optimizer(learning_rate=LR))
            step = jstep.make_train_step(jcfg, JMTLoss(JLossConfig()), opt, with_forces=with_forces)
            new, metrics = jax.jit(step)(jstep.init_train_state(jparams, opt), batch, labs)
            out[layout, with_forces] = (
                {k: float(v) for k, v in metrics.items()},
                jax_leaves(new.params),
                jax_leaves(new.opt_state[1]),
            )
    return out


@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("with_forces", [True, False], ids=["forces", "energy"])
def test_train_step_matches_jax(model, jax_steps, with_forces, precision):
    check_step(model, jax_steps, LAYOUTS[0], with_forces, precision)


def check_step(model, jax_steps, layout, with_forces, precision):
    """The port's step on ``layout`` against JAX's (module docstring)."""
    _jcfg, _jparams, tcfg, tparams = model
    j_metrics, j_params, j_grads = jax_steps[layout, with_forces]
    sample = _sample(with_forces)
    ds = TDataset({SIZE: sample})
    make = ds.make_batch_system_packed if layout == "packed" else ds.make_batch_system
    system, labels = make(SIZE, sample, pad_mols=B, device="cpu")
    loss = TMTLoss(TLossConfig())
    opt = tstep.make_optimizer(learning_rate=LR)
    state = tstep.init_train_state(tparams, opt)

    # the gradient the step takes, leaf by leaf
    leaves = [leaf for _p, leaf in state.trainable]
    pred = tstep.predict(state.params, tcfg, system, with_forces, create_graph=True)
    grads = torch.autograd.grad(loss(pred, labels, system)[0], leaves, allow_unused=True)
    names = [p for p, _leaf in state.trainable]
    assert {"aev/rc_s", "aev/eta_s", "aev/shifts_s"} <= set(names)
    for name, g in zip(names, grads):
        want = j_grads[name]
        got = np.zeros_like(want) if g is None else g.numpy()
        scale = max(float(np.abs(want).max()), 1e-7)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0, err_msg=name)
        if name.startswith("aev/"):
            assert np.abs(want).max() > 0, name  # the XLA engine trains them

    step = tstep.make_train_step(tcfg, loss, opt, with_forces=with_forces, precision=precision)
    state, metrics = step(state, system, labels)
    assert state.step == 1
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        assert float(metrics[k]) == pytest.approx(v, abs=1e-5), k
    for name, leaf in tstep.tree_leaves(state.params):
        np.testing.assert_allclose(leaf.detach().numpy(), j_params[name], atol=2e-5, rtol=0, err_msg=name)


def test_train_step_refuses_balanced(model):
    _jcfg, _jparams, tcfg, _tparams = model
    with pytest.raises(ValueError, match="precision"):
        tstep.make_train_step(tcfg, TMTLoss(TLossConfig()), tstep.make_optimizer(), precision="balanced")
