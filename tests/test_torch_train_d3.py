"""Training a model with the DFT-D3 head: the port holds the head's
reference tables constant (CPU, against the JAX package).

JAX's layout test's model with simple Coulomb plus the wB97M-D3 head
(``DFTD3Head(s8=0.3908, a1=0.566, a2=3.128)``), random JAX weights carried
across, one force-loss step on molecule bins:

- JAX's own step (its energy-loss step: the cheaper compile shows the same
  NaN): its gradient with respect to ``r4r2`` is NaN (0 x inf where a real
  atom pairs with padding, ROADMAP.md section 3), so its ``grad_norm``
  and every parameter after the step are NaN;
- the port's step is finite, leaves ``rcov``, ``r4r2``, ``c6ab`` and
  ``cn_ref`` bit for bit as they were (``train/step.py::is_trainable``),
  and every other leaf's gradient is within 1e-4 of that leaf's largest |g|
  of JAX's gradient taken with the four tables closed over as constants;
  the loss within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.data.sgdataset import SizeGroupedDataset as JDataset  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_apply as j_apply  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models.heads import DFTD3Head  # noqa: E402
from aimnetcentral_tpu.train import step as jstep  # noqa: E402
from aimnetcentral_tpu.train.loss import LossConfig as JLossConfig  # noqa: E402
from aimnetcentral_tpu.train.loss import MTLoss as JMTLoss  # noqa: E402
from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset as TDataset  # noqa: E402
from aimnetcentral_tpu_torch.train import step as tstep  # noqa: E402
from aimnetcentral_tpu_torch.train.loss import LossConfig as TLossConfig  # noqa: E402
from aimnetcentral_tpu_torch.train.loss import MTLoss as TMTLoss  # noqa: E402
from test_packed_train import _cfg_with_coulomb  # noqa: E402
from test_torch_train_step import B, SIZE, _one_torch_thread, _sample, capturing  # noqa: E402, F401
from torch_train_helpers import jax_leaves, port_object, port_params  # noqa: E402

TABLES = tuple(f"outputs/external_dftd3/{k}" for k in tstep.D3_TABLES)


@pytest.fixture(scope="module")
def d3():
    cfg = _cfg_with_coulomb()
    jcfg = dataclasses.replace(
        cfg, outputs=cfg.outputs + (("external_dftd3", DFTD3Head(s8=0.3908, a1=0.566, a2=3.128)),)
    )
    jparams = j_init(jax.random.key(0), jcfg)
    sample = _sample(with_forces=True)
    jsys, jlab = JDataset({SIZE: sample}).make_batch_system_packed(SIZE, sample, pad_mols=B)
    loss = JMTLoss(JLossConfig())

    # JAX's own step, its gradient kept
    opt = capturing(jstep.make_optimizer(learning_rate=1e-3))
    step = jstep.make_train_step(jcfg, loss, opt, with_forces=False)
    batch = jax.tree.map(lambda x: x[None] if hasattr(x, "ndim") else x, jsys)
    labs = {k: jnp.asarray(v)[None] for k, v in jlab.items() if k != "forces"}
    new, metrics = jax.jit(step)(jstep.init_train_state(jparams, opt), batch, labs)

    # JAX's gradient with the tables closed over as constants
    tables = {k: jparams["outputs"]["external_dftd3"][k] for k in tstep.D3_TABLES}

    def loss_fn(params):
        params = {**params, "outputs": {**params["outputs"], "external_dftd3": tables}}

        def e_of(coord):
            out = j_apply(params, jcfg, jsys.replace(coord=coord), sae_external=False, conv_engine="xla")
            return out["energy"].sum(), out

        (_, out), g = jax.value_and_grad(e_of, has_aux=True)(jsys.coord)
        return loss({**out, "forces": -g}, {k: jnp.asarray(v) for k, v in jlab.items()}, jsys)[0]

    trainable = {**jparams, "outputs": {k: v for k, v in jparams["outputs"].items() if k != "external_dftd3"}}
    total, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    return {
        "cfg": port_object(jcfg), "params": port_params(jparams), "sample": sample,
        "step_metrics": {k: float(v) for k, v in metrics.items()}, "step_grads": jax_leaves(new.opt_state[1]),
        "step_params": jax_leaves(new.params), "loss": float(total), "grads": jax_leaves(grads),
    }


def test_jax_step_turns_nan(d3):
    """The reference's NaN, which the port's definition avoids."""
    r4r2 = d3["step_grads"]["outputs/external_dftd3/r4r2"]
    assert np.isnan(r4r2[[1, 6, 8]]).all()
    assert np.isnan(d3["step_metrics"]["grad_norm"])
    assert all(np.isnan(p).all() for p in d3["step_params"].values() if p.dtype.kind == "f")


def test_port_step_holds_the_d3_tables(d3):
    params = d3["params"]
    state = tstep.init_train_state(params, tstep.make_optimizer(learning_rate=1e-3))
    names = [p for p, _leaf in state.trainable]
    assert not set(TABLES) & set(names)
    assert "outputs/atomic_shift/weight" in names and "aev/rc_s" in names
    sample = d3["sample"]
    system, labels = TDataset({SIZE: sample}).make_batch_system_packed(SIZE, sample, pad_mols=B, device="cpu")
    loss = TMTLoss(TLossConfig())
    leaves = [leaf for _p, leaf in state.trainable]
    pred = tstep.predict(state.params, d3["cfg"], system, True, create_graph=True)
    total, _ = loss(pred, labels, system)
    assert float(total.detach()) == pytest.approx(d3["loss"], abs=1e-5)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    checked = 0
    for name, g in zip(names, grads):
        want = d3["grads"][name]
        got = np.zeros_like(want) if g is None else g.numpy()
        assert np.isfinite(got).all(), name
        scale = max(float(np.abs(want).max()), 1e-7)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0, err_msg=name)
        checked += float(np.abs(want).max()) > 0
    assert checked >= 10

    before = {p: x.clone() for p, x in tstep.tree_leaves(state.params) if p in TABLES}
    step = tstep.make_train_step(d3["cfg"], loss, tstep.make_optimizer(learning_rate=1e-3), precision="exact")
    state, metrics = step(state, system, labels)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = dict(tstep.tree_leaves(state.params))
    for p in TABLES:
        assert torch.equal(after[p], before[p]), p
    assert all(torch.isfinite(x).all() for _p, x in tstep.tree_leaves(state.params))
