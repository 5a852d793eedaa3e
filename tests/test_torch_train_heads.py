"""Every head leaf the JAX package's train step updates gets its gradient in
the port's on molecule bins (CPU, against the JAX package).

JAX's layout test's model with simple Coulomb plus SRRep, a dispersion
OutputHead, DispParam (a seeded positive ``disp_param0``) and D3TS, the heads
of tests/test_torch_lr_heads.py, random JAX weights carried across: one
force-loss step's gradient, leaf by leaf (SRRep's ``gfn1_ab`` and D3TS's
``r4r2`` through kernel D and E's per-atom operands, ``disp_param0``
through DispParam), within 1e-4 of each leaf's largest |g| of JAX's real
step (read through the optax wrapper of tests/test_torch_train_step.py),
and the loss within 1e-5 relative.  The molecules are JAX's layout test's,
scaled by 0.6 so that SRRep's contacts reach 1.3 A.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.data.sgdataset import SizeGroupedDataset as JDataset  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu.models import modules as jmodules  # noqa: E402
from aimnetcentral_tpu.train import step as jstep  # noqa: E402
from aimnetcentral_tpu.train.loss import LossConfig as JLossConfig  # noqa: E402
from aimnetcentral_tpu.train.loss import MTLoss as JMTLoss  # noqa: E402
from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset as TDataset  # noqa: E402
from aimnetcentral_tpu_torch.train import step as tstep  # noqa: E402
from aimnetcentral_tpu_torch.train.loss import LossConfig as TLossConfig  # noqa: E402
from aimnetcentral_tpu_torch.train.loss import MTLoss as TMTLoss  # noqa: E402
from test_packed_train import _cfg_with_coulomb  # noqa: E402
from test_torch_lr_heads import _disp_table  # noqa: E402
from test_torch_train_step import B, SIZE, _one_torch_thread, _sample, capturing  # noqa: E402, F401
from torch_train_helpers import jax_leaves, port_object, port_params  # noqa: E402

HEAD_LEAVES = ("outputs/srrep/gfn1_ab", "outputs/d3ts/r4r2", "outputs/disp_param/disp_param0")


def test_head_leaves_get_their_gradients():
    cfg = _cfg_with_coulomb()
    jcfg = dataclasses.replace(cfg, outputs=cfg.outputs + (
        ("srrep", jheads.SRRepHead(key_out="energy", rc=4.0)),
        ("disp_raw", jheads.OutputHead(n_in=32, n_out=2, key_in="aim", key_out="disp_param",
                                       mlp=jmodules.MLPSpec(hidden=(16,), last_linear=True))),
        ("disp_param", jheads.DispParamHead()),
        ("d3ts", jheads.D3TSHead(a1=0.49, a2=3.5, s8=0.78)),
    ))
    jparams = j_init(jax.random.key(0), jcfg)
    jparams["outputs"]["disp_param"]["disp_param0"] = jnp.asarray(_disp_table())
    sample = _sample(with_forces=True)
    sample["coord"] = sample["coord"] * 0.6
    jsys, jlab = JDataset({SIZE: sample}).make_batch_system_packed(SIZE, sample, pad_mols=B)
    opt = capturing(jstep.make_optimizer(learning_rate=1e-3))
    step = jstep.make_train_step(jcfg, JMTLoss(JLossConfig()), opt, with_forces=True)
    batch = jax.tree.map(lambda x: x[None] if hasattr(x, "ndim") else x, jsys)
    labs = {k: jnp.asarray(v)[None] for k, v in jlab.items()}
    new, metrics = jax.jit(step)(jstep.init_train_state(jparams, opt), batch, labs)
    j_grads = jax_leaves(new.opt_state[1])

    system, labels = TDataset({SIZE: sample}).make_batch_system_packed(SIZE, sample, pad_mols=B, device="cpu")
    state = tstep.init_train_state(port_params(jparams), tstep.make_optimizer())
    leaves = [leaf for _p, leaf in state.trainable]
    pred = tstep.predict(state.params, port_object(jcfg), system, True, create_graph=True)
    total, _ = TMTLoss(TLossConfig())(pred, labels, system)
    assert float(total.detach()) == pytest.approx(float(metrics["loss"]), rel=1e-5)
    grads = dict(zip([p for p, _leaf in state.trainable], torch.autograd.grad(total, leaves, allow_unused=True)))
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        want = j_grads[name]
        got = np.zeros_like(want) if g is None else g.numpy()
        scale = max(float(np.abs(want).max()), 1e-7)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0, err_msg=name)
    for name in HEAD_LEAVES:
        assert np.abs(j_grads[name]).max() > 0, name
