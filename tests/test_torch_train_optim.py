"""The port's optimizer and the AEV constants' adjoint of the conv pass (CPU).

- ``train/step.py::make_optimizer`` (``torch.optim.Adam`` behind the
  hand-written global-norm clip) against the JAX package's optax chain on
  the same numpy gradients over three updates: the clip active and
  inactive, weight decay, parameter groups; the optimizer state leaves in
  the JAX checkpoint's order (``trainer._opt_leaves``);
- ``ConvAcc``'s adjoints of the AEV constants (shifts, eta, rc), first and
  second order, against autograd of ``conv_forward_plain``: the plain
  version of kernel B's constants' build, which the card holds the kernel
  to (tests/test_torch_gpu.py, chip_smoke.py phase ``train``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.train import step as jstep  # noqa: E402
from aimnetcentral_tpu_torch.builders import system_molecule_bins  # noqa: E402
from aimnetcentral_tpu_torch.kernels import conv_pass as cp  # noqa: E402
from aimnetcentral_tpu_torch.kernels import conv_stencil as cs  # noqa: E402
from aimnetcentral_tpu_torch.kernels.conv_pass import build_conv_tables  # noqa: E402
from aimnetcentral_tpu_torch.ops import binned as tB  # noqa: E402
from aimnetcentral_tpu_torch.train import step as tstep  # noqa: E402
from aimnetcentral_tpu_torch.train.trainer import _opt_leaves  # noqa: E402
from test_packed_train import _cfg_with_coulomb  # noqa: E402
from torch_train_helpers import jax_leaves, one_torch_thread, port_params  # noqa: E402, F401  (a fixture)

CPU = torch.device("cpu")
LR = 1e-3


@pytest.fixture(scope="module")
def model():
    """The JAX layout test's model with every parameter zero, in both
    packages' trees."""
    jparams = jax.tree.map(jnp.zeros_like, j_init(jax.random.key(0), _cfg_with_coulomb()))
    return jparams, port_params(jparams)


OPT_CASES = {
    "clipped": dict(scale=1.0, kw={}),
    "unclipped": dict(scale=1e-3, kw={}),
    "weight_decay": dict(scale=1.0, kw=dict(weight_decay=1e-2)),
    "groups": dict(scale=1.0, kw=dict(param_group_lr={"atomic_shift": 0.1, "mlps/1": 3.0})),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(model, case):
    """Three updates on the same numpy gradients from zero parameters (so
    the parameters are the updates' sums, far below one float32 rounding of
    the model's weights): parameters within 1e-7, the learning rate, and
    the optimizer state (JAX's checkpoint leaves) within 1e-6 of each
    value."""
    jparams, tparams = model
    spec = OPT_CASES[case]
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda x: (rng.normal(size=x.shape) * spec["scale"]).astype(np.float32), jparams)
             for _ in range(3)]
    jopt = jstep.make_optimizer(learning_rate=LR, **spec["kw"])
    jp, js = jparams, jopt.init(jparams)
    update = jax.jit(jopt.update)
    topt = tstep.make_optimizer(learning_rate=LR, **spec["kw"])
    state = tstep.init_train_state(tparams, topt)
    leaves = [leaf for _p, leaf in state.trainable]
    norms = []
    for g in grads:
        updates, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [torch.as_tensor(jax_leaves(g)[p]) for p, _leaf in state.trainable]
        with torch.no_grad():
            norms.append(float(topt.apply(state.opt_state, leaves, tg)))
    assert (max(norms) > 0.4) == (case != "unclipped")
    want = jax_leaves(jp)
    for name, leaf in tstep.tree_leaves(state.params):
        np.testing.assert_allclose(leaf.detach().numpy(), want[name], atol=1e-7, rtol=0, err_msg=name)
    assert tstep.get_learning_rate(state.opt_state) == pytest.approx(jstep.get_learning_rate(js), rel=1e-7)
    got = _opt_leaves(state)
    ref = [np.asarray(x) for x in jax.tree.leaves(js)]
    assert len(got) == len(ref)
    for i, (x, y) in enumerate(zip(got, ref)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_allclose(x, y, atol=1e-7, rtol=1e-6, err_msg=f"o{i}")


def test_learning_rate_setters():
    opt = tstep.make_optimizer(learning_rate=1e-3, param_group_lr={"b": 0.5})
    a, b = torch.zeros(2, requires_grad=True), torch.zeros(3, requires_grad=True)
    adam = opt.init([("a", a), ("b", b)])
    assert tstep.get_learning_rate(adam) == pytest.approx(1e-3)
    tstep.set_learning_rate(adam, 5e-4)
    assert tstep.get_learning_rate(adam) == pytest.approx(5e-4)
    assert sorted(g["lr"] for g in adam.param_groups) == pytest.approx([2.5e-4, 5e-4])


def _conv_operands(seed: int = 7):
    """Kernel operands of the molecule-bin layout (three molecules, C = 16)
    on the CPU, with the AEV constants as leaves that require grad."""
    rng = np.random.default_rng(seed)
    mols = []
    for n in (11, 16, 5):
        coord = rng.uniform(-2.5, 2.5, size=(n, 3)).astype(np.float32)
        mols.append({"coord": coord, "numbers": rng.choice([1, 6, 8], size=n)})
    sysb = system_molecule_bins(mols, CPU)
    grid = sysb.bins
    tab = build_conv_tables(grid, tB.stencil_radius(5.0, grid))
    b, c, g, f = grid.total_bins, grid.capacity, 8, 5
    st = cs.ConvStatic(b_tot=b, c=c, g=g, f=f, s_tot=tab["nbr"].shape[0])
    ops = dict(
        a_gmajor=torch.tensor((rng.normal(size=(b, c, g * f)) * 0.3).astype(np.float32), requires_grad=True),
        coord=sysb.coord.reshape(b, c, 3).clone().requires_grad_(True),
        shift=torch.tensor(tab["push"]).requires_grad_(True),
        mask=(sysb.numbers > 0).float().reshape(b, c),
        nbr=torch.tensor(tab["nbr"]),
        mnbr=torch.tensor(tab["mnbr"]),
        shifts_g=torch.tensor(np.linspace(0.8, 5.0, g + 1, dtype=np.float32)[:g], requires_grad=True),
        scal=torch.tensor([10.5, 5.0], requires_grad=True),
    )
    gbar = torch.tensor(rng.normal(size=(b, 4, c, g * f)).astype(np.float32))
    return st, ops, gbar


def _acc(st, o):
    return cp.ConvAcc.apply(o["a_gmajor"], o["coord"], o["shift"], st, o["mask"], o["nbr"], o["mnbr"],
                            o["shifts_g"], o["scal"])


def _plain(st, o):
    return cs.conv_forward_plain(st, o["a_gmajor"], o["coord"], o["mask"], o["shift"], o["nbr"], o["shifts_g"],
                                 o["scal"])


def test_conv_constants_adjoint_matches_plain():
    """First order: ConvAcc's adjoints of shifts_g, eta and rc (the
    constants' build's plain version) equal autograd of the plain forward;
    second order: the gradient of a force-like quantity (the coordinate
    adjoint, itself differentiated) in the constants and the features
    equals autograd of the plain twice over."""
    st, o, gbar = _conv_operands()
    wrt = [o["shifts_g"], o["scal"], o["a_gmajor"], o["coord"]]
    got = torch.autograd.grad((_acc(st, o) * gbar).sum(), wrt)
    want = torch.autograd.grad((_plain(st, o) * gbar).sum(), wrt)
    assert float(got[0].abs().max()) > 0 and float(got[1].abs().max()) > 0
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5 * float(y.abs().max()), rtol=0)

    def second(fn):
        (gc,) = torch.autograd.grad((fn(st, o) * gbar).sum(), o["coord"], create_graph=True)
        return torch.autograd.grad((gc * gc).sum(), [o["shifts_g"], o["scal"], o["a_gmajor"]])

    for x, y in zip(second(_acc), second(_plain)):
        assert float(y.abs().max()) > 0
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5 * float(y.abs().max()), rtol=0)


def test_conv_backward_asks_for_the_constants_only_in_training():
    """Without a leaf among the constants the plain backward returns three
    adjoints (the build without the constants on the card); with one, five."""
    st, o, gbar = _conv_operands()
    args = (st, o["a_gmajor"], o["coord"], o["mask"], o["shift"], o["nbr"], o["mnbr"], o["shifts_g"], o["scal"],
            gbar)
    assert len(cs.conv_stencil_backward(*args)) == 3
    assert len(cs.conv_stencil_backward_constants(*args)) == 5
    o = {**o, "shifts_g": o["shifts_g"].detach(), "scal": o["scal"].detach()}
    a, c = torch.autograd.grad((_acc(st, o) * gbar).sum(), [o["a_gmajor"], o["coord"]])
    assert a.shape == o["a_gmajor"].shape and c.shape == o["coord"].shape
