"""The plain versions of kernels A and B in "bf16" against the JAX package's
Pallas conv kernels in "bf16", in interpret mode (CPU).

JAX's kernels cast W and the features to bfloat16 before each MXU dot
(``conv_stencil._mxu_dot``), and the port's bf16 builds round the same
operands the same way (``conv_stencil.round_bf16``).  On the 40-atom box of
tests/test_pallas_conv.py (2x2x2 bins, C = 16: about 20 s of interpret
mode) the two agree to summation order, 1e-5 of the largest magnitude, in
the conv pass's outputs and in the coordinate gradient (JAX's fused
adjoint kernel against the port's plain B); the exact conv lies 3e-3 away,
so the comparison sees the mode.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from aimnetcentral_tpu.builders import system_from_molecules as j_system_from_molecules  # noqa: E402
from aimnetcentral_tpu.kernels.conv_pallas import conv_pass_pallas  # noqa: E402
from aimnetcentral_tpu.ops import binned as jB  # noqa: E402
from aimnetcentral_tpu_torch.builders import system_from_molecules as t_system_from_molecules  # noqa: E402
from aimnetcentral_tpu_torch.kernels import conv_pass as tcp  # noqa: E402
from aimnetcentral_tpu_torch.ops import binned as tB  # noqa: E402
from torch_train_helpers import one_torch_thread  # noqa: E402, F401  (an autouse fixture)

RC = 5.0
SUM_ORDER = 1e-5  # of the largest magnitude: f32 sums in another order
KEYS = ("a", "q", "agh_a", "agh_q")


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(7)
    n, a = 40, 12.0
    coord = rng.uniform(0, a, size=(n, 3)).astype(np.float32)
    numbers = rng.choice([1, 6, 8], size=n)
    cell = np.eye(3, dtype=np.float32) * a
    mol = {"coord": coord, "numbers": numbers, "cell": cell}
    sysj, _p, ovf = jB.to_binned_system(j_system_from_molecules([mol], build_nbmat=False),
                                        jB.plan_bins(cell, n, 5.2, safety=3.0))
    syst, _p2, _o = tB.to_binned_system(t_system_from_molecules([mol], torch.device("cpu")),
                                        tB.plan_bins(cell, n, 5.2, safety=3.0))
    assert int(ovf) == 0
    big_l = syst.natoms
    feats = {
        "a": (rng.normal(size=(big_l, 16, 16)) * 0.3).astype(np.float32),
        "q": (rng.normal(size=(big_l, 1)) * 0.1).astype(np.float32),
        "agh_a": (rng.normal(size=(16, 16, 12)) * 0.2).astype(np.float32),
        "agh_q": (rng.normal(size=(1, 16, 12)) * 0.2).astype(np.float32),
    }
    aev = {"rc_s": np.float32(RC), "eta_s": np.float32(14.5),
           "shifts_s": np.linspace(0.8, 5.0, 17, dtype=np.float32)[:16]}

    def loss_j(c):
        out_a, out_q = conv_pass_pallas(sysj.replace(coord=c), {k: jnp.asarray(v) for k, v in aev.items()},
                                        *(jnp.asarray(feats[k]) for k in KEYS), rc_static=RC, precision="bf16")
        return (out_a**2).sum() + (out_q**2).sum(), (out_a, out_q)

    with pltpu.force_tpu_interpret_mode():
        (_l, outs), grad = jax.value_and_grad(loss_j, has_aux=True)(sysj.coord)
    pallas = {"a": np.asarray(outs[0]), "q": np.asarray(outs[1]), "grad": np.asarray(grad)}

    def port(mode):
        mp = pytest.MonkeyPatch()
        mp.setattr(tcp, "resolve_conv_mode", lambda _prec, _dev: mode)
        try:
            c = syst.coord.clone().requires_grad_(True)
            out_a, out_q = tcp.conv_pass(syst.replace(coord=c), {k: torch.tensor(v) for k, v in aev.items()},
                                         *(torch.tensor(feats[k]) for k in KEYS), rc_static=RC)
            (g,) = torch.autograd.grad((out_a**2).sum() + (out_q**2).sum(), c)
        finally:
            mp.undo()
        return {"a": out_a.detach().numpy(), "q": out_q.detach().numpy(), "grad": g.numpy()}

    return pallas, port("bf16"), port("fp32")


@pytest.mark.parametrize("key", ["a", "q", "grad"])
def test_plain_bf16_matches_pallas_bf16(both, key):
    pallas, bf16, exact = both
    scale = float(np.abs(pallas[key]).max())
    np.testing.assert_allclose(bf16[key], pallas[key], atol=SUM_ORDER * scale)
    # and the exact conv does not: the comparison sees the rounding
    assert float(np.abs(exact[key] - pallas[key]).max()) > 30 * SUM_ORDER * scale
