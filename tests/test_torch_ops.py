"""The port's math and per-molecule ops against the JAX package (CPU).

Inputs are drawn with numpy and handed to both frameworks; rtol 1e-6 (f32,
the same formula in both)."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from aimnetcentral_tpu.ops import math as jmath
from aimnetcentral_tpu.ops import nb as jnb
from aimnetcentral_tpu.models import modules as jmodules
from aimnetcentral_tpu_torch.ops import math as tmath
from aimnetcentral_tpu_torch.ops import nb as tnb
from aimnetcentral_tpu_torch.models import modules as tmodules

RTOL = 1e-6


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_cellmul(rng):
    a = rng.normal(size=(50, 3)).astype(np.float32)
    cell = (np.eye(3) * 9.0 + rng.normal(size=(3, 3))).astype(np.float32)
    _close(tmath.cellmul(torch.tensor(a), torch.tensor(cell)), jmath.cellmul(a, cell), atol=1e-6)


@pytest.mark.parametrize("rc", [4.6, 5.0])
def test_cosine_cutoff(rng, rc):
    d = rng.uniform(0.0, 6.0, size=(40, 7)).astype(np.float32)
    _close(tmath.cosine_cutoff(torch.tensor(d), rc), jmath.cosine_cutoff(d, rc), atol=1e-7)


def test_exp_expand(rng):
    d = rng.uniform(0.5, 5.0, size=(30, 9)).astype(np.float32)
    shifts = np.linspace(0.8, 5.0, 17, dtype=np.float32)[:16]
    _close(
        tmath.exp_expand(torch.tensor(d), torch.tensor(shifts), 14.5),
        jmath.exp_expand(d, shifts, 14.5),
        atol=1e-7,
    )


def test_erfc_approx(rng):
    x = rng.uniform(0.0, 6.0, size=(200,)).astype(np.float32)
    _close(tmath.erfc_approx(torch.tensor(x)), jmath.erfc_approx(x), atol=1e-7)


def test_mol_sum_and_expand(rng):
    n, num_mol = 37, 3
    mol_idx = np.sort(rng.integers(0, num_mol + 1, size=n)).astype(np.int64)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    s_t = tnb.mol_sum(torch.tensor(x), torch.tensor(mol_idx), num_mol)
    s_j = jnb.mol_sum(x, mol_idx.astype(np.int32), num_mol)
    _close(s_t, s_j, atol=1e-6)
    _close(tnb.expand_mol(s_t, torch.tensor(mol_idx)), jnb.expand_mol(s_j, mol_idx.astype(np.int32)), atol=1e-6)


def test_mol_sum_drops_non_finite_padding(rng):
    """An inf or NaN in a padding row stays out of every molecule's sum
    and out of the gradient of the real rows, as in JAX's segment sum."""
    n, num_mol = 37, 3
    mol_idx = np.sort(rng.integers(0, num_mol + 1, size=n)).astype(np.int64)
    mol_idx[-2:] = num_mol
    x = rng.normal(size=(n, 4)).astype(np.float32)
    x[-2] = np.inf
    x[-1] = np.nan
    xt = torch.tensor(x, requires_grad=True)
    s_t = tnb.mol_sum(xt, torch.tensor(mol_idx), num_mol)
    _close(s_t, jnb.mol_sum(x, mol_idx.astype(np.int32), num_mol), atol=1e-6)
    (g,) = torch.autograd.grad(s_t.sum(), xt)
    np.testing.assert_array_equal(g.numpy(), (mol_idx < num_mol)[:, None] * np.ones_like(x))


def test_mask_pad_atoms(rng):
    numbers = rng.integers(0, 3, size=25)
    x = rng.normal(size=(25, 5)).astype(np.float32)
    _close(tnb.mask_pad_atoms(torch.tensor(x), torch.tensor(numbers)), jnb.mask_pad_atoms(x, numbers))


def test_nse(rng):
    n, num_mol = 40, 2
    mol_idx = np.concatenate([np.zeros(18), np.ones(20), np.full(2, num_mol)]).astype(np.int64)
    q_u = rng.normal(size=(n, 1)).astype(np.float32)
    f_u = (rng.normal(size=(n, 1)) ** 2).astype(np.float32)
    big_q = np.array([[1.0], [-2.0]], np.float32)
    q_t, dq_t = tmath.nse(torch.tensor(big_q), torch.tensor(q_u), torch.tensor(f_u), torch.tensor(mol_idx), num_mol)
    q_j, dq_j = jmath.nse(big_q, q_u, f_u, mol_idx.astype(np.int32), num_mol)
    _close(q_t, q_j, atol=1e-6)
    _close(dq_t, dq_j, atol=1e-6)


@pytest.mark.parametrize("last_linear", [True, False])
def test_mlp_apply(rng, last_linear):
    spec_j = jmodules.MLPSpec(hidden=(12, 7), last_linear=last_linear)
    spec_t = tmodules.MLPSpec(hidden=(12, 7), last_linear=last_linear)
    sizes = [9, 12, 7, 3]
    layers_np = [
        {"w": rng.normal(size=(a, b)).astype(np.float32), "b": rng.normal(size=b).astype(np.float32)}
        for a, b in zip(sizes[:-1], sizes[1:])
    ]
    x = rng.normal(size=(20, 9)).astype(np.float32)
    y_j = jmodules.mlp_apply([{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers_np], x, spec_j)
    y_t = tmodules.mlp_apply([{k: torch.tensor(v) for k, v in lay.items()} for lay in layers_np], torch.tensor(x), spec_t)
    # matmul sums run in another order: 1e-6 of the output's magnitude
    _close(y_t, y_j, atol=RTOL * float(np.abs(np.asarray(y_j)).max()))


def test_exp_cutoff(rng):
    d = rng.uniform(0.0, 6.0, size=(40, 7)).astype(np.float32)
    _close(tmath.exp_cutoff(torch.tensor(d), 4.6), jmath.exp_cutoff(d, 4.6), atol=1e-7)


def test_coulomb_matrix_dsf(rng):
    d = rng.uniform(0.5, 18.0, size=(30, 9)).astype(np.float32)
    valid = rng.uniform(size=d.shape) > 0.2
    _close(
        tmath.coulomb_matrix_dsf(torch.tensor(d), 15.0, 0.2, torch.tensor(valid)),
        jmath.coulomb_matrix_dsf(d, 15.0, 0.2, valid),
        atol=1e-7,
    )


@pytest.mark.parametrize("name,kw", [("huber", {}), ("huber", {"delta": 0.3}), ("bumpfn", {}),
                                     ("bumpfn", {"low": 0.2, "high": 0.9}), ("smoothstep", {}),
                                     ("smoothstep", {"low": -0.5, "high": 1.2}), ("expstep", {}),
                                     ("expstep", {"low": 0.1, "high": 0.8})])
def test_transition_functions(rng, name, kw):
    """The loss and transition helpers (tests/test_ops_properties.py's),
    values and first derivatives, on both sides of their ranges."""
    import jax

    x = rng.uniform(-1.5, 2.5, size=200).astype(np.float32)
    jfn, tfn = getattr(jmath, name), getattr(tmath, name)
    xt = torch.tensor(x, requires_grad=True)
    yt = tfn(xt, **kw)
    _close(yt, jfn(x, **kw), atol=1e-7)
    (gt,) = torch.autograd.grad(yt.sum(), xt)
    _close(gt, jax.grad(lambda v: jfn(v, **kw).sum())(x), rtol=1e-5, atol=1e-6)


def test_ops_package_exports_what_jax_exports():
    import aimnetcentral_tpu.ops as jops
    import aimnetcentral_tpu_torch.ops as tops

    public = {n for n in vars(jops) if not n.startswith("_") and not n[0].isupper()} - {"math", "nb", "binned"}
    assert public <= set(vars(tops))
    assert tops.smoothstep is tmath.smoothstep


def test_system_mask_i():
    from aimnetcentral_tpu.builders import system_from_molecules as jsfm
    from aimnetcentral_tpu_torch.builders import system_from_molecules as tsfm

    mols = [{"coord": np.eye(3, dtype=np.float32), "numbers": np.array([8, 1, 1])},
            {"coord": np.zeros((1, 3), np.float32), "numbers": np.array([6])}]
    got = tsfm(mols, torch.device("cpu")).mask_i()
    want = jsfm(mols).mask_i()
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
