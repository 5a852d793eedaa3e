"""The port's binned layout and DSF pair sweep against the JAX package (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.builders import system_from_molecules as j_system_from_molecules
from aimnetcentral_tpu.models import engine_binned as jeb
from aimnetcentral_tpu.ops import binned as jB
from aimnetcentral_tpu_torch.builders import system_from_molecules as t_system_from_molecules
from aimnetcentral_tpu_torch.models import engine_binned as teb
from aimnetcentral_tpu_torch.ops import binned as tB
from torch_train_helpers import one_torch_thread  # noqa: E402, F401  (an autouse fixture)

CPU = torch.device("cpu")
# jitted as the JAX calculator runs it: eager dispatch of its many small ops
# costs ten times the compile
j_to_binned_system = jax.jit(jB.to_binned_system, static_argnums=(1, 2))


def _box(n, a, seed):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(-0.5 * a, 1.5 * a, size=(n, 3)).astype(np.float32)  # some outside the cell
    numbers = rng.choice([1, 6, 7, 8], size=n)
    return {"coord": coord, "numbers": numbers, "charge": 0.0, "cell": np.eye(3, dtype=np.float32) * a}


def _grid_fields(g):
    return (g.nbins, g.capacity, g.edge_hint, g.periodic, g.margin)


CASES = [(40, 12.0, 5.6, 1.5), (60, 12.0, 5.2, 3.0), (300, 18.0, 5.6, 1.5)]


@pytest.mark.parametrize("n,a,edge,safety", CASES)
def test_plan_bins_equal(n, a, edge, safety):
    cell = np.eye(3) * a
    assert _grid_fields(tB.plan_bins(cell, n, edge, safety=safety)) == _grid_fields(
        jB.plan_bins(cell, n, edge, safety=safety)
    )
    assert _grid_fields(tB.plan_lr_bins(cell, n, 15.0, safety=safety, margin=0.6)) == _grid_fields(
        jB.plan_lr_bins(cell, n, 15.0, safety=safety, margin=0.6)
    )


@pytest.mark.parametrize("nbins,radius", [((2, 2, 2), 1), ((8, 8, 8), 1), ((3, 1, 2), 2)])
def test_stencil_tables_equal(nbins, radius):
    tg = tB.BinGrid(nbins=nbins, capacity=8, edge_hint=5.0, periodic=True)
    jg = jB.BinGrid(nbins=nbins, capacity=8, edge_hint=5.0, periodic=True)
    np.testing.assert_array_equal(tB.stencil_offsets(radius), jB.stencil_offsets(radius))
    for t, j in zip(tB.stencil_tables(tg, radius), jB.stencil_tables(jg, radius)):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tB.mirror_stencil_tables(tg, radius), jB.mirror_stencil_tables(jg, radius)):
        np.testing.assert_array_equal(t, j)


def test_gas_phase_stencil_tables_equal():
    tg = tB.BinGrid(nbins=(3, 2, 2), capacity=8, edge_hint=5.0, periodic=False)
    jg = jB.BinGrid(nbins=(3, 2, 2), capacity=8, edge_hint=5.0, periodic=False)
    for t, j in zip(tB.stencil_tables(tg, 1), jB.stencil_tables(jg, 1)):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tB.mirror_stencil_tables(tg, 1), jB.mirror_stencil_tables(jg, 1)):
        np.testing.assert_array_equal(t, j)


def _both_binned(n, a, edge, safety, seed=3):
    mol = _box(n, a, seed)
    sys_j = j_system_from_molecules([mol], build_nbmat=False)
    sys_t = t_system_from_molecules([mol], CPU)
    cell = np.eye(3) * a
    jg = jB.plan_bins(cell, n, edge, safety=safety)
    jl = jB.plan_lr_bins(cell, n, 15.0, safety=safety, margin=0.6)
    tg = tB.plan_bins(cell, n, edge, safety=safety)
    tl = tB.plan_lr_bins(cell, n, 15.0, safety=safety, margin=0.6)
    bj, perm_j, ovf_j = j_to_binned_system(sys_j, jg, jl)
    bt, perm_t, ovf_t = tB.to_binned_system(sys_t, tg, tl)
    return bj, perm_j, ovf_j, bt, perm_t, ovf_t


@pytest.mark.parametrize("n,a,edge,safety", CASES)
def test_to_binned_system_matches(n, a, edge, safety):
    bj, perm_j, ovf_j, bt, perm_t, ovf_t = _both_binned(n, a, edge, safety)
    assert int(ovf_t.sum()) == int(ovf_j)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_allclose(bt.coord.numpy(), np.asarray(bj.coord), atol=1e-6)
    np.testing.assert_array_equal(bt.numbers.numpy(), np.asarray(bj.numbers))
    np.testing.assert_array_equal(bt.mol_idx.numpy(), np.asarray(bj.mol_idx))
    np.testing.assert_array_equal(bt.lr_slot.numpy(), np.asarray(bj.lr_slot))
    # every real SR slot maps to the same LR slot (padding rows may differ:
    # both read a slot whose pair sums are zero)
    real = np.asarray(bj.numbers) > 0
    np.testing.assert_array_equal(bt.lr_inv.numpy()[real], np.asarray(bj.lr_inv)[real])


def test_capacity_overflow_counted():
    mol = _box(60, 12.0, 5)
    sys_j = j_system_from_molecules([mol], build_nbmat=False)
    sys_t = t_system_from_molecules([mol], CPU)
    jg = jB.BinGrid(nbins=(2, 2, 2), capacity=8, edge_hint=5.6, periodic=True)
    tg = tB.BinGrid(nbins=(2, 2, 2), capacity=8, edge_hint=5.6, periodic=True)
    _bj, perm_j, ovf_j = j_to_binned_system(sys_j, jg, None)
    _bt, perm_t, ovf_t = tB.to_binned_system(sys_t, tg)
    assert int(ovf_t.sum()) == int(ovf_j) > 0
    assert ovf_t.shape == (2,) and int(ovf_t[1]) == 0  # [sr, lr]: no LR grid, nothing dropped there
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))


@pytest.mark.parametrize("envelope", ["exp", "cosine"])
def test_coulomb_dsf_binned_matches(envelope):
    """Energy and its coordinate and cell gradients, LR twin layout."""
    bj, _pj, _oj, bt, _pt, _ot = _both_binned(60, 12.0, 5.6, 1.5, seed=9)
    rng = np.random.default_rng(4)
    q = (rng.normal(size=bt.natoms) * 0.3).astype(np.float32) * (bt.numbers.numpy() > 0)

    def e_j(coord, cell):
        return jeb.coulomb_dsf_binned(
            bj.replace(coord=coord, cell=cell), jnp.asarray(q), 4.6, 0.2, 15.0, envelope, True
        ).sum()

    ej, (gcj, gsj) = jax.value_and_grad(e_j, argnums=(0, 1))(bj.coord, bj.cell)
    coord = bt.coord.clone().requires_grad_(True)
    cell = bt.cell.clone().requires_grad_(True)
    et = teb.coulomb_dsf_binned(
        bt.replace(coord=coord, cell=cell), torch.tensor(q), 4.6, 0.2, 15.0, envelope, True
    ).sum()
    gct, gst = torch.autograd.grad(et, (coord, cell))
    np.testing.assert_allclose(float(et.detach()), float(ej), rtol=1e-5)
    scale = float(np.abs(np.asarray(gcj)).max())
    np.testing.assert_allclose(gct.numpy(), np.asarray(gcj), atol=1e-5 * scale)
    np.testing.assert_allclose(gst.numpy(), np.asarray(gsj), atol=1e-5 * float(np.abs(np.asarray(gsj)).max()))


def test_stencil_radius_matches():
    for nb, edge, margin in [((2, 2, 2), 5.6, 0.6), ((6, 6, 6), 7.8, 0.6), ((8, 8, 8), 5.6, 0.0)]:
        tg = tB.BinGrid(nbins=nb, capacity=8, edge_hint=edge, periodic=True, margin=margin)
        jg = dataclasses.replace(
            jB.BinGrid(nbins=nb, capacity=8, edge_hint=edge, periodic=True), margin=margin
        )
        for cut in (5.0, 15.0):
            assert teb.stencil_radius(cut, tg) == jeb.stencil_radius(cut, jg)
