"""The port's DFT-D3(BJ) against the JAX package's (CPU): the reference
tables, the factorised per-atom C6 vectors, ``dftd3_binned``, and the
released wB97M-D3 head set (the flagship's heads plus the external D3 head
of ``aimnet2-wb97m-d3_*``) through ``AIMNet2Calculator``.

The narrow model of tests/test_torch_calculator.py with JAX parameters
carried across by the weights bridge, on its 60-atom 12 A periodic box.
Tolerances: D3 vectors and energies 1e-5 relative; calculator energy 1e-5
relative, charges 1e-5, forces 1e-5 eV/A, stress 1e-6 eV/A^3.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu import constants as jconstants
from aimnetcentral_tpu.builders import system_from_molecules as j_system_from_molecules
from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator
from aimnetcentral_tpu.models import AIMNet2Config as JConfig
from aimnetcentral_tpu.models import aimnet2_init as j_init
from aimnetcentral_tpu.models import engine_binned as jeb
from aimnetcentral_tpu.models import heads as jheads
from aimnetcentral_tpu.models import modules as jmodules
from aimnetcentral_tpu.ops import binned as jB
from aimnetcentral_tpu_torch import constants as tconstants
from aimnetcentral_tpu_torch.builders import system_from_molecules as t_system_from_molecules
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator
from aimnetcentral_tpu_torch.models import AIMNet2Config as TConfig
from aimnetcentral_tpu_torch.models import aimnet2_init as t_init
from aimnetcentral_tpu_torch.models import engine_binned as teb
from aimnetcentral_tpu_torch.models import heads as theads
from aimnetcentral_tpu_torch.models import modules as tmodules
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy
from aimnetcentral_tpu_torch.ops import binned as tB
from torch_train_helpers import one_torch_thread  # noqa: E402, F401  (an autouse fixture)

CPU = torch.device("cpu")
NARROW = dict(nfeature=4, ncomb_v=4, hidden=((32, 16), (32, 16), (32, 16)), aim_size=16)
D3 = dict(s8=0.3908, a1=0.566, a2=3.128, cutoff=15.0)  # model_registry.yaml:13-16


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
        ("external_dftd3", heads.DFTD3Head(**D3)),
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


def _rel(actual, desired, rel=1e-5):
    desired = np.asarray(desired, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64), desired,
                               atol=rel * float(np.abs(desired).max()))


def test_d3_tables_equal():
    jt, tt = jconstants.get_d3_tables(), tconstants.get_d3_tables()
    assert sorted(jt) == sorted(tt)
    for k in jt:
        assert tt[k].dtype == jt[k].dtype
        np.testing.assert_array_equal(tt[k], jt[k])


@pytest.fixture(scope="module")
def binned():
    """The 60-atom box on both packages' binned layouts with the 15 A LR
    twin grid (1x1x1: the bin meets itself at every offset)."""
    mol = {**_box(), "charge": 0.0}
    cell = mol["cell"]
    jg, tg = jB.plan_bins(cell, 60, 5.6, safety=1.5), tB.plan_bins(cell, 60, 5.6, safety=1.5)
    jl = jB.plan_lr_bins(cell, 60, 15.0, safety=1.5, margin=0.6)
    tl = tB.plan_lr_bins(cell, 60, 15.0, safety=1.5, margin=0.6)
    bj, _pj, ovf = jax.jit(jB.to_binned_system, static_argnums=(1, 2))(
        j_system_from_molecules([mol], build_nbmat=False), jg, jl
    )
    bt, _pt, _ot = tB.to_binned_system(t_system_from_molecules([mol], CPU), tg, tl)
    assert int(ovf) == 0
    assert bt.species == bj.species == (1, 6, 7, 8)
    return bj, bt


def test_d3_pair_extras_match(binned):
    bj, bt = binned
    rng = np.random.default_rng(1)
    cn = rng.uniform(0.0, 4.0, size=bt.natoms).astype(np.float32)
    t = jconstants.get_d3_tables()
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    tt = {k: torch.tensor(v) for k, v in t.items()}
    ref = jeb.d3_pair_extras(bj.species, bj.numbers, jnp.asarray(cn), jt)
    got = teb.d3_pair_extras(bt.species, bt.numbers, torch.tensor(cn), tt)
    assert sorted(got) == sorted(ref) == ["p", "r", "rr"]
    for k in ref:
        _rel(got[k].numpy(), ref[k])


def test_dftd3_binned_matches(binned):
    """Energy and its coordinate and cell gradients: both sweeps (CN, then
    the factorised energy) and the C6 vectors between them."""
    bj, bt = binned
    t = jconstants.get_d3_tables()
    kw = dict(a1=0.566, a2=3.128, s8=0.3908, smoothing_on=12.0, smoothing_off=15.0)

    def e_j(coord, cell):
        return jeb.dftd3_binned(bj.replace(coord=coord, cell=cell), {k: jnp.asarray(v) for k, v in t.items()}, **kw).sum()

    ej, (gcj, gsj) = jax.jit(jax.value_and_grad(e_j, argnums=(0, 1)))(bj.coord, bj.cell)
    coord = bt.coord.clone().requires_grad_(True)
    cell = bt.cell.clone().requires_grad_(True)
    et = teb.dftd3_binned(bt.replace(coord=coord, cell=cell), {k: torch.tensor(v) for k, v in t.items()}, **kw).sum()
    gct, gst = torch.autograd.grad(et, (coord, cell))
    np.testing.assert_allclose(float(et.detach()), float(ej), rtol=1e-5)
    _rel(gct.numpy(), gcj)
    _rel(gst.numpy(), gsj)


@pytest.fixture(scope="module")
def models():
    jcfg = _config(JConfig, jheads, jmodules)
    tcfg = _config(TConfig, theads, tmodules)
    jparams = j_init(jax.random.key(0), jcfg)
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


def test_d3_tables_carry_across(models):
    """The bridge keeps the tables' float32 and the port's own init builds
    the same tree."""
    jmodel, tmodel = models
    tables = tmodel[0]["outputs"]["external_dftd3"]
    for k, v in jconstants.get_d3_tables().items():
        assert tables[k].dtype == torch.float32
        np.testing.assert_array_equal(tables[k].numpy(), v)
    mine = t_init(tmodel[1], seed=0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, mine)) == jax.tree.structure(
        jax.tree.map(lambda x: 0, tmodel[0])
    )


def test_lr_grid_planned_on_the_largest_cutoff(models):
    """The LR twin grid follows max(dsf_rc, D3 cutoff), as in the JAX
    calculator: a D3 cutoff above dsf_rc widens the LR bins."""
    _jmodel, (tparams, tcfg, aux) = models
    data = {**_box(n=240, a=19.0), "cell": np.eye(3, dtype=np.float32) * 19.0}
    calc = TCalculator((tparams, tcfg, aux), device="cpu", binned_threshold=0)
    assert calc.prepare_system(data).lr_bins.edge_hint == pytest.approx((15.0 + 0.6) / 2.0)
    outputs = tuple(
        (n, dataclasses.replace(h, cutoff=18.0) if n == "external_dftd3" else h) for n, h in tcfg.outputs
    )
    wide = TCalculator((tparams, dataclasses.replace(tcfg, outputs=outputs), aux), device="cpu",
                       binned_threshold=0)
    assert wide.prepare_system(data).lr_bins.edge_hint == pytest.approx((18.0 + 0.6) / 2.0)


def test_d3_indexed_matches_binned(binned):
    """The D3 head on the indexed layout gives the binned head's energy on
    the same box: the 60 atoms with a 15.6 A list, against the 15 A LR twin
    grid."""
    _bj, bt = binned
    head = theads.DFTD3Head(**D3)
    params = theads.head_init(None, head, CPU)
    mol = {**_box(), "charge": 0.0}
    indexed = t_system_from_molecules([mol], CPU, 64, cutoff=5.6, lr_cutoff=15.6, build_nbmat=True)
    e_idx = theads.head_apply(head, params, {}, indexed)["energy"]
    e_bin = theads.head_apply(head, params, {}, bt)["energy"]
    _rel(e_idx.numpy(), e_bin.numpy())
