"""Ensembles on the port's spatial mesh (parallel/spatial.py, ``ens_axis``)
against the JAX package's single-device forward on the CPU.

JAX's tests/test_spatial.py::test_ens_x_sp_composition and
::test_spatial2d_ens_composition on the port: two members (JAX seeds 0 and
7) of the narrow flagship head chain on JAX's 400-atom DSF box (DSF at
9 A, a halo of two planes), stacked on a member axis, on an (ens 2, sp 2)
mesh and an (ens 2, sp 2, spy 2) mesh, both in one gloo world of eight
ranks.  Each member's energy within JAX's limits (``rtol=2e-6,
atol=2e-5``) of that member's single-device JAX energy, its forces within
JAX's force limit of its own gradient, its cell gradient likewise; every
rank holds every member's numbers.  The observables refusal, as JAX's
assertion."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.models import aimnet2_apply  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu_torch.calculators.ensemble import stack_params  # noqa: E402
from aimnetcentral_tpu_torch.parallel.spatial import make_spatial_energy_fn, plan_spatial  # noqa: E402
from torch_spatial_helpers import (  # noqa: E402
    E_TOL,
    World,
    assert_cell_grad,
    assert_forces,
    binned_pair,
    lattice_box,
    narrow_config,
)
from torch_train_helpers import one_torch_thread, port_object, port_params  # noqa: E402, F401  (a fixture)

SEEDS = (0, 7)  # JAX's members: its case's params and aimnet2_init(key(7))
MESHES = {"ens2_sp2": dict(n_sp=2, n_spy=1), "ens2_sp2_spy2": dict(n_sp=2, n_spy=2)}


@pytest.fixture(scope="module")
def case():
    mol = lattice_box(400, 22.0, 0.4, seed=3)
    jsys, tsys = binned_pair(mol, 5.3, 2.5)
    assert jsys.bins.nbins[:2] == (4, 4)
    jcfg = jheads.auto_switch_simple_to_dsf(narrow_config(jheads.LRCoulombHead(rc=4.6, dsf_rc=9.0)))
    jparams = [j_init(jax.random.key(s), jcfg) for s in SEEDS]
    return jcfg, jparams, jsys, tsys


@pytest.fixture(scope="module")
def runs(case):
    """Both meshes in one world of eight ranks, while JAX computes each
    member's single-device energy and gradients (one compile for both)."""
    jcfg, jparams, jsys, tsys = case
    tcfg = port_object(jcfg)
    stacked = stack_params([port_params(p) for p in jparams])
    world = World(8, [(name, "energy", dict(system=tsys, cfg=tcfg, params=stacked, n_ens=2, **kw))
                      for name, kw in MESHES.items()])

    def energy(params, coord, cell):
        s = jsys.replace(coord=coord, cell=cell[None])
        return aimnet2_apply(params, jcfg, s, sae_external=True)["energy"].sum()

    fn = jax.jit(jax.value_and_grad(energy, argnums=(1, 2)))
    refs = []
    for p in jparams:
        e, (g, g_cell) = fn(p, jsys.coord, jsys.cell[0])
        refs.append({"energy": float(e), "grad": np.asarray(g), "cell_grad": np.asarray(g_cell)})
    return world.results(), refs


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_member_energies_match_single_device_jax(runs, mesh):
    ranks, refs = runs
    n = 4 * MESHES[mesh]["n_spy"]
    outs = [r[mesh] for r in ranks[:n]]
    assert all(r[mesh] is None for r in ranks[n:])
    want = np.array([ref["energy"] for ref in refs])
    for out in outs:
        assert out["energy"].shape == (2,)
        np.testing.assert_allclose(out["energy"], want, **E_TOL)
        np.testing.assert_array_equal(out["energy"], outs[0]["energy"])
    # ens-major: the first half of the ranks is member 0's ring or torus
    assert [o["member"] for o in outs] == [0] * (n // 2) + [1] * (n // 2)
    assert outs[0]["energy"][0] != outs[0]["energy"][1]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_member_forces_match_single_device_jax(runs, case, mesh):
    ranks, refs = runs
    _jcfg, _jparams, _jsys, tsys = case
    n = 4 * MESHES[mesh]["n_spy"]
    for out in (r[mesh] for r in ranks[:n]):
        assert out["forces"].shape == (2,) + tuple(tsys.coord.shape)
        for m, ref in enumerate(refs):
            assert_forces(out["forces"][m], ref["grad"], tsys.numbers.numpy())
            assert_cell_grad(out["cell_grad"][m], ref["cell_grad"])
    # each member's forces are its own: the members' gradients differ
    f = ranks[0][mesh]["forces"]
    assert np.abs(f[0] - f[1]).max() > 1e-3 * np.abs(f).max()


def test_observables_with_ens_axis_raise(case):
    jcfg, _jparams, _jsys, tsys = case
    tcfg = port_object(jcfg)
    spec = plan_spatial(tsys, tcfg, n_sp=2)
    with pytest.raises(ValueError, match="observables"):
        make_spatial_energy_fn(tcfg, spec, None, ens_axis="ens", observables=True)
