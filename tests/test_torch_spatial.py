"""The port's spatial decomposition (aimnetcentral_tpu_torch/parallel/)
against the JAX package's single-device forward on the CPU, on JAX
tests/test_spatial.py's 400-atom DSF box (4 x-planes, DSF at 9 A: a halo of
two planes): a gloo ring of 2 ranks (energy, forces, cell gradient,
stress, observables, NSE) and a world of 4 at DSF 5 A, a halo of one
plane (the 2 x 2 torus, a ring of four, and NVE steps of
``SpatialMDDriver`` on it against JAX's velocity Verlet from the same
state); the per-axis stencil tables bit for
bit against JAX's; the over-split refusals; the collectives' backward
against autograd of a one-process reference.  JAX's own slow tests hold
its sharded function to the same single-device forward."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu.ops import binned as jB  # noqa: E402
from aimnetcentral_tpu.parallel.spatial import plan_spatial as j_plan_spatial  # noqa: E402
from aimnetcentral_tpu_torch.builders import stack_systems, system_from_molecules  # noqa: E402
from aimnetcentral_tpu_torch.dynamics.md import MDConfig  # noqa: E402
from aimnetcentral_tpu_torch.ops import binned as tB  # noqa: E402
from aimnetcentral_tpu_torch.parallel.mesh import card_backend  # noqa: E402
from aimnetcentral_tpu_torch.parallel.spatial import plan_spatial  # noqa: E402
from torch_spatial_helpers import (  # noqa: E402
    E_TOL,
    World,
    assert_cell_grad,
    assert_forces,
    binned_pair,
    jax_reference,
    lattice_box,
    model,
    narrow_config,
    verlet_reference,
    replace_head,
)
from torch_train_helpers import one_torch_thread  # noqa: E402, F401  (an autouse fixture)

MD_STEPS, MD_CHUNK, MD_DT = 2, 1, 0.2  # a global re-bin after each step
LANGEVIN = dict(temperature_K=300.0, friction_fs=0.1)  # strong friction: the noise moves step 2's epot

GRIDS = {
    "ring": dict(nbins=(6, 4, 4), periodic=True, periodic_axes=(False, True, True)),
    "torus": dict(nbins=(6, 6, 4), periodic=True, periodic_axes=(False, False, True)),
    "gas": dict(nbins=(3, 2, 2), periodic=False),
    "box": dict(nbins=(4, 4, 4), periodic=True),
}


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("kind", sorted(GRIDS))
def test_stencil_tables_per_axis_match_jax(kind, radius):
    tg = tB.BinGrid(capacity=8, edge_hint=5.0, **GRIDS[kind])
    jg = jB.BinGrid(capacity=8, edge_hint=5.0, **GRIDS[kind])
    assert tg.axes_periodic == jg.axes_periodic
    for t, j in zip(tB.stencil_tables(tg, radius), jB.stencil_tables(jg, radius)):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tB.mirror_stencil_tables(tg, radius), jB.mirror_stencil_tables(jg, radius)):
        np.testing.assert_array_equal(t, j)


@pytest.fixture(scope="module")
def case():
    mol = lattice_box(400, 22.0, 0.4, seed=3)
    jsys, tsys = binned_pair(mol, 5.3, 2.5)
    assert jsys.bins.nbins[0] == 4
    obs_heads = (("dipole", jheads.DipoleHead()), ("quadrupole", jheads.QuadrupoleHead(center_coord=True)))
    base = narrow_config(jheads.LRCoulombHead(rc=4.6, dsf_rc=9.0), obs_heads)
    nse = dataclasses.replace(narrow_config(jheads.LRCoulombHead(rc=4.6, dsf_rc=9.0)), num_charge_channels=2)
    jsys2, tsys2 = binned_pair(mol, 5.3, 2.5, mult=2.0)
    rng = np.random.default_rng(11)
    mols = [{"coord": rng.normal(size=(5, 3)).astype(np.float32), "numbers": np.array([8, 1, 1, 6, 1])}
            for _ in range(4)]
    batch = stack_systems([system_from_molecules(mols[2 * k : 2 * k + 2], torch.device("cpu")) for k in range(2)])
    return {
        "mol": mol, "jsys": jsys, "tsys": tsys, "jsys2": jsys2, "tsys2": tsys2, "batch": batch,
        "base": model(base, 0), "nse": model(nse, 7),
        "dsf5": model(replace_head(base, "lrcoulomb", dsf_rc=5.0), 2),
    }


@pytest.fixture(scope="module")
def runs(case):
    """Both worlds run while JAX computes its references."""
    _jc, _jp, tc, tp = case["base"]
    _nc, _np2, tnc, tnp = case["nse"]
    _fc, _fp, tfc, tfp = case["dsf5"]
    tsys = case["tsys"]
    md = MDConfig(dt_fs=MD_DT, temperature_K=1e-6, thermostat="nve", skin=1.0, precision="exact")
    md_langevin = MDConfig(dt_fs=MD_DT, thermostat="langevin", skin=1.0, precision="exact", **LANGEVIN)
    w2 = World(2, [
        ("ring", "energy", dict(system=tsys, cfg=tc, params=tp, n_sp=2, observables=True)),
        ("nse", "energy", dict(system=case["tsys2"], cfg=tnc, params=tnp, n_sp=2, observables=True)),
        ("coll", "collectives", dict(n_sp=2, n_spy=1, rows=3, width=2, h=2, seed=0)),
        ("dp", "dp_mesh", dict(batch=case["batch"])),
    ])
    w4 = World(4, [
        ("torus", "energy", dict(system=tsys, cfg=tfc, params=tfp, n_sp=2, n_spy=2, observables=True)),
        ("ring4", "energy", dict(system=tsys, cfg=tfc, params=tfp, n_sp=4)),
        ("md", "md", dict(system=tsys, cfg=tfc, params=tfp, n_sp=4, n_spy=1, md=md, steps=MD_STEPS, chunk=MD_CHUNK)),
        # one chunk: the noise of both steps is drawn in the initial slot order
        ("langevin", "md", dict(system=tsys, cfg=tfc, params=tfp, n_sp=2, n_spy=2, md=md_langevin, steps=MD_STEPS,
                                chunk=MD_STEPS)),
        ("coll_torus", "collectives", dict(n_sp=2, n_spy=2, rows=3, width=2, h=2, seed=1)),
        ("coll_ring4", "collectives", dict(n_sp=4, n_spy=1, rows=2, width=3, h=1, seed=2)),
    ])
    refs = {
        "base": jax_reference(case["base"][0], case["base"][1], case["jsys"])[0],
        "nse": jax_reference(case["nse"][0], case["nse"][1], case["jsys2"])[0],
    }
    refs["dsf5"], fn = jax_reference(case["dsf5"][0], case["dsf5"][1], case["jsys"])
    r2, r4 = w2.results(), w4.results()
    md = r4[0]["md"]
    refs["md"] = verlet_reference(fn, case["jsys"], md["veloc0"], md["masses"], MD_DT, MD_STEPS)
    # SpatialMDDriver's draws from torch.Generator(seed 0): the velocities, then
    # one whole-box (N, 3) standard normal a step
    lang = r4[0]["langevin"]
    gen = torch.Generator().manual_seed(0)
    n = case["tsys"].numbers.shape[0]
    noises = [torch.randn((n, 3), generator=gen).numpy() for _ in range(MD_STEPS + 1)][1:]
    refs["langevin"] = verlet_reference(fn, case["jsys"], lang["veloc0"], lang["masses"], MD_DT, MD_STEPS,
                                        (LANGEVIN["friction_fs"], LANGEVIN["temperature_K"], noises))
    refs["langevin_nve"] = verlet_reference(fn, case["jsys"], lang["veloc0"], lang["masses"], MD_DT, MD_STEPS)
    return refs, r2, r4


def _check_energy_forces(out, ref, numbers):
    np.testing.assert_allclose(float(out["energy"][0]), ref["energy"], **E_TOL)
    assert_forces(out["forces"], ref["grad"], numbers)


def test_ring_energy_and_forces_match_jax(case, runs):
    refs, w2, _w4 = runs
    out = w2[0]["ring"]
    assert out["halo"] == 2 and tuple(out["ext_nbins"]) == (6, 4, 4)
    _check_energy_forces(out, refs["base"], case["tsys"].numbers)


def test_ring_cell_gradient_and_stress_match_jax(case, runs):
    refs, w2, _w4 = runs
    out, ref = w2[0]["ring"], refs["base"]
    assert_cell_grad(out["cell_grad"], ref["cell_grad"])
    coord = case["tsys"].coord.numpy().astype(np.float64)
    cell = case["tsys"].cell[0].numpy().astype(np.float64)
    virial = coord.T @ ref["grad"] + cell.T @ ref["cell_grad"]
    stress = virial / abs(np.linalg.det(cell))
    np.testing.assert_allclose(out["stress"], stress, atol=5e-5 * np.abs(stress).max() + 1e-8)


def test_ring_observables_match_jax(case, runs):
    refs, w2, _w4 = runs
    out, ref = w2[0]["ring"], refs["base"]
    real = case["tsys"].numbers.numpy() > 0
    np.testing.assert_allclose(out["charges"][real], ref["charges"][real], atol=1e-5)
    np.testing.assert_allclose(out["dipole"], ref["dipole"][0], atol=1e-4)
    np.testing.assert_allclose(out["quadrupole"], ref["quadrupole"][0], rtol=2e-5, atol=1e-3)


def test_ring_ranks_hold_the_same_result(runs):
    _refs, w2, _w4 = runs
    for key in ("energy", "forces", "cell_grad", "charges", "dipole"):
        np.testing.assert_array_equal(w2[0]["ring"][key], w2[1]["ring"][key])


def test_nse_two_channel_matches_jax(case, runs):
    refs, w2, _w4 = runs
    out, ref = w2[0]["nse"], refs["nse"]
    _check_energy_forces(out, ref, case["tsys"].numbers)
    real = case["tsys"].numbers.numpy() > 0
    np.testing.assert_allclose(out["spin_charges"][real], ref["spin_charges"][real], atol=1e-5)
    np.testing.assert_allclose(out["charges"][real], ref["charges"][real], atol=1e-5)


def test_four_shards_ring_matches_jax(case, runs):
    refs, _w2, w4 = runs
    out = w4[0]["ring4"]
    assert out["halo"] == 1 and tuple(out["ext_nbins"]) == (3, 4, 4)
    _check_energy_forces(out, refs["dsf5"], case["tsys"].numbers)
    assert_cell_grad(out["cell_grad"], refs["dsf5"]["cell_grad"])


def test_torus_energy_forces_match_jax(case, runs):
    refs, _w2, w4 = runs
    out, ref = w4[0]["torus"], refs["dsf5"]
    assert tuple(out["ext_nbins"]) == (4, 4, 4)
    _check_energy_forces(out, ref, case["tsys"].numbers)
    assert_cell_grad(out["cell_grad"], ref["cell_grad"])
    real = case["tsys"].numbers.numpy() > 0
    np.testing.assert_allclose(out["charges"][real], ref["charges"][real], atol=1e-5)
    np.testing.assert_allclose(out["quadrupole"], ref["quadrupole"][0], rtol=2e-5, atol=1e-3)
    for r in (1, 2, 3):
        np.testing.assert_array_equal(w4[r]["torus"]["forces"], out["forces"])


def test_spatial_md_nve_matches_jax(runs):
    """SpatialMDDriver's epot trace (a global re-bin after every chunk)
    against JAX's single-device velocity Verlet on the fixed layout from the
    same initial velocities: the slot permutations are inert."""
    refs, _w2, w4 = runs
    np.testing.assert_allclose(w4[0]["md"]["epot"], refs["md"], rtol=1e-6, atol=1e-5)
    for r in (1, 2, 3):
        np.testing.assert_array_equal(w4[r]["md"]["epot"], w4[0]["md"]["epot"])


def test_spatial_md_langevin_matches_jax(runs):
    """SpatialMDDriver's Langevin steps on the 2 x 2 torus against JAX's
    Langevin update in a single-device loop drawing the same whole-box
    noise; the noise must move the trace beyond the limit (the NVE loop
    from the same state is the control)."""
    refs, _w2, w4 = runs
    got = w4[0]["langevin"]["epot"]
    tol = dict(rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got, refs["langevin"], **tol)
    assert not np.allclose(got, refs["langevin_nve"], **tol)
    for r in (1, 2, 3):
        np.testing.assert_array_equal(w4[r]["langevin"]["epot"], got)


def test_dp_mesh_replicate_and_shard_system(case, runs):
    """``make_mesh`` lays the world out as JAX's ("dp", "ens") mesh,
    ``replicate`` gives every rank the first rank's tree, ``shard_system``
    each rank its block of the stacked batch (JAX's ``P("dp")``)."""
    _refs, w2, _w4 = runs
    batch = case["batch"]
    for rank, res in enumerate(r["dp"] for r in w2):
        assert res["axis_names"] == ("dp", "ens") and res["shape"] == (2, 1) and res["coords"] == (rank, 0)
        np.testing.assert_array_equal(res["w"], np.zeros(3, np.float32))
        np.testing.assert_array_equal(res["mlps"], np.arange(4))
        assert res["block"] == (rank, 2)
        np.testing.assert_array_equal(res["coord"], batch.coord[rank : rank + 1].numpy())
        np.testing.assert_array_equal(res["numbers"], batch.numbers[rank : rank + 1].numpy())


def test_oversplit_refusals_match_jax(case):
    """A halo deeper than the local slab or tile is refused, where JAX
    asserts."""
    tc, jc = case["base"][2], case["base"][0]
    for n_sp, n_spy, match in ((4, 1, "halo"), (2, 4, "halo"), (3, 1, "divide")):
        with pytest.raises(ValueError, match=match):
            plan_spatial(case["tsys"], tc, n_sp, n_spy)
        with pytest.raises(AssertionError):
            j_plan_spatial(case["jsys"], jc, n_sp, n_spy)
    spec, jspec = plan_spatial(case["tsys"], tc, 2, 2), j_plan_spatial(case["jsys"], jc, 2, 2)
    assert (spec.halo, spec.nx_ext, spec.ny_ext) == (jspec.halo, jspec.nx_ext, jspec.ny_ext)
    assert spec.ext_grid.axes_periodic == jspec.ext_grid.axes_periodic
    core = spec.core_mask(torch.device("cpu")).numpy()
    np.testing.assert_array_equal(core, np.asarray(jspec.core_mask()))


@pytest.mark.parametrize("name", ["coll", "coll_torus", "coll_ring4"])
def test_collectives_backward_matches_one_process(runs, name):
    """Each rank's halo rows and the gradient of the sum of every rank's
    share (halo exchange, all-reduce, replicated sum) against one
    process's periodic indexing and autograd."""
    _refs, w2, w4 = runs
    ranks = [r[name] for r in (w2 if name == "coll" else w4)]
    g = torch.tensor(ranks[0]["g"], requires_grad=True)
    nx_tot, ny_tot = g.shape[:2]
    total = 0
    for me, res in enumerate(ranks):
        ext = res["ext"]
        h = (ext.shape[0] - res["grad"].shape[0]) // 2
        hy = (ext.shape[1] - res["grad"].shape[1]) // 2
        rows, cols = res["grad"].shape[:2]
        ix, iy = res["coords"][0], (res["coords"][1] if len(res["coords"]) > 1 else 0)
        xi = torch.arange(ix * rows - h, (ix + 1) * rows + h) % nx_tot
        yi = torch.arange(iy * cols - hy, (iy + 1) * cols + hy) % ny_tot
        ext_ref = g[xi][:, yi]
        np.testing.assert_array_equal(ext, ext_ref.detach().numpy())
        share = (torch.tensor(res["w_ext"][me]) * ext_ref).sum() + (torch.tensor(res["v"][me]) * g.sum((0, 1))).sum()
        total = total + share
    (grad,) = torch.autograd.grad(total, g)
    for res in ranks:
        assert res["clock_off"] == (0.0, 0.0) and min(res["clock"]) > 0.0
        np.testing.assert_allclose(res["total"][0], float(total.detach()), rtol=1e-5)
        rows, cols = res["grad"].shape[:2]
        ix, iy = res["coords"][0], (res["coords"][1] if len(res["coords"]) > 1 else 0)
        np.testing.assert_allclose(res["grad"], grad[ix * rows : (ix + 1) * rows, iy * cols : (iy + 1) * cols].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_cards, local_rank, local_world, want", [
    (4, 2, 4, ("nccl", 2)),   # a card a rank
    (4, 1, 4, ("nccl", 1)),   # a node of four in a world of eight
    (1, 3, 4, ("gloo", 0)),   # four ranks share one card
    (2, 3, 4, ("gloo", 1)),
])
def test_card_backend_follows_the_node(n_cards, local_rank, local_world, want):
    assert card_backend(n_cards, local_rank, local_world) == want


def test_init_distributed_reads_the_node_from_torchrun(monkeypatch):
    """Under torchrun a node's four cards serve its four ranks over NCCL,
    whatever the world's size; the card is the local rank's."""
    from aimnetcentral_tpu_torch.parallel import mesh as tmesh

    seen = {}
    for k, v in {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tmesh, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.setdefault("set", d))
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    dev = tmesh.init_distributed()
    assert dev == torch.device("cuda", 1) and seen["set"] == dev
    assert (seen["backend"], seen["rank"], seen["world_size"], seen["device_id"]) == ("nccl", 5, 8, dev)
