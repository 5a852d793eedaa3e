"""The port's MD driver, its cell lists and FIRE relaxation against the JAX
package's (CPU).

The narrow model and the 60-atom 12 A periodic box of
tests/test_torch_calculator.py, JAX parameters carried across by the
weights bridge, both drivers at ``precision="exact"`` and the same initial
velocities injected into both states through ``atom_id``: the binned
engine on the box, the indexed engine on the box and on a 40-atom
gas-phase cluster, and the binned engine on that cluster (DSF Coulomb).
Tolerances: per-step ``epot`` and ``temperature`` 1e-5 relative, final
coordinates and velocities 1e-5 (f32 sums in another order, over 10 steps
of chaotic dynamics, the layout rebuilt after the sixth); ``pressure`` 1e-6 eV/A^3 and ``volume`` 1e-5
relative; FIRE coordinates 1e-5 A.  ``build_cell_list`` equals JAX's row
for row.  Langevin noise comes from different generators in the two
packages, so Langevin runs are held statistically.  Each JAX driver is
built once per module with one chunk size (one compile each).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.builders import system_from_molecules as j_system  # noqa: E402
from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator  # noqa: E402
from aimnetcentral_tpu.dynamics import MDConfig as JMDConfig  # noqa: E402
from aimnetcentral_tpu.dynamics import MDDriver as JMDDriver  # noqa: E402
from aimnetcentral_tpu.dynamics import TrajectoryWriter as JTrajectoryWriter  # noqa: E402
from aimnetcentral_tpu.dynamics import fire_relax as j_fire  # noqa: E402
from aimnetcentral_tpu.models import AIMNet2Config as JConfig  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu.models import modules as jmodules  # noqa: E402
from aimnetcentral_tpu.ops import binned as jB  # noqa: E402
from aimnetcentral_tpu.ops import cell_list as jcl  # noqa: E402
from aimnetcentral_tpu_torch import constants  # noqa: E402
from aimnetcentral_tpu_torch.builders import system_from_molecules as t_system  # noqa: E402
from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver, TrajectoryWriter, fire_relax, read_frames  # noqa: E402
from aimnetcentral_tpu_torch.models import AIMNet2Config as TConfig  # noqa: E402
from aimnetcentral_tpu_torch.models import heads as theads  # noqa: E402
from aimnetcentral_tpu_torch.models import modules as tmodules  # noqa: E402
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from aimnetcentral_tpu_torch.ops import binned as tB  # noqa: E402
from aimnetcentral_tpu_torch.ops import cell_list as tcl  # noqa: E402
from test_torch_calculator import _box, _config  # noqa: E402
from test_torch_gpu import _cluster  # noqa: E402

CPU = torch.device("cpu")
N_PAD = 64
NVE = dict(dt_fs=0.5, thermostat="nve", skin=0.2, precision="exact")
NPT = dict(dt_fs=0.5, thermostat="berendsen", barostat="berendsen", barostat_tau_fs=20.0,
           skin=0.2, precision="exact")
LANGEVIN = dict(dt_fs=0.5, thermostat="langevin", temperature_K=300.0, friction_fs=0.05, skin=0.2)


def _grid_fields(g):
    return (g.nbins, g.capacity, g.edge_hint, g.periodic, g.margin)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: test files run side by side
    in worker processes, and the plain versions are many small ops, which
    several threads per worker only slow down on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = _config(JConfig, jheads, jmodules)
    tcfg = _config(TConfig, theads, tmodules)
    jparams = j_init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jparams, jcfg), (tparams, tcfg)


@pytest.fixture(scope="module")
def systems():
    mol = _box()
    return mol, j_system([mol], build_nbmat=False, n_pad=N_PAD), t_system([mol], CPU, n_pad=N_PAD)


def _velocities(numbers: np.ndarray) -> np.ndarray:
    """Maxwell-Boltzmann velocities at 300 K per compact atom, from numpy."""
    sigma = np.sqrt(constants.kB * 300.0 / constants.get_masses()[numbers])[:, None]
    return (sigma * np.random.default_rng(3).normal(size=(len(numbers), 3))).astype(np.float32)


def _inject(drv, v_compact: np.ndarray, to) -> None:
    """The same compact velocities into a driver's slot layout (keeping the
    driver unprimed, so its first run evaluates the initial forces)."""
    atom_id = np.asarray(drv._state.atom_id)
    real = np.asarray(drv._state.system.numbers) > 0
    v = np.zeros((len(atom_id), 3), np.float32)
    v[real] = v_compact[atom_id[real]]
    drv._state = dataclasses.replace(drv._state, veloc=to(v))


def _pair(models, systems, md: dict, **kw):
    (jparams, jcfg), (tparams, tcfg) = models
    mol, jsys, tsys = systems
    jd = JMDDriver(jparams, jcfg, jsys, JMDConfig(**md), **kw)
    td = MDDriver(tparams, tcfg, tsys, MDConfig(**md), device="cpu", **kw)
    return jd, td


@pytest.fixture(scope="module")
def nve(models, systems, tmp_path_factory):
    jd, td = _pair(models, systems, NVE)
    v0 = _velocities(systems[0]["numbers"])
    _inject(jd, v0, jnp.asarray)
    _inject(td, v0, torch.as_tensor)
    ref0 = td._state.ref_coord
    path = str(tmp_path_factory.mktemp("md") / "nve.extxyz")
    jo = jd.run(10, chunk=5)  # the JAX driver primes through one dt = 0 chunk
    with TrajectoryWriter(path) as w:
        to = td.run(10, chunk=5, traj=w)
    return {"jax": jd, "port": td, "jo": jo, "to": to, "ref0": ref0, "path": path}


def test_grids_match_through_grow_and_shrink(models, systems):
    """Grids equal JAX's at construction, after a forced capacity regrow of
    both layouts and after the shrink-back; the slot layouts too."""
    jd, td = _pair(models, systems, dict(NVE, shrink_patience=1))
    assert _grid_fields(td.grid) == _grid_fields(jd.grid)
    assert _grid_fields(td.lr_grid) == _grid_fields(jd.lr_grid)
    np.testing.assert_array_equal(td._state.atom_id.numpy(), np.asarray(jd._state.atom_id))
    jstate = jd._grow_capacity(jd._state, grow_sr=True, grow_lr=True)
    tstate = td._grow_capacity(td._state, grow_sr=True, grow_lr=True)
    assert td.grid.capacity > td._plan_capacity[0] and td.lr_grid.capacity > td._plan_capacity[1]
    assert (_grid_fields(td.grid), _grid_fields(td.lr_grid)) == (_grid_fields(jd.grid), _grid_fields(jd.lr_grid))
    np.testing.assert_array_equal(tstate.atom_id.numpy(), np.asarray(jstate.atom_id))
    np.testing.assert_array_equal(tstate.system.lr_slot.numpy(), np.asarray(jstate.system.lr_slot))
    jstate = jd._maybe_shrink(jstate)
    tstate = td._maybe_shrink(tstate)
    assert (td.grid.capacity, td.lr_grid.capacity) == td._plan_capacity
    assert (_grid_fields(td.grid), _grid_fields(td.lr_grid)) == (_grid_fields(jd.grid), _grid_fields(jd.lr_grid))
    np.testing.assert_array_equal(tstate.atom_id.numpy(), np.asarray(jstate.atom_id))
    assert tstate.coord.shape == (td.grid.num_slots, 3)


def test_nve_traces_match_jax(nve):
    """10 NVE steps with skin 0.2 that re-bin inside the loop (after the
    sixth): per-step potential energy and temperature."""
    assert nve["port"].rebins >= 1
    assert not torch.equal(nve["port"].state.ref_coord, nve["ref0"])  # the layout was rebuilt
    np.testing.assert_allclose(nve["to"]["epot"], nve["jo"]["epot"], rtol=1e-5)
    np.testing.assert_allclose(nve["to"]["temperature"], nve["jo"]["temperature"], rtol=1e-5)
    assert nve["port"].regrows == 0


def test_nve_final_coordinates_match_jax(nve, systems):
    got, ref = nve["port"].snapshot(), nve["jax"].snapshot()
    np.testing.assert_array_equal(got["numbers"], ref["numbers"])
    np.testing.assert_allclose(got["coord"], ref["coord"], atol=1e-5)
    np.testing.assert_allclose(got["veloc"], ref["veloc"], atol=1e-5)
    n = len(systems[0]["numbers"])
    np.testing.assert_array_equal(got["numbers"][:n], systems[0]["numbers"])


def test_trajectory_frames_in_caller_order(nve, systems):
    frames = read_frames(nve["path"])
    assert len(frames) == 2
    numbers = systems[0]["numbers"]
    for fr in frames:
        np.testing.assert_array_equal(fr["numbers"], numbers)
        np.testing.assert_allclose(fr["cell"], systems[0]["cell"], atol=1e-6)
    assert frames[-1]["step"] == "10"
    snap = nve["port"].snapshot()
    np.testing.assert_allclose(frames[-1]["coord"], snap["coord"][: len(numbers)], atol=1e-6)
    np.testing.assert_allclose(float(frames[-1]["epot_eV"]), nve["to"]["epot"][-1], rtol=1e-6)


def test_trajectory_writer_text_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    frames = [
        (rng.choice([1, 6, 7, 8], size=5), rng.normal(size=(5, 3)) * 5, np.eye(3) * 12.5,
         {"step": 10, "epot_eV": -1.25}),
        (np.array([8, 1, 1]), rng.normal(size=(3, 3)), None, None),
    ]
    paths = []
    for name, cls in (("port", TrajectoryWriter), ("jax", JTrajectoryWriter)):
        paths.append(tmp_path / f"{name}.extxyz")
        with cls(str(paths[-1])) as w:
            for numbers, coord, cell, comment in frames:
                w.write(numbers, coord, cell=cell, comment=comment)
    assert paths[0].read_text() == paths[1].read_text()


def test_berendsen_barostat_matches_jax(models, systems):
    """Berendsen thermostat and barostat: pressure, volume and potential
    traces (the cell's gradient comes through the lattice shifts)."""
    jd, td = _pair(models, systems, NPT)
    v0 = _velocities(systems[0]["numbers"])
    _inject(jd, v0, jnp.asarray)
    _inject(td, v0, torch.as_tensor)
    jo = jd.run(6, chunk=3)
    to = td.run(6, chunk=3)
    assert np.abs(np.diff(to["volume"])).max() > 0  # the box moves
    np.testing.assert_allclose(to["pressure"], jo["pressure"], atol=1e-6)
    np.testing.assert_allclose(to["volume"], jo["volume"], rtol=1e-5)
    np.testing.assert_allclose(to["epot"], jo["epot"], rtol=1e-5)
    np.testing.assert_allclose(to["temperature"], jo["temperature"], rtol=1e-5)
    np.testing.assert_allclose(td.snapshot()["cell"], jd.snapshot()["cell"], rtol=1e-6)


@pytest.fixture(scope="module")
def langevin(models, systems, tmp_path_factory):
    """A Langevin run split by a checkpoint: 6 steps, save, 6 more; then a
    driver of another seed restores the file and runs the same 6."""
    _jm, (tparams, tcfg) = models
    tsys = systems[2]
    md = MDConfig(**LANGEVIN)
    drv_a = MDDriver(tparams, tcfg, tsys, md, seed=11, device="cpu")
    first = drv_a.run(6, chunk=6)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "md.ckpt.npz")
    drv_a.save_checkpoint(ckpt)
    second = drv_a.run(6, chunk=6)
    drv_b = MDDriver(tparams, tcfg, tsys, md, seed=99, device="cpu")  # the seed is overridden
    drv_b.restore_checkpoint(ckpt)
    resumed = drv_b.run(6, chunk=6)
    return {"first": first, "second": second, "resumed": resumed, "ckpt": ckpt}


def test_langevin_holds_temperature(langevin):
    t = np.concatenate([langevin["first"]["temperature"], langevin["second"]["temperature"]])
    assert np.isfinite(t).all()
    assert 120.0 < t.mean() < 600.0  # loose: small system, large fluctuations


def test_checkpoint_resume_continues_trajectory(langevin, models, tmp_path):
    np.testing.assert_allclose(langevin["resumed"]["epot"], langevin["second"]["epot"], atol=2e-4)
    np.testing.assert_allclose(
        langevin["resumed"]["temperature"], langevin["second"]["temperature"], rtol=2e-4, atol=1e-3
    )
    _jm, (tparams, tcfg) = models
    other = t_system([_box(n=50, seed=5)], CPU, n_pad=N_PAD)
    drv_c = MDDriver(tparams, tcfg, other, MDConfig(**LANGEVIN), device="cpu")
    with pytest.raises(ValueError, match="numbers mismatch"):
        drv_c.restore_checkpoint(langevin["ckpt"])
    # a file without the port's generator state (the JAX driver's layout)
    with np.load(langevin["ckpt"]) as d:
        jax_like = {k: d[k] for k in ("coord", "veloc", "numbers", "cell")}
    path = str(tmp_path / "jax_like.npz")
    np.savez(path, key_data=np.zeros(2, np.uint32), **jax_like)
    drv_a = MDDriver(tparams, tcfg, t_system([_box()], CPU, n_pad=N_PAD), MDConfig(**LANGEVIN), device="cpu")
    with pytest.raises(ValueError, match="generator"):
        drv_a.restore_checkpoint(path)


def test_fire_relax_matches_jax(models, systems):
    """10 FIRE steps on a fixed binned layout (the periodic DSF head set)."""
    (jparams, jcfg), (tparams, tcfg) = models
    mol, jsys, tsys = systems
    grid = dataclasses.replace(tB.plan_bins(mol["cell"], len(mol["numbers"]), 5.6), margin=0.6)
    lr_grid = tB.plan_lr_bins(mol["cell"], len(mol["numbers"]), 15.0, margin=0.6)
    tsysb, _perm, ovf = tB.to_binned_system(tsys, grid, lr_grid)
    assert not ovf.any()
    jgrid = jB.BinGrid(*_grid_fields(grid))
    jlr = jB.BinGrid(*_grid_fields(lr_grid))
    jsysb, _jperm, _jovf = jB.to_binned_system(jsys, jgrid, jlr)
    relaxed, info = fire_relax(tparams, theads.auto_switch_simple_to_dsf(tcfg), tsysb, fmax=0.0, max_steps=10)
    jrelaxed, jinfo = j_fire(jparams, jheads.auto_switch_simple_to_dsf(jcfg), jsysb, fmax=0.0, max_steps=10)
    assert info["steps"] == jinfo["steps"] == 10
    real = tsysb.numbers.numpy() > 0
    moved = np.abs(relaxed.coord.numpy() - tsysb.coord.numpy())[real].max()
    assert moved > 1e-3
    np.testing.assert_allclose(relaxed.coord.numpy()[real], np.asarray(jrelaxed.coord)[real], atol=1e-5)
    np.testing.assert_allclose(info["fmax"], jinfo["fmax"], rtol=1e-4)


def test_unported_paths_raise(models, systems, monkeypatch):
    """What the port's driver refuses raises: members whose AEV constants
    disagree on the fused ensemble path (JAX's ``ValueError``), an unknown
    precision and a missing card.  Ensembles, which raised before they were
    ported, build on stacked members (tests/test_torch_ensemble_md.py
    holds their trajectories to JAX's); gas-phase systems and
    ``engine="indexed"`` run in the trajectory tests below; Ewald attaches
    its discretisation and sizes the LR grid by its real-space cutoff
    (tests/test_torch_ewald.py runs it)."""
    from aimnetcentral_tpu_torch.calculators import stack_params

    _jm, (tparams, tcfg) = models
    tsys = systems[2]
    stacked = stack_params([tparams, tparams])
    monkeypatch.setenv("AIMNET_ENSEMBLE_FUSED", "1")
    drv = MDDriver(stacked, tcfg, tsys, MDConfig(), ensemble=True, device="cpu")
    assert drv.ensemble and drv.ensemble_fused and drv.params["afv"]["weight"].shape[0] == 2
    odd = {**stacked, "aev": {**stacked["aev"], "rc_s": stacked["aev"]["rc_s"] * torch.tensor([1.0, 1.1])}}
    with pytest.raises(ValueError, match="AEV constant 'rc_s'"):
        MDDriver(odd, tcfg, tsys, MDConfig(), ensemble=True, device="cpu")
    ewald = dataclasses.replace(
        tcfg, outputs=tuple(
            (n, dataclasses.replace(h, method="ewald") if isinstance(h, theads.LRCoulombHead) else h)
            for n, h in tcfg.outputs
        ),
    )
    drv = MDDriver(tparams, ewald, tsys, MDConfig(), device="cpu")
    assert drv._ewald_rc == drv._state.system.ewald_r_static and drv._lr_cutoff() == drv._ewald_rc
    with pytest.raises(ValueError, match="precision"):
        MDDriver(tparams, tcfg, tsys, MDConfig(precision="f32x3"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MDDriver(tparams, tcfg, tsys, MDConfig())


# -- the cell lists ------------------------------------------------------------


def _padded(coord, numbers, pad=1):
    coord = np.concatenate([coord, np.full((pad, 3), 1e3, np.float32)]).astype(np.float32)
    return coord, np.concatenate([numbers, np.zeros(pad, np.int64)])


def _cell_list_case(name: str):
    """The five cases of tests/test_cell_list.py: ``(coord, numbers, plan
    args, plan kwargs, cell)``."""
    rng = np.random.default_rng(0)
    if name == "gas":
        c, z = _padded(rng.uniform(0, 12, size=(60, 3)), np.full(60, 6))
        return c, z, (None, 60, 4.0), {"extent": 13.0}, None
    if name in ("periodic", "wrapped"):
        n, a = (40, 10.0) if name == "periodic" else (20, 8.0)
        lo, hi = (0.0, a) if name == "periodic" else (-a, 2 * a)
        c, z = _padded(rng.uniform(lo, hi, size=(n, 3)), np.full(n, 6))
        cell = np.eye(3, dtype=np.float32) * a
        return c, z, (cell, n, 3.0), {}, cell
    if name == "overflow":
        c, z = _padded(rng.uniform(0, 2.0, size=(30, 3)), np.full(30, 6))
        return c, z, (None, 30, 3.0), {"extent": 3.0, "max_neighbors": 4}, None
    coord = np.ones((16, 3), np.float32)  # several padding rows
    coord[:3] = [[0, 0, 0.119], [0, 0.763, -0.477], [0, -0.763, -0.477]]
    numbers = np.zeros(16, np.int64)
    numbers[:3] = [8, 1, 1]
    return coord, numbers, (None, 3, 6.0), {"extent": 3.5}, None


@pytest.mark.parametrize("name", ["gas", "periodic", "wrapped", "overflow", "padding"])
def test_build_cell_list_matches_jax(name):
    """The plan, every row of ``nbmat`` (JAX's order), the shifts and the
    overflow count equal JAX's; padding rows are never neighbors."""
    coord, numbers, args, kw, cell = _cell_list_case(name)
    jspec, tspec = jcl.plan_cell_list(*args, **kw), tcl.plan_cell_list(*args, **kw)
    assert dataclasses.astuple(tspec) == dataclasses.astuple(jspec)
    jnb, jsh, jovf = jcl.build_cell_list(jnp.asarray(coord), jnp.asarray(numbers), jspec,
                                         cell=None if cell is None else jnp.asarray(cell))
    tnb, tsh, tovf = tcl.build_cell_list(torch.as_tensor(coord), torch.as_tensor(numbers), tspec,
                                         cell=None if cell is None else torch.as_tensor(cell))
    assert tnb.dtype == torch.int64
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))
    assert (tsh is None) == (jsh is None) == (cell is None)
    if tsh is not None:
        np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))
    assert int(tovf) == int(jovf)
    assert (int(tovf) > 0) == (name == "overflow")
    real = numbers > 0
    assert set(tnb.numpy()[real].ravel().tolist()) <= set(np.flatnonzero(real).tolist()) | {len(coord) - 1}


def test_build_cell_list_is_deterministic():
    """Repeats bit for bit under ``torch.use_deterministic_algorithms``."""
    coord, numbers, args, kw, cell = _cell_list_case("wrapped")
    spec = tcl.plan_cell_list(*args, **kw)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = [tcl.build_cell_list(torch.as_tensor(coord), torch.as_tensor(numbers), spec, torch.as_tensor(cell))
                for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(prev)
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)


# -- the indexed engine and gas-phase MD ----------------------------------------


def _coulomb(cfg, heads, **kw):
    return dataclasses.replace(cfg, outputs=tuple(
        (n, dataclasses.replace(h, **kw) if isinstance(h, heads.LRCoulombHead) else h) for n, h in cfg.outputs))


# name -> (periodic box, engine, Coulomb head fields): the box's DSF cutoff
# at 8 A keeps its LR cell list (8 + lr_skin) inside the 12 A cell
ENGINES = {
    "indexed-gas": (False, "indexed", {}),
    "indexed-periodic": (True, "indexed", {"dsf_rc": 8.0}),
    "binned-gas": (False, "binned", {"method": "dsf"}),
}
NVE_IDX = dict(NVE, lr_skin=0.5)


@pytest.fixture(scope="module")
def engine_runs(models):
    """10 NVE steps of both drivers on each of ``ENGINES``, chunks of 5 (each
    rebuilds its layout after the sixth)."""
    (jparams, jcfg), (tparams, tcfg) = models
    out = {}
    for name, (periodic, engine, coulomb) in ENGINES.items():
        mol = _box() if periodic else _cluster(40, seed=2)
        jc, tc = _coulomb(jcfg, jheads, **coulomb), _coulomb(tcfg, theads, **coulomb)
        jd = JMDDriver(jparams, jc, j_system([mol], build_nbmat=False, n_pad=N_PAD), JMDConfig(**NVE_IDX),
                       engine=engine)
        td = MDDriver(tparams, tc, t_system([mol], CPU, n_pad=N_PAD), MDConfig(**NVE_IDX), engine=engine,
                      device="cpu")
        v0 = _velocities(mol["numbers"])
        _inject(jd, v0, jnp.asarray)
        _inject(td, v0, torch.as_tensor)
        ref0 = td._state.ref_coord
        out[name] = {"jax": jd, "port": td, "jo": jd.run(10, chunk=5), "to": td.run(10, chunk=5), "ref0": ref0,
                     "mol": mol}
    return out


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_trajectories_match_jax(engine_runs, name):
    """Per-step potential energy and temperature, final coordinates and
    velocities in the caller's order; the layout was rebuilt inside the
    run, and the indexed lists are JAX's row for row."""
    run = engine_runs[name]
    td, jd = run["port"], run["jax"]
    assert td.engine == jd.engine == ENGINES[name][1]
    assert td.rebins >= 1 and not torch.equal(td.state.ref_coord, run["ref0"])
    np.testing.assert_allclose(run["to"]["epot"], run["jo"]["epot"], rtol=1e-5)
    np.testing.assert_allclose(run["to"]["temperature"], run["jo"]["temperature"], rtol=1e-5)
    got, ref = td.snapshot(), jd.snapshot()
    np.testing.assert_array_equal(got["numbers"], ref["numbers"])
    np.testing.assert_allclose(got["coord"], ref["coord"], atol=1e-5)
    np.testing.assert_allclose(got["veloc"], ref["veloc"], atol=1e-5)
    assert ("cell" in got) == ("cell" in ref) == ENGINES[name][0]
    if td.engine == "indexed":
        assert td.grid is None and td.state.system.bins is None
        np.testing.assert_array_equal(td.state.atom_id.numpy(), np.arange(N_PAD))
        for s in ("", "_lr"):
            np.testing.assert_array_equal(getattr(td.state.system, f"nbmat{s}").numpy(),
                                          np.asarray(getattr(jd.state.system, f"nbmat{s}")))
    else:
        assert _grid_fields(td.grid) == _grid_fields(jd.grid) and not td.grid.periodic


def test_indexed_overflow_raises(models):
    """An indexed engine whose lists overflow raises ``RuntimeError``: at
    construction, and in a run (its list shapes are fixed)."""
    _jm, (tparams, tcfg) = models
    tsys = t_system([_cluster(40, seed=2)], CPU, n_pad=N_PAD)
    drv = MDDriver(tparams, tcfg, tsys, MDConfig(**NVE_IDX), device="cpu")
    drv.sr_spec = dataclasses.replace(drv.sr_spec, max_neighbors=2)
    with pytest.raises(RuntimeError, match="indexed engine"):
        drv.run(20, chunk=20)
    with pytest.raises(RuntimeError, match="overflow at initialization"):
        drv._rebuild_indexed(tsys)


def test_indexed_checkpoint_resumes(models, tmp_path):
    """A gas-phase Langevin run on the indexed engine split by a checkpoint:
    a driver of another seed restores the file and runs the same steps."""
    _jm, (tparams, tcfg) = models
    tsys = t_system([_cluster(40, seed=2)], CPU, n_pad=N_PAD)
    md = MDConfig(**dict(LANGEVIN, lr_skin=0.5))
    drv_a = MDDriver(tparams, tcfg, tsys, md, seed=11, device="cpu")
    drv_a.run(4, chunk=4)
    ckpt = str(tmp_path / "gas.ckpt.npz")
    drv_a.save_checkpoint(ckpt)
    with np.load(ckpt) as d:
        assert "cell" not in d.files
    second = drv_a.run(4, chunk=4)
    drv_b = MDDriver(tparams, tcfg, tsys, md, seed=99, device="cpu")
    drv_b.restore_checkpoint(ckpt)
    resumed = drv_b.run(4, chunk=4)
    assert drv_b.engine == "indexed"
    np.testing.assert_allclose(resumed["epot"], second["epot"], atol=2e-4)
    np.testing.assert_allclose(resumed["temperature"], second["temperature"], rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(drv_b.snapshot()["coord"], drv_a.snapshot()["coord"], atol=1e-5)


def test_indexed_plan_grows_where_jax_overflows(models):
    """A compact 113-atom cluster: the JAX driver's gas-phase plan (density
    over the extent's cube) overflows its SR list at construction and
    raises; the port re-plans until the lists hold it, and its first forces
    are JAX's calculator's on the same molecule (1e-5)."""
    (jparams, jcfg), (tparams, tcfg) = models
    mol = _cluster(113, seed=7)
    n_pad = 128
    with pytest.raises(RuntimeError, match="overflow at initialization"):
        JMDDriver(jparams, jcfg, j_system([mol], build_nbmat=False, n_pad=n_pad), JMDConfig(**NVE_IDX))
    drv = MDDriver(tparams, tcfg, t_system([mol], CPU, n_pad=n_pad), MDConfig(**NVE_IDX), device="cpu")
    extent = float((mol["coord"].max(0) - mol["coord"].min(0)).max()) + 2.0
    first = tcl.plan_cell_list(None, 113, drv.sr_spec.cutoff, extent=extent)
    assert drv.engine == "indexed" and drv.sr_spec.max_neighbors > first.max_neighbors
    ref = JCalculator((jparams, jcfg), binned_threshold=10**9).eval(mol, forces=True)
    st = drv.state
    np.testing.assert_allclose(st.epot.numpy(), ref["energy"], rtol=1e-5)
    np.testing.assert_allclose(st.forces.numpy()[:113], ref["forces"], atol=1e-5)


def test_indexed_md_truncates_simple_coulomb_as_jax(models):
    """Simple Coulomb on the indexed engine reads the LR list, built at
    dsf_rc + lr_skin (16 A): a 26 A chain loses its far pairs in MD, as in
    the JAX driver (a fault shared with the reference; ROADMAP.md), while
    the calculator sums every pair.  The port's MD energy and forces are
    JAX's MD ones."""
    (jparams, jcfg), (tparams, tcfg) = models
    rng = np.random.default_rng(4)
    coord = np.zeros((14, 3), np.float32)
    coord[:, 0] = 2.0 * np.arange(14)
    coord[:, 1:] = rng.uniform(-0.2, 0.2, size=(14, 2))
    mol = {"coord": coord, "numbers": rng.choice([1, 6, 7, 8], size=14)}
    md = dict(NVE)  # lr_skin 1.0: the LR list at 16 A
    jd = JMDDriver(jparams, jcfg, j_system([mol], build_nbmat=False, n_pad=16), JMDConfig(**md))
    td = MDDriver(tparams, tcfg, t_system([mol], CPU, n_pad=16), MDConfig(**md), device="cpu")
    np.testing.assert_allclose(td.state.epot.numpy(), np.asarray(jd.state.epot), rtol=1e-5)
    np.testing.assert_allclose(td.state.forces.numpy(), np.asarray(jd.state.forces), atol=1e-5)
    full = JCalculator((jparams, jcfg), binned_threshold=10**9).eval(mol)["energy"]
    assert abs(float(td.state.epot[0]) - float(full[0])) > 1e-4  # the far pairs are missing
