"""The port's command line (aimnetcentral_tpu_torch/cli.py) against the JAX
package's (CPU).

JAX's tests/test_cli.py serving journeys, each run through click's test
runner on both packages with the same JAX-exported artifacts (JAX's tiny
config, seeds 0 and 1), the port under ``--device cpu``; the printed
numbers are compared between them: energies 1e-5 eV (plus the printed
rounding), forces 1e-5 eV/A, frequencies from Hessians within 1e-4.  MD is
compared at ``--thermostat nve --temperature 0``, where neither package
draws random numbers; the Langevin runs draw from different generators and
are checked for their keys and finiteness only.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from click.testing import CliRunner  # noqa: E402

from aimnetcentral_tpu import cli as jcli  # noqa: E402
from aimnetcentral_tpu.models import aimnet2 as jaimnet2  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init  # noqa: E402
from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu.models import modules as jmodules  # noqa: E402
from aimnetcentral_tpu.train.export import export_model  # noqa: E402
from aimnetcentral_tpu_torch import cli as tcli  # noqa: E402

WATER = "3\n\nO 0 0 0.119\nH 0 0.763 -0.477\nH 0 -0.763 -0.477\n"
PRODUCT = "3\n\nO 0 0 0.119\nH 0 0.963 0.1\nH 0 -0.963 0.1\n"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg(aimnet2=jaimnet2, heads=jheads, modules=jmodules):
    """JAX's tests/test_cli.py model in either package's classes."""
    return aimnet2.AIMNet2Config(
        aev=aimnet2.AEVConfig(rc_s=5.0, nshifts_s=8),
        nfeature=4,
        d2features=True,
        ncomb_v=4,
        hidden=((16,), (16,), (16,)),
        aim_size=16,
        outputs=(
            ("energy_mlp", heads.OutputHead(n_in=16, n_out=1, key_in="aim", key_out="energy",
                                            mlp=modules.MLPSpec(hidden=(8,), last_linear=True))),
            ("atomic_shift", heads.AtomicShiftHead(key_in="energy", key_out="energy")),
            ("atomic_sum", heads.AtomicSumHead(key_in="energy", key_out="energy")),
        ),
    )


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Two tiny artifacts written by JAX's exporter, a water xyz, a second
    endpoint for NEB and a small periodic box as CIF."""
    d = tmp_path_factory.mktemp("cli")
    cfg = _tiny_cfg()
    paths = []
    for i in range(2):
        p = str(d / f"m{i}.pt")
        export_model(aimnet2_init(jax.random.key(i), cfg), cfg, p, sae={1: -13.6, 8: -2042.6},
                     implemented_species=[1, 8])
        paths.append(p)
    files = {}
    for name, text in (("water.xyz", WATER), ("product.xyz", PRODUCT), ("box.cif", _box_cif())):
        files[name] = str(d / name)
        with open(files[name], "w") as f:
            f.write(text)
    return d, paths, files


def _box_cif(a=6.0, n=9, seed=4):
    """A cubic P1 cell of water-like H and O on a jittered grid."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)[:n]
    frac = (grid + 0.5 + rng.uniform(-0.1, 0.1, size=(n, 3))) / 3.0
    lines = ["data_box", f"_cell_length_a {a}", f"_cell_length_b {a}", f"_cell_length_c {a}",
             "_cell_angle_alpha 90", "_cell_angle_beta 90", "_cell_angle_gamma 90", "loop_",
             "_atom_site_type_symbol", "_atom_site_fract_x", "_atom_site_fract_y", "_atom_site_fract_z"]
    lines += [f"{'O' if k % 3 == 0 else 'H'} {x:.6f} {y:.6f} {z:.6f}" for k, (x, y, z) in enumerate(frac)]
    return "\n".join(lines) + "\n"


def _invoke(pkg, args):
    if pkg == "jax":
        return CliRunner().invoke(jcli.cli, args)
    return CliRunner().invoke(tcli.cli, ["--device", "cpu", *args])


def _run(pkg, args):
    r = _invoke(pkg, args)
    assert r.exit_code == 0, (pkg, args, r.output, r.exception)
    return r.output


def _both(args):
    return {pkg: _run(pkg, args) for pkg in ("jax", "torch")}


def _json(out):
    return json.loads(out.strip().splitlines()[-1])


def _energy(out):
    return float(out.split("energy (eV):")[1].split()[0])


def _sp_numbers(out):
    """energy, charges, max |force|, stress (if printed) of sp's output."""
    lines = {ln.split(":")[0]: ln.split(":", 1)[1] for ln in out.strip().splitlines()}
    res = {"energy": _energy(out), "charges": np.array(json.loads(lines["charges"]))}
    if "max |force| (eV/A)" in lines:
        res["fmax"] = float(lines["max |force| (eV/A)"])
    if "stress (eV/A^3)" in lines:
        res["stress"] = np.array(json.loads(lines["stress (eV/A^3)"]))
    return res


def _assert_sp_match(out):
    got, ref = _sp_numbers(out["torch"]), _sp_numbers(out["jax"])
    assert set(got) == set(ref)
    assert abs(got["energy"] - ref["energy"]) <= 1e-5 + 1e-6
    np.testing.assert_allclose(got["charges"], ref["charges"], rtol=0, atol=1e-4 + 1e-5)  # printed to 4 places
    if "fmax" in ref:
        assert abs(got["fmax"] - ref["fmax"]) <= 1e-5 + 1e-6
    if "stress" in ref:
        np.testing.assert_allclose(got["stress"], ref["stress"], rtol=0, atol=1e-6 + 1e-6)
    return got


def test_cli_sp(workspace):
    _d, paths, files = workspace
    out = _both(["sp", paths[0], files["water.xyz"]])
    assert "energy (eV):" in out["torch"] and "charges:" in out["torch"] and "force" in out["torch"]
    assert np.isfinite(_assert_sp_match(out)["energy"])


def test_cli_sp_periodic_cif(workspace):
    """A CIF is read with its cell: stress is printed."""
    _d, paths, files = workspace
    out = _both(["sp", paths[0], files["box.cif"]])
    assert "stress (eV/A^3)" in out["torch"]
    _assert_sp_match(out)


def test_cli_sp_no_forces(workspace):
    _d, paths, files = workspace
    out = _both(["sp", paths[1], files["water.xyz"], "--no-forces", "--charge", "0"])
    assert "force" not in out["torch"]
    _assert_sp_match(out)


def test_cli_sp_ensemble_member_list(workspace):
    _d, paths, files = workspace
    out = _both(["sp", ",".join(paths), files["water.xyz"], "--ensemble"])
    means, stds = {}, {}
    for pkg, text in out.items():
        assert "ensemble spread" in text
        e, std = text.split("energy (eV):")[1].split("+/-")
        means[pkg], stds[pkg] = float(e), float(std.split()[0])
        assert stds[pkg] > 0  # members of different seeds
    assert abs(means["torch"] - means["jax"]) <= 1e-5 + 1e-6
    assert abs(stds["torch"] - stds["jax"]) <= 1e-5 + 1e-6
    # the ensemble mean is the mean of the two single-model energies
    singles = [_energy(_run("torch", ["sp", p, files["water.xyz"]])) for p in paths]
    assert means["torch"] == pytest.approx(np.mean(singles), abs=1e-4)


def test_cli_sp_fast_precision(workspace):
    _d, paths, files = workspace
    out = _both(["sp", paths[0], files["water.xyz"], "--precision", "fast"])
    _assert_sp_match(out)
    # on the CPU the tiers give the same numbers
    assert _energy(out["torch"]) == _energy(_run("torch", ["sp", paths[0], files["water.xyz"]]))


def test_cli_md_nve_matches_jax(workspace):
    """Zero-temperature NVE: no random numbers in either package."""
    _d, paths, files = workspace
    args = ["md", paths[0], files["water.xyz"], "--steps", "20", "--chunk", "10", "--thermostat", "nve",
            "--temperature", "0", "--precision", "balanced"]
    res = {pkg: _json(text) for pkg, text in _both(args).items()}
    assert set(res["torch"]) == set(res["jax"]) and res["torch"]["steps"] == 20
    assert abs(res["torch"]["final_epot_eV"] - res["jax"]["final_epot_eV"]) <= 1e-5
    assert res["torch"]["mean_T_K"] == pytest.approx(res["jax"]["mean_T_K"], rel=1e-3, abs=1e-3)


def test_cli_md_npt_guard(workspace):
    """NPT without a cell is a usage error in both, not a crash."""
    _d, paths, files = workspace
    for pkg in ("jax", "torch"):
        r = _invoke(pkg, ["md", paths[0], files["water.xyz"], "--pressure-gpa", "1.0"])
        assert r.exit_code == 2 and "requires --cell" in (r.output or ""), (pkg, r.output)


def test_cli_md_langevin_trajectory(workspace, tmp_path):
    """Langevin MD writes its trajectory; the two packages draw different
    numbers, so only the keys and the frame count are compared."""
    _d, paths, files = workspace
    res = {}
    for pkg in ("jax", "torch"):
        traj = str(tmp_path / f"{pkg}.extxyz")
        res[pkg] = _json(_run(pkg, ["md", paths[0], files["water.xyz"], "--steps", "10", "--chunk", "5",
                                    "--traj", traj]))
        assert np.isfinite(res[pkg]["final_epot_eV"]) and np.isfinite(res[pkg]["mean_T_K"])
        with open(traj) as fh:
            assert fh.read().count("Properties=") == res[pkg]["traj_frames"]
    assert set(res["torch"]) == set(res["jax"]) and res["torch"]["traj_frames"] == res["jax"]["traj_frames"]


def test_cli_md_ensemble_and_checkpoint(workspace, tmp_path):
    _d, paths, files = workspace
    keys = {}
    for pkg in ("jax", "torch"):
        ck = str(tmp_path / f"{pkg}.ckpt")
        res = _json(_run(pkg, ["md", ",".join(paths), files["water.xyz"], "--steps", "10", "--chunk", "5",
                               "--ensemble", "--save-ckpt", ck]))
        assert res["steps"] == 10 and np.isfinite(res["final_epot_eV"])
        assert res["final_epot_std_eV"] > 0 and os.path.exists(ck)
        res2 = _json(_run(pkg, ["md", ",".join(paths), files["water.xyz"], "--steps", "5", "--chunk", "5",
                                "--ensemble", "--restore-ckpt", ck]))
        assert np.isfinite(res2["final_epot_eV"])
        keys[pkg] = (set(res), set(res2))
    assert keys["torch"] == keys["jax"]


def test_cli_md_periodic_cell(workspace):
    """``--cell``: a periodic box through the binned engine, NVE at zero
    temperature in both packages."""
    _d, paths, files = workspace
    args = ["md", paths[0], files["water.xyz"], "--steps", "4", "--chunk", "2", "--thermostat", "nve",
            "--temperature", "0", "--precision", "exact", "--cell", "9.0"]
    res = {pkg: _json(text) for pkg, text in _both(args).items()}
    assert abs(res["torch"]["final_epot_eV"] - res["jax"]["final_epot_eV"]) <= 1e-5


def test_md_takes_the_calculators_binned_box():
    """What ``md`` hands to MDDriver: for a box at or above
    ``binned_threshold`` ``prepare_system`` gives a binned System, which
    both drivers bin again at their own skin; zero-temperature NVE from it
    gives JAX's energies, and the compact System's."""
    from aimnetcentral_tpu.calculators import AIMNet2Calculator as JCalculator
    from aimnetcentral_tpu.dynamics import MDConfig as JMD
    from aimnetcentral_tpu.dynamics import MDDriver as JDriver
    from aimnetcentral_tpu_torch.builders import system_from_molecules
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator
    from aimnetcentral_tpu_torch.dynamics import MDConfig as TMD
    from aimnetcentral_tpu_torch.dynamics import MDDriver as TDriver
    from aimnetcentral_tpu_torch.models import aimnet2 as taimnet2
    from aimnetcentral_tpu_torch.models import heads as theads
    from aimnetcentral_tpu_torch.models import modules as tmodules
    from aimnetcentral_tpu_torch.models.bridge import params_from_numpy

    jcfg, tcfg = _tiny_cfg(), _tiny_cfg(taimnet2, theads, tmodules)
    jparams = aimnet2_init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    a = 8.0
    grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)[:24]
    coord = ((grid + 0.5) * a / 3 + rng.uniform(-0.2, 0.2, size=(24, 3))).astype(np.float32)
    box = {"coord": coord, "numbers": np.resize([8, 1, 1], 24), "cell": np.eye(3, dtype=np.float32) * a}
    md = dict(dt_fs=0.5, temperature_K=0.0, thermostat="nve")
    jcalc = JCalculator((jparams, jcfg, {"sae": {}}), binned_threshold=0)
    tcalc = TCalculator((tparams, tcfg, {"sae": {}}), device="cpu", binned_threshold=0)
    jsys, tsys = jcalc.prepare_system(dict(box)), tcalc.prepare_system(dict(box))
    assert tcalc._prep_cache["kind"] == "binned" and tsys.bins is not None and jsys.bins is not None
    assert tuple(tsys.coord.shape) == tuple(jsys.coord.shape)  # the same slots
    ref = JDriver(jparams, jcalc.cfg, jsys, JMD(**md)).run(3, chunk=3)
    drv = TDriver(tcalc.params, tcalc.cfg, tsys, TMD(**md), device="cpu")
    got = drv.run(3, chunk=3)
    assert drv.grid is not None and drv.state.system.bins == drv.grid  # binned again at the driver's skin
    np.testing.assert_allclose(got["epot"], ref["epot"], rtol=0, atol=1e-5)
    compact = system_from_molecules([box], "cpu", n_pad=32)
    again = TDriver(tcalc.params, tcalc.cfg, compact, TMD(**md), device="cpu").run(3, chunk=3)
    np.testing.assert_allclose(got["epot"], again["epot"], rtol=0, atol=1e-5)


def test_cli_relax(workspace):
    _d, paths, files = workspace
    res = {pkg: _json(text) for pkg, text in
           _both(["relax", paths[0], files["water.xyz"], "--max-steps", "20", "--fmax", "0.5"]).items()}
    assert set(res["torch"]) == set(res["jax"]) == {"steps", "fmax", "converged"}
    assert res["torch"]["steps"] == res["jax"]["steps"]
    assert res["torch"]["converged"] == res["jax"]["converged"]
    assert abs(res["torch"]["fmax"] - res["jax"]["fmax"]) <= 1e-4


def test_cli_neb(workspace, tmp_path):
    """Reactant and product in, a JSON barrier summary and an extxyz band out."""
    _d, paths, files = workspace
    res = {}
    for pkg in ("jax", "torch"):
        band = str(tmp_path / f"band-{pkg}.extxyz")
        res[pkg] = _json(_run(pkg, ["neb", paths[0], files["water.xyz"], files["product.xyz"], "--n-images", "5",
                                    "--max-steps", "10", "--fmax", "0.5", "--band", band]))
        info = res[pkg]
        assert info["n_images"] == 5 and info["steps"] > 0 and 1 <= info["i_ts"] <= 3
        assert len(info["energies_rel_eV"]) == 5 and info["energies_rel_eV"][0] == 0.0
        with open(band) as fh:
            assert fh.read().count("image=") == 5 and info["band"] == band
    got, ref = res["torch"], res["jax"]
    assert (got["steps"], got["i_ts"], got["converged"]) == (ref["steps"], ref["i_ts"], ref["converged"])
    for k in ("barrier_eV", "reaction_energy_eV", "fmax"):
        assert abs(got[k] - ref[k]) <= 1e-4, k
    np.testing.assert_allclose(got["energies_rel_eV"], ref["energies_rel_eV"], rtol=0, atol=1e-4)


def test_cli_freq(workspace):
    _d, paths, files = workspace
    res = {pkg: _json(text) for pkg, text in _both(["freq", paths[0], files["water.xyz"], "--n-modes", "6"]).items()}
    assert set(res["torch"]) == set(res["jax"])
    assert res["torch"]["n_imaginary"] == res["jax"]["n_imaginary"]
    assert len(res["torch"]["lowest_cm1"]) == 6 and all(np.isfinite(res["torch"]["lowest_cm1"]))
    # a Hessian within 1e-4 moves a frequency by about (1e-4 / 2 H) of itself
    np.testing.assert_allclose(res["torch"]["lowest_cm1"][3:], res["jax"]["lowest_cm1"][3:], rtol=1e-4, atol=0.02)
    assert res["torch"]["highest_cm1"] == pytest.approx(res["jax"]["highest_cm1"], rel=1e-4, abs=0.02)


def test_cli_freq_ir_thermo(workspace):
    _d, paths, files = workspace
    res = {pkg: _json(text) for pkg, text in
           _both(["freq", paths[0], files["water.xyz"], "--ir", "--thermo", "--symmetry-number", "2"]).items()}
    got, ref = res["torch"], res["jax"]
    assert "ir_km_mol" in got and len(got["ir_km_mol"]) == len(ref["ir_km_mol"]) >= 3
    assert all(np.isfinite(v) and v >= 0 for v in got["ir_km_mol"])
    # the six projected null modes span a degenerate space (any basis of it
    # will do), so the intensities are compared on the 3N - 6 vibrations
    np.testing.assert_allclose(got["ir_km_mol"][6:], ref["ir_km_mol"][6:], rtol=1e-3, atol=2e-3)
    assert set(got["thermo"]) == set(ref["thermo"])
    th = got["thermo"]
    assert th["zpe"] >= 0.0
    assert abs(th["g"] - (th["h"] - th["temperature"] * th["s"])) < 1e-3
    for k, v in ref["thermo"].items():
        if isinstance(v, float):
            assert th[k] == pytest.approx(v, rel=1e-4, abs=2e-6), k
        else:
            assert th[k] == v, k


def test_cli_info(workspace):
    out = {pkg: _run(pkg, ["info"]) for pkg in ("jax", "torch")}
    text = out["torch"]
    assert text.startswith("aimnetcentral_tpu_torch ") and f"torch {torch.__version__}" in text
    assert f"cuda available: {torch.cuda.is_available()}" in text and "device: cpu" in text
    assert "kernels built under" in text and "model cache:" in text
    count = {pkg: int(t.split("registry models:")[1].split()[0]) for pkg, t in out.items()}
    assert count["torch"] == count["jax"] > 0


def test_cli_clear_model_cache(tmp_path, monkeypatch):
    for pkg in ("jax", "torch"):
        cache = tmp_path / pkg
        cache.mkdir()
        (cache / "stale.pt").write_bytes(b"x")
        monkeypatch.setenv("AIMNET_CACHE_DIR", str(cache))
        assert _run(pkg, ["clear-model-cache"]).strip() == "model cache cleared"
        assert not (cache / "stale.pt").exists()


def test_cli_download_prints_the_path(monkeypatch):
    """``download`` echoes what the registry's download_model returns (no
    network here: both registries' function is replaced)."""
    from aimnetcentral_tpu.calculators import registry as jregistry
    from aimnetcentral_tpu_torch.calculators import registry as tregistry

    for mod in (jregistry, tregistry):
        monkeypatch.setattr(mod, "download_model", lambda name: f"/cache/{name}.pt")
    out = _both(["download", "aimnet2"])
    assert out["torch"] == out["jax"] == "/cache/aimnet2.pt\n"


def test_cli_unknown_registry_name_fails_as_jax(workspace):
    _d, _paths, files = workspace
    r = {pkg: _invoke(pkg, ["sp", "no-such-model", files["water.xyz"]]) for pkg in ("jax", "torch")}
    assert r["torch"].exit_code != 0 and r["jax"].exit_code != 0
    assert type(r["torch"].exception) is type(r["jax"].exception)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_cli_needs_a_card_or_the_cpu(workspace):
    """Without a card the group fails as resolve_device does, unless
    ``--device cpu`` is given; it never falls back to the CPU."""
    _d, paths, files = workspace
    r = CliRunner().invoke(tcli.cli, ["sp", paths[0], files["water.xyz"]])
    assert r.exit_code != 0 and isinstance(r.exception, RuntimeError) and "no CUDA device" in str(r.exception)


def test_command_bodies_run_without_click(workspace):
    """The plain bodies return what the commands print."""
    _d, paths, files = workspace
    lines = tcli.run_sp(paths[0], files["water.xyz"], device="cpu")
    assert "\n".join(lines) + "\n" == _run("torch", ["sp", paths[0], files["water.xyz"]])
    info = tcli.run_relax(paths[0], files["water.xyz"], fmax=0.5, max_steps=20, device="cpu")
    assert json.dumps(info) == _run("torch", ["relax", paths[0], files["water.xyz"], "--max-steps", "20",
                                              "--fmax", "0.5"]).strip()
    with pytest.raises(tcli.UsageError, match="requires --cell"):
        tcli.run_md(paths[0], files["water.xyz"], pressure_gpa=1.0, device="cpu")


def _tool_validate_torch():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "validate_torch.py")
    spec = importlib.util.spec_from_file_location("validate_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_drivers_get_the_calculators_parameters(workspace, monkeypatch):
    """relax, md and neb hand the drivers the calculator's own parameters
    (on its device), not the loader's CPU tensors."""
    import importlib

    import aimnetcentral_tpu_torch.dynamics as tdyn

    tneb = importlib.import_module("aimnetcentral_tpu_torch.dynamics.neb")  # the package exports neb()

    _d, paths, files = workspace
    tvalidate = _tool_validate_torch()
    seen = []
    real_calc = tcli._load_calc

    def load(*a, **kw):
        calc, loaded = real_calc(*a, **kw)
        # with the artifact's own metadata the calculator's tree holds the
        # loader's numbers (JAX's drivers get the loader's tree; the rows
        # of species outside the artifact's are NaN in both)
        flat = tvalidate._flatten
        for x, y in zip(flat(loaded.params), flat(calc.params), strict=True):
            torch.testing.assert_close(y.cpu(), x, rtol=0, atol=0, equal_nan=True)
        seen.append(calc)
        return calc, loaded

    def spy(fn):
        def wrapped(params, *a, **kw):
            assert params is seen[-1].params
            return fn(params, *a, **kw)
        return wrapped

    monkeypatch.setattr(tcli, "_load_calc", load)
    monkeypatch.setattr(tdyn, "fire_relax", spy(tdyn.fire_relax))
    monkeypatch.setattr(tdyn, "MDDriver", spy(tdyn.MDDriver))
    monkeypatch.setattr(tneb, "neb", spy(tneb.neb))
    tcli.run_relax(paths[0], files["water.xyz"], max_steps=1, device="cpu")
    tcli.run_md(paths[0], files["water.xyz"], steps=1, chunk=1, thermostat="nve", device="cpu")
    tcli.run_neb(paths[0], files["water.xyz"], files["product.xyz"], n_images=3, max_steps=1, device="cpu")
    assert len(seen) == 3
