"""The port's ASE and PySisyphus adapters against the JAX package's (CPU).

JAX's tests/test_ase_adapter.py, each run on both packages with the same
fakes (tests/torch_fakes.py: a fake ``ase`` package, ``FakeAtoms``, the
``RecordingCalc`` spy) and the same weights (JAX's tiny configs, carried
across by ``params_from_numpy``), the values compared between them:
energy 1e-5 eV, forces 1e-5 eV/A, charges 1e-5, stress 1e-6 eV/A^3,
Hessian 1e-4.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from torch_fakes import CountingCalc, FakeAtoms, RecordingCalc, fake_ase, water_atoms  # noqa: E402

from aimnetcentral_tpu import constants as jconstants  # noqa: E402
from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator  # noqa: E402
from aimnetcentral_tpu.models import aimnet2 as jaimnet2  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu.models import modules as jmodules  # noqa: E402
from aimnetcentral_tpu.train.export import export_model as j_export  # noqa: E402
from aimnetcentral_tpu_torch import constants as tconstants  # noqa: E402
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator  # noqa: E402
from aimnetcentral_tpu_torch.models import aimnet2 as taimnet2  # noqa: E402
from aimnetcentral_tpu_torch.models import heads as theads  # noqa: E402
from aimnetcentral_tpu_torch.models import modules as tmodules  # noqa: E402
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy  # noqa: E402

TOL = {"energy": 1e-5, "forces": 1e-5, "charges": 1e-5, "dipole_moment": 1e-5, "spin_charges": 1e-5,
       "stress": 1e-6}
PACKAGES = ("jax", "torch")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(aimnet2, heads, modules, channels=1):
    """JAX's tests/test_ase_adapter.py model in either package's classes."""
    return aimnet2.AIMNet2Config(
        aev=aimnet2.AEVConfig(rc_s=5.0, nshifts_s=8),
        nfeature=4,
        d2features=True,
        ncomb_v=4,
        hidden=((32,), (32,), (32,)),
        aim_size=32,
        num_charge_channels=channels,
        outputs=(
            ("energy_mlp", heads.OutputHead(n_in=32, n_out=1, key_in="aim", key_out="energy",
                                            mlp=modules.MLPSpec(hidden=(16,), last_linear=True))),
            ("atomic_sum", heads.AtomicSumHead(key_in="energy", key_out="energy")),
        ),
    )


def both_calcs(seed, channels=1):
    jcfg = tiny_config(jaimnet2, jheads, jmodules, channels)
    jparams = j_init(jax.random.key(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return {
        "jax": JCalculator((jparams, jcfg, {"sae": {}})),
        "torch": TCalculator((tparams, tiny_config(taimnet2, theads, tmodules, channels), {"sae": {}}), device="cpu"),
    }


@pytest.fixture(scope="module")
def adapters():
    with fake_ase("aimnetcentral_tpu.calculators.ase_adapter", "aimnetcentral_tpu_torch.calculators.ase_adapter") as (
        jmod,
        tmod,
    ):
        assert jmod.ASE_AVAILABLE and tmod.ASE_AVAILABLE
        yield {"jax": jmod, "torch": tmod}


@pytest.fixture(scope="module")
def calcs():
    return both_calcs(0)


@pytest.fixture(scope="module")
def nse_calcs():
    return both_calcs(1, channels=2)


def assert_results_match(got, ref, keys=None):
    keys = keys or [k for k in ref if k in TOL]
    assert set(keys) <= set(got)
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL[k], err_msg=k)


def _periodic_atoms():
    rng = np.random.default_rng(0)
    a = 7.0
    return FakeAtoms(positions=rng.uniform(0, a, (8, 3)), numbers=[8, 1, 1, 6, 1, 1, 1, 1],
                     cell=np.eye(3) * a, pbc=True)


def test_property_mapping_gas_phase(adapters, calcs):
    res = {}
    for pkg in PACKAGES:
        ase_calc = adapters[pkg].AIMNet2ASE(calcs[pkg])
        atoms = water_atoms()
        ase_calc.calculate(atoms, properties=("energy", "forces"))
        r = res[pkg] = ase_calc.results
        assert isinstance(r["energy"], float)  # a batch of one as a scalar
        assert r["free_energy"] == r["energy"]
        assert r["forces"].shape == (3, 3) and r["forces"].dtype == np.float64
        np.testing.assert_allclose(r["dipole_moment"], (r["charges"][:, None] * atoms.get_positions()).sum(0))
    assert set(res["torch"]) == set(res["jax"])
    assert_results_match(res["torch"], res["jax"], ["energy", "forces", "charges", "dipole_moment"])


def test_charge_mult_precedence(adapters, calcs):
    """atoms.info overrides the constructor's values; both packages hand the
    calculator the same data dicts."""
    seen = {}
    for pkg in PACKAGES:
        spy = RecordingCalc(calcs[pkg])
        ase_calc = adapters[pkg].AIMNet2ASE(spy, charge=1.0, mult=2.0)
        ase_calc.calculate(water_atoms(), properties=("energy",))
        ase_calc.calculate(water_atoms(info={"charge": -1.0, "mult": 3.0}), properties=("energy",))
        seen[pkg] = spy.calls
        assert [(d["charge"], d["mult"]) for d, _ in spy.calls] == [(1.0, 2.0), (-1.0, 3.0)]
    for (dj, kj), (dt, kt) in zip(seen["jax"], seen["torch"]):
        assert set(dj) == set(dt) and kj == kt
        for k in dj:
            np.testing.assert_array_equal(dt[k], dj[k])
            assert np.asarray(dt[k]).dtype == np.asarray(dj[k]).dtype


def test_no_cell_passed_for_gas_phase(adapters, calcs):
    for pkg in PACKAGES:
        spy = RecordingCalc(calcs[pkg])
        adapters[pkg].AIMNet2ASE(spy).calculate(water_atoms(), properties=("energy",))
        data, kw = spy.calls[-1]
        assert "cell" not in data
        assert kw == {"forces": True, "stress": False}


def test_periodic_stress_voigt(adapters, calcs):
    res = {}
    for pkg in PACKAGES:
        atoms = _periodic_atoms()
        ase_calc = adapters[pkg].AIMNet2ASE(calcs[pkg])
        ase_calc.calculate(atoms, properties=("energy", "forces", "stress"))
        s = res[pkg] = ase_calc.results["stress"]
        assert s.shape == (6,) and s.dtype == np.float64  # Voigt: xx, yy, zz, yz, xz, xy
        out = calcs[pkg](
            {"coord": atoms.positions.astype(np.float32), "numbers": atoms.numbers, "charge": 0.0,
             "cell": atoms.cell.astype(np.float32)},
            forces=True, stress=True,
        )
        full = 0.5 * (out["stress"][0] + out["stress"][0].T)
        np.testing.assert_allclose(s, [full[0, 0], full[1, 1], full[2, 2], full[1, 2], full[0, 2], full[0, 1]],
                                   atol=1e-6)
        res[pkg] = ase_calc.results
    assert_results_match(res["torch"], res["jax"], ["energy", "forces", "charges", "stress"])


def test_get_hessian(adapters, calcs):
    hs = {}
    for pkg in PACKAGES:
        h = hs[pkg] = adapters[pkg].AIMNet2ASE(calcs[pkg]).get_hessian(water_atoms())
        assert h.shape == (9, 9) and h.dtype == np.float64
        np.testing.assert_allclose(h, h.T, atol=1e-4)
    np.testing.assert_allclose(hs["torch"], hs["jax"], rtol=0, atol=1e-4)
    # the port's adapter reshapes the calculator's (N, 3, N, 3) Hessian
    direct = calcs["torch"].eval({"coord": water_atoms().positions.astype(np.float32), "numbers": [8, 1, 1],
                                  "charge": 0.0}, hessian=True)["hessian"]
    np.testing.assert_array_equal(hs["torch"], direct.reshape(9, 9).astype(np.float64))


def test_get_hessian_without_atoms_raises(adapters, calcs):
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="atoms"):
            adapters[pkg].AIMNet2ASE(calcs[pkg]).get_hessian()


def test_forces_sum_nearly_zero(adapters, calcs):
    for pkg in PACKAGES:
        ase_calc = adapters[pkg].AIMNet2ASE(calcs[pkg])
        ase_calc.calculate(water_atoms(), properties=("energy", "forces"))
        np.testing.assert_allclose(ase_calc.results["forces"].sum(0), np.zeros(3), atol=1e-5)


def test_set_charge_mult_invalidate_and_apply(adapters, calcs):
    """set_charge / set_mult clear the cached results and feed the next
    evaluation, in both packages alike."""
    energies = {}
    for pkg in PACKAGES:
        rec = RecordingCalc(calcs[pkg])
        ase_calc = adapters[pkg].AIMNet2ASE(rec)
        atoms = water_atoms()
        ase_calc.calculate(atoms, properties=("energy",))
        assert "energy" in ase_calc.results
        ase_calc.set_charge(1.0)
        assert ase_calc.results == {}
        ase_calc.calculate(atoms, properties=("energy",))
        assert rec.calls[-1][0]["charge"] == 1.0
        ase_calc.set_mult(3.0)
        assert ase_calc.results == {}
        ase_calc.calculate(atoms, properties=("energy",))
        assert rec.calls[-1][0]["mult"] == 3.0
        energies[pkg] = ase_calc.results
    assert_results_match(energies["torch"], energies["jax"], ["energy", "forces", "charges"])


def test_check_state_flags_info_charge_change(adapters, calcs):
    """A changed atoms.info charge or multiplicity asks for a new
    calculation, which ASE's geometry-only check would not."""
    for pkg in PACKAGES:
        ase_calc = adapters[pkg].AIMNet2ASE(calcs[pkg])
        atoms = water_atoms()
        ase_calc.calculate(atoms, properties=("energy",))
        assert ase_calc.check_state(atoms) == []
        atoms.info["charge"] = -1
        assert "info" in ase_calc.check_state(atoms)
        ase_calc.calculate(atoms, properties=("energy",))
        assert ase_calc.check_state(atoms) == []
        atoms.info["spin"] = 2  # the MACE-style alias of mult counts too
        assert "info" in ase_calc.check_state(atoms)


def test_get_dipole_moment_method(adapters, calcs):
    dms = {}
    for pkg in PACKAGES:
        ase_calc = adapters[pkg].AIMNet2ASE(calcs[pkg])
        dm = dms[pkg] = ase_calc.get_dipole_moment(water_atoms())
        assert dm.shape == (3,)
        np.testing.assert_allclose(dm, ase_calc.results["dipole_moment"])
    np.testing.assert_allclose(dms["torch"], dms["jax"], rtol=0, atol=1e-5)


# -- the NSE surface -------------------------------------------------------------------


def test_is_nse_flags(adapters, calcs, nse_calcs):
    for pkg in PACKAGES:
        assert not adapters[pkg].AIMNet2ASE(calcs[pkg]).is_nse
        assert adapters[pkg].AIMNet2ASE(nse_calcs[pkg]).is_nse


def test_spin_charges_in_implemented_properties_only_for_nse(adapters, calcs, nse_calcs):
    for pkg in PACKAGES:
        cls = adapters[pkg].AIMNet2ASE
        assert "spin_charges" not in cls.implemented_properties
        assert "spin_charges" not in cls(calcs[pkg]).implemented_properties
        assert "spin_charges" in cls(nse_calcs[pkg], mult=2.0).implemented_properties
        assert "spin_charges" not in cls.implemented_properties  # the class list is untouched
    assert adapters["torch"].AIMNet2ASE.implemented_properties == adapters["jax"].AIMNet2ASE.implemented_properties


def test_get_spin_charges_raises_for_standard_model(adapters, calcs):
    for pkg in PACKAGES:
        std = adapters[pkg].AIMNet2ASE(calcs[pkg])
        std.calculate(water_atoms(), properties=("energy",))
        with pytest.raises(RuntimeError, match="NSE"):
            std.get_spin_charges()


def test_spin_charges_shape_and_sum_rule(adapters, nse_calcs):
    res = {}
    for pkg in PACKAGES:
        nse = adapters[pkg].AIMNet2ASE(nse_calcs[pkg], charge=1.0, mult=2.0)
        nse.calculate(water_atoms(), properties=("energy",))
        sc = nse.get_spin_charges()
        assert sc.shape == (3,)
        np.testing.assert_allclose(np.asarray(sc).sum(), 1.0, atol=1e-4)  # mult - 1 unpaired electrons
        res[pkg] = nse.results
    assert_results_match(res["torch"], res["jax"], ["energy", "forces", "charges", "spin_charges"])


def test_spin_info_alias_maps_to_mult(adapters, nse_calcs):
    energies = []
    for pkg in PACKAGES:
        spy = RecordingCalc(nse_calcs[pkg])
        ase_calc = adapters[pkg].AIMNet2ASE(spy, charge=1.0, mult=2.0)
        ase_calc.calculate(water_atoms(info={"spin": 4.0, "charge": 1.0}), properties=("energy",))
        assert spy.calls[-1][0]["mult"] == 4.0
        energies.append(ase_calc.results["energy"])
    np.testing.assert_allclose(energies[1], energies[0], rtol=0, atol=1e-5)


# -- the string constructor --------------------------------------------------------------


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """JAX's export of the tiny model (seed 3), as JAX's string-constructor test."""
    cfg = tiny_config(jaimnet2, jheads, jmodules)
    p = str(tmp_path_factory.mktemp("ase") / "m.pt")
    j_export(j_init(jax.random.key(3), cfg), cfg, p, sae={1: -13.6, 8: -2042.6}, implemented_species=[1, 8])
    return p


def test_string_ctor_resolves_artifact_path(adapters, artifact):
    res = {}
    for pkg, kw in (("jax", {}), ("torch", {"device": "cpu"})):
        ase_calc = adapters[pkg].AIMNet2ASE(artifact, **kw)
        ase_calc.calculate(water_atoms(), properties=("energy", "forces"))
        assert np.isfinite(ase_calc.results["energy"])
        assert ase_calc.results["forces"].shape == (3, 3)
        res[pkg] = ase_calc.results
    assert_results_match(res["torch"], res["jax"], ["energy", "forces", "charges"])


def test_string_ctor_forwards_calculator_options(adapters, artifact):
    ase_calc = adapters["torch"].AIMNet2ASE(artifact, device="cpu", precision="fast", binned_threshold=64)
    assert ase_calc.base_calc.device == torch.device("cpu")
    assert (ase_calc.base_calc.precision, ase_calc.base_calc.binned_threshold) == ("fast", 64)
    with pytest.raises(TypeError, match="model name or path"):
        adapters["torch"].AIMNet2ASE(ase_calc.base_calc, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_string_ctor_needs_a_card_or_the_cpu(adapters, artifact):
    """Without a card the string constructor raises as resolve_device does;
    it never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adapters["torch"].AIMNet2ASE(artifact)


# -- PySisyphus --------------------------------------------------------------------------


def _pysis_classes():
    from aimnetcentral_tpu.calculators.ase_adapter import AIMNet2Pysis as JPysis
    from aimnetcentral_tpu_torch.calculators.ase_adapter import AIMNet2Pysis as TPysis

    return {"jax": JPysis, "torch": TPysis}


def test_pysis_constants_match():
    assert (tconstants.Bohr, tconstants.Hartree) == (jconstants.Bohr, jconstants.Hartree)


def test_pysis_unit_conversions():
    elem = ["O", "H", "H"]
    coords_bohr = np.arange(9, dtype=np.float64)
    out = {}
    for pkg, cls in _pysis_classes().items():
        base = CountingCalc()
        p = cls(base, charge=1.0)
        e = p.get_energy(elem, coords_bohr)
        assert e["energy"] == pytest.approx(-2.0 / tconstants.Hartree)
        np.testing.assert_allclose(base.calls[0][0], coords_bohr.reshape(-1, 3) * tconstants.Bohr, rtol=1e-6)
        f = p.get_forces(elem, coords_bohr)
        np.testing.assert_allclose(f["forces"], 0.5 * tconstants.Bohr / tconstants.Hartree, rtol=1e-12)
        assert f["forces"].shape == (9,)
        h = p.get_hessian(elem, coords_bohr)
        np.testing.assert_allclose(h["hessian"], np.eye(9) * 4.0 * tconstants.Bohr**2 / tconstants.Hartree,
                                   rtol=1e-12)
        out[pkg] = (e, f, h, base.calls)
    for a, b in zip(out["torch"][:3], out["jax"][:3]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for (ct, kt), (cj, kj) in zip(out["torch"][3], out["jax"][3]):
        np.testing.assert_array_equal(ct, cj)
        assert kt == kj


def test_pysis_coordinate_keyed_cache():
    for cls in _pysis_classes().values():
        base = CountingCalc()
        p = cls(base)
        elem = ["C", "O"]
        c1 = np.arange(6, dtype=np.float64)
        p.get_forces(elem, c1)
        p.get_forces(elem, c1)  # the same coordinates: cached
        assert len(base.calls) == 1
        p.get_forces(elem, c1 + 0.1)  # moved: evaluated again
        assert len(base.calls) == 2


def test_pysis_on_the_model(calcs):
    """Energy, forces and Hessian of water through both Pysis adapters on
    the same weights, in Hartree and Bohr."""
    elem = ["O", "H", "H"]
    coords_bohr = water_atoms().positions.reshape(-1) / tconstants.Bohr
    res = {}
    for pkg, cls in _pysis_classes().items():
        p = cls(calcs[pkg])
        res[pkg] = (p.get_forces(elem, coords_bohr), p.get_hessian(elem, coords_bohr))
    (ft, ht), (fj, hj) = res["torch"], res["jax"]
    scale_f = tconstants.Bohr / tconstants.Hartree
    np.testing.assert_allclose(ft["energy"], fj["energy"], rtol=0, atol=1e-5 / tconstants.Hartree)
    np.testing.assert_allclose(ft["forces"], fj["forces"], rtol=0, atol=1e-5 * scale_f)
    np.testing.assert_allclose(ht["hessian"], hj["hessian"], rtol=0,
                               atol=1e-4 * tconstants.Bohr**2 / tconstants.Hartree)
