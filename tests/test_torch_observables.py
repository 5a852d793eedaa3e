"""The port's observables harness (validation/observables.py) and
tools/validate_torch.py against the JAX package's (CPU).

JAX's tests/test_validate_drift.py comparer cases and
tests/test_calculator.py::test_validation_observables_roundtrip run on both
packages; ``compare_observables`` reads a dump of either package in both
directions; tools/validate_torch.py loads the committed weights without
JAX and reproduces tools/validate_baseline.json within that tool's limits
(1e-5 eV, 1e-4 eV/A, charges 1e-5).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu import validation as jvalidation  # noqa: E402
from aimnetcentral_tpu_torch import validation as tvalidation  # noqa: E402
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
PACKAGES = {"jax": jvalidation, "torch": tvalidation}


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"tools_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tools():
    return _tool("validate"), _tool("validate_torch")


@pytest.fixture(scope="module")
def dumps(tools):
    """The validation model's dump from each package (JAX on its own
    weights loader, the port on validate_torch's)."""
    jtool, ttool = tools
    return {"jax": jvalidation.dump_observables(jtool.build_calculator()),
            "torch": tvalidation.dump_observables(ttool.build_calculator(device="cpu"))}


def test_reference_systems_are_jax_s():
    assert json.dumps(tvalidation.reference_systems()) == json.dumps(jvalidation.reference_systems())


def test_validation_model_is_jax_s(tools):
    from test_torch_indexed import _port_validation_config

    jtool, ttool = tools
    assert ttool.validation_model() == _port_validation_config(jtool.validation_model())
    assert (ttool.ENERGY_ATOL, ttool.FORCE_ATOL) == (jtool.ENERGY_ATOL, jtool.FORCE_ATOL)
    assert (ttool.WEIGHTS, ttool.BASELINE) == (jtool.WEIGHTS, jtool.BASELINE)


def test_weights_load_without_jax_as_jax_loads_them(tools):
    """validate_torch's flattening (dict keys sorted, lists in order) puts
    each committed leaf where JAX's ``tree.unflatten`` does."""
    jtool, ttool = tools
    jcalc = jtool.build_calculator()
    ref = params_from_numpy(jax.tree.map(np.asarray, jcalc.params), device="cpu")
    got = ttool.load_params(ttool.validation_model(), device="cpu")
    ref_leaves, got_leaves = ttool._flatten(ref), ttool._flatten(got)
    assert len(got_leaves) == len(ref_leaves) == len(jax.tree.leaves(jcalc.params))
    for a, b in zip(got_leaves, ref_leaves):
        assert torch.equal(a, b)


def test_dump_header_names_the_port(dumps):
    d = dumps["torch"]
    assert d["torch_version"] == torch.__version__
    assert (d["backend"], d["device"]) == ("cpu", "cpu")
    assert "jax_version" not in d and "jax_version" in dumps["jax"]
    assert set(d) - {"torch_version", "backend", "device"} == set(dumps["jax"]) - {"jax_version", "backend"}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_committed_baseline_reproduces(tools, dumps, pkg):
    """Each package's dump against the committed baseline, through each
    comparer, at tools/validate.py's limits (the port's also on charges)."""
    jtool, ttool = tools
    ok, report = PACKAGES[pkg].compare_observables(
        jtool.BASELINE, dumps["torch"], energy_atol=jtool.ENERGY_ATOL, force_atol=jtool.FORCE_ATOL
    )
    assert ok, report
    ok, report = tvalidation.compare_observables(
        jtool.BASELINE, dumps[pkg], energy_atol=ttool.ENERGY_ATOL, force_atol=ttool.FORCE_ATOL,
        charge_atol=ttool.CHARGE_ATOL,
    )
    assert ok and report.count("OK") == 4, report


@pytest.mark.parametrize("direction", ["jax_vs_port", "port_vs_jax"])
@pytest.mark.parametrize("comparer", list(PACKAGES))
def test_cross_package_dumps_compare(dumps, direction, comparer):
    a, b = (dumps["jax"], dumps["torch"]) if direction == "jax_vs_port" else (dumps["torch"], dumps["jax"])
    ok, report = PACKAGES[comparer].compare_observables(a, b, energy_atol=1e-5, force_atol=1e-5)
    assert ok and "FAIL" not in report, report


def test_cross_package_report_names_both(dumps):
    _ok, report = tvalidation.compare_observables(dumps["jax"], dumps["torch"])
    first = report.splitlines()[0]
    assert f"(jax {jax.__version__})" in first and f"(torch {torch.__version__})" in first


def test_validate_torch_check_reproduces_the_baseline(tools, tmp_path, capsys):
    _jtool, ttool = tools
    out = tmp_path / "dump.json"
    assert ttool.main(["--check", "--device", "cpu", "--dump", str(out)]) == 0
    report = capsys.readouterr().out
    assert report.count(" OK") == 4 and "max|dq|" in report
    with open(out) as fh:
        assert json.load(fh)["backend"] == "cpu"


def test_validate_torch_runs_without_jax(tmp_path):
    """The tool as a script, in a process where importing JAX or the JAX
    package raises."""
    probe = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['aimnetcentral_tpu'] = None\n"
        f"sys.argv = ['validate_torch.py', '--dump', {str(tmp_path / 'd.json')!r}, '--device', 'cpu']\n"
        f"runpy.run_path({os.path.join(TOOLS, 'validate_torch.py')!r}, run_name='__main__')\n"
    )
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "wrote" in r.stdout and (tmp_path / "d.json").exists()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_drift_is_detected(tools, pkg):
    """A shifted dump fails each comparer (the gate is not vacuously green)."""
    jtool, _ttool = tools
    with open(jtool.BASELINE) as f:
        shifted = json.load(f)
    shifted["water"]["forces"] = (np.asarray(shifted["water"]["forces"]) + 5e-4).tolist()
    ok, _ = PACKAGES[pkg].compare_observables(jtool.BASELINE, shifted, energy_atol=jtool.ENERGY_ATOL,
                                              force_atol=jtool.FORCE_ATOL)
    assert not ok


def test_charge_drift_is_detected_when_asked(tools):
    jtool, ttool = tools
    with open(jtool.BASELINE) as f:
        shifted = json.load(f)
    shifted["nacl"]["charges"] = (np.asarray(shifted["nacl"]["charges"]) + 5e-5).tolist()
    assert tvalidation.compare_observables(jtool.BASELINE, shifted)[0]  # charges not compared
    ok, report = tvalidation.compare_observables(jtool.BASELINE, shifted, charge_atol=ttool.CHARGE_ATOL)
    assert not ok and "nacl" in [ln.split(":")[0] for ln in report.splitlines() if ln.endswith("FAIL")]


def test_validation_observables_roundtrip(tools, tmp_path):
    """A dump written to a file and one kept in memory compare OK and, on
    one device, bit for bit."""
    _jtool, ttool = tools
    calc = ttool.build_calculator(device="cpu")
    p1 = str(tmp_path / "obs1.json")
    tvalidation.dump_observables(calc, p1)
    obs2 = tvalidation.dump_observables(calc)
    ok, report = tvalidation.compare_observables(p1, obs2)
    assert ok and "OK" in report, report
    with open(p1) as fh:
        obs1 = json.load(fh)
    for name in tvalidation.reference_systems():
        assert obs1[name] == obs2[name]


# -- the comparer's own cases (JAX's tests/test_validate_drift.py) ------------------------


def _fake_dump(e_shift=0.0, f_shift=0.0, drop=None):
    dump = {"backend": "cpu", "jax_version": "x"}
    for i, name in enumerate(tvalidation.reference_systems()):
        if name == drop:
            continue
        dump[name] = {"energy": [1.0 + i + e_shift], "forces": [[0.1 + f_shift, 0.0, 0.0]] * 3}
    return dump


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_comparer_passes_within_tolerance(pkg):
    ok, report = PACKAGES[pkg].compare_observables(_fake_dump(), _fake_dump(e_shift=5e-5))
    assert ok and "OK" in report and "FAIL" not in report


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_comparer_flags_energy_drift(pkg):
    ok, report = PACKAGES[pkg].compare_observables(_fake_dump(), _fake_dump(e_shift=5e-3))
    assert not ok and "FAIL" in report


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_comparer_flags_force_drift(pkg):
    ok, _report = PACKAGES[pkg].compare_observables(_fake_dump(), _fake_dump(f_shift=5e-3))
    assert not ok


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_comparer_flags_missing_system(pkg):
    victim = next(iter(tvalidation.reference_systems()))
    ok, report = PACKAGES[pkg].compare_observables(_fake_dump(), _fake_dump(drop=victim))
    assert not ok and f"{victim}: MISSING" in report


def test_comparers_give_the_same_verdicts():
    cases = [(_fake_dump(), _fake_dump(e_shift=s, f_shift=f)) for s in (0.0, 5e-5, 2e-4) for f in (0.0, 9e-5, 2e-4)]
    for a, b in cases:
        assert tvalidation.compare_observables(a, b)[0] == jvalidation.compare_observables(a, b)[0]
