"""The port's TorchSim adapter against the JAX package's (CPU).

JAX's tests/test_torchsim.py, each run on both packages with the same fake
``SimState`` (tests/torch_fakes.py) and the same weights (JAX's tiny
config, carried across by ``params_from_numpy``), the values compared
between them: energy 1e-5 eV, forces 1e-5 eV/A, stress 1e-6 eV/A^3.  The
port returns JAX's dtypes on the state's device; a batch at or above
``binned_threshold`` goes onto the molecule-bin layout and a periodic state
onto the binned one, in both packages.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from test_torch_ase_adapter import both_calcs  # noqa: E402
from torch_fakes import FakeSimState, SpyCalc  # noqa: E402

from aimnetcentral_tpu.calculators.torchsim_adapter import AIMNet2TorchSim as JTorchSim  # noqa: E402
from aimnetcentral_tpu_torch.calculators.torchsim_adapter import AIMNet2TorchSim as TTorchSim  # noqa: E402

ADAPTERS = {"jax": JTorchSim, "torch": TTorchSim}
TOL = {"energy": 1e-5, "forces": 1e-5, "stress": 1e-6}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def calcs():
    return both_calcs(0)


def run_both(calcs, state, **kw):
    """The state through both adapters; the outputs' keys, dtypes and
    devices agree and the values within ``TOL``."""
    out = {pkg: ADAPTERS[pkg](calcs[pkg], **kw)(state) for pkg in ADAPTERS}
    assert set(out["torch"]) == set(out["jax"])
    for k, ref in out["jax"].items():
        got = out["torch"][k]
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        assert got.device == state.positions.device, k
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=TOL[k], err_msg=k)
    return out


def _pair_state(rng):
    pos1 = rng.normal(size=(4, 3)).astype(np.float32) * 2.0
    pos2 = rng.normal(size=(6, 3)).astype(np.float32) * 2.0
    z1, z2 = np.array([6, 1, 1, 1]), np.array([8, 1, 6, 1, 1, 1])
    state = FakeSimState(
        positions=torch.tensor(np.concatenate([pos1, pos2])),
        atomic_numbers=torch.tensor(np.concatenate([z1, z2])),
        system_idx=torch.tensor([0] * 4 + [1] * 6),
    )
    return state, (pos1, z1), (pos2, z2)


def _box_state(n=8, a=8.0, seed=2):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, a, size=(n, 3)).astype(np.float32)
    numbers = np.resize([6, 1, 1, 8, 1, 6, 1, 1], n)
    # TorchSim's convention: the lattice vectors as columns
    return FakeSimState(positions=torch.tensor(pos), atomic_numbers=torch.tensor(numbers),
                        cell=torch.tensor((np.eye(3) * a).T.astype(np.float32)), pbc=True)


def test_single_system(calcs):
    rng = np.random.default_rng(0)
    state = FakeSimState(positions=torch.tensor(rng.normal(size=(5, 3)).astype(np.float32) * 2.0),
                         atomic_numbers=torch.tensor([6, 1, 1, 8, 1]))
    out = run_both(calcs, state)["torch"]
    assert out["energy"].shape == (1,) and out["forces"].shape == (5, 3)
    assert out["energy"].dtype == torch.float64 and out["forces"].dtype == torch.float64
    assert torch.isfinite(out["energy"]).all() and torch.isfinite(out["forces"]).all()


def test_multi_system_matches_separate_evals(calcs):
    state, (pos1, z1), (pos2, z2) = _pair_state(np.random.default_rng(1))
    out = run_both(calcs, state)["torch"]
    assert out["energy"].shape == (2,) and out["forces"].shape == (10, 3)
    sep = [calcs["torch"]({"coord": p, "numbers": z}, forces=True) for p, z in ((pos1, z1), (pos2, z2))]
    np.testing.assert_allclose(out["energy"].numpy(), [s["energy"][0] for s in sep], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["forces"].numpy(), np.concatenate([s["forces"] for s in sep]), rtol=0, atol=1e-5)


def test_periodic_stress(calcs):
    out = run_both(calcs, _box_state(), compute_stress=True)["torch"]
    assert out["stress"].shape == (1, 3, 3) and out["stress"].dtype == torch.float64
    assert torch.isfinite(out["stress"]).all()


def test_stress_without_cell_raises(calcs):
    state = FakeSimState(positions=torch.zeros(2, 3), atomic_numbers=torch.tensor([1, 1]))
    for cls in ADAPTERS.values():
        with pytest.raises(ValueError, match="cell"):
            cls(calcs["torch"], compute_stress=True)(state)


def _spied(state):
    """The data dict each adapter hands to the calculator."""
    seen = {}
    for pkg, cls in ADAPTERS.items():
        spy = SpyCalc()
        cls(spy)(state)
        seen[pkg] = spy.last
    assert set(seen["torch"]) == set(seen["jax"])
    for k, ref in seen["jax"].items():
        np.testing.assert_array_equal(seen["torch"][k], ref)
        assert np.asarray(seen["torch"][k]).dtype == np.asarray(ref).dtype
    return seen["torch"]


def test_extras_map_charge_and_mult():
    data = _spied(FakeSimState(positions=torch.zeros((4, 3)), atomic_numbers=torch.tensor([8, 1, 1, 1]),
                               system_idx=torch.tensor([0, 0, 1, 1]),
                               extras={"charge": [1.0, -1.0], "mult": [2.0, 1.0]}))
    np.testing.assert_array_equal(data["charge"], [1.0, -1.0])
    np.testing.assert_array_equal(data["mult"], [2.0, 1.0])


def test_spin_extra_falls_back_to_multiplicity():
    """MACE-style extras["spin"]; an explicit "mult" wins when both are given."""
    data = _spied(FakeSimState(positions=torch.zeros((2, 3)), atomic_numbers=torch.tensor([8, 1]),
                               extras={"spin": [3.0]}))
    np.testing.assert_array_equal(data["mult"], [3.0])
    data = _spied(FakeSimState(positions=torch.zeros((2, 3)), atomic_numbers=torch.tensor([8, 1]),
                               extras={"spin": [3.0], "mult": [2.0]}))
    np.testing.assert_array_equal(data["mult"], [2.0])


def test_column_vector_cell_is_transposed():
    """A skewed cell: TorchSim's columns become the calculator's rows, for
    one cell and for a batch of cells."""
    cols = np.array([[6.0, 0.5, 0.2], [0.0, 7.0, 0.3], [0.0, 0.0, 8.0]], dtype=np.float32)
    one = _spied(FakeSimState(positions=torch.zeros((2, 3)), atomic_numbers=torch.tensor([8, 1]),
                              cell=torch.tensor(cols), pbc=True))
    np.testing.assert_array_equal(one["cell"], cols.T)
    two = _spied(FakeSimState(positions=torch.zeros((4, 3)), atomic_numbers=torch.tensor([8, 1, 8, 1]),
                              system_idx=torch.tensor([0, 0, 1, 1]), cell=torch.tensor(np.stack([cols, 2 * cols])),
                              pbc=torch.tensor([True, True, True])))
    np.testing.assert_array_equal(two["cell"], np.stack([cols.T, 2 * cols.T]))


def test_extras_shape_validation():
    state = FakeSimState(positions=torch.zeros((4, 3)), atomic_numbers=torch.tensor([8, 1, 1, 1]),
                         system_idx=torch.tensor([0, 0, 1, 1]), extras={"charge": [1.0, 0.0, -1.0]})
    for cls in ADAPTERS.values():
        with pytest.raises(ValueError, match="2 systems"):
            cls(SpyCalc())(state)
    state.extras = {"mult": [1.0]}
    for cls in ADAPTERS.values():
        with pytest.raises(ValueError, match="2 systems"):
            cls(SpyCalc())(state)


def test_outputs_are_detached_torch_tensors(calcs):
    """The simulation loop must never backpropagate into the calculator."""
    state = FakeSimState(
        positions=torch.tensor([[0.0, 0.0, 0.119], [0.0, 0.763, -0.477], [0.0, -0.763, -0.477]],
                               requires_grad=True),
        atomic_numbers=torch.tensor([8, 1, 1]),
    )
    out = run_both(calcs, state)["torch"]
    assert isinstance(out["energy"], torch.Tensor)
    assert not out["energy"].requires_grad and not out["forces"].requires_grad
    assert torch.isfinite(out["forces"]).all()


@pytest.mark.parametrize("case", ["packed", "binned"])
def test_layouts_at_the_threshold(case):
    """A batch of molecules at or above ``binned_threshold`` goes onto the
    molecule-bin layout and a periodic state onto the binned one, through
    the adapter as through ``eval``, in both packages alike."""
    from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator

    base = both_calcs(0)
    jc = base["jax"]
    calcs = {
        "jax": JCalculator((jc.params, jc.cfg, {"sae": {}}), binned_threshold=8),
        "torch": TCalculator((base["torch"].params, base["torch"].cfg, {"sae": {}}), device="cpu", binned_threshold=8),
    }
    if case == "packed":
        state, _m1, _m2 = _pair_state(np.random.default_rng(5))
        run_both(calcs, state)
    else:
        run_both(calcs, _box_state(n=16, a=7.0, seed=3), compute_stress=True)
    assert calcs["torch"]._prep_cache["kind"] == case
