"""The port's AIMNet2Calculator against the JAX package's (CPU).

A narrow model (nfeature=4, ncomb_v=4, hidden (32, 16), aim_size=16, the
four flagship heads) with JAX parameters carried across by the weights
bridge, on a 60-atom 12 A periodic box through the binned engine.
Tolerances: energy 1e-5 relative, charges 1e-5, forces 1e-5 eV/A, stress
1e-6 eV/A^3."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator
from aimnetcentral_tpu.models import AIMNet2Config as JConfig
from aimnetcentral_tpu.models import aimnet2_init as j_init
from aimnetcentral_tpu.models import heads as jheads
from aimnetcentral_tpu.models import modules as jmodules
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator
from aimnetcentral_tpu_torch.models import AIMNet2Config as TConfig
from aimnetcentral_tpu_torch.models import aimnet2_init as t_init
from aimnetcentral_tpu_torch.models import heads as theads
from aimnetcentral_tpu_torch.models import modules as tmodules
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy

NARROW = dict(nfeature=4, ncomb_v=4, hidden=((32, 16), (32, 16), (32, 16)), aim_size=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: test files run side by side
    in worker processes, and the plain versions are many small ops, which
    several threads per worker only slow down on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def models():
    jcfg = _config(JConfig, jheads, jmodules)
    tcfg = _config(TConfig, theads, tmodules)
    jparams = j_init(jax.random.key(0), jcfg)
    # non-zero SAE so the host float64 shift is exercised
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


def test_energy_only_matches_forces_call(models, results):
    _jmodel, tmodel = models
    got, _ref = results
    plain = TCalculator(tmodel, device="cpu", binned_threshold=0).eval(_box())
    np.testing.assert_allclose(plain["energy"], got["energy"], rtol=1e-6)
    assert "forces" not in plain


def test_init_builds_the_same_tree(models):
    """The port's own init draws other numbers but the same structure."""
    jmodel, tmodel = models
    mine = t_init(tmodel[1], seed=0, device="cpu")
    ref = tmodel[0]
    assert jax.tree.structure(jax.tree.map(lambda x: 0, mine)) == jax.tree.structure(
        jax.tree.map(lambda x: 0, ref)
    )
    assert [tuple(x.shape) for x in jax.tree.leaves(mine)] == [
        tuple(x.shape) for x in jax.tree.leaves(ref)
    ]


@pytest.mark.parametrize("precision", ["fast", "balanced"])
def test_unported_tiers_raise(models, results, precision):
    """The ``fast`` and ``balanced`` tiers (once unported, hence the name)
    give the ``exact`` tier's results on the CPU, where f32 matmuls are exact
    whatever the TF32 flag; the flag is restored afterwards."""
    got, _ref = results
    flag = torch.backends.cuda.matmul.allow_tf32
    tiered = TCalculator(models[1], device="cpu", binned_threshold=0, precision=precision).eval(
        _box(), forces=True, stress=True
    )
    assert torch.backends.cuda.matmul.allow_tf32 == flag
    for key in ("energy", "charges", "forces", "stress"):
        np.testing.assert_array_equal(tiered[key], got[key])
    with pytest.raises(ValueError, match="precision"):
        TCalculator(models[1], device="cpu", precision="f32x3")


def test_unported_inputs_raise(models):
    """Inputs that raised before their slice was ported run.  Ewald Coulomb
    (ported with the rest of long range) runs on the box and is refused
    without a cell, with JAX's ValueError.  A gas-phase batch at or above
    ``binned_threshold``, which
    raised before the molecule-bin layout was ported, runs on it; so does a
    Hessian, which raised before the second order was ported: on the
    indexed layout, whatever the threshold (a 12-atom cut of the box here,
    to keep the dense Hessian small)."""
    calc = TCalculator(models[1], device="cpu", binned_threshold=0)
    gas = {k: v for k, v in _box().items() if k != "cell"}
    small = {"coord": gas["coord"][:12], "numbers": gas["numbers"][:12]}
    hess = calc.eval(small, hessian=True)
    assert calc._prep_cache["kind"] == "indexed"
    assert hess["hessian"].shape == (12, 3, 12, 3) and np.isfinite(hess["hessian"]).all()
    out = calc.eval([gas, gas], forces=True)
    assert calc._prep_cache["kind"] == "packed" and np.isfinite(out["forces"]).all()
    np.testing.assert_array_equal(out["energy"][0], out["energy"][1])
    params, cfg, aux = models[1]
    ewald = dataclasses.replace(cfg, outputs=tuple(
        (n, dataclasses.replace(h, method="ewald") if n == "lrcoulomb" else h) for n, h in cfg.outputs))
    ew = TCalculator((params, ewald, aux), device="cpu").eval(_box(), forces=True)
    assert np.isfinite(ew["forces"]).all()
    with pytest.raises(ValueError, match="periodic cell"):
        TCalculator((params, ewald, aux), device="cpu").eval(gas)


def test_gas_and_small_inputs_run(models):
    """A gas-phase structure with simple Coulomb (the indexed all-pairs
    layout, whatever the threshold) and a box below the threshold (the
    indexed layout with shifts) run."""
    calc = TCalculator(models[1], device="cpu", binned_threshold=0)
    gas = {k: v for k, v in _box().items() if k != "cell"}
    assert np.isfinite(calc.eval(gas, forces=True)["forces"]).all()
    assert calc._prep_cache["system"].bins is None
    small = TCalculator(models[1], device="cpu")  # 60 atoms < binned_threshold 1024: indexed
    assert np.isfinite(small.eval(_box())["energy"]).all()
    assert small._prep_cache["system"].bins is None


def test_no_card_raises_unless_cpu_asked(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TCalculator(models[1])


def test_reuse_is_exact_across_pbc_crossing(models):
    """An eval after a sub-skin move reuses the binned layout (no rebuild),
    and an atom that crossed the box boundary keeps a continuous
    coordinate through the cached wrap: results equal a fresh build's."""
    tmodel = models[1]
    data = _box()
    data["coord"][0] = [0.05, 6.0, 6.0]  # next to the boundary
    calc = TCalculator(tmodel, device="cpu", binned_threshold=0)
    fresh = TCalculator(tmodel, device="cpu", binned_threshold=0, reuse_skin=0.0)
    out0 = calc.eval(data)
    cached = calc._prep_cache["system"]
    moved = dict(data, coord=data["coord"].copy())
    moved["coord"][0, 0] -= 0.1  # crosses x = 0
    out2 = calc.eval(moved, forces=True, stress=True)
    assert calc._prep_cache["system"] is cached  # no rebuild happened
    ref2 = fresh.eval(moved, forces=True, stress=True)
    assert fresh._prep_cache is None
    np.testing.assert_allclose(out2["energy"], ref2["energy"], atol=1e-5)
    np.testing.assert_allclose(out2["forces"], ref2["forces"], atol=1e-4)
    np.testing.assert_allclose(out2["stress"], ref2["stress"], atol=1e-6)
    assert out0["energy"][0] != out2["energy"][0]


def _skewed(data: dict) -> dict:
    """``data`` in a non-orthogonal cell at the same fractional coordinates
    (some outside the cell, so the builder wraps them).  The cell's entries
    use all of float32's bits, so a lattice vector sum is not a float32."""
    cell = np.array([[12.0, 0.0, 0.0], [2.71828, 11.4142, 0.0], [-1.73205, 1.41421, 11.0905]], np.float32)
    frac = data["coord"].astype(np.float64) / 12.0
    return {**data, "coord": (frac @ cell).astype(np.float32), "cell": cell}


@pytest.mark.parametrize("cell", ["cubic", "skewed"])
@pytest.mark.parametrize("layout", ["indexed", "binned"])
def test_reuse_repeats_the_build(models, layout, cell):
    """The same box again reuses the layout and gives the built request's
    coordinates and results bit for bit, for atoms the builder wrapped into
    the cell: the reuse re-wraps as the builder does."""
    data = _box() if cell == "cubic" else _skewed(_box())
    threshold = 1024 if layout == "indexed" else 0  # 60 atoms
    calc = TCalculator(models[1], device="cpu", binned_threshold=threshold)
    built_out = calc.eval(data, forces=True, stress=True)
    built = calc._prep_cache["system"]
    assert (built.bins is None) == (layout == "indexed")
    reused = calc.prepare_system(data)
    assert calc._prep_cache["system"] is built  # no rebuild happened
    assert torch.equal(reused.coord, built.coord)
    reused_out = calc.eval(data, forces=True, stress=True)
    for key in ("energy", "charges", "forces", "stress"):
        np.testing.assert_array_equal(reused_out[key], built_out[key])


@pytest.mark.parametrize(
    "change",
    ["charge", "numbers", "cell", "atom_count", "far_move"],
)
def test_reuse_invalidated_by_topology_change(models, change):
    """Any other change of input than a sub-skin move rebuilds the layout."""
    tmodel = models[1]
    data = _box()
    calc = TCalculator(tmodel, device="cpu", binned_threshold=0)
    calc.eval(data)
    cached = calc._prep_cache["system"]
    other = dict(data)
    if change == "charge":
        other["charge"] = 1.0
    elif change == "numbers":
        other["numbers"] = np.where(data["numbers"] == 1, 6, data["numbers"])
    elif change == "cell":
        other["cell"] = data["cell"] * 1.01
    elif change == "atom_count":
        other = {k: (v[:-1] if k in ("coord", "numbers") else v) for k, v in data.items()}
    else:
        other["coord"] = data["coord"].copy()
        other["coord"][3, 1] += 0.31  # one coordinate beyond reuse_skin / 2
    calc.eval(other)
    assert calc._prep_cache["system"] is not cached


def _with_pair(base: dict, ri: np.ndarray, rj: np.ndarray) -> dict:
    """``base`` with two atoms (C, O) placed at ``ri`` and ``rj`` and every
    atom within 1.6 A of either removed; the pair comes first."""
    coord, numbers = base["coord"], base["numbers"]
    far = (np.linalg.norm(coord - ri, axis=1) > 1.6) & (np.linalg.norm(coord - rj, axis=1) > 1.6)
    return {
        "coord": np.concatenate([[ri, rj], coord[far]]).astype(np.float32),
        "numbers": np.concatenate([[6, 8], numbers[far]]),
        "cell": base["cell"],
    }


def _diagonal_move(data: dict) -> dict:
    """The pair's atoms moved 0.299 A along every coordinate, towards each
    other along (1, 1, 1): under ``reuse_skin / 2`` = 0.3 A per coordinate,
    0.518 A each in length."""
    moved = dict(data, coord=data["coord"].copy())
    moved["coord"][0] += 0.299
    moved["coord"][1] -= 0.299
    return moved


def _normal_111_box() -> dict:
    """A cell whose first plane normal is (1, 1, 1): rows 28.5 n1, 17 n2 and
    17 n3 of an orthonormal frame with n1 along (1, 1, 1), so the SR grid at
    cutoff + skin 5.6 A is 5 x 3 x 3 bins (stencil radius 1).  A jittered
    3 A lattice in that frame, and a pair on n1 at u = 11.35 (bin 1) and
    17.15 A (bin 3): 5.8 A apart, no SR pair at the build."""
    n1 = np.ones(3) / np.sqrt(3.0)
    n2 = np.array([1.0, -1.0, 0.0]) / np.sqrt(2.0)
    frame = np.stack([n1, n2, np.cross(n1, n2)])
    lengths = np.array([28.5, 17.0, 17.0])
    rng = np.random.default_rng(5)
    counts = (9, 5, 5)
    grid = np.stack(np.meshgrid(*[np.arange(k) for k in counts], indexing="ij"), axis=-1).reshape(-1, 3)
    uvw = (grid + 0.5 + rng.uniform(-0.15, 0.15, size=grid.shape)) * (lengths / counts)
    base = {
        "coord": uvw @ frame,
        "numbers": rng.choice([1, 6, 7, 8], size=len(grid), p=[0.5, 0.35, 0.05, 0.1]),
        "cell": (lengths[:, None] * frame).astype(np.float32),
    }
    return _with_pair(base, np.array([11.35, 8.5, 8.5]) @ frame, np.array([17.15, 8.5, 8.5]) @ frame)


def _corner_pair_box() -> dict:
    """The 12 A test box with a pair on the cube's diagonal, 5.7 A apart:
    beyond the SR list's reach (cutoff + skin 5.6 A) at the build."""
    ri = np.array([3.0, 3.0, 3.0])
    return _with_pair(_box(), ri, ri + 5.7 / np.sqrt(3.0))


@pytest.mark.parametrize("layout", ["binned-skewed", "indexed-diagonal"])
def test_reuse_rebuilds_after_a_diagonal_move(models, layout):
    """Two atoms move 0.299 A along each coordinate towards each other: no
    coordinate moves more than ``reuse_skin / 2``, but each atom moves
    0.518 A, and the pair comes within the cutoff (5.8 -> 4.76 A along the
    skewed cell's plane normal, whose bins 1 and 3 the radius-1 stencil does
    not join; 5.7 -> 4.66 A on the indexed layout's SR list).  The reuse
    test takes the Euclidean move, so the layout is rebuilt and the result
    is a fresh build's, bit for bit, and the JAX package's fresh build's
    within the tolerances.  A reuse test on the largest coordinate would
    keep the stale layout and drop the pair."""
    jmodel, tmodel = models
    data = _normal_111_box() if layout == "binned-skewed" else _corner_pair_box()
    threshold = 0 if layout == "binned-skewed" else 1024
    moved = _diagonal_move(data)
    calc = TCalculator(tmodel, device="cpu", binned_threshold=threshold)
    calc.eval(data)
    cached = calc._prep_cache["system"]
    assert (cached.bins is not None) == (layout == "binned-skewed")
    if cached.bins is not None:
        assert cached.bins.nbins == (5, 3, 3)
    got = calc.eval(moved, forces=True, stress=True)
    assert calc._prep_cache["system"] is not cached
    fresh = TCalculator(tmodel, device="cpu", binned_threshold=threshold).eval(moved, forces=True, stress=True)
    for key in ("energy", "forces", "stress"):
        np.testing.assert_array_equal(got[key], fresh[key])
    ref = JCalculator(jmodel, binned_threshold=threshold).eval(moved, forces=True, stress=True)
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)
    np.testing.assert_allclose(got["forces"], ref["forces"], atol=1e-5)
    np.testing.assert_allclose(got["stress"], ref["stress"], atol=1e-6)
