"""The port's second derivatives against the JAX package's (CPU).

- The indexed layout: ``AIMNet2Calculator.eval(hessian=True)`` and
  ``hessian_vector_product`` against JAX's on a 10-atom molecule (flagship
  and wB97M-D3 heads), a two-molecule list (per-structure lists) and a
  small periodic box with stress beside the Hessian; ``make_eval_fn`` and
  ``make_hvp_fn`` directly.  Every Hessian is finite, symmetric and sums to
  zero over each row's atoms (translation invariance).
- The binned layouts, through the K3 rules of ``ConvAcc`` and ``PairAcc``:
  ``make_hvp_fn`` on a periodic box on the binned layout
  (``binned_threshold`` lowered) and on packed molecule bins against JAX's
  ``make_hvp_fn`` (its XLA conv engine), and on molecule bins the
  force-loss gradient ``d/dtheta sum |F|^2`` against ``jax.grad`` of the
  same with ``conv_engine="xla"`` (every leaf but the radial constants,
  which the kernel route holds constant as JAX's Pallas route does).
- The routing: a Hessian or an HVP after a forces request never reuses a
  binned or packed layout.
- The K3 rules themselves in float64 against finite differences
  (``torch.autograd.gradcheck`` on ``ConvAccBwd`` and ``PairAccBwd``, the
  plain versions on the CPU).

The narrow model of tests/test_torch_indexed.py, JAX parameters carried
across by the weights bridge, inputs drawn with numpy from fixed seeds.
Tolerance: 1e-4 eV/A^2 absolute on H and H v (float32 summation order);
forces 1e-5 eV/A and stress 1e-6 eV/A^3 as in tests/test_torch_indexed.py;
the parameter gradient 1e-4 of each leaf's largest magnitude (a leaf
differs in scale by orders of magnitude from another).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.calculators import derivatives as jder  # noqa: E402
from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator  # noqa: E402
from aimnetcentral_tpu.models.aimnet2 import aimnet2_apply as j_apply  # noqa: E402
from aimnetcentral_tpu_torch.builders import system_from_molecules  # noqa: E402
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator  # noqa: E402
from aimnetcentral_tpu_torch.calculators import derivatives as tder  # noqa: E402
from aimnetcentral_tpu_torch.kernels import conv_stencil as tcs  # noqa: E402
from aimnetcentral_tpu_torch.kernels import pair_sweep as ps  # noqa: E402
from aimnetcentral_tpu_torch.kernels.conv_pass import ConvAcc, ConvAccBwd, build_conv_tables  # noqa: E402
from aimnetcentral_tpu_torch.models import engine_binned as teb  # noqa: E402
from aimnetcentral_tpu_torch.models.aimnet2 import aimnet2_apply as t_apply  # noqa: E402
from aimnetcentral_tpu_torch.ops import binned as tB  # noqa: E402
from test_torch_indexed import _box, _mol, models  # noqa: E402, F401  (models: a fixture)

CPU = torch.device("cpu")
H_TOL = 1e-4  # eV/A^2 on H and H v
MOL = _mol(10, 31)
PAIR = [_mol(7, 32), _mol(9, 33, charge=1.0)]
BOX = _box(16, 7.0, seed=5)  # 16 atoms in a 7 A cell: the indexed layout with shifts
PACKED = [_mol(11, 21), _mol(9, 22, charge=1.0), _mol(12, 23), _mol(5, 24, charge=-1.0)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (test files run side by side
    in worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_hessian(h: np.ndarray) -> None:
    """Finite, symmetric, and each row sums to zero over the atoms."""
    n = h.shape[0]
    assert h.shape == (n, 3, n, 3) and np.isfinite(h).all()
    flat = h.reshape(3 * n, 3 * n).astype(np.float64)
    assert np.abs(flat - flat.T).max() < H_TOL
    assert np.abs(h.astype(np.float64).sum(axis=2)).max() < H_TOL


def _vectors(n: int, seed: int = 3, count: int = 3) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(count)]


# -- the indexed layout ---------------------------------------------------------


@pytest.mark.parametrize("config", ["flagship", "wb97m-d3"])
def test_molecule_hessian_and_hvp_match_jax(models, config):
    jmodel, tmodel = models[config, "simple"]
    jcalc, tcalc = JCalculator(jmodel), TCalculator(tmodel, device="cpu")
    ref = jcalc.eval(MOL, hessian=True)
    got = tcalc.eval(MOL, hessian=True)
    assert tcalc._prep_cache["kind"] == "indexed"
    assert set(got) == {k for k in ref if k != "mol_element_counts"}  # forces come beside the Hessian
    _check_hessian(got["hessian"])
    np.testing.assert_allclose(got["hessian"], ref["hessian"], atol=H_TOL, rtol=0)
    np.testing.assert_allclose(got["forces"], ref["forces"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)
    n = len(MOL["numbers"])
    h = got["hessian"].reshape(3 * n, 3 * n).astype(np.float64)
    for v in _vectors(n):
        hv = tcalc.hessian_vector_product(MOL, v)
        np.testing.assert_allclose(hv, jcalc.hessian_vector_product(MOL, v), atol=H_TOL, rtol=0)
        np.testing.assert_allclose(hv, (h @ v.reshape(-1)).reshape(n, 3), atol=H_TOL, rtol=0)


def test_batch_hessians_are_per_structure(models):
    jmodel, tmodel = models["flagship", "simple"]
    ref = JCalculator(jmodel).eval(PAIR, forces=True, hessian=True)
    got = TCalculator(tmodel, device="cpu").eval(PAIR, forces=True, hessian=True)
    assert isinstance(got["hessian"], list) and len(got["hessian"]) == 2
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)
    for k, mol in enumerate(PAIR):
        n = len(mol["numbers"])
        assert got["hessian"][k].shape == (n, 3, n, 3)
        _check_hessian(got["hessian"][k])
        np.testing.assert_allclose(got["hessian"][k], ref["hessian"][k], atol=H_TOL, rtol=0)
        np.testing.assert_allclose(got["forces"][k], ref["forces"][k], atol=1e-5, rtol=0)


def test_periodic_hessian_with_stress_matches_jax(models):
    """A 16-atom box on the indexed layout with shifts (its simple Coulomb
    switched to DSF): stress and forces beside the Hessian."""
    jmodel, tmodel = models["wb97m-d3", "simple"]
    jcalc, tcalc = JCalculator(jmodel), TCalculator(tmodel, device="cpu")
    ref = jcalc.eval(BOX, forces=True, stress=True, hessian=True)
    got = tcalc.eval(BOX, forces=True, stress=True, hessian=True)
    assert tcalc._prep_cache["kind"] == "indexed"
    _check_hessian(got["hessian"])
    np.testing.assert_allclose(got["hessian"], ref["hessian"], atol=H_TOL, rtol=0)
    np.testing.assert_allclose(got["stress"], ref["stress"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["forces"], ref["forces"], atol=1e-5, rtol=0)
    v = _vectors(len(BOX["numbers"]), seed=4, count=1)[0]
    np.testing.assert_allclose(tcalc.hessian_vector_product(BOX, v), jcalc.hessian_vector_product(BOX, v),
                               atol=H_TOL, rtol=0)


def test_make_eval_fn_and_hvp_fn_match_jax(models):
    """The functions under the calculator on one indexed System: the padded
    (N, 3, N, 3) Hessian (padding rows zero in both) and ``make_hvp_fn``."""
    (jparams, jcfg, _aux), (tparams, tcfg, _aux2) = models["wb97m-d3", "simple"]
    jsys = JCalculator(models["wb97m-d3", "simple"][0]).prepare_system(MOL, allow_binned=False)
    tsys = TCalculator(models["wb97m-d3", "simple"][1], device="cpu").prepare_system(MOL, allow_binned=False)
    ref = jax.jit(jder.make_eval_fn(jcfg, hessian=True))(jparams, jsys)
    got = tder.make_eval_fn(tcfg, hessian=True)(tparams, tsys)
    assert got["hessian"].shape == (tsys.natoms, 3, tsys.natoms, 3)
    np.testing.assert_allclose(got["hessian"].numpy(), np.asarray(ref["hessian"]), atol=H_TOL, rtol=0)
    n = len(MOL["numbers"])
    assert not got["hessian"][n:].any() and not got["hessian"][:, :, n:].any()
    v = np.zeros((tsys.natoms, 3), np.float32)
    v[:n] = _vectors(n, seed=6, count=1)[0]
    hv = tder.make_hvp_fn(tcfg)(tparams, tsys, torch.tensor(v))
    hv_j = jax.jit(jder.make_hvp_fn(jcfg))(jparams, jsys, jnp.asarray(v))
    np.testing.assert_allclose(hv.numpy(), np.asarray(hv_j), atol=H_TOL, rtol=0)


# -- the binned layouts: the K3 rules -----------------------------------------------


def _slots(perm: np.ndarray, valid: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``v`` (n_real, 3) in input order -> the slot layout (zero on padding)."""
    out = np.zeros((len(perm), 3), np.float32)
    out[valid] = v[perm[valid]]
    return out


def _binned_hvps(models, config, data, threshold):
    """H v on the port's and JAX's binned layouts of ``data`` for three
    seeded v, each in input order."""
    jmodel, tmodel = models[config]
    jcalc = JCalculator(jmodel, binned_threshold=threshold)
    tcalc = TCalculator(tmodel, device="cpu", binned_threshold=threshold)
    jsys, tsys = jcalc.prepare_system(data), tcalc.prepare_system(data)
    jperm, tperm = np.asarray(jcalc._last_perm), tcalc._last_perm
    jvalid, tvalid = np.asarray(jsys.numbers) > 0, tsys.numbers.numpy() > 0
    jcfg = jcalc._effective_cfg(jsys.cell is not None)
    tcfg = tcalc._effective_cfg(tsys.cell is not None)
    j_hvp = jax.jit(jder.make_hvp_fn(jcfg))
    t_hvp = tder.make_hvp_fn(tcfg)
    n = int(tvalid.sum())
    out = []
    for v in _vectors(n, seed=9):
        hv_t = t_hvp(tmodel[0], tsys, torch.tensor(_slots(tperm, tvalid, v))).numpy()
        hv_j = np.asarray(j_hvp(jmodel[0], jsys, jnp.asarray(_slots(jperm, jvalid, v))))
        got, ref = np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32)
        got[tperm[tvalid]] = hv_t[tvalid]
        ref[jperm[jvalid]] = hv_j[jvalid]
        out.append((got, ref))
    return tcalc, tsys, out


def test_binned_box_hvp_matches_jax(models):
    """The 60-atom 12 A box on the binned layout (DSF by the periodic
    switch): A, B through ConvAcc and DSF through PairAcc, twice."""
    tcalc, tsys, pairs = _binned_hvps(models, ("flagship", "simple"), _box(), 0)
    assert tcalc._prep_cache["kind"] == "binned" and tsys.bins is not None
    for got, ref in pairs:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=H_TOL, rtol=0)


def test_packed_hvp_matches_jax(models):
    """Molecule bins (radius 0): simple Coulomb and both D3 sweeps through
    PairAcc, twice."""
    tcalc, tsys, pairs = _binned_hvps(models, ("wb97m-d3", "simple"), PACKED, 16)
    assert tcalc._prep_cache["kind"] == "packed"
    for got, ref in pairs:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=H_TOL, rtol=0)


def _leaves(tree, prefix=""):
    """``(path, leaf)`` of a nested parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _rebuild(tree, fn, prefix=""):
    """A copy of ``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, f"{prefix}/{i}") for i, v in enumerate(tree))
    return fn(prefix, tree)


def test_force_loss_parameter_gradient_matches_jax(models):
    """``d/dtheta sum |F|^2`` on molecule bins (the training force loss's
    second order through the K3 rules) against ``jax.grad`` of the same
    with JAX's XLA conv engine."""
    (jparams, jcfg, aux), (tparams, tcfg, _aux) = models["wb97m-d3", "simple"]
    jcalc = JCalculator((jparams, jcfg, aux), binned_threshold=16)
    tcalc = TCalculator((tparams, tcfg, aux), device="cpu", binned_threshold=16)
    jsys, tsys = jcalc.prepare_system(PACKED), tcalc.prepare_system(PACKED)
    assert tcalc._prep_cache["kind"] == "packed"

    def j_loss(params):
        def energy(c):
            return j_apply(params, jcfg, jsys.replace(coord=c), sae_external=True, conv_engine="xla")["energy"].sum()

        f = -jax.grad(energy)(jsys.coord)
        return jnp.sum(jnp.where((jsys.numbers > 0)[:, None], f, 0.0) ** 2)

    ref = dict(_leaves(jax.tree.map(np.asarray, jax.jit(jax.grad(j_loss))(jparams))))
    leaves = {}

    def leaf(path, x):
        if x.is_floating_point():
            leaves[path] = x.detach().clone().requires_grad_(True)
            return leaves[path]
        return x

    params = _rebuild(tparams, leaf)

    def t_loss(params, create_graph=True):
        coord = tsys.coord.clone().requires_grad_(True)
        energy = t_apply(params, tcfg, tsys.replace(coord=coord), sae_external=True)["energy"].sum()
        (g,) = torch.autograd.grad(energy, coord, create_graph=create_graph)
        return (torch.where((tsys.numbers > 0)[:, None], -g, 0.0) ** 2).sum()

    grads = torch.autograd.grad(t_loss(params), list(leaves.values()), allow_unused=True)
    checked = 0
    for name, grad in zip(leaves, grads):
        want = ref[name]
        got = np.zeros_like(want) if grad is None else grad.numpy()
        if name.startswith("/aev/"):
            # the radial constants (eta, shifts, rc) are differentiated as
            # JAX's XLA engine differentiates them (kernel B's constants'
            # build on the card, autograd of the plain version here)
            assert np.abs(got).max() > 0, name
        if name == "/outputs/external_dftd3/r4r2":
            # JAX's gradient here is NaN on every layout (0 x inf where a
            # real atom pairs with padding, whose r4r2 is 0: ROADMAP.md
            # section 3); the port's (rr := 1 on non-pairs) is held to
            # central differences of its own loss instead, step 1e-2 of
            # each element's r4r2 (f32 loss noise ~1e-8 over the step)
            assert np.isnan(want[[1, 6, 7, 8]]).all() and np.isfinite(got).all()
            for z in (1, 6, 7, 8):
                h = 1e-2 * float(tparams["outputs"]["external_dftd3"]["r4r2"][z])
                fd = []
                for sign in (1.0, -1.0):
                    table = tparams["outputs"]["external_dftd3"]["r4r2"].clone()
                    table[z] += sign * h
                    moved = _rebuild(tparams, lambda p, x, t=table: t if p == name else x)
                    fd.append(float(t_loss(moved, create_graph=False)))
                np.testing.assert_allclose(got[z], (fd[0] - fd[1]) / (2 * h), rtol=2e-3, atol=1e-5, err_msg=name)
            continue
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0, err_msg=name)
        checked += float(np.abs(want).max()) > 0
    assert checked >= 10


# -- routing ----------------------------------------------------------------------


def test_hessian_never_reuses_a_binned_or_packed_layout(models):
    """A forces request on a box above ``binned_threshold`` (lowered) runs
    binned; a Hessian or an HVP on the same input afterwards builds the
    indexed layout instead of reusing it, and so does a batch after a
    packed request.  A forces request after the Hessian goes binned again."""
    jmodel, tmodel = models["flagship", "simple"]
    box = _box(16, 7.0, seed=5)
    calc = TCalculator(tmodel, device="cpu", binned_threshold=8)
    forces = calc.eval(box, forces=True)
    assert calc._prep_cache["kind"] == "binned"
    hess = calc.eval(box, hessian=True)
    assert calc._prep_cache["kind"] == "indexed"
    _check_hessian(hess["hessian"])
    np.testing.assert_allclose(hess["forces"], forces["forces"], atol=1e-5, rtol=0)
    calc.eval(box, forces=True)
    assert calc._prep_cache["kind"] == "binned"
    v = _vectors(len(box["numbers"]), count=1)[0]
    hv = calc.hessian_vector_product(box, v)
    assert calc._prep_cache["kind"] == "indexed"
    ref = JCalculator(jmodel, binned_threshold=8).hessian_vector_product(box, v)
    np.testing.assert_allclose(hv, ref, atol=H_TOL, rtol=0)

    calc.eval(PACKED, forces=True)
    assert calc._prep_cache["kind"] == "packed"
    calc.eval(PACKED, hessian=True)
    assert calc._prep_cache["kind"] == "indexed"


# -- the K3 rules against finite differences (f64) -----------------------------------


def _small_grid(seed: int = 7):
    """Ten atoms in a 6 A box on 2x2x2 bins (every bin recurs at several
    offsets as a periodic image)."""
    rng = np.random.default_rng(seed)
    coord = rng.uniform(0, 6.0, size=(10, 3)).astype(np.float32)
    cell = np.eye(3, dtype=np.float32) * 6.0
    mol = {"coord": coord, "numbers": rng.choice([1, 6, 8], size=10), "cell": cell}
    grid = tB.plan_bins(cell, 10, 3.0, safety=3.0)
    system, _perm, _ovf = tB.to_binned_system(system_from_molecules([mol], CPU), grid)
    return system, rng


def test_conv_k3_rules_match_finite_differences():
    system, rng = _small_grid()
    grid, rc = system.bins, 3.0
    tab = build_conv_tables(grid, tB.stencil_radius(rc, grid))
    b, c, g, f = grid.total_bins, grid.capacity, 2, 3
    st = tcs.ConvStatic(b_tot=b, c=c, g=g, f=f, s_tot=tab["nbr"].shape[0])
    d = torch.float64
    shift = (torch.tensor(tab["push"]) + torch.tensor(tab["wraps"]) @ system.cell[0]).to(d)
    mask = (system.numbers > 0).to(d).reshape(b, c)
    fixed = (mask, torch.tensor(tab["nbr"]), torch.tensor(tab["mnbr"]), torch.tensor([1.0, 2.0], dtype=d),
             torch.tensor([2.0, rc], dtype=d))
    ins = [
        torch.tensor(rng.normal(size=(b, c, g * f)) * 0.3, dtype=d, requires_grad=True),
        system.coord.reshape(b, c, 3).to(d).requires_grad_(True),
        shift.requires_grad_(True),
        torch.tensor(rng.normal(size=(b, 4, c, g * f)), dtype=d, requires_grad=True),
    ]
    mask, nbr, mnbr, shifts_g, scal = fixed
    assert torch.autograd.gradcheck(
        lambda a, x, s, gb: ConvAccBwd.apply(a, x, s, gb, st, mask, nbr, mnbr, shifts_g, scal),
        ins, eps=1e-6, atol=1e-5, rtol=1e-4, fast_mode=True,
    )
    assert torch.autograd.gradgradcheck(
        lambda a, x, s: ConvAcc.apply(a, x, s, st, mask, nbr, mnbr, shifts_g, scal),
        ins[:3], eps=1e-6, atol=1e-5, rtol=1e-4, fast_mode=True,
    )


@pytest.mark.parametrize("name", ["dsf", "d3_cn", "d3_energy", "ewald_real", "srrep", "d3ts"])
def test_pair_k3_rules_match_finite_differences(name):
    system, rng = _small_grid()
    n = system.natoms
    real = (system.numbers > 0).double()
    term, extras = {
        "dsf": (ps.DSFTerm(alpha=0.2, dsf_rc=3.0, rc=2.0), {"q": torch.tensor(rng.normal(size=n)) * real}),
        "d3_cn": (ps.D3CNTerm(), {"rcov": torch.tensor(rng.uniform(0.5, 2.0, size=n))}),
        "d3_energy": (
            ps.D3EnergyTerm(a1=0.566, a2=3.128, s8=0.3908, r_on=2.4, r_off=3.0),
            {"p": torch.tensor(rng.uniform(0, 1, size=(n, 3))), "r": torch.tensor(rng.uniform(0, 1, size=(n, 3))),
             "rr": torch.tensor(rng.uniform(1, 3, size=n)) * real},
        ),
        "ewald_real": (ps.EwaldRealTerm(eta=1.2, rc=2.0, subtract_sr=True), {"q": torch.tensor(rng.normal(size=n)) * real}),
        "srrep": (
            ps.SRRepTerm(rc=3.0, cutoff_fn="cosine_cutoff"),
            {"alpha": torch.tensor(rng.uniform(0.5, 1.5, size=n)), "zeff": torch.tensor(rng.uniform(0.5, 3, size=n))},
        ),
        "d3ts": (  # alpha > 0 on every row, padding included, as DispParam gives it
            ps.D3TSTerm(a1=0.49, a2=3.5, s8=0.78),
            {"c6": torch.tensor(rng.uniform(1, 20, size=n)) * real, "alpha": torch.tensor(rng.uniform(1, 10, size=n)),
             "rr": torch.tensor(rng.uniform(1, 3, size=n)) * real},
        ),
    }[name]
    sys64 = system.replace(coord=system.coord.double(), cell=system.cell.double())
    st, ops = teb.pair_operands(sys64, 3.0, term, extras)
    ct = torch.tensor(rng.normal(size=(st.b_tot, st.c)), dtype=torch.float64)
    ins = [x.detach().clone().requires_grad_(True) for x in (ops["coord"], ops["ext"], ops["shift"], ct)]
    fixed = (ops["mask"], ops["nbr"], ops["inv"])
    assert torch.autograd.gradcheck(
        lambda x, e, s, c: ps.PairAccBwd.apply(x, e, s, c, st, term, *fixed),
        ins, eps=1e-6, atol=1e-5, rtol=1e-4, fast_mode=True,
    )
    assert torch.autograd.gradgradcheck(
        lambda x, e, s: ps.PairAcc.apply(x, e, s, st, term, *fixed),
        ins[:3], eps=1e-6, atol=1e-5, rtol=1e-4, fast_mode=True,
    )
