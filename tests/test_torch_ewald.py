"""The port's Ewald summation (models/ewald.py, the real-space term of
kernels D and E, the calculator's routing and MD) against the JAX package
(CPU).

- ``estimate_ewald_parameters``, ``_k_grid`` and ``attach_ewald`` equal
  JAX's (the host arithmetic is the same numpy).
- ``ewald_energy`` on the indexed layout and ``coulomb_periodic_binned``
  on the binned layout against JAX's, with the coordinate and cell
  gradients: a neutral box, a charged box, a box whose side is below twice
  the real-space cutoff (one atom meets several images of a neighbour),
  and (indexed) a batch of two different cells.
- Rock salt's Madelung constant 1.7475645 within 2e-4 on both layouts.
- ``AIMNet2Calculator`` with ``set_lrcoulomb_method("ewald")`` against
  JAX's calculator: energy, forces and stress on binned, indexed and
  batched inputs, a charged cell, the layout reuse, HVPs (Ewald and PME)
  and a dense Hessian; refused without a cell as in JAX.
- A few NVE steps of ``MDDriver`` against JAX's driver: Ewald on the
  binned engine, PME on the indexed one.

Inputs are drawn with numpy from fixed seeds.  Tolerances: energy 1e-5
relative with a floor of 1e-5 eV, forces 1e-4 eV/A, stress 1e-6 eV/A^3;
gradients of the bare Ewald energy 1e-5 of their largest magnitude; the
binned real-space sum uses JAX's rational erfc on both sides, the indexed
one the exact erfc.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu import builders as jbuilders  # noqa: E402
from aimnetcentral_tpu import constants  # noqa: E402
from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator  # noqa: E402
from aimnetcentral_tpu.dynamics import MDConfig as JMDConfig  # noqa: E402
from aimnetcentral_tpu.dynamics import MDDriver as JMDDriver  # noqa: E402
from aimnetcentral_tpu.models import AIMNet2Config as JConfig  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models import ewald as jewald  # noqa: E402
from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu.models import modules as jmodules  # noqa: E402
from aimnetcentral_tpu.ops import binned as jB  # noqa: E402
from aimnetcentral_tpu_torch import builders as tbuilders  # noqa: E402
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator  # noqa: E402
from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver  # noqa: E402
from aimnetcentral_tpu_torch.models import AIMNet2Config as TConfig  # noqa: E402
from aimnetcentral_tpu_torch.models import ewald as tewald  # noqa: E402
from aimnetcentral_tpu_torch.models import heads as theads  # noqa: E402
from aimnetcentral_tpu_torch.models import modules as tmodules  # noqa: E402
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from aimnetcentral_tpu_torch.ops import binned as tB  # noqa: E402
from test_torch_calculator import _box, _config  # noqa: E402

CPU = torch.device("cpu")
TRICLINIC = np.array([[11.0, 0.0, 0.0], [2.0, 12.0, 0.0], [1.0, -1.5, 10.0]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _energy_close(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0, atol=max(1e-5, 1e-5 * np.abs(ref).max()))


def _rel_close(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0, atol=rel * np.abs(ref).max())


# -- the discretisation --------------------------------------------------------


@pytest.mark.parametrize("cell", [np.eye(3, dtype=np.float32) * 12.0, TRICLINIC], ids=["cubic", "triclinic"])
@pytest.mark.parametrize("accuracy", [1e-6, 1e-8])
def test_parameters_and_k_grid_match_jax(cell, accuracy):
    tp = tewald.estimate_ewald_parameters(cell, 60, accuracy)
    jp = jewald.estimate_ewald_parameters(cell, 60, accuracy)
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
    np.testing.assert_array_equal(tewald._k_grid(tp.kmax), jewald._k_grid(jp.kmax))


def _batch():
    """Two boxes of different cells: 40 atoms in 12 A, 30 in the triclinic cell."""
    a = _box(40, 12.0, seed=1)
    b = _box(30, 10.0, seed=2)
    b["cell"] = TRICLINIC
    return [a, b]


@pytest.mark.parametrize("pme", [False, True])
def test_attach_ewald_matches_jax(pme):
    mols = _batch()
    jsys = jewald.attach_ewald(jbuilders.system_from_molecules(mols, cutoff=5.0, n_pad=80), 1e-6, pme=pme)
    tsys = tewald.attach_ewald(tbuilders.system_from_molecules(mols, CPU, n_pad=80), 1e-6, pme=pme)
    for k in ("ewald_kpts", "ewald_eta", "ewald_r_cutoff", "ewald_k_cutoff"):
        np.testing.assert_array_equal(getattr(tsys, k).numpy(), np.asarray(getattr(jsys, k)), err_msg=k)
    assert tsys.ewald_r_static == jsys.ewald_r_static
    assert tsys.pme_mesh == jsys.pme_mesh
    assert tsys.ewald_eta_static == tuple(float(e) for e in np.asarray(jsys.ewald_eta))


# -- the bare Ewald energy --------------------------------------------------------


def _case(name: str):
    """(molecules, per-atom charges) of a case, drawn with numpy."""
    rng = np.random.default_rng(7)
    if name == "batch":
        mols = _batch()
    elif name == "small":  # side 6 A, below twice the real-space cutoff (about 7 A)
        mols = [_box(16, 6.0, seed=3)]
    else:
        mols = [_box(60, 12.0)]
    n = sum(len(m["numbers"]) for m in mols)
    q = rng.normal(size=n).astype(np.float32) * 0.4
    if name != "charged":
        off = 0
        for m in mols:
            k = len(m["numbers"])
            q[off : off + k] -= q[off : off + k].mean()
            off += k
    return mols, q


CASES = ["neutral", "charged", "small", "batch"]


@pytest.mark.parametrize("name", CASES)
def test_indexed_ewald_matches_jax(name):
    """Energy and its coordinate and cell gradients on the indexed layout,
    each package on its own lists at the largest real-space cutoff."""
    mols, q = _case(name)
    n_pad = 96
    acc = 1e-6
    r_cut = max(jewald.estimate_ewald_parameters(m["cell"], len(m["numbers"]), acc).r_cutoff for m in mols)
    jsys = jewald.attach_ewald(
        jbuilders.system_from_molecules(mols, cutoff=5.0, lr_cutoff=r_cut, n_pad=n_pad), acc
    )
    tsys = tewald.attach_ewald(
        tbuilders.system_from_molecules(mols, CPU, n_pad=n_pad, cutoff=5.0, lr_cutoff=r_cut, build_nbmat=True), acc
    )
    qp = np.zeros(n_pad, np.float32)
    qp[: len(q)] = q

    def jfn(coord, cell):
        s = jsys.replace(coord=coord, cell=cell)
        return jewald.coulomb_periodic({"charges": jnp.asarray(qp)}, s).sum()

    je = jewald.coulomb_periodic({"charges": jnp.asarray(qp)}, jsys)
    jg = jax.grad(jfn, argnums=(0, 1))(jsys.coord, jsys.cell)
    coord = tsys.coord.clone().requires_grad_(True)
    cell = tsys.cell.clone().requires_grad_(True)
    te = tewald.coulomb_periodic({"charges": torch.tensor(qp)}, tsys.replace(coord=coord, cell=cell))
    tg = torch.autograd.grad(te.sum(), (coord, cell))
    _energy_close(te.detach().numpy(), je)
    for t, j in zip(tg, jg):
        _rel_close(t.numpy(), np.asarray(j))
    assert np.isfinite(te.detach().numpy()).all()


def _binned_pair(mols, n_pad: int, acc: float, safety: float = 1.5):
    """One box on the binned layout in both packages: SR grid at 5 A, the LR
    twin grid at the real-space cutoff, Ewald attached."""
    mol = mols[0]
    cell = mol["cell"]
    n = len(mol["numbers"])
    r_cut = jewald.estimate_ewald_parameters(cell, n, acc).r_cutoff
    jg, tg = jB.plan_bins(cell, n, 5.0, safety=3.0), tB.plan_bins(cell, n, 5.0, safety=3.0)
    jl = jB.plan_lr_bins(cell, n, r_cut, safety=safety)
    tl = tB.plan_lr_bins(cell, n, r_cut, safety=safety)
    bj, pj, ovf = jax.jit(jB.to_binned_system, static_argnums=(1, 2))(
        jbuilders.system_from_molecules(mols, build_nbmat=False, n_pad=n_pad), jg, jl
    )
    bt, pt, _o = tB.to_binned_system(tbuilders.system_from_molecules(mols, CPU, n_pad=n_pad), tg, tl)
    assert int(ovf) == 0
    return jewald.attach_ewald(bj, acc), tewald.attach_ewald(bt, acc), np.asarray(pj), pt.numpy()


@pytest.mark.parametrize("name", ["neutral", "charged", "small"])
def test_binned_ewald_matches_jax(name):
    """``coulomb_periodic_binned`` (the real-space sum through the pair
    sweep on the LR grid, the reciprocal part plain) against JAX's, with the
    coordinate and cell gradients."""
    mols, q = _case(name)
    bj, bt, pj, pt = _binned_pair(mols, 96, 1e-6)
    np.testing.assert_array_equal(pt, pj)  # the same slot layout
    qp = np.zeros(96, np.float32)
    qp[: len(q)] = q
    qs = qp[pt]
    if name == "small":
        radius = tB.stencil_radius(bt.ewald_r_static, bt.lr_bins)
        assert min(bt.lr_bins.nbins) < 2 * radius + 1  # bins recur at several offsets

    def jfn(coord, cell):
        return jewald.coulomb_periodic_binned({"charges": jnp.asarray(qs)}, bj.replace(coord=coord, cell=cell)).sum()

    je = jewald.coulomb_periodic_binned({"charges": jnp.asarray(qs)}, bj)
    jg = jax.grad(jfn, argnums=(0, 1))(bj.coord, bj.cell)
    coord = bt.coord.clone().requires_grad_(True)
    cell = bt.cell.clone().requires_grad_(True)
    te = tewald.coulomb_periodic_binned({"charges": torch.tensor(qs)}, bt.replace(coord=coord, cell=cell))
    tg = torch.autograd.grad(te.sum(), (coord, cell))
    _energy_close(te.detach().numpy(), je)
    for t, j in zip(tg, jg):
        _rel_close(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("layout", ["indexed", "binned"])
def test_madelung_rock_salt(layout):
    """Rock salt's Madelung constant from the Ewald energy of its
    conventional cell (8 ions, a = 5 A, accuracy 1e-8: the real-space
    cutoff, 8.6 A, exceeds the cell's side)."""
    a = 5.0
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5],
                     [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [0.5, 0.5, 0.5]])
    mol = {"coord": (frac * a).astype(np.float32), "numbers": np.array([11] * 4 + [17] * 4),
           "cell": np.eye(3, dtype=np.float32) * a}
    q8 = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float32)
    acc = 1e-8
    r_cut = tewald.estimate_ewald_parameters(mol["cell"], 8, acc).r_cutoff
    assert r_cut > a
    if layout == "indexed":
        sys = tewald.attach_ewald(
            tbuilders.system_from_molecules([mol], CPU, n_pad=16, cutoff=4.0, lr_cutoff=r_cut, build_nbmat=True), acc
        )
        qp = np.zeros(16, np.float32)
        qp[:8] = q8
        e = float(tewald.coulomb_periodic({"charges": torch.tensor(qp)}, sys)[0])
    else:
        _bj, bt, _pj, pt = _binned_pair([mol], 16, acc, safety=3.0)
        qp = np.zeros(16, np.float32)
        qp[:8] = q8
        e = float(tewald.coulomb_periodic_binned({"charges": torch.tensor(qp[pt])}, bt)[0])
    ke = constants.Hartree * constants.Bohr
    madelung = -e * (a / 2.0) / (4.0 * ke)  # E = -4 M ke / r0, r0 = a / 2
    assert madelung == pytest.approx(1.7475645, abs=2e-4)


# -- the calculator --------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """JAX's and the port's model (the flagship's heads at narrow widths,
    Coulomb by Ewald) with the same parameters."""
    jcfg, tcfg = _config(JConfig, jheads, jmodules), _config(TConfig, theads, tmodules)
    jparams = j_init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jparams, jcfg), (tparams, tcfg)


def _calcs(models, method: str, threshold: int, **kw):
    (jp, jc), (tp, tc) = models
    jcalc = JCalculator((jp, jc, {"sae": {}}), binned_threshold=threshold, **kw)
    tcalc = TCalculator((tp, tc, {"sae": {}}), device="cpu", binned_threshold=threshold, **kw)
    jcalc.set_lrcoulomb_method(method)
    tcalc.set_lrcoulomb_method(method)
    return jcalc, tcalc


def _compare(got, ref, keys):
    for k in keys:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, k
        if k == "energy":
            _energy_close(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol={"forces": 1e-4, "stress": 1e-6}[k], err_msg=k)


CALC_INPUTS = {
    "binned": (lambda: _box(), 0, "binned"),
    "binned-charged": (lambda: {**_box(), "charge": 1.0}, 0, "binned"),
    "binned-small": (lambda: _box(24, 7.0, seed=4), 0, "binned"),
    "indexed": (lambda: _box(), 1024, "indexed"),
    "indexed-charged": (lambda: {**_box(), "charge": -1.0}, 1024, "indexed"),
    "batch": (_batch, 1024, "indexed"),
}


@pytest.mark.parametrize("name", list(CALC_INPUTS))
def test_calculator_matches_jax(models, name):
    make, threshold, kind = CALC_INPUTS[name]
    data = make()
    jcalc, tcalc = _calcs(models, "ewald", threshold)
    stress = name != "batch"
    ref = jcalc.eval(data, forces=True, stress=stress)
    got = tcalc.eval(data, forces=True, stress=stress)
    _compare(got, ref, ("energy", "forces") + (("stress",) if stress else ()))
    assert tcalc._prep_cache["kind"] == kind
    system = tcalc._prep_cache["system"]
    assert system.ewald_kpts is not None and system.pme_mesh is None
    if kind == "binned":
        # the LR grid reaches the real-space cutoff
        radius = tB.stencil_radius(system.ewald_r_static, system.lr_bins)
        assert radius * system.lr_bins.edge_hint >= system.ewald_r_static + system.lr_bins.margin
    if name == "binned":  # a reused layout keeps the discretisation
        moved = {**data, "coord": data["coord"] + np.float32(0.05)}
        again = tcalc.eval(moved, forces=True, stress=True)
        assert tcalc._prep_cache["system"].ewald_kpts is system.ewald_kpts
        _compare(again, jcalc.eval(moved, forces=True, stress=True), ("energy", "forces", "stress"))


def test_ewald_needs_a_cell(models):
    jcalc, tcalc = _calcs(models, "ewald", 1024)
    gas = {k: v for k, v in _box().items() if k != "cell"}
    for calc in (jcalc, tcalc):
        with pytest.raises(ValueError, match="periodic cell"):
            calc.eval(gas)


@pytest.mark.parametrize("method", ["ewald", "pme"])
def test_hvp_matches_jax(models, method):
    """H v with Ewald and with PME on a small box (the indexed layout, plain
    torch twice differentiated), within 1e-5 of its largest magnitude."""
    data = _box(24, 7.0, seed=4)
    jcalc, tcalc = _calcs(models, method, 1024)
    v = np.random.default_rng(5).normal(size=(24, 3)).astype(np.float32)
    ref = np.asarray(jcalc.hessian_vector_product(data, v))
    got = tcalc.hessian_vector_product(data, v)
    assert np.isfinite(got).all()
    _rel_close(got, ref)


def test_dense_hessian_matches_jax(models):
    """The dense Hessian with Ewald on a 10-atom box against JAX's, within
    1e-5 of its largest magnitude (JAX leaves the padding rows to jacfwd;
    both are sliced to the real atoms)."""
    data = _box(10, 6.0, seed=6)
    jcalc, tcalc = _calcs(models, "ewald", 1024)
    ref = np.asarray(jcalc.eval(data, hessian=True)["hessian"])
    got = tcalc.eval(data, hessian=True)["hessian"]
    assert got.shape == (10, 3, 10, 3)
    _rel_close(got, ref)


# -- MD ----------------------------------------------------------------------------


@pytest.mark.parametrize("method,engine", [("ewald", "binned"), ("pme", "indexed")])
def test_md_nve_matches_jax(models, method, engine):
    """NVE steps with Ewald on the binned engine (skin 0.2) and with PME on
    the indexed engine (cell lists with shifts, the LR list at the
    real-space cutoff), at the head's accuracy 1e-4 (a 10.4 A real-space
    cutoff: 2x2x2 LR bins): per-step potential energy and temperature
    against JAX's driver with the same initial velocities."""
    (jp, jc), (tp, tc) = models
    ew = lambda cfg, heads: dataclasses.replace(cfg, outputs=tuple(  # noqa: E731
        (n, dataclasses.replace(h, method=method, ewald_accuracy=1e-4) if isinstance(h, heads.LRCoulombHead) else h)
        for n, h in cfg.outputs))
    mol = _box()
    md = dict(dt_fs=0.5, thermostat="nve", skin=0.2, precision="exact")
    jd = JMDDriver(jp, ew(jc, jheads), jbuilders.system_from_molecules([mol], build_nbmat=False, n_pad=64),
                   JMDConfig(**md), engine=engine)
    td = MDDriver(tp, ew(tc, theads), tbuilders.system_from_molecules([mol], CPU, n_pad=64), MDConfig(**md),
                  device="cpu", engine=engine)
    assert td._ewald_rc == jd._ewald_rc
    if engine == "binned":
        assert td.lr_grid.nbins == jd.lr_grid.nbins
    else:
        assert td.lr_spec.cutoff == jd.lr_spec.cutoff == jd._ewald_rc + td.md.lr_skin
    from test_torch_md import _inject, _velocities

    v0 = _velocities(mol["numbers"])
    _inject(jd, v0, jnp.asarray)
    _inject(td, v0, torch.as_tensor)
    jo, to = jd.run(4, chunk=2), td.run(4, chunk=2)
    np.testing.assert_allclose(to["epot"], jo["epot"], rtol=1e-5)
    np.testing.assert_allclose(to["temperature"], jo["temperature"], rtol=1e-5)
