"""The port's indexed layout and the calculator's routing around
``binned_threshold`` against the JAX package (CPU).

- The ops and terms on identical neighbor matrices (JAX's, carried across):
  ``gather_nb``, ``calc_distances`` with shifts, ``_calc_aev``, ``_conv_sv``
  (with and without d2features), ``coulomb_sr``, ``coulomb_simple``,
  ``coulomb_dsf`` and ``dftd3_energy``, each with its coordinate gradient.
- The host builders: every neighbor row holds JAX's set of (neighbor,
  image) pairs.
- ``AIMNet2Calculator`` with a narrow model of the flagship's shape (the
  flagship head set and the wB97M-D3 head set, JAX parameters carried
  across by the weights bridge) on two molecules, a batch given as a list
  and as (B, N, 3), a periodic box below ``binned_threshold`` (with
  stress), and a gas-phase DSF cluster above it on the binned grid.
- The committed validation model reproduces tools/validate_baseline.json.

Inputs are drawn with numpy from fixed seeds.  Tolerances: energy 1e-5 eV,
forces 1e-5 eV/A, stress 1e-6 eV/A^3, charges 1e-5; the ops 1e-5 of their
largest magnitude.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu import builders as jbuilders
from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator
from aimnetcentral_tpu.models import AIMNet2Config as JConfig
from aimnetcentral_tpu.models import aimnet2 as jaimnet2
from aimnetcentral_tpu.models import engine_binned as jeb
from aimnetcentral_tpu.models import aimnet2_init as j_init
from aimnetcentral_tpu.models import heads as jheads
from aimnetcentral_tpu.models import lr as jlr
from aimnetcentral_tpu.models import modules as jmodules
from aimnetcentral_tpu.ops import binned as jB
from aimnetcentral_tpu.ops import math as jmath
from aimnetcentral_tpu.ops import neighbors as jneighbors
from aimnetcentral_tpu.validation.observables import reference_systems
from aimnetcentral_tpu_torch import builders as tbuilders
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator
from aimnetcentral_tpu_torch.models import AEVConfig as TAEVConfig
from aimnetcentral_tpu_torch.models import AIMNet2Config as TConfig
from aimnetcentral_tpu_torch.models import aimnet2 as taimnet2
from aimnetcentral_tpu_torch.models import engine_binned as teb
from aimnetcentral_tpu_torch.models import heads as theads
from aimnetcentral_tpu_torch.models import lr as tlr
from aimnetcentral_tpu_torch.models import modules as tmodules
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy
from aimnetcentral_tpu_torch.ops import binned as tB
from aimnetcentral_tpu_torch.ops import math as tmath
from aimnetcentral_tpu_torch.ops import nb as tnb
from aimnetcentral_tpu_torch.ops import neighbors as tneighbors
from aimnetcentral_tpu_torch.system import System

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NARROW = dict(nfeature=4, ncomb_v=4, hidden=((32, 16), (32, 16), (32, 16)), aim_size=16)
D3 = dict(s8=0.3908, a1=0.566, a2=3.128, cutoff=15.0)  # model_registry.yaml:13-16
TOL = {"energy": 1e-5, "forces": 1e-5, "charges": 1e-5, "stress": 1e-6}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (test files run side by side
    in worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- inputs -------------------------------------------------------------------


def _cluster(n: int, seed: int = 0, spacing: float = 2.2):
    """The ``n`` atoms nearest the centre of a jittered CHNO lattice
    (spacing 2.2 A, about the density of chip_smoke.py's boxes)."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil((3 * n) ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)
    coord = (grid + rng.uniform(-0.15, 0.15, size=grid.shape)) * spacing
    numbers = rng.choice([1, 6, 7, 8], size=len(grid), p=[0.5, 0.35, 0.05, 0.1])
    keep = np.argsort(np.linalg.norm(coord - coord.mean(0), axis=1), kind="stable")[:n]
    return coord[keep].astype(np.float32), numbers[keep]


def _mol(n: int, seed: int, charge: float = 0.0) -> dict:
    coord, numbers = _cluster(n, seed)
    return {"coord": coord, "numbers": numbers, "charge": charge}


def _box(n=60, a=12.0, seed=0):
    """Jittered lattice (minimum separation), CHNO, some atoms outside the cell."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)[:n]
    coord = (grid + 0.5) * (a / m) + rng.uniform(-0.15, 0.15, size=(n, 3)) * (a / m)
    coord[: n // 6] += a  # periodic images of some atoms
    numbers = rng.choice([1, 6, 7, 8], size=n, p=[0.5, 0.35, 0.05, 0.1])
    return {"coord": coord.astype(np.float32), "numbers": numbers, "cell": np.eye(3, dtype=np.float32) * a}


def _dense(mols: list[dict]) -> dict:
    """A list of molecules as one (B, N, 3) batch with zero-padded numbers."""
    n = max(len(m["numbers"]) for m in mols)
    coord = np.zeros((len(mols), n, 3), np.float32)
    numbers = np.zeros((len(mols), n), np.int64)
    for i, m in enumerate(mols):
        coord[i, : len(m["numbers"])] = m["coord"]
        numbers[i, : len(m["numbers"])] = m["numbers"]
    return {"coord": coord, "numbers": numbers, "charge": np.array([m["charge"] for m in mols])}


MOLS = [_mol(7, 1), _mol(12, 2, charge=1.0), _mol(9, 3)]
# name -> (input, binned_threshold, stress, Coulomb method)
INPUTS = {
    "mol-7": (MOLS[0], 1024, False, "simple"),
    "mol-12": (MOLS[1], 1024, False, "simple"),
    "batch-list": (MOLS, 1024, False, "simple"),
    "batch-dense": (_dense(MOLS), 1024, False, "simple"),
    "box": (_box(), 1024, True, "simple"),  # periodic: switches to dsf
    "box-split": (_box(), 1024, True, "simple"),  # D3 cutoff 8 A: split lists
    "cluster-dsf": (_mol(80, 4), 64, False, "dsf"),  # gas phase, binned grid
}


# -- models -------------------------------------------------------------------


def _outputs(heads, modules, d3: bool, method: str = "simple"):
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
        ("lrcoulomb", heads.LRCoulombHead(rc=4.6, key_in="charges", key_out="energy", method=method)),
    )
    if d3:
        outputs += (("external_dftd3", heads.DFTD3Head(**D3)),)
    return outputs


@pytest.fixture(scope="module")
def models():
    """``{(head set, Coulomb method): (jax model, port model)}`` with the
    same parameters; non-zero SAE so the host float64 shift runs."""
    sae = {"atomic_shift": np.linspace(-10.0, -1.0, 64)}
    out = {}
    for d3 in (False, True):
        jcfg = JConfig(outputs=_outputs(jheads, jmodules, d3), **NARROW)
        tcfg = TConfig(outputs=_outputs(theads, tmodules, d3), **NARROW)
        jparams = j_init(jax.random.key(0), jcfg)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
        name = "wb97m-d3" if d3 else "flagship"
        for method in ("simple", "dsf"):
            jc = dataclasses.replace(jcfg, outputs=_outputs(jheads, jmodules, d3, method))
            tc = dataclasses.replace(tcfg, outputs=_outputs(theads, tmodules, d3, method))
            out[name, method] = (jparams, jc, {"sae": sae}), (tparams, tc, {"sae": sae})
    return out


def _compare(got: dict, ref: dict, keys=("energy", "forces", "charges")):
    for k in keys:
        assert got[k].shape == np.asarray(ref[k]).shape, k
        np.testing.assert_allclose(got[k], ref[k], atol=TOL[k], rtol=0, err_msg=k)


def _d3_cutoff(model, cutoff: float):
    """``model`` with its D3 head's cutoff set to ``cutoff``."""
    params, cfg, aux = model
    outputs = tuple((n, dataclasses.replace(h, cutoff=cutoff) if n == "external_dftd3" else h) for n, h in cfg.outputs)
    return params, dataclasses.replace(cfg, outputs=outputs), aux


@pytest.mark.parametrize(
    "name,config",
    [
        pytest.param(name, config, id=f"{name}-{config}")
        for name in INPUTS
        for config in ("flagship", "wb97m-d3")
        if not (name == "box-split" and config == "flagship")  # no D3 list to split off
    ],
)
def test_calculator_matches_jax(models, config, name):
    data, threshold, stress, method = INPUTS[name]
    jmodel, tmodel = models[config, method]
    if name == "box-split":
        # DSF at 15 A and D3 at 8 A differ by more than 20%: Coulomb and D3
        # read a list each
        jmodel, tmodel = _d3_cutoff(jmodel, 8.0), _d3_cutoff(tmodel, 8.0)
    ref = JCalculator(jmodel, binned_threshold=threshold).eval(data, forces=True, stress=stress)
    calc = TCalculator(tmodel, device="cpu", binned_threshold=threshold)
    got = calc.eval(data, forces=True, stress=stress)
    _compare(got, ref, ("energy", "forces", "charges") + (("stress",) if stress else ()))
    system = calc._prep_cache["system"]
    assert (system.bins is not None) == (name == "cluster-dsf")
    if name.startswith("box"):
        split = name == "box-split"
        assert (system.nbmat_lr is None) == split
        assert (system.nbmat_coulomb is not None) == (system.nbmat_dftd3 is not None) == split
    if system.bins is None:
        # the fill value is the padding last row, never a real atom
        assert system.natoms % 16 == 0 and int(system.numbers[-1]) == 0
        assert int(system.nbmat.max()) == system.pad_idx and system.nbmat.dtype == torch.int64
    assert np.abs(got["forces"].astype(np.float64).sum(0)).max() < 1e-4  # translation invariance


def test_batch_is_its_molecules(models):
    """A batch gives each molecule's own energy and forces (both inputs)."""
    _jm, tmodel = models["flagship", "simple"]
    calc = TCalculator(tmodel, device="cpu", reuse_skin=0.0)
    alone = [calc.eval(m, forces=True) for m in MOLS]
    for data in (MOLS, _dense(MOLS)):
        got = calc.eval(data, forces=True)
        np.testing.assert_allclose(got["energy"], [a["energy"][0] for a in alone], atol=1e-5)
        np.testing.assert_allclose(got["forces"], np.concatenate([a["forces"] for a in alone]), atol=1e-5)


# -- ops and terms on identical neighbor matrices ----------------------------------


def _port_system(jsys) -> System:
    """JAX's indexed System carried across field by field."""
    fields = {}
    for f in dataclasses.fields(System):
        v = getattr(jsys, f.name, None)
        if v is None or f.name in ("bins", "lr_bins", "species"):
            fields[f.name] = v
        elif f.name.startswith("nbmat") or f.name in ("numbers", "mol_idx"):
            fields[f.name] = torch.as_tensor(np.asarray(v).astype(np.int64))
        else:
            fields[f.name] = torch.as_tensor(np.array(v))
    return System(**fields)


@pytest.fixture(scope="module")
def lists():
    """A 60-atom periodic box and a two-molecule gas-phase batch on the
    indexed layout, built by the JAX package: SR list at 5.6 A, the box
    with a 15.6 A shared LR list, the batch all-pairs."""
    box = _box()
    jbox = jbuilders.system_from_molecules([box], cutoff=5.6, lr_cutoff=15.6, n_pad=64)
    jgas = jbuilders.system_from_molecules(MOLS[:2], n_pad=32)
    return {"box": (jbox, _port_system(jbox)), "gas": (jgas, _port_system(jgas))}


def _close(t, j, rel=1e-5):
    j = np.asarray(j, dtype=np.float64)
    np.testing.assert_allclose(t.detach().double().numpy(), j, rtol=0, atol=rel * max(np.abs(j).max(), 1e-30))


def test_gather_nb_and_pair_mask(lists):
    jsys, tsys = lists["box"]
    x = np.random.default_rng(5).normal(size=(tsys.natoms, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(tnb.gather_nb(torch.tensor(x), tsys.nbmat).numpy(), np.asarray(x)[np.asarray(jsys.nbmat)])
    np.testing.assert_array_equal(tnb.pair_mask(tsys.nbmat).numpy(), np.asarray(jsys.nbmat) != tsys.pad_idx)


@pytest.mark.parametrize("layout", ["box", "gas"])
def test_calc_distances(lists, layout):
    """Distances, displacements and the gradient of a weighted distance sum
    in the coordinates and (with shifts) the cell."""
    jsys, tsys = lists[layout]
    w = np.random.default_rng(6).normal(size=tuple(jsys.nbmat.shape)).astype(np.float32)

    def jfn(coord, cell):
        d, _r = jmath.calc_distances(coord, jsys.nbmat, jsys.shifts, cell, jsys.mol_idx)
        return (jnp.where(jsys.nbmat != jsys.pad_idx, d, 0.0) * w).sum()

    jd, jr = jmath.calc_distances(jsys.coord, jsys.nbmat, jsys.shifts, jsys.cell, jsys.mol_idx)
    coord = tsys.coord.clone().requires_grad_(True)
    cell = tsys.cell.clone().requires_grad_(True) if tsys.cell is not None else None
    td, tr = tmath.calc_distances(coord, tsys.nbmat, tsys.shifts, cell, tsys.mol_idx)
    _close(td, jd, 1e-6)
    _close(tr, jr, 1e-6)
    loss = (torch.where(tnb.pair_mask(tsys.nbmat), td, 0.0) * torch.tensor(w)).sum()
    if cell is None:
        jg = jax.jit(jax.grad(jfn))(jsys.coord, None)
        (tg,) = torch.autograd.grad(loss, [coord])
        _close(tg, jg)
    else:
        jg, jgc = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jsys.coord, jsys.cell)
        tg, tgc = torch.autograd.grad(loss, [coord, cell])
        _close(tg, jg)
        _close(tgc, jgc)


@pytest.fixture(scope="module")
def aev_params(models):
    jmodel, tmodel = models["flagship", "simple"]
    return jmodel[0], jmodel[1], tmodel[0]


@pytest.mark.parametrize("layout", ["box", "gas"])
def test_calc_aev(lists, aev_params, layout):
    jsys, tsys = lists[layout]
    jparams, jcfg, tparams = aev_params
    jd, jr = jmath.calc_distances(jsys.coord, jsys.nbmat, jsys.shifts, jsys.cell, jsys.mol_idx)
    td, tr = tmath.calc_distances(tsys.coord, tsys.nbmat, tsys.shifts, tsys.cell, tsys.mol_idx)
    jg = jaimnet2._calc_aev(jparams, jcfg, jd, jr, jsys.nbmat != jsys.pad_idx)
    tg = taimnet2._calc_aev(tparams, td, tr, tnb.pair_mask(tsys.nbmat))
    _close(tg, jg, 1e-6)


@pytest.mark.parametrize("d2features", [True, False])
def test_conv_sv(lists, aev_params, d2features):
    """The indexed convolution and its gradient in the features and the
    coordinates, on the periodic box's list."""
    jsys, tsys = lists["box"]
    jparams, jcfg, tparams = aev_params
    rng = np.random.default_rng(7)
    n, c, g = tsys.natoms, 4, 16
    a = rng.normal(size=(n, c, g) if d2features else (n, c)).astype(np.float32)
    a[-1] = 0.0  # the padding row
    agh = np.asarray(jparams["conv_a"]["agh"])
    wout = rng.normal(size=(n, c * g + c * agh.shape[-1])).astype(np.float32)

    def jfn(a_, coord):
        d, r = jmath.calc_distances(coord, jsys.nbmat, jsys.shifts, jsys.cell, jsys.mol_idx)
        gsv = jaimnet2._calc_aev(jparams, jcfg, d, r, jsys.nbmat != jsys.pad_idx)
        return (jaimnet2._conv_sv(agh, a_, gsv, jsys.nbmat, d2features) * wout).sum()

    ta = torch.tensor(a, requires_grad=True)
    coord = tsys.coord.clone().requires_grad_(True)
    td, tr = tmath.calc_distances(coord, tsys.nbmat, tsys.shifts, tsys.cell, tsys.mol_idx)
    gsv = taimnet2._calc_aev(tparams, td, tr, tnb.pair_mask(tsys.nbmat))
    out = taimnet2._conv_sv(torch.tensor(agh), ta, gsv, tsys.nbmat, d2features)
    jd, jr = jmath.calc_distances(jsys.coord, jsys.nbmat, jsys.shifts, jsys.cell, jsys.mol_idx)
    jout = jaimnet2._conv_sv(agh, a, jaimnet2._calc_aev(jparams, jcfg, jd, jr, jsys.nbmat != jsys.pad_idx),
                             jsys.nbmat, d2features)
    _close(out, jout)
    ga, gc = torch.autograd.grad((out * torch.tensor(wout)).sum(), [ta, coord])
    jga, jgc = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jnp.asarray(a), jsys.coord)
    _close(ga, jga)
    _close(gc, jgc)


def _charges(n: int, seed: int = 8) -> np.ndarray:
    q = 0.3 * np.random.default_rng(seed).normal(size=n).astype(np.float32)
    q[-1] = 0.0
    return q


TERMS = {  # name -> energy(lr module, data, system); dftd3_energy takes the D3 tables instead
    "coulomb_sr": lambda lr_, d, s: lr_.coulomb_sr(d, s, 4.6, "exp"),
    "coulomb_simple": lambda lr_, d, s: lr_.coulomb_simple(d, s, 4.6, "exp", True),
    "coulomb_dsf": lambda lr_, d, s: lr_.coulomb_dsf(d, s, 4.6, 0.2, 15.0, "cosine", True),
    "dftd3_energy": None,
}


@pytest.mark.parametrize("layout", ["box", "gas"])
@pytest.mark.parametrize("term", list(TERMS))
def test_lr_terms(lists, layout, term):
    """Each long-range term's per-molecule energy and its coordinate
    gradient."""
    jsys, tsys = lists[layout]
    q = _charges(tsys.natoms)
    jt = jheads.head_init(None, jheads.DFTD3Head(**D3))
    tables = {k: torch.as_tensor(v) for k, v in jt.items()}

    def jfn(coord):
        s = jsys.replace(coord=coord)
        if term == "dftd3_energy":
            return jlr.dftd3_energy({}, s, jt, 0.566, 3.128, 0.3908, 1.0, 12.0, 15.0)
        return TERMS[term](jlr, {"charges": jnp.asarray(q)}, s)

    def tfn(coord):
        s = tsys.replace(coord=coord)
        if term == "dftd3_energy":
            return tlr.dftd3_energy({}, s, tables, 0.566, 3.128, 0.3908, 1.0, 12.0, 15.0)
        return TERMS[term](tlr, {"charges": torch.tensor(q)}, s)

    coord = tsys.coord.clone().requires_grad_(True)
    e = tfn(coord)
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(jfn(jsys.coord)), rtol=1e-5, atol=1e-6)
    (g,) = torch.autograd.grad(e.sum(), [coord])
    _close(g, jax.jit(jax.grad(lambda c: jfn(c).sum()))(jsys.coord))


def test_srcoulomb_head(lists):
    """The SR Coulomb head subtracts ``coulomb_sr`` from the energy on the
    indexed layout, as JAX's does, and on the binned layout of the same box
    (the SR Coulomb term of the pair sweep) gives the same energy."""
    jsys, tsys = lists["box"]
    q = _charges(tsys.natoms)
    jd = {"charges": jnp.asarray(q), "energy": jnp.ones(1)}
    td = {"charges": torch.tensor(q), "energy": torch.ones(1)}
    ref = jheads.head_apply(jheads.SRCoulombHead(envelope="cosine"), {}, jd, jsys)["energy"]
    got = theads.head_apply(theads.SRCoulombHead(envelope="cosine"), {}, td, tsys)["energy"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    box = _box()
    grid = tB.plan_bins(box["cell"], len(box["numbers"]), 5.6, safety=3.0)
    bsys, perm, ovf = tB.to_binned_system(tbuilders.system_from_molecules([box], CPU, n_pad=64), grid, None)
    assert not ovf.any()
    q_slots = torch.where(bsys.numbers > 0, torch.tensor(q)[perm], 0.0)
    binned = theads.head_apply(theads.SRCoulombHead(envelope="cosine"), {},
                               {"charges": q_slots, "energy": torch.ones(1)}, bsys)["energy"]
    np.testing.assert_allclose(binned.numpy(), np.asarray(ref), rtol=1e-5)


def test_d3_forces_stay_finite_with_padding_and_isolated_atoms():
    """D3 on the indexed layout with padding rows (n_pad well above the real
    atoms), an atom 40 A from the rest of its molecule, and a molecule of
    one atom (a neighbor row of fill values only): the energy and the
    forces are finite and are JAX's."""
    mol = _mol(9, 5)
    mol["coord"] = np.concatenate([mol["coord"], [[40.0, 0.0, 0.0]]]).astype(np.float32)
    mol["numbers"] = np.concatenate([mol["numbers"], [6]])
    lone = {"coord": np.zeros((1, 3), np.float32), "numbers": np.array([8]), "charge": 0.0}
    jsys = jbuilders.system_from_molecules([mol, lone], n_pad=32)
    tsys = _port_system(jsys)
    assert bool((tsys.nbmat[len(mol["numbers"])] == tsys.pad_idx).all())  # the lone atom's row
    jt = jheads.head_init(None, jheads.DFTD3Head(**D3))
    tables = {k: torch.as_tensor(v) for k, v in jt.items()}
    coord = tsys.coord.clone().requires_grad_(True)
    e = tlr.dftd3_energy({}, tsys.replace(coord=coord), tables, 0.566, 3.128, 0.3908)
    (g,) = torch.autograd.grad(e.sum(), [coord])
    assert bool(torch.isfinite(e).all()) and bool(torch.isfinite(g).all())
    jg = jax.jit(jax.grad(lambda c: jlr.dftd3_energy({}, jsys.replace(coord=c), jt, 0.566, 3.128, 0.3908).sum()))(
        jsys.coord)
    _close(g, jg)
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(
        jlr.dftd3_energy({}, jsys, jt, 0.566, 3.128, 0.3908)), rtol=1e-5)


def test_binned_d3_matches_jax_at_high_coordination():
    """A dense cluster (1.4 A spacing) whose coordination numbers run far
    above every D3 reference, on the gas-phase grid: the port's binned D3
    energy and coordinate gradient are JAX's ``dftd3_binned``.  Both
    packages zero the C6 of an atom whose unshifted Gaussian weights sum
    below 1e-12, where the indexed D3 shifts them and keeps it (ROADMAP.md
    section 3: -3.35 against -9.68 eV on this cluster)."""
    coord, numbers = _cluster(80, 5, spacing=1.4)
    mol = {"coord": coord, "numbers": numbers}
    t = jheads.head_init(None, jheads.DFTD3Head(**D3))
    extent = (coord.min(0), coord.max(0))
    grids = [
        (B.plan_bins(None, 80, 5.6, extent=extent, safety=8.0),
         B.plan_lr_bins(None, 80, 15.0, extent=extent, safety=4.0, margin=0.6))
        for B in (jB, tB)
    ]
    bj, _pj, ovf_j = jax.jit(jB.to_binned_system, static_argnums=(1, 2))(
        jbuilders.system_from_molecules([mol], n_pad=96, build_nbmat=False), *grids[0])
    bt, _pt, ovf_t = tB.to_binned_system(tbuilders.system_from_molecules([mol], CPU, n_pad=96), *grids[1])
    assert not bool(np.asarray(ovf_j).any()) and not bool(ovf_t.any())
    kw = dict(a1=0.566, a2=3.128, s8=0.3908)
    ej, gj = jax.jit(jax.value_and_grad(lambda c: jeb.dftd3_binned(bj.replace(coord=c), t, **kw).sum()))(bj.coord)
    coord_t = bt.coord.clone().requires_grad_(True)
    et = teb.dftd3_binned(bt.replace(coord=coord_t), {k: torch.as_tensor(v) for k, v in t.items()}, **kw).sum()
    (gt,) = torch.autograd.grad(et, [coord_t])
    np.testing.assert_allclose(float(et.detach()), float(ej), rtol=1e-5)
    _close(gt, gj)


# -- host builders ----------------------------------------------------------------------


def _row_sets(nbmat, shifts, n_real):
    nbmat = np.asarray(nbmat)
    fill = nbmat.shape[0] - 1
    sh = None if shifts is None else np.asarray(shifts).astype(np.int64)
    rows = []
    for i in range(n_real):
        ok = nbmat[i] != fill
        if sh is None:
            rows.append(sorted(nbmat[i][ok].tolist()))
        else:
            rows.append(sorted(zip(nbmat[i][ok].tolist(), map(tuple, sh[i][ok].tolist()))))
    return rows


def _skewed_box():
    box = _box(n=100, a=13.0, seed=4)
    cell = np.array([[13.0, 0.0, 0.0], [3.0, 12.0, 0.0], [-2.0, 1.5, 11.0]], np.float32)
    frac = box["coord"] / 13.0
    return {**box, "coord": (frac @ cell).astype(np.float32), "cell": cell}


@pytest.mark.parametrize("build", ["brute_force_nbmat", "_cell_list_nbmat_kdtree"])
@pytest.mark.parametrize("geometry", ["gas", "cubic", "skewed", "mixed"])
def test_host_builders_match(build, geometry):
    """Every row holds JAX's set of (neighbor, image); so does max_seen."""
    if geometry == "gas":
        mols = [{"coord": c, "numbers": z} for c, z in (_cluster(40, 1), _cluster(30, 2))]
    elif geometry == "cubic":
        mols = [_box()]
    elif geometry == "skewed":
        mols = [_skewed_box()]
    else:  # a periodic box and a gas-phase molecule in one batch
        mols = [_box(), {"coord": _cluster(20, 3)[0], "numbers": _cluster(20, 3)[1]}]
    coord = np.concatenate([m["coord"] for m in mols]).astype(np.float32)
    mol_idx = np.concatenate([np.full(len(m["coord"]), i) for i, m in enumerate(mols)])
    cells = [m.get("cell") for m in mols]
    cell = None if all(c is None for c in cells) else np.stack([c if c is not None else np.eye(3) for c in cells])
    pbc = None if cell is None else np.array([c is not None for c in cells])
    if cell is not None:  # the builders take the wrapped frame of system_from_molecules
        coord = np.asarray(jbuilders.system_from_molecules(mols, build_nbmat=False).coord)[: len(coord)]
    n_pad = len(coord) + 5
    args = (coord, mol_idx, 5.6)
    kw = dict(cell=cell, n_pad=n_pad, pbc_mol=pbc)
    jnb, jsh, jmax = getattr(jneighbors, build)(*args, **kw)
    # the port's cell_list_nbmat is the kd-tree build itself
    tbuild = "cell_list_nbmat" if build == "_cell_list_nbmat_kdtree" else build
    tnb_, tsh, tmax = getattr(tneighbors, tbuild)(*args, **kw)
    assert tmax == jmax and tnb_.shape[0] == n_pad
    assert _row_sets(tnb_, tsh, len(coord)) == _row_sets(jnb, jsh, len(coord))


def test_allpairs_and_density():
    np.testing.assert_array_equal(tneighbors.allpairs_nbmat([3, 5, 1], 12), jneighbors.allpairs_nbmat([3, 5, 1], 12))
    for cut, hint in ((5.0, None), (15.0, 200), (3.0, 10)):
        assert tneighbors.density_max_neighbors(cut, hint) == jneighbors.density_max_neighbors(cut, hint)


def test_nbmat_within_cutoff_matches_jax():
    jsys = jbuilders.system_from_molecules(MOLS, n_pad=40, build_nbmat=False)
    args = [np.asarray(x) for x in (jsys.coord, jsys.mol_idx, jsys.numbers)]
    jnbm, jovf = jneighbors.nbmat_within_cutoff(*args, 4.0, 6)
    tnbm, tovf = tneighbors.nbmat_within_cutoff(*(torch.tensor(x) for x in args), 4.0, 6)
    np.testing.assert_array_equal(tnbm.numpy(), np.asarray(jnbm))
    assert int(tovf) == int(jovf) > 0


@pytest.mark.parametrize("lr", ["shared", "split"])
def test_system_from_molecules_lists(lr):
    """The builder's SR and long-range lists (shared, or Coulomb and D3
    apart), wrapped coordinates and padding."""
    box = _box()
    kw = dict(lr_cutoff=12.6) if lr == "shared" else dict(coulomb_cutoff=10.6, dftd3_cutoff=13.6)
    jsys = jbuilders.system_from_molecules([box], cutoff=5.6, n_pad=64, **kw)
    tsys = tbuilders.system_from_molecules([box], CPU, 64, cutoff=5.6, build_nbmat=True, **kw)
    np.testing.assert_array_equal(tsys.coord.numpy(), np.asarray(jsys.coord))
    assert tsys.species == jsys.species
    for s in ("", "_lr", "_coulomb", "_dftd3"):
        jn, tn = getattr(jsys, f"nbmat{s}"), getattr(tsys, f"nbmat{s}")
        assert (jn is None) == (tn is None), s
        if tn is not None:
            assert tn.dtype == torch.int64 and tn.shape == tuple(jn.shape)
            assert _row_sets(tn.numpy(), getattr(tsys, f"shifts{s}"), 60) == _row_sets(
                jn, getattr(jsys, f"shifts{s}"), 60)
    assert tsys.resolve_nb("_dftd3", "_lr", "")[2] == ("_lr" if lr == "shared" else "_dftd3")


def test_stack_systems():
    mols = [_mol(7, 1), _mol(7, 2)]
    syss = [tbuilders.system_from_molecules([m], CPU, 16, build_nbmat=True) for m in mols]
    jsyss = [jbuilders.system_from_molecules([m], n_pad=16) for m in mols]
    st, jst = tbuilders.stack_systems(syss), jbuilders.stack_systems(jsyss)
    assert st.species == jst.species
    assert st.coord.shape == (2, 16, 3) and st.nbmat.shape == tuple(jst.nbmat.shape)
    np.testing.assert_array_equal(st.nbmat.numpy(), np.asarray(jst.nbmat))
    with pytest.raises(ValueError, match="bins"):
        tbuilders.stack_systems([syss[0], syss[1].replace(bins=tB.BinGrid((1, 1, 1), 8, 5.0, False))])


# -- routing ---------------------------------------------------------------------------


def test_layouts_chosen_as_jax_chooses(models):
    """Below ``binned_threshold`` and for gas-phase simple Coulomb: indexed;
    the periodic box's lists shared (equal Coulomb and D3 cutoffs) or split
    (D3 cutoff 8 against 15.6); gas-phase batches at or above the threshold
    take the molecule-bin layout; Ewald's Coulomb shares the LR list (its
    12.7 A real-space cutoff is within 20% of D3's 15 A) and carries its
    discretisation, as JAX's does."""
    _jm, (tparams, tcfg, aux) = models["wb97m-d3", "simple"]
    calc = TCalculator((tparams, tcfg, aux), device="cpu")
    box = calc.prepare_system(_box())
    assert box.bins is None and box.nbmat_lr is not None and box.nbmat_coulomb is None
    split = TCalculator(_d3_cutoff((tparams, tcfg, aux), 8.0), device="cpu")
    sysx = split.prepare_system(_box())
    assert sysx.nbmat_lr is None and sysx.nbmat_coulomb is not None and sysx.nbmat_dftd3 is not None
    gas = TCalculator((tparams, tcfg, aux), device="cpu", binned_threshold=64).prepare_system(_mol(80, 4))
    assert gas.bins is None and gas.nbmat.shape[1] == 79  # simple Coulomb: all pairs, indexed
    packed = TCalculator((tparams, tcfg, aux), device="cpu", binned_threshold=16).prepare_system(MOLS)
    assert packed.bins.molecule_bins and packed.bins.nbins == (3, 1, 1) and packed.nbmat is None
    ewald = dataclasses.replace(tcfg, outputs=tuple(
        (n, dataclasses.replace(h, method="ewald") if n == "lrcoulomb" else h) for n, h in tcfg.outputs))
    jparams, jcfg, jaux = _jm
    jewald = dataclasses.replace(jcfg, outputs=tuple(
        (n, dataclasses.replace(h, method="ewald") if n == "lrcoulomb" else h) for n, h in jcfg.outputs))
    tsys = TCalculator((tparams, ewald, aux), device="cpu").prepare_system(_box())
    jsys = JCalculator((jparams, jewald, jaux)).prepare_system(_box())
    assert tsys.nbmat_coulomb is None and tuple(tsys.nbmat_lr.shape) == tuple(jsys.nbmat_lr.shape)
    assert tsys.ewald_r_static == jsys.ewald_r_static and tuple(tsys.ewald_kpts.shape) == jsys.ewald_kpts.shape


# -- the committed validation model -----------------------------------------------------


def _validate_module():
    spec = importlib.util.spec_from_file_location("tools_validate", os.path.join(ROOT, "tools", "validate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_validation_config(jcfg) -> TConfig:
    """The port's spelling of tools/validate.py::validation_model()."""
    heads = {
        "output": lambda h: theads.OutputHead(n_in=h.n_in, n_out=h.n_out, key_in=h.key_in, key_out=h.key_out,
                                              mlp=tmodules.MLPSpec(hidden=h.mlp.hidden, last_linear=h.mlp.last_linear)),
        "atomic_shift": lambda h: theads.AtomicShiftHead(key_in=h.key_in, key_out=h.key_out),
        "atomic_sum": lambda h: theads.AtomicSumHead(key_in=h.key_in, key_out=h.key_out),
        "lrcoulomb": lambda h: theads.LRCoulombHead(method=h.method, dsf_rc=h.dsf_rc, rc=h.rc),
        "dftd3": lambda h: theads.DFTD3Head(s8=h.s8, a1=h.a1, a2=h.a2, cutoff=h.cutoff),
    }
    return TConfig(
        aev=TAEVConfig(rc_s=jcfg.aev.rc_s, nshifts_s=jcfg.aev.nshifts_s),
        nfeature=jcfg.nfeature, d2features=jcfg.d2features, ncomb_v=jcfg.ncomb_v, hidden=jcfg.hidden,
        aim_size=jcfg.aim_size, outputs=tuple((n, heads[h.kind](h)) for n, h in jcfg.outputs),
    )


def test_validation_model_reproduces_the_baseline():
    """tools/validate.py's model with the committed weights, loaded into its
    pytree as build_calculator does and bridged to the port, gives
    tools/validate_baseline.json (water, methane, ion pair, NaCl) within that
    file's limits: 1e-5 eV, 1e-4 eV/A; charges 1e-5."""
    mod = _validate_module()
    jcalc = mod.build_calculator()
    cfg = _port_validation_config(jcalc.cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jcalc.params), device="cpu")
    calc = TCalculator((params, cfg, {"sae": {}}), device="cpu")
    with open(mod.BASELINE) as fh:
        baseline = json.load(fh)
    for name, data in reference_systems().items():
        got = calc.eval(dict(data), forces=True)
        ref = baseline[name]
        np.testing.assert_allclose(got["energy"], ref["energy"], rtol=0, atol=mod.ENERGY_ATOL, err_msg=name)
        np.testing.assert_allclose(got["forces"], ref["forces"], rtol=0, atol=mod.FORCE_ATOL, err_msg=name)
        np.testing.assert_allclose(got["charges"], ref["charges"], rtol=0, atol=1e-5, err_msg=name)
