"""The port's ensembles against the JAX package's (CPU).

Random members (three, and two where a test says so) of the narrow model
of the JAX package's tests/test_ensemble_fused.py, drawn by JAX's init
and carried across by the weights bridge (``params_from_numpy`` of a
``stack_params`` tree, with its leading member axis):

- the fused forward (models/ensemble_fused.py) against JAX's
  ``aimnet2_apply_ensemble`` on the same inputs: binned DSF (with
  ``sae_external`` both ways, and the forces of the member-mean energy),
  binned Ewald and PME (and Ewald's forces), indexed Ewald, the indexed
  gas phase, the NSE two-channel model, and the SRRep, DFTD3, DispParam,
  D3TS and dipole head set;
- ``EnsembleCalculator`` (per member and fused) against JAX's: means,
  ``energy_std``, ``forces_std``, ``charges_std`` in the caller's atom
  order on the binned layout, stress and the Hessian through the per-member
  path, an attached long-range head stacked over the members, and
  ``from_registry`` on artifacts the port's exporter writes into a
  temporary directory.

Ensemble MD is held to the JAX driver in tests/test_torch_ensemble_md.py.

Tolerances (each test names its own): energies 1e-5 of max(1 eV, the
largest |E|), tighter than JAX's own 2e-4 to 3e-4 eV; charges and ``aim``
1e-5; forces and gradients 5e-5 eV/A (JAX's); stds 1e-5.  One JAX
compile gives a case's forward and its gradient where a test needs both.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from aimnetcentral_tpu.builders import system_from_molecules as j_system  # noqa: E402
from aimnetcentral_tpu.calculators.ensemble import EnsembleCalculator as JEnsemble  # noqa: E402
from aimnetcentral_tpu.calculators.ensemble import stack_params as j_stack  # noqa: E402
from aimnetcentral_tpu.dynamics import MDConfig as JMDConfig  # noqa: E402
from aimnetcentral_tpu.dynamics import MDDriver as JMDDriver  # noqa: E402
from aimnetcentral_tpu.models import aimnet2 as jaimnet2  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu.models import modules as jmodules  # noqa: E402
from aimnetcentral_tpu.models.ensemble_fused import aimnet2_apply_ensemble as j_fused  # noqa: E402
from aimnetcentral_tpu.models.ewald import attach_ewald as j_attach_ewald  # noqa: E402
from aimnetcentral_tpu.ops import binned as jB  # noqa: E402
from aimnetcentral_tpu.system import System as JSystem  # noqa: E402
from aimnetcentral_tpu_torch import constants  # noqa: E402
from aimnetcentral_tpu_torch.builders import system_from_molecules as t_system  # noqa: E402
from aimnetcentral_tpu_torch.calculators import EnsembleCalculator as TEnsemble  # noqa: E402
from aimnetcentral_tpu_torch.calculators import ensemble as tens  # noqa: E402
from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver  # noqa: E402
from aimnetcentral_tpu_torch.models import aimnet2 as taimnet2  # noqa: E402
from aimnetcentral_tpu_torch.models import heads as theads  # noqa: E402
from aimnetcentral_tpu_torch.models import modules as tmodules  # noqa: E402
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from aimnetcentral_tpu_torch.models.ensemble_fused import aimnet2_apply_ensemble as t_fused  # noqa: E402
from aimnetcentral_tpu_torch.models.ensemble_fused import member_params  # noqa: E402
from aimnetcentral_tpu_torch.models.ewald import attach_ewald as t_attach_ewald  # noqa: E402
from aimnetcentral_tpu_torch.ops import binned as tB  # noqa: E402

CPU = torch.device("cpu")
E_REL, E_FLOOR = 1e-5, 1.0  # energies: 1e-5 of max(1 eV, the largest |E|)
Q_ABS = 1e-5  # charges, aim, stds
F_ABS = 5e-5  # forces and gradients, eV/A (JAX's tests/test_ensemble_fused.py)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_energy(got, ref):
    ref = np.asarray(ref, dtype=np.float64)
    tol = E_REL * max(E_FLOOR, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), ref, rtol=0, atol=tol)


def _heads(heads, modules, lr: tuple):
    """The energy heads of JAX's tests/test_ensemble_fused.py plus ``lr``."""
    return (
        ("energy_mlp", heads.OutputHead(n_in=24, n_out=1, key_in="aim", key_out="energy",
                                        mlp=modules.MLPSpec(hidden=(32,), last_linear=True))),
        ("atomic_shift", heads.AtomicShiftHead(key_in="energy", key_out="energy")),
        ("atomic_sum", heads.AtomicSumHead(key_in="energy", key_out="energy")),
    ) + lr


def _cfg(pkg, lr_fn, c: int = 1):
    """The narrow config of JAX's ensemble tests in package ``pkg`` (JAX's
    or the port's aimnet2 module), with the heads ``lr_fn(heads, modules)``."""
    heads, modules = (jheads, jmodules) if pkg is jaimnet2 else (theads, tmodules)
    return pkg.AIMNet2Config(
        aev=pkg.AEVConfig(rc_s=4.0, nshifts_s=16), nfeature=8, d2features=True, ncomb_v=4,
        hidden=((48, 32), (48, 32), (48, 32, 32)), aim_size=24, num_charge_channels=c,
        outputs=_heads(heads, modules, lr_fn(heads, modules)),
    )


def _dsf(heads, _m):
    return (("lrcoulomb", heads.LRCoulombHead(rc=3.5, method="dsf", dsf_rc=6.0)),)


def _ewald(method):
    return lambda heads, _m: (("lrcoulomb", heads.LRCoulombHead(rc=3.5, method=method)),)


def _simple(heads, _m):
    return (("lrcoulomb", heads.LRCoulombHead(rc=3.5, method="simple")),)


def _lr_heads(heads, modules):
    """JAX's tests/test_ensemble_fused.py:299-306."""
    return (
        ("srrep", heads.SRRepHead(rc=4.0, cutoff_fn="cosine_cutoff")),
        ("dftd3", heads.DFTD3Head(s8=1.2, a1=0.4, a2=5.0, cutoff=6.0)),
        ("disp_raw", heads.OutputHead(n_in=24, n_out=2, key_in="aim", key_out="disp_param",
                                      mlp=modules.MLPSpec(hidden=(16,), last_linear=True))),
        ("disp_param", heads.DispParamHead()),
        ("d3ts", heads.D3TSHead(a1=0.49, a2=3.5, s8=0.78)),
        ("dipole", heads.DipoleHead()),
    )


def _members(lr_fn, n_e: int = 3, c: int = 1, disp: bool = False):
    """(JAX stacked params, JAX cfg), (port params, port cfg): members with
    seeds 0..n_e-1 of JAX's init, the port's a bridge of the stacked tree.
    With ``disp`` the DispParam table is seeded positive (its zero init
    makes D3TS vanish)."""
    jcfg, tcfg = _cfg(jaimnet2, lr_fn, c), _cfg(taimnet2, lr_fn, c)
    members = [j_init(jax.random.key(i), jcfg) for i in range(n_e)]
    if disp:
        tab = np.zeros((87, 2), np.float32)
        rng = np.random.default_rng(0)
        tab[1:, 0], tab[1:, 1], tab[0, 1] = rng.uniform(2.0, 40.0, 86), rng.uniform(3.0, 15.0, 86), 1.0
        for p in members:
            p["outputs"]["disp_param"] = {"disp_param0": jnp.asarray(tab)}
    jparams = j_stack(members)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jparams, jcfg), (tparams, tcfg)


def _jax_grid(g):
    return None if g is None else jB.BinGrid(**{f.name: getattr(g, f.name) for f in dataclasses.fields(jB.BinGrid)
                                                if hasattr(g, f.name)})


def _to_jax(tsys):
    """The port's System as the JAX package's, field for field (the port's
    binning equals JAX's slot for slot: tests/test_torch_binned.py)."""
    kw = {}
    for f in dataclasses.fields(JSystem):
        v = getattr(tsys, f.name, None)
        if f.name in ("bins", "lr_bins"):
            v = _jax_grid(v)
        elif isinstance(v, torch.Tensor):
            a = v.numpy()
            v = jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
        kw[f.name] = v
    return JSystem(**kw)


def member_params_slice(tree, n: int):
    """The first ``n`` members of a stacked port tree."""
    if isinstance(tree, dict):
        return {k: member_params_slice(v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(member_params_slice(v, n) for v in tree)
    return tree[:n]


def _binned(mol: dict, lr_cut: float | None, ewald: str | None = None):
    """The same binned System on both packages: the port's binning, carried
    into JAX's System."""
    n = len(mol["numbers"])
    cell = mol["cell"]
    tsys, _tp, tovf = tB.to_binned_system(t_system([mol], CPU), tB.plan_bins(cell, n, edge=4.0),
                                          tB.plan_lr_bins(cell, n, lr_cut) if lr_cut else None)
    assert int(tovf.sum()) == 0
    jsys = _to_jax(tsys)
    if ewald is not None:
        jsys = j_attach_ewald(jsys, 1e-6, pme=ewald == "pme")
        tsys = t_attach_ewald(tsys, 1e-6, pme=ewald == "pme")
    return jsys, tsys


def _box(seed: int, n: int = 40, a: float = 10.0, species=(1, 6, 7, 8), **extra) -> dict:
    rng = np.random.default_rng(seed)
    return {"coord": rng.uniform(0, a, size=(n, 3)).astype(np.float32), "numbers": rng.choice(species, size=n),
            "cell": np.eye(3, dtype=np.float32) * a, **extra}


@pytest.fixture(scope="module")
def dsf():
    return _members(_dsf), _binned(_box(0), 6.0)


def _fused_pair(models, systems, sae_external=True):
    (jp, jc), (tp, tc) = models
    jsys, tsys = systems
    ref = jax.jit(lambda p: j_fused(p, jc, jsys, sae_external=sae_external))(jp)
    got = t_fused(tp, tc, tsys, sae_external=sae_external)
    return got, ref


def _fused_with_grad(models, systems):
    """The fused forward (sae external) and the gradient of the member-mean
    energy (the MD force path) on both packages: (got, ref, port grad, JAX
    grad), one JAX compile for both."""
    (jp, jc), (tp, tc) = models
    jsys, tsys = systems

    def mean_energy(c):
        out = j_fused(jp, jc, jsys.replace(coord=c), sae_external=True)
        return out["energy"].mean(axis=0).sum(), out

    (_e, ref), jg = jax.jit(jax.value_and_grad(mean_energy, has_aux=True))(jsys.coord)
    coord = tsys.coord.clone().requires_grad_(True)
    got = t_fused(tp, tc, tsys.replace(coord=coord), sae_external=True)
    (tg,) = torch.autograd.grad(got["energy"].mean(0).sum(), coord)
    got = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in got.items()}
    return got, ref, tg.numpy(), np.asarray(jg)


@pytest.fixture(scope="module")
def dsf_grad(dsf):
    return _fused_with_grad(*dsf)


@pytest.mark.parametrize("sae_external", [True, False])
def test_fused_binned_dsf_matches_jax(dsf, dsf_grad, sae_external):
    """Binned DSF: energies per member (1e-5 of max(1, |E|)), charges and
    ``aim`` (1e-5), the SAE counts exactly."""
    got, ref = dsf_grad[:2] if sae_external else _fused_pair(*dsf, sae_external)
    _close_energy(got["energy"].numpy(), ref["energy"])
    np.testing.assert_allclose(got["charges"].numpy(), np.asarray(ref["charges"]), atol=Q_ABS)
    np.testing.assert_allclose(got["aim"].detach().numpy(), np.asarray(ref["aim"]), atol=Q_ABS)
    assert got["energy"].shape == (3, 1)
    if sae_external:
        np.testing.assert_array_equal(got["mol_element_counts"].numpy(), np.asarray(ref["mol_element_counts"]))


def test_fused_forces_match_jax(dsf_grad):
    """The gradient of the member-mean energy (the MD force path) on the
    binned DSF layout, within 5e-5 eV/A."""
    _got, _ref, tg, jg = dsf_grad
    np.testing.assert_allclose(tg, jg, atol=F_ABS)
    assert np.abs(jg).max() > 1e-3


@pytest.fixture(scope="module")
def ewald_models():
    return {m: _members(_ewald(m)) for m in ("ewald", "pme")}


@pytest.fixture(scope="module")
def ewald_systems():
    box = _box(1, n=40, a=10.0)
    from aimnetcentral_tpu.models.ewald import estimate_ewald_parameters

    rc = float(estimate_ewald_parameters(box["cell"], 40, 1e-6).r_cutoff)
    return {m: _binned(box, rc, m) for m in ("ewald", "pme")}


@pytest.fixture(scope="module")
def ewald_grad(ewald_models, ewald_systems):
    return _fused_with_grad(ewald_models["ewald"], ewald_systems["ewald"])


@pytest.mark.parametrize("method", ["ewald", "pme"])
def test_fused_binned_ewald_pme_matches_jax(ewald_models, ewald_systems, ewald_grad, method):
    """Binned Ewald and PME (the member form of the real-space sweep with
    the SR part inside, the shared phase matrix or spread geometry):
    energies 1e-5 of max(1, |E|), charges 1e-5."""
    if method == "ewald":
        got, ref = ewald_grad[:2]
    else:
        got, ref = _fused_pair(ewald_models[method], ewald_systems[method])
    _close_energy(got["energy"].numpy(), ref["energy"])
    np.testing.assert_allclose(got["charges"].numpy(), np.asarray(ref["charges"]), atol=Q_ABS)


def test_fused_ewald_forces_match_jax(ewald_grad):
    """The gradient of the member-mean energy through binned Ewald, 5e-5."""
    _got, _ref, tg, jg = ewald_grad
    np.testing.assert_allclose(tg, jg, atol=F_ABS)


def test_fused_indexed_ewald_matches_jax(ewald_models):
    """The indexed layout's Ewald with the SR part subtracted
    (``lr.coulomb_sr_multi``), two members: energies 1e-5 of max(1, |E|)."""
    from aimnetcentral_tpu.models.ewald import estimate_ewald_parameters

    (jp, jc), (tp, tc) = ewald_models["ewald"]
    jp2, tp2 = jax.tree.map(lambda x: x[:2], jp), member_params_slice(tp, 2)
    mol = _box(2, n=24, a=8.0, species=(1, 6, 8))
    rc = float(estimate_ewald_parameters(mol["cell"], 24, 1e-6).r_cutoff)
    jsys = j_attach_ewald(j_system([mol], cutoff=4.0, lr_cutoff=rc), 1e-6)
    tsys = t_attach_ewald(t_system([mol], CPU, cutoff=4.0, lr_cutoff=rc, build_nbmat=True), 1e-6)
    got, ref = _fused_pair(((jp2, jc), (tp2, tc)), (jsys, tsys))
    assert got["energy"].shape == (2, 1)
    _close_energy(got["energy"].numpy(), ref["energy"])


def test_fused_indexed_gas_phase_matches_jax():
    """A gas-phase molecule on the indexed layout, simple Coulomb (the
    per-member head path sharing the distance cache): energies 1e-5 of
    max(1, |E|), charges 1e-5."""
    models = _members(_simple)
    rng = np.random.default_rng(3)
    mol = {"coord": rng.uniform(-3, 3, size=(20, 3)).astype(np.float32), "numbers": rng.choice([1, 6, 8], size=20)}
    systems = (j_system([mol], cutoff=4.0), t_system([mol], CPU, cutoff=4.0, build_nbmat=True))
    got, ref = _fused_pair(models, systems)
    _close_energy(got["energy"].numpy(), ref["energy"])
    np.testing.assert_allclose(got["charges"].numpy(), np.asarray(ref["charges"]), atol=Q_ABS)


def test_fused_nse_two_channel_matches_jax():
    """The NSE two-channel model (charge +1, doublet) on the binned layout:
    energies 1e-5 of max(1, |E|), charges and spin charges 1e-5."""
    models = _members(_dsf, c=2)
    systems = _binned(_box(4, n=30, charge=1.0, mult=2.0), 6.0)
    got, ref = _fused_pair(models, systems)
    _close_energy(got["energy"].numpy(), ref["energy"])
    for key in ("charges", "spin_charges"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=Q_ABS, err_msg=key)


def test_fused_lr_heads_match_jax():
    """SRRep and DFTD3 (once, broadcast over the members), DispParam, D3TS
    (its member form) and the dipole, binned: energies 1e-5 of max(1,
    |E|), ``disp_param`` and dipole 1e-5 of their largest magnitude; D3TS
    is not empty (a positive ``disp_param0``)."""
    models = _members(_lr_heads, disp=True)
    got, ref = _fused_pair(models, _binned(_box(5), 6.0))
    _close_energy(got["energy"].detach().numpy(), ref["energy"])
    for key in ("disp_param", "dipole"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].detach().numpy(), r, atol=Q_ABS * max(1.0, np.abs(r).max()), err_msg=key)
    assert float(np.abs(np.asarray(ref["disp_param"])).max()) > 1.0


# ---------------------------------------------------------------------------
# EnsembleCalculator


D3_WB97M = {"s6": 1.0, "s8": 0.3908, "a1": 0.566, "a2": 3.128}


def _calcs(models, fused=False, metadata=None, **kw):
    (jp, jc), (tp, tc) = models
    aux = {"sae": {"atomic_shift": np.linspace(-10.0, -1.0, 64)}}
    if metadata is not None:
        aux["metadata"] = metadata
    return (JEnsemble((jp, jc, dict(aux)), **kw),
            TEnsemble((tp, tc, dict(aux)), device="cpu", fused=fused, **kw))


@pytest.fixture(scope="module")
def calc_ref(dsf):
    """JAX's per-member ``eval(forces=True)`` of the binned box."""
    return _calcs(dsf[0], binned_threshold=0)[0].eval(_box(6), forces=True)


@pytest.mark.parametrize("fused", [False, True], ids=["per_member", "fused"])
def test_calculator_binned_matches_jax(dsf, calc_ref, fused):
    """``eval(forces=True)`` on the binned layout (threshold 0), both port
    paths against JAX's per-member path (JAX's own tests hold its fused
    path to it): the mean energy (1e-5 of max(1, |E|)), forces (5e-5
    eV/A) and charges, and ``energy_std`` and ``charges_std`` (1e-5),
    ``forces_std`` on the per-member path only; the per-atom keys in the
    caller's atom order."""
    models, _systems = dsf
    tcalc = _calcs(models, fused=fused, binned_threshold=0)[1]
    ref = calc_ref
    got = tcalc.eval(_box(6), forces=True)
    assert tcalc._prep_cache["kind"] == "binned" and tcalc._last_perm is not None
    _close_energy(got["energy"], ref["energy"])
    np.testing.assert_allclose(got["forces"], ref["forces"], atol=F_ABS)
    for key in ("charges", "energy_std", "charges_std") + (() if fused else ("forces_std",)):
        np.testing.assert_allclose(got[key], ref[key], atol=Q_ABS, err_msg=key)
    assert got["charges_std"].shape == (40,) and (got["energy_std"] > 0).all()
    assert ("forces_std" in got) == (not fused)


def test_calculator_stress_and_hessian_per_member(dsf):
    """Stress and the dense Hessian run on the per-member path even when
    ``fused``, as in JAX: the means against JAX's (stress 1e-6 eV/A^3 of
    a 24-atom box on the indexed layout; the Hessian of a 5-atom molecule
    5e-5 of its largest entry; two members)."""
    (jp, jc), (tp, tc) = dsf[0]
    models = ((jax.tree.map(lambda x: x[:2], jp), jc), (member_params_slice(tp, 2), tc))
    jcalc, tcalc = _calcs(models, fused=True)
    data = _box(8, n=24, a=7.0)
    ref = jcalc.eval(data, forces=True, stress=True)
    got = tcalc.eval(data, forces=True, stress=True)
    np.testing.assert_allclose(got["stress"], ref["stress"], atol=1e-6)
    assert "forces_std" in got  # the per-member path
    mol = {"coord": np.random.default_rng(9).uniform(-1.2, 1.2, size=(5, 3)).astype(np.float32),
           "numbers": np.array([6, 1, 1, 8, 1])}
    ref_h = jcalc.eval(mol, hessian=True)
    got_h = tcalc.eval(mol, hessian=True)
    scale = float(np.abs(ref_h["hessian"]).max())
    np.testing.assert_allclose(got_h["hessian"], ref_h["hessian"], atol=5e-5 * scale)
    np.testing.assert_allclose(got_h["energy_std"], ref_h["energy_std"], atol=Q_ABS)


def test_calculator_attached_head_is_stacked(dsf):
    """``needs_dispersion=True`` attaches a DFTD3 head whose tables the
    constructor broadcasts onto the member axis; energies against JAX's
    (1e-5 of max(1, |E|)) on the indexed layout of a molecule."""
    models, _systems = dsf
    meta = {"needs_dispersion": False, "coulomb_mode": "none", "d3_params": dict(D3_WB97M)}
    jcalc, tcalc = _calcs(models, metadata=meta, needs_dispersion=True)
    assert tcalc.has_external_dftd3
    tables = tcalc.params["outputs"]["external_dftd3"]
    assert all(v.shape[0] == 3 for v in tables.values())
    rng = np.random.default_rng(10)
    mol = {"coord": rng.uniform(-3, 3, size=(16, 3)).astype(np.float32), "numbers": rng.choice([1, 6, 8], size=16)}
    ref, got = jcalc.eval(mol, forces=True), tcalc.eval(mol, forces=True)
    _close_energy(got["energy"], ref["energy"])
    np.testing.assert_allclose(got["forces"], ref["forces"], atol=F_ABS)
    np.testing.assert_allclose(got["energy_std"], ref["energy_std"], atol=Q_ABS)


def test_from_registry_matches_jax(tmp_path, monkeypatch):
    """``from_registry("aimnet2")`` loads the family's four members from
    artifacts the port's exporter wrote (two members' weights, each twice),
    with both packages' ``resolve_model`` sent to them: the mean energy
    (1e-5 of max(1, |E|)) and ``energy_std`` (1e-5) against JAX's, the SAE
    tables averaged, and a member of another architecture refused."""
    from aimnetcentral_tpu.calculators import registry as jreg
    from aimnetcentral_tpu_torch.calculators import registry as treg
    from aimnetcentral_tpu_torch.train.export import export_model

    (_jp, _jc), (tp, tc) = _members(_dsf, n_e=2)
    names = treg.ensemble_members("aimnet2")
    assert len(names) == 4
    paths = {}
    for k, name in enumerate(names):
        paths[name] = str(tmp_path / f"{name}.pt")
        sae = {1: -13.6 - k, 6: -1029.8, 7: -1485.3, 8: -2042.6}
        export_model(member_params(tp, k % 2), tc, paths[name], sae=sae, implemented_species=[1, 6, 7, 8])
    for reg in (treg, jreg):
        monkeypatch.setattr(reg, "resolve_model", lambda n: paths[treg.resolve_name(n)[0]])
    tcalc = TEnsemble.from_registry("aimnet2", device="cpu")
    jcalc = JEnsemble.from_registry("aimnet2")
    assert tcalc.params["afv"]["weight"].shape[0] == 4
    np.testing.assert_allclose(tcalc.aux["sae"]["atomic_shift"][1], -13.6 - 1.5, rtol=1e-12)
    mol = {"coord": np.random.default_rng(11).uniform(-2.5, 2.5, size=(12, 3)).astype(np.float32),
           "numbers": np.array([6, 6, 8, 7, 1, 1, 1, 1, 6, 1, 1, 8])}
    ref, got = jcalc.eval(mol, forces=True), tcalc.eval(mol, forces=True)
    _close_energy(got["energy"], ref["energy"])
    np.testing.assert_allclose(got["energy_std"], ref["energy_std"], atol=Q_ABS)
    assert (got["energy_std"] > 0).all()
    other = dataclasses.replace(tc, nfeature=4, ncomb_v=4)
    export_model(taimnet2.aimnet2_init(other, seed=1, device="cpu"), other, paths[names[3]], sae={1: -13.6},
                 implemented_species=[1, 6, 7, 8])
    with pytest.raises(ValueError, match="different architecture"):
        TEnsemble.from_registry("aimnet2", device="cpu")


def test_bridge_carries_stacked_members():
    """``params_from_numpy`` carries a ``stack_params`` tree of JAX members
    with its leading member axis, leaf for leaf, and the port's own
    ``stack_params`` of the single members' bridges gives the same tree."""
    (jp, _jc), (tp, _tc) = _members(_dsf, n_e=2)
    jl, tl = jax.tree.leaves(jp), tens._leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.shape[0] == 2 and tuple(b.shape) == tuple(a.shape)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a, dtype=np.float32))
    singles = [params_from_numpy(jax.tree.map(lambda x, e=e: np.asarray(x[e]), jp), device="cpu") for e in range(2)]
    for a, b in zip(tens._leaves(tens.stack_params(singles)), tl):
        assert torch.equal(a, b)
