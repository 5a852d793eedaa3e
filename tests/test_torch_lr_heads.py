"""The port's SRRep, DispParam and D3TS heads, their pair terms of kernels
D and E, and models without d2features on the binned layout, against the
JAX package (CPU).

- The head set of JAX's tests/test_ensemble_fused.py (SRRep with a cosine
  cutoff at 4.0 A, an OutputHead giving ``disp_param``, DispParam,
  D3TS(a1=0.49, a2=3.5, s8=0.78)) on the flagship's heads at narrow
  widths, through ``AIMNet2Calculator`` on the binned and the indexed
  layouts, against JAX's calculator: energy, forces and stress.  SRRep
  runs with each of its three cutoff functions.  ``disp_param0`` is filled
  with positive C6 and alpha per element from a seed (its zero init would
  make D3TS exactly zero and the test empty).
- The two JAX layouts' SRRep held to each other: with a cutoff function
  they agree; without one (``cutoff_fn="none"``) the indexed layout sums
  the whole SR list, the binned layout stops at ``rc``.
- The new terms' hand derivatives (the formulas of csrc/pair_terms.cuh)
  against autograd in float64.
- A v2 artifact carrying these heads, written by the port's exporter,
  loaded by JAX's loader: JAX's energies and forces.
- A model without d2features on the binned layout (kernels A and B with
  the features broadcast along G) against JAX's indexed layout (JAX's own
  binned engine fails on such a model) and the port's indexed layout.

Tolerances: energy 1e-5 relative with a floor of 1e-5 eV, forces 1e-4
eV/A, stress 1e-6 eV/A^3; hand derivatives 1e-6 of the largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu import builders as jbuilders  # noqa: E402
from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator  # noqa: E402
from aimnetcentral_tpu.models import AIMNet2Config as JConfig  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models import engine_binned as jeb  # noqa: E402
from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu.models import lr as jlr  # noqa: E402
from aimnetcentral_tpu.models import modules as jmodules  # noqa: E402
from aimnetcentral_tpu.ops import binned as jB  # noqa: E402
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator  # noqa: E402
from aimnetcentral_tpu_torch.kernels import pair_sweep as ps  # noqa: E402
from aimnetcentral_tpu_torch.models import AIMNet2Config as TConfig  # noqa: E402
from aimnetcentral_tpu_torch.models import heads as theads  # noqa: E402
from aimnetcentral_tpu_torch.models import modules as tmodules  # noqa: E402
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from aimnetcentral_tpu_torch.train import export as texport  # noqa: E402
from test_torch_calculator import NARROW, _box, _config  # noqa: E402
from test_torch_ewald import _compare  # noqa: E402

CPU = torch.device("cpu")


def _dense_box():
    """60 CHNO atoms in a 7.5 A box: neighbours from about 1.3 A, where
    GFN1 repulsion is of the order of 0.01-1 eV a pair (at the 3 A spacing
    of the 12 A box it is below float32's resolution of the energy)."""
    return _box(60, 7.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lr_head_outputs(heads, modules, cutoff_fn: str = "cosine_cutoff"):
    """The flagship's heads plus SRRep, the dispersion OutputHead, DispParam
    and D3TS (JAX tests/test_ensemble_fused.py:299-306)."""
    base = _config(TConfig if heads is theads else JConfig, heads, modules).outputs
    return base + (
        ("srrep", heads.SRRepHead(key_out="energy", rc=4.0, cutoff_fn=cutoff_fn)),
        ("disp_raw", heads.OutputHead(n_in=16, n_out=2, key_in="aim", key_out="disp_param",
                                      mlp=modules.MLPSpec(hidden=(16,), last_linear=True))),
        ("disp_param", heads.DispParamHead()),
        ("d3ts", heads.D3TSHead(a1=0.49, a2=3.5, s8=0.78)),
    )


def _disp_table(seed: int = 0) -> np.ndarray:
    """Positive C6 and alpha per element from ``seed``; the padding row
    keeps (0, 1), as ``head_init`` gives it."""
    tab = np.zeros((87, 2), np.float32)
    rng = np.random.default_rng(seed)
    tab[1:, 0] = rng.uniform(2.0, 40.0, size=86)
    tab[1:, 1] = rng.uniform(3.0, 15.0, size=86)
    tab[0, 1] = 1.0
    return tab


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) per SRRep cutoff function, with the same
    parameters and a filled ``disp_param0``."""
    out = {}
    for cutoff_fn in ("cosine_cutoff", "exp_cutoff", "none"):
        jcfg = JConfig(outputs=lr_head_outputs(jheads, jmodules, cutoff_fn), **NARROW)
        tcfg = TConfig(outputs=lr_head_outputs(theads, tmodules, cutoff_fn), **NARROW)
        jparams = j_init(jax.random.key(0), jcfg)
        jparams = {**jparams, "outputs": {**jparams["outputs"],
                                          "disp_param": {"disp_param0": jax.numpy.asarray(_disp_table())}}}
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
        out[cutoff_fn] = (jparams, jcfg), (tparams, tcfg)
    return out


@pytest.mark.parametrize("cutoff_fn", ["cosine_cutoff", "exp_cutoff", "none"])
@pytest.mark.parametrize("threshold,kind", [(0, "binned"), (1024, "indexed")], ids=["binned", "indexed"])
def test_lr_heads_match_jax(models, cutoff_fn, threshold, kind):
    (jp, jc), (tp, tc) = models[cutoff_fn]
    data = _dense_box()
    ref = JCalculator((jp, jc, {"sae": {}}), binned_threshold=threshold).eval(data, forces=True, stress=True)
    calc = TCalculator((tp, tc, {"sae": {}}), device="cpu", binned_threshold=threshold)
    got = calc.eval(data, forces=True, stress=True)
    assert calc._prep_cache["kind"] == kind
    _compare(got, ref, ("energy", "forces", "stress"))


def test_heads_are_not_empty(models):
    """SRRep and D3TS each move the energy and the forces, and D3TS's
    forces reach through ``disp_param``: the model's energy without them,
    and with ``disp_param`` held fixed, differs."""
    (_jp, _jc), (tp, tc) = models["cosine_cutoff"]
    data = _dense_box()
    full = TCalculator((tp, tc, {"sae": {}}), device="cpu").eval(data, forces=True)
    for drop in ("srrep", "d3ts"):
        cfg = dataclasses.replace(tc, outputs=tuple((n, h) for n, h in tc.outputs if n != drop))
        part = TCalculator((tp, cfg, {"sae": {}}), device="cpu").eval(data, forces=True)
        assert abs(full["energy"][0] - part["energy"][0]) > 1e-3, drop
        assert np.abs(full["forces"] - part["forces"]).max() > 1e-3, drop


def test_jax_srrep_layouts(models):
    """JAX's two layouts of SRRep held to each other on the dense box.  The
    indexed layout sums every pair of the SR list (5.6 A here: the 5 A
    cutoff and the calculator's 0.6 A skin), the binned sweep stops at rc
    (4 A).  With a cutoff function, zero from rc on, the two are one
    definition; without one (``cutoff_fn="none"``) they differ by the pairs
    between rc and the list's reach, which for H, C, N and O weigh below
    1e-9 eV each (``exp(-a_i a_j d^1.5)`` with a_i a_j >= 3.3 at d >= 4 A),
    so the energies agree to float32 all the same (ROADMAP.md section 3)."""
    mol = _dense_box()
    gfn1 = jheads.head_init(jax.random.key(0), jheads.SRRepHead())["gfn1_ab"]
    isys = jbuilders.system_from_molecules([mol], cutoff=5.6, n_pad=64)
    grid = jB.plan_bins(mol["cell"], 60, 3.75, safety=3.0)
    bsys, _p, _o = jB.to_binned_system(jbuilders.system_from_molecules([mol], build_nbmat=False, n_pad=64), grid)
    for cutoff_fn in ("cosine_cutoff", "exp_cutoff", "none"):
        e_i = float(jlr.srrep_energy({}, isys, {"gfn1_ab": gfn1}, 4.0, cutoff_fn)[0])
        e_b = float(jeb.srrep_binned(bsys, gfn1, 4.0, cutoff_fn)[0])
        assert e_i > 1.0  # close contacts: the term is not empty
        assert abs(e_i - e_b) < 1e-5 * abs(e_i), cutoff_fn


HAND_TERMS = {
    "ewald_real": ps.EwaldRealTerm(eta=2.4),
    "ewald_real_exp": ps.EwaldRealTerm(eta=2.4, rc=4.6, subtract_sr=True),
    "ewald_real_cosine": ps.EwaldRealTerm(eta=2.4, rc=4.6, envelope="cosine", subtract_sr=True),
    "srrep_none": ps.SRRepTerm(rc=5.2),
    "srrep_exp": ps.SRRepTerm(rc=5.2, cutoff_fn="exp_cutoff"),
    "srrep_cosine": ps.SRRepTerm(rc=4.0, cutoff_fn="cosine_cutoff"),
    "d3ts": ps.D3TSTerm(a1=0.49, a2=3.5, s8=0.78),
}


@pytest.mark.parametrize("name", list(HAND_TERMS))
def test_hand_derivatives_match_autograd(name):
    """``g_grad`` against autograd of ``g`` in float64, over distances that
    cross each term's cutoff and clamps; D3TS also where the TS
    denominator's clamp (1e-4) is active."""
    dtype = torch.float64
    term = HAND_TERMS[name]
    rc = getattr(term, "rc", 5.2)
    dist = np.concatenate([np.linspace(0.6, 15.0, 40), [rc * (1 - 1e-6), rc - 1e-3, rc + 1e-3]])
    rng = np.random.default_rng(4)
    ns = len(term.scalar_keys)
    d = torch.tensor(dist, dtype=dtype, requires_grad=True)
    shape = d.shape + ((ns,) if ns > 1 else ())
    si = torch.tensor(rng.uniform(0.5, 3.0, size=shape), dtype=dtype)
    sj = torch.tensor(rng.uniform(0.5, 3.0, size=shape), dtype=dtype)
    if name == "d3ts":
        si[:5, 0] = 1e-6  # tiny C6: the denominator's clamp
        sj[:5, 0] = 1e-6
    si.requires_grad_(True)
    sj.requires_grad_(True)
    valid = torch.ones(d.shape, dtype=torch.bool)
    g = term.g(d, si, sj, valid)
    auto = torch.autograd.grad(g.sum(), (d, si, sj))
    hand = term.g_grad(d.detach(), si.detach(), sj.detach(), valid)
    np.testing.assert_allclose(hand[0].numpy(), g.detach().numpy(), rtol=0, atol=1e-6 * g.abs().max().item())
    for h, a in zip(hand[1:], auto):
        np.testing.assert_allclose(h.numpy(), a.numpy(), rtol=0, atol=1e-6 * a.abs().max().item())
        assert torch.isfinite(h).all()


def test_port_artifact_loads_in_jax(models, tmp_path):
    """The port's exporter writes DispParam and D3TS into a v2 artifact
    (``has_embedded_d3ts``); JAX's loader reads it and gives the port's
    energies, forces and stress on both layouts.  SRRep is not among the
    v2 allowlist's classes: an artifact carrying it is refused by both
    loaders alike."""
    from aimnetcentral_tpu.models import loader as jloader
    from aimnetcentral_tpu_torch.models import loader as tloader

    (_jp, _jc), (tp, tc) = models["cosine_cutoff"]
    kw = dict(sae={1: -13.6, 6: -1029.0, 7: -1485.0, 8: -2042.0}, implemented_species=[1, 6, 7, 8])
    no_rep = dataclasses.replace(tc, outputs=tuple((n, h) for n, h in tc.outputs if n != "srrep"))
    path = str(tmp_path / "d3ts.pt")
    art = texport.export_model(tp, no_rep, path, **kw)
    assert art["has_embedded_d3ts"]
    data = _dense_box()
    for threshold in (0, 1024):
        ref = JCalculator(path, binned_threshold=threshold).eval(data, forces=True, stress=True)
        got = TCalculator(path, device="cpu", binned_threshold=threshold).eval(data, forces=True, stress=True)
        _compare(got, ref, ("energy", "forces", "stress"))
    rep_path = str(tmp_path / "srrep.pt")
    texport.export_model(tp, tc, rep_path, **kw)
    for loader in (jloader, tloader):
        with pytest.raises(ValueError, match="SRRep"):
            loader.load_model(rep_path)


def test_nod2_binned_matches_jax_and_indexed():
    """A model without d2features on the binned layout, through kernels A
    and B's plain versions with the features broadcast along G.  JAX's
    binned engine (engine_binned.conv_pass_binned) reads (L, F) features
    as one feature over G and fails with a TypeError on such a model
    (ROADMAP.md section 3), so the port's binned layout is held to JAX's
    indexed layout (``_conv_sv``'s ``einsum("nmc,nmgd->ncgd")``, the
    definition) and to its own indexed layout."""
    jcfg = dataclasses.replace(_config(JConfig, jheads, jmodules), d2features=False)
    tcfg = dataclasses.replace(_config(TConfig, theads, tmodules), d2features=False)
    jp = j_init(jax.random.key(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    data = _box()
    with pytest.raises(TypeError):
        JCalculator((jp, jcfg, {"sae": {}}), binned_threshold=0).eval(data, forces=True)
    ref = JCalculator((jp, jcfg, {"sae": {}})).eval(data, forces=True, stress=True)
    binned = TCalculator((tp, tcfg, {"sae": {}}), device="cpu", binned_threshold=0)
    got = binned.eval(data, forces=True, stress=True)
    assert binned._prep_cache["kind"] == "binned"
    _compare(got, ref, ("energy", "forces", "stress"))
    indexed = TCalculator((tp, tcfg, {"sae": {}}), device="cpu").eval(data, forces=True, stress=True)
    _compare(got, indexed, ("energy", "forces", "stress"))
