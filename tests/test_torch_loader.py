"""The port's artifact path (models/loader.py, models/convert.py, the
calculator's family checks) against the JAX package's (CPU).

- A v2 artifact written by JAX ``train/export.py::export_model`` from
  random weights (a narrow model with LRCoulomb and DFTD3 heads, SAE and
  ``implemented_species``) loads in the port to JAX's parameters bit for
  bit and gives JAX's energies (1e-5 relative), charges and forces (1e-5
  eV/A) and stress (1e-6 eV/A^3) on the indexed, molecule-bin and binned
  layouts.
- NSE (two charge channels, ``mult``) and rxn (dipole and quadrupole,
  post-hoc D3, neutral only) artifacts, written by JAX from its own
  ``config_to_yaml`` trees, match JAX with the same tolerances (dipole and
  quadrupole 1e-5).
- The trust boundary, case by case as JAX's tests/test_adversarial_
  artifacts.py, test_safety.py and test_lr_overrides.py: the port refuses
  what JAX refuses with the same exception type, and loads what JAX loads.
"""

import copy
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator  # noqa: E402
from aimnetcentral_tpu.models import AIMNet2Config as JConfig  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models import heads as jh  # noqa: E402
from aimnetcentral_tpu.models import loader as jloader  # noqa: E402
from aimnetcentral_tpu.models import modules as jm  # noqa: E402
from aimnetcentral_tpu.models.convert import config_from_yaml as j_config_from_yaml  # noqa: E402
from aimnetcentral_tpu.train.export import config_to_yaml as j_config_to_yaml  # noqa: E402
from aimnetcentral_tpu.train.export import export_model as j_export  # noqa: E402
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator  # noqa: E402
from aimnetcentral_tpu_torch.models import heads as th  # noqa: E402
from aimnetcentral_tpu_torch.models import loader as tloader  # noqa: E402

NARROW = dict(nfeature=4, ncomb_v=4, hidden=((32, 16), (32, 16), (32, 16)), aim_size=16)
SAE = {1: -13.6, 6: -1030.0, 7: -1485.0, 8: -2040.0}
SPECIES = [1, 6, 7, 8]
D3 = dict(s8=0.3908, a1=0.566, a2=3.128)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (test files run side by side
    in worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_config(coulomb=True, d3=True, channels=1, multipoles=False):
    """A narrow JAX config: the flagship heads, optionally LRCoulomb, DFTD3
    and the rxn family's dipole and quadrupole."""
    outputs = [
        ("energy_mlp", jh.OutputHead(n_in=16, n_out=1, key_in="aim", key_out="energy",
                                     mlp=jm.MLPSpec(hidden=(16, 16)))),
        ("atomic_shift", jh.AtomicShiftHead(key_in="energy", key_out="energy")),
        ("atomic_sum", jh.AtomicSumHead(key_in="energy", key_out="energy")),
    ]
    if coulomb:
        outputs.append(("lrcoulomb", jh.LRCoulombHead(rc=4.6, key_in="charges", key_out="energy")))
    if d3:
        outputs.append(("external_dftd3", jh.DFTD3Head(**D3)))
    if multipoles:
        outputs += [("dipole", jh.DipoleHead()), ("quadrupole", jh.QuadrupoleHead())]
    return JConfig(outputs=tuple(outputs), num_charge_channels=channels, **NARROW)


def jax_artifact(path, cfg, seed=0, **kw):
    """JAX's export of random weights (``seed``) of ``cfg`` to ``path``."""
    params = j_init(jax.random.key(seed), cfg)
    kw.setdefault("sae", SAE)
    kw.setdefault("implemented_species", SPECIES)
    j_export(params, cfg, str(path), **kw)
    return str(path)


def box(n=60, a=12.0, seed=0):
    """A jittered-lattice CHNO box, some atoms outside the cell."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)[:n]
    coord = (grid + 0.5) * (a / m) + rng.uniform(-0.15, 0.15, size=(n, 3)) * (a / m)
    coord[: n // 6] += a
    numbers = rng.choice(SPECIES, size=n, p=[0.5, 0.35, 0.05, 0.1])
    return {"coord": coord.astype(np.float32), "numbers": numbers, "cell": np.eye(3, dtype=np.float32) * a}


def mol(n, seed, **extra):
    """A gas-phase molecule: ``n`` atoms of a box at the same density."""
    b = box(n, a=(n / 0.09) ** (1.0 / 3.0), seed=seed)
    b["coord"] -= b["coord"].mean(0)
    return {"coord": b["coord"], "numbers": b["numbers"], **extra}


# layout: (input, binned_threshold, stress, the port's prepared layout)
LAYOUTS = {
    "molecule": (mol(20, 1), 1024, False, "indexed"),
    "batch": ([mol(20, 2 + k) for k in range(4)], 40, False, "packed"),
    "box": (box(), 0, True, "binned"),
}


def assert_matches(got, ref, keys=("energy", "charges", "forces")):
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)
    for k in keys:
        if k != "energy":
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6 if k == "stress" else 1e-5, err_msg=k)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return jax_artifact(tmp_path_factory.mktemp("art") / "model.pt", jax_config())


@pytest.fixture(scope="module")
def loaded(artifact):
    return jloader.load_v2_artifact(artifact), tloader.load_model(artifact)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_jax_artifact_matches_jax(loaded, artifact, layout):
    """``AIMNet2Calculator(path)`` on the port against JAX's calculator on
    JAX's load of the same file."""
    data, threshold, stress, kind = LAYOUTS[layout]
    ref = JCalculator(loaded[0].as_calculator_model(), binned_threshold=threshold).eval(
        data, forces=True, stress=stress
    )
    calc = TCalculator(artifact, device="cpu", binned_threshold=threshold)
    got = calc.eval(data, forces=True, stress=stress)
    assert calc._prep_cache["kind"] == kind
    assert_matches(got, ref, ("energy", "charges", "forces") + (("stress",) if stress else ()))
    assert np.isfinite(got["forces"]).all()


def test_loaded_model_is_jax_load(loaded):
    """Heads, metadata, the float64 SAE and every parameter equal JAX's
    load bit for bit (NaN rows where JAX has them)."""
    jl, tl = loaded
    assert [n for n, _ in tl.cfg.outputs] == [n for n, _ in jl.cfg.outputs] == [
        "energy_mlp", "atomic_shift", "atomic_sum", "srcoulomb", "external_coulomb", "external_dftd3"]
    heads = dict(tl.cfg.outputs)
    assert heads["srcoulomb"] == th.SRCoulombHead(rc=4.6, envelope="exp")
    assert heads["external_coulomb"] == th.LRCoulombHead(rc=4.6, method="simple", subtract_sr=False)
    assert heads["external_dftd3"] == th.DFTD3Head(**D3)
    for (n, jhd), (_n, thd) in zip(jl.cfg.outputs, tl.cfg.outputs):
        assert dataclasses.asdict(jhd) == dataclasses.asdict(thd), n
    assert tl.metadata == jl.metadata
    assert tl.metadata["coulomb_mode"] == "sr_embedded" and tl.metadata["implemented_species"] == SPECIES
    np.testing.assert_array_equal(tl.aux["sae"]["atomic_shift"], jl.aux["sae"]["atomic_shift"])
    assert tl.aux["sae"]["atomic_shift"].dtype == np.float64
    j_leaves, j_tree = jax.tree.flatten(jl.params)
    t_leaves, t_tree = jax.tree.flatten(tl.params)
    assert t_tree == j_tree
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == torch.float32 and a.device.type == "cpu" and a.is_contiguous()
        assert tuple(a.shape) == np.shape(b)  # 0-d leaves stay 0-d
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    afv = tl.params["afv"]["weight"].numpy()
    unimplemented = np.ones(len(afv), bool)
    unimplemented[[0] + SPECIES] = False
    assert np.isnan(afv[unimplemented]).all() and np.isfinite(afv[~unimplemented]).all()


def test_model_forms_agree(loaded, artifact):
    """A path, a ``LoadedModel`` and its ``(params, cfg, aux)`` tuple give
    one calculator; ``attach_lr=False`` returns the bare network, to which
    the calculator attaches the heads the metadata asks for."""
    _jl, tl = loaded
    data = LAYOUTS["molecule"][0]
    outs = [TCalculator(m, device="cpu").eval(data, forces=True)
            for m in (artifact, tl, tl.as_calculator_model())]
    bare = tloader.load_v2_artifact(artifact, attach_lr=False)
    assert [n for n, _ in bare.cfg.outputs][-1] == "srcoulomb"
    calc = TCalculator(bare, device="cpu")
    assert calc.has_external_coulomb and calc.has_external_dftd3
    outs.append(calc.eval(data, forces=True))
    for o in outs[1:]:
        np.testing.assert_array_equal(o["energy"], outs[0]["energy"])
        np.testing.assert_array_equal(o["forces"], outs[0]["forces"])


def test_padding_and_batches_stay_finite_with_nan_rows(loaded):
    """The artifact's NaN embedding rows reach no implemented atom: every
    lookup is a gather, and padding reads the unmasked row 0."""
    _jl, tl = loaded
    calc = TCalculator(tl, device="cpu", binned_threshold=40)
    out = calc.eval(LAYOUTS["batch"][0], forces=True)
    assert np.isfinite(out["energy"]).all() and np.isfinite(out["forces"]).all()
    bad = mol(12, 9)
    bad["numbers"][0] = 17
    with pytest.raises(ValueError, match=r"\[17\].*implemented_species"):
        calc.eval(bad)
    assert np.isnan(calc.eval(bad, validate_species=False)["energy"]).all()


# -- NSE and rxn structures ----------------------------------------------------


def _written_from_tree(tmp_path, cfg, **kw):
    """JAX's export of a config rebuilt from JAX's own ``config_to_yaml``."""
    tree = j_config_to_yaml(cfg)
    return jax_artifact(tmp_path / "m.pt", dataclasses.replace(j_config_from_yaml(tree), outputs=cfg.outputs), **kw)


@pytest.mark.parametrize("layout", ["molecule", "batch"])
def test_nse_artifact_matches_jax(tmp_path, layout):
    path = _written_from_tree(tmp_path, jax_config(channels=2))
    data, threshold, _stress, kind = LAYOUTS[layout]
    if isinstance(data, list):
        data = [{**m, "charge": 1.0, "mult": 2.0} for m in data]
    else:
        data = {**data, "charge": 1.0, "mult": 2.0}
    ref = JCalculator(jloader.load_model(path).as_calculator_model(), binned_threshold=threshold).eval(
        data, forces=True)
    calc = TCalculator(path, device="cpu", binned_threshold=threshold)
    assert calc.is_nse
    got = calc.eval(data, forces=True)
    assert calc._prep_cache["kind"] == kind
    assert_matches(got, ref, ("energy", "charges", "spin_charges", "forces"))


@pytest.mark.parametrize("layout", ["molecule", "batch"])
def test_rxn_artifact_matches_jax(tmp_path, layout):
    """The rxn family: dipole and quadrupole heads, post-hoc D3 attached
    from the registry's family policy, net-charged systems refused."""
    path = _written_from_tree(tmp_path, jax_config(d3=False, multipoles=True), extra_metadata={"family": "rxn"})
    jl, tl = jloader.load_model(path), tloader.load_model(path)
    assert tl.metadata == jl.metadata
    assert tl.metadata["supports_charged_systems"] is False and tl.metadata["needs_dispersion"]
    assert [n for n, _ in tl.cfg.outputs][-1] == "external_dftd3"
    data, threshold, _stress, kind = LAYOUTS[layout]
    jcalc = JCalculator(jl.as_calculator_model(), binned_threshold=threshold)
    calc = TCalculator(tl, device="cpu", binned_threshold=threshold)
    got, ref = calc.eval(data, forces=True), jcalc.eval(data, forces=True)
    assert calc._prep_cache["kind"] == kind
    assert got["dipole"].shape == ref["dipole"].shape and got["quadrupole"].shape == ref["quadrupole"].shape
    assert_matches(got, ref, ("energy", "charges", "forces", "dipole", "quadrupole"))
    charged = {**LAYOUTS["molecule"][0], "charge": 1.0}
    for c in (calc, jcalc):
        with pytest.raises(ValueError, match="net-charged"):
            c.eval(charged)


# -- the trust boundary ----------------------------------------------------------


def _payload(artifact):
    return torch.load(artifact, map_location="cpu", weights_only=True)


def _malicious_yaml(p):
    p["model_yaml"] = p["model_yaml"].replace("activation_fn: torch.nn.GELU", "activation_fn: os.system")


def _add_head(text):
    def mutate(p):
        tree = yaml.safe_load(p["model_yaml"])
        tree["kwargs"]["outputs"].update(yaml.safe_load(text))
        p["model_yaml"] = yaml.safe_dump(tree, sort_keys=False)
    return mutate


def _set(key, value):
    def mutate(p):
        if value is _DROP:
            p.pop(key)
        else:
            p[key] = value
    return mutate


_DROP = object()


def _jit_archive(path):
    class M(torch.nn.Module):
        def forward(self, x):
            return x + 1

    torch.jit.save(torch.jit.script(M()), path)


def _truncate(path):
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])


def _garbage(path):
    open(path, "wb").write(b"\x80\x02not a real archive" * 10)


# case: (payload mutation, or None; file mutation, or None)
TRUST_CASES = {
    "forbidden_ptfile": (_add_head("disp_param:\n  class: aimnet.modules.lr.DispParam\n"
                                   "  kwargs: {ptfile: /etc/passwd}\n"), None),
    "nested_malicious_path": (_malicious_yaml, None),
    "unknown_head_class": (_add_head("evil:\n  class: evil.Module\n  kwargs: {}\n"), None),
    "non_mapping_yaml": (_set("model_yaml", "- just\n- a\n- list\n"), None),
    "oversized_yaml": (_set("model_yaml", "a: " + "[" * 60), None),
    "format_version_3": (_set("format_version", 3), None),
    "format_version_str": (_set("format_version", "2"), None),
    "format_version_1": (_set("format_version", 1), None),
    "format_version_missing": (_set("format_version", _DROP), None),
    "cutoff_negative": (_set("cutoff", -1.0), None),
    "cutoff_nan": (_set("cutoff", float("nan")), None),
    "cutoff_str": (_set("cutoff", "five"), None),
    "cutoff_missing": (_set("cutoff", _DROP), None),
    "d3ts_nan_damping": (_add_head("d3ts:\n  class: aimnet.modules.D3TS\n  kwargs: {a1: .nan, a2: 3.5, s8: 0.78}\n"),
                         None),
    "d3ts_negative_damping": (_add_head("d3ts:\n  class: aimnet.modules.D3TS\n  kwargs: {a1: -0.1, a2: 3.5, "
                                        "s8: 0.78}\n"), None),
    "non_tensor_state": (lambda p: p["state_dict"].update({"afv.weight": "not a tensor"}), None),
    "missing_parameter": (lambda p: p["state_dict"].pop("conv_a.agh"), None),
    "not_a_dict": (lambda p: p.pop("state_dict"), None),
    "bad_coulomb_mode": (_set("coulomb_mode", "everything"), None),
    "bad_species": (_set("implemented_species", [1, -6]), None),
    "truncated": (None, _truncate),
    "garbage": (None, _garbage),
    "torchscript": (None, _jit_archive),
}


def _outcome(fn):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn()
    except Exception as e:  # the outcome under test
        return type(e)
    return None


@pytest.mark.parametrize("case", list(TRUST_CASES))
def test_trust_boundary_matches_jax(artifact, tmp_path, case):
    """Each case: the port refuses what JAX refuses, with the same
    exception type, and loads what JAX loads."""
    mutate, corrupt = TRUST_CASES[case]
    path = str(tmp_path / "case.pt")
    payload = _payload(artifact)
    if mutate is not None:
        mutate(payload)
    torch.save(payload, path)
    if corrupt is not None:
        corrupt(path)
    want = _outcome(lambda: jloader.load_v2_artifact(path))
    got = _outcome(lambda: tloader.load_v2_artifact(path))
    assert got is want
    if case not in ("format_version_1", "format_version_missing"):
        assert want is not None, "a case JAX accepts teaches nothing here"


def test_import_policy_modes(artifact, tmp_path):
    """``replace`` with a path list that omits the model's classes refuses;
    ``unsafe`` skips the allowlist but still refuses ``ptfile``."""
    for mode, paths in (("replace", ("my.module.Head",)), ("unsafe", None)):
        for loader in (jloader, tloader):
            if mode == "replace":
                with pytest.raises(ValueError, match="Untrusted"):
                    loader.load_v2_artifact(artifact, model_import_paths=paths, model_import_mode=mode)
            else:
                loader.load_v2_artifact(artifact, model_import_mode=mode)
    payload = _payload(artifact)
    _add_head("disp_param:\n  class: aimnet.modules.lr.DispParam\n  kwargs: {ptfile: /etc/passwd}\n")(payload)
    path = str(tmp_path / "ptfile.pt")
    torch.save(payload, path)
    with pytest.raises(ValueError, match="ptfile"):
        tloader.load_v2_artifact(path, model_import_mode="unsafe")
    with pytest.raises(ValueError, match="model_import_mode"):
        tloader.load_v2_artifact(artifact, model_import_mode="everything")


def test_registry_family_mismatch_refused(artifact, tmp_path):
    payload = _payload(artifact)
    payload["family"] = "wb97m-d3"
    path = str(tmp_path / "fam.pt")
    torch.save(payload, path)
    for loader in (jloader, tloader):
        with pytest.raises(ValueError, match="Refusing to load"):
            loader.load_v2_artifact(path, registry_family="rxn")
    assert tloader.load_v2_artifact(path, registry_family="wb97m-d3").metadata["family"] == "wb97m-d3"


@pytest.mark.parametrize("meta,call", [
    ({"family": "rxn", "needs_dispersion": False, "d3_params": None, "has_embedded_d3ts": False,
      "supports_charged_systems": None}, None),
    ({"family": "rxn"}, "wb97m-d3"),
    ({"family": "rxn", "supports_charged_systems": True}, None),
    ({"family": "rxn", "has_embedded_d3ts": True}, None),
    ({"family": None}, "nse"),
])
def test_family_defaults_match_jax(meta, call):
    want = _outcome(lambda: jloader.apply_family_defaults(meta, call))
    assert _outcome(lambda: tloader.apply_family_defaults(meta, call)) is want
    if want is None:
        assert tloader.apply_family_defaults(meta, call) == jloader.apply_family_defaults(meta, call)


# -- species, charge and mult -------------------------------------------------------


def _calcs(meta, **kw):
    """JAX's and the port's calculator on one narrow model with ``meta``."""
    cfg = jax_config(coulomb=False, d3=False)
    jp = j_init(jax.random.key(1), cfg)
    from aimnetcentral_tpu_torch.models.bridge import params_from_numpy
    from test_torch_export import port_config

    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    aux = {"sae": {}, "metadata": dict(meta)}
    return (JCalculator((jp, cfg, copy.deepcopy(aux)), **kw),
            TCalculator((tp, port_config(cfg), copy.deepcopy(aux)), device="cpu", **kw))


@pytest.mark.parametrize("case", ["species", "charge", "batch_charge", "no_metadata"])
def test_species_and_charge_checks_match_jax(case):
    meta = {"species": {"implemented_species": SPECIES}, "charge": {"supports_charged_systems": False},
            "batch_charge": {"supports_charged_systems": False}, "no_metadata": {}}[case]
    data = mol(8, 3)
    if case == "species" or case == "no_metadata":
        data["numbers"] = data["numbers"].copy()
        data["numbers"][0] = 17
    if case == "charge" or case == "no_metadata":
        data["charge"] = 1.0
    if case == "batch_charge":
        data = [mol(8, 3), {**mol(6, 4), "charge": -1.0}]
    jc, tc = _calcs(meta)
    want = _outcome(lambda: jc.eval(data))
    assert _outcome(lambda: tc.eval(data)) is want
    assert (want is None) == (case == "no_metadata")
    got, ref = tc.eval(data, validate_species=False), jc.eval(data, validate_species=False)
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)


def test_species_check_sees_in_place_changes():
    """The species cache keys on content, not identity: an array changed in
    place is checked again."""
    _jc, tc = _calcs({"implemented_species": SPECIES})
    data = mol(8, 5)
    tc.eval(data)
    data["numbers"][0] = 17
    with pytest.raises(ValueError, match="implemented_species"):
        tc.eval(data)


def test_mult_warns_once_on_closed_shell():
    _jc, tc = _calcs({})
    data = {**mol(6, 6), "mult": 3.0}
    with pytest.warns(UserWarning, match="mult is ignored"):
        tc.eval(data)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tc.eval(data)


# -- external long-range overrides -------------------------------------------------------


META_D3 = {"needs_coulomb": False, "needs_dispersion": True, "coulomb_mode": "none",
           "d3_params": {"s6": 1.0, **D3}}


@pytest.mark.parametrize("case", [
    "strip_d3", "attach_d3", "attach_coulomb_null_metadata", "full_embedded_refuses_coulomb",
    "embedded_d3ts_refuses_d3", "incomplete_d3_params", "incomplete_d3_params_disabled",
    "sr_embedded_null_rc_not_bypassed",
])
def test_overrides_match_jax(case):
    """Overrides strip or attach the external heads as JAX's do, refuse the
    same metadata, and never change the metadata itself."""
    sr_embedded = {"format_version": 2, "cutoff": 5.0, "needs_coulomb": True, "needs_dispersion": False,
                   "coulomb_mode": "sr_embedded", "coulomb_sr_rc": None, "coulomb_sr_envelope": "exp",
                   "has_embedded_lr": True}
    meta, kw = {
        "strip_d3": (META_D3, {"needs_dispersion": False}),
        "attach_d3": ({**META_D3, "needs_dispersion": False}, {"needs_dispersion": True}),
        "attach_coulomb_null_metadata": ({}, {"needs_coulomb": True}),
        "full_embedded_refuses_coulomb": ({"format_version": 2, "cutoff": 5.0, "coulomb_mode": "full_embedded",
                                           "has_embedded_lr": True}, {"needs_coulomb": True}),
        "embedded_d3ts_refuses_d3": ({"format_version": 2, "cutoff": 5.0, "coulomb_mode": "none",
                                      "d3_params": {"s6": 1.0, **D3}, "has_embedded_lr": True,
                                      "has_embedded_d3ts": True}, {"needs_dispersion": True}),
        "incomplete_d3_params": ({**META_D3, "d3_params": {"s8": 1.0}}, {}),
        "incomplete_d3_params_disabled": ({**META_D3, "d3_params": {"s8": 1.0}}, {"needs_dispersion": False}),
        "sr_embedded_null_rc_not_bypassed": (sr_embedded, {"needs_coulomb": False}),
    }[case]
    original = copy.deepcopy(meta)
    want = _outcome(lambda: _calcs(meta, **kw))
    assert _outcome(lambda: _calcs(meta, **kw)) is want
    assert meta == original
    if want is not None:
        return
    jc, tc = _calcs(meta, **kw)
    assert [n for n, _ in tc.cfg.outputs] == [n for n, _ in jc.cfg.outputs]
    assert tc.metadata == original
    data = mol(10, 7)
    np.testing.assert_allclose(tc.eval(data)["energy"], jc.eval(data)["energy"], rtol=1e-5)


def test_controls_match_jax():
    """The introspection properties and the setters, as JAX's; each setter
    drops the prepared layout."""
    cfg = jax_config()
    jp = j_init(jax.random.key(2), cfg)
    from aimnetcentral_tpu_torch.models.bridge import params_from_numpy
    from test_torch_export import port_config

    jc = JCalculator((jp, cfg, {"sae": {}, "metadata": {}}))
    tc = TCalculator((params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), port_config(cfg),
                      {"sae": {}, "metadata": {}}), device="cpu")
    props = ("is_nse", "has_external_coulomb", "has_external_dftd3", "coulomb_method", "coulomb_cutoff",
             "dftd3_cutoff")
    steps = (("set_lrcoulomb_method", ("dsf",), {"dsf_rc": 12.0}), ("set_dftd3_cutoff", (12.5,), {}),
             ("set_lr_cutoff", (10.0,), {}), ("set_lrcoulomb_method", ("ewald",), {}))
    assert [getattr(tc, p) for p in props] == [getattr(jc, p) for p in props]
    tc.eval(mol(10, 8))
    for name, args, kw in steps:
        getattr(jc, name)(*args, **kw)
        getattr(tc, name)(*args, **kw)
        assert tc._prep_cache is None
        assert [getattr(tc, p) for p in props] == [getattr(jc, p) for p in props], name
    for calc in (jc, tc):  # a gas-phase molecule: Ewald is refused alike
        with pytest.raises(ValueError, match="periodic cell"):
            calc.eval(mol(10, 8))
    with pytest.raises(ValueError, match="unknown Coulomb method"):
        tc.set_lrcoulomb_method("magic")


def test_lr_cutoff_override_reaches_the_layout():
    """``set_lr_cutoff`` sets the reach of the long-range lists as in JAX:
    a 500-atom box's shared LR list, and the energy equals JAX's."""
    cfg = jax_config()
    jp = j_init(jax.random.key(3), cfg)
    from aimnetcentral_tpu_torch.models.bridge import params_from_numpy
    from test_torch_export import port_config

    jc = JCalculator((jp, cfg, {"sae": {}}), reuse_skin=0.0)
    tc = TCalculator((params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), port_config(cfg),
                      {"sae": {}}), device="cpu", reuse_skin=0.0)
    data = box(60, 12.0, seed=4)
    for c in (jc, tc):
        c.set_lr_cutoff(9.0)
    sys_t = tc.prepare_system(data)
    sys_j = jc.prepare_system(data)
    assert sys_t.nbmat_lr.shape[1] == sys_j.nbmat_lr.shape[1]
    np.testing.assert_allclose(tc.eval(data)["energy"], jc.eval(data)["energy"], rtol=1e-5)


def test_hf_style_directory_matches_jax(loaded, artifact, tmp_path):
    """``load_model`` on a local Hugging Face style directory (config.json
    and ensemble_0.safetensors, written from the same artifact) gives JAX's
    parameters and energies."""
    from safetensors.numpy import save_file

    payload = _payload(artifact)
    config = {k: v for k, v in payload.items() if k != "state_dict"}
    (tmp_path / "config.json").write_text(json.dumps(config))
    save_file({k: v.numpy() for k, v in payload["state_dict"].items()}, str(tmp_path / "ensemble_0.safetensors"))
    jl, tl = jloader.load_model(str(tmp_path)), tloader.load_model(str(tmp_path))
    assert tl.metadata == jl.metadata
    np.testing.assert_array_equal(tl.aux["sae"]["atomic_shift"], jl.aux["sae"]["atomic_shift"])
    data = LAYOUTS["molecule"][0]
    got = TCalculator(tl, device="cpu").eval(data, forces=True)
    ref = JCalculator(jl.as_calculator_model()).eval(data, forces=True)
    assert_matches(got, ref)
    with pytest.raises(ValueError, match="member"):
        tloader.load_hf_repo(str(tmp_path), member=-1)
