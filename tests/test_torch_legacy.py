"""The port's legacy ``.jpt`` path (models/convert_v1.py,
``loader.load_jpt_model``, ``AIMNet2Calculator.from_legacy_jit``, the
``convert`` command) against the JAX package's (CPU).

Both packages read the same hand-made archives (tests/torch_jpt_helpers.py,
the TorchScript stand-in of a v1 ``.jpt``), written from JAX's random
weights through JAX's ``params_to_state_dict`` and ``config_to_yaml`` at
narrow widths, for six head sets: the flagship's (LRCoulomb simple), the
same with DFTD3, the long-range heads (SRRep, DispParam, D3TS), rxn's
(Dipole, Quadrupole), NSE with two charge channels, and a model without
``d2features``.  For each:

- ``infer_model_yaml_from_scripted`` gives JAX's tree, and its config is
  the source's once the heads' ``rc`` are rounded to float32 (the archive
  keeps ``rc`` as a float32 buffer);
- ``load_jpt_model`` gives JAX's heads, metadata, float64 SAE table and
  parameters bit for bit;
- energies, charges and forces of the legacy model on the port's
  indexed and molecule-bin layouts agree with JAX's on the same batch
  within test_torch_loader.py's limits (1e-5 relative energy, 1e-5 eV/A);
  the binned layout's in test_torch_legacy_box.py;
- ``convert_v1_model`` with the architecture read from the archive, from
  an explicit YAML, and with ``implemented_species`` and ``family``
  writes JAX's file: the state dict bit for bit (NaN rows included), the
  metadata and the ``model_yaml`` text; each package loads the other's;
- the ``convert`` command through click's runner on both CLIs, which list
  the same commands; every JAX module but the two TPU-only ones has its
  counterpart in the port.

The refusals, outcome for outcome as JAX's tests/test_jpt_direct.py: an
unknown head class, import settings, a D3 head without damping
parameters, ``from_legacy_jit(model=...)`` and ``needs_coulomb=True`` on a
model whose Coulomb is embedded.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from click.testing import CliRunner  # noqa: E402

from aimnetcentral_tpu import cli as jcli  # noqa: E402
from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator  # noqa: E402
from aimnetcentral_tpu.models import AIMNet2Config as JConfig  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models import convert_v1 as jconvert_v1  # noqa: E402
from aimnetcentral_tpu.models import heads as jheads  # noqa: E402
from aimnetcentral_tpu.models import loader as jloader  # noqa: E402
from aimnetcentral_tpu.models import modules as jmodules  # noqa: E402
from aimnetcentral_tpu.models.convert import config_from_yaml as j_config_from_yaml  # noqa: E402
from aimnetcentral_tpu.train import export as jexport  # noqa: E402
from aimnetcentral_tpu_torch import cli as tcli  # noqa: E402
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator  # noqa: E402
from aimnetcentral_tpu_torch.models import convert_v1 as tconvert_v1  # noqa: E402
from aimnetcentral_tpu_torch.models import loader as tloader  # noqa: E402
from test_torch_loader import LAYOUTS, NARROW, SPECIES, _outcome, assert_matches, jax_config  # noqa: E402
from test_torch_lr_heads import _disp_table, lr_head_outputs  # noqa: E402
from torch_jpt_helpers import make_introspectable_jpt  # noqa: E402

CUTOFF = 5.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _renamed(cfg, names):
    return dataclasses.replace(cfg, outputs=tuple((names.get(n, n), h) for n, h in cfg.outputs))


# the head sets, as the reference's YAMLs name their heads (lrcoulomb, dftd3)
CONFIGS = {
    "flagship": jax_config(d3=False),
    "flagship-d3": _renamed(jax_config(), {"external_dftd3": "dftd3"}),
    "lr-heads": JConfig(outputs=lr_head_outputs(jheads, jmodules), **NARROW),
    "rxn": jax_config(d3=False, multipoles=True),
    "nse": jax_config(channels=2, d3=False),
    "nod2": dataclasses.replace(jax_config(d3=False), d2features=False),
}
FAMILY = {"rxn": "rxn", "nse": "nse"}


def _source(name):
    """JAX's random weights of ``CONFIGS[name]``: the reference-layout state
    dict (numpy) and the model YAML tree.  SRRep's ``rc`` is a buffer of
    the reference's module, which JAX's exporter does not write."""
    cfg = CONFIGS[name]
    params = j_init(jax.random.key(3), cfg)
    if name == "lr-heads":
        params["outputs"]["disp_param"] = {"disp_param0": jax.numpy.asarray(_disp_table())}
    sd = jexport.params_to_state_dict(params, cfg)
    if name == "lr-heads":
        sd["outputs.srrep.rc"] = np.asarray(4.0, np.float32)
    return sd, jexport.config_to_yaml(cfg)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpt")
    out = {}
    for name in CONFIGS:
        sd, tree = _source(name)
        path = str(d / f"{name}.jpt")
        make_introspectable_jpt(sd, tree, CUTOFF, path)
        out[name] = (path, tree)
    return out


@pytest.fixture(scope="module")
def loaded(archives):
    return {name: (jloader.load_model(path), tloader.load_model(path)) for name, (path, _t) in archives.items()}


def _data(name, layout):
    data, threshold, _stress, _kind = LAYOUTS[layout]
    if name == "nse":
        extra = {"charge": 1.0, "mult": 2.0}
        data = [{**m, **extra} for m in data] if isinstance(data, list) else {**data, **extra}
    return data, threshold


@pytest.mark.parametrize("name", list(CONFIGS))
def test_inferred_tree_matches_jax(archives, name):
    path, tree = archives[name]
    jit_model = torch.jit.load(path, map_location="cpu")
    got = tconvert_v1.infer_model_yaml_from_scripted(jit_model)
    assert got == jconvert_v1.infer_model_yaml_from_scripted(jit_model)
    # the archive keeps rc as a float32 buffer: the source's rc rounded so
    expect = copy.deepcopy(tree)
    for hcfg in expect["kwargs"]["outputs"].values():
        if "rc" in hcfg.get("kwargs", {}):
            hcfg["kwargs"]["rc"] = float(np.float32(hcfg["kwargs"]["rc"]))
    assert j_config_from_yaml(got) == j_config_from_yaml(expect)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_load_jpt_model_is_jax_load(loaded, name):
    """Heads, metadata (format_version 1, the embedded Coulomb, D3
    parameters from a tabulated DFTD3 head only), the float64 SAE table and
    every parameter equal JAX's load bit for bit."""
    jl, tl = loaded[name]
    assert [n for n, _ in tl.cfg.outputs] == [n for n, _ in jl.cfg.outputs] == [n for n, _ in CONFIGS[name].outputs]
    for (n, jh), (_n, th) in zip(jl.cfg.outputs, tl.cfg.outputs):
        assert type(th).__name__ == type(jh).__name__ and dataclasses.asdict(th) == dataclasses.asdict(jh), n
    assert dataclasses.asdict(tl.cfg.aev) == dataclasses.asdict(jl.cfg.aev)
    assert (tl.cfg.d2features, tl.cfg.num_charge_channels, tl.cfg.hidden) == (
        jl.cfg.d2features, jl.cfg.num_charge_channels, jl.cfg.hidden)
    assert tl.metadata == jl.metadata and tl.aux["metadata"] == tl.metadata
    md = tl.metadata
    assert md["format_version"] == 1 and md["cutoff"] == CUTOFF
    assert md["coulomb_mode"] == "full_embedded" and md["has_embedded_lr"]
    assert not md["needs_coulomb"] and not md["needs_dispersion"]
    assert md["has_embedded_d3ts"] == (name == "lr-heads")
    assert (md["d3_params"] is None) == (name != "flagship-d3")
    np.testing.assert_array_equal(tl.aux["sae"]["atomic_shift"], jl.aux["sae"]["atomic_shift"])
    assert tl.aux["sae"]["atomic_shift"].dtype == np.float64
    j_leaves, j_tree = jax.tree.flatten(jl.params)
    t_leaves, t_tree = jax.tree.flatten(tl.params)
    assert t_tree == j_tree
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def legacy_matches_jax(path, jax_model, name, data, layouts, jax_threshold=1 << 30):
    """``AIMNet2Calculator(path)`` on the port's ``layouts`` ((binned_threshold,
    the prepared layout) pairs) against JAX's calculator on its load of the
    same archive (at ``jax_threshold``: its indexed layout by default, one
    compile an input) within test_torch_loader.py's limits."""
    keys = ("energy", "charges", "forces") + (("dipole", "quadrupole") if name == "rxn" else ())
    keys += ("spin_charges",) if name == "nse" else ()
    ref = JCalculator(jax_model.as_calculator_model(), binned_threshold=jax_threshold).eval(data, forces=True)
    for threshold, kind in layouts:
        calc = TCalculator(path, device="cpu", binned_threshold=threshold)
        assert calc.coulomb_method is None and not calc.has_external_coulomb and not calc.has_external_dftd3
        got = calc.eval(data, forces=True)
        assert calc._prep_cache["kind"] == kind
        assert_matches(got, ref, keys)
        assert np.isfinite(got["forces"]).all()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_legacy_batch_matches_jax(archives, loaded, name):
    """A batch of four molecules on the port's indexed and molecule-bin
    layouts (the box's binned layout: test_torch_legacy_box.py)."""
    legacy_matches_jax(archives[name][0], loaded[name][0], name, _data(name, "batch")[0],
                       ((1024, "indexed"), (40, "packed")))


def _convert(pkg, path, d, yaml_path=None, species=None, family=None):
    out = str(d / f"{pkg.__name__.split('.')[0]}.pt")
    loaded, artifact = pkg.convert_v1_model(path, yaml_path, output_path=out, implemented_species=species,
                                            family=family)
    return out, loaded, artifact


def _same_files(t_path, j_path):
    """The two v2 files: the same state-dict keys, dtypes and values (NaN
    rows included), metadata and ``model_yaml`` text; each package loads the
    other's file to the same parameters (an SRRep head set is refused by
    both loaders alike: the v2 allowlist leaves SRRep out, ROADMAP.md
    section 3)."""
    j_art = torch.load(j_path, weights_only=True)
    t_art = torch.load(t_path, weights_only=True)
    assert {k: v for k, v in t_art.items() if k != "state_dict"} == {
        k: v for k, v in j_art.items() if k != "state_dict"}
    j_sd, t_sd = j_art["state_dict"], t_art["state_dict"]
    assert list(t_sd) == list(j_sd)
    for k in j_sd:
        assert t_sd[k].dtype == j_sd[k].dtype and t_sd[k].shape == j_sd[k].shape, k
        assert np.array_equal(t_sd[k].numpy(), j_sd[k].numpy(), equal_nan=True), k
    for path in (t_path, j_path):
        want = _outcome(lambda: jloader.load_model(path))
        assert _outcome(lambda: tloader.load_model(path)) is want
        if want is None:
            jl, tl = jloader.load_model(path), tloader.load_model(path)
            assert tl.metadata == jl.metadata
            for a, b in zip(jax.tree.leaves(tl.params), jax.tree.leaves(jl.params)):
                assert np.array_equal(a.numpy(), np.asarray(b), equal_nan=True)
    return t_art


@pytest.mark.parametrize("variant", ["inferred", "yaml", "species-family"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_convert_v1_matches_jax(archives, tmp_path, name, variant):
    path, tree = archives[name]
    kw = {}
    if variant == "yaml":
        kw["yaml_path"] = str(tmp_path / "model.yaml")
        with open(kw["yaml_path"], "w") as f:
            yaml.safe_dump(tree, f, sort_keys=False)
    if variant == "species-family":
        kw.update(species=[8, 1, 6, 7, 1], family=FAMILY.get(name, "wb97m-d3"))
    j_path, jl, j_art = _convert(jconvert_v1, path, tmp_path, **kw)
    t_path, tl, t_art = _convert(tconvert_v1, path, tmp_path, **kw)
    assert t_art.keys() == j_art.keys() and tl.metadata == jl.metadata
    art = _same_files(t_path, j_path)
    assert art["coulomb_mode"] == "sr_embedded" and art["needs_coulomb"] and art["cutoff"] == CUTOFF
    assert art["needs_dispersion"] == (name == "flagship-d3")
    assert art["state_dict"]["outputs.atomic_shift.shifts.weight"].dtype == torch.float64
    if variant == "species-family":
        assert art["implemented_species"] == SPECIES and art["family"] == FAMILY.get(name, "wb97m-d3")
        afv = art["state_dict"]["afv.weight"].numpy()
        unimplemented = np.ones(len(afv), bool)
        unimplemented[[0] + SPECIES] = False
        assert np.isnan(afv[unimplemented]).all() and np.isfinite(afv[~unimplemented]).all()
        np.testing.assert_array_equal(tl.params["afv"]["weight"].numpy(), afv)


def test_converted_artifact_matches_the_legacy_model(archives):
    """The v2 file (SR Coulomb in the model, external simple Coulomb without
    its SR part, external D3) gives the legacy model's energies and forces."""
    path, _tree = archives["flagship-d3"]
    converted = str(archives["flagship-d3"][0]).replace(".jpt", "-v2.pt")
    tcli.run_convert(path, converted, species="1,6,7,8")
    calc = TCalculator(converted, device="cpu")
    assert [n for n, _ in calc.cfg.outputs][-3:] == ["srcoulomb", "external_coulomb", "external_dftd3"]
    assert calc.coulomb_method == "simple"
    for layout in LAYOUTS:
        data, threshold = _data("flagship-d3", layout)
        got = TCalculator(converted, device="cpu", binned_threshold=threshold).eval(data, forces=True)
        want = TCalculator.from_legacy_jit(path, device="cpu", binned_threshold=threshold).eval(data, forces=True)
        assert_matches(got, want)


def test_convert_command_matches_jax(archives, tmp_path):
    """``convert`` through click on both CLIs writes the same file; the two
    CLIs have the same commands."""
    assert sorted(tcli.cli.commands) == sorted(jcli.cli.commands)
    path, _tree = archives["flagship-d3"]
    outs = {}
    for tag, group, pre in (("jax", jcli.cli, []), ("port", tcli.cli, ["--device", "cpu"])):
        outs[tag] = str(tmp_path / f"{tag}.pt")
        res = CliRunner().invoke(group, pre + ["convert", path, "--output", outs[tag], "--species", "1,6,7,8",
                                               "--family", "wb97m-d3"])
        assert res.exit_code == 0, res.output
        assert res.output.strip() == f"converted {path} -> {outs[tag]}"
    _same_files(outs["port"], outs["jax"])


# Public names of the JAX package without a counterpart of the same name in
# the port's module of the same path, each a TPU-only piece: the Pallas
# kernels' switches and entry points, their banded-grid tables, the XLA
# engines the port does not have (it runs one engine: the kernels on the
# card, their plain versions on the CPU; ROADMAP.md section 3) and JAX's
# matmul-precision constants.
TPU_ONLY_NAMES = {
    # whether Pallas imports and the backend is a TPU; the port's kernels
    # are built by kernels/build.py on any card
    "kernels/__init__.py": {"PALLAS_CONV_ENABLED"},
    "kernels/conv_stencil.py": {"PALLAS_CONV_ENABLED", "conv_stencil_available",
                                # the banded Pallas adjoint; the port's kernel B is conv_stencil_backward
                                "conv_stencil_bwd_banded"},
    # the half-band Pallas sweeps, their static shapes and custom_vjp; the
    # port's kernels D and E are pair_sweep_forward / _backward, PairStatic, PairAcc
    "kernels/pair_sweep.py": {"PAIR_SWEEP_ENABLED", "pair_sweep_available", "PairStaticHB", "pair_acc_hb",
                              "pair_sweep_forward_hb", "pair_sweep_backward_hb", "pair_energy_pallas"},
    # the XLA engines of the conv (AIMNET_CONV_ENGINE=xla) and of the D3
    # sweeps; the port's are kernels/conv_pass.py::conv_pass and the D3 terms
    # of kernels D and E (pair_sweep.D3CNTerm, D3EnergyTerm)
    "models/engine_binned.py": {"conv_pass_binned", "d3_cn_fn", "d3_e_fn"},
    # the TPU's banded z-row grid (sequential grid steps, 128-lane tiles); the
    # port keeps per-offset tables (stencil_tables, mirror_stencil_tables)
    "ops/binned.py": {"row_stencil_tables", "mirror_row_stencil_tables", "xy_band_tables", "xy_band_tables_half",
                      "stencil_map"},
    # jax.lax.Precision.HIGHEST; the port's exact contractions are ops/math.py::cellmul
    "models/ewald.py": {"HI"},
    "ops/math.py": {"HIGHEST"},
}


def _public_names(mod) -> set[str]:
    """Names a module defines at top level: not private, not modules, and
    not functions, classes or typing aliases imported from elsewhere."""
    import inspect

    out = set()
    for name, obj in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        origin = getattr(obj, "__module__", None)
        if origin in ("typing", "collections.abc"):
            continue
        if (inspect.isfunction(obj) or inspect.isclass(obj)) and origin != mod.__name__:
            continue
        out.add(name)
    return out


def test_every_module_of_jax_has_its_port():
    """The JAX package's modules all have a counterpart of the same path in
    the port, but two TPU-only ones: ``kernels/conv_pallas.py`` (the port's
    ``kernels/conv_pass.py``) and ``xla_cache.py`` (``kernels/build.py``);
    and every public top-level name of each has the same name there, but
    the ``TPU_ONLY_NAMES``."""
    import importlib

    def modules(pkg):
        root = os.path.dirname(pkg.__file__)
        return {os.path.relpath(os.path.join(d, f), root) for d, _s, fs in os.walk(root) for f in fs
                if f.endswith(".py")}

    import aimnetcentral_tpu
    import aimnetcentral_tpu_torch

    jax_modules = modules(aimnetcentral_tpu)
    assert jax_modules - modules(aimnetcentral_tpu_torch) == {"kernels/conv_pallas.py", "xla_cache.py"}
    missing = {}
    for rel in sorted(jax_modules - {"kernels/conv_pallas.py", "xla_cache.py"}):
        dotted = rel[: -len(".py")].replace("/", ".").removesuffix(".__init__").removesuffix("__init__")
        suffix = f".{dotted}" if dotted else ""
        jmod = importlib.import_module(f"aimnetcentral_tpu{suffix}")
        tmod = importlib.import_module(f"aimnetcentral_tpu_torch{suffix}")
        gap = _public_names(jmod) - set(vars(tmod))
        if gap != TPU_ONLY_NAMES.get(rel, set()):
            missing[rel] = sorted(gap)
    assert not missing


def test_from_legacy_jit_passes_calculator_keywords(archives):
    path, _tree = archives["flagship"]
    calc = TCalculator.from_legacy_jit(path, device="cpu", precision="fast")
    jcalc = JCalculator.from_legacy_jit(path, precision="fast")
    assert calc.precision == jcalc.precision == "fast"
    assert calc.metadata == jcalc.metadata and calc.metadata["coulomb_mode"] == "full_embedded"
    assert calc.coulomb_method is jcalc.coulomb_method is None


def _without_damping(archives, tmp_path):
    sd, tree = _source("flagship-d3")
    tree = copy.deepcopy(tree)
    del tree["kwargs"]["outputs"]["dftd3"]["kwargs"]["s8"]
    path = str(tmp_path / "nod3.jpt")
    make_introspectable_jpt(sd, tree, CUTOFF, path)
    return path


def _weird(archives, tmp_path):
    sd, tree = _source("flagship")
    path = str(tmp_path / "weird.jpt")
    make_introspectable_jpt(sd, tree, CUTOFF, path, head_class_override={"lrcoulomb": "Weird"})
    return path


# each package's (loader, convert_v1, calculator class, calculator keywords)
PACKAGES = {"jax": (jloader, jconvert_v1, JCalculator, {}),
            "port": (tloader, tconvert_v1, TCalculator, {"device": "cpu"})}
# case: (archive maker or None for the flagship's, call, message)
REFUSALS = {
    "unknown_head_class": (_weird, lambda ld, cv, calc, kw, p: ld.load_model(p), "unrecognized class"),
    "unknown_head_class_calculator": (_weird, lambda ld, cv, calc, kw, p: calc.from_legacy_jit(p, **kw),
                                      "unrecognized class"),
    "unknown_head_class_convert": (_weird, lambda ld, cv, calc, kw, p: cv.convert_v1_model(p),
                                   "unrecognized class"),
    "import_mode": (None, lambda ld, cv, calc, kw, p: ld.load_model(p, model_import_mode="unsafe"),
                    "Import settings are not supported"),
    "import_paths": (None, lambda ld, cv, calc, kw, p: ld.load_model(p, model_import_paths=("my_pkg.heads.*",)),
                     "Import settings are not supported"),
    "d3_without_damping": (_without_damping, lambda ld, cv, calc, kw, p: ld.load_model(p),
                           "damping parameter 's8'"),
    "model_keyword": (None, lambda ld, cv, calc, kw, p: calc.from_legacy_jit(p, model="x", **kw), "model keyword"),
    "needs_coulomb_on_embedded": (None, lambda ld, cv, calc, kw, p: calc(p, needs_coulomb=True, **kw),
                                  "full_embedded"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(archives, tmp_path, case):
    make, call, message = REFUSALS[case]
    path = archives["flagship"][0] if make is None else make(archives, tmp_path)
    want = _outcome(lambda: call(*PACKAGES["jax"], path))
    assert want is not None
    with pytest.raises(want, match=message):
        call(*PACKAGES["port"], path)
