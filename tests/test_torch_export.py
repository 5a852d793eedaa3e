"""The port's exporter (train/export.py) against the JAX package's (CPU).

Given the same parameters (JAX's random weights carried across through
numpy), both write the same state-dict keys, dtypes and values bit for bit
(NaN rows included), the same metadata and the same ``model_yaml`` text;
each package loads the other's file to the same energies (1e-5 relative).
The port's exporter validates the metadata before the file exists and
saves atomically, keeping an existing destination's mode.
"""

import dataclasses
import os
import stat

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.calculators.calculator import AIMNet2Calculator as JCalculator  # noqa: E402
from aimnetcentral_tpu.models import aimnet2_init as j_init  # noqa: E402
from aimnetcentral_tpu.models import loader as jloader  # noqa: E402
from aimnetcentral_tpu.train import export as jexport  # noqa: E402
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator as TCalculator  # noqa: E402
from aimnetcentral_tpu_torch.models import AEVConfig as TAEVConfig  # noqa: E402
from aimnetcentral_tpu_torch.models import AIMNet2Config as TConfig  # noqa: E402
from aimnetcentral_tpu_torch.models import heads as th  # noqa: E402
from aimnetcentral_tpu_torch.models import loader as tloader  # noqa: E402
from aimnetcentral_tpu_torch.models import modules as tm  # noqa: E402
from aimnetcentral_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from aimnetcentral_tpu_torch.train import export as texport  # noqa: E402
from test_torch_loader import LAYOUTS, SAE, SPECIES, jax_config  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jcfg):
    """The port's AIMNet2Config equal field for field to the JAX one."""

    def head(h):
        kw = {f.name: getattr(h, f.name) for f in dataclasses.fields(h) if f.init}
        if "mlp" in kw:
            kw["mlp"] = tm.MLPSpec(**dataclasses.asdict(kw["mlp"]))
        return getattr(th, type(h).__name__)(**kw)

    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["aev"] = TAEVConfig(**dataclasses.asdict(jcfg.aev))
    fields["outputs"] = tuple((n, head(h)) for n, h in jcfg.outputs)
    return TConfig(**fields)


# config: (JAX config, exporter keywords)
CONFIGS = {
    "sr_embedded_d3": (jax_config(), {"sae": SAE, "implemented_species": SPECIES}),
    "no_coulomb": (jax_config(coulomb=False), {"sae": SAE}),
    "nse": (jax_config(channels=2, d3=False), {"implemented_species": SPECIES}),
    "multipoles": (jax_config(multipoles=True), {"sae": SAE, "extra_metadata": {"family": "rxn"}}),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def exported(request, tmp_path_factory):
    cfg, kw = CONFIGS[request.param]
    jp = j_init(jax.random.key(5), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    d = tmp_path_factory.mktemp(request.param)
    j_art = jexport.export_model(jp, cfg, str(d / "jax.pt"), **kw)
    t_art = texport.export_model(tp, port_config(cfg), str(d / "port.pt"), **kw)
    return request.param, str(d / "jax.pt"), str(d / "port.pt"), j_art, t_art


def test_state_dicts_equal_bit_for_bit(exported):
    _name, j_path, t_path, _ja, _ta = exported
    j_sd = torch.load(j_path, weights_only=True)["state_dict"]
    t_sd = torch.load(t_path, weights_only=True)["state_dict"]
    assert list(t_sd) == list(j_sd)
    for k in j_sd:
        assert t_sd[k].dtype == j_sd[k].dtype and t_sd[k].shape == j_sd[k].shape, k
        assert np.array_equal(t_sd[k].numpy(), j_sd[k].numpy(), equal_nan=True), k


def test_metadata_and_yaml_equal(exported):
    _name, j_path, t_path, _ja, _ta = exported
    j_art = torch.load(j_path, weights_only=True)
    t_art = torch.load(t_path, weights_only=True)
    assert {k: v for k, v in t_art.items() if k != "state_dict"} == {
        k: v for k, v in j_art.items() if k != "state_dict"}
    assert yaml.safe_load(t_art["model_yaml"]) == yaml.safe_load(j_art["model_yaml"])
    assert t_art["model_yaml"] == j_art["model_yaml"]


def test_each_loads_the_others_file(exported):
    """The port's file in JAX and JAX's file in the port give the same
    energies as each package on its own file."""
    name, j_path, t_path, _ja, _ta = exported
    data, threshold, _stress, _kind = LAYOUTS["molecule"]
    data = {**data, "mult": 1.0} if name == "nse" else data
    e = {}
    for tag, path in (("jax", j_path), ("port", t_path)):
        e["jax", tag] = JCalculator(jloader.load_model(path).as_calculator_model()).eval(data)["energy"]
        e["port", tag] = TCalculator(path, device="cpu").eval(data)["energy"]
    np.testing.assert_array_equal(e["jax", "jax"], e["jax", "port"])
    np.testing.assert_array_equal(e["port", "jax"], e["port", "port"])
    np.testing.assert_allclose(e["port", "port"], e["jax", "jax"], rtol=1e-5)


def test_exporter_externalises_coulomb_and_bakes_sae(exported):
    name, _j, t_path, _ja, t_art = exported
    outputs = yaml.safe_load(t_art["model_yaml"])["kwargs"]["outputs"]
    if name == "no_coulomb":
        assert t_art["coulomb_mode"] == "none" and "srcoulomb" not in outputs
    else:
        assert t_art["coulomb_mode"] == "sr_embedded" and t_art["needs_coulomb"]
        assert outputs["srcoulomb"]["class"] == "aimnet.modules.SRCoulomb"
        assert "lrcoulomb" not in outputs and "external_dftd3" not in outputs
    shifts = t_art["state_dict"]["outputs.atomic_shift.shifts.weight"]
    assert shifts.dtype == torch.float64
    if "sae" in CONFIGS[name][1]:
        for z, e in SAE.items():
            assert float(shifts[z, 0]) == e  # the random init's shift is zero
    loaded = tloader.load_model(t_path)
    assert loaded.aux["sae"]["atomic_shift"].dtype == np.float64


def test_invalid_metadata_leaves_no_file(tmp_path):
    """The canonical validation runs before the artifact exists: an
    inconsistent export (an SR cutoff beyond the model's) raises in both
    packages and writes nothing, and an existing file stays as it was."""
    cfg = jax_config()
    jp = j_init(jax.random.key(6), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    out = tmp_path / "bad.pt"
    bad = {"extra_metadata": {"coulomb_sr_rc": 9.0}}
    with pytest.raises(ValueError, match="coulomb_sr_rc"):
        jexport.export_model(jp, cfg, str(out), **bad)
    with pytest.raises(ValueError, match="coulomb_sr_rc"):
        texport.export_model(tp, port_config(cfg), str(out), **bad)
    assert not list(tmp_path.iterdir())
    out.write_bytes(b"keep me")
    with pytest.raises(ValueError, match="format_version"):
        texport.export_model(tp, port_config(cfg), str(out), extra_metadata={"format_version": 3})
    assert out.read_bytes() == b"keep me" and [p.name for p in tmp_path.iterdir()] == ["bad.pt"]


def test_atomic_save_keeps_mode(tmp_path):
    cfg = port_config(jax_config(coulomb=False, d3=False))
    tp = params_from_numpy(jax.tree.map(np.asarray, j_init(jax.random.key(7), jax_config(coulomb=False, d3=False))),
                           device="cpu")
    new = tmp_path / "new.pt"
    texport.export_model(tp, cfg, str(new), sae=SAE)
    assert stat.S_IMODE(os.stat(new).st_mode) == 0o600
    old = tmp_path / "old.pt"
    old.write_bytes(b"x")
    os.chmod(old, 0o644)
    texport.export_model(tp, cfg, str(old), sae=SAE)
    assert stat.S_IMODE(os.stat(old).st_mode) == 0o644
    assert [p.name for p in tmp_path.iterdir() if p.name.endswith(".tmp")] == []


def test_shift_tables_and_species(tmp_path):
    """``shift_tables`` replace a whole f64 table before the SAE is added;
    without ``implemented_species`` the species are the SAE's and no row is
    NaN; JAX's exporter agrees."""
    jcfg = jax_config(coulomb=False, d3=False)
    jp = j_init(jax.random.key(8), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    table = np.linspace(-1.0, 1.0, 64) * (1.0 + 1e-12)
    kw = {"sae": {1: -0.5}, "shift_tables": {"atomic_shift": table}}
    j_art = jexport.export_model(jp, jcfg, str(tmp_path / "j.pt"), **kw)
    t_art = texport.export_model(tp, port_config(jcfg), str(tmp_path / "t.pt"), **kw)
    shifts = t_art["state_dict"]["outputs.atomic_shift.shifts.weight"].numpy()[:, 0]
    want = table.copy()
    want[1] += -0.5
    np.testing.assert_array_equal(shifts, want)
    np.testing.assert_array_equal(shifts, j_art["state_dict"]["outputs.atomic_shift.shifts.weight"].numpy()[:, 0])
    assert t_art["implemented_species"] == j_art["implemented_species"] == [1]
    assert np.isfinite(t_art["state_dict"]["afv.weight"].numpy()).all()
