"""The port's model registry (calculators/registry.py) and Hugging Face
fetch (models/loader.py::fetch_hf_snapshot) against the JAX package's (CPU,
no network).

- The registry data is the JAX package's file byte for byte, and every name,
  alias, family and ensemble resolves as there; every digest is a SHA-256.
- ``download_model`` against a fake ``requests.get``: checksum verified,
  cache reused without a request, a corrupt cache replaced once, a
  mismatch leaving no file, ``force`` downloading again, and JAX's
  ``RuntimeError`` without ``requests``.
- ``fetch_hf_snapshot`` against a fake ``hf_hub_download``: the config is
  validated before any weights are requested, as JAX's is.
"""

import hashlib
import json
import os
import re
import sys

import pytest
import yaml

pytest.importorskip("jax")  # the card's machine has no JAX

from aimnetcentral_tpu.calculators import registry as jreg  # noqa: E402
from aimnetcentral_tpu.models import loader as jloader  # noqa: E402
from aimnetcentral_tpu_torch.calculators import registry as treg  # noqa: E402
from aimnetcentral_tpu_torch.models import loader as tloader  # noqa: E402
from test_torch_loader import jax_artifact, jax_config  # noqa: E402

REG = yaml.safe_load(open(treg._REGISTRY_FILE))
NAMES = sorted(REG["models"]) + sorted(REG["aliases"]) + ["aimnet2-wb97m-d3", "aimnet3-unobtainium"]


def test_registry_file_is_jaxs_byte_for_byte():
    assert treg._REGISTRY_FILE != jreg._REGISTRY_FILE
    assert open(treg._REGISTRY_FILE, "rb").read() == open(jreg._REGISTRY_FILE, "rb").read()


def test_every_model_has_a_digest_url_file_and_family():
    families = set(REG["families"])
    for name, entry in REG["models"].items():
        assert re.fullmatch(r"[0-9a-f]{64}", entry["sha256"]), name
        assert entry["url"].startswith("https://") and entry["file"], name
        assert entry["family"] in families, name
    for alias, target in REG["aliases"].items():
        assert target in REG["models"] and target not in REG["aliases"], alias


def _same(fn_t, fn_j, *args):
    try:
        want = fn_j(*args)
    except KeyError:
        with pytest.raises(KeyError, match="not in registry"):
            fn_t(*args)
        return
    assert fn_t(*args) == want


@pytest.mark.parametrize("name", NAMES)
def test_names_resolve_as_jax(name):
    _same(treg.resolve_name, jreg.resolve_name, name)
    _same(treg.ensemble_members, jreg.ensemble_members, name)
    assert treg.registry_family(name) == jreg.registry_family(name)


def test_listing_families_and_cache_dir(monkeypatch, tmp_path):
    assert treg.available_models() == jreg.available_models()
    assert treg.resolve_name("aimnet2")[0] == "aimnet2-wb97m-d3_0"
    assert treg.ensemble_members("aimnet2") == [f"aimnet2-wb97m-d3_{i}" for i in range(4)]
    for fam in list(REG["families"]) + ["mystery", None]:
        t, j = treg.get_family_policy(fam), jreg.get_family_policy(fam)
        assert (t.supports_charged_systems, t.posthoc_d3_params) == (j.supports_charged_systems, j.posthoc_d3_params)
    monkeypatch.setenv("AIMNET_CACHE_DIR", str(tmp_path / "c"))
    assert treg.cache_dir() == jreg.cache_dir() == str(tmp_path / "c")
    monkeypatch.delenv("AIMNET_CACHE_DIR")
    assert treg.cache_dir() == os.path.join(os.path.expanduser("~"), ".cache", "aimnet")
    path = tmp_path / "local.pt"
    path.write_bytes(b"x")
    assert treg.resolve_model(str(path)) == str(path) and treg.registry_family(str(path)) is None


# -- downloads -------------------------------------------------------------------


class _FakeResponse:
    def __init__(self, payload: bytes):
        self.payload = payload

    def raise_for_status(self):
        pass

    def iter_content(self, _size):
        yield self.payload

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.fixture()
def fake_registry(tmp_path, monkeypatch):
    payload = b"fake artifact bytes"
    entry = {"file": "demo_model.pt", "url": "https://example.invalid/demo_model.pt",
             "sha256": hashlib.sha256(payload).hexdigest(), "family": "demo"}
    monkeypatch.setattr(treg, "cache_dir", lambda: str(tmp_path))
    monkeypatch.setattr(treg, "resolve_name", lambda name: ("demo", entry))
    calls = []
    import requests

    def fake_get(url, stream=True, timeout=None):
        calls.append(url)
        return _FakeResponse(payload)

    monkeypatch.setattr(requests, "get", fake_get)
    return payload, entry, calls, tmp_path


def test_download_verifies_and_caches(fake_registry):
    payload, entry, calls, _tmp = fake_registry
    p = treg.download_model("demo")
    assert open(p, "rb").read() == payload and calls == [entry["url"]]
    assert treg.download_model("demo") == p and len(calls) == 1  # the cache, no request
    assert treg.resolve_model("demo") == p and len(calls) == 1


def test_corrupt_cache_replaced_once(fake_registry):
    payload, entry, calls, tmp_path = fake_registry
    (tmp_path / entry["file"]).write_bytes(b"corrupted!!")
    assert open(treg.download_model("demo"), "rb").read() == payload
    assert len(calls) == 1


def test_checksum_mismatch_leaves_no_file(fake_registry, monkeypatch):
    _payload, _entry, _calls, tmp_path = fake_registry
    import requests

    monkeypatch.setattr(requests, "get", lambda url, stream=True, timeout=None: _FakeResponse(b"evil"))
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        treg.download_model("demo")
    assert os.listdir(tmp_path) == []


def test_force_downloads_again(fake_registry):
    _payload, _entry, calls, _tmp = fake_registry
    treg.download_model("demo")
    treg.download_model("demo", force=True)
    assert len(calls) == 2


def test_without_requests_raises_runtime_error(fake_registry, monkeypatch):
    monkeypatch.setitem(sys.modules, "requests", None)
    with pytest.raises(RuntimeError, match="requests"):
        treg.download_model("demo")


def test_clear_model_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("AIMNET_CACHE_DIR", str(tmp_path / "cache"))
    os.makedirs(tmp_path / "cache")
    (tmp_path / "cache" / "a.pt").write_bytes(b"x")
    treg.clear_model_cache()
    assert not (tmp_path / "cache").exists()
    treg.clear_model_cache()  # nothing left: no error


# -- Hugging Face fetch ------------------------------------------------------------


class _RecordingHub:
    """Stands in for huggingface_hub.hf_hub_download and records requests."""

    def __init__(self, repo_dir):
        self.repo_dir = repo_dir
        self.calls = []

    def __call__(self, repo_id, filename, revision=None, token=None):
        self.calls.append((repo_id, filename, revision))
        path = os.path.join(self.repo_dir, filename)
        if not os.path.exists(path):
            raise FileNotFoundError(filename)
        return path


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A local snapshot: config.json and ensemble_0.safetensors of a JAX
    export."""
    import torch
    from safetensors.numpy import save_file

    d = tmp_path_factory.mktemp("hf")
    payload = torch.load(jax_artifact(d / "m.pt", jax_config()), weights_only=True)
    config = {k: v for k, v in payload.items() if k != "state_dict"}
    (d / "config.json").write_text(json.dumps(config))
    save_file({k: v.numpy() for k, v in payload["state_dict"].items()}, str(d / "ensemble_0.safetensors"))
    os.remove(d / "m.pt")
    return str(d), config


def _write_config(tmp_path, config):
    (tmp_path / "config.json").write_text(json.dumps(config))
    return str(tmp_path)


@pytest.mark.parametrize("case", ["good", "malicious_yaml", "non_mapping", "format_version",
                                  "family_fallback", "family_incomplete", "bad_member"])
def test_fetch_matches_jax(hf_dir, tmp_path, monkeypatch, case):
    """The port's fetch requests the same files in the same order as JAX's
    and refuses the same configs with the same exception type, before any
    weights are requested."""
    import huggingface_hub

    repo, config = hf_dir
    member = 0
    if case == "good":
        where = repo
    elif case == "malicious_yaml":
        where = _write_config(tmp_path, {**config, "model_yaml": "class: evil.Backdoor\nkwargs: {}\n"})
    elif case == "non_mapping":
        (tmp_path / "config.json").write_text("[1, 2]")
        where = str(tmp_path)
    elif case == "format_version":
        where = _write_config(tmp_path, {**config, "format_version": 7})
    elif case == "family_fallback":
        where = _write_config(tmp_path, {"format_version": 2, "cutoff": 5.0,
                                         "member_names": ["aimnet2-wb97m-d3_0", "aimnet2-wb97m-d3_1"]})
        member = 1
    elif case == "family_incomplete":
        where = _write_config(tmp_path, {"format_version": 2, "cutoff": 5.0})
    else:
        where, member = repo, -1
    results = {}
    for tag, loader, reg in (("jax", jloader, jreg), ("port", tloader, treg)):
        rec = _RecordingHub(where)
        monkeypatch.setattr(huggingface_hub, "hf_hub_download", rec)
        monkeypatch.setattr(reg, "download_model", lambda name, force=False: f"registry:{name}")
        try:
            out = loader.fetch_hf_snapshot("acme/aimnet2-demo", member=member, revision="abc123")
        except Exception as e:  # the outcome under test
            out = type(e)
        results[tag] = (out, rec.calls)
    assert results["port"] == results["jax"]
    out, calls = results["port"]
    files = [c[1] for c in calls]
    if case == "good":
        assert files == ["config.json", "ensemble_0.safetensors"] and out == repo
        assert all(c[2] == "abc123" for c in calls)
    elif case == "family_fallback":
        assert out == "registry:aimnet2-wb97m-d3_1" and files == ["config.json"]
    else:
        assert isinstance(out, type) and issubclass(out, Exception)
        assert "ensemble_0.safetensors" not in files
        if case == "bad_member":
            assert files == []


def test_load_model_fetches_a_repo_id(hf_dir, monkeypatch):
    """``load_model`` on a repo id fetches the snapshot and loads it."""
    import huggingface_hub

    repo, config = hf_dir
    monkeypatch.setattr(huggingface_hub, "hf_hub_download", _RecordingHub(repo))
    loaded = tloader.load_model("acme/aimnet2-demo")
    assert loaded.metadata["coulomb_mode"] == config["coulomb_mode"]
    assert [n for n, _ in loaded.cfg.outputs][-2:] == ["external_coulomb", "external_dftd3"]
