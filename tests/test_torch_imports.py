"""The port imports neither JAX nor the JAX package: every module of
``aimnetcentral_tpu_torch`` (dynamics, the indexed layout's neighbor
builders, the integrations, training and the CLI included), ``chip_smoke.py``,
``tests/torch_fakes.py``, ``tests/torch_spatial_worker.py`` (the spatial tests'
ranks), ``tests/torch_jpt_helpers.py`` (the legacy archives) and
``tools/validate_torch.py`` import in a fresh
interpreter where both are blocked.  scipy is imported inside the kd-tree build only, never
when a module is imported."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None  # any import of jax, or of a jax submodule, raises
sys.modules["aimnetcentral_tpu"] = None
import aimnetcentral_tpu_torch
names = [m.name for m in pkgutil.walk_packages(aimnetcentral_tpu_torch.__path__, "aimnetcentral_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "tests")
import torch_fakes
import torch_spatial_worker  # what the spatial tests' spawned ranks import
import torch_jpt_helpers  # chip_smoke.py's legacy archives
spec = importlib.util.spec_from_file_location("validate_torch", "tools/validate_torch.py")
validate_torch = importlib.util.module_from_spec(spec)
spec.loader.exec_module(validate_torch)
validate_torch.validation_model()
assert not any(k == "jax" or k.startswith(("jax.", "aimnetcentral_tpu.")) for k in sys.modules if sys.modules[k])
assert not any(k == "scipy" or k.startswith("scipy.") for k in sys.modules)
print(" ".join(names))
"""


def test_port_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for must in ("aimnetcentral_tpu_torch.dynamics.md", "aimnetcentral_tpu_torch.dynamics.optimize",
                 "aimnetcentral_tpu_torch.dynamics.trajectory", "aimnetcentral_tpu_torch.calculators.calculator",
                 "aimnetcentral_tpu_torch.kernels.pair_sweep", "aimnetcentral_tpu_torch.models.engine_binned",
                 "aimnetcentral_tpu_torch.ops.neighbors", "aimnetcentral_tpu_torch.ops.cell_list",
                 "aimnetcentral_tpu_torch.builders",
                 "aimnetcentral_tpu_torch.models.lr", "aimnetcentral_tpu_torch.models.loader",
                 "aimnetcentral_tpu_torch.models.convert", "aimnetcentral_tpu_torch.models.convert_v1",
                 "aimnetcentral_tpu_torch.models.validation",
                 "aimnetcentral_tpu_torch.calculators.registry", "aimnetcentral_tpu_torch.train.export",
                 "aimnetcentral_tpu_torch.config", "aimnetcentral_tpu_torch.io",
                 "aimnetcentral_tpu_torch.dynamics.vibrations", "aimnetcentral_tpu_torch.dynamics.saddle",
                 "aimnetcentral_tpu_torch.dynamics.neb", "aimnetcentral_tpu_torch.models.ewald",
                 "aimnetcentral_tpu_torch.models.pme", "aimnetcentral_tpu_torch.models.ensemble_fused",
                 "aimnetcentral_tpu_torch.calculators.ensemble",
                 "aimnetcentral_tpu_torch.calculators.ase_adapter",
                 "aimnetcentral_tpu_torch.calculators.torchsim_adapter",
                 "aimnetcentral_tpu_torch.validation", "aimnetcentral_tpu_torch.validation.observables",
                 "aimnetcentral_tpu_torch.cli", "aimnetcentral_tpu_torch.data",
                 "aimnetcentral_tpu_torch.data.sgdataset", "aimnetcentral_tpu_torch.train.loss",
                 "aimnetcentral_tpu_torch.train.metrics", "aimnetcentral_tpu_torch.train.sae",
                 "aimnetcentral_tpu_torch.train.trackers", "aimnetcentral_tpu_torch.train.step",
                 "aimnetcentral_tpu_torch.train.trainer", "aimnetcentral_tpu_torch.parallel",
                 "aimnetcentral_tpu_torch.parallel.mesh", "aimnetcentral_tpu_torch.parallel.collectives",
                 "aimnetcentral_tpu_torch.parallel.spatial"):
        assert must in names
