"""The kernels' build (aimnetcentral_tpu_torch/kernels/build.py) with a
stand-in for nvcc: each library's nvcc log is kept beside it, and a later
process reads the logs of what is already built without compiling again."""

import sys

import pytest

from aimnetcentral_tpu_torch.kernels import build

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = args[-1]
with open(out, "w") as f:
    f.write("library")
with open({calls!r}, "a") as f:
    f.write(src + "\\n")
print("ptxas info    : Compiling entry function 'kernel' for 'sm_90a'")
print("ptxas info    : Used 64 registers, 0 bytes spill stores, 0 bytes spill loads")
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    return calls


def test_build_keeps_each_log_beside_its_library(fake_build):
    libs = build.KernelLibraries()
    libs.build()
    assert fake_build.read_text().count("\n") == len(build.SOURCES)
    for name in build.SOURCES:
        assert build._lib_path(name).exists()
        assert build._log_path(name).read_text() == libs.logs[name]
        assert "Used 64 registers" in libs.logs[name]
    assert not list(build.BUILD_DIR.glob("*.tmp")) and not list(build.BUILD_DIR.glob("*.tmp.log"))


def test_a_built_library_is_read_not_compiled_again(fake_build):
    build.KernelLibraries().build()
    again = build.KernelLibraries()
    again.build()
    assert fake_build.read_text().count("\n") == len(build.SOURCES)  # no second nvcc
    assert set(again.logs) == set(build.SOURCES)
    # a library without its log is built again, so its log is never missing
    build._log_path("conv_fwd").unlink()
    third = build.KernelLibraries()
    third.build()
    assert fake_build.read_text().count("\n") == len(build.SOURCES) + 1
    assert "Used 64 registers" in build._log_path("conv_fwd").read_text()
