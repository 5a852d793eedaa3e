"""Build the CUDA kernels of ``csrc/`` at first use and bind them with ctypes.

Each source is compiled by ``nvcc`` on its own into a shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a``); all sources
compile in parallel.  Libraries are named by a hash of their source, so a
changed source is never served a stale build.  The build directory
(``aimnetcentral_tpu_torch/_build/``) is listed in .gitignore.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("conv_fwd", "conv_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


class KernelLibraries:
    """The process's loaded kernel libraries and their build logs."""

    def __init__(self) -> None:
        self._libs: dict[str, ctypes.CDLL] = {}
        self.logs: dict[str, str] = {}  # nvcc output (ptxas -v: registers, smem, spills)

    def build(self) -> None:
        """Compile every missing library, one nvcc per source, all at once."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
                out,
            )
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            self.logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))

    def get(self, name: str) -> ctypes.CDLL:
        lib = self._libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                self.build()
            lib = ctypes.CDLL(str(_lib_path(name)))
            self._libs[name] = lib
        return lib


LIBRARIES = KernelLibraries()
