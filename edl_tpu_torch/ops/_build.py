"""Build the package's CUDA sources into shared libraries and load them.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) from the
sources under ``edl_tpu_torch/csrc/`` into ``build/edl_tpu_torch/`` at the
repository root, at first use, and loaded with ``ctypes``.  The sources
expose a plain C interface, so no PyTorch header is compiled and a build
takes seconds.  A build is reused while its sources and flags are
unchanged (a stamp file holds their hash).  A failed build raises with
nvcc's output in the message: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "edl_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# library name -> its sources under csrc/
LIBRARIES = {"attn": ["attention.cu"]}

_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc failed, or is missing."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME/bin; "
                           "the CUDA kernels are built on a machine with the "
                           "CUDA toolkit")


def _paths(name: str) -> tuple[list[Path], Path, Path, str]:
    sources = [CSRC / s for s in LIBRARIES[name]]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    return (sources, BUILD_DIR / f"lib{name}.so",
            BUILD_DIR / f"lib{name}.stamp", h.hexdigest())


def _start(name: str, extra_flags: list[str]) -> tuple[subprocess.Popen, Path, Path, str] | None:
    """Start nvcc for ``name`` unless an up-to-date build exists."""
    sources, lib, stamp, digest = _paths(name)
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           *(str(s) for s in sources)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, stamp, digest


def build(names=None, extra_flags: list[str] | None = None) -> dict[str, str]:
    """Build the named libraries (default: all), one nvcc per library, all
    started together.  Returns each library's compiler output (empty when
    the build was reused).  ``extra_flags`` (e.g. ``["-Xptxas", "-v"]``)
    do not enter the stamp."""
    names = list(LIBRARIES) if names is None else list(names)
    running = {n: _start(n, list(extra_flags or [])) for n in names}
    logs: dict[str, str] = {}
    for name, job in running.items():
        if job is None:
            logs[name] = ""
            continue
        proc, tmp, stamp, digest = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed building lib{name}.so (exit {proc.returncode}):\n{out}")
        os.replace(tmp, BUILD_DIR / f"lib{name}.so")
        stamp.write_text(digest)
        logs[name] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        _loaded[name] = lib
    return lib
