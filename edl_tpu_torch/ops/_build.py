"""Build the package's CUDA sources into shared libraries and load them.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) from the
sources under ``edl_tpu_torch/csrc/`` into ``build/edl_tpu_torch/`` at the
repository root, at first use, and loaded with ``ctypes``: one ``nvcc -c``
per source, all started together, then one link.  The sources expose a
plain C interface, so no PyTorch header is compiled and a build takes
seconds.  A build is reused while its sources, the headers beside them
and the flags are unchanged (a stamp file holds their hash).  A failed
build raises with nvcc's output in the message: there is no fallback.
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
              "-Xcompiler", "-fPIC"]

# library name -> its sources under csrc/ (each includes headers from csrc/)
LIBRARIES = {"attn": ["attention.cu", "attention_sm90.cu", "attention_wide.cu"]}

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
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return (sources, BUILD_DIR / f"lib{name}.so",
            BUILD_DIR / f"lib{name}.stamp", h.hexdigest())


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _start(name: str, extra_flags: list[str], force: bool):
    """Start one ``nvcc -c`` per source of ``name`` unless an up-to-date
    build exists (or ``force``); returns the compile jobs and what the link
    needs."""
    sources, lib, stamp, digest = _paths(name)
    if not force and lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [BUILD_DIR / f"{name}.{src.stem}.{os.getpid()}.o" for src in sources]
    jobs = [_run([_nvcc(), *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj), str(src)])
            for src, obj in zip(sources, objs)]
    return jobs, objs, lib, stamp, digest


def build(names=None, extra_flags: list[str] | None = None,
          force: bool = False) -> dict[str, str]:
    """Build the named libraries (default: all): every source of every
    library compiles at once, then each library links.  Returns each
    library's compiler output (empty when the build was reused; ``force``
    rebuilds).  ``extra_flags`` (e.g. ``["-Xptxas", "-v"]``) go to the
    compiles and do not enter the stamp."""
    names = list(LIBRARIES) if names is None else list(names)
    running = {n: _start(n, list(extra_flags or []), force) for n in names}
    logs: dict[str, str] = {}
    for name, job in running.items():
        if job is None:
            logs[name] = ""
            continue
        jobs, objs, lib, stamp, digest = job
        outs, failed = [], []
        for proc in jobs:
            out, _ = proc.communicate()
            outs.append(out)
            if proc.returncode != 0:
                failed.append(proc.returncode)
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        if not failed:
            link = _run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
                         *(str(o) for o in objs)])
            out, _ = link.communicate()
            outs.append(out)
            if link.returncode != 0:
                failed.append(link.returncode)
        for obj in objs:
            obj.unlink(missing_ok=True)
        log = "\n".join(outs)
        if failed:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed building lib{name}.so (exit {failed[0]}):\n{log}")
        os.replace(tmp, lib)
        stamp.write_text(digest)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        _loaded[name] = lib
    return lib
