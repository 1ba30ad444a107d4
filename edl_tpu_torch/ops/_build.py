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
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "edl_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# library name -> its sources under csrc/ (each includes headers from csrc/)
LIBRARIES = {"attn": ["attention.cu", "attention_sm90.cu", "attention_wide_sm90.cu",
                      "attention_chunk_sm90.cu", "attention_bwd_cluster_sm90.cu",
                      "attention_wide.cu"]}

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


def _start(sources: list[Path], lib: Path, extra_flags: list[str]):
    """Start one ``nvcc -c`` per source of ``lib``; returns what
    :func:`_finish` needs."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [BUILD_DIR / f"{lib.stem}.{src.stem}.{os.getpid()}.o" for src in sources]
    jobs = [_run([_nvcc(), *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj), str(src)])
            for src, obj in zip(sources, objs)]
    return jobs, objs, lib


def _finish(jobs, objs, lib: Path) -> str:
    """Wait for the compiles, link ``lib`` and return the compiler output;
    raise :class:`KernelBuildError` if a step failed."""
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
        raise KernelBuildError(f"nvcc failed building {lib.name} (exit {failed[0]}):\n{log}")
    os.replace(tmp, lib)
    return log


def build(names=None, extra_flags: list[str] | None = None,
          force: bool = False) -> dict[str, str]:
    """Build the named libraries (default: all): every source of every
    library compiles at once, then each library links.  Returns each
    library's compiler output (empty when the build was reused; ``force``
    rebuilds).  ``extra_flags`` (e.g. ``["-Xptxas", "-v"]``) go to the
    compiles and do not enter the stamp."""
    names = list(LIBRARIES) if names is None else list(names)
    running = {}
    for name in names:
        sources, lib, stamp, digest = _paths(name)
        if not force and lib.exists() and stamp.exists() and stamp.read_text() == digest:
            continue
        running[name] = (_start(sources, lib, list(extra_flags or [])), stamp, digest)
    logs = {name: "" for name in names}
    for name, (job, stamp, digest) in running.items():
        logs[name] = _finish(*job)
        stamp.write_text(digest)
    return logs


def build_sources(sources: list[Path], lib: Path) -> str:
    """Compile ``sources`` (each with the headers beside it), all at once,
    and link them into ``lib``, e.g. an earlier tree's ``csrc`` to time
    against; no stamp, always rebuilt.  Returns the compiler output."""
    return _finish(*_start(list(sources), lib, []))


_KINDS = {"float": "F", "int": "I"}
_CTYPES = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}


def entry_points(source: str) -> dict[str, list[str]]:
    """The functions of the ``extern "C"`` block of a CUDA source, each as
    its parameter kinds in order: ``"P"`` for a pointer, ``"I"`` for an
    ``int``, ``"F"`` for a ``float``; any other parameter type raises."""
    body = source[source.index('extern "C" {'):]
    out: dict[str, list[str]] = {}
    for name, params in re.findall(r"^int\s+(\w+)\s*\(([^)]*)\)\s*\{", body, re.M):
        kinds = []
        for param in (" ".join(p.split()) for p in params.split(",")):
            if "*" in param:
                kinds.append("P")
            elif param.split()[0] in _KINDS:
                kinds.append(_KINDS[param.split()[0]])
            else:
                raise ValueError(f"{name}: parameter {param!r} has no ctypes kind")
        out[name] = kinds
    return out


def bind(lib, source: str):
    """Declare the entry points of ``lib`` as the ``extern "C"`` block of
    ``source`` (the CUDA source text it was built from) declares them (see
    :func:`entry_points`); each returns an ``int``.  Returns ``lib``."""
    for name, kinds in entry_points(source).items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[k] for k in kinds]
        fn.restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        _loaded[name] = lib
    return lib
