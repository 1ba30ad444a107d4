#!/usr/bin/env python3
"""Time the attention kernels on one NVIDIA card, against an earlier version
of them in the same process.

    git archive <commit> edl_tpu_torch/csrc | tar -x -C build/parent
    python3 bench_attention.py --parent build/parent/edl_tpu_torch/csrc

``--parent`` names a directory of an earlier tree's CUDA sources (every
``.cu`` there is compiled against the headers beside it, and linked into
``build/edl_tpu_torch/libattn_parent.so``); its entry points' arguments are
read from its own ``attention.cu``, so a parent whose dQ entry points
report the kernels they launched (an ``int*`` before the stream: above D =
256 the standalone delta, then the mma.sync dQ) is timed as its dQ ran,
both kernels.  To time a variant of the current sources, copy ``csrc``
under ``build/``, edit the copy and pass it as ``--parent``.

At the flagship shape ``[8, 1024, 6, 128]`` bf16, and at ``[8, 1024, 6,
64]``, ``[8, 1024, 4, 192]``, ``[8, 1024, 4, 256]``, the ``d256`` phase's
``[8, 1024, 3, 256]`` of ``chip_smoke.py``, ``[8, 1024, 2, 320]``, the
``d384`` phase's ``[8, 1024, 2, 384]``, ``[4, 1024, 2, 512]``, ``[4, 1024,
2, 640]``, the ``d768`` phase's ``[8, 1024, 1, 768]``, ``[4, 1024, 2,
1024]``, ``[4, 1024, 2, 448]`` and ``[1, 1024, 1, 2112]`` (the last eight
run the kernels for head dims above 256: the Hopper forward whose
consumers split the output columns, above 512 on chunks of the columns,
with a run-time plan above 768; the Hopper dQ with delta folded in on a
thread block cluster that splits D; the Hopper dK/dV whose blocks split
the output columns up to 384, the cluster one above; above 2048, past the
largest portable cluster, the ``mma.sync`` dQ and dK/dV), the script times the earlier and the current
forward, dQ (with delta) and dK/dV, causal (the splash entry points) and
non-causal (the flash ones), in turns: earlier, current, current, earlier.
It checks both against the plain PyTorch versions first. Every time is a
device time (``torch.profiler``, summed kernel time per call); each row
carries its bound (the larger of bytes over 3.35 TB/s and operations over
their type's peak rate, the larger over the types), the plain PyTorch
version's time (f32, from the same bf16 inputs) and the library time of
one PyTorch call for the same function (``scaled_dot_product_attention``,
its whole backward for dQ and dK/dV), with the SDPA backend that ran, read
from its longest kernel's name.
Without ``--parent`` only the current kernels are timed.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per measurement.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import types
from pathlib import Path

import chip_smoke as cs

FLAGSHIP = (8, 1024, 6, 128)
EXTRA = ((8, 1024, 6, 64), (8, 1024, 4, 192), (8, 1024, 4, 256), cs.D256_SHAPE,
         (8, 1024, 2, 320), cs.D384_SHAPE, (4, 1024, 2, 512), (4, 1024, 2, 640),
         cs.D768_SHAPE, (4, 1024, 2, 1024), (4, 1024, 2, 448), (1, 1024, 1, 2112))
REPS = 20
KINDS = ("fwd", "dq", "dkdv")
WORK = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkdv": "flash_bwd_dkdv"}  # cs._attention_work


def build_parent(csrc: str) -> ctypes.CDLL:
    from edl_tpu_torch.ops import _build
    src = Path(csrc)
    lib = _build.BUILD_DIR / "libattn_parent.so"
    _build.build_sources(sorted(src.glob("*.cu")), lib)
    return _build.bind(ctypes.CDLL(str(lib)), (src / "attention.cu").read_text())


def launcher(lib, kind: str, causal: bool):
    """A call of ``lib``'s forward, dQ or dK/dV entry point: the splash one
    for causal, the flash one otherwise, with the wrappers' argument
    set-up.  dQ returns ``(dq, delta)``; a library whose dQ entry point
    takes an ``int*`` count of the kernels it launched before the stream
    gets one."""
    from edl_tpu_torch.ops import attention as A
    entry = ("edl_attn_" if causal else "edl_flash_") + {"fwd": "fwd", "dq": "bwd_dq",
                                                         "dkdv": "bwd_dkdv"}[kind]
    mode = None if causal else False
    if kind == "fwd":
        return lambda q, k, v, scale: A._run_fwd(entry, q, k, v, scale, mode, lib=lib)
    if kind == "dkdv":
        return lambda q, k, v, do, lse, delta, scale: A._run_dkdv(
            entry, q, k, v, do, lse, delta, scale, mode, lib=lib)
    fn = getattr(lib, entry)
    if len(fn.argtypes) == len(getattr(A._kernels(), entry).argtypes):
        return lambda q, k, v, o, do, lse, scale: A._run_dq(
            entry, q, k, v, o, do, lse, scale, mode, lib=lib)

    # the entry point with the count passed before the stream
    counted = types.SimpleNamespace(**{
        entry: lambda *a: fn(*a[:-1], ctypes.byref(ctypes.c_int(0)), a[-1])})
    return lambda q, k, v, o, do, lse, scale: A._run_dq(
        entry, q, k, v, o, do, lse, scale, mode, lib=counted)


def inputs(shape, seed):
    import torch

    from edl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (cs._randn(shape, g) for _ in range(4))
    scale = shape[3] ** -0.5
    return q, k, v, do, scale, A


def sdpa_backend(fn) -> str:
    """The SDPA backend that ``fn()`` ran, from the name of its longest
    kernel, with that name."""
    for _ in range(5):   # a profile that recorded no kernel is taken again
        rows = cs.kernel_times(fn, reps=REPS)
        if rows:
            break
    else:
        raise RuntimeError("the profiler recorded no kernel in 5 tries")
    name = rows[0][1]
    if "cudnn" in name:
        kind = "cudnn"
    elif "flash" in name:
        kind = "flash"
    elif "fmha" in name or "cutlass" in name or "mem_eff" in name:
        kind = "efficient"
    else:
        kind = "math"
    return f"{kind} ({name[:80]})"


def library_ms(q, k, v, do, causal) -> tuple[tuple[float, int], tuple[float, int], str, str]:
    """SDPA's forward and whole-backward device ms (each with its profile
    retakes, as ``cs.device_ms`` gives them), and the backend of each."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    yt = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    def bwd():
        return torch.autograd.grad(yt, (qt, kt, vt), dot, retain_graph=True)

    return (cs.device_ms(fwd, reps=REPS), cs.device_ms(bwd, reps=REPS),
            sdpa_backend(fwd), sdpa_backend(bwd))


def measure(shape, causal, seed, parent):
    """Rows for the forward, dQ and dK/dV at one shape and mask."""
    import torch

    q, k, v, do, scale, A = inputs(shape, seed)
    B, L, H, D = shape
    o, lse = A.flash_fwd_plain(q, k, v, scale, causal)
    delta = A.attention_bwd_delta_plain(o, do)
    work = cs._attention_work(B, L, L, H, D, causal)
    lib_fwd, lib_bwd, be_fwd, be_bwd = library_ms(q, k, v, do, causal)
    args = {"fwd": (q, k, v, scale), "dq": (q, k, v, o, do, lse, scale),
            "dkdv": (q, k, v, do, lse, delta, scale)}
    plain = {"fwd": lambda: A.flash_fwd_plain(q, k, v, scale, causal),
             "dq": lambda: A.flash_bwd_dq_plain(q, k, v, o, do, lse, scale, causal),
             "dkdv": lambda: A.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale, causal)}
    library = {"fwd": (f"sdpa forward, {be_fwd}", lib_fwd),
               "dq": (f"sdpa whole backward, {be_bwd}", lib_bwd),
               "dkdv": (f"sdpa whole backward, {be_bwd}", lib_bwd)}
    rows = []
    for kind in KINDS:
        want = plain[kind]()
        new = launcher(A._kernels(), kind, causal)
        old = launcher(parent, kind, causal) if parent is not None else None
        errs = {"new": max(cs.rel_err(a, b) for a, b in zip(new(*args[kind]), want))}
        if old is not None:
            errs["earlier"] = max(cs.rel_err(a, b) for a, b in zip(old(*args[kind]), want))
        torch.cuda.synchronize()
        if max(errs.values()) > cs.REL_TOL:
            raise AssertionError(f"{kind} at {shape} causal={causal}: rel errs {errs}")
        times = {}
        lib_ms, retakes = library[kind][1]
        order = ("earlier", "new", "new", "earlier") if old is not None else ("new",)
        for who in order:
            fn = new if who == "new" else old
            ms, n = cs.device_ms(lambda: fn(*args[kind]), reps=REPS)
            times.setdefault(who, []).append(ms)
            retakes += n
        plain_ms, n = cs.device_ms(plain[kind], reps=REPS)
        retakes += n
        bound, by = cs._bound(*work[WORK[kind]])
        rows.append({"kernel": kind, "shape": list(shape), "causal": causal,
                     "ms": times["new"], "earlier_ms": times.get("earlier"),
                     "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                     "library": library[kind][0], "rel_err": errs,
                     "profile_retakes": retakes})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default=None,
                   help="a directory of earlier CUDA sources (csrc) to time against")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device is available", file=sys.stderr)
        return 1
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi_name_and_power_limit(), flush=True)
    parent = build_parent(args.parent) if args.parent else None
    from edl_tpu_torch.ops import attention as A
    A._kernels()   # built before any profile: profiles right after a build lost records
    for j, shape in enumerate((FLAGSHIP,) + EXTRA):
        for i, causal in enumerate((True, False)):
            for row in measure(shape, causal, seed=40 + 2 * j + i, parent=parent):
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
