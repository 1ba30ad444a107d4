#!/usr/bin/env python3
"""Time the attention forward and dK/dV kernels on one NVIDIA card, against
an earlier version of them in the same process.

    python3 bench_attention.py --parent build/parent_attention.cu

``--parent`` names a copy of an earlier ``edl_tpu_torch/csrc/attention.cu``
(one self-contained source with the same C entry points); it is built by
nvcc into ``build/edl_tpu_torch/libattn_parent.so``.  At the flagship shape
``[8, 1024, 6, 128]`` bf16 the script times the earlier and the current
forward and dK/dV, causal (the splash entry points) and non-causal (the
flash ones), in turns: earlier, current, current, earlier.  It checks both
against the plain PyTorch versions first, and the delta kernel
(``rowsum(dO * O)``) the same way.  Then it times the current forward and
dK/dV at ``[8, 1024, 6, 64]`` and ``[8, 1024, 4, 256]``, causal and not.
Every time is a device time (``torch.profiler``, summed kernel time per
call); each row carries its bound (the larger of bytes over 3.35 TB/s and
operations over 989 TFLOP/s) and the library time of one PyTorch call for
the same function (``scaled_dot_product_attention``, its whole backward
for dK/dV).  Without ``--parent`` only the current kernels are timed.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per measurement.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import chip_smoke as cs

FLAGSHIP = (8, 1024, 6, 128)
EXTRA = ((8, 1024, 6, 64), (8, 1024, 4, 256))
REPS = 20


def build_parent(source: str) -> ctypes.CDLL:
    from edl_tpu_torch.ops import _build
    from edl_tpu_torch.ops import attention as A
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "libattn_parent.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), source]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{done.stdout}{done.stderr}")
    cdll = ctypes.CDLL(str(lib))
    for name, argtypes in A._SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return cdll


def launcher(lib, kind: str, causal: bool):
    """A call of ``lib``'s forward, delta or dK/dV entry point: the splash
    one for causal, the flash one otherwise; the wrappers' argument set-up."""
    import torch

    from edl_tpu_torch.ops import attention as A
    if kind == "delta":
        def delta(o, do):
            B, L, H, D = o.shape
            out = torch.empty(B, H, L, dtype=torch.float32, device=o.device)
            A._raise_on(lib.edl_attn_bwd_delta(o.data_ptr(), do.data_ptr(), out.data_ptr(),
                                               A._strides(o, do), B, H, L, D, A._stream(o)),
                        "edl_attn_bwd_delta")
            return (out,)
        return delta
    entry = ("edl_attn_" if causal else "edl_flash_") + ("fwd" if kind == "fwd" else "bwd_dkdv")
    fn = getattr(lib, entry)
    mode = None if causal else False

    def fwd(q, k, v, scale):
        dims, (q, k, v) = A._operands(q, k, v)
        B, H, Lq, _, D = dims
        o = torch.empty(B, Lq, H, D, dtype=q.dtype, device=q.device)
        lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
        A._raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                       A._strides(q, k, v, o), *A._sizes(dims, mode), float(scale), A._stream(q)),
                    entry)
        return o, lse

    def dkdv(q, k, v, do, lse, delta, scale):
        dims, (q, k, v, do) = A._operands(q, k, v, do)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        A._raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                       delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       A._strides(q, k, v, do, dk, dv), *A._sizes(dims, mode), float(scale),
                       A._stream(q)), entry)
        return dk, dv

    return fwd if kind == "fwd" else dkdv


def inputs(shape, seed):
    import torch

    from edl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (cs._randn(shape, g) for _ in range(4))
    scale = shape[3] ** -0.5
    return q, k, v, do, scale, A


def library_ms(q, k, v, do, causal) -> tuple[float, float]:
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    fwd = cs.device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), reps=REPS)
    yt = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    bwd = cs.device_ms(lambda: torch.autograd.grad(yt, (qt, kt, vt), dot, retain_graph=True), reps=REPS)
    return fwd, bwd


def measure(shape, causal, seed, parent):
    """Rows for the forward and dK/dV at one shape and mask."""
    import torch

    q, k, v, do, scale, A = inputs(shape, seed)
    B, L, H, D = shape
    o, lse = A.flash_fwd_plain(q, k, v, scale, causal)
    delta = A.attention_bwd_delta_plain(o, do)
    work = cs._attention_work(B, L, L, H, D, causal)
    lib_fwd, lib_bwd = library_ms(q, k, v, do, causal)
    rows = []
    kinds = [("fwd", (q, k, v, scale), lambda: A.flash_fwd_plain(q, k, v, scale, causal)),
             ("dkdv", (q, k, v, do, lse, delta, scale),
              lambda: A.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale, causal))]
    if parent is not None and causal:
        kinds.append(("delta", (o, do), lambda: (delta,)))
    for kind, args, plain in kinds:
        want = plain()
        new = launcher(A._kernels(), kind, causal)
        old = launcher(parent, kind, causal) if parent is not None else None
        errs = {"new": max(cs.rel_err(a, b) for a, b in zip(new(*args), want))}
        if old is not None:
            errs["earlier"] = max(cs.rel_err(a, b) for a, b in zip(old(*args), want))
        torch.cuda.synchronize()
        if max(errs.values()) > cs.REL_TOL:
            raise AssertionError(f"{kind} at {shape} causal={causal}: rel errs {errs}")
        times = {}
        order = ("earlier", "new", "new", "earlier") if old is not None else ("new",)
        for who in order:
            fn = new if who == "new" else old
            times.setdefault(who, []).append(cs.device_ms(lambda: fn(*args), reps=REPS))
        bound, by = cs._bound(*work[{"fwd": "flash_fwd", "dkdv": "flash_bwd_dkdv",
                                     "delta": "attention_bwd_delta"}[kind]])
        library = {"fwd": ("sdpa forward", lib_fwd), "dkdv": ("sdpa whole backward", lib_bwd),
                   "delta": (None, None)}[kind]
        rows.append({"kernel": kind, "shape": list(shape), "causal": causal,
                     "ms": times["new"], "earlier_ms": times.get("earlier"),
                     "bound_ms": bound, "bound_by": by, "library_ms": library[1],
                     "library": library[0], "rel_err": errs})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default=None, help="an earlier attention.cu to time against")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device is available", file=sys.stderr)
        return 1
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi_name_and_power_limit(), flush=True)
    parent = build_parent(args.parent) if args.parent else None
    for i, causal in enumerate((True, False)):
        for row in measure(FLAGSHIP, causal, seed=40 + i, parent=parent):
            print(json.dumps(row), flush=True)
    for j, shape in enumerate(EXTRA):
        for i, causal in enumerate((True, False)):
            for row in measure(shape, causal, seed=50 + 2 * j + i, parent=None):
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
