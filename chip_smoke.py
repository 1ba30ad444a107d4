#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py                 # every phase, as a check runs it
    python3 chip_smoke.py --phases build,kernels,flash
    python3 chip_smoke.py --phases build,kernels,d256
    python3 chip_smoke.py --phases build,kernels,d384
    python3 chip_smoke.py --phases build,kernels,d768
    python3 chip_smoke.py --phases build,elastic
    python3 chip_smoke.py --phases build,serve

Phases, in order; each prints its numbers on a line of its own, and any
failure exits non-zero:

1. ``build``: compile the CUDA kernels from ``edl_tpu_torch/csrc`` with nvcc,
   one process per source, all at once (every instantiation: the Hopper
   forward, dQ and dK/dV at 4 head dims each, causal and not, the Hopper
   forward whose consumers split the output columns at D = 320, 384, 448,
   512 and the one that does so on chunks of the columns above 512, the
   Hopper dK/dV whose blocks split the output columns at D = 320, 384,
   the Hopper dQ and dK/dV on thread block clusters that split
   D, at 3 and 4 column boxes a block, and the mma.sync dQ and dK/dV past
   the largest cluster), and print each one's registers and spills, and
   the cluster kernels' shared memory; the cluster kernels must neither
   spill nor carry a ptxas C75xx note.
2. ``kernels``: each kernel against its plain PyTorch version (f32 from the
   same bf16 inputs; dQ's two outputs, dq and delta, both) at the flagship
   shape and at ragged, cross-length (causal ``Lq < Lk``: keys that no
   query sees must get exactly zero gradients),
   wide-head (D = 192 to 2112: the cluster kernels from 320 on, with 2 to
   8 blocks a cluster, and the mma.sync backward at 2112), many-head (B *
   H > 65,535, at D = 64 and 256) and transposed-layout ones (D = 128, 192,
   256, 384, 768); which forward, dQ and dK/dV kernel each head dim runs
   (from the profile); f32 causal cross-length
   attention on the card (the top-left function, through dense); and
   device times (``torch.profiler``) of the kernel, of its plain version
   and of one PyTorch library call as a yardstick only, and the least time
   the card could take (the bound), at the flagship shape, at the ``d256``
   phase's ``[8, 1024, 3, 256]``, at the ``d384`` phase's ``[8, 1024,
   2, 384]`` and at the ``d768`` phase's ``[8, 1024, 1, 768]``.
3. ``parity``: one training step of small bf16 configs on the card (with
   the kernels) and on the CPU (plain path) from the same weights: the
   splash path at head dims 128, 192, 256, 384 and 768, and the flash path
   with grouped-query attention at head dims 64 and 256.
4. ``flagship``: the 124M-parameter LM at batch 8 x seq 1024 with the fused
   cross-entropy, through ``edl_tpu_torch.train_lm``'s trainer: 2 warm-up
   steps and 10 timed steps on a fixed batch; tokens/s, MFU and peak memory;
   the splash kernels' launch counters (forward, dQ, dK/dV) must equal 12
   per step each, and every other attention kernel's 0; the profile of two
   more steps must show this repo's attention kernels 36 times a step.
5. ``flash``: the same run with ``--attention flash``: the flash kernels
   launch 12 times per step each and every other attention kernel none,
   the loss falls, and the first loss equals the splash path's.
6. ``d256``: the flagship's widths and depth with ``--heads 3``, so head
   dim 256 (the Gemma family's): the same checks, and the profile must
   show the dK/dV kernel whose consumers split dK and dV 12 times a step.
7. ``d384``: the same with ``--heads 2``, head dim 384: the launch
   counters show forward, dQ and dK/dV 12 times a step each, and the
   profile the Hopper forward whose consumers split the output columns,
   the cluster dQ and the Hopper dK/dV whose blocks split the output
   columns 12 times a step each (36 attention kernels), and no other.
8. ``d768``: the same with ``--heads 1``, head dim 768: the profile shows
   the Hopper forward on chunks of the output columns, the cluster dQ and
   the cluster dK/dV 12 times a step each, and no other attention
   kernel.
9. ``resume``: save at an epoch's end, drop the trainer, restore a new one
   with ``restore_or_create`` and check that step, epoch and the next loss
   continue the uninterrupted run.
10. ``elastic``: the distributed trainer.  (1) An NCCL process group of
   one: 3 flagship steps through the gradient all-reduce give parameters
   and losses equal to the bit to 3 steps without a group, the splash
   kernels launch 12 times a step each, and the profile of a step shows
   the NCCL all-reduce kernel(s), their ms and the step's device time;
   tokens/s with and without the group.  (2) ``python -m
   edl_tpu_torch.train_lm`` (depth 2) under a launcher-shaped env with no
   store, 1 epoch then 2: the second resumes at epoch 1 in a world of 1,
   and neither imports ``msgpack``.  (3) A 2-rank gloo world on the CPU
   (2 layers, width 128) saves an epoch; the card restores it at world 1
   under ``EDL_TPU_LR_RESCALE=1``: epoch history [2, 1], LR scale 0.5,
   and the next loss within the parity phase's bf16 tolerance of the same
   continuation on the CPU.
11. ``serve``: generation and serving at the flagship's full width (12 x 768,
   6 heads x 128, MLP 3072, vocab 32,000, max_len 1024, seed-0 weights,
   bf16).  (a) ``generate`` greedy on [8, 128] prompts, 64 new tokens; the
   decode path's logits, teacher-forced on the emitted tokens, within
   ``SERVE_MARGIN / 2`` of the full-prefix dense forward's.  (b) ``python -m
   edl_tpu_torch.serve_lm --continuous 16`` as a subprocess, output to a
   file, its endpoint read from its first line; 64 greedy requests over the
   wire from 16 client threads, prompt lengths 16 to 900 from a seed (those
   over 512 tokens prefill in chunks); then SIGTERM.  (c) An in-process
   engine on the same requests: tokens/s, peak memory; decode ms a step at
   16 live slots and the device-busy share of that loop (``torch.profiler``);
   prefill ms per bucket.  Every request must return its length, and every
   emitted token must be the argmax of the full-prefix dense forward (no
   cache) on the emitted tokens wherever that forward's top-2 margin exceeds
   ``SERVE_MARGIN``; how many requests equal their isolated ``generate``
   token for token is reported.  The path computes attention densely, as the
   JAX package's serving path does, so no attention kernel launches in it.

It then prints the card's ``nvidia-smi`` name and power limit, one line
``{"kernels": [...]}``, and, last, ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import sys
import time
from pathlib import Path

PHASES = ("build", "kernels", "parity", "flagship", "flash", "d256", "d384", "d768", "resume",
          "elastic", "serve")

# card peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor cores, f32
# outside them, and HBM bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP_SHAPE = (8, 1024, 6, 128)     # [B, L, H, D]
D256_SHAPE = (8, 1024, 3, 256)         # the d256 phase's attention
D384_SHAPE = (8, 1024, 2, 384)         # the d384 phase's attention
D768_SHAPE = (8, 1024, 1, 768)         # the d768 phase's attention
RAGGED_SHAPES = ((2, 200, 4, 64), (1, 77, 2, 128), (1, 17, 2, 64),
                 (2, 256, 4, 192), (2, 256, 4, 256), (1, 77, 2, 192), (1, 77, 2, 256),
                 (2, 256, 2, 320), (1, 77, 2, 320), (1, 200, 2, 320),
                 (1, 77, 2, 384), (1, 200, 2, 384), (2, 300, 2, 384),
                 (1, 77, 2, 448), (1, 100, 2, 448), (1, 200, 2, 448),
                 (1, 77, 2, 512), (1, 200, 2, 512),
                 (1, 77, 2, 576), (1, 200, 2, 576), (1, 77, 2, 640), (1, 200, 2, 640),
                 (1, 77, 2, 768), (1, 200, 2, 768), (1, 77, 2, 832), (1, 200, 2, 832),
                 (1, 77, 2, 1024), (1, 200, 2, 1024), (1, 130, 2, 1152), (1, 77, 1, 2048),
                 (1, 77, 1, 2112), (1, 300, 1, 2048))
# flash: (q's [B, Lq, H, D], Lk, causal), untimed
FLASH_CASES = (((2, 256, 4, 128), 512, True), ((2, 512, 4, 128), 256, True),
               ((1, 300, 2, 64), 1100, False),
               ((2, 256, 4, 192), 256, True), ((2, 256, 4, 192), 256, False),
               ((2, 256, 4, 256), 256, True), ((2, 256, 4, 256), 256, False),
               ((2, 200, 4, 256), 300, True), ((2, 300, 4, 192), 200, True),
               ((2, 128, 4, 256), 512, True),
               ((2, 256, 2, 320), 384, True), ((1, 300, 2, 320), 200, False),
               ((2, 128, 2, 384), 512, True), ((2, 300, 2, 384), 200, True),
               ((1, 300, 2, 384), 200, False), ((1, 100, 2, 448), 300, True),
               ((2, 256, 2, 512), 256, True), ((1, 200, 2, 512), 300, False),
               ((1, 200, 2, 320), 77, True), ((1, 300, 2, 448), 200, False),
               ((1, 77, 2, 448), 200, True), ((1, 128, 2, 512), 320, True),
               ((1, 300, 2, 512), 200, True), ((1, 200, 2, 512), 77, False),
               ((1, 77, 2, 576), 200, True), ((1, 200, 2, 576), 77, True),
               ((1, 200, 2, 576), 300, False),
               ((1, 77, 2, 640), 200, True), ((1, 200, 2, 640), 77, False),
               ((1, 300, 2, 640), 200, True),
               ((1, 77, 2, 768), 200, True), ((1, 200, 2, 768), 77, True),
               ((1, 200, 2, 768), 300, False),
               ((1, 77, 2, 832), 200, True), ((1, 200, 2, 832), 300, False),
               ((1, 77, 2, 1024), 200, True), ((1, 200, 2, 1024), 77, True),
               ((1, 200, 2, 1024), 300, False), ((1, 300, 1, 2048), 200, False))
# flash with every operand a transposed [B, H, L, D] tensor: (q's shape, Lk,
# causal), untimed
TRANSPOSED_CASES = (((2, 256, 4, 128), 384, True), ((2, 256, 4, 192), 384, True),
                    ((2, 320, 4, 256), 256, False), ((2, 256, 2, 384), 320, True),
                    ((1, 200, 2, 768), 256, True))
# B * H = 81,920 and 65,540 > 65,535 (grid y's limit): B * H rides on grid x
# (splash, untimed)
MANY_HEADS_SHAPES = ((16384, 128, 5, 64), (13108, 32, 5, 256))
REL_TOL = 1e-2                          # ||kernel - plain|| / ||plain||

SM90 = "edl_tpu_torch/csrc/attention_sm90.cu"     # the flagship path's forward, dQ and dK/dV
SPLIT = "edl_tpu_torch/csrc/attention_wide_sm90.cu"   # the forward at D = 320..512
CHUNK = "edl_tpu_torch/csrc/attention_chunk_sm90.cu"  # the forward above D = 512
CLUSTER = "edl_tpu_torch/csrc/attention_bwd_cluster_sm90.cu"  # dQ above 256, dK/dV above 384
SPLASH = "edl_tpu/ops/attention.py:112 -> jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py"
FLASH = "edl_tpu/ops/attention.py:81 -> jax/experimental/pallas/ops/tpu/flash_attention.py"
KERNELS = {
    # wrapper name -> (kernel name, source at the flagship shape, TPU code it replaces)
    "attention_fwd": ("edl_attn_fwd", SM90, f"{SPLASH}:1137"),
    "attention_bwd_dkdv": ("edl_attn_bwd_dkdv", SM90, f"{SPLASH}:2196"),
    "attention_bwd_dq": ("edl_attn_bwd_dq", SM90, f"{SPLASH}:1635"),
    "flash_fwd": ("edl_flash_fwd", SM90, f"{FLASH}:758"),
    "flash_bwd_dkdv": ("edl_flash_bwd_dkdv", SM90, f"{FLASH}:1121"),
    "flash_bwd_dq": ("edl_flash_bwd_dq", SM90, f"{FLASH}:1456"),
}
# the d384 phase's kernels: the splash path's at D = 384 (the Hopper forward
# whose consumers split the output columns; the cluster dQ, delta folded
# in; the Hopper dK/dV whose blocks split the output columns)
KERNELS_D384 = {
    "attention_fwd": ("edl_attn_fwd", SPLIT, KERNELS["attention_fwd"][2]),
    "attention_bwd_dq": ("edl_attn_bwd_dq", CLUSTER, KERNELS["attention_bwd_dq"][2]),
    "attention_bwd_dkdv": ("edl_attn_bwd_dkdv", SM90, KERNELS["attention_bwd_dkdv"][2]),
}
# the d768 phase's kernels: the splash path's at D = 768 (the Hopper forward
# on chunks of the output columns; the cluster dQ and dK/dV)
KERNELS_D768 = {**KERNELS_D384,
                "attention_fwd": ("edl_attn_fwd", CHUNK, KERNELS["attention_fwd"][2]),
                "attention_bwd_dkdv": ("edl_attn_bwd_dkdv", CLUSTER, KERNELS["attention_bwd_dkdv"][2])}
# each path's kernels, in the order the autograd function launches them
SPLASH_WRAPPERS = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv")
FLASH_WRAPPERS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
# (causal, non-causal) x (Hopper forward, dQ and dK/dV at 4 head dims each;
# dK/dV at 192 and 256 is the kernel whose consumers split dK and dV),
# (causal, non-causal) x (the Hopper forward whose consumers split the
# output columns at 4 head dims, the Hopper dK/dV whose blocks split the
# output columns at 2 head dims), (causal, non-causal) x the forward above
# 512 (a compile-time plan at D = 576, 640, 704, 768, and the run-time one
# above), (causal, non-causal) x the cluster dQ and dK/dV at 3 and 4 boxes
# a block, and the mma.sync kernels past the largest cluster: (causal,
# non-causal) x (dK/dV, dQ)
KERNEL_INSTANTIATIONS = 2 * (4 + 4 + 4) + 2 * (4 + 2) + 2 * (4 + 1) + 2 * (2 + 2) + 2 * 2


def log(phase: str, **nums) -> None:
    print(f"[{phase}] " + json.dumps(nums, sort_keys=True), flush=True)


def kernel_times(fn, reps: int) -> list[tuple[float, str, int]]:
    """``(device µs, kernel name, launches)`` of every kernel that ``reps``
    calls of ``fn()`` launch, longest first (``torch.profiler``).  A user
    annotation on the device timeline (the optimizer's ``Optimizer.step#...``,
    the process group's ``nccl:all_reduce``) spans kernels that are counted
    already and is left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                   and not ev.key.startswith(("Optimizer.", "nccl:"))), reverse=True)


def device_ms(fn, reps: int = 10, warmup: int = 3) -> tuple[float, int]:
    """Mean device time of ``fn()`` in ms: the summed time of the kernels it
    launches, so the host's launch overhead between calls, which exceeds the
    shortest kernels' run time, does not count.  Every call launches the
    same kernels, so a profile in which a kernel's count is not a multiple
    of ``reps`` lost records, and is taken again, as is one with none.
    Returns the time and how many profiles were taken again before it."""
    for _ in range(warmup):
        fn()
    for attempt in range(10):
        rows = kernel_times(fn, reps)
        if rows and all(count % reps == 0 for _, _, count in rows):
            return sum(us for us, _, _ in rows) / reps / 1e3, attempt
        print(f"device_ms: the profiler lost kernel records (counts "
              f"{[count for _, _, count in rows]} of {reps} calls); taken again",
              file=sys.stderr, flush=True)
        time.sleep(0.1 * (attempt + 1))
    raise RuntimeError("the profiler lost kernel records in 10 tries")


def rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


# -- phase 1 ---------------------------------------------------------------------

def phase_build(ctx) -> None:
    """Build, and print each kernel instantiation's registers and spill
    bytes from ``ptxas -v`` (``fwd_sm90<128,1>``: Hopper forward, D = 128,
    causal; ``fwd_split_sm90<384,1>``: the Hopper forward whose consumers
    split the output columns, D = 384, causal; ``fwd_chunk_sm90<768,1>``:
    the one on chunks of the columns above 512, D = 768, causal;
    ``fwd_chunk_sm90<1>``: the same with the run-time plan above 768).  A
    kernel that moves registers with setmaxnreg reports its launch-bound
    count (168); its consumer warpgroups run on 240.  Also every ptxas
    note C75xx, by instantiation (C7515, C7519, C7520: wgmma serialised or
    an arrive injected, slow, not wrong), which it prints as info, not as
    warnings; the note names its function, else it is the function being
    compiled."""
    from edl_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(extra_flags=["-Xptxas", "-v"], force=True)
    seconds = time.perf_counter() - t0

    def key(m):
        # the kernel's name and its integer and bool template arguments (a
        # plan's head dim too), from the mangled name's tail
        targs = m.group(2).split("Ev")[0] if m.group(2).startswith("I") else ""
        params = ",".join(re.findall(r"L[ib](\d+)E", targs))
        return f"{m.group(1)}<{params}>" if params else m.group(1)

    kernels, notes, name = {}, {}, None
    for out in logs.values():
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '.*?attn_(\w+?)_kernel(\w*)", line)
            if m:
                name = key(m)
                kernels[name] = {}
            elif note := re.search(r"\((C75\d\d)\)", line):
                m = re.search(r"attn_(\w+?)_kernel(\w*)", line)
                notes.setdefault(key(m) if m else str(name), []).append(note.group(1))
            elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
                kernels[name]["spill_bytes"] = int(m.group(1))
            elif name and (m := re.search(r"Used (\d+) registers", line)):
                kernels[name]["registers"] = int(m.group(1))
            elif "error" in line or "warning" in line:
                print(f"[build] {line.strip()}", flush=True)
    log("build", seconds=seconds, libraries=sorted(logs), kernel_instantiations=len(kernels),
        kernels=kernels, wgmma_notes=notes)
    if len(kernels) != KERNEL_INSTANTIATIONS:
        raise AssertionError(f"compiled {len(kernels)} attention kernels, want "
                             f"{KERNEL_INSTANTIATIONS}")
    # the cluster kernels (3 or 4 column boxes a block): registers, spills,
    # C75xx notes and the dynamic shared memory a launch takes
    # (edl_attn_bwd_smem)
    from edl_tpu_torch.ops import attention as A
    cluster = {}
    for kname in ("dq_cluster_sm90", "dkdv_cluster_sm90"):
        for bpr in (3, 4):
            for causal in (0, 1):
                inst = f"{kname}<{bpr},{causal}>"
                cluster[inst] = {**kernels.get(inst, {}), "notes": notes.get(inst, []),
                                 "smem_bytes": A.bwd_cluster_smem(bpr, kname.startswith("dq"))}
    log("build", cluster_kernels=cluster)
    bad = {k: v for k, v in cluster.items()
           if v.get("spill_bytes", 1) or v["notes"] or not v["smem_bytes"]}
    if bad:
        raise AssertionError(f"cluster kernels that spill, carry a C75xx note or were not "
                             f"built: {bad}")


# -- phase 2 ---------------------------------------------------------------------

def _attention_work(B, Lq, Lk, H, D, causal) -> dict:
    """Operations (as ``(count, peak rate of their type)`` pairs) and bytes
    each kernel needs at this shape: the unmasked pairs (causal, top-left:
    key j <= query i) are what the data needs; each input read once, each
    output written once."""
    if causal:
        pairs = B * H * sum(min(i + 1, Lk) for i in range(Lq))
    else:
        pairs = B * H * Lq * Lk
    tq, tk = B * Lq * H * D * 2, B * Lk * H * D * 2   # bf16 [B, L, H, D] tensors
    s = B * H * Lq * 4                                 # one f32 [B, H, Lq] statistic
    delta = (2 * B * Lq * H * D, PEAK_F32_FLOPS)      # rowsum(dO * O) in f32, in dQ
    fwd = (((4 * pairs * D, PEAK_BF16_FLOPS),), 2 * tq + 2 * tk + s)
    dkdv = (((8 * pairs * D, PEAK_BF16_FLOPS),), 2 * tq + 4 * tk + 2 * s)
    # dQ with delta folded in: reads q, o, dO, k, v and lse; writes dq and delta
    dq = (((6 * pairs * D, PEAK_BF16_FLOPS), delta), 4 * tq + 2 * tk + 2 * s)
    return {
        "attention_fwd": fwd, "flash_fwd": fwd,
        "attention_bwd_dkdv": dkdv, "flash_bwd_dkdv": dkdv,
        "attention_bwd_dq": dq, "flash_bwd_dq": dq,
    }


def _bound(ops, nbytes):
    """The least time in ms for ``ops`` (``(count, peak rate)`` pairs, one
    per type: the types' units run side by side, so the slowest type
    bounds) and ``nbytes``, and which of the two bounds it."""
    t_ops = max(n / peak for n, peak in ops) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _randn(shape, g, transposed=False):
    """bf16 normal values of ``shape`` ([B, L, H, D]); ``transposed``: a
    [B, H, L, D] tensor seen as [B, L, H, D] (head stride above row stride)."""
    import torch
    if transposed:
        B, L, H, D = shape
        return _randn((B, H, L, D), g).transpose(1, 2)
    return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)


def _kernel_set(flash: bool, causal: bool) -> dict:
    """wrapper name -> (kernel wrapper, plain version) of one path: the
    forward, dQ (with delta) and dK/dV."""
    from edl_tpu_torch.ops import attention as A
    if not flash:
        return {"attention_fwd": (A.attention_fwd, A.attention_fwd_plain),
                "attention_bwd_dq": (A.attention_bwd_dq, A.attention_bwd_dq_plain),
                "attention_bwd_dkdv": (A.attention_bwd_dkdv, A.attention_bwd_dkdv_plain)}
    c = functools.partial
    return {"flash_fwd": (c(A.flash_fwd, causal=causal), c(A.flash_fwd_plain, causal=causal)),
            "flash_bwd_dq": (c(A.flash_bwd_dq, causal=causal),
                             c(A.flash_bwd_dq_plain, causal=causal)),
            "flash_bwd_dkdv": (c(A.flash_bwd_dkdv, causal=causal),
                               c(A.flash_bwd_dkdv_plain, causal=causal))}


def check_kernels(shape, seed, timed: bool, Lk=None, causal=True, flash=False,
                  transposed=False) -> dict:
    """Each kernel of one path (splash: causal self-attention; flash: ``Lk``
    keys, ``causal`` or not) against its plain version at q's ``shape``;
    with ``timed``, also the times and bounds; with ``transposed``, every
    operand is a transposed [B, H, L, D] tensor, which the kernels must
    read in place.  Returns per-wrapper numbers."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import attention as A

    B, Lq, H, D = shape
    Lk = Lq if Lk is None else Lk
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (_randn(s, g, transposed)
                   for s in (shape, (B, Lk, H, D), (B, Lk, H, D), shape))
    if transposed and any(A._operand(t, "t", t.shape) is not t for t in (q, k, v, do)):
        raise AssertionError("a transposed operand was copied before the kernels")
    scale = D ** -0.5
    ks = _kernel_set(flash, causal)
    (fwd, fwd_p), (dq_k, dq_p), (dkdv, dkdv_p) = ks.values()
    n_fwd, n_dq, n_dkdv = ks
    o, lse = fwd(q, k, v, scale)
    o_p, lse_p = fwd_p(q, k, v, scale)
    # dQ first: it computes delta, which dK/dV then takes, as on the path
    dq, delta = dq_k(q, k, v, o, do, lse, scale)
    dq_pl, delta_p = dq_p(q, k, v, o, do, lse, scale)
    dk, dv = dkdv(q, k, v, do, lse, delta, scale)
    dk_p, dv_p = dkdv_p(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    pairs = {n_fwd: [(o, o_p), (lse, lse_p)], n_dq: [(dq, dq_pl), (delta, delta_p)],
             n_dkdv: [(dk, dk_p), (dv, dv_p)]}
    out = {}
    for name, outs in pairs.items():
        errs = [rel_err(a, b) for a, b in outs]
        finite = all(bool(torch.isfinite(a).all()) for a, _ in outs)
        out[name] = {"rel_err": max(errs), "max_abs_err": max(max_abs(a, b) for a, b in outs),
                     "finite": finite}
        if not finite or max(errs) > REL_TOL:
            raise AssertionError(f"{name} at {shape}, Lk={Lk}, causal={causal}: rel err "
                                 f"{errs} (tol {REL_TOL}), finite={finite}")
    if causal and Lk > Lq:
        # keys that no query sees (top-left: j >= Lq) get exactly zero
        unseen = max(float(dk[:, Lq:].abs().max()), float(dv[:, Lq:].abs().max()))
        out["unseen_keys_max_abs_grad"] = unseen
        if unseen != 0.0:
            raise AssertionError(f"dk/dv of unseen keys are not zero: {unseen}")
    # the autograd function end to end against dense attention's autograd,
    # with the top-left causal mask as an explicit mask
    qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
    if flash:
        ya = A.FlashAttention.apply(qa, ka, va, scale, causal)
    else:
        ya = A.SplashAttention.apply(qa, ka, va, scale)
    ga = torch.autograd.grad(ya, (qa, ka, va), do)
    qd, kd, vd = (t.detach().float().requires_grad_() for t in (q, k, v))
    keep = torch.ones(Lq, Lk, dtype=torch.bool, device="cuda").tril() if causal else None
    yd = A.dense_attention(qd, kd, vd, mask=keep)
    gd = torch.autograd.grad(yd, (qd, kd, vd), do.float())
    e2e = [rel_err(ya, yd)] + [rel_err(a, b) for a, b in zip(ga, gd)]
    if max(e2e) > REL_TOL:
        raise AssertionError(f"autograd vs dense at {shape}, Lk={Lk}: rel errs {e2e}")
    out["autograd_vs_dense_rel_err"] = max(e2e)
    if not timed:
        return out

    work = _attention_work(B, Lq, Lk, H, D, causal)
    args = {n_fwd: (q, k, v, scale), n_dq: (q, k, v, o, do, lse, scale),
            n_dkdv: (q, k, v, do, lse, delta, scale)}
    # the library yardstick: PyTorch's fused attention, forward and backward
    # (its backward computes dq, dk and dv in one call; its is_causal is
    # top-left too)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
    yt = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    lib_bwd = device_ms(lambda: torch.autograd.grad(yt, (qt, kt, vt), dot, retain_graph=True))
    library = {n_fwd: lib_fwd, n_dq: lib_bwd, n_dkdv: lib_bwd}
    for name, (kernel_fn, plain_fn) in ks.items():
        bound, by = _bound(*work[name])
        a = args[name]
        ms, retakes = device_ms(lambda: kernel_fn(*a))
        plain_ms, plain_retakes = device_ms(lambda: plain_fn(*a), reps=5)
        lib_ms, lib_retakes = library[name]
        # profiles taken again (records lost) behind ms, plain_ms and library_ms
        out[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                         bound_by=by, profile_retakes=retakes + plain_retakes + lib_retakes)
    return out


def check_fresh_thread() -> dict:
    """The forward and dQ as the first launches of a host thread that has
    made no CUDA call (autograd runs the backward on such a thread): the
    Hopper kernels' tensor maps need the thread's context current."""
    import threading

    import torch

    from edl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (_randn((2, 200, 4, 64), g) for _ in range(4))
    o, lse = A.attention_fwd_plain(q, k, v, 0.125)
    errors = []

    def body():
        try:
            A.attention_fwd(q, k, v, 0.125)
            A.attention_bwd_dq(q, k, v, o, do, lse, 0.125)
            torch.cuda.synchronize()
        except Exception as e:  # raised again on the main thread below
            errors.append(e)

    for _ in range(2):
        thread = threading.Thread(target=body)
        thread.start()
        thread.join()
    if errors:
        raise AssertionError(f"a launch from a fresh host thread failed: {errors[0]!r}")
    return {"fresh_thread_launches": "ok"}


ROUTE_HEAD_DIMS = (128, 256, 320, 384, 448, 512, 576, 640, 768, 832, 1024, 2048, 2112)


def check_routes() -> dict:
    """The device kernel the forward, dQ and dK/dV entry points run at each
    head dim, from the profile of one causal call (one kernel each), against
    ``device_kernels``' routing."""
    import torch

    from edl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(6)
    routes = {"forward": {}, "dq": {}, "dkdv": {}}
    for d in ROUTE_HEAD_DIMS:
        q = _randn((1, 128, 2, d), g)
        o, lse = A.attention_fwd(q, q, q, d ** -0.5)
        delta = A.attention_bwd_delta_plain(o, q)
        calls = {"forward": (lambda: A.attention_fwd(q, q, q, d ** -0.5), 0),
                 "dq": (lambda: A.attention_bwd_dq(q, q, q, o, q, lse, d ** -0.5), 1),
                 "dkdv": (lambda: A.attention_bwd_dkdv(q, q, q, q, lse, delta, d ** -0.5), 2)}
        for kind, (fn, at) in calls.items():
            fn()
            for _ in range(5):   # a profile that lost the kernel's record is taken again
                rows = kernel_times(fn, reps=1)
                names = [key for _, key, _ in rows if "attn_" in key]
                if names:
                    break
            want = A.device_kernels(d)[at]
            if len(names) != 1 or not re.search(rf"::{want}[<(]", names[0]):
                raise AssertionError(f"the {kind} at D = {d} ran {names}, want {want}")
            routes[kind][d] = want
    return {"kernel_by_head_dim": routes}


def check_f32_cross_length() -> dict:
    """f32 causal attention with Lq != Lk on the card, which the JAX package
    hands to its flash kernel: ``impl="auto"`` and ``"flash"`` compute its
    top-left function (through dense; the kernels take bf16) and launch no
    kernel."""
    import torch

    from edl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for lq, lk in ((128, 256), (256, 128)):
        q = torch.randn(2, lq, 2, 64, generator=g, device="cuda")
        k, v = (torch.randn(2, lk, 2, 64, generator=g, device="cuda") for _ in range(2))
        A.reset_launch_counts()
        got = [A.dot_product_attention(q, k, v, causal=True, impl=impl) for impl in ("auto", "flash")]
        o, _ = A.flash_fwd_plain(q, k, v, 64 ** -0.5, True)
        errs = [rel_err(x, o) for x in got]
        if max(errs) > 1e-5 or sum(A.launch_counts().values()) != 0:
            raise AssertionError(f"f32 causal {lq}x{lk}: rel errs {errs} against the top-left "
                                 f"function, launches {A.launch_counts()}")
        out[f"{lq}x{lk}"] = max(errs)
    return {"f32_causal_cross_length_rel_err": out}


def phase_kernels(ctx) -> None:
    import torch
    # the largest error of each wrapper: over every shape, and over D = 256,
    # 384 and 768
    worst: dict[str, float] = {}
    worst_at = {256: {}, 384: {}, 768: {}}
    log("kernels", **check_fresh_thread())
    log("kernels", **check_routes())
    log("kernels", **check_f32_cross_length())

    def record(res, shape, log_it=True, **where):
        for name, r in res.items():
            if isinstance(r, dict):
                worst[name] = max(worst.get(name, 0.0), r["max_abs_err"])
                if shape[3] in worst_at:
                    at = worst_at[shape[3]]
                    at[name] = max(at.get(name, 0.0), r["max_abs_err"])
        if log_it:
            log("kernels", shape=list(shape), **where, **res)

    for i, shape in enumerate(RAGGED_SHAPES):
        record(check_kernels(shape, seed=10 + i, timed=False), shape, path="splash")
    for seed, shape in zip((9, 31), MANY_HEADS_SHAPES):
        record(check_kernels(shape, seed=seed, timed=False), shape, path="splash")
        torch.cuda.empty_cache()
    for seed, (shape, Lk, causal) in zip((8, 41, 42, 43, 44), TRANSPOSED_CASES, strict=True):
        record(check_kernels(shape, seed=seed, timed=False, Lk=Lk, causal=causal, flash=True,
                             transposed=True),
               shape, path="flash", Lk=Lk, causal=causal, layout="[B, H, L, D] transposed")
    for i, (shape, Lk, causal) in enumerate(FLASH_CASES):
        record(check_kernels(shape, seed=20 + i, timed=False, Lk=Lk, causal=causal, flash=True),
               shape, path="flash", Lk=Lk, causal=causal)
    res = check_kernels(FLAGSHIP_SHAPE, seed=1, timed=True)
    flash = check_kernels(FLAGSHIP_SHAPE, seed=2, timed=True, causal=False, flash=True)
    d256 = check_kernels(D256_SHAPE, seed=3, timed=True)
    d384 = check_kernels(D384_SHAPE, seed=4, timed=True)
    d768 = check_kernels(D768_SHAPE, seed=5, timed=True)
    for path, r, causal, shape in (("splash", res, True, FLAGSHIP_SHAPE),
                                   ("flash", flash, False, FLAGSHIP_SHAPE),
                                   ("splash", d256, True, D256_SHAPE),
                                   ("splash", d384, True, D384_SHAPE),
                                   ("splash", d768, True, D768_SHAPE)):
        record(r, shape, log_it=False)
        for name, nums in r.items():
            if name in KERNELS and "ms" in nums:
                log("kernels", path=path, shape=list(shape), causal=causal, kernel=name, **nums)
        log("kernels", path=path, shape=list(shape), causal=causal,
            autograd_vs_dense_rel_err=r["autograd_vs_dense_rel_err"])
    timed = {**res, **{n: flash[n] for n in FLASH_WRAPPERS}}
    for name in KERNELS:
        timed[name]["max_abs_err"] = worst[name]
    ctx["kernels"] = timed
    ctx["kernels_d256"] = {n: {**d256[n], "max_abs_err": worst_at[256][n]} for n in SPLASH_WRAPPERS}
    ctx["kernels_d384"] = {n: {**d384[n], "max_abs_err": worst_at[384][n]} for n in KERNELS_D384}
    ctx["kernels_d768"] = {n: {**d768[n], "max_abs_err": worst_at[768][n]} for n in KERNELS_D768}
    torch.cuda.synchronize()


# -- phase 3 ---------------------------------------------------------------------

PARITY_LOSS_RTOL = 2e-2    # bf16 compute rounds to ~0.4% at every layer output
PARITY_GRAD_RTOL = 5e-2    # per-parameter gradient norms, same reason
# (attention impl, width, heads, kv heads): the splash path at head dims
# 128, 192, 256, 384 and 768, and the flash path with grouped-query
# attention at head dims 64 and 256
PARITY_CONFIGS = (("auto", 256, 2, 0), ("flash", 256, 4, 2), ("auto", 384, 2, 0),
                  ("auto", 512, 2, 0), ("flash", 512, 2, 1), ("auto", 768, 2, 0),
                  ("auto", 768, 1, 0))


def phase_parity(ctx) -> None:
    """One training step of 2-layer bf16 configs on the card (kernels) and
    on the CPU (plain path), from the same weights and the same batch."""
    import numpy as np
    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.train.state import adamw
    from edl_tpu_torch.train.trainer import ElasticTrainer

    for impl, width, heads, kv_heads in PARITY_CONFIGS:
        cfg = TransformerConfig(vocab_size=1000, num_layers=2, embed_dim=width, num_heads=heads,
                                num_kv_heads=kv_heads, mlp_dim=512, max_len=256,
                                dtype=torch.bfloat16, remat=False, attention_impl=impl)
        args = train_lm.parse_args(["--fused_ce", "--ce_block", "256"])
        ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 257)).astype(np.int32)
        weights = TransformerLM(cfg, torch.Generator().manual_seed(0)).state_dict()
        out = {}
        for dev in ("cuda", "cpu"):
            tr = ElasticTrainer(train_lm.make_loss_fn(args), device=dev)

            def init():
                model = TransformerLM(cfg)
                model.load_state_dict(weights)
                return model, None

            state = tr.create_state(init, adamw(3e-4))
            A.reset_launch_counts()
            state, metrics = tr.step_fn(state, tr.to_device({"ids": ids}),
                                        torch.Generator(device=dev).manual_seed(0))
            out[dev] = (float(metrics["loss"]),
                        {n: float(p.grad.float().norm()) for n, p in state.model.named_parameters()},
                        A.launch_counts())
        (loss_c, g_c, n_c), (loss_h, g_h, n_h) = out["cuda"], out["cpu"]
        grad_rel = max(abs(g_c[n] - g_h[n]) / max(g_h[n], 1e-30) for n in g_h)
        loss_rel = abs(loss_c - loss_h) / abs(loss_h)
        log("parity", attention=impl, head_dim=cfg.head_dim, kv_heads=cfg.kv_heads,
            loss_card=loss_c, loss_cpu=loss_h, loss_rel=loss_rel, grad_norm_max_rel=grad_rel,
            launches_card=n_c, launches_cpu=n_h, loss_rtol=PARITY_LOSS_RTOL,
            grad_rtol=PARITY_GRAD_RTOL)
        if not (math.isfinite(loss_c) and loss_rel <= PARITY_LOSS_RTOL
                and grad_rel <= PARITY_GRAD_RTOL):
            raise AssertionError(f"card and CPU disagree on the 2-layer {impl} step at "
                                 f"head dim {cfg.head_dim}")
        used = FLASH_WRAPPERS if impl == "flash" else SPLASH_WRAPPERS
        want = {n: cfg.num_layers if n in used else 0 for n in n_c}
        if n_c != want or max(n_h.values()) != 0:
            raise AssertionError(f"the card's {impl} step must launch its path's kernels once "
                                 f"per layer and no others, the CPU step none: {n_c} / {n_h}")


# -- phases 4 and 5 ----------------------------------------------------------------

FLAGSHIP_ARGS = ["--layers", "12", "--embed", "768", "--heads", "6", "--mlp", "3072",
                 "--vocab", "32000", "--seq_len", "1024", "--batch_size", "8",
                 "--fused_ce", "--lr", "3e-4"]
WARMUP_STEPS, TIMED_STEPS = 2, 10
FIRST_LOSS_RTOL = 1e-3   # splash and flash: one function, other kernels' rounding


def _drive_flagship(phase: str, extra_args: list[str], path_wrappers):
    """The 124M LM through train_lm's trainer on a fixed batch: 2 warm-up
    and 10 timed steps; ``path_wrappers`` must launch 12 times a step each
    and every other attention kernel none, and the profile must show each
    device kernel that one layer's attention launches at the run's head
    dim (``device_kernels``) 12 times a step and no other attention
    kernel.  Returns the losses and the launch counts of the timed steps."""
    import numpy as np
    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.models.transformer import param_count
    from edl_tpu_torch.obs.flops import analytic_lm_flops_per_token, peak_tflops
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.utils.device import smi_name_and_power_limit

    args = train_lm.parse_args(FLAGSHIP_ARGS + extra_args)
    device = torch.device("cuda")
    cfg, trainer, init_fn, tx = train_lm.build_trainer(args, device)
    state = trainer.create_state(init_fn, tx)
    ids = np.random.default_rng(2).integers(0, args.vocab, (args.batch_size,
                                                           args.seq_len + 1)).astype(np.int32)
    batch = trainer.to_device({"ids": ids})
    gen = torch.Generator(device=device).manual_seed(3)
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, metrics = trainer.step_fn(state, batch, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = A.launch_counts()
    losses = [float(x) for x in losses]
    tok_s = args.batch_size * args.seq_len * TIMED_STEPS / dt
    flops_tok = analytic_lm_flops_per_token(cfg.num_layers, cfg.embed_dim, cfg.mlp_dim,
                                            cfg.vocab_size, args.seq_len)
    peak = peak_tflops(torch.cuda.get_device_name(0))
    log(phase, nvidia_smi=smi_name_and_power_limit(), attention=args.attention,
        head_dim=cfg.head_dim, params=param_count(cfg), remat=cfg.remat,
        dtype=str(cfg.dtype), steps=TIMED_STEPS, step_ms=dt / TIMED_STEPS * 1e3,
        tokens_per_s=tok_s, tflops=tok_s * flops_tok / 1e12,
        mfu=(tok_s * flops_tok / 1e12 / peak) if peak else None,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        losses=losses, launches=launches)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    # unit-variance random logits put the first loss near ln V + 1/2
    if abs(losses[0] - math.log(args.vocab)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near ln V = {math.log(args.vocab)}")
    if not losses[-1] < losses[0] - 0.1:
        raise AssertionError(f"loss did not fall: {losses}")
    per_step = cfg.num_layers * TIMED_STEPS
    want = {n: per_step if n in path_wrappers else 0 for n in launches}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want} "
                             f"(12 layers x {TIMED_STEPS} steps on the path's kernels)")

    # where the step's device time goes, by kernel, over two steps
    rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
    total = sum(r[0] for r in rows)
    groups: dict[str, float] = {}
    for us, key, _ in rows:
        groups[_kernel_group(key)] = groups.get(_kernel_group(key), 0.0) + us / 2 / 1e3
    log(f"{phase}_profile", nvidia_smi=smi_name_and_power_limit(),
        device_busy_ms_per_step=total / 2 / 1e3, wall_ms_per_step=dt / TIMED_STEPS * 1e3,
        ms_per_step_by_group=groups)
    for rank, (us, key, count) in enumerate(rows):
        if rank < 15 or "attn_" in key:
            log(f"{phase}_profile", kernel=key[:100], ms_per_step=us / 2 / 1e3,
                share=us / total, calls_per_step=count / 2)
    # the device's own record: per layer a forward and the backward's two
    # kernels (dQ with delta, then dK/dV), and no other attention kernel
    device_kernels = A.device_kernels(cfg.head_dim)
    attn_calls = {key: count / 2 for _, key, count in rows
                  if _kernel_group(key).startswith("attention")}
    by_kernel = {k: sum(n for key, n in attn_calls.items() if re.search(rf"::{k}[<(]", key))
                 for k in device_kernels}
    if (sum(attn_calls.values()) != len(device_kernels) * cfg.num_layers
            or any(n != cfg.num_layers for n in by_kernel.values())):
        raise AssertionError(f"the profile shows attention kernels per step {attn_calls}, "
                             f"want {cfg.num_layers} each of {device_kernels} and no other")
    A.reset_launch_counts()
    del trainer, state
    torch.cuda.empty_cache()
    return losses, launches


def phase_flagship(ctx) -> None:
    """The 124M LM on the default (splash) path; also the splash path's
    pre-scale of q and of dq, timed apart at the flagship's q shape."""
    losses, launches = _drive_flagship("flagship", [], SPLASH_WRAPPERS)
    ctx["first_loss"] = losses[0]
    _keep_launches(ctx, launches, SPLASH_WRAPPERS)
    log("flagship", **prescale_cost())


def prescale_cost() -> dict:
    """Device ms a flagship step spends scaling q before the splash kernels
    and dq after them (``SplashAttention``): 12 layers x 2 bf16 multiplies
    of a [8, 1024, 6, 128] tensor."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(8)
    x = _randn(FLAGSHIP_SHAPE, g)
    s_b = float(torch.tensor(FLAGSHIP_SHAPE[3] ** -0.5, dtype=torch.bfloat16))
    ms, retakes = device_ms(lambda: x * s_b)
    return {"prescale_ms_per_call": ms, "prescale_ms_per_step": 2 * 12 * ms,
            "prescale_profile_retakes": retakes}


def phase_flash(ctx) -> None:
    """The 124M LM with ``--attention flash``; its first loss against the
    splash path's (one step of it here if the flagship phase did not run)."""
    losses, launches = _drive_flagship("flash", ["--attention", "flash"], FLASH_WRAPPERS)
    splash_first = ctx.get("first_loss")
    if splash_first is None:
        splash_first = _first_loss(["--attention", "splash"])
    rel = abs(losses[0] - splash_first) / abs(splash_first)
    log("flash", first_loss=losses[0], splash_first_loss=splash_first, first_loss_rel=rel,
        rtol=FIRST_LOSS_RTOL)
    if rel > FIRST_LOSS_RTOL:
        raise AssertionError(f"flash path's first loss {losses[0]} != splash path's "
                             f"{splash_first} (rel {rel}, tol {FIRST_LOSS_RTOL})")
    _keep_launches(ctx, launches, FLASH_WRAPPERS)


def phase_d256(ctx) -> None:
    """The flagship's widths and depth at head dim 256 (``--heads 3``) on the
    splash path: the dK/dV kernel whose consumers split dK and dV runs
    every layer."""
    _, launches = _drive_flagship("d256", ["--heads", "3"], SPLASH_WRAPPERS)
    ctx["launches_d256"] = {n: launches[n] for n in SPLASH_WRAPPERS}


def phase_d384(ctx) -> None:
    """The flagship's widths and depth at head dim 384 (``--heads 2``) on the
    splash path: every layer runs the Hopper forward whose consumers split
    the output columns, the cluster dQ and the Hopper dK/dV whose blocks
    split the output columns."""
    _, launches = _drive_flagship("d384", ["--heads", "2"], tuple(KERNELS_D384))
    ctx["launches_d384"] = {n: launches[n] for n in KERNELS_D384}


def phase_d768(ctx) -> None:
    """The flagship's widths and depth at head dim 768 (``--heads 1``) on the
    splash path: every layer runs the Hopper forward on chunks of the output
    columns and the cluster dQ and dK/dV."""
    _, launches = _drive_flagship("d768", ["--heads", "1"], tuple(KERNELS_D768))
    ctx["launches_d768"] = {n: launches[n] for n in KERNELS_D768}


def _keep_launches(ctx, launches, path_wrappers) -> None:
    """Keep a main-path run's counts of its path's kernels for the kernels
    line."""
    ctx.setdefault("launches", {}).update({n: launches[n] for n in path_wrappers})


def _first_loss(extra_args: list[str]) -> float:
    """The flagship's first training-step loss on another path."""
    import numpy as np
    import torch

    from edl_tpu_torch import train_lm

    args = train_lm.parse_args(FLAGSHIP_ARGS + extra_args)
    device = torch.device("cuda")
    _, trainer, init_fn, tx = train_lm.build_trainer(args, device)
    state = trainer.create_state(init_fn, tx)
    ids = np.random.default_rng(2).integers(0, args.vocab, (args.batch_size,
                                                           args.seq_len + 1)).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(3)
    _, metrics = trainer.step_fn(state, trainer.to_device({"ids": ids}), gen)
    loss = float(metrics["loss"])
    del trainer, state
    torch.cuda.empty_cache()
    return loss


def _kernel_group(name: str) -> str:
    if "attn_" in name:
        return "attention (this repo's kernels)"
    if any(tag in name for tag in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "elementwise" in name or "reduce" in name:
        return "elementwise and reductions"
    return "other"


# -- phase 6 ---------------------------------------------------------------------

RESUME_RTOL = 1e-4   # the same card, deterministic kernels, a bit-exact restore


def phase_resume(ctx) -> None:
    """Stop at an epoch's end, restore into a new trainer, and continue:
    the next loss must match an uninterrupted run's."""
    import shutil

    import torch

    from edl_tpu_torch import train_lm

    args = train_lm.parse_args(FLAGSHIP_ARGS + ["--steps_per_epoch", "2"])
    device = torch.device("cuda")
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def data_fn(epoch):
        gen = train_lm.markov_corpus(args, 1000 * (epoch + 1))
        for _ in range(args.steps_per_epoch):
            yield next(gen)

    def run(epochs, checkpoint_dir):
        _, trainer, init_fn, tx = train_lm.build_trainer(args, device, checkpoint_dir)
        inner, losses = trainer.loss_fn, []

        def recording(*a):
            loss, aux = inner(*a)
            losses.append(loss.detach())
            return loss, aux

        trainer.loss_fn = recording
        state, meta = trainer.restore_or_create(init_fn, tx)
        resumed = (state.step, meta.next_epoch)
        state, meta = trainer.fit(state, meta, data_fn, epochs=epochs)
        out = (resumed, state.step, meta.next_epoch, [float(x) for x in losses])
        del trainer, state
        torch.cuda.empty_cache()
        return out

    _, _, _, straight = run(2, "")
    _, step_a, next_a, first = run(1, str(ckpt_dir))
    (step_b0, epoch_b0), step_b, next_b, second = run(2, str(ckpt_dir))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n = args.steps_per_epoch
    diff = abs(second[0] - straight[n]) / abs(straight[n])
    log("resume", uninterrupted_losses=straight, before_stop=first, after_restore=second,
        saved_step=step_a, restored_step=step_b0, restored_next_epoch=epoch_b0,
        final_step=step_b, final_next_epoch=next_b, next_loss_rel_diff=diff,
        rtol=RESUME_RTOL)
    if (step_a, next_a) != (n, 1) or (step_b0, epoch_b0) != (n, 1) or (step_b, next_b) != (2 * n, 2):
        raise AssertionError("step / next_epoch did not continue across the restore")
    before = max(abs(a - b) / abs(b) for a, b in zip(first, straight[:n]))
    if diff > RESUME_RTOL or before > RESUME_RTOL:
        raise AssertionError("the resumed run does not continue the uninterrupted one")


# -- phase 10 --------------------------------------------------------------------

ELASTIC_STEPS = 3
# the entry point's run (full width, depth cut to 2) and the 2-rank CPU world
ENTRY_ARGS = FLAGSHIP_ARGS + ["--layers", "2", "--steps_per_epoch", "2"]
WORLD_ARGS = ["--vocab", "1000", "--layers", "2", "--embed", "128", "--heads", "2",
              "--mlp", "512", "--seq_len", "256", "--batch_size", "2", "--steps_per_epoch", "2",
              "--fused_ce", "--ce_block", "256", "--lr", "3e-4"]
SUBPROCESS_TIMEOUT = 300


def _launch_env(rank: int, world: int, port: int, ckpt_dir, **extra) -> dict:
    """The env the elastic launcher exports to one trainer (one trainer a
    pod), with no coordination store."""
    import os
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    root = str(Path(__file__).resolve().parent)
    env.update({"PYTHONPATH": root, "EDL_TPU_JOB_ID": "chip-smoke",
                "EDL_TPU_TRAINER_ID": str(rank), "EDL_TPU_TRAINER_RANK_IN_POD": "0",
                "EDL_TPU_TRAINERS_NUM": str(world), "EDL_TPU_COORDINATOR": f"127.0.0.1:{port}",
                "EDL_TPU_TRAINER_ENDPOINTS": ",".join(f"127.0.0.1:{port + r}"
                                                      for r in range(world)),
                "EDL_TPU_POD_ID": f"pod-{rank}", "EDL_TPU_POD_RANK": str(rank),
                "EDL_TPU_DEVICE_IDS": "0", "EDL_TPU_CKPT_DIR": str(ckpt_dir), **extra})
    return env


def _run_ranks(argv: list[str], world: int, ckpt_dir, **extra) -> list[tuple[str, str]]:
    """Run ``python -X importtime -m edl_tpu_torch.train_lm argv`` as
    ``world`` ranks; returns each rank's (stdout, stderr).  Their output goes
    to files, so no rank blocks on a full pipe while its peers wait for it
    in a collective; every process is stopped by the time this returns."""
    import subprocess
    import tempfile

    from edl_tpu_torch.utils.network import find_free_port
    port = find_free_port()
    root = Path(__file__).resolve().parent
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, "-X", "importtime", "-m", "edl_tpu_torch.train_lm",
                               *argv], cwd=root, env=_launch_env(r, world, port, ckpt_dir, **extra),
                              stdout=out, stderr=err, text=True)
             for r, (out, err) in enumerate(files)]
    try:
        for proc in procs:
            proc.wait(timeout=SUBPROCESS_TIMEOUT)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = []
    for proc, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        outs.append((out.read(), err.read()))
        out.close()
        err.close()
        if proc.returncode != 0:
            raise AssertionError(f"train_lm {argv} exited {proc.returncode}:\n"
                                 f"{outs[-1][0][-2000:]}\n{outs[-1][1][-4000:]}")
    return outs


def _imported(importtime_stderr: str) -> set[str]:
    return {line.split("|")[-1].strip() for line in importtime_stderr.splitlines()
            if line.startswith("import time:")}


def _elastic_group_of_one() -> dict:
    """3 flagship steps with no process group, then 3 from the same weights
    in an NCCL group of one: equal to the bit; the profile of a step and
    tokens/s with and without the group."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    from edl_tpu_torch.utils.network import find_free_port

    args = train_lm.parse_args(FLAGSHIP_ARGS)
    device = torch.device("cuda", 0)
    ids = np.random.default_rng(2).integers(0, args.vocab, (args.batch_size,
                                                           args.seq_len + 1)).astype(np.int32)

    def steps(n):
        cfg, trainer, init_fn, tx = train_lm.build_trainer(args, device)
        state = trainer.create_state(init_fn, tx)
        batch = trainer.to_device({"ids": ids})
        gen = torch.Generator(device=device).manual_seed(3)
        losses = []
        for _ in range(n):
            state, metrics = trainer.step_fn(state, batch, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        return cfg, trainer, state, batch, gen, [float(x) for x in losses]

    def tokens_per_s(trainer, state, batch, gen):
        for _ in range(WARMUP_STEPS):
            trainer.step_fn(state, batch, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            trainer.step_fn(state, batch, gen)
        torch.cuda.synchronize()
        return args.batch_size * args.seq_len * TIMED_STEPS / (time.perf_counter() - t0)

    *_, plain_state, _, _, plain_losses = steps(ELASTIC_STEPS)
    plain = {n: t.detach().clone() for n, t in plain_state.model.state_dict().items()}
    del plain_state
    torch.cuda.empty_cache()

    torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", find_free_port(), 1, True)
    dist.init_process_group("nccl", store=store, world_size=1, rank=0, device_id=device)
    try:
        A.reset_launch_counts()
        cfg, trainer, state, batch, gen, losses = steps(ELASTIC_STEPS)
        launches = A.launch_counts()
        if trainer.world_size != 1 or dist.get_backend() != "nccl":
            raise AssertionError(f"world {trainer.world_size}, backend {dist.get_backend()}")
        differing = [n for n, t in state.model.state_dict().items() if not torch.equal(t, plain[n])]
        rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
        with_group = tokens_per_s(trainer, state, batch, gen)
    finally:
        dist.destroy_process_group()
        del store
    rows_plain = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
    without_group = tokens_per_s(trainer, state, batch, gen)
    nccl = {key: (us / 2 / 1e3, count / 2) for us, key, count in rows
            if re.search(r"nccl|onerank", key, re.I)}
    plain_keys = {key for _, key, _ in rows_plain}
    reduction = {key: us / 2 / 1e3 for us, key, _ in rows if key not in plain_keys}
    out = {"nvidia_smi": smi_name_and_power_limit(), "losses_group": losses,
           "losses_no_group": plain_losses, "params_differing": differing,
           "launches": launches, "nccl_kernels": {k: {"ms_per_step": ms, "calls_per_step": n}
                                                  for k, (ms, n) in nccl.items()},
           "nccl_ms_per_step": sum(ms for ms, _ in nccl.values()),
           "reduction_kernels_ms_per_step": reduction,
           "device_busy_ms_per_step": sum(r[0] for r in rows) / 2 / 1e3,
           "device_busy_ms_per_step_no_group": sum(r[0] for r in rows_plain) / 2 / 1e3,
           "tokens_per_s_group": with_group, "tokens_per_s_no_group": without_group}
    del trainer, state
    torch.cuda.empty_cache()
    log("elastic", **out)
    if losses != plain_losses or differing:
        raise AssertionError(f"the NCCL group of one changed the step: losses {losses} vs "
                             f"{plain_losses}, parameters differing: {differing[:5]}")
    want = {n: cfg.num_layers * ELASTIC_STEPS if n in SPLASH_WRAPPERS else 0 for n in launches}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not nccl:
        raise AssertionError(f"no NCCL kernel in the step's profile; kernels the group added: "
                             f"{sorted(reduction)}")
    return launches


def _elastic_entry_point(ckpt_dir) -> dict:
    """The entry point under a launcher-shaped env with no store: 1 epoch,
    then 2, resuming at epoch 1; no msgpack import."""
    first, = _run_ranks(ENTRY_ARGS + ["--epochs", "1"], 1, ckpt_dir)
    second, = _run_ranks(ENTRY_ARGS + ["--epochs", "2"], 1, ckpt_dir)
    out = {}
    for name, (stdout, stderr) in (("first", first), ("second", second)):
        lines = [line for line in stdout.splitlines() if line.startswith("[train_lm]")]
        msgpack = sorted(m for m in _imported(stderr) if m.split(".")[0] == "msgpack")
        out[name] = {"lines": lines, "msgpack_imports": msgpack}
        if msgpack:
            raise AssertionError(f"the {name} run imported {msgpack}")
    log("elastic", entry_point=out)
    if ("resume_epoch=0" not in first[0] or "resume_epoch=1" not in second[0]
            or '"world": 1' not in second[0] or "rank=0/1 device=cuda" not in second[0]):
        raise AssertionError("the entry point did not resume at epoch 1 in a world of 1")
    return out


def _elastic_world_change(root) -> dict:
    """A 2-rank gloo world on the CPU saves an epoch; the card and the CPU
    each restore it at world 1 under EDL_TPU_LR_RESCALE=1 and train the
    next epoch from the same batches."""
    import os
    import shutil

    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.train import lr as lr_mod

    saved = root / "world2"
    _run_ranks(WORLD_ARGS + ["--device", "cpu", "--epochs", "1"], 2, saved,
               EDL_TPU_LR_RESCALE="1", OMP_NUM_THREADS="4")
    out = {}
    os.environ["EDL_TPU_LR_RESCALE"] = "1"
    try:
        for dev in ("cuda", "cpu"):
            ckpt = root / f"restore_{dev}"
            shutil.copytree(saved, ckpt)
            args = train_lm.parse_args(WORLD_ARGS + ["--device", dev])
            _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device(dev), str(ckpt))
            inner, losses = trainer.loss_fn, []

            def recording(*a, inner=inner, losses=losses):
                loss, aux = inner(*a)
                losses.append(loss.detach())
                return loss, aux

            trainer.loss_fn = recording
            state, meta = trainer.restore_or_create(init_fn, tx)
            restored = {"step": state.step, "next_epoch": meta.next_epoch,
                        "lr_scale": lr_mod.lr_scale(state),
                        "param_device": str(next(state.model.parameters()).device)}

            def data_fn(epoch, args=args):
                gen = train_lm.markov_corpus(args, 1000 * (epoch + 1))
                for _ in range(args.steps_per_epoch):
                    yield next(gen)

            state, meta = trainer.fit(state, meta, data_fn, epochs=2)
            out[dev] = {**restored, "losses": [float(x) for x in losses],
                        "epoch_worlds": [e.world_size for e in meta.epochs],
                        "final_lr_scale": lr_mod.lr_scale(state)}
            del trainer, state
    finally:
        del os.environ["EDL_TPU_LR_RESCALE"]
    torch.cuda.empty_cache()
    card, cpu = out["cuda"], out["cpu"]
    rel = abs(card["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
    log("elastic", world_change=out, next_loss_rel=rel, rtol=PARITY_LOSS_RTOL)
    for dev, r in out.items():
        if (r["step"], r["next_epoch"], r["lr_scale"], r["epoch_worlds"]) != (2, 1, 0.5, [2, 1]):
            raise AssertionError(f"the {dev} restore of the 2-rank checkpoint: {r}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"non-finite loss on {dev}: {r['losses']}")
    if card["param_device"] != "cuda:0" or rel > PARITY_LOSS_RTOL:
        raise AssertionError(f"the card's continuation is not the CPU's: rel {rel}")
    return out


def phase_elastic(ctx) -> None:
    """The distributed trainer: an NCCL group of one, the entry point under a
    launcher-shaped env, and a restore across a world change."""
    import shutil
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_elastic"
    shutil.rmtree(root, ignore_errors=True)
    try:
        ctx["launches_elastic"] = _elastic_group_of_one()
        _elastic_entry_point(root / "entry")
        _elastic_world_change(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phase 11 --------------------------------------------------------------------

SERVE_ARGS = ["--layers", "12", "--embed", "768", "--heads", "6", "--mlp", "3072",
              "--vocab", "32000", "--max_len", "1024"]
SERVE_SLOTS = 16
SERVE_REQUESTS = 64
SERVE_NEW = 32
# a token is held to the full-prefix forward's argmax where that forward's
# top-2 margin exceeds this (in logits, of unit scale at seed-0 weights: 8
# bf16 ulps at 4); the decode path's logits must lie within half of it of the
# full-prefix forward's, so a margin above it cannot flip
SERVE_MARGIN = 0.25


def _serve_model():
    """The flagship LM at seed-0 weights on the card, bf16, dense attention
    (serve_lm builds the same from the same seed)."""
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    cfg = TransformerConfig(vocab_size=32000, num_layers=12, embed_dim=768, num_heads=6,
                            mlp_dim=3072, max_len=1024, remat=False, attention_impl="dense",
                            dtype=torch.bfloat16)
    model = TransformerLM(cfg, torch.Generator().manual_seed(0)).to("cuda")
    return model.requires_grad_(False).eval()


def _argmax_check(model, prompts, outs) -> dict:
    """Each emitted token against the argmax of the full-prefix dense
    forward (no cache) on prompt + the tokens emitted before it, where that
    forward's top-2 margin exceeds SERVE_MARGIN."""
    import numpy as np
    import torch
    checked = wrong = 0
    for prompt, out in zip(prompts, outs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        with torch.inference_mode():
            logits = model(torch.from_numpy(seq[None]).cuda())[0, len(prompt) - 1:]
        top = logits.topk(2, dim=-1)
        sure = (top.values[:, 0] - top.values[:, 1] > SERVE_MARGIN).cpu().numpy()
        checked += int(sure.sum())
        wrong += int((sure & (top.indices[:, 0].cpu().numpy() != out)).sum())
    return {"tokens": int(sum(len(o) for o in outs)), "checked": checked, "mismatched": wrong}


def _serve_generate(model) -> dict:
    """(a) generate greedy on [8, 128] prompts, 64 new tokens; its decode
    logits teacher-forced on the emitted tokens against the full forward's."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.generate import generate
    from edl_tpu_torch.models.transformer import KVCache, decode_model
    B, P, N = 8, 128, 64
    prompt = torch.from_numpy(np.random.default_rng(10).integers(0, 32000, (B, P))).cuda()
    dm = decode_model(model)
    generate(dm, prompt, 4, temperature=0)             # first calls: cuBLAS handles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(dm, prompt, N, temperature=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if toks.shape != (B, N):
        raise AssertionError(f"generate returned {tuple(toks.shape)}, want {(B, N)}")
    seq = torch.cat([prompt, toks[:, :-1].long()], dim=1)
    with torch.inference_mode():
        full = model(seq)[:, P - 1:]
        cache = KVCache.zeros(dm.cfg, B, 256, "cuda")
        rows = [dm.head(dm(prompt, cache=cache, return_hidden=True)[:, -1])]
        for t in range(N - 1):
            rows.append(dm.head(dm(toks[:, t:t + 1], positions=cache.index[:, None],
                                   cache=cache, return_hidden=True)[:, 0]))
    dev = float((torch.stack(rows, 1) - full).abs().max())
    check = _argmax_check(model, list(prompt.cpu().numpy()), list(toks.cpu().numpy()))
    out = {"batch": B, "prompt": P, "new": N, "seconds": dt, "tokens_per_s": B * N / dt,
           "decode_vs_full_max_abs_logit": dev, "argmax": check}
    log("serve_generate", **out)
    if dev > SERVE_MARGIN / 2:
        raise AssertionError(f"the decode path's logits are {dev} from the full forward's "
                             f"(allowed {SERVE_MARGIN / 2})")
    return check


def _kernel_ms(fn, reps: int) -> tuple[float, float]:
    """Summed device time (ms) of the kernels one call of ``fn()`` launches,
    and their number, over ``reps`` profiled calls (cuBLAS may pick a kernel
    per call, so per-kernel counts need not divide by ``reps`` as
    ``device_ms`` asks)."""
    rows = kernel_times(fn, reps)
    return sum(r[0] for r in rows) / reps / 1e3, sum(r[2] for r in rows) / reps


def _serve_prompts():
    import numpy as np
    rng = np.random.default_rng(11)
    return [rng.integers(0, 32000, int(n)).astype(np.int32)
            for n in rng.integers(16, 901, SERVE_REQUESTS)]


def _start_server(log_path):
    """serve_lm --continuous 16 at full width on the card, output to a file."""
    import os
    import subprocess
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent)
    with open(log_path, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "edl_tpu_torch.serve_lm", *SERVE_ARGS, "--continuous",
             str(SERVE_SLOTS), "--max_new_tokens", str(SERVE_NEW), "--temperature", "0",
             "--port", "0"],
            cwd=Path(__file__).resolve().parent, env=env, stdout=f, stderr=subprocess.STDOUT)


def _serve_wire(proc, log_path, prompts) -> tuple[list, dict]:
    """(b) 64 greedy requests over the wire from 16 client threads."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from edl_tpu_torch.rpc.client import RpcClient
    from edl_tpu_torch.serve_lm import request
    deadline = time.monotonic() + SUBPROCESS_TIMEOUT
    while True:
        text = log_path.read_text()
        first = text.splitlines()[0] if text else ""
        if "[serve_lm] serving on" in first:
            endpoint = first.split("serving on")[1].split()[0]
            break
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"serve_lm never announced its endpoint: {text[-3000:]}")
        time.sleep(0.2)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_SLOTS) as pool:
        outs = list(pool.map(lambda p: request(endpoint, p[None], timeout=SUBPROCESS_TIMEOUT),
                             prompts))
    dt = time.perf_counter() - t0
    client = RpcClient(endpoint, 30)
    stats = client.call("stats")
    client.close()
    bad = [i for i, o in enumerate(outs) if o.shape != (1, SERVE_NEW)]
    if bad:
        raise AssertionError(f"requests {bad} returned the wrong length")
    out = {"endpoint": endpoint, "requests": len(prompts), "seconds": dt,
           "tokens_per_s": len(prompts) * SERVE_NEW / dt, "engine_stats": stats}
    log("serve_wire", **out)
    if stats["chunked_admissions"] < 1 or stats["requests_done"] != len(prompts):
        raise AssertionError(f"the server's stats show no chunked admission or lost "
                             f"requests: {stats}")
    return [np.asarray(o[0]) for o in outs], out


def _serve_engine(model, prompts) -> dict:
    """(c) an in-process engine on the same requests, and its pieces timed."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.transformer import KVCache
    from edl_tpu_torch.serving import ContinuousBatcher
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    engine = ContinuousBatcher(model, slots=SERVE_SLOTS, temperature=0.0)
    try:
        engine.warm(128)
        engine.warm(900)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        futs = [engine.submit(p, SERVE_NEW) for p in prompts]
        outs = [f.result(timeout=SUBPROCESS_TIMEOUT) for f in futs]
        dt = time.perf_counter() - t0
        if any(len(o) != SERVE_NEW for o in outs):
            raise AssertionError(f"engine outputs of lengths {[len(o) for o in outs]}")
        stats = engine.stats()
        peak = torch.cuda.max_memory_allocated()
        # the decode loop at 16 live slots, at position 512 of a 1024 cache:
        # one dispatch is steps_per_sync steps, the engine's own _step
        T = engine._T
        gen = torch.Generator(device="cuda").manual_seed(0)
        with torch.inference_mode():
            cache = KVCache.zeros(engine._mcfg, SERVE_SLOTS, 1024, "cuda")
            cache.index.fill_(512)
            toks = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device="cuda")

            def dispatch():
                engine._step(cache, toks, gen)

            dispatch()
            torch.cuda.synchronize()
            reps = 4
            t1 = time.perf_counter()
            for _ in range(reps):
                dispatch()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) / reps / T * 1e3
            busy_ms, launches = _kernel_ms(dispatch, reps=2)
            busy_ms, launches = busy_ms / T, launches / T
            prefill = {}
            for P in engine._buckets:
                ids, lens = np.zeros((1, P), np.int32), np.full(1, P, np.int32)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                engine._prefill(ids, lens, gen)
                torch.cuda.synchronize()
                prefill[P] = {"wall_ms": (time.perf_counter() - t1) * 1e3,
                              "device_ms": _kernel_ms(lambda: engine._prefill(ids, lens, gen),
                                                      reps=2)[0]}
    finally:
        engine.stop()
    out = {"nvidia_smi": smi_name_and_power_limit(), "requests": len(prompts),
           "seconds": dt, "engine_tokens_per_s": len(prompts) * SERVE_NEW / dt,
           "decode_ms_per_step_16_slots": wall_ms, "decode_device_ms_per_step_16_slots": busy_ms,
           "decode_device_busy_share": busy_ms / wall_ms,
           "decode_kernels_per_step": launches, "prefill_ms_by_bucket_k1": prefill,
           "max_memory_allocated": peak, "steps_per_sync": T,
           "cache_bytes": KVCache.zeros(engine._mcfg, 1, 1, "meta").nbytes() * SERVE_SLOTS * 1024,
           "engine_stats": stats}
    log("serve_engine", **out)
    return {"outs": outs, **out}


def phase_serve(ctx) -> None:
    """Generation and serving at the flagship's width: generate, the entry
    point over the wire, an in-process engine; every token held to the
    full-prefix forward's argmax where its margin allows."""
    import shutil
    import signal

    import numpy as np
    import torch

    from edl_tpu_torch.models.generate import generate
    from edl_tpu_torch.models.transformer import decode_model
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.utils.device import smi_name_and_power_limit
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_serve"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    log_path = root / "serve_lm.log"
    proc = _start_server(log_path)        # it loads while (a) runs
    try:
        A.reset_launch_counts()
        model = _serve_model()
        check_a = _serve_generate(model)
        prompts = _serve_prompts()
        wire_outs, wire = _serve_wire(proc, log_path, prompts)
        proc.send_signal(signal.SIGTERM)
        if proc.wait(timeout=60) != 0:
            raise AssertionError(f"serve_lm exited {proc.returncode}: "
                                 f"{log_path.read_text()[-3000:]}")
        eng = _serve_engine(model, prompts)
        launches = A.launch_counts()
        dm = decode_model(model)
        alone = [generate(dm, torch.from_numpy(p[None]), SERVE_NEW,
                          temperature=0).cpu().numpy()[0] for p in prompts]
        checks = {"generate": check_a, "wire": _argmax_check(model, prompts, wire_outs),
                  "engine": _argmax_check(model, prompts, eng["outs"])}
        equal = {"wire": sum(bool(np.array_equal(a, b)) for a, b in zip(wire_outs, alone)),
                 "engine": sum(bool(np.array_equal(a, b)) for a, b in zip(eng["outs"], alone))}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log("serve", nvidia_smi=smi_name_and_power_limit(), argmax=checks,
        requests_equal_to_isolated_generate=equal, of=len(prompts), margin=SERVE_MARGIN,
        attention_kernel_launches=launches,
        wire_tokens_per_s=wire["tokens_per_s"], engine_tokens_per_s=eng["engine_tokens_per_s"],
        decode_ms_per_step_16_slots=eng["decode_ms_per_step_16_slots"],
        decode_device_busy_share=eng["decode_device_busy_share"],
        decode_kernels_per_step=eng["decode_kernels_per_step"],
        prefill_ms_by_bucket_k1=eng["prefill_ms_by_bucket_k1"],
        max_memory_allocated=eng["max_memory_allocated"])
    shutil.rmtree(root, ignore_errors=True)
    if any(c["mismatched"] for c in checks.values()):
        raise AssertionError(f"emitted tokens differ from the full-prefix argmax: {checks}")
    if any(c["checked"] < 0.1 * c["tokens"] for c in checks.values()):
        raise AssertionError(f"too few tokens clear the margin to be checked: {checks}")
    if any(launches.values()):
        raise AssertionError(f"the serving path launched attention kernels: {launches}")


# -- main ------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma-separated subset of {','.join(PHASES)}")
    args = p.parse_args(argv)
    phases = [s for s in args.phases.split(",") if s]
    unknown = set(phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from edl_tpu_torch.utils.device import smi_name_and_power_limit

    # every comparison below is against full-f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_name_and_power_limit()
    log("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0))

    ctx: dict = {}
    runners = {"build": phase_build, "kernels": phase_kernels, "parity": phase_parity,
               "flagship": phase_flagship, "flash": phase_flash, "d256": phase_d256,
               "d384": phase_d384, "d768": phase_d768, "resume": phase_resume,
               "elastic": phase_elastic, "serve": phase_serve}
    for name in PHASES:
        if name in phases:
            t0 = time.perf_counter()
            runners[name](ctx)
            log(name, phase_seconds=time.perf_counter() - t0)

    def entry(name, source, replaces, launches, r):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
                "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"),
                "profile_retakes": r.get("profile_retakes")}

    kern, launches = ctx.get("kernels", {}), ctx.get("launches", {})
    entries = [entry(kname, source, replaces, launches.get(wrapper), kern.get(wrapper, {}))
               for wrapper, (kname, source, replaces) in KERNELS.items()]
    # the d256 phase's kernels: the splash path at [8, 1024, 3, 256]
    kern, launches = ctx.get("kernels_d256", {}), ctx.get("launches_d256", {})
    entries += [entry(f"{KERNELS[w][0]} at D=256", SM90, KERNELS[w][2], launches.get(w),
                      kern.get(w, {})) for w in SPLASH_WRAPPERS]
    # the d384 phase's kernels: the splash path at [8, 1024, 2, 384]
    kern, launches = ctx.get("kernels_d384", {}), ctx.get("launches_d384", {})
    entries += [entry(f"{kname} at D=384", source, replaces, launches.get(w), kern.get(w, {}))
                for w, (kname, source, replaces) in KERNELS_D384.items()]
    # the d768 phase's kernels: the splash path at [8, 1024, 1, 768]
    kern, launches = ctx.get("kernels_d768", {}), ctx.get("launches_d768", {})
    entries += [entry(f"{kname} at D=768", source, replaces, launches.get(w), kern.get(w, {}))
                for w, (kname, source, replaces) in KERNELS_D768.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
