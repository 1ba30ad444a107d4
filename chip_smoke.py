#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py                 # every phase, as a check runs it
    python3 chip_smoke.py --phases build,kernels

Phases, in order; each prints its numbers on a line of its own, and any
failure exits non-zero:

1. ``build``: compile the CUDA kernels from ``edl_tpu_torch/csrc`` with nvcc.
2. ``kernels``: each kernel against its plain PyTorch version (f32 from the
   same bf16 inputs) at the flagship shape and ragged ones, with device
   times (``torch.profiler``) of the kernel, of its plain version and of
   one PyTorch library call as a yardstick only, and the least time the
   card could take (the bound).
3. ``parity``: one training step of a small bf16 config on the card (with
   the kernels) and on the CPU (plain path) from the same weights.
4. ``flagship``: the 124M-parameter LM at batch 8 x seq 1024 with the fused
   cross-entropy, through ``edl_tpu_torch.train_lm``'s trainer: 2 warm-up
   steps and 10 timed steps on a fixed batch; tokens/s, MFU and peak memory;
   the kernels' launch counters must equal 12 per step each.
5. ``resume``: save at an epoch's end, drop the trainer, restore a new one
   with ``restore_or_create`` and check that step, epoch and the next loss
   continue the uninterrupted run.

It then prints the card's ``nvidia-smi`` name and power limit, one line
``{"kernels": [...]}``, and, last, ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time

PHASES = ("build", "kernels", "parity", "flagship", "resume")

# card peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor cores, f32
# outside them, and HBM bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP_SHAPE = (8, 1024, 6, 128)     # [B, L, H, D]
RAGGED_SHAPES = ((2, 200, 4, 64), (1, 77, 2, 128), (1, 17, 2, 64))
REL_TOL = 1e-2                          # ||kernel - plain|| / ||plain||

SOURCE = "edl_tpu_torch/csrc/attention.cu"
SPLASH = "edl_tpu/ops/attention.py:112 -> jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py"
KERNELS = {
    # wrapper name -> (kernel name, TPU code it replaces)
    "attention_fwd": ("edl_attn_fwd", f"{SPLASH}:1137"),
    "attention_bwd_delta": ("edl_attn_bwd_delta", f"{SPLASH}:2285"),
    "attention_bwd_dkdv": ("edl_attn_bwd_dkdv", f"{SPLASH}:2196"),
    "attention_bwd_dq": ("edl_attn_bwd_dq", f"{SPLASH}:1635"),
}


def log(phase: str, **nums) -> None:
    print(f"[{phase}] " + json.dumps(nums, sort_keys=True), flush=True)


def kernel_times(fn, reps: int) -> list[tuple[float, str, int]]:
    """``(device µs, kernel name, launches)`` of every kernel that ``reps``
    calls of ``fn()`` launch, longest first (``torch.profiler``).  A user
    annotation on the device timeline (the optimizer's ``Optimizer.step#...``)
    spans kernels that are counted already and is left out."""
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
                   and not ev.key.startswith("Optimizer.")), reverse=True)


def device_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms: the summed time of the kernels it
    launches, so the host's launch overhead between calls, which exceeds the
    shortest kernels' run time, does not count."""
    for _ in range(warmup):
        fn()
    return sum(us for us, _, _ in kernel_times(fn, reps)) / reps / 1e3


def rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


# -- phase 1 ---------------------------------------------------------------------

def phase_build(ctx) -> None:
    from edl_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(extra_flags=["-Xptxas", "-v"])
    for name, out in logs.items():
        for line in out.splitlines():
            if any(tag in line for tag in ("Compiling entry", "registers", "spill", "error")):
                print(f"[build] {name}: {line.strip()}", flush=True)
    log("build", seconds=time.perf_counter() - t0, libraries=sorted(logs))


# -- phase 2 ---------------------------------------------------------------------

def _attention_work(B, L, H, D) -> dict:
    """Operations and bytes each kernel needs at this shape: the causal
    pairs (k <= q) are what the data needs; each input read once, each
    output written once."""
    pairs = B * H * L * (L + 1) // 2
    t = B * L * H * D * 2            # one bf16 [B, L, H, D] tensor
    s = B * H * L * 4                # one f32 [B, H, L] statistic
    return {
        "attention_fwd": (4 * pairs * D, PEAK_BF16_FLOPS, 4 * t + s),
        "attention_bwd_delta": (2 * B * L * H * D, PEAK_F32_FLOPS, 2 * t + s),
        "attention_bwd_dkdv": (8 * pairs * D, PEAK_BF16_FLOPS, 6 * t + 2 * s),
        "attention_bwd_dq": (6 * pairs * D, PEAK_BF16_FLOPS, 5 * t + 2 * s),
    }


def _bound(ops, peak, nbytes):
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _inputs(shape, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    return q, k, v, do


def check_kernels(shape, seed, timed: bool) -> dict:
    """Each kernel against its plain version at ``shape``; with ``timed``,
    also the times and bounds.  Returns per-wrapper numbers."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import attention as A

    q, k, v, do = _inputs(shape, seed)
    B, L, H, D = shape
    scale = D ** -0.5
    o, lse = A.attention_fwd(q, k, v, scale)
    o_p, lse_p = A.attention_fwd_plain(q, k, v, scale)
    delta = A.attention_bwd_delta(o, do)
    delta_p = A.attention_bwd_delta_plain(o, do)
    dk, dv = A.attention_bwd_dkdv(q, k, v, do, lse, delta, scale)
    dk_p, dv_p = A.attention_bwd_dkdv_plain(q, k, v, do, lse, delta, scale)
    dq = A.attention_bwd_dq(q, k, v, do, lse, delta, scale)
    dq_p = A.attention_bwd_dq_plain(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    pairs = {
        "attention_fwd": [(o, o_p), (lse, lse_p)],
        "attention_bwd_delta": [(delta, delta_p)],
        "attention_bwd_dkdv": [(dk, dk_p), (dv, dv_p)],
        "attention_bwd_dq": [(dq, dq_p)],
    }
    out = {}
    for name, outs in pairs.items():
        errs = [rel_err(a, b) for a, b in outs]
        finite = all(bool(torch.isfinite(a).all()) for a, _ in outs)
        out[name] = {"rel_err": max(errs), "max_abs_err": max(max_abs(a, b) for a, b in outs),
                     "finite": finite}
        if not finite or max(errs) > REL_TOL:
            raise AssertionError(f"{name} at {shape}: rel err {errs} (tol {REL_TOL}), "
                                 f"finite={finite}")
    # the autograd function end to end against dense attention's autograd
    qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
    ya = A.SplashAttention.apply(qa, ka, va, scale)
    ga = torch.autograd.grad(ya, (qa, ka, va), do)
    qd, kd, vd = (t.detach().float().requires_grad_() for t in (q, k, v))
    yd = A.dense_attention(qd, kd, vd, causal=True)
    gd = torch.autograd.grad(yd, (qd, kd, vd), do.float())
    e2e = [rel_err(ya, yd)] + [rel_err(a, b) for a, b in zip(ga, gd)]
    if max(e2e) > REL_TOL:
        raise AssertionError(f"autograd vs dense at {shape}: rel errs {e2e}")
    out["autograd_vs_dense_rel_err"] = max(e2e)
    if not timed:
        return out

    work = _attention_work(*shape)
    fns = {
        "attention_fwd": (lambda: A.attention_fwd(q, k, v, scale),
                          lambda: A.attention_fwd_plain(q, k, v, scale)),
        "attention_bwd_delta": (lambda: A.attention_bwd_delta(o, do),
                                lambda: A.attention_bwd_delta_plain(o, do)),
        "attention_bwd_dkdv": (lambda: A.attention_bwd_dkdv(q, k, v, do, lse, delta, scale),
                               lambda: A.attention_bwd_dkdv_plain(q, k, v, do, lse, delta, scale)),
        "attention_bwd_dq": (lambda: A.attention_bwd_dq(q, k, v, do, lse, delta, scale),
                             lambda: A.attention_bwd_dq_plain(q, k, v, do, lse, delta, scale)),
    }
    # the library yardstick: PyTorch's fused attention, forward and backward
    # (its backward computes dq, dk and dv in one call)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    yt = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_bwd = device_ms(lambda: torch.autograd.grad(yt, (qt, kt, vt), dot, retain_graph=True))
    library = {"attention_fwd": lib_fwd, "attention_bwd_delta": None,
               "attention_bwd_dkdv": lib_bwd, "attention_bwd_dq": lib_bwd}
    for name, (kernel_fn, plain_fn) in fns.items():
        bound, by = _bound(*work[name])
        out[name].update(ms=device_ms(kernel_fn), plain_ms=device_ms(plain_fn, reps=5),
                         library_ms=library[name], bound_ms=bound, bound_by=by)
    return out


def phase_kernels(ctx) -> None:
    import torch
    for i, shape in enumerate(RAGGED_SHAPES):
        res = check_kernels(shape, seed=10 + i, timed=False)
        log("kernels", shape=list(shape), **{n: r for n, r in res.items()})
    res = check_kernels(FLAGSHIP_SHAPE, seed=1, timed=True)
    for name, r in res.items():
        if name in KERNELS:
            log("kernels", shape=list(FLAGSHIP_SHAPE), kernel=name, **r)
    log("kernels", shape=list(FLAGSHIP_SHAPE),
        autograd_vs_dense_rel_err=res["autograd_vs_dense_rel_err"])
    ctx["kernels"] = res
    torch.cuda.synchronize()


# -- phase 3 ---------------------------------------------------------------------

PARITY_LOSS_RTOL = 2e-2    # bf16 compute rounds to ~0.4% at every layer output
PARITY_GRAD_RTOL = 5e-2    # per-parameter gradient norms, same reason


def phase_parity(ctx) -> None:
    """One training step of a 2-layer bf16 config on the card (kernels) and
    on the CPU (plain path), from the same weights and the same batch."""
    import numpy as np
    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from edl_tpu_torch.ops import attention as A
    from edl_tpu_torch.train.state import adamw
    from edl_tpu_torch.train.trainer import ElasticTrainer

    cfg = TransformerConfig(vocab_size=1000, num_layers=2, embed_dim=256, num_heads=2,
                            mlp_dim=512, max_len=256, dtype=torch.bfloat16, remat=False)
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
    log("parity", loss_card=loss_c, loss_cpu=loss_h, loss_rel=loss_rel,
        grad_norm_max_rel=grad_rel, launches_card=n_c, launches_cpu=n_h,
        loss_rtol=PARITY_LOSS_RTOL, grad_rtol=PARITY_GRAD_RTOL)
    if not (math.isfinite(loss_c) and loss_rel <= PARITY_LOSS_RTOL
            and grad_rel <= PARITY_GRAD_RTOL):
        raise AssertionError("card and CPU disagree on the 2-layer step")
    if min(n_c.values()) != cfg.num_layers or max(n_h.values()) != 0:
        raise AssertionError(f"the card step must launch every kernel once per layer "
                             f"and the CPU step none: {n_c} / {n_h}")


# -- phase 4 ---------------------------------------------------------------------

FLAGSHIP_ARGS = ["--layers", "12", "--embed", "768", "--heads", "6", "--mlp", "3072",
                 "--vocab", "32000", "--seq_len", "1024", "--batch_size", "8",
                 "--fused_ce", "--lr", "3e-4"]
WARMUP_STEPS, TIMED_STEPS = 2, 10


def phase_flagship(ctx) -> None:
    """The 124M LM through train_lm's trainer on a fixed batch."""
    import numpy as np
    import torch

    from edl_tpu_torch import train_lm
    from edl_tpu_torch.models.transformer import param_count
    from edl_tpu_torch.obs.flops import analytic_lm_flops_per_token, peak_tflops
    from edl_tpu_torch.ops import attention as A

    args = train_lm.parse_args(FLAGSHIP_ARGS)
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
    log("flagship", params=param_count(cfg), remat=cfg.remat, dtype=str(cfg.dtype),
        steps=TIMED_STEPS, step_ms=dt / TIMED_STEPS * 1e3, tokens_per_s=tok_s,
        tflops=tok_s * flops_tok / 1e12,
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
    want = cfg.num_layers * TIMED_STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launch counts {launches} != {want} (12 layers x {TIMED_STEPS} steps)")
    ctx["launches"] = launches

    # where the step's device time goes, by kernel, over two steps
    rows = kernel_times(lambda: trainer.step_fn(state, batch, gen), reps=2)
    total = sum(r[0] for r in rows)
    groups: dict[str, float] = {}
    for us, key, _ in rows:
        groups[_kernel_group(key)] = groups.get(_kernel_group(key), 0.0) + us / 2 / 1e3
    log("flagship_profile", device_busy_ms_per_step=total / 2 / 1e3,
        wall_ms_per_step=dt / TIMED_STEPS * 1e3, ms_per_step_by_group=groups)
    for rank, (us, key, count) in enumerate(rows):
        if rank < 15 or "attn_" in key:
            log("flagship_profile", kernel=key[:100], ms_per_step=us / 2 / 1e3,
                share=us / total, calls_per_step=count / 2)
    A.reset_launch_counts()


def _kernel_group(name: str) -> str:
    if "attn_" in name:
        return "attention (this repo's kernels)"
    if any(tag in name for tag in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "elementwise" in name or "reduce" in name:
        return "elementwise and reductions"
    return "other"


# -- phase 5 ---------------------------------------------------------------------

RESUME_RTOL = 1e-4   # the same card, deterministic kernels, a bit-exact restore


def phase_resume(ctx) -> None:
    """Stop at an epoch's end, restore into a new trainer, and continue:
    the next loss must match an uninterrupted run's."""
    import shutil
    from pathlib import Path

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
               "flagship": phase_flagship, "resume": phase_resume}
    for name in PHASES:
        if name in phases:
            t0 = time.perf_counter()
            runners[name](ctx)
            log(name, phase_seconds=time.perf_counter() - t0)

    kern = ctx.get("kernels", {})
    launches = ctx.get("launches", {})
    entries = []
    for wrapper, (kname, replaces) in KERNELS.items():
        r = kern.get(wrapper, {})
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches.get(wrapper), "max_abs_err": r.get("max_abs_err"),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms"),
        })
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
