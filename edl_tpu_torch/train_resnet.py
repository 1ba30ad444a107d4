"""Elastic collective ResNet training: the PyTorch port of
``examples/collective/train_resnet.py``.

    python -m edl_tpu_torch.train_resnet --data_dir /data/imagenet-rec \\
        --epochs 90 --batch_size 256

The same flags and defaults as the JAX example, plus ``--device`` (default
``cuda``; ``cpu`` only when asked): SGD with Nesterov momentum and coupled
L2 weight decay (``train/state.py:sgd``) on a cosine-warmup schedule whose
peak is scaled by the global batch (``base_lr * global_batch / 256``), a
label-smoothed cross-entropy, per-epoch eval and a benchmark record per
epoch kept in the checkpoint's ``State`` sidecar (so an elastic restart
keeps the records of earlier epochs), dumped by rank 0 with
``--bench_dump``.  Each rank reads its round-robin share of the
``train-*.rec`` files (``data/images.py:shard_files``), or, with
``--data_service`` (under the launcher: a store and a pod id), takes records
from the leader's data service (``data/elastic_input.py``): dynamic file
handout, a masked ragged epoch end, and exactly-once mid-epoch resume from
the checkpointed record spans; with ``--data_leader`` the service is the
job's standalone elected data leader (``data/leader.py``), journaled, so a
successor takes over mid-epoch.  On a masked batch the loss and top-1 are
the masked means of the global batch (every real record weighs the same,
whatever the ranks' shares) and, if any row of it is padding, the step keeps
the BN running stats as they were (the forward still normalises with batch
statistics that include the zero rows, as flax does).  In a world of two or
more, BN takes its statistics over the global batch, as the JAX mesh does
(``models/resnet.py``), so every rank holds the same running stats.  ``--remat``
recomputes the model's forward in the backward (``torch.utils.checkpoint``
over the whole forward, the unit ``jax.checkpoint`` wraps, so the peak
memory does not fall), the recomputation leaving the BN running stats
alone.  Compute is bf16 on the card and f32 on the CPU.
``--synthetic N`` first writes a learnable toy dataset of N classes (once,
whatever the number of racing processes; it needs ``cv2``).  Under the
elastic launcher one process runs per trainer, as with ``train_lm``.

``--dcn_dp`` builds ``MeshSpec(dcn_dp=...)``, as the JAX example does:
data-parallel replica groups across pods merged pod-major into ``dp``; a
rank's position on that axis picks its file shard and its batches' seed.

Not ported yet, each raising ``NotImplementedError``: ``--dgc`` (ROADMAP.md
Queue 1 item 7) and ``--profile_steps`` (item 8).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

MODELS = {
    "resnet18": "ResNet18", "resnet34": "ResNet34", "resnet50": "ResNet50",
    "resnet50vd": "ResNet50vd", "resnet101": "ResNet101", "resnet152": "ResNet152",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="elastic collective ResNet training")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate a toy dataset with N classes instead of reading --data_dir")
    p.add_argument("--synthetic_per_file", type=int, default=64)
    p.add_argument("--synthetic_files", type=int, default=4)
    p.add_argument("--model", type=str, default="resnet50", choices=sorted(MODELS))
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--batch_size", type=int, default=256, help="per process")
    p.add_argument("--base_lr", type=float, default=0.1)
    p.add_argument("--warmup_epochs", type=float, default=5.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--label_smoothing", type=float, default=0.1)
    p.add_argument("--remat", action="store_true",
                   help="recompute the whole forward in the backward (jax.checkpoint's unit; "
                        "the peak memory does not fall, the step is slower)")
    p.add_argument("--save_every_steps", type=int, default=0,
                   help="mid-epoch checkpoint cadence (0 = per-epoch only)")
    p.add_argument("--dgc", type=float, default=0.0, help="not ported")
    p.add_argument("--dgc_rampup_epochs", type=float, default=1.0)
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="cap steps per epoch (0 = full dataset)")
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--no-eval", dest="eval", action="store_false")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--bench_dump", type=str, default="",
                   help="write per-epoch benchmark JSON here")
    p.add_argument("--profile_steps", type=str, default="", help="not ported")
    p.add_argument("--profile_dir", type=str, default="")
    p.add_argument("--dcn_dp", type=int, default=0,
                   help="data-parallel replica groups across pods; 0 = auto (one group per pod)")
    p.add_argument("--data_service", action="store_true",
                   help="take records from the launcher's data service (needs the launcher)")
    p.add_argument("--data_leader", action="store_true",
                   help="with --data_service, take them from the job's standalone elected "
                        "data leader (python -m edl_tpu_torch.data.leader) instead")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    unported = [(args.dgc > 0, "--dgc", "item 7 (train/compress.py)"),
                (bool(args.profile_steps), "--profile_steps", "item 8 (obs/profile.py)")]
    for asked, flag, item in unported:
        if asked:
            raise NotImplementedError(f"{flag} is not ported to edl_tpu_torch yet "
                                      f"(ROADMAP.md Queue 1 {item})")
    return args


def _generate_synthetic_once(images, data_dir: str, args) -> str:
    """Generate the toy dataset into ``data_dir/synth`` exactly once across
    any number of racing processes: each generator writes its own temporary
    directory and renames it into place, and one rename wins.  An advisory
    O_EXCL lock only saves duplicate work."""
    import shutil

    os.makedirs(data_dir, exist_ok=True)
    final = os.path.join(data_dir, "synth")
    lock = os.path.join(data_dir, ".synth-lock")
    if not os.path.isdir(final):
        got_lock = False
        try:
            os.close(os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            got_lock = True
        except FileExistsError:
            deadline = time.monotonic() + 60
            while not os.path.isdir(final) and time.monotonic() < deadline:
                time.sleep(0.25)
        if not os.path.isdir(final):
            tmp = os.path.join(data_dir, f".synth-tmp-{os.getpid()}-{time.monotonic_ns()}")
            try:
                images.write_synthetic_imagenet(
                    tmp, n_files=args.synthetic_files, per_file=args.synthetic_per_file,
                    size=args.image_size, classes=args.synthetic, prefix="train")
                images.write_synthetic_imagenet(
                    tmp, n_files=1, per_file=args.synthetic_per_file, size=args.image_size,
                    classes=args.synthetic, seed=99, prefix="val")
                os.rename(tmp, final)
            except Exception:  # noqa: BLE001 — clean up, then re-raise below
                shutil.rmtree(tmp, ignore_errors=True)
                if not os.path.isdir(final):
                    # a failed generator drops its lock, or every later cold
                    # start waits out the deadline before generating
                    if got_lock:
                        try:
                            os.unlink(lock)
                        except FileNotFoundError:
                            pass
                    raise  # not a lost race: surface the real error
    if os.path.isdir(final):
        # once published, any process clears the lock (a killed holder's too)
        try:
            os.unlink(lock)
        except FileNotFoundError:
            pass
    return final


def make_loss_fn(args):
    """``loss_fn(model, extra, batch, gen)``: the label-smoothed CE of the
    model's logits (``optax.smooth_labels`` then softmax CE is
    ``F.cross_entropy(label_smoothing=...)``) and the batch's top-1.  A
    uint8 image batch is BGR, normalised on the device.  The BN running
    stats are module buffers, so no extra state is threaded.

    A batch with a ``mask`` (the data service's ragged epoch end, zero-padded)
    gives the masked means of the global batch, as the JAX example's loss on
    its sharded batch does: in a world each rank's loss is
    ``sum(ce * mask) * world / max(n, 1)``, ``n`` the real rows of every
    rank, so the trainer's world mean of losses and gradients weighs every
    real record ``1 / n`` whatever the ranks' shares (a rank with none adds
    nothing), and top-1 is the global masked top-1 on every rank.  If any
    rank's share holds padding, every rank's forward leaves the BN running
    stats as they were.  The real rows, the padded shares and the hits are
    summed by all-reduces on the mask's device, and the gate is a device
    tensor (``models/resnet.py:ResNet.stat_gate``), so the step does not wait
    for the card.  With ``--remat`` the forward is recomputed in the
    backward, the recomputation with the stats' update off."""
    import torch.distributed as dist
    from torch.utils.checkpoint import checkpoint

    from edl_tpu_torch.data.images import device_normalize

    def forward(model, x):
        if not args.remat:
            return model(x)
        return checkpoint(model, x, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), model.stat_gate(0.0)))

    def loss_fn(model, extra, batch, gen):
        x, labels = batch["image"], batch["label"].long()
        if x.dtype == torch.uint8:
            x = device_normalize(x)
        mask = batch.get("mask")
        if mask is None:
            logits = forward(model, x)
            loss = F.cross_entropy(logits, labels, label_smoothing=args.label_smoothing)
            top1 = (logits.argmax(-1) == labels).float().mean()
            return loss, (None, {"top1": top1})
        world = dist.get_world_size() if dist.is_initialized() else 1
        # [real rows, shares holding padding], summed over the world
        facts = torch.stack([mask.sum(), (mask.min() < 1).to(mask.dtype)])
        if world > 1:
            dist.all_reduce(facts)
        n = facts[0].clamp_min(1.0)
        with model.stat_gate((facts[1] == 0).float()):
            logits = forward(model, x)
        ce = F.cross_entropy(logits, labels, label_smoothing=args.label_smoothing,
                             reduction="none")
        hits = ((logits.argmax(-1) == labels).to(mask.dtype) * mask).sum()
        if world > 1:
            dist.all_reduce(hits)
        return (ce * mask).sum() * world / n, (None, {"top1": hits / n})

    return loss_fn


def metric_fn(model, extra, batch):
    """Per-example ``val_loss`` (plain CE) and ``val_top1``."""
    labels = batch["label"].long()
    logits = model(batch["image"])
    return {"val_loss": F.cross_entropy(logits, labels, reduction="none"),
            "val_top1": (logits.argmax(-1) == labels).float()}


def build_trainer(args, device: torch.device, steps_per_epoch: int = 1,
                  checkpoint_dir: str = "", store=None, tenv=None):
    """``(init_fn, trainer, tx, lr)`` for ``args`` on ``device``: the global
    batch is ``--batch_size`` times the formed world's size, and the
    schedule spans ``--epochs`` of ``steps_per_epoch``."""
    import torch.distributed as dist

    from edl_tpu_torch.models import resnet
    from edl_tpu_torch.parallel.mesh import MeshSpec
    from edl_tpu_torch.train.lr import cosine_warmup, scale_lr_for_batch
    from edl_tpu_torch.train.state import sgd
    from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    world = dist.get_world_size() if dist.is_initialized() else 1
    global_batch = args.batch_size * world
    lr = scale_lr_for_batch(args.base_lr, global_batch, base_batch=256)
    schedule = cosine_warmup(lr, total_steps=args.epochs * steps_per_epoch,
                             warmup_steps=int(args.warmup_epochs * steps_per_epoch))
    tx = sgd(schedule, momentum=args.momentum, nesterov=True, weight_decay=args.weight_decay)
    trainer = ElasticTrainer(
        make_loss_fn(args),
        TrainConfig(checkpoint_dir=checkpoint_dir, save_every_steps=args.save_every_steps,
                    global_batch_size=global_batch, log_every=50,
                    mesh_spec=MeshSpec(dcn_dp=args.dcn_dp)),
        store=store, tenv=tenv, device=device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model_cls = getattr(resnet, MODELS[args.model])

    def init_fn():
        return model_cls(num_classes=args.num_classes, width=args.width, dtype=dtype,
                         generator=torch.Generator().manual_seed(0)), None

    return init_fn, trainer, tx, lr


def main(argv=None):
    """Train; returns the final ``(TrainState, State)``."""
    from edl_tpu_torch.cluster.env import TrainerEnv
    from edl_tpu_torch.train.distributed import connect_store, initialize_from_env, shutdown
    from edl_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    tenv = initialize_from_env(TrainerEnv(), device)
    if device.type == "cuda" and tenv.world_size > 1:
        device = torch.device("cuda", torch.cuda.current_device())  # bound to this rank
    store = connect_store(tenv)
    try:
        return train(args, device, tenv, store)
    finally:
        if store is not None:
            store.close()
        shutdown()


def _data_service_input(args, tenv, store, train_files):
    """``(ElasticInput, decode pool, decode stats)`` for ``--data_service``,
    as the JAX example builds it: records from ``RecordioSplitter``, decoded
    by a thread pool with one augmentation RNG a batch slot.  The stats dict
    sums ``images`` decoded and the ``seconds`` the decodes took (wall)."""
    from concurrent.futures import ThreadPoolExecutor

    from edl_tpu_torch.data import images
    from edl_tpu_torch.data.dataset import RecordioSplitter
    from edl_tpu_torch.data.elastic_input import ElasticInput

    if store is None or not tenv.pod_id:
        raise SystemExit("--data_service needs the elastic launcher's store and pod id")
    decode_pool = ThreadPoolExecutor(args.num_workers, thread_name_prefix="decode")
    decode_rngs = [np.random.default_rng((7, i)) for i in range(args.batch_size)]
    stats = {"images": 0, "seconds": 0.0}

    def assemble(records: list) -> dict:
        if not records:
            return {"image": np.zeros((0, args.image_size, args.image_size, 3), np.float32),
                    "label": np.zeros((0,), np.int32)}
        t0 = time.perf_counter()
        decoded = list(decode_pool.map(
            lambda ir: images.decode_train(ir[1], args.image_size,
                                           decode_rngs[ir[0] % args.batch_size]),
            enumerate(records)))
        stats["seconds"] += time.perf_counter() - t0
        stats["images"] += len(records)
        return {"image": np.stack([d[0] for d in decoded]),
                "label": np.asarray([d[1] for d in decoded], np.int32)}

    leader = None
    if args.data_leader:
        from edl_tpu_torch.data.leader import resolve_data_leader
        leader = lambda: resolve_data_leader(store, tenv.job_id)  # noqa: E731
    ei = ElasticInput(store, tenv.job_id, tenv.pod_id, "imagenet", train_files,
                      args.batch_size, RecordioSplitter(), assemble,
                      distributed=tenv.world_size > 1, leader=leader)
    return ei, decode_pool, stats


def train(args, device, tenv, store):
    """The training run of ``main`` on a formed world: ``tenv`` (the
    launcher's env), ``store`` (the coordination store, or None); returns
    ``(TrainState, State)``."""
    from edl_tpu_torch.data import images
    from edl_tpu_torch.parallel import mesh as mesh_mod

    rank = tenv.global_rank
    world = max(1, tenv.world_size)
    # the rank's position on the mesh's data axis (pod-major with --dcn_dp):
    # its file shard and its batches' seed
    pods = mesh_mod.pod_ranks() if world > 1 else [0]
    data_rank = mesh_mod.data_index(
        mesh_mod.world_layout(mesh_mod.MeshSpec(dcn_dp=args.dcn_dp), pods), rank)
    if args.synthetic:
        data_dir = args.data_dir or os.path.join(os.environ.get("TMPDIR", "/tmp"), "edl-synth")
        data_dir = _generate_synthetic_once(images, data_dir, args)
        args.num_classes = args.synthetic
    else:
        data_dir = args.data_dir
        if not data_dir:
            raise SystemExit("--data_dir or --synthetic required")
    train_files = sorted(glob.glob(os.path.join(data_dir, "train-*.rec")))
    val_files = sorted(glob.glob(os.path.join(data_dir, "val-*.rec")))
    if not train_files:
        raise SystemExit(f"no train-*.rec under {data_dir}")
    my_files = images.shard_files(train_files, data_rank, world)
    per_file = (args.synthetic_per_file if args.synthetic
                else 1281167 // max(1, len(train_files)))
    steps_per_epoch = (args.steps_per_epoch
                       or max(1, len(my_files) * per_file // args.batch_size))

    init_fn, trainer, tx, lr = build_trainer(args, device, steps_per_epoch,
                                             tenv.checkpoint_dir, store, tenv)
    global_batch = trainer.cfg.global_batch_size
    trainer.adjust.register(lambda old, new, st: print(
        f"[adjust] world {old} -> {new}; lr now {lr:.4f}", flush=True))
    state, meta = trainer.restore_or_create(init_fn, tx)
    resumed_spans = sum(r.end - r.begin for r in meta.data_checkpoint.processed)
    print(f"[train_resnet] {args.model} rank={rank}/{world} data_rank={data_rank} device={device} "
          f"resume_epoch={meta.next_epoch} in_epoch={meta.in_epoch} "
          f"resumed_spans={resumed_spans} lr={lr:.4f} steps/epoch={steps_per_epoch} "
          f"files={len(my_files)}", flush=True)
    step_sleep = float(os.environ.get("EDL_TPU_DEMO_STEP_SLEEP", "0"))
    ei = decode_pool = decode = None
    if args.data_service:
        ei, decode_pool, decode = _data_service_input(args, tenv, store, train_files)

    def data_fn(epoch: int):
        if ei is not None:
            # the generation is seeded from the data checkpoint: a mid-epoch
            # resume trains only the records it lacks
            it = ei.epoch(epoch, meta.data_checkpoint)
        else:
            it = iter(images.ImageBatches(my_files, args.batch_size, image_size=args.image_size,
                                          train=True, seed=1000 * epoch + data_rank,
                                          num_workers=args.num_workers))
        for i, batch in enumerate(it):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                it.close()
                break
            if step_sleep:  # launcher tests pace the run so a kill lands mid-epoch
                time.sleep(step_sleep)
            yield batch

    seen = dict(trainer.input_stats)

    def on_epoch_end(epoch, st, meta_):
        attr = meta_.epoch_attr(epoch)
        n_img = (attr.step_num if attr else 0) * global_batch
        sec = (attr.step_num * attr.avg_step_time) if attr else 0.0
        record = {"epoch": epoch, "sec": round(sec, 2), "img_s": round(n_img / max(sec, 1e-9), 1)}
        # this segment's time blocked on the input, and on the staged copy
        for key in ("input_wait_s", "h2d_wait_s"):
            record[key] = round(trainer.input_stats[key] - seen[key], 4)
        seen.update(trainer.input_stats)
        if decode is not None and decode["seconds"]:
            record["decode_img_s"] = round(decode["images"] / decode["seconds"], 1)
        if args.eval and val_files:
            record.update({k: round(v, 4) for k, v in trainer.evaluate(
                st, images.ImageBatches(val_files, args.batch_size, image_size=args.image_size,
                                        train=False, num_workers=args.num_workers,
                                        drop_remainder=False),
                metric_fn).items()})
        # kept in the sidecar, so a restart's dump holds the earlier epochs
        records = meta_.user_defined.setdefault("bench", [])
        records[:] = [r for r in records if r["epoch"] != epoch] + [record]
        print(f"[train_resnet] {json.dumps(record)}", flush=True)

    try:
        state, meta = trainer.fit(state, meta, data_fn, epochs=args.epochs,
                                  on_epoch_end=on_epoch_end)
    finally:
        if ei is not None:
            ei.stop()
            decode_pool.shutdown()
    bench = sorted(meta.user_defined.get("bench", []), key=lambda r: r["epoch"])
    total = sum(r["sec"] for r in bench)
    if args.bench_dump and rank == 0:
        with open(args.bench_dump, "w") as f:
            json.dump({"model": args.model, "global_batch": global_batch, "world": world,
                       "total_sec": round(total, 2), "epochs": bench}, f, indent=1)
    marker = os.environ.get("EDL_TPU_DEMO_MARKER")
    if marker:
        with open(marker, "a") as f:
            f.write(f"done rank={rank} world={world} "
                    f"epochs={sorted(e.epoch_no for e in meta.epochs)} "
                    f"last={json.dumps(bench[-1] if bench else {})}\n")
    return state, meta


if __name__ == "__main__":
    main()
