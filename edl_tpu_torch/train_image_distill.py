"""Image-scale service distillation: the PyTorch port of
``examples/distill/train_image_distill.py``.

Reference: example/distill/resnet/train_with_fleet.py (~690) +
models/resnet_vd.py:306, a ResNet_vd student trained with
``--use_distill_service``: every batch is streamed to a fleet of teacher
servers and the loss mixes the hard-label cross-entropy with the soft-label
one against the teacher's temperature-softened softmax.  Here the student
is the port's ResNet-vd (``models/resnet.py``), the teachers are
``TeacherServer``\\ s over ``module_teacher`` found through the discovery
service (``distill/discovery.py``), and the student runs under the elastic
launcher, one process a trainer.

Roles::

    # 1. train a teacher on the (clean) synthetic recordio set
    python -m edl_tpu_torch.train_image_distill --role teacher_train --teacher_dir /ckpt/t

    # 2. serve it, registered for discovery (one a card)
    python -m edl_tpu_torch.train_image_distill --role serve --teacher_dir /ckpt/t \\
        --coord_endpoints $COORD --service image-teacher

    # 3. elastic student under the launcher (soft labels from the fleet)
    python -m edl_tpu.collective.launch --job_id distill --nodes_range 1:4 \\
        edl_tpu_torch/train_image_distill.py -- --role student --discovery $DISC \\
        --service image-teacher

    # the whole flow in one process: teacher -> 2-server fleet -> student
    # against the label-only baseline
    python -m edl_tpu_torch.train_image_distill --role local --device cpu

The same flags and defaults as the JAX example, plus ``--device`` (default
``cuda``; ``cpu`` only when asked).  Both students train with the example's
``optax.sgd(base_lr, momentum=0.9)``: a constant LR, plain momentum, no
weight decay (``train/state.py:sgd(lr, 0.9, nesterov=False)``), on
``alpha * CE(logits, label) + (1 - alpha) * T² * CE(logits / T,
softmax(teacher / T))`` with no label smoothing.  The student's labels carry
asymmetric noise (a flipped label moves to the next class), so past 50% the
plurality label is wrong and only the teacher's soft labels rescue the
student.  Compute is bf16 on the card and f32 on the CPU.  ``MODELS`` also
names ResNet101 and ResNet152 (both packages define them), so a teacher may
be either.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="image-scale service distillation")
    p.add_argument("--role", default="local",
                   choices=["teacher_train", "serve", "student", "local"])
    p.add_argument("--teacher_dir", default="/tmp/edl-image-teacher")
    p.add_argument("--coord_endpoints", default="")
    p.add_argument("--service", default="image-teacher")
    p.add_argument("--discovery", default="")
    p.add_argument("--teachers", default="",
                   help="fixed teacher endpoints (skip discovery)")
    p.add_argument("--data_dir", default="/tmp/edl-image-distill-data")
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--per_file", type=int, default=48)
    p.add_argument("--n_files", type=int, default=4)
    p.add_argument("--label_noise", type=float, default=0.65)
    p.add_argument("--teacher_model", default="resnet18")
    p.add_argument("--student_model", default="resnet18vd")
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--teacher_epochs", type=int, default=10)
    p.add_argument("--student_epochs", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--teacher_batch_size", type=int, default=16)
    p.add_argument("--base_lr", type=float, default=0.05)
    p.add_argument("--alpha", type=float, default=0.05,
                   help="hard-label weight; 1-alpha goes to the teacher")
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--out", default="", help="write summary JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


MODELS = {"resnet18": "ResNet18", "resnet18vd": "ResNet18vd",
          "resnet34": "ResNet34", "resnet50": "ResNet50",
          "resnet50vd": "ResNet50vd", "resnet101": "ResNet101",
          "resnet152": "ResNet152"}


def make_model(name: str, args, device: torch.device, seed: int = 0):
    """The named ResNet at ``args``' classes and width, its weights drawn
    from ``seed``, on ``device``: bf16 compute on the card, f32 on the CPU
    (as the JAX example computes bf16 on a TPU only)."""
    from edl_tpu_torch.models import resnet as resnet_mod
    cls_name = MODELS[name]
    if not hasattr(resnet_mod, cls_name):  # vd stem fallback for small nets
        cls_name = MODELS[name.replace("vd", "")]
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = getattr(resnet_mod, cls_name)(num_classes=args.classes, width=args.width,
                                          dtype=dtype,
                                          generator=torch.Generator().manual_seed(seed))
    return model.to(device)


# -- data ---------------------------------------------------------------------
def ensure_data(args) -> tuple[list[str], list[str]]:
    """Synthetic recordio shards (``data/images.py``'s task; writing them
    needs ``cv2``): train-*.rec carry clean labels; the student flips a
    fraction at read time."""
    from edl_tpu_torch.data import images

    train = sorted(glob.glob(os.path.join(args.data_dir, "train-*.rec")))
    val = sorted(glob.glob(os.path.join(args.data_dir, "val-*.rec")))
    if len(train) >= args.n_files and val:
        return train[:args.n_files], val
    train = images.write_synthetic_imagenet(
        args.data_dir, n_files=args.n_files, per_file=args.per_file,
        size=args.image_size, classes=args.classes, prefix="train")
    val = images.write_synthetic_imagenet(
        args.data_dir, n_files=1, per_file=args.per_file,
        size=args.image_size, classes=args.classes, seed=99, prefix="val")
    return train, val


def image_batches(args, paths, seed, noise=0.0, rank=0):
    """Decoded train batches; optional deterministic label noise (the
    student's handicap, which the teacher never saw).  The noise is
    asymmetric (a flipped label moves to the next class), so past 50% the
    plurality label is wrong and a label-only baseline learns the wrong
    mapping: only the teacher's clean soft labels can rescue the student."""
    from edl_tpu_torch.data import images

    for b in images.ImageBatches(paths, args.batch_size,
                                 image_size=args.image_size, train=True,
                                 seed=seed, num_workers=2):
        if noise > 0:
            rng = np.random.default_rng(
                (seed, int(b["label"][0]), len(b["label"]), rank))
            flip = rng.random(len(b["label"])) < noise
            noisy = b["label"].copy()
            noisy[flip] = (noisy[flip] + 1) % args.classes
            b = dict(b, label=noisy)
        yield b


def _optimizer(args):
    """The example's ``optax.sgd(base_lr, momentum=0.9)``."""
    from edl_tpu_torch.train.state import sgd
    return sgd(args.base_lr, momentum=0.9, nesterov=False, weight_decay=0.0)


# -- teacher ------------------------------------------------------------------
def train_teacher(args, train_files, device: torch.device, data_fn=None):
    """``(module, TrainState)`` of the teacher after ``--teacher_epochs`` on
    the clean labels (plain cross-entropy).  ``data_fn(epoch)`` yields the
    host batches; by default the recordio stream of ``train_files``."""
    from edl_tpu_torch.cluster.state import State
    from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    def loss_fn(model, extra, batch, gen):
        logits = model(batch["image"])
        return F.cross_entropy(logits, batch["label"].long()), (None, {})

    tr = ElasticTrainer(loss_fn, TrainConfig(log_every=0), device=device)
    state = tr.create_state(lambda: (make_model(args.teacher_model, args, device), None),
                            _optimizer(args))
    data_fn = data_fn or (lambda e: image_batches(args, train_files, 10 + e))
    state, _ = tr.fit(state, State(), data_fn, epochs=args.teacher_epochs)
    return state.model, state


def save_teacher(args, state) -> None:
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    CheckpointManager(args.teacher_dir, max_to_keep=1).save(0, state, force=True)


def load_teacher(args, device: torch.device):
    """``(module, TrainState)`` restored from ``--teacher_dir``."""
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.train.state import TrainState

    state = TrainState.create(make_model(args.teacher_model, args, device), _optimizer(args))
    restored = CheckpointManager(args.teacher_dir, max_to_keep=1).restore(state)
    if restored is None:
        raise FileNotFoundError(f"no teacher checkpoint in {args.teacher_dir}")
    return restored[0].model, restored[0]


def serve_teacher(args, store, device: torch.device, model=None, block=True):
    """A ``TeacherServer`` over ``module_teacher(model)`` on ``device``,
    registered under ``--service``; ``block`` serves until SIGTERM."""
    from edl_tpu_torch.distill.teacher import TeacherServer, module_teacher

    if model is None:
        model, _ = load_teacher(args, device)
    predict = module_teacher(model, fetch_name="logits", device=device)
    server = TeacherServer(predict, device=device).register(store, args.service)
    if block:  # pragma: no cover - CLI path
        print(f"[image-distill] serving on {server.endpoint}", flush=True)
        ev = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: ev.set())
        try:
            ev.wait()
        finally:
            print("[image-distill] teacher stats:",
                  json.dumps(server.stats()), flush=True)
            server.stop()
    return server


@torch.no_grad()
def eval_model(args, model, val_files, device: torch.device) -> float:
    """Top-1 of ``model`` (eval mode) over the validation files."""
    from edl_tpu_torch.data import images as images_mod

    was_training = model.training
    model.eval()
    hits = total = 0
    try:
        for b in images_mod.ImageBatches(val_files, args.batch_size,
                                         image_size=args.image_size, train=False,
                                         num_workers=2, drop_remainder=False):
            pred = model(torch.from_numpy(b["image"]).to(device)).argmax(-1).cpu().numpy()
            hits += int((pred == b["label"]).sum())
            total += len(b["label"])
    finally:
        model.train(was_training)
    return hits / max(1, total)


# -- student ------------------------------------------------------------------
_DEBUG_TEACHER = None  # the teacher module: set by the local role for EDL_TPU_DISTILL_VERIFY


def make_distill_source(args, train_files, rank=0, source=None, servers_fn=None,
                        wrap_reader=None):
    """``build(epoch)``: a DistillReader over the noisy image stream, so every
    batch gains the teacher fleet's logits (reference DistillReader(['image',
    'label'], predicts=['score']), resnet/train_with_fleet.py).  ``source(
    epoch)`` yields the host batches (``image``, ``label``) to distil; by
    default ``image_batches`` of ``train_files`` with the label noise.  The
    teachers are ``--teachers``, else ``servers_fn`` (a callable of the
    current endpoints, e.g. ``DistillFleet.endpoints_fn()``), else the
    discovery service.  ``wrap_reader(reader)``, when given, is read instead
    of the configured reader (e.g. a ``StudentFeed`` publishing the backlog).
    Under ``EDL_TPU_DISTILL_VERIFY`` (with ``_DEBUG_TEACHER`` set) every
    batch's logits are held to the teacher's own forward on its images."""
    from edl_tpu_torch.distill.reader import DistillReader

    verify = (os.environ.get("EDL_TPU_DISTILL_VERIFY", "0")
              not in ("", "0")) and _DEBUG_TEACHER is not None

    def build(epoch):
        dr = DistillReader(ins=["image", "label"], predicts=["logits"],
                           feeds=["image"],
                           teacher_batch_size=args.teacher_batch_size)
        if args.teachers:
            dr.set_fixed_teacher(*args.teachers.split(","))
        elif servers_fn is not None:
            dr.set_servers_fn(servers_fn)
        else:
            dr.set_dynamic_teacher(args.discovery, args.service)

        def gen():
            batches = (source(epoch) if source is not None else
                       image_batches(args, train_files, 100 + epoch,
                                     noise=args.label_noise, rank=rank))
            for b in batches:
                yield b["image"], b["label"]
        dr.set_batch_generator(gen)
        for image, label, logits in (dr if wrap_reader is None else wrap_reader(dr)):
            if verify:  # the pairing audit: the logits must be of these images
                tmodel = _DEBUG_TEACHER
                dev = next(tmodel.parameters()).device
                with torch.inference_mode():
                    want = tmodel.eval()(torch.from_numpy(np.asarray(image)).to(dev))
                # the tolerance covers low-precision compute (the reduction
                # order varies with the server's bucketing); a pairing bug
                # shows class-level errors orders of magnitude bigger
                err = float(np.abs(want.float().cpu().numpy() - np.asarray(logits)).max())
                if err > 1.0:
                    raise AssertionError(
                        f"teacher logits mispaired: max err {err}")
            yield {"image": np.asarray(image),
                   "label": np.asarray(label),
                   "teacher_logits": np.asarray(logits)}
    return build


def distill_loss(logits, labels, teacher_logits, alpha: float, temperature: float):
    """``alpha * CE(logits, labels) + (1 - alpha) * T² * CE(logits / T,
    softmax(teacher_logits / T))``, batch means; plain CE without a
    teacher.  No label smoothing."""
    hard = F.cross_entropy(logits, labels.long())
    if teacher_logits is None:
        return hard
    T = temperature
    soft = F.cross_entropy(logits / T, F.softmax(teacher_logits.float() / T, -1)) * (T * T)
    return alpha * hard + (1 - alpha) * soft


def make_student_loss_fn(args):
    """``loss_fn(model, extra, batch, gen)`` of the student: ``distill_loss``
    on the batch's ``teacher_logits`` when it has them, and top-1.  BN
    updates its running statistics as in ``train_resnet``."""
    def loss_fn(model, extra, batch, gen):
        logits = model(batch["image"])
        loss = distill_loss(logits, batch["label"], batch.get("teacher_logits"),
                            args.alpha, args.temperature)
        top1 = (logits.argmax(-1) == batch["label"].long()).float().mean()
        return loss, (None, {"top1": top1})
    return loss_fn


def train_student(args, train_files, val_files, device: torch.device,
                  distill_source=None, tenv=None, store=None, seed=1):
    """``(TrainState, val top-1, img/s)`` of the student after
    ``--student_epochs``: distilled through ``distill_source(epoch)`` (see
    :func:`make_distill_source`), else on the noisy labels alone.  Restores
    from and checkpoints to the launcher's checkpoint directory when
    ``tenv`` names one.  No ``val_files``: no eval (top-1 None)."""
    from edl_tpu_torch.cluster.state import State
    from edl_tpu_torch.data import images as images_mod
    from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig
    from edl_tpu_torch.train_resnet import metric_fn

    cfg = TrainConfig(log_every=0,
                      checkpoint_dir=(tenv.checkpoint_dir if tenv else ""))
    tr = ElasticTrainer(make_student_loss_fn(args), cfg, store=store, tenv=tenv,
                        device=device)

    def init():
        return make_model(args.student_model, args, device, seed=seed), None

    state, meta = (tr.restore_or_create(init, _optimizer(args)) if cfg.checkpoint_dir else
                   (tr.create_state(init, _optimizer(args)), State()))
    t0 = time.monotonic()
    n_img = [0]

    def data_fn(epoch):
        src = (distill_source(epoch) if distill_source is not None
               else image_batches(args, train_files, 100 + epoch,
                                  noise=args.label_noise))
        for b in src:
            n_img[0] += len(b["label"])
            yield b

    state, meta = tr.fit(state, meta, data_fn, epochs=args.student_epochs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    img_s = n_img[0] / max(1e-9, time.monotonic() - t0)
    top1 = None
    if val_files:
        top1 = tr.evaluate(state, images_mod.ImageBatches(
            val_files, args.batch_size, image_size=args.image_size, train=False,
            num_workers=2, drop_remainder=False), metric_fn)["val_top1"]
    return state, top1, img_s


# -- roles --------------------------------------------------------------------
def main(argv=None) -> dict:
    from edl_tpu_torch.coord.client import connect
    from edl_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    train_files, val_files = ensure_data(args)
    store = connect(args.coord_endpoints) if args.coord_endpoints else None

    if args.role == "teacher_train":
        _model, state = train_teacher(args, train_files, device)
        save_teacher(args, state)
        print("[image-distill] teacher trained", flush=True)
        return {}

    if args.role == "serve":
        if store is None:
            raise SystemExit("--role serve needs --coord_endpoints")
        serve_teacher(args, store, device, block=True)
        return {}

    if args.role == "student":
        # under the elastic launcher: the env contract, a torch.distributed
        # world, a static per-rank file shard (the distill stream is the
        # data plane here)
        from edl_tpu_torch.cluster.env import TrainerEnv
        from edl_tpu_torch.data import images as images_mod
        from edl_tpu_torch.train.distributed import connect_store, initialize_from_env, shutdown

        tenv = initialize_from_env(TrainerEnv(), device)
        if device.type == "cuda" and tenv.world_size > 1:
            device = torch.device("cuda", torch.cuda.current_device())  # bound to this rank
        if store is None:
            store = connect_store(tenv)
        try:
            world, rank = max(1, tenv.world_size), tenv.global_rank
            my_files = images_mod.shard_files(train_files, rank, world)
            src = make_distill_source(args, my_files, rank=rank)
            _state, top1, img_s = train_student(args, my_files, val_files, device, src,
                                                tenv=tenv, store=store)
        finally:
            if store is not None:
                store.close()
            shutdown()
        rec = {"val_top1": round(float(top1), 4),
               "distill_img_s": round(img_s, 1), "world": world}
        print(f"[image-distill] student {json.dumps(rec)}", flush=True)
        marker = os.environ.get("EDL_TPU_DEMO_MARKER")
        if marker:
            with open(marker, "a") as f:
                f.write("done " + json.dumps(rec) + "\n")
        return rec

    # -- local: the whole flow in one process ---------------------------------
    from edl_tpu_torch.coord.memory import MemoryKV
    from edl_tpu_torch.distill.discovery import DiscoveryServer

    store = store or MemoryKV(sweep_period=0.2)
    tmodel, _ = train_teacher(args, train_files, device)
    teacher_top1 = eval_model(args, tmodel, val_files, device)
    print(f"[image-distill] teacher val_top1={teacher_top1:.3f}", flush=True)

    global _DEBUG_TEACHER
    _DEBUG_TEACHER = tmodel
    disc = DiscoveryServer(store, host="127.0.0.1")
    fleet = [serve_teacher(args, store, device, model=tmodel, block=False)
             for _ in range(2)]
    args.discovery = disc.endpoint
    try:
        _s, distill_top1, distill_img_s = train_student(
            args, train_files, val_files, device, make_distill_source(args, train_files))
        _b, baseline_top1, _ = train_student(args, train_files, val_files, device, None)
        stats = [t.stats() for t in fleet]
    finally:
        for t in fleet:
            t.stop()
        disc.stop()
        store.close()
        _DEBUG_TEACHER = None
    summary = {
        "teacher_top1": round(float(teacher_top1), 4),
        "distill_top1": round(float(distill_top1), 4),
        "baseline_top1": round(float(baseline_top1), 4),
        "gain": round(float(distill_top1 - baseline_top1), 4),
        "distill_img_s": round(distill_img_s, 1),
        "teacher_rows_per_s": round(sum(s["rows_per_s"] for s in stats), 1),
        "teacher_rows": sum(s["rows"] for s in stats),
        "teacher_forward_passes": sum(s["forward_passes"] for s in stats),
    }
    print(f"[image-distill] {json.dumps(summary)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
