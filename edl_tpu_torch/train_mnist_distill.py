"""Service distillation end to end, the minimal real-model flow: the PyTorch
port of ``examples/distill/train_mnist_distill.py`` (reference
example/distill/mnist_distill/train_with_fleet.py:1-300 and
example/distill/README.md:11-31).

Roles::

    # 1. train the teacher and checkpoint it
    python -m edl_tpu_torch.train_mnist_distill --role teacher_train --teacher_dir /ckpt/t

    # 2. serve it, registered for discovery
    python -m edl_tpu_torch.distill.discovery --coord_endpoints $COORD &
    python -m edl_tpu_torch.train_mnist_distill --role serve --teacher_dir /ckpt/t \\
        --coord_endpoints $COORD --service mnist-teacher

    # 3. train the student through the discovery-balanced teacher fleet
    python -m edl_tpu_torch.train_mnist_distill --role student \\
        --discovery $DISCOVERY_EP --service mnist-teacher

    # the whole flow in one process
    python -m edl_tpu_torch.train_mnist_distill --role local

The same flags and defaults as the JAX example, plus ``--device`` (default
``cuda``; ``cpu`` only when asked).  ``make_digits`` and ``batches`` are the
example's, to the bit.  Teacher and students are ``models/mnist.py:
MnistCNN`` in f32 (the example's ``dtype=jnp.float32``), trained with the
example's ``optax.adam(2e-3)``, AdamW without decay
(``train/state.py:adamw(2e-3, weight_decay=0.0)``): the teacher on clean
labels, the students on labels with noise.  The teacher is saved and loaded
through the port's ``CheckpointManager`` and served by ``TeacherServer``
over ``module_teacher``; the distilled student reads a ``DistillReader``
(``ins=["image", "label"]``, ``predicts=["logits"]``, ``feeds=["image"]``)
and its loss is ``alpha·CE + (1 − alpha)·T²·CE(logits / T, softmax(teacher
/ T))``.  ``local`` runs the whole flow in one process against a
``MemoryKV`` and a ``DiscoveryServer`` and returns (and with ``--out``
writes) the example's summary.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading

import numpy as np
import torch
import torch.nn.functional as F


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MNIST-style service distillation")
    p.add_argument("--role", default="local",
                   choices=["teacher_train", "serve", "student", "local"])
    p.add_argument("--teacher_dir", default="/tmp/edl-mnist-teacher")
    p.add_argument("--coord_endpoints", default="")
    p.add_argument("--service", default="mnist-teacher")
    p.add_argument("--discovery", default="",
                   help="discovery server endpoint(s) for the student")
    p.add_argument("--teachers", default="",
                   help="fixed teacher endpoints (skip discovery)")
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--image_size", type=int, default=16)
    p.add_argument("--train_n", type=int, default=512)
    p.add_argument("--test_n", type=int, default=256)
    p.add_argument("--label_noise", type=float, default=0.4)
    p.add_argument("--teacher_epochs", type=int, default=30)
    p.add_argument("--student_epochs", type=int, default=12)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--teacher_batch_size", type=int, default=16)
    p.add_argument("--alpha", type=float, default=0.1,
                   help="hard-label weight; 1-alpha goes to the teacher")
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--out", default="", help="write summary JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


# -- synthetic digit task ----------------------------------------------------
def make_digits(n, classes, size, seed, label_noise=0.0):
    """Class-conditional stripe+blob patterns, learnable by a small CNN."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, size, size, 1), np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    for i, c in enumerate(y):
        period = 2 + int(c)
        stripes = ((np.arange(size) // period) % 2).astype(np.float32)
        img = np.outer(stripes, np.ones(size)) if c % 2 == 0 else \
            np.outer(np.ones(size), stripes)
        cx = (c * size // classes + size // 4) % size
        img[:, cx:min(size, cx + 2)] += 0.8
        x[i, :, :, 0] = img + rng.normal(0, 0.35, (size, size))
    y_noisy = y.copy()
    if label_noise > 0:
        flip = rng.random(n) < label_noise
        y_noisy[flip] = rng.integers(0, classes, flip.sum())
    return x, y, y_noisy


def batches(x, y, bs, seed, extra=None):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(x))
    for i in range(0, len(x) - bs + 1, bs):
        idx = order[i:i + bs]
        b = {"image": x[idx], "label": y[idx]}
        if extra is not None:
            b["teacher_logits"] = extra[idx]
        yield b


# -- models and losses --------------------------------------------------------
def make_model(args, device: torch.device, seed: int = 0):
    """The example's ``MnistCNN(num_classes, dtype=float32)`` on ``device``,
    its weights drawn from ``seed``."""
    from edl_tpu_torch.models.mnist import MnistCNN
    return MnistCNN(num_classes=args.classes, image_size=args.image_size,
                    dtype=torch.float32, generator=torch.Generator().manual_seed(seed)).to(device)


def _optimizer():
    """The example's ``optax.adam(2e-3)``."""
    from edl_tpu_torch.train.state import adamw
    return adamw(2e-3, weight_decay=0.0)


def teacher_loss_fn(model, extra, batch, gen):
    return F.cross_entropy(model(batch["image"]), batch["label"].long()), (extra, {})


def make_student_loss_fn(args):
    """The example's student loss: ``alpha·CE + (1 − alpha)·T²·CE(logits /
    T, softmax(teacher_logits / T))`` on a batch with the teacher's logits,
    plain CE without."""
    T = args.temperature

    def loss_fn(model, extra, batch, gen):
        logits = model(batch["image"])
        hard = F.cross_entropy(logits, batch["label"].long())
        if "teacher_logits" in batch:
            soft = F.cross_entropy(logits / T,
                                   F.softmax(batch["teacher_logits"].float() / T, -1)) * (T * T)
            loss = args.alpha * hard + (1 - args.alpha) * soft
        else:
            loss = hard
        return loss, (extra, {})
    return loss_fn


def _fit(model_fn, loss_fn, data_fn, epochs: int, device: torch.device):
    from edl_tpu_torch.cluster.state import State
    from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    tr = ElasticTrainer(loss_fn, TrainConfig(log_every=0), device=device)
    state = tr.create_state(lambda: (model_fn(), None), _optimizer())
    state, _ = tr.fit(state, State(), data_fn, epochs=epochs)
    return state


# -- teacher -----------------------------------------------------------------
def train_teacher(args, x, y_clean, device: torch.device):
    """The teacher's ``TrainState`` after ``--teacher_epochs`` on the clean
    labels."""
    return _fit(lambda: make_model(args, device), teacher_loss_fn,
                lambda e: batches(x, y_clean, args.batch_size, e), args.teacher_epochs, device)


def save_teacher(args, state) -> None:
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    CheckpointManager(args.teacher_dir, max_to_keep=1).save(0, state, force=True)


def load_teacher(args, device: torch.device):
    """The teacher module restored from ``--teacher_dir``."""
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.train.state import TrainState

    state = TrainState.create(make_model(args, device), _optimizer())
    restored = CheckpointManager(args.teacher_dir, max_to_keep=1).restore(state)
    if restored is None:
        raise FileNotFoundError(f"no teacher checkpoint in {args.teacher_dir}")
    return restored[0].model


def serve_teacher(args, store, device: torch.device, model=None, block=True):
    """A ``TeacherServer`` over ``module_teacher(model)`` on ``device``,
    registered under ``--service``; ``block`` serves until SIGTERM."""
    from edl_tpu_torch.distill.teacher import TeacherServer, module_teacher

    if model is None:
        model = load_teacher(args, device)
    predict = module_teacher(model, fetch_name="logits", device=device)
    server = TeacherServer(predict, device=device).register(store, args.service)
    if block:  # pragma: no cover - CLI path
        print(f"[distill] serving on {server.endpoint}", flush=True)
        ev = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: ev.set())
        try:
            ev.wait()
        finally:
            server.stop()
    return server


# -- student -----------------------------------------------------------------
def train_student(args, x, y_noisy, device: torch.device, distill_source=None, seed=1):
    """The student's ``TrainState`` after ``--student_epochs``: distilled
    through ``distill_source(epoch)`` (see :func:`make_distill_source`), else
    on the noisy labels alone."""
    def data_fn(epoch):
        if distill_source is None:
            return batches(x, y_noisy, args.batch_size, 100 + epoch)
        return distill_source(epoch)

    return _fit(lambda: make_model(args, device, seed), make_student_loss_fn(args), data_fn,
                args.student_epochs, device)


def make_distill_source(args, x, y_noisy):
    """``build(epoch)``: a DistillReader over the noisy training set, so every
    batch gains the teacher's logits (the ``predicts`` fields)."""
    from edl_tpu_torch.distill.reader import DistillReader

    def build(epoch):
        dr = DistillReader(ins=["image", "label"], predicts=["logits"], feeds=["image"],
                           teacher_batch_size=args.teacher_batch_size)
        if args.teachers:
            dr.set_fixed_teacher(*args.teachers.split(","))
        else:
            dr.set_dynamic_teacher(args.discovery, args.service)

        def gen():
            for b in batches(x, y_noisy, args.batch_size, 100 + epoch):
                yield b["image"], b["label"]
        dr.set_batch_generator(gen)
        for image, label, logits in dr:
            yield {"image": np.asarray(image), "label": np.asarray(label),
                   "teacher_logits": np.asarray(logits)}
    return build


@torch.no_grad()
def accuracy(model, x, y, device: torch.device, bs: int = 64) -> float:
    model.eval()
    hits = sum(int((model(torch.from_numpy(x[i:i + bs]).to(device)).argmax(-1).cpu().numpy()
                    == y[i:i + bs]).sum()) for i in range(0, len(x), bs))
    return hits / len(x)


# -- roles -------------------------------------------------------------------
def main(argv=None) -> dict:
    from edl_tpu_torch.coord.client import connect
    from edl_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    store = connect(args.coord_endpoints) if args.coord_endpoints else None

    xt, yt, _ = make_digits(args.train_n, args.classes, args.image_size, seed=0)
    xs, ys, ys_noisy = make_digits(args.train_n, args.classes, args.image_size, seed=1,
                                   label_noise=args.label_noise)
    xe, ye, _ = make_digits(args.test_n, args.classes, args.image_size, seed=2)

    if args.role == "teacher_train":
        state = train_teacher(args, xt, yt, device)
        save_teacher(args, state)
        acc = accuracy(state.model, xe, ye, device)
        print(f"[distill] teacher trained: test_acc={acc:.3f}", flush=True)
        return {"teacher_acc": acc}

    if args.role == "serve":
        if store is None:
            raise SystemExit("--role serve needs --coord_endpoints")
        serve_teacher(args, store, device, block=True)
        return {}

    if args.role == "student":
        state = train_student(args, xs, ys_noisy, device,
                              make_distill_source(args, xs, ys_noisy))
        acc = accuracy(state.model, xe, ye, device)
        print(f"[distill] student trained: test_acc={acc:.3f}", flush=True)
        return {"student_acc": acc}

    # -- local: the whole flow in one process --------------------------------
    from edl_tpu_torch.coord.memory import MemoryKV
    from edl_tpu_torch.distill.discovery import DiscoveryServer

    store = store or MemoryKV(sweep_period=0.2)
    tmodel = train_teacher(args, xt, yt, device).model
    teacher_acc = accuracy(tmodel, xe, ye, device)

    disc = DiscoveryServer(store, host="127.0.0.1")
    server = serve_teacher(args, store, device, model=tmodel, block=False)
    args.discovery = disc.endpoint
    try:
        dstate = train_student(args, xs, ys_noisy, device,
                               make_distill_source(args, xs, ys_noisy))
        distill_acc = accuracy(dstate.model, xe, ye, device)
        bstate = train_student(args, xs, ys_noisy, device, None)
        baseline_acc = accuracy(bstate.model, xe, ye, device)
    finally:
        server.stop()
        disc.stop()
        store.close()
    summary = {"teacher_acc": round(teacher_acc, 4),
               "distill_acc": round(distill_acc, 4),
               "baseline_acc": round(baseline_acc, 4),
               "gain": round(distill_acc - baseline_acc, 4)}
    print(f"[distill] {json.dumps(summary)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
