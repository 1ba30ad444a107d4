"""NLP service distillation, a transformer teacher and a BOW or CNN student:
the PyTorch port of ``examples/distill/train_nlp_distill.py`` (reference
example/distill/nlp/*: distill.py:208's KL with temperature, model.py's
BOW/CNN students, fine_tune.py's BERT teacher on ChnSentiCorp).

    python -m edl_tpu_torch.train_nlp_distill --role local
    python -m edl_tpu_torch.train_nlp_distill --role local --student cnn

The same flags and defaults as the JAX example, plus ``--device`` (default
``cuda``; ``cpu`` only when asked).  ``make_corpus`` (class-conditional
token bands, masked padding, asymmetric label noise) and ``batches`` are the
example's, to the bit.  The teacher is ``models/text.py:TextTransformer(
num_layers=2, embed_dim=64, num_heads=4, mlp_dim=128, max_len=seq_len)``
and the students ``BowClassifier``/``CnnClassifier(embed_dim=64)``, all in
f32 (the example's ``dtype=jnp.float32``), trained with the example's
``optax.adam(2e-3)`` (``train/state.py:adamw(2e-3, weight_decay=0.0)``).
The teacher is served by ``TeacherServer`` over ``module_teacher``, whose
feeds ``ids, mask`` go in sorted key order, the order the forward takes;
the student's loss is ``alpha·CE + (1 − alpha)·KL`` (``kl_distill_loss``,
times ``T²``).  ``local`` trains the teacher, serves it behind a
``DiscoveryServer`` over a ``MemoryKV`` (or ``--coord_endpoints``'s store),
distils the student, trains the label-only baseline and returns (with
``--out``, writes) the example's summary, ``teacher_rows`` and
``teacher_rows_per_s`` from the server's stats.  ``serve`` trains the
teacher, registers it and serves until SIGTERM.
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
    p = argparse.ArgumentParser(description="NLP service distillation")
    p.add_argument("--role", default="local", choices=["local", "serve"])
    p.add_argument("--student", default="bow", choices=["bow", "cnn"])
    p.add_argument("--coord_endpoints", default="")
    p.add_argument("--service", default="nlp-teacher")
    p.add_argument("--vocab", type=int, default=200)
    p.add_argument("--seq_len", type=int, default=32)
    p.add_argument("--classes", type=int, default=3)
    p.add_argument("--train_n", type=int, default=480)
    p.add_argument("--test_n", type=int, default=240)
    p.add_argument("--label_noise", type=float, default=0.65)
    p.add_argument("--teacher_epochs", type=int, default=10)
    p.add_argument("--student_epochs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--teacher_batch_size", type=int, default=16)
    p.add_argument("--alpha", type=float, default=0.05,
                   help="hard-label weight; 1-alpha goes to the teacher KL")
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


# -- synthetic corpus ---------------------------------------------------------
def make_corpus(args, n, seed, label_noise=0.0):
    """Each class draws 40% of its tokens from a class-specific vocab
    band; the rest is shared noise.  Variable lengths exercise the mask."""
    rng = np.random.default_rng(seed)
    band = args.vocab // (args.classes + 1)
    ids = np.zeros((n, args.seq_len), np.int32)
    mask = np.zeros((n, args.seq_len), np.float32)
    y = rng.integers(0, args.classes, n).astype(np.int32)
    for i, c in enumerate(y):
        length = int(rng.integers(args.seq_len // 2, args.seq_len + 1))
        cls_band = rng.integers(band * (c + 1), band * (c + 2), length)
        noise = rng.integers(0, band, length)
        pick = rng.random(length) < 0.4
        ids[i, :length] = np.where(pick, cls_band, noise)
        mask[i, :length] = 1.0
    y_noisy = y.copy()
    if label_noise > 0:
        flip = rng.random(n) < label_noise
        y_noisy[flip] = (y_noisy[flip] + 1) % args.classes  # asymmetric
    return ids, mask, y, y_noisy


def batches(ids, mask, y, bs, seed):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ids))
    for i in range(0, len(ids) - bs + 1, bs):
        idx = order[i:i + bs]
        yield {"ids": ids[idx], "mask": mask[idx], "label": y[idx]}


# -- models -------------------------------------------------------------------
def make_teacher(args, seed: int = 0):
    from edl_tpu_torch.models.text import TextTransformer
    return TextTransformer(vocab_size=args.vocab, num_layers=2, embed_dim=64, num_heads=4,
                           mlp_dim=128, max_len=args.seq_len, num_classes=args.classes,
                           dtype=torch.float32, generator=torch.Generator().manual_seed(seed))


def make_student(args, seed: int = 1):
    from edl_tpu_torch.models.text import BowClassifier, CnnClassifier
    cls = BowClassifier if args.student == "bow" else CnnClassifier
    return cls(vocab_size=args.vocab, embed_dim=64, num_classes=args.classes,
               dtype=torch.float32, generator=torch.Generator().manual_seed(seed))


def fit(model_fn, data_fn, epochs: int, loss_fn, device: torch.device):
    """The example's ``fit``: ``model_fn()``'s ``TrainState`` after
    ``epochs`` of ``optax.adam(2e-3)``."""
    from edl_tpu_torch.cluster.state import State
    from edl_tpu_torch.train.state import adamw
    from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    tr = ElasticTrainer(loss_fn, TrainConfig(log_every=0), device=device)
    state = tr.create_state(lambda: (model_fn(), None), adamw(2e-3, weight_decay=0.0))
    state, _ = tr.fit(state, State(), data_fn, epochs=epochs)
    return state


@torch.no_grad()
def accuracy(model, ids, mask, y, device: torch.device, bs: int = 64) -> float:
    model.eval()
    hits = 0
    for i in range(0, len(ids), bs):
        logits = model(torch.from_numpy(ids[i:i + bs]).to(device),
                       torch.from_numpy(mask[i:i + bs]).to(device))
        hits += int((logits.argmax(-1).cpu().numpy() == y[i:i + bs]).sum())
    return hits / len(ids)


def teacher_loss(model, extra, batch, gen):
    return F.cross_entropy(model(batch["ids"], batch["mask"]), batch["label"].long()), (extra, {})


def student_loss(args):
    """The example's student loss: ``alpha·CE + (1 − alpha)·KL(teacher ∥
    student)·T²`` on a batch with the teacher's logits, plain CE without."""
    from edl_tpu_torch.models.text import kl_distill_loss

    def loss_fn(model, extra, batch, gen):
        logits = model(batch["ids"], batch["mask"])
        hard = F.cross_entropy(logits, batch["label"].long())
        if "teacher_logits" in batch:
            soft = kl_distill_loss(logits, batch["teacher_logits"].float(), args.temperature)
            loss = args.alpha * hard + (1 - args.alpha) * soft
        else:
            loss = hard
        return loss, (extra, {})
    return loss_fn


# -- distillation -------------------------------------------------------------
def make_distill_source(args, ids, mask, y_noisy, discovery):
    from edl_tpu_torch.distill.reader import DistillReader

    def build(epoch):
        dr = DistillReader(ins=["ids", "mask", "label"], predicts=["logits"],
                           feeds=["ids", "mask"], teacher_batch_size=args.teacher_batch_size)
        dr.set_dynamic_teacher(discovery, args.service)

        def gen():
            for b in batches(ids, mask, y_noisy, args.batch_size, 100 + epoch):
                yield b["ids"], b["mask"], b["label"]
        dr.set_batch_generator(gen)
        for bids, bmask, blabel, blogits in dr:
            yield {"ids": np.asarray(bids), "mask": np.asarray(bmask),
                   "label": np.asarray(blabel), "teacher_logits": np.asarray(blogits)}
    return build


# -- roles --------------------------------------------------------------------
def main(argv=None) -> dict:
    from edl_tpu_torch.coord.client import connect
    from edl_tpu_torch.coord.memory import MemoryKV
    from edl_tpu_torch.distill.discovery import DiscoveryServer
    from edl_tpu_torch.distill.teacher import TeacherServer, module_teacher
    from edl_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    ids_t, mask_t, y_t, _ = make_corpus(args, args.train_n, seed=0)
    ids_s, mask_s, y_s, y_s_noisy = make_corpus(args, args.train_n, seed=1,
                                                label_noise=args.label_noise)
    ids_e, mask_e, y_e, _ = make_corpus(args, args.test_n, seed=2)

    tstate = fit(lambda: make_teacher(args).to(device),
                 lambda e: batches(ids_t, mask_t, y_t, args.batch_size, e),
                 args.teacher_epochs, teacher_loss, device)
    teacher = tstate.model
    teacher_acc = accuracy(teacher, ids_e, mask_e, y_e, device)

    store = (connect(args.coord_endpoints) if args.coord_endpoints
             else MemoryKV(sweep_period=0.2))
    server = TeacherServer(module_teacher(teacher, fetch_name="logits", device=device),
                           device=device).register(store, args.service)
    if args.role == "serve":  # pragma: no cover - CLI path
        print(f"[nlp-distill] serving on {server.endpoint}", flush=True)
        ev = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: ev.set())
        try:
            ev.wait()
        finally:
            server.stop()
            store.close()
        return {}

    disc = DiscoveryServer(store, host="127.0.0.1")
    loss_fn = student_loss(args)
    try:
        src = make_distill_source(args, ids_s, mask_s, y_s_noisy, disc.endpoint)
        dstate = fit(lambda: make_student(args).to(device), src, args.student_epochs,
                     loss_fn, device)
        distill_acc = accuracy(dstate.model, ids_e, mask_e, y_e, device)
        bstate = fit(lambda: make_student(args).to(device),
                     lambda e: batches(ids_s, mask_s, y_s_noisy, args.batch_size, 100 + e),
                     args.student_epochs, loss_fn, device)
        baseline_acc = accuracy(bstate.model, ids_e, mask_e, y_e, device)
        stats = server.stats()
    finally:
        server.stop()
        disc.stop()
        store.close()
    summary = {"student": args.student,
               "teacher_acc": round(teacher_acc, 4),
               "distill_acc": round(distill_acc, 4),
               "baseline_acc": round(baseline_acc, 4),
               "gain": round(distill_acc - baseline_acc, 4),
               "teacher_rows": stats["rows"],
               "teacher_rows_per_s": stats["rows_per_s"]}
    print(f"[nlp-distill] {json.dumps(summary)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
