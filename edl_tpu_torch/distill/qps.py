"""DistillReader throughput probe (the port of the JAX package's
``examples/distill/qps_tool.py``).

Reference: example/distill/qps_tools/distill_reader_qps.py:34-45 — a
synthetic generator pushed through the full reader/predict-pool/reorder
machinery, reporting samples/sec.  One of BASELINE.md's explicitly
unpublished north-star metrics; the bench harness records it.

    # against live teachers
    python -m edl_tpu_torch.distill.qps --teachers 10.0.0.5:9000 --batches 500
    # pure pool overhead (nop teacher, no network)
    python -m edl_tpu_torch.distill.qps --nop --batches 500
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run_probe(teachers: str = "", nop: bool = False, batches: int = 300,
              batch_size: int = 32, sample_shape=(16, 16, 1),
              teacher_batch_size: int = 16, discovery: str = "",
              service: str = "", warmup: int = 20) -> dict:
    from edl_tpu_torch.distill import reader as reader_mod
    from edl_tpu_torch.distill.reader import DistillReader

    if nop:
        reader_mod._NOP_PREDICT_TEST = True
    try:
        dr = DistillReader(ins=["image", "label"], predicts=["logits"],
                           feeds=["image"],
                           teacher_batch_size=teacher_batch_size)
        if nop:
            dr.set_fixed_teacher("nop-0", "nop-1")
        elif teachers:
            dr.set_fixed_teacher(*teachers.split(","))
        else:
            dr.set_dynamic_teacher(discovery, service)

        x = np.random.default_rng(0).normal(
            size=(batch_size,) + tuple(sample_shape)).astype(np.float32)
        y = np.zeros((batch_size,), np.int32)

        def gen():
            for _ in range(batches):
                yield x, y
        dr.set_batch_generator(gen)

        n_samples = 0
        t0 = None
        for i, _batch in enumerate(dr):
            if i == warmup:  # exclude pool spin-up from the rate
                t0 = time.perf_counter()
                n_samples = 0
            n_samples += batch_size
        dt = time.perf_counter() - (t0 if t0 is not None else time.perf_counter())
        qps = n_samples / dt if dt > 0 else 0.0
        return {"metric": "distill_reader_qps", "value": round(qps, 1),
                "unit": "samples/s", "batches": batches,
                "batch_size": batch_size, "nop": nop}
    finally:
        if nop:
            reader_mod._NOP_PREDICT_TEST = False


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--teachers", default="")
    p.add_argument("--discovery", default="")
    p.add_argument("--service", default="")
    p.add_argument("--nop", action="store_true")
    p.add_argument("--batches", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--teacher_batch_size", type=int, default=16)
    args = p.parse_args()
    out = run_probe(teachers=args.teachers, nop=args.nop,
                    batches=args.batches, batch_size=args.batch_size,
                    teacher_batch_size=args.teacher_batch_size,
                    discovery=args.discovery, service=args.service)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
