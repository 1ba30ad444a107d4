"""Task model for the predict pool (a copy of the JAX package's
``distill/tasks.py``).

The reference cuts the student's sample stream into teacher-batch
``Task``s and reassembles original batches after prediction
(distill_worker.py:547-596 slicing, :720-847 reassembly).  Tags record
where every sample came from: ``(batch_id, slot)``; a task never mixes
teacher batch sizes, an original batch may span tasks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Task:
    """One teacher-batch worth of samples."""

    task_id: int
    samples: list[tuple]           # each: tuple of per-sample np arrays/scalars
    tags: list[tuple[int, int]]    # (batch_id, slot) per sample
    retries: int = 0


@dataclass
class BatchBuilder:
    """Accumulates predicted samples of one original batch until full,
    then emits stacked arrays (the reference's fetch_out regrouping)."""

    batch_id: int
    size: int
    ins: list[tuple] = field(default_factory=list)      # placeholder slots
    predicts: list[tuple] = field(default_factory=list)
    filled: int = 0

    def __post_init__(self):
        self.ins = [None] * self.size
        self.predicts = [None] * self.size

    def add(self, slot: int, sample: tuple, predict: tuple) -> None:
        assert self.ins[slot] is None, f"slot {slot} filled twice"
        self.ins[slot] = sample
        self.predicts[slot] = predict
        self.filled += 1

    @property
    def complete(self) -> bool:
        return self.filled == self.size

    def stack(self) -> tuple:
        """Stack per-sample fields into batch arrays: ins fields then
        predict fields — the tuple DistillReader yields."""
        n_in = len(self.ins[0])
        n_out = len(self.predicts[0])
        cols = []
        for i in range(n_in):
            cols.append(_stack([s[i] for s in self.ins]))
        for i in range(n_out):
            cols.append(_stack([p[i] for p in self.predicts]))
        return tuple(cols)


def _stack(values: list):
    first = values[0]
    if isinstance(first, np.ndarray):
        return np.stack(values)
    return np.asarray(values)
