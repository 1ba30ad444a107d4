"""Train state + data checkpoint: step-level resume metadata.

A copy of the JAX package's ``cluster/state.py``.  ``State`` carries the
global batch size, a user-defined serializable blob, a
``DataCheckpoint`` (reader name, file list, processed record ranges)
and per-epoch ``EpochAttr`` history (world size, step count, average
step time).  It is the checkpoint's JSON sidecar
(``edl_tpu_torch/train/checkpoint.py``), field for field the JSON the
JAX package writes, so a resumed job (possibly at a different world
size) can skip processed records and rescale its LR.
"""

from __future__ import annotations

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.utils import constants
from edl_tpu_torch.utils.exceptions import EdlTableError
from edl_tpu_torch.utils.serialization import JsonSerializable, register_serializable


@register_serializable
class EpochAttr(JsonSerializable):
    def __init__(self, epoch_no: int = 0, world_size: int = 0,
                 step_num: int = 0, avg_step_time: float = 0.0):
        self.epoch_no = epoch_no
        self.world_size = world_size
        self.step_num = step_num
        self.avg_step_time = avg_step_time


@register_serializable
class ProcessedRange(JsonSerializable):
    """Half-open record range [begin, end) of one file (state.py:25-31)."""

    def __init__(self, file_idx: int = 0, begin: int = 0, end: int = 0):
        self.file_idx = file_idx
        self.begin = begin
        self.end = end


@register_serializable
class DataCheckpoint(JsonSerializable):
    def __init__(self, reader_name: str = "", file_list: list[str] | None = None):
        self.reader_name = reader_name
        self.file_list = list(file_list or [])
        self.processed: list[ProcessedRange] = []

    def mark_processed(self, file_idx: int, begin: int, end: int) -> None:
        """Record [begin,end) as done, merging overlapping/adjacent
        ranges per file (general merge — the distributed reader marks
        per record, in whatever order batches were stolen)."""
        from edl_tpu_torch.utils.spans import merge_span
        spans = [[r.begin, r.end] for r in self.processed
                 if r.file_idx == file_idx]
        merge_span(spans, begin, end)
        self.processed = ([r for r in self.processed if r.file_idx != file_idx]
                         + [ProcessedRange(file_idx, b, e) for b, e in spans])

    def is_processed(self, file_idx: int, record_no: int) -> bool:
        return any(r.file_idx == file_idx and r.begin <= record_no < r.end
                   for r in self.processed)


@register_serializable
class State(JsonSerializable):
    def __init__(self, total_batch_size: int = 0, user_defined: dict | None = None):
        self.total_batch_size = total_batch_size
        self.user_defined = dict(user_defined or {})
        self.step = 0
        self.epoch_no = 0
        self.data_checkpoint = DataCheckpoint()
        self.epochs: list[EpochAttr] = []
        self.train_status: str = "initial"
        # mid-epoch resume (finishes the reference's WIP state.py intent):
        # the epoch currently in progress (-1 = between epochs) and the
        # global step at which it started; a mid-epoch checkpoint carries
        # both plus data_checkpoint's consumed spans, so a stop-resume
        # restart re-enters the SAME epoch and skips trained records
        self.in_epoch = -1
        self.epoch_start_step = 0

    # -- epoch history -------------------------------------------------------
    def epoch_attr(self, epoch_no: int) -> EpochAttr | None:
        return next((e for e in self.epochs if e.epoch_no == epoch_no), None)

    def record_epoch(self, epoch_no: int, world_size: int, step_num: int,
                     avg_step_time: float) -> None:
        attr = self.epoch_attr(epoch_no)
        if attr is None:
            self.epochs.append(EpochAttr(epoch_no, world_size, step_num, avg_step_time))
        else:
            attr.world_size = world_size
            attr.step_num = step_num
            attr.avg_step_time = avg_step_time

    @property
    def next_epoch(self) -> int:
        """First epoch to (re)run on resume (reference train_status.next());
        an epoch in progress at checkpoint time is re-entered, with
        ``data_checkpoint`` saying which records it already trained."""
        if self.in_epoch >= 0:
            return self.in_epoch
        done = [e.epoch_no for e in self.epochs]
        return max(done) + 1 if done else 0

    # -- persistence ---------------------------------------------------------
    @staticmethod
    def load_from_store(store, job_id: str, name: str) -> "State | None":
        rec = store.get(paths.key(job_id, constants.ETCD_STATE, name))
        return State().from_json(rec.value.decode()) if rec else None

    def save_to_store(self, store, job_id: str, name: str,
                      leader_pod_id: str | None = None) -> None:
        """Leader-guarded when ``leader_pod_id`` given (state.py:186-200)."""
        key = paths.key(job_id, constants.ETCD_STATE, name)
        if leader_pod_id is None:
            store.put(key, self.to_json().encode())
            return
        ok = store.put_if_equals(
            paths.key(job_id, constants.ETCD_POD_RANK, constants.LEADER_KEY),
            leader_pod_id.encode(), key, self.to_json().encode())
        if not ok:
            raise EdlTableError(f"pod {leader_pod_id} not leader; state not saved")


class AdjustRegistry:
    """Callbacks fired when the world size changes on resume
    (reference register_adjust_function, state.py:142) — e.g. linear LR
    rescale by new_world/old_world."""

    def __init__(self):
        self._fns = []

    def register(self, fn) -> None:
        self._fns.append(fn)

    def run(self, old_world_size: int, new_world_size: int, state: State) -> None:
        if old_world_size == new_world_size:
            return
        for fn in self._fns:
            fn(old_world_size, new_world_size, state)
