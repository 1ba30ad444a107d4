"""Coordination-store journal of the leader ``DataService``'s generation
state (a copy of the JAX package's ``data/journal.py``, its keys and
records field for field, so a successor of either package rebuilds from
the other's journal).

Every mutation a generation's work queue depends on (the file list and the
restored spans at creation, file grants, batch metas, ``file_done`` and
``file_failed``, the consumed-span unions) lands under a
generation-scoped prefix before the in-memory state applies it
(write-ahead).  A successor leader rebuilds every live generation *minus
consumed spans* from this prefix alone, and readers reattach without
restarting the epoch.

Key layout (JSON values, under the ``dist_reader`` table, so a job's
cleanup sweep covers it)::

    /edl_tpu/<job>/dist_reader/<reader>/create          {"files", "consumed"}
    /edl_tpu/<job>/dist_reader/<reader>/owner/<idx>     {"pod", "only", "skip"}
    /edl_tpu/<job>/dist_reader/<reader>/done/<idx>      1
    /edl_tpu/<job>/dist_reader/<reader>/repair/<idx>    [[b,e), ...]
    /edl_tpu/<job>/dist_reader/<reader>/meta/<batch_id> {"p","e","s"} | {"acked": 1}
    /edl_tpu/<job>/dist_reader/<reader>/consumed/<idx>  [[b,e), ...]
    /edl_tpu/<job>/dist_reader/<reader>/error           "producer ...: msg"
    /edl_tpu/<job>/dist_reader/<reader>/dead            1

Write discipline: the ops of the reader-facing hot path (grants, metas,
acks, done) are **strict**: a journal write that cannot land within
``EDL_TPU_DATA_JOURNAL_BUDGET`` raises the retryable ``EdlCoordError`` to
the reader, whose resilient client retries (every mutation is idempotent
by ``(reader, batch_id)`` or ``(reader, file_idx)``), so the journal never
falls behind what a reader observed.  The requeue paths (a dead pod,
nacks) are **best-effort**: a stale owner or meta record only points
consumers at a dead cache, and the nack machinery heals it.

A torn prefix (``create`` missing but per-file keys present, e.g. a
partial GC) reads as *no journal*: the successor serves reattaches from
the readers' own checkpoints and claimed spans instead, the fall-back onto
the stop-resume-from-``DataCheckpoint`` contract.
"""

from __future__ import annotations

import json
import logging

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.utils import constants

logger = logging.getLogger(__name__)


class DataJournal:
    """Generation-state journal on the coordination store.

    Strict methods raise :class:`EdlCoordError` when the store cannot
    confirm the write inside the budget; best-effort methods return
    ``False`` instead.  All values are small JSON documents; span lists
    are half-open ``[begin, end)`` pairs.
    """

    def __init__(self, store, job_id: str,
                 budget: float | None = None):
        self._store = store
        self._job_id = job_id
        self._budget = (constants.data_journal_budget()
                        if budget is None else budget)

    # -- key helpers ---------------------------------------------------------
    def _key(self, reader: str, *parts: str) -> str:
        return paths.key(self._job_id, constants.ETCD_DIST_READER,
                         "/".join((reader,) + parts))

    def _prefix(self, reader: str) -> str:
        return self._key(reader) + "/"

    def _scope(self):
        return self._store.scoped_deadline(self._budget)

    def _put(self, key: str, value) -> None:
        self._store.put(key, json.dumps(value).encode())

    # -- strict write-ahead ops ---------------------------------------------
    def create(self, reader: str, files: list[str],
               consumed: dict[int, list[list[int]]]) -> None:
        with self._scope():
            self._put(self._key(reader, "create"),
                      {"files": list(files),
                       "consumed": {str(k): v for k, v in consumed.items()}})

    def grant(self, reader: str, file_idx: int, pod_id: str,
              only: list[list[int]] | None,
              skip: list[list[int]] | None = None) -> None:
        """``skip`` — the covered-spans skip the grant was issued with
        — rides the record so a successor leader knows which records
        the owner is NOT emitting (the repair-requeue decision)."""
        with self._scope():
            self._put(self._key(reader, "owner", str(file_idx)),
                      {"pod": pod_id, "only": only, "skip": skip or []})

    def metas(self, reader: str, metas: list) -> None:
        """``metas``: [(batch_id, producer, endpoint, spans), ...]."""
        with self._scope():
            for batch_id, producer, endpoint, spans in metas:
                self._put(self._key(reader, "meta", batch_id),
                          {"p": producer, "e": endpoint, "s": spans})

    def ack(self, reader: str, batch_ids: list[str],
            consumed_by_file: dict[int, list[list[int]]]) -> None:
        """Journal an ack batch: the post-merge consumed union per
        touched file, then an ``acked`` tombstone over each meta key
        (not a delete: the tombstone keeps ``(reader, batch_id)``
        replay-dedup alive across a leader rebuild — a producer's
        ancient report retry must not resurrect an already-trained
        batch).  Consumed first — a crash between the two leaves a
        consumed meta still live, which the idempotent ack replay
        clears."""
        with self._scope():
            self.consumed(reader, consumed_by_file, _scoped=True)
            for bid in batch_ids:
                self._put(self._key(reader, "meta", bid), {"acked": 1})

    def consumed(self, reader: str,
                 consumed_by_file: dict[int, list[list[int]]],
                 _scoped: bool = False) -> None:
        if not _scoped:
            with self._scope():
                return self.consumed(reader, consumed_by_file, _scoped=True)
        for file_idx, spans in consumed_by_file.items():
            self._put(self._key(reader, "consumed", str(file_idx)), spans)

    def file_done(self, reader: str, file_idx: int,
                  whole_file: bool = True) -> None:
        """Close out a grant.  Whole-file grants leave a ``done``
        record (the file never re-pends on rebuild); span-repair grants
        just clear their ``owner``/``repair`` keys — the file's
        done-ness is unchanged by a repair pass."""
        with self._scope():
            if whole_file:
                self._put(self._key(reader, "done", str(file_idx)), 1)
            else:
                self._store.delete(self._key(reader, "repair",
                                             str(file_idx)))
            self._store.delete(self._key(reader, "owner", str(file_idx)))

    def error(self, reader: str, message: str) -> None:
        with self._scope():
            self._put(self._key(reader, "error"), message)

    # -- best-effort requeue bookkeeping ------------------------------------
    def requeue(self, reader: str, *, whole_files=(), repairs=None,
                dropped_metas=(), done_cleared=(), cleared_owners=()) -> bool:
        """Reflect a work-requeue (dead pod, eviction nack) in the
        journal.  ``whole_files`` re-pend with no owner left (done +
        owner + repair records drop); ``done_cleared`` only revoke
        done-ness (a live repair owner keeps its grant record);
        ``cleared_owners`` only drop a grant (done-ness untouched —
        the re-pended repair grant of a finished file).  Best-effort:
        a failure leaves records that only say a dead pod still owns
        work — consumers nack their way past that, so correctness
        never depends on this landing."""
        try:
            with self._scope():
                for file_idx in whole_files:
                    self._store.delete(self._key(reader, "done",
                                                 str(file_idx)))
                    self._store.delete(self._key(reader, "owner",
                                                 str(file_idx)))
                    self._store.delete(self._key(reader, "repair",
                                                 str(file_idx)))
                for file_idx in done_cleared:
                    self._store.delete(self._key(reader, "done",
                                                 str(file_idx)))
                for file_idx in cleared_owners:
                    self._store.delete(self._key(reader, "owner",
                                                 str(file_idx)))
                for file_idx, spans in (repairs or {}).items():
                    self._put(self._key(reader, "repair", str(file_idx)),
                              spans)
                for bid in dropped_metas:
                    self._store.delete(self._key(reader, "meta", bid))
            return True
        except Exception as e:  # noqa: BLE001 — self-healing via nacks
            logger.warning("journal requeue for %s failed (stale records "
                           "heal via nacks): %s", reader, e)
            return False

    def gc(self, reader: str) -> bool:
        """Drop a stale generation's whole prefix (new epoch/stage),
        leaving a single ``dead`` tombstone behind: a straggler
        addressing the superseded generation on a SUCCESSOR leader must
        fail fast, not re-seed it through the reattach fallback — the
        in-memory tombstone alone would not survive the failover."""
        try:
            with self._scope():
                self._store.delete_prefix(self._prefix(reader))
                self._put(self._key(reader, "dead"), 1)
            return True
        except Exception as e:  # noqa: BLE001 — sweeps cover it later
            logger.warning("journal gc for %s failed: %s", reader, e)
            return False

    # -- rebuild -------------------------------------------------------------
    def load(self, reader: str) -> dict | None:
        """Read one generation's journal back.

        Returns ``None`` when nothing (or only a torn fragment with no
        ``create`` record) is journaled; ``{"dead": True}`` when the
        generation was GC'd (superseded — callers fail fast); otherwise
        a dict with keys
        ``files``, ``consumed`` ({int: spans}), ``owner``
        ({int: (pod, only)}), ``done`` (set[int]), ``repair``
        ({int: spans}), ``metas`` ([(bid, producer, endpoint, spans)]),
        ``acked`` (set[str] — tombstoned batch ids), ``error``
        (str | None).  Raises :class:`EdlCoordError` when the store
        itself cannot answer."""
        with self._scope():
            recs, _rev = self._store.get_prefix(self._prefix(reader))
        state: dict = {"files": None, "consumed": {}, "owner": {},
                       "granted_skip": {}, "done": set(), "repair": {},
                       "metas": [], "acked": set(), "error": None}
        plen = len(self._prefix(reader))
        for rec in recs:
            rel = rec.key[plen:]
            try:
                val = json.loads(rec.value.decode())
            except Exception:  # noqa: BLE001 — skip a torn record
                logger.warning("journal %s: unreadable record %s",
                               reader, rec.key)
                continue
            if rel == "dead":
                return {"dead": True}
            if rel == "create":
                state["files"] = list(val["files"])
                for k, spans in (val.get("consumed") or {}).items():
                    state["consumed"].setdefault(int(k), []).extend(
                        [int(b), int(e)] for b, e in spans)
            elif rel == "error":
                state["error"] = str(val)
            elif "/" in rel:
                kind, name = rel.split("/", 1)
                if kind == "owner":
                    state["owner"][int(name)] = (val["pod"], val.get("only"))
                    state["granted_skip"][int(name)] = [
                        list(map(int, s)) for s in val.get("skip") or []]
                elif kind == "done":
                    state["done"].add(int(name))
                elif kind == "repair":
                    state["repair"][int(name)] = [list(map(int, s))
                                                 for s in val]
                elif kind == "consumed":
                    # full merged union per file: REPLACES the create
                    # record's seed (it is a superset by construction)
                    state["consumed"][int(name)] = [list(map(int, s))
                                                    for s in val]
                elif kind == "meta":
                    if val.get("acked"):
                        state["acked"].add(name)
                    else:
                        state["metas"].append((name, val["p"], val["e"],
                                               [list(map(int, s))
                                                for s in val["s"]]))
        if state["files"] is None:
            if recs:
                logger.warning("journal %s: torn (create record missing, "
                               "%d fragments) — treating as no journal",
                               reader, len(recs))
            return None
        return state

    def list_readers(self) -> list[str]:
        """Every generation with a ``create`` record in the journal."""
        prefix = paths.table_prefix(self._job_id, constants.ETCD_DIST_READER)
        with self._scope():
            recs, _rev = self._store.get_prefix(prefix)
        out = []
        for rec in recs:
            rel = rec.key[len(prefix):]
            if rel.endswith("/create"):
                out.append(rel[:-len("/create")])
        return sorted(out)
