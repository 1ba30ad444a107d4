"""Desired-size, job-spec, demand and distillation-backlog records: the
controller's scaling channel (a copy of the JAX package's
``cluster/scale.py``, under its keys and with its JSON byte for byte, so a
JAX controller reads what the port writes and the other way round).

A controller writes ``desired nodes`` for a job into the coordination
store, and the launcher's generator treats it as a live cap; the generator
publishes the job's ``nodes_range`` here so the controller never needs the
launcher's flags.  The arbitration records (``spec``, ``demand``) and each
student's ``backlog/<student>`` record (``distill/backlog.py``), which the
controller's distillation autoscaler sums, live under the same table.
"""

from __future__ import annotations

import json
import time

from edl_tpu_torch.cluster import paths
from edl_tpu_torch.utils import constants


def save_desired_nodes(store, job_id: str, nodes: int,
                       by: str = "controller") -> None:
    store.put(paths.key(job_id, constants.ETCD_SCALE, "desired"),
              json.dumps({"nodes": int(nodes), "by": by,
                          "at": time.time()}).encode())


def load_desired_nodes(store, job_id: str) -> int | None:
    rec = store.get(paths.key(job_id, constants.ETCD_SCALE, "desired"))
    if rec is None:
        return None
    return int(json.loads(rec.value.decode())["nodes"])


def clear_desired_nodes(store, job_id: str) -> None:
    store.delete(paths.key(job_id, constants.ETCD_SCALE, "desired"))


def save_nodes_range(store, job_id: str, min_nodes: int,
                     max_nodes: int) -> None:
    """Published by the generator so controllers can read the job's
    elasticity bounds from the store."""
    store.put(paths.key(job_id, constants.ETCD_SCALE, "range"),
              json.dumps({"min": int(min_nodes),
                          "max": int(max_nodes)}).encode())


def load_nodes_range(store, job_id: str) -> tuple[int, int] | None:
    rec = store.get(paths.key(job_id, constants.ETCD_SCALE, "range"))
    if rec is None:
        return None
    d = json.loads(rec.value.decode())
    return int(d["min"]), int(d["max"])


# -- multi-job arbitration records (the JAX package's controller/policy.py) --
def save_job_spec(store, job_id: str, kind: str = "training",
                  priority: int | None = None, gang: bool = False,
                  fleet: bool = False) -> None:
    """Arbitration spec for one job: ``kind`` (training / distill /
    serving — serving jobs are counted by their replica adverts, not a
    cluster record), ``priority`` (surplus capacity goes to higher
    classes first; None = the kind's default, policy.KIND_PRIORITY) and
    ``gang`` (atomic placement: min_nodes or nothing).  ``fleet`` marks
    a ``kind="distill"`` job as an advert-backed teacher fleet: its
    members are counted by their serving-table adverts (like a serving
    job) and its demand comes from the DistillAutoscaler's backlog
    signal, not a cluster record.  Published by whoever owns the job's
    deployment; absent = a plain training job."""
    spec = {"kind": kind, "gang": bool(gang)}
    if priority is not None:
        spec["priority"] = int(priority)
    if fleet:
        spec["fleet"] = True
    store.put(paths.key(job_id, constants.ETCD_SCALE, "spec"),
              json.dumps(spec).encode())


def load_job_spec(store, job_id: str) -> dict | None:
    """``{"kind", "gang"[, "priority"]}`` or None (defaults apply)."""
    rec = store.get(paths.key(job_id, constants.ETCD_SCALE, "spec"))
    if rec is None:
        return None
    try:
        d = json.loads(rec.value.decode())
        return d if isinstance(d, dict) else None
    except ValueError:
        return None


def save_demand(store, job_id: str, replicas: int, reason: str = "",
                by: str = "remediation") -> None:
    """Autoscaling demand signal: the alert-driven remediation
    dispatcher (the JAX package's ``controller/remediate.py``) asks the
    controller for this many replicas.  Timestamped — the controller's
    autoscaler only honors a demand fresher than EDL_TPU_DEMAND_TTL,
    so a dead dispatcher's last spike decays instead of pinning the
    fleet scaled out forever."""
    store.put(paths.key(job_id, constants.ETCD_SCALE, "demand"),
              json.dumps({"replicas": int(replicas), "reason": reason,
                          "by": by, "at": time.time()}).encode())


def load_demand(store, job_id: str) -> dict | None:
    """``{"replicas", "reason", "at"}`` or None."""
    rec = store.get(paths.key(job_id, constants.ETCD_SCALE, "demand"))
    if rec is None:
        return None
    try:
        d = json.loads(rec.value.decode())
        return {"replicas": int(d["replicas"]),
                "reason": str(d.get("reason", "")),
                "at": float(d.get("at", 0.0))}
    except (ValueError, KeyError, TypeError):
        return None


def clear_demand(store, job_id: str) -> None:
    store.delete(paths.key(job_id, constants.ETCD_SCALE, "demand"))


# -- distill backlog records (the JAX controller's DistillAutoscaler) -------
def save_backlog(store, job_id: str, student_id: str, queued_rows: int,
                 rows_per_s: float, by: str = "student") -> None:
    """One student's durable backlog signal for a teacher-fleet job:
    rows it has queued for teacher inference and the teacher throughput
    it is observing.  Per-student keys (``scale/backlog/<student>``) so
    concurrent students never clobber each other; the DistillAutoscaler
    sums the FRESH records (same EDL_TPU_DEMAND_TTL freshness rule as
    demand records — a dead student's last backlog decays instead of
    pinning teachers scaled out)."""
    store.put(paths.key(job_id, constants.ETCD_SCALE,
                        f"backlog/{student_id}"),
              json.dumps({"queued_rows": int(queued_rows),
                          "rows_per_s": float(rows_per_s), "by": by,
                          "at": time.time()}).encode())


def load_backlogs(store, job_id: str) -> dict[str, dict]:
    """Every student's backlog record:
    ``{student_id: {"queued_rows", "rows_per_s", "at"}}`` (torn records
    skipped — the writer re-publishes every period)."""
    prefix = paths.key(job_id, constants.ETCD_SCALE, "backlog/")
    recs, _rev = store.get_prefix(prefix)
    out: dict[str, dict] = {}
    for rec in recs:
        try:
            d = json.loads(rec.value.decode())
            out[rec.key[len(prefix):]] = {
                "queued_rows": int(d["queued_rows"]),
                "rows_per_s": float(d.get("rows_per_s", 0.0)),
                "at": float(d.get("at", 0.0))}
        except (ValueError, KeyError, TypeError):
            continue
    return out


def clear_backlog(store, job_id: str, student_id: str) -> None:
    store.delete(paths.key(job_id, constants.ETCD_SCALE,
                           f"backlog/{student_id}"))
