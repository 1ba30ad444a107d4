"""On-demand profiler capture: ``/profile?duration_s=N`` on the process
that is training, on ``torch.profiler`` (the JAX package's
``obs/profile.py``, whose captures run ``jax.profiler``).

- :class:`ProfileCapture` owns one capture at a time for its process.
  On the card the kind is ``torch_profiler``: ``trigger()`` only arms a
  window, and the trainer's loop starts the profiler (CPU and CUDA
  activities) at the next step boundary; the captured steps begin once the
  session's lead (:func:`lead_s`) has run, whole steps in ``ProfilerStep#0``,
  and end at the first boundary past ``duration_s``, and the profiler stops
  one step after that, on the training thread (:meth:`ProfileCapture.
  step_boundary`, :meth:`ProfileCapture.end_window`), then exports a Chrome
  trace into the profile directory.  Each captured step is a
  ``ProfilerStep#N`` range, ``#1`` to the manifest's ``steps``, and
  :func:`events_by_step` counts their kernels by the step that launched
  them.  The manifest counts the kernel launches whose kernel the trace
  lacks, by step (:func:`unrecorded_launches`), and says whether the
  captured steps lost none (``whole``).  The step ledger emits one
  ``train/step_phases`` event for each captured step.  On the CPU the kind is ``phase_ledger``, as the JAX
  package's CPU fallback: a worker arms the step ledger's capture window
  (one ``train/step_phases`` trace event per step).
- A capture asked for while a profiler is already active in the process
  (``torch.profiler`` allows one session, and a second one's start ends
  the first) is refused: counted under ``kind="refused"``, logged, and
  never raised.  A failed stop never fails the run.
- Every capture writes a JSON **manifest** into ``EDL_TPU_PROFILE_DIR``
  (default: ``EDL_TPU_TRACE_DIR``, else ``edl-tpu-profile`` in the temp
  directory) carrying the process's current ``trace_id``, and emits a
  ``profile/capture`` trace event.
- :func:`install_route` mounts the capture at ``/profile`` on the
  process's /metrics endpoint, where the JAX aggregator's alert actions
  and operators ask for it.

:class:`TorchProfilerSession` is the one ``torch.profiler`` session both
this capture and the trainer's step window (``TrainConfig.profile_window``,
``train_resnet --profile_steps``) run.

Knobs: ``EDL_TPU_PROFILE_DIR`` (artifact/manifest directory),
``EDL_TPU_PROFILE_DURATION`` (default seconds per capture, 5).
"""

from __future__ import annotations

import bisect
import json
import logging
import os
import tempfile
import threading
import time

from edl_tpu_torch.obs import context as obs_context
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger(__name__)

CAPTURES_TOTAL = obs_metrics.counter(
    "edl_profile_captures_total",
    "Profiler captures completed, by kind (torch_profiler vs the "
    "phase_ledger CPU fallback; refused when a profiler was already "
    "active) and trigger (http vs alert)",
    ("kind", "trigger"))

# the step ranges of a torch_profiler session's trace (ProfilerStep#N)
STEP_RANGE = "ProfilerStep#"

# an armed torch_profiler capture that no step boundary started within
# this long (the trainer is not training) gives way to a new trigger
ARM_TIMEOUT_S = 60.0

# A torch.profiler window loses the card's records of its first
# milliseconds while it keeps their launch calls, the more the longer the
# process has run (on an H100, in runs of chip_smoke.py: a minute in, a
# session's first step kept every attention kernel; about 890 s in, it lost
# 61 launches made up to 6.2-12.1 ms into the session, under 14 µs a second
# of the process's age; the cause is not known).  So a
# session on a card leads with work that is not counted for at least
# lead_s(): the least lead, twice the longest loss measured in this process
# (unrecorded_launches), and LOSS_S_PER_S times the process's age.
LEAD_S_MIN = 0.03
LOSS_S_PER_S = 15e-6
_BORN = time.monotonic()
_lost_max_s = 0.0


def lead_s() -> float:
    """The time a card session leads with uncounted work before its counted
    steps (see ``LEAD_S_MIN``)."""
    return max(LEAD_S_MIN, 2 * _lost_max_s, LOSS_S_PER_S * (time.monotonic() - _BORN))


def default_duration() -> float:
    try:
        return float(os.environ.get("EDL_TPU_PROFILE_DURATION", 5.0))
    except ValueError:
        return 5.0


def profile_dir() -> str:
    return (os.environ.get("EDL_TPU_PROFILE_DIR")
            or os.environ.get("EDL_TPU_TRACE_DIR")
            or os.path.join(tempfile.gettempdir(), "edl-tpu-profile"))


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` session is active in this process:
    PyTorch's process-wide flag, or this thread's profiler state."""
    import torch
    import torch.autograd.profiler as autograd_profiler
    return bool(getattr(autograd_profiler, "_is_profiler_enabled", False)
                or torch.autograd._profiler_enabled())


class TorchProfilerSession:
    """One ``torch.profiler`` session over the work this thread launches:
    the CPU activity, and the CUDA activity for a ``cuda`` device.
    ``start()`` refuses (returns False) when a profiler is already active
    in the process, and neither it nor ``stop()`` ever raises.  The steps
    are ``ProfilerStep#N`` ranges (the name ``torch.profiler``'s own step
    markers and TensorBoard's plugin use), ``#0`` from ``start()`` and the
    next at each :meth:`step`: :func:`events_by_step` reads a trace by them.

    On a card ``#0`` is the lead: the caller runs uncounted steps in it
    while :meth:`leading`.  After the export, ``by_step`` holds the card's
    kernels, copies and sets by launching step, ``unrecorded`` the kernel
    launches without a record by step, ``lost_ms`` how far into the session
    the last of them came, and ``lead_ms`` the lead's length; :meth:`whole`
    says whether counted steps lost none."""

    def __init__(self, device_type: str = "cpu"):
        self.device_type = device_type
        self._prof = None
        self._range = None
        self.step_num = 0
        self._t_start = 0.0
        self._lead_s = 0.0
        self.lead_ms: float | None = None
        self.by_step: dict[int, dict[str, int]] | None = None
        self.unrecorded: dict[int, int] | None = None
        self.lost_ms: float | None = None

    def _sync(self) -> None:
        if self.device_type == "cuda":
            import torch
            torch.cuda.synchronize()

    def _mark(self, step_num: int | None) -> None:
        from torch.autograd.profiler import record_function
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if step_num is not None:
            self.step_num = step_num
            self._range = record_function(f"{STEP_RANGE}{step_num}")
            self._range.__enter__()

    def start(self) -> bool:
        from torch.profiler import ProfilerActivity, profile
        if self._prof is not None or profiler_active():
            return False
        activities = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            self._sync()   # the queue drains first: no earlier step's kernel lands in it
            prof = profile(activities=activities)
            prof.start()
            self._prof = prof
            self._mark(0)
        except Exception:  # noqa: BLE001 — profiling must never fail a run
            logger.exception("torch.profiler start failed")
            self._prof = None
            return False
        self._t_start = time.monotonic()
        self._lead_s = lead_s() if self.device_type == "cuda" else 0.0
        return True

    def leading(self) -> bool:
        """Whether the lead (``ProfilerStep#0``) wants more uncounted work."""
        return time.monotonic() - self._t_start < self._lead_s

    def step(self) -> None:
        """A step boundary: the next ``ProfilerStep#N`` range begins."""
        if self._prof is not None:
            if self.step_num == 0:
                self.lead_ms = (time.monotonic() - self._t_start) * 1e3
            self._mark(self.step_num + 1)

    def stop(self, path: str) -> str | None:
        """Stop and export the Chrome trace to ``path``; the path, or None
        when the stop or the export failed (logged)."""
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        try:
            self._mark(None)
            self._sync()   # every captured kernel has run
            prof.stop()
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception:  # noqa: BLE001 — profiling must never fail a run
            logger.exception("torch.profiler stop failed")
            return None
        try:
            self._read(path)
        except Exception:  # noqa: BLE001 — profiling must never fail a run
            logger.exception("torch.profiler trace unreadable: %s", path)
        return path

    def _read(self, path: str) -> None:
        global _lost_max_s
        events = load_trace(path)
        self.by_step = events_by_step(events, cats=CARD_CATS)
        self.unrecorded, self.lost_ms = unrecorded_launches(events)
        _lost_max_s = max(_lost_max_s, self.lost_ms / 1e3)

    def whole(self, steps: int) -> bool | None:
        """Whether ``ProfilerStep#1`` to ``#steps`` lost no kernel record
        (None before the trace is read)."""
        if self.unrecorded is None:
            return None
        return not any(self.unrecorded.get(i) for i in range(1, steps + 1))


# the card's records in a Chrome trace, and the host calls that launch them
CARD_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load_trace(path: str | os.PathLike) -> list[dict]:
    """The ``traceEvents`` of a Chrome trace file."""
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def _step_ranges(events: list[dict]) -> list[tuple[float, float, int]]:
    return sorted((ev["ts"], ev["ts"] + ev.get("dur", 0), int(ev["name"][len(STEP_RANGE):]))
                  for ev in events if ev.get("cat") == "user_annotation"
                  and str(ev.get("name", "")).startswith(STEP_RANGE))


def _step_at(ranges: list[tuple[float, float, int]], starts: list[float], ts) -> int:
    """The ``ProfilerStep`` number whose range holds host time ``ts`` (-1: none)."""
    if ts is not None:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ranges[i][1]:
            return ranges[i][2]
    return -1


def unrecorded_launches(events: list[dict] | str | os.PathLike
                        ) -> tuple[dict[int, int], float]:
    """The kernel launch calls (runtime or driver) in a session's trace
    whose kernel has no record (none has their ``correlation``), counted by
    the ``ProfilerStep#N`` range that made them (-1: none), and the host ms
    from the session's first range to the last of them (0.0 with none): the
    records that a window's start lost (see ``LEAD_S_MIN``)."""
    if not isinstance(events, list):
        events = load_trace(events)
    recorded = {(ev.get("args") or {}).get("correlation") for ev in events
                if ev.get("cat") == "kernel"}
    lost = [ev["ts"] for ev in events if ev.get("cat") in LAUNCH_CATS
            and ("LaunchKernel" in ev.get("name", "")
                 or "LaunchCooperativeKernel" in ev.get("name", ""))
            and (ev.get("args") or {}).get("correlation") not in recorded]
    ranges = _step_ranges(events)
    starts = [r[0] for r in ranges]
    out: dict[int, int] = {}
    for ts in lost:
        step = _step_at(ranges, starts, ts)
        out[step] = out.get(step, 0) + 1
    lost_ms = (max(lost) - starts[0]) / 1e3 if lost and starts else 0.0
    return out, max(lost_ms, 0.0)


def events_by_step(events: list[dict] | str | os.PathLike, cats: tuple[str, ...] = ("kernel",)
                   ) -> dict[int, dict[str, int]]:
    """Events of the categories ``cats`` in a session's Chrome trace (a
    path, or its loaded events; the card's ``kernel``, ``gpu_memcpy`` and
    ``gpu_memset``; ``cpu_op``, ``user_annotation``), counted by name under
    the ``ProfilerStep#N`` range that launched them (-1: none).
    A card kernel is placed by the host time of the op that launched it
    (its ``External id``; else the runtime or driver call of its
    ``correlation``), never by its own time, which is on the card's clock
    converted to the host's."""
    if not isinstance(events, list):
        events = load_trace(events)
    ranges = _step_ranges(events)
    launched, op_ts = {}, {}
    for ev in events:
        args = ev.get("args") or {}
        if ev.get("cat") in LAUNCH_CATS and "correlation" in args:
            launched[args["correlation"]] = ev["ts"]
        elif ev.get("cat") in ("cpu_op", "user_annotation") and "External id" in args:
            op_ts.setdefault(args["External id"], ev["ts"])
    starts = [r[0] for r in ranges]
    out: dict[int, dict[str, int]] = {}
    for ev in events:
        if ev.get("cat") not in cats:
            continue
        args = ev.get("args") or {}
        ts = (ev["ts"] if ev["cat"] in ("cpu_op", "user_annotation")
              else op_ts.get(args.get("External id"), launched.get(args.get("correlation"))))
        row = out.setdefault(_step_at(ranges, starts, ts), {})
        row[ev["name"]] = row.get(ev["name"], 0) + 1
    return out


def count_refusal(trigger: str, what: str) -> None:
    CAPTURES_TOTAL.labels(kind="refused", trigger=trigger).inc()
    logger.warning("profile capture %s refused: a profiler is already active "
                   "in this process", what)


class ProfileCapture:
    """One capture at a time for this process; ``trigger`` returns
    immediately.  ``device``: the trainer's device; a ``cuda`` one takes
    ``torch_profiler`` captures (``torch_profiler=True`` forces them, with
    the CPU activity only, on the CPU)."""

    def __init__(self, component: str = "trainer", ledger=None,
                 out_dir: str | None = None, device=None,
                 torch_profiler: bool | None = None):
        self.component = component
        self.ledger = ledger
        self.out_dir = out_dir or profile_dir()
        self.device_type = getattr(device, "type", device) or "cpu"
        self.torch_profiler = (self.device_type == "cuda" if torch_profiler is None
                               else torch_profiler)
        self._lock = threading.Lock()
        self._active: dict | None = None
        self._armed: dict | None = None       # a torch_profiler capture awaiting its start
        self._armed_at = 0.0
        self._session: TorchProfilerSession | None = None
        self._running: dict | None = None        # the running capture's manifest
        self._stage = ""                   # lead, window or tail
        self._t0 = 0.0
        self._steps = 0
        self._lead_steps = 0
        self._seq = 0

    def trigger(self, duration_s: float | None = None,
                trigger: str = "http") -> dict:
        duration_s = (default_duration() if not duration_s
                      else min(300.0, max(0.05, float(duration_s))))
        # the requesting thread's ambient context (falls back to the
        # process root), captured HERE: the loop's thread has its own
        ctx = obs_context.current()
        trace_id = ctx.trace_id if ctx is not None else None
        with self._lock:
            if (self._armed is not None
                    and time.monotonic() - self._armed_at > ARM_TIMEOUT_S):
                logger.warning("profile capture %s never started (no step in %.0fs); "
                               "dropped", self._armed["name"], ARM_TIMEOUT_S)
                self._armed = self._active = None
            if self._active is not None:
                return {"busy": True, **self._active}
            self._seq += 1
            # a DISABLED ledger must not pretend to capture: its
            # step_done is a no-op, so the "capture" would be a manifest
            # pointing at a trace that never receives step events
            ledger_ok = (self.ledger is not None
                         and getattr(self.ledger, "enabled", False))
            kind = ("torch_profiler" if self.torch_profiler
                    else "phase_ledger" if ledger_ok
                    else "manifest_only")
            name = f"profile-{self.component}-{os.getpid()}-{self._seq}"
            manifest = {
                "name": name, "kind": kind, "component": self.component,
                "pid": os.getpid(), "trigger": trigger,
                "duration_s": duration_s, "ts": round(time.time(), 6),
            }
            if trace_id:
                manifest["trace_id"] = trace_id
            self._active = manifest
            if kind == "torch_profiler":
                # the training thread starts it at its next step boundary
                self._armed, self._armed_at = dict(manifest), time.monotonic()
        if kind != "torch_profiler":
            threading.Thread(target=self._run, args=(dict(manifest),),
                             daemon=True, name=f"edl-profile:{name}").start()
        return {"started": True, **manifest,
                "manifest": os.path.join(self.out_dir, name + ".json")}

    # -- the torch_profiler window, driven by the training thread ------------
    def step_boundary(self) -> None:
        """Before a step, on the training thread: start an armed capture,
        move a running one on a step, or end it.  The session leads with
        whole steps in ``ProfilerStep#0`` while :meth:`TorchProfilerSession.
        leading` (at least one), then the captured steps are ``#1`` to
        ``#steps``, and one step more runs past them, since a window's end
        too has lost records (``kernel_times`` in ``chip_smoke.py``).  Two
        attribute reads when no capture is asked for."""
        if self._session is None and self._armed is None:
            return
        session = self._session
        if session is not None:
            if self._stage == "lead":
                if session.leading():
                    self._lead_steps += 1
                    return
                self._stage, self._t0, self._steps = "window", time.monotonic(), 1
                if self.ledger is not None and getattr(self.ledger, "enabled", False):
                    # per-step phase events for exactly the captured steps
                    self.ledger.start_capture(float("inf"))
            elif self._stage == "window":
                if time.monotonic() - self._t0 >= self._running["duration_s"]:
                    self._close_window()
                else:
                    self._steps += 1
            else:
                self.end_window()
                return
            session.step()
            return
        with self._lock:
            manifest, self._armed = self._armed, None
        if manifest is None:
            return
        session = TorchProfilerSession(self.device_type)
        if not session.start():
            count_refusal(manifest["trigger"], manifest["name"])
            manifest["refused"] = "a profiler is already active in this process"
            self._write_manifest(manifest)
            with self._lock:
                self._active = None
            return
        self._session, self._running = session, manifest
        self._stage, self._t0, self._steps = "lead", time.monotonic(), 0
        self._lead_steps = 1

    def _close_window(self) -> None:
        """The captured steps end: the ledger's capture stops and the
        session runs on into its trailing step."""
        if self._stage == "window":
            self._running["traced_s"] = round(time.monotonic() - self._t0, 3)
            if self.ledger is not None and getattr(self.ledger, "enabled", False):
                self.ledger.stop_capture()
        self._stage = "tail"

    def end_window(self) -> None:
        """End a running capture now (its trailing step ran, or the epoch
        ended inside it): stop the profiler, export the trace, write the
        manifest.  Never raises."""
        session, self._session = self._session, None
        if session is None:
            return
        manifest = self._running
        try:
            self._close_window()
            artifact = session.stop(os.path.join(self.out_dir, manifest["name"] + ".pt.trace.json"))
            if artifact is None:
                manifest["kind"] = "manifest_only"
            else:
                manifest["artifact"] = artifact
            # the captured steps are the trace's ProfilerStep#1..#steps,
            # after lead_steps uncounted ones in #0; whole: no captured step
            # launched a kernel that the trace lacks
            manifest["steps"] = self._steps
            manifest["lead_steps"] = self._lead_steps
            manifest["lead_ms"] = None if session.lead_ms is None else round(session.lead_ms, 3)
            manifest["whole"] = session.whole(self._steps)
            if session.unrecorded is not None:
                manifest["unrecorded_launches"] = {str(k): n for k, n in
                                                   sorted(session.unrecorded.items())}
                manifest["lost_ms"] = round(session.lost_ms, 3)
            if manifest["whole"] is False:
                logger.warning("profile capture %s: its captured steps lack kernel records "
                               "(unrecorded launches by step %s, the last %.1f ms in)",
                               manifest["name"], session.unrecorded, session.lost_ms)
            self._finish(manifest, time.monotonic() - self._t0)
        except Exception:  # noqa: BLE001 — profiling must never kill the host
            logger.exception("profile capture failed")
        finally:
            with self._lock:
                self._active = None

    # -- the CPU fallback, on a worker ---------------------------------------
    def _run(self, manifest: dict) -> None:
        duration_s = manifest["duration_s"]
        t0 = time.monotonic()
        try:
            if manifest["kind"] == "phase_ledger":
                # the step loop emits per-step train/step_phases events
                # into the process trace file for the window
                self.ledger.start_capture(duration_s)
                time.sleep(duration_s)
                tr = obs_trace.get_tracer()
                if getattr(tr, "path", None):
                    manifest["artifact"] = tr.path
            else:
                time.sleep(min(duration_s, 0.05))
            self._finish(manifest, time.monotonic() - t0)
        except Exception:  # noqa: BLE001 — profiling must never kill the host
            logger.exception("profile capture failed")
        finally:
            with self._lock:
                self._active = None

    def _finish(self, manifest: dict, seconds: float) -> None:
        manifest["captured_s"] = round(seconds, 3)
        self._write_manifest(manifest)
        CAPTURES_TOTAL.labels(kind=manifest["kind"],
                              trigger=manifest["trigger"]).inc()
        extra = ({"trace_id": manifest["trace_id"]}
                 if manifest.get("trace_id") else {})
        obs_trace.emit("profile/capture", dur=manifest["captured_s"],
                       # back-dating a TRACE ts to the capture begin (merge
                       # convention: ts is begin), not deadline arithmetic
                       at=time.time() - manifest["captured_s"],
                       kind=manifest["kind"], trigger=manifest["trigger"],
                       capture=manifest["name"],
                       path=manifest.get("artifact", ""), **extra)

    def _write_manifest(self, manifest: dict) -> None:
        path = os.path.join(self.out_dir, manifest["name"] + ".json")
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(manifest, f)
        except OSError:
            logger.exception("profile manifest write failed")


def install_route(capture: ProfileCapture) -> None:
    """Mount ``capture`` at ``/profile`` on this process's /metrics
    endpoint (idempotent: last registration wins)."""
    from edl_tpu_torch.obs import exposition

    def handle(query: dict) -> dict:
        duration = exposition.query_float(query, "duration_s")
        return capture.trigger(duration_s=duration or None,
                               trigger=str(query.get("trigger", "http")))

    exposition.register_route("/profile", handle)
