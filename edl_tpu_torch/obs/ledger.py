"""Per-step phase ledger: where does a train step's wall time go?

A copy of the JAX package's ``obs/ledger.py`` (the same phases, metric
names, coverage self-check and trace events).  Each completed step's wall
time (the trainer's interval between step observations) is decomposed into
named phases —

- ``data_wait``  — blocked obtaining the next host batch (the one-ahead
  staging ran dry: input-bound time);
- ``h2d``        — blocked on the staged host-to-device copy
  (``data/elastic_input.py:device_put_stream``'s ``h2d_wait_s``, credited
  inside ``data_wait`` and deducted from it);
- ``compute``    — the step's forward, backward and update as the host
  queues them (the card's queue is bounded, so in steady state the block
  lands here and this converges on the device step time);
- ``hooks``      — span marking, heartbeat, preempt/reshard checks,
  logging, the profiler's step boundary — the framework's own per-step
  bookkeeping;
- ``checkpoint`` — save/wait calls landing inside the epoch loop

— published as ``edl_step_phase_seconds{phase}`` histograms.  Phases
nest correctly: a phase recorded while another is open is *deducted*
from the enclosing one, so the per-step sum never double counts.  Every
timer reads the host's clocks only: nothing here touches the card.

**Self-check**: the ledger tracks what fraction of step wall time its
phases account for (``edl_step_ledger_coverage_ratio``, an EMA).

The ledger is also the CPU fallback for on-demand profiler capture
(:mod:`edl_tpu_torch.obs.profile`): while a capture window is armed
(:meth:`StepPhaseLedger.start_capture`), every step emits a
``train/step_phases`` trace event carrying the per-phase split as a
``counters`` dict — ``edl-obs-dump --perfetto`` renders those as
counter tracks next to the span rows.  Outside a capture window the
same event is emitted on a throttled cadence (~`_EMIT_EVERY_S`), so
long-running jobs always have a coarse phase history in their trace.

``EDL_TPU_STEP_LEDGER=0`` disables every phase timer.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace

PHASES = ("data_wait", "h2d", "compute", "hooks", "checkpoint")

PHASE_SECONDS = obs_metrics.histogram(
    "edl_step_phase_seconds",
    "Per-step wall time by phase: data_wait / h2d / compute / hooks / "
    "checkpoint (train/trainer.py step ledger)",
    ("phase",))
_COVERAGE_G = obs_metrics.gauge(
    "edl_step_ledger_coverage_ratio",
    "EMA fraction of step wall time the phase ledger accounts for "
    "(self-check; ~1.0 when instrumentation covers the hot path)")

# throttled background trace emit (outside capture windows)
_EMIT_EVERY_S = 30.0


def enabled_from_env() -> bool:
    return os.environ.get("EDL_TPU_STEP_LEDGER", "1") != "0"


class StepPhaseLedger:
    """One instance per train loop; NOT thread-safe by design — every
    call happens on the consumer (epoch-loop) thread, including the
    ``h2d``/``data_wait`` credits from generators the loop drives."""

    def __init__(self, enabled: bool | None = None, component: str = ""):
        self.enabled = enabled_from_env() if enabled is None else enabled
        self.component = component
        self._acc = dict.fromkeys(PHASES, 0.0)
        self._open: list[list[float]] = []   # stack of [deduction] frames
        self._cover_ema: float | None = None
        self._steps = 0
        self._totals = dict.fromkeys(PHASES, 0.0)  # since last trace emit
        self._totals_wall = 0.0
        self._totals_steps = 0
        self._last_emit = time.monotonic()
        self._capture_until = 0.0            # monotonic deadline

    # -- recording -----------------------------------------------------------
    @contextmanager
    def phase(self, name: str):
        """Time the block into ``name``.  Credits recorded inside the
        block (a nested phase, an external :meth:`add`) are deducted,
        so enclosing phases report only their own exclusive time."""
        if not self.enabled:
            yield
            return
        frame = [0.0]
        self._open.append(frame)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._open.pop()
            # exclusive time: the block minus everything credited inside
            # it; the ENCLOSING phase deducts this block's whole span
            self._acc[name] = (self._acc.get(name, 0.0)
                               + max(0.0, dt - frame[0]))
            if self._open:
                self._open[-1][0] += dt

    def add(self, name: str, seconds: float) -> None:
        """Credit ``seconds`` to ``name`` directly — for waits measured
        by code the loop drives (the ``h2d`` stage wait inside the
        prefetch generator) rather than a wrappable block."""
        if self.enabled:
            self._credit(name, max(0.0, float(seconds)))

    def _credit(self, name: str, seconds: float) -> None:
        self._acc[name] = self._acc.get(name, 0.0) + seconds
        if self._open:
            self._open[-1][0] += seconds

    def reset(self) -> None:
        """Drop the accumulated (un-closed) phases without observing
        them: the trainer calls this at its FIRST step observation —
        where no inter-step interval exists yet — so the first step's
        jit compile (accumulated inside ``compute``) is never observed
        as if it were a normal step's phase split."""
        self._acc = dict.fromkeys(PHASES, 0.0)

    # -- per-step close ------------------------------------------------------
    def step_done(self, wall_dt: float, step: int | None = None) -> None:
        """Close the current step's ledger against its measured wall
        time (the trainer's inter-step interval): observe the phase
        histograms, update the coverage self-check, and emit the trace
        event when a capture is armed (or the throttle allows)."""
        if not self.enabled:
            return
        t_self = time.perf_counter()
        acc, self._acc = self._acc, dict.fromkeys(PHASES, 0.0)
        total = 0.0
        for p, v in acc.items():
            PHASE_SECONDS.labels(phase=p).observe(v)
            self._totals[p] = self._totals.get(p, 0.0) + v
            total += v
        self._steps += 1
        self._totals_steps += 1
        self._totals_wall += max(0.0, wall_dt)
        if wall_dt > 0:
            cover = min(1.0, total / wall_dt)
            self._cover_ema = (cover if self._cover_ema is None
                               else 0.9 * self._cover_ema + 0.1 * cover)
            _COVERAGE_G.set(self._cover_ema)
        now = time.monotonic()
        if now < self._capture_until:
            # capture window: one event PER STEP, exact per-phase split
            obs_trace.emit("train/step_phases", dur=max(0.0, wall_dt),
                           # back-dating a TRACE
                           # ts to the span begin (merge convention: ts is
                           # begin), not deadline arithmetic
                           at=time.time() - max(0.0, wall_dt),
                           step=step, steps=1,
                           counters={p: round(v, 6) for p, v in acc.items()})
        elif now - self._last_emit >= _EMIT_EVERY_S:
            self.flush(now=now, step=step)
        # the ledger's own close-out cost (histogram observes, trace
        # emits) is real per-step overhead: charge it to the NEXT
        # step's hooks so the coverage self-check stays honest on
        # sub-millisecond steps
        self._acc["hooks"] += time.perf_counter() - t_self

    def flush(self, now: float | None = None, step: int | None = None
              ) -> None:
        """Emit the aggregated ``train/step_phases`` event for the
        window since the last emit (the coarse always-on history).
        Counters are the PER-STEP MEAN seconds by phase — the same
        unit the per-step capture events use, so both land on one
        comparable Perfetto counter track instead of window totals
        spiking ~1000x above step samples at capture boundaries;
        ``dur``/``steps`` keep the window totals."""
        if not self.enabled or not self._totals_steps:
            return
        n = self._totals_steps
        obs_trace.emit("train/step_phases", dur=round(self._totals_wall, 6),
                       # back-dating a TRACE ts
                       # to the window begin, not deadline arithmetic
                       at=time.time() - self._totals_wall,
                       step=step, steps=n,
                       counters={p: round(v / n, 6)
                                 for p, v in self._totals.items()})
        self._totals = dict.fromkeys(PHASES, 0.0)
        self._totals_wall = 0.0
        self._totals_steps = 0
        self._last_emit = time.monotonic() if now is None else now

    # -- capture window (the CPU fallback of /profile) -----------------------
    def start_capture(self, duration_s: float) -> None:
        """Arm per-step trace emission for ``duration_s`` from now —
        the phase-ledger profile capture (:mod:`edl_tpu_torch.obs.profile`
        uses it where ``jax.profiler`` is unavailable or too heavy)."""
        self._capture_until = time.monotonic() + max(0.0, float(duration_s))

    def stop_capture(self) -> None:
        """End the capture window now (a profiler capture whose window
        closed at a step boundary: its steps and the per-step events then
        match one to one)."""
        self._capture_until = 0.0

    def capture_active(self) -> bool:
        return time.monotonic() < self._capture_until

    @property
    def coverage(self) -> float | None:
        """The coverage EMA (None before the first completed step)."""
        return self._cover_ema
