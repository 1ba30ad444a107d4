"""The port's step-phase ledger and profiler capture (``edl_tpu_torch/obs/
ledger.py``, ``obs/profile.py``) against the JAX package's: the same phase
sequence under a fake clock gives the same histogram counts and sums and
the same coverage, nested deduction, ``reset`` and
``EDL_TPU_STEP_LEDGER=0`` included; the CPU fallback's manifest has JAX's
keys; the busy guard and ``/profile`` over HTTP; a ``torch_profiler``
capture forced on the CPU writes a trace of its steps; a capture asked for
inside an active ``torch.profiler.profile`` is refused and counted without
raising; and the ``EDL_TPU_PEAK_TFLOPS`` override."""

import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from edl_tpu.obs import flops as jax_flops
from edl_tpu.obs import ledger as jax_ledger
from edl_tpu.obs import profile as jax_profile
from edl_tpu.obs import trace as jax_trace
from edl_tpu_torch.obs import flops as torch_flops
from edl_tpu_torch.obs import ledger as torch_ledger
from edl_tpu_torch.obs import profile as torch_profile
from edl_tpu_torch.obs import trace as torch_trace
from edl_tpu_torch.obs.exposition import MetricsServer
from edl_tpu_torch.obs.metrics import Registry


class FakeClock:
    """``perf_counter``/``monotonic``/``time`` on a clock the test moves."""

    def __init__(self):
        self.t = 1000.0

    def advance(self, dt: float) -> None:
        self.t += dt

    def perf_counter(self):
        return self.t

    monotonic = time = perf_counter


def _snapshot(mod) -> dict:
    return {p: (mod.PHASE_SECONDS.labels(phase=p).count, mod.PHASE_SECONDS.labels(phase=p).sum)
            for p in mod.PHASES}


def _play(mod, monkeypatch, seed: int, enabled: bool | None = None):
    """A seeded sequence of steps on a fresh ledger of ``mod`` under a fake
    clock: nested phases with credits inside, a ``reset`` after the first
    step, per-step ``step_done``; the histogram deltas and the coverage."""
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", clock)
    rng = np.random.default_rng(seed)
    before = _snapshot(mod)
    led = mod.StepPhaseLedger(enabled=enabled)
    for step in range(8):
        with led.phase("data_wait"):
            clock.advance(float(rng.uniform(0, 0.01)))
            led.add("h2d", float(rng.uniform(0, 0.003)))
        with led.phase("hooks"):
            clock.advance(float(rng.uniform(0, 0.002)))
        with led.phase("compute"):
            clock.advance(float(rng.uniform(0.05, 0.1)))
        if step % 3 == 2:
            with led.phase("hooks"):
                with led.phase("checkpoint"):
                    clock.advance(float(rng.uniform(0.01, 0.2)))
                    led.add("h2d", 0.004)
        if step == 0:
            led.reset()          # the first observation: no interval yet
        else:
            led.step_done(float(rng.uniform(0.08, 0.4)), step=step)
    after = _snapshot(mod)
    deltas = {p: (after[p][0] - before[p][0], round(after[p][1] - before[p][1], 12))
              for p in mod.PHASES}
    return deltas, led.coverage, led.enabled


@pytest.mark.parametrize("seed", [0, 1])
def test_ledger_matches_jax_under_a_fake_clock(seed, monkeypatch):
    monkeypatch.delenv("EDL_TPU_STEP_LEDGER", raising=False)
    want = _play(jax_ledger, monkeypatch, seed)
    got = _play(torch_ledger, monkeypatch, seed)
    assert got == want
    deltas, coverage, _ = got
    assert deltas["compute"][0] == 7 and 0 < coverage <= 1.0
    assert torch_ledger.PHASES == jax_ledger.PHASES


def test_ledger_env_off_matches_jax(monkeypatch):
    monkeypatch.setenv("EDL_TPU_STEP_LEDGER", "0")
    want = _play(jax_ledger, monkeypatch, 3)
    got = _play(torch_ledger, monkeypatch, 3)
    assert got == want and got[2] is False and got[1] is None
    assert all(n == 0 for n, _ in got[0].values())


def test_ledger_capture_and_flush_emit_jax_shaped_events(tmp_path):
    path = tmp_path / "trace-test.jsonl"
    prev = torch_trace.install(torch_trace.Tracer(str(path), "test"))
    try:
        led = torch_ledger.StepPhaseLedger(enabled=True)
        led.start_capture(30.0)
        assert led.capture_active()
        for i in range(3):
            led.add("compute", 0.01)
            led.step_done(0.012, step=i)
        led._capture_until = 0.0
        for i in range(4):
            led.add("compute", 0.01)
            led.step_done(0.02, step=3 + i)
        led.flush(step=7)
    finally:
        torch_trace.install(prev).close()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    per_step = [e for e in events if e["steps"] == 1]
    assert len(per_step) == 3 and set(per_step[0]["counters"]) == set(torch_ledger.PHASES)
    (agg,) = [e for e in events if e["steps"] > 1]   # the window since the last emit
    assert agg["steps"] == 7 and agg["counters"]["compute"] == pytest.approx(0.01)
    assert agg["dur"] == pytest.approx(3 * 0.012 + 4 * 0.02)


def _wait_for(path, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not os.path.exists(path):
        time.sleep(0.02)
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def test_fallback_manifest_has_jax_keys(tmp_path):
    manifests = []
    for mod, led_mod, trace_mod, sub in ((jax_profile, jax_ledger, jax_trace, "jax"),
                                         (torch_profile, torch_ledger, torch_trace, "torch")):
        prev = trace_mod.install(trace_mod.Tracer(str(tmp_path / f"trace-{sub}.jsonl"), sub))
        try:
            cap = mod.ProfileCapture("trainer", ledger=led_mod.StepPhaseLedger(enabled=True),
                                     out_dir=str(tmp_path / sub))
            res = cap.trigger(duration_s=0.05, trigger="alert")
            assert res["started"] and res["kind"] == "phase_ledger"
            manifests.append(_wait_for(res["manifest"]))
        finally:
            trace_mod.install(prev).close()
    jax_m, torch_m = manifests
    assert set(torch_m) == set(jax_m)
    assert {k: torch_m[k] for k in ("kind", "component", "trigger", "duration_s")} == \
        {k: jax_m[k] for k in ("kind", "component", "trigger", "duration_s")}


def test_busy_guard_and_the_route_over_http(tmp_path):
    cap = torch_profile.ProfileCapture("trainer",
                                       ledger=torch_ledger.StepPhaseLedger(enabled=True),
                                       out_dir=str(tmp_path))
    assert cap.trigger(duration_s=1.0).get("started")
    assert cap.trigger(duration_s=1.0).get("busy")
    other = torch_profile.ProfileCapture("trainer",
                                         ledger=torch_ledger.StepPhaseLedger(enabled=True),
                                         out_dir=str(tmp_path))
    torch_profile.install_route(other)
    srv = MetricsServer(Registry(), host="127.0.0.1").start()
    try:
        url = f"http://127.0.0.1:{srv.port}/profile?duration_s=0.1&trigger=alert"
        res = json.loads(urllib.request.urlopen(url, timeout=10).read().decode())
        assert res["started"] and res["trigger"] == "alert" and res["kind"] == "phase_ledger"
        again = json.loads(urllib.request.urlopen(url, timeout=10).read().decode())
        assert again["busy"] and again["name"] == res["name"]
        assert _wait_for(res["manifest"])["kind"] == "phase_ledger"
    finally:
        srv.stop()


def _steps(cap, n, ledger=None):
    """``n`` tiny steps, the capture's step boundary before each and the
    ledger's step close after each."""
    x = torch.randn(64, 64)
    for _ in range(n):
        cap.step_boundary()
        for _ in range(20):
            x = torch.tanh(x @ x.T / 64)
        time.sleep(0.02)
        if ledger is not None:
            ledger.add("compute", 0.02)
            ledger.step_done(0.021)


def test_a_forced_torch_profiler_capture_on_the_cpu_writes_its_steps(tmp_path):
    led = torch_ledger.StepPhaseLedger(enabled=True)
    cap = torch_profile.ProfileCapture("trainer", ledger=led, out_dir=str(tmp_path),
                                       torch_profiler=True)
    done0 = torch_profile.CAPTURES_TOTAL.labels(kind="torch_profiler", trigger="http").value
    res = cap.trigger(duration_s=0.05)
    assert res["kind"] == "torch_profiler" and not os.path.exists(res["manifest"])
    prev = torch_trace.install(torch_trace.Tracer(str(tmp_path / "trace.jsonl"), "test"))
    try:
        _steps(cap, 6, led)
        cap.end_window()
    finally:
        torch_trace.install(prev).close()
    manifest = _wait_for(res["manifest"])
    # a step before the window and one after it: 6 steps hold at most 4
    assert manifest["kind"] == "torch_profiler" and 1 <= manifest["steps"] <= 4
    # the ledger's per-step events cover exactly the captured steps
    events = [json.loads(line) for line in (tmp_path / "trace.jsonl").read_text().splitlines()]
    assert sum(e["name"] == "train/step_phases" and e["steps"] == 1
               for e in events) == manifest["steps"]
    assert not led.capture_active()
    # ProfilerStep#0 before the window, #1..#steps captured, one after it:
    # each step's 20 products under its own range
    by_step = torch_profile.events_by_step(manifest["artifact"], cats=("cpu_op",))
    assert sorted(by_step) == list(range(manifest["steps"] + 2))
    assert all(by_step[i]["aten::mm"] == 20 for i in by_step)
    # a CPU session has no card clock to lead: one step, whole
    assert (manifest["lead_steps"], manifest["whole"], manifest["unrecorded_launches"],
            manifest["lost_ms"]) == (1, True, {}, 0.0)
    assert torch_profile.CAPTURES_TOTAL.labels(kind="torch_profiler",
                                               trigger="http").value == done0 + 1
    assert cap.trigger(duration_s=0.05).get("started")        # the slot is free again
    cap.end_window()


def test_an_armed_capture_no_step_starts_gives_way(tmp_path, monkeypatch):
    """A ``torch_profiler`` capture waits for a step boundary; when none
    comes within ``ARM_TIMEOUT_S`` (the trainer is not training) a new
    trigger replaces it instead of answering busy for ever."""
    cap = torch_profile.ProfileCapture("trainer", out_dir=str(tmp_path), torch_profiler=True)
    first = cap.trigger(duration_s=0.05)
    assert cap.trigger(duration_s=0.05).get("busy")
    monkeypatch.setattr(torch_profile, "ARM_TIMEOUT_S", 0.0)
    second = cap.trigger(duration_s=0.05)
    assert second.get("started") and second["name"] != first["name"]
    _steps(cap, 3)
    cap.end_window()
    assert _wait_for(second["manifest"])["steps"] >= 1


def test_a_capture_inside_an_active_profiler_is_refused_and_counted(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    cap = torch_profile.ProfileCapture("trainer", out_dir=str(tmp_path), torch_profiler=True)
    refused0 = torch_profile.CAPTURES_TOTAL.labels(kind="refused", trigger="http").value
    with profile(activities=[ProfilerActivity.CPU]) as outer:
        res = cap.trigger(duration_s=0.05)
        _steps(cap, 3)
        torch.ones(3).sum()
    assert torch_profile.CAPTURES_TOTAL.labels(kind="refused",
                                               trigger="http").value == refused0 + 1
    assert "refused" in _wait_for(res["manifest"])
    # the outer profiler kept its session: its events are all there
    assert any(e.key == "aten::sum" for e in outer.key_averages())
    session = torch_profile.TorchProfilerSession("cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        assert session.start() is False
    assert session.start() is True and session.stop(str(tmp_path / "t.json"))
    assert session.stop(str(tmp_path / "u.json")) is None      # a second stop: no raise


def test_events_by_step_places_a_kernel_by_its_launch(tmp_path):
    """A kernel is counted under the step whose op launched it (its
    ``External id``, else its launch call's ``correlation``), not by its
    own time on the card's clock, which may read before the step began."""
    step = [{"cat": "user_annotation", "name": f"ProfilerStep#{i}", "ph": "X", "ts": 100.0 * i,
             "dur": 99.0, "args": {"External id": 90 + i}} for i in range(3)]
    ops = [{"cat": "cpu_op", "name": "attn", "ph": "X", "ts": 100.0 * i + 10, "dur": 5.0,
            "args": {"External id": i}} for i in range(3)]
    launches = [{"cat": "cuda_driver", "name": "cuLaunchKernelEx", "ph": "X",
                 "ts": 100.0 * i + 60, "dur": 2.0, "args": {"correlation": 7 + i}}
                for i in range(3)]
    kernels = [
        # card clock 30 µs behind: its own time lies in the step before
        {"cat": "kernel", "name": "k_op", "ph": "X", "ts": 100.0 * i - 20, "dur": 1.0,
         "args": {"External id": i, "correlation": 50 + i}} for i in range(3)] + [
        {"cat": "kernel", "name": "k_launch", "ph": "X", "ts": 100.0 * i + 30, "dur": 1.0,
         "args": {"External id": 999, "correlation": 7 + i}} for i in range(3)] + [
        {"cat": "kernel", "name": "k_none", "ph": "X", "ts": 5.0, "dur": 1.0, "args": {}}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": step + ops + launches + kernels}))
    by_step = torch_profile.events_by_step(str(path))
    assert by_step == {**{i: {"k_op": 1, "k_launch": 1} for i in range(3)}, -1: {"k_none": 1}}


def test_unrecorded_launches_count_what_a_window_lost_by_step(tmp_path):
    """A kernel launch call whose kernel the trace lacks is counted under
    its step, and the last of them says how far into the session the loss
    reached; copies and non-kernel calls are not kernel launches."""
    steps = [{"cat": "user_annotation", "name": f"ProfilerStep#{i}", "ph": "X",
              "ts": 1000.0 + 100.0 * i, "dur": 99.0, "args": {}} for i in range(3)]
    launches = [{"cat": cat, "name": name, "ph": "X", "ts": ts, "dur": 2.0,
                 "args": {"correlation": c}}
                for cat, name, ts, c in (
                    ("cuda_runtime", "cudaLaunchKernel", 1010.0, 1),      # lost, step 0
                    ("cuda_driver", "cuLaunchKernelEx", 1040.0, 2),       # lost, step 0
                    ("cuda_runtime", "cudaLaunchKernelExC_v11060", 1060.0, 3),
                    ("cuda_runtime", "cudaMemcpyAsync", 1070.0, 4),       # a copy
                    ("cuda_runtime", "cudaLaunchHostFunc", 1080.0, 5),    # no kernel
                    ("cuda_runtime", "cudaLaunchKernel", 1150.0, 6),      # lost, step 1
                    ("cuda_runtime", "cudaLaunchKernel", 1250.0, 7),
                    ("cuda_runtime", "cudaLaunchKernel", 1500.0, 8))]     # lost, no step
    kernels = [{"cat": "kernel", "name": "k", "ph": "X", "ts": 2000.0, "dur": 1.0,
                "args": {"correlation": c}} for c in (3, 7)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": steps + launches + kernels}))
    assert torch_profile.unrecorded_launches(path) == ({0: 2, 1: 1, -1: 1}, 0.5)
    assert torch_profile.unrecorded_launches(steps + kernels) == ({}, 0.0)


def test_the_lead_covers_the_longest_loss_measured(monkeypatch, tmp_path):
    monkeypatch.setattr(torch_profile, "_lost_max_s", 0.0)
    monkeypatch.setattr(torch_profile, "_BORN", time.monotonic())
    assert torch_profile.lead_s() == torch_profile.LEAD_S_MIN
    monkeypatch.setattr(torch_profile, "_lost_max_s", 0.2)
    assert torch_profile.lead_s() == pytest.approx(0.4)
    monkeypatch.setattr(torch_profile, "_lost_max_s", 0.0)
    monkeypatch.setattr(torch_profile, "_BORN", time.monotonic() - 3600)   # an hour old
    assert torch_profile.lead_s() == pytest.approx(torch_profile.LOSS_S_PER_S * 3600, rel=1e-3)
    cpu = torch_profile.TorchProfilerSession("cpu")
    assert cpu.start() and not cpu.leading()      # no card: no lead
    assert cpu.whole(1) is None
    assert cpu.stop(str(tmp_path / "cpu.json")) and cpu.whole(1) is True


def test_peak_tflops_env_override(monkeypatch):
    monkeypatch.delenv("EDL_TPU_PEAK_TFLOPS", raising=False)
    assert torch_flops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert torch_flops.peak_tflops("cpu") is None
    for env in ("12.5", "not a number"):
        monkeypatch.setenv("EDL_TPU_PEAK_TFLOPS", env)

        class Dev:
            device_kind = "weird accelerator"

        assert torch_flops.peak_tflops("weird accelerator") == jax_flops.peak_tflops(Dev())
    assert torch_flops.peak_tflops("NVIDIA H100 80GB HBM3") is None
