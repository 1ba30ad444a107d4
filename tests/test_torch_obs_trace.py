"""The port's trace context and JSONL tracer (``edl_tpu_torch/obs/
context.py``, ``obs/trace.py``) against the JAX package's: a context
crosses both ways in its wire and env forms, the same spans under a fake
clock write the same records, and the JAX package's ``obs/dump.py`` merges
a port trace file into its timeline."""

import itertools
import json

import pytest

from edl_tpu.obs import context as jax_context
from edl_tpu.obs import dump as jax_dump
from edl_tpu.obs import trace as jax_trace
from edl_tpu_torch.obs import context as torch_context
from edl_tpu_torch.obs import trace as torch_trace


@pytest.fixture(autouse=True)
def clean_process_root():
    yield
    jax_context.set_process_root(None)
    torch_context.set_process_root(None)


class FakeClock:
    """``time.time``/``monotonic``/``perf_counter`` advancing 0.25 s a read."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def _tick(self):
        self.t += 0.25
        return self.t

    time = monotonic = perf_counter = _tick


def _read(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("src,dst", [(jax_context, torch_context),
                                     (torch_context, jax_context)])
def test_a_context_crosses_both_ways_on_the_wire_and_in_the_env(src, dst):
    ctx = src.new_trace(job="j", stage="s1").child()
    for back in (dst.TraceContext.from_wire(ctx.to_wire()),
                 dst.TraceContext.from_env_value(ctx.to_env())):
        assert (back.trace_id, back.span_id, back.baggage) == (ctx.trace_id, ctx.span_id,
                                                               {"job": "j", "stage": "s1"})
    assert ctx.to_env() == dst.TraceContext.from_env_value(ctx.to_env()).to_env()
    assert dst.TraceContext.from_wire({"t": 1, "s": "x"}) is None
    assert dst.TraceContext.from_env_value("not json") is None


def test_install_from_env_roots_the_process(monkeypatch):
    ctx = jax_context.new_trace(phase="x")
    monkeypatch.setenv("EDL_TPU_TRACE_CONTEXT", ctx.to_env())
    got = torch_context.install_from_env()
    assert got.trace_id == ctx.trace_id and torch_context.current().trace_id == ctx.trace_id
    with torch_context.use(torch_context.new_trace()) as inner:
        assert torch_context.current() is inner
    assert torch_context.current().trace_id == ctx.trace_id


def _write_spans(ctx_mod, trace_mod, path, monkeypatch):
    clock = FakeClock()
    ids = (f"{i:016x}" for i in itertools.count(1))
    monkeypatch.setattr(trace_mod, "time", clock)
    monkeypatch.setattr(ctx_mod, "_span_id", lambda: next(ids))
    root = ctx_mod.TraceContext("a" * 32, "b" * 16, None, {"job": "j"})
    tr = trace_mod.Tracer(str(path), component="trainer")
    tr.emit("bare", at=12.0, stage="s1")
    with ctx_mod.use(root):
        with tr.span("train/restore", step=7):
            tr.emit("inside", epoch=1, counters={"compute": 0.5})
            with tr.span("train/restore_peer", step=7):
                pass
        try:
            with tr.span("train/reshard", mode="grow"):
                raise RuntimeError("x")
        except RuntimeError:
            pass
    tr.close()
    return _read(path)


def test_the_same_spans_under_a_fake_clock_write_the_same_records(tmp_path, monkeypatch):
    want = _write_spans(jax_context, jax_trace, tmp_path / "jax.jsonl", monkeypatch)
    got = _write_spans(torch_context, torch_trace, tmp_path / "torch.jsonl", monkeypatch)
    assert len(got) == 5 and got == want
    assert got[2]["name"] == "train/restore_peer" and got[2]["parent_id"] == got[3]["span_id"]


def test_configure_from_env_idempotent_and_null_tracer_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("EDL_TPU_TRACE_DIR", raising=False)
    assert torch_trace.configure_from_env("unit") is None
    assert isinstance(torch_trace.get_tracer(), torch_trace.NullTracer)
    monkeypatch.setenv("EDL_TPU_TRACE_DIR", str(tmp_path))
    tr = torch_trace.configure_from_env("unit")
    try:
        assert tr is torch_trace.get_tracer() and torch_trace.configure_from_env("unit") is tr
        torch_trace.emit("e1", at=1.0)
        (trace_file,) = tmp_path.glob("trace-unit-*.jsonl")
        assert _read(trace_file) == [{"ts": 1.0, "name": "e1", "component": "unit"}]
    finally:
        torch_trace.install(torch_trace.NullTracer()).close()


def test_tracer_rotates_at_cap_and_counts_drops(tmp_path):
    from edl_tpu_torch.obs.trace import _DROPPED_TOTAL, _ROTATIONS_TOTAL

    path = tmp_path / "t.jsonl"
    tr = torch_trace.Tracer(str(path), "unit", max_bytes=2048)
    rotations0 = _ROTATIONS_TOTAL.value
    for i in range(200):
        tr.emit("spin", at=float(i), i=i)
    tr.close()
    assert _ROTATIONS_TOTAL.value > rotations0
    live, old = _read(path), _read(tmp_path / "t.jsonl.1")
    assert live[-1]["i"] == 199 and old[-1]["i"] == live[0]["i"] - 1
    assert path.stat().st_size <= 2048
    tr = torch_trace.Tracer(str(tmp_path / "d.jsonl"), "unit")
    dropped0 = _DROPPED_TOTAL.labels(reason="write").value
    tr._f.close()
    tr.emit("lost", at=1.0)
    assert _DROPPED_TOTAL.labels(reason="write").value == dropped0 + 1


def test_jax_dump_merges_a_port_trace_file(tmp_path, capsys):
    ctx = torch_context.new_trace()
    tr = torch_trace.Tracer(str(tmp_path / "trace-trainer-1.jsonl"), "trainer")
    with torch_context.use(ctx):
        with tr.span("train/restore", step=3):
            pass
        tr.emit("train/step_phases", dur=0.1, step=4, steps=1,
                counters={"compute": 0.09, "hooks": 0.01})
    tr.emit("train/epoch", dur=1.0, epoch=0, steps=4, world=1)
    tr.close()
    (tmp_path / "trace-launcher-2.jsonl").write_text(json.dumps(
        {"ts": 1.0, "name": "resize/detect", "component": "launcher",
         "trace_id": ctx.trace_id}) + "\n")
    events, skipped = jax_dump.read_trace_dir(str(tmp_path))
    assert skipped == 0 and len(events) == 4
    timeline = jax_dump.merge_timeline(events, ctx.trace_id)
    assert [e["name"] for e in timeline] == ["resize/detect", "train/restore",
                                             "train/step_phases"]
    pf = json.loads(json.dumps(jax_dump.to_perfetto(events)))
    assert any(e.get("name") == "train/restore" and e["ph"] == "X" for e in pf["traceEvents"])
    assert any(e["ph"] == "C" for e in pf["traceEvents"]), "counters become counter tracks"
    out = tmp_path / "out.json"
    assert jax_dump.main(["--merge", "--trace_dir", str(tmp_path), "--trace", ctx.trace_id,
                          "--perfetto", str(out)]) == 0
    assert "train/restore" in capsys.readouterr().out
