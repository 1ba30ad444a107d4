"""The port's flight recorder (``edl_tpu_torch/obs/flightrec.py``): the
cases of ``tests/test_obs_flightrec.py`` (ring eviction, the log ring and
the scrape source, the trace tap through a ``NullTracer``), the installed
recorder's ``GET /flightrec`` read over HTTP with its log ring on the
``edl_tpu_torch`` logger, ``EDL_TPU_FLIGHTREC=0``, and the JAX package's
postmortem bundler reading a port process's rings."""

import json
import logging
import os
import time
import urllib.error
import urllib.request

import pytest

from edl_tpu.obs.bundle import capture_bundle
from edl_tpu.obs.dump import read_trace_dir
from edl_tpu_torch.obs import exposition, flightrec
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.obs.exposition import MetricsServer
from edl_tpu_torch.obs.flightrec import FlightRecorder
from edl_tpu_torch.obs.metrics import Registry


@pytest.fixture
def server():
    srv = MetricsServer(Registry(), host="127.0.0.1").start()
    yield srv
    srv.stop()


@pytest.fixture
def installed(monkeypatch):
    """A fresh process recorder, uninstalled after the test."""
    monkeypatch.delenv("EDL_TPU_FLIGHTREC", raising=False)
    flightrec.uninstall()
    rec = flightrec.install("trainer")
    yield rec
    flightrec.uninstall()


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=10) as resp:
        return resp.read().decode()


def test_flightrec_ring_evicts_oldest_under_pressure():
    rec = FlightRecorder("test", capacity=16)
    ev_evicted0 = rec._ev_evicted.value
    for i in range(50):
        rec.record_event({"ts": float(i), "name": f"e{i}"})
    snap = rec.snapshot()
    assert [e["name"] for e in snap["events"]] == [f"e{i}" for i in range(34, 50)]
    assert rec._ev_evicted.value - ev_evicted0 == 34
    assert snap["capacity"] == 16 and snap["pid"] == os.getpid()


def test_flightrec_snapshot_logs_and_scrape_source():
    rec = FlightRecorder("test", capacity=32)
    rec.record_log(logging.LogRecord("edl_tpu_torch.x", logging.WARNING, "f.py", 7,
                                     "boom %d", (3,), None))
    snap = rec.snapshot()
    assert (snap["logs"][0]["msg"], snap["logs"][0]["level"]) == ("boom 3", "WARNING")
    assert snap["metrics"]["source"] == "live"
    rec.note_scrape("edl_fake_total 1\n")
    snap = rec.snapshot(limit=5)
    assert snap["metrics"] == {"ts": snap["metrics"]["ts"], "source": "scrape",
                               "text": "edl_fake_total 1\n"}


def test_trace_tap_feeds_ring_through_null_tracer():
    rec = FlightRecorder("test", capacity=8)
    tracer = obs_trace.NullTracer()
    tracer.emit("quiet/event", x=1)
    obs_trace.add_tap(rec.record_event)
    try:
        tracer.emit("ring/event", x=2)
        with tracer.span("ring/span"):
            pass
    finally:
        obs_trace.remove_tap(rec.record_event)
    events = rec.snapshot()["events"]
    assert [e["name"] for e in events] == ["ring/event", "ring/span"]
    assert "dur" in events[1]


def test_installed_recorder_serves_flightrec_over_http(installed, server):
    assert flightrec.install("trainer") is installed           # idempotent
    logging.getLogger("edl_tpu_torch.train.trainer").warning("step %d stalled", 41)
    obs_trace.emit("train/epoch", epoch=0, steps=4)
    page = _get(server, "/metrics")                            # a scrape the ring keeps
    snap = json.loads(_get(server, "/flightrec?n=10"))
    assert snap["component"] == "trainer" and snap["pid"] == os.getpid()
    assert any(r["msg"] == "step 41 stalled" and r["logger"] == "edl_tpu_torch.train.trainer"
               for r in snap["logs"])
    assert any(e["name"] == "train/epoch" for e in snap["events"])
    assert snap["metrics"]["source"] == "scrape" and snap["metrics"]["text"] == page
    flightrec.uninstall()
    assert flightrec.installed() is None
    with pytest.raises(urllib.error.HTTPError):
        _get(server, "/flightrec")
    assert not any(isinstance(h, flightrec._RingHandler)
                   for h in logging.getLogger("edl_tpu_torch").handlers)


def test_flightrec_env_off(monkeypatch):
    flightrec.uninstall()
    monkeypatch.setenv("EDL_TPU_FLIGHTREC", "0")
    assert flightrec.install("trainer") is None and flightrec.installed() is None


def test_jax_bundle_freezes_a_port_process_rings(tmp_path, server, monkeypatch):
    rec = FlightRecorder("trainer", capacity=32)
    rec.record_event({"ts": 1.0, "name": "train/step_phases", "trace_id": "tid-1"})
    monkeypatch.setitem(exposition._routes, "/flightrec", rec.route)
    targets = {"live": {"endpoint": f"127.0.0.1:{server.port}", "component": "trainer"}}
    incident = {"id": "abc123", "name": "alert/straggler", "trace_id": "tid-1",
                "ts": time.time()}
    manifest = capture_bundle(None, "job-b", rule_name="straggler", incident=incident,
                              out_dir=str(tmp_path), timeout=2.0, targets=targets)
    assert manifest["flightrec_rings"] == 1 and not manifest["missing"]
    events, _ = read_trace_dir(manifest["path"])
    assert any(e.get("trace_id") == "tid-1" and e["name"] == "train/step_phases"
               for e in events)
