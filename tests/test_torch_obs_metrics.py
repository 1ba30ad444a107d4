"""The port's metrics registry and /metrics endpoint (``edl_tpu_torch/obs/
metrics.py``, ``obs/exposition.py``) against the JAX package's: the same
``inc``/``set``/``observe`` sequence, with labels, renders the same text to
the byte, each package's ``parse_exposition`` reads the other's page, and
the cases of ``tests/test_metrics.py`` hold for the port."""

import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from edl_tpu.obs import metrics as jax_metrics
from edl_tpu_torch.obs import exposition
from edl_tpu_torch.obs import metrics as torch_metrics
from edl_tpu_torch.obs.exposition import CONTENT_TYPE, MetricsServer
from edl_tpu_torch.obs.metrics import Registry, parse_exposition


def _drive(mod, seed: int) -> str:
    """A seeded sequence of instrument calls on a fresh registry of
    ``mod``; the rendered page."""
    rng = np.random.default_rng(seed)
    r = mod.Registry()
    ops = r.counter("edl_ops_total", "Operations served", ("op", "code"))
    depth = r.gauge("edl_depth", "Queue depth")
    lat = r.histogram("edl_lat_seconds", "Latency", ("phase",))
    resize = r.histogram("edl_resize_seconds", "Resize", buckets=mod.RESIZE_BUCKETS)
    plain = r.counter("edl_plain_total", 'Help with \\ and\nnewline')
    for _ in range(200):
        k = int(rng.integers(5))
        if k == 0:
            ops.labels(op=str(rng.choice(["get", "put", 'we"ird\n'])),
                       code=str(int(rng.integers(3)))).inc(float(rng.integers(1, 4)))
        elif k == 1:
            depth.set(float(rng.normal()))
        elif k == 2:
            lat.labels(phase=str(rng.choice(["a", "b"]))).observe(float(rng.exponential(0.3)))
        elif k == 3:
            resize.observe(float(rng.exponential(20.0)))
        else:
            plain.inc()
            depth.inc(0.5)
    return r.render()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_calls_render_the_same_page_and_each_parser_reads_the_other(seed):
    jax_page, torch_page = _drive(jax_metrics, seed), _drive(torch_metrics, seed)
    assert torch_page == jax_page
    assert torch_metrics.parse_exposition(jax_page) == jax_metrics.parse_exposition(torch_page)
    assert torch_metrics.DEFAULT_BUCKETS == jax_metrics.DEFAULT_BUCKETS
    assert torch_metrics.RESIZE_BUCKETS == jax_metrics.RESIZE_BUCKETS


def test_concurrent_increments_from_threads():
    r = Registry()
    c = r.counter("ops_total", "ops", ("worker",))
    h = r.histogram("lat_seconds", "lat", buckets=(0.5,))
    g = r.gauge("depth", "depth")
    n, nthreads = 1000, 8

    def work(i):
        child = c.labels(worker=str(i % 2))
        for _ in range(n):
            child.inc()
            h.observe(0.1)
            g.inc()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.labels(worker="0").value == n * nthreads / 2
    assert c.labels(worker="1").value == n * nthreads / 2
    assert h.count == n * nthreads
    assert abs(h.sum - 0.1 * n * nthreads) < 1e-6
    assert g.value == n * nthreads


def test_label_handling():
    r = Registry()
    c = r.counter("x_total", "x", ("a", "b"))
    c.labels("1", "2").inc()
    c.labels(b="2", a="1").inc()
    assert c.labels("1", "2").value == 2.0
    for bad in (lambda: c.labels("1"), lambda: c.labels(a="1", z="2"), lambda: c.inc(),
                lambda: c.labels("1", "2").inc(-1), lambda: r.counter("x_total", "x", ("a",)),
                lambda: r.gauge("x_total")):
        with pytest.raises(ValueError):
            bad()
    assert r.counter("x_total", "x", ("a", "b")) is c


def test_exposition_byte_exact_and_parse_back():
    r = Registry()
    c = r.counter("edl_ops_total", "Operations served", ("op",))
    c.labels(op="get").inc(3)
    c.labels(op='we"ird\n').inc()
    r.gauge("edl_depth", "Queue depth").set(2.5)
    h = r.histogram("edl_lat_seconds", "Latency", buckets=(0.1, 1.0))
    for v in (0.25, 0.5, 7.0):
        h.observe(v)
    assert r.render() == (
        '# HELP edl_depth Queue depth\n'
        '# TYPE edl_depth gauge\n'
        'edl_depth 2.5\n'
        '# HELP edl_lat_seconds Latency\n'
        '# TYPE edl_lat_seconds histogram\n'
        'edl_lat_seconds_bucket{le="0.1"} 0.0\n'
        'edl_lat_seconds_bucket{le="1.0"} 2.0\n'
        'edl_lat_seconds_bucket{le="+Inf"} 3.0\n'
        'edl_lat_seconds_sum 7.75\n'
        'edl_lat_seconds_count 3.0\n'
        '# HELP edl_ops_total Operations served\n'
        '# TYPE edl_ops_total counter\n'
        'edl_ops_total{op="get"} 3.0\n'
        'edl_ops_total{op="we\\"ird\\n"} 1.0\n')
    parsed = parse_exposition(r.render())
    assert parsed[("edl_ops_total", (("op", 'we"ird\n'),))] == 1.0
    assert parsed[("edl_lat_seconds_bucket", (("le", "+Inf"),))] == 3.0
    assert parsed[("edl_lat_seconds_sum", ())] == 7.75
    with pytest.raises(ValueError):
        parse_exposition("this is not { prometheus\n")


def test_metrics_http_endpoint_serves_a_page_jax_parses():
    r = Registry()
    r.counter("up_total", "process up").inc()
    r.histogram("h_seconds", "h", ("phase",), buckets=(1.0,)).labels(phase="a").observe(0.5)
    srv = MetricsServer(r, host="127.0.0.1", port=0).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=5) as resp:
            assert resp.headers["Content-Type"] == CONTENT_TYPE
            text = resp.read().decode()
        parsed = jax_metrics.parse_exposition(text)
        assert parsed[("up_total", ())] == 1.0
        assert parsed[("h_seconds_bucket", (("le", "1.0"), ("phase", "a")))] == 1.0
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=5)
    finally:
        srv.stop()


def test_serve_from_env_writes_addr_file_and_is_off_without_env(tmp_path, monkeypatch):
    monkeypatch.setattr(exposition, "_server", None)
    monkeypatch.delenv("EDL_TPU_METRICS_PORT", raising=False)
    assert exposition.serve_from_env("unit") is None
    monkeypatch.setenv("EDL_TPU_METRICS_PORT", "0")
    monkeypatch.setenv("EDL_TPU_METRICS_DIR", str(tmp_path))
    srv = exposition.serve_from_env("unit", Registry())
    try:
        assert srv is not None and exposition.serve_from_env("unit") is srv
        (addr_file,) = tmp_path.glob("metrics-unit-*.addr")
        assert addr_file.read_text().strip().endswith(f":{srv.port}")
    finally:
        exposition.shutdown_installed()
    assert exposition.installed_server() is None
