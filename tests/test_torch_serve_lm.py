"""The port's serving front (``edl_tpu_torch/serve_lm.py``, ``distill/teacher.py``,
``rpc/server.py``, ``coord/register.py``) on the CPU: the JAX package's own
``TeacherClient`` reads the port's ``TeacherServer`` and ``_ContinuousServer``,
whose greedy tokens equal the JAX package's ``generate`` from the same
weights; coalescing, slicing, mixed shapes and stop, mirroring
``tests/test_teacher_server.py``; the CLI restores a checkpoint the port's
``train_lm`` wrote and runs on the card unless given ``--device cpu``; and a
leased ``Register`` against the JAX coordination server.  Every subprocess
and server call has its own time limit."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.distill.predict_client import TeacherClient as JaxTeacherClient
from edl_tpu.models import transformer as jtf
from edl_tpu.models.generate import generate as jgenerate
from edl_tpu_torch.distill.teacher import TeacherServer, _Request, lm_teacher
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.models.generate import generate
from edl_tpu_torch.serve_lm import _ContinuousServer, build_predict_fn, request
from edl_tpu_torch.serving import ContinuousBatcher

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=53, num_layers=1, embed_dim=32, num_heads=2, mlp_dim=64, max_len=64)
CLI_ARGS = ["--vocab", "53", "--layers", "1", "--embed", "32", "--heads", "2", "--mlp", "64",
            "--max_len", "64", "--max_new_tokens", "4", "--temperature", "0"]


@pytest.fixture(scope="module")
def pair():
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, attention_impl="dense", **SMALL)
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **SMALL)
    params = jax.jit(jtf.TransformerLM(jc).init)(jax.random.key(0),
                                                jnp.zeros((1, 4), jnp.int32))["params"]
    tm = ttf.TransformerLM(tc)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
    return jc, params, tm


def _jax_request(endpoint, prompts, timeout=60.0):
    client = JaxTeacherClient(endpoint, ["tokens"], timeout=timeout, first_timeout=timeout)
    try:
        return client.predict({"ids": prompts.astype(np.int32)})["tokens"]
    finally:
        client.close()


def _jax_greedy(jc, params, prompts, n):
    return np.asarray(jax.jit(lambda p, x: jgenerate(jc, p, x, n, temperature=0))(
        params, jnp.asarray(prompts)))


def slow_double(delay=0.05):
    def predict(feed):
        time.sleep(delay)  # hold the inference thread so requests pile up
        return {"out": feed["x"] * 2.0}
    return predict


def test_concurrent_requests_coalesce_and_slice_correctly():
    server = TeacherServer(slow_double(), host="127.0.0.1", buckets=(4, 8, 16, 32),
                           coalesce_wait_ms=20.0)
    try:
        results = {}

        def call(i):
            client = JaxTeacherClient(server.endpoint, ["out"], timeout=30, first_timeout=30)
            results[i] = client.predict({"x": np.full((4, 2), float(i), np.float32)})["out"]
            client.close()

        threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        for i in range(6):
            assert results[i].shape == (4, 2) and float(results[i][0, 0]) == 2.0 * i
        stats = server.stats()
        assert stats["requests"] == 6 and stats["rows"] == 24
        assert stats["forward_passes"] < 6, stats        # passes were shared
    finally:
        server.stop()


def test_mixed_shapes_do_not_coalesce():
    server = TeacherServer(slow_double(0.0), host="127.0.0.1", buckets=(4, 8))
    try:
        a = _Request({"x": np.ones((4, 2), np.float32)}, ["out"], 4)
        b = _Request({"x": np.full((4, 3), 3.0, np.float32)}, ["out"], 4)
        results = server._infer([a, b])
        assert results[0]["out"].shape == (4, 2) and results[1]["out"].shape == (4, 3)
        assert float(results[1]["out"][0, 0]) == 6.0
        assert server.stats()["forward_passes"] == 2
    finally:
        server.stop()


def test_stop_rejects_new_requests():
    server = TeacherServer(slow_double(0.0), host="127.0.0.1")
    server.stop()
    client = JaxTeacherClient(server.endpoint, ["out"], retries=1, timeout=2.0,
                              first_timeout=2.0)
    with pytest.raises(ConnectionError):
        client.predict({"x": np.ones((2, 2), np.float32)})
    client.close()


def test_serve_generate_roundtrip_through_the_jax_client(pair):
    jc, params, tm = pair
    server = TeacherServer(build_predict_fn(tm, max_new_tokens=6, temperature=0.0, top_k=0),
                           host="127.0.0.1", device="cpu")
    try:
        prompts = np.asarray([[3, 1, 4], [1, 5, 9]], np.int32)
        toks = _jax_request(server.endpoint, prompts)
        assert toks.shape == (2, 6) and toks.dtype == np.int32
        np.testing.assert_array_equal(toks, _jax_greedy(jc, params, prompts, 6))
        np.testing.assert_array_equal(request(server.endpoint, prompts, timeout=60), toks)
        assert server.stats()["rows"] == 4
    finally:
        server.stop()


def test_serve_sampling_varies_between_requests(pair):
    server = TeacherServer(build_predict_fn(pair[2], max_new_tokens=8, temperature=1.2,
                                            top_k=0), host="127.0.0.1")
    try:
        prompts = np.asarray([[7, 7]], np.int32)
        a = request(server.endpoint, prompts, timeout=60)
        b = request(server.endpoint, prompts, timeout=60)
        assert (a != b).any()      # a fresh generator per call
    finally:
        server.stop()


def test_continuous_server_roundtrip_through_the_jax_client(pair):
    """Concurrent JAX clients share the engine's decode batch; greedy
    tokens equal JAX's generate."""
    jc, params, tm = pair
    engine = ContinuousBatcher(tm, slots=2, temperature=0.0, prefill_buckets=(8, 16),
                               steps_per_sync=4)
    server = _ContinuousServer(engine, max_new_tokens=6, host="127.0.0.1")
    try:
        prompts = np.asarray([[3, 1, 4], [1, 5, 9]], np.int32)
        with ThreadPoolExecutor(3) as pool:
            results = list(pool.map(lambda _: _jax_request(server.endpoint, prompts), range(3)))
        want = _jax_greedy(jc, params, prompts, 6)
        for toks in results:
            np.testing.assert_array_equal(toks, want)
        stats = engine.stats()
        assert stats["requests_done"] == 6 and stats["tokens_emitted"] == 36
    finally:
        server.stop()


def test_lm_teacher_pads_rows_and_slices(pair):
    tm = pair[2]
    engine = ContinuousBatcher(tm, slots=2, temperature=0.0, prefill_buckets=(8,))
    server = TeacherServer(lm_teacher(engine, max_new=5), host="127.0.0.1", buckets=(4,))
    try:
        ids = np.asarray([[3, 1, 4, 0], [2, 7, 0, 0], [9, 9, 9, 9]], np.int32)
        lens = np.asarray([3, 2, 4], np.int32)
        client = JaxTeacherClient(server.endpoint, ["tokens"], timeout=60, first_timeout=60)
        toks = client.predict({"ids": ids, "lens": lens})["tokens"]
        client.close()
        assert toks.shape == (3, 5)
        for row, n, got in zip(ids, lens, toks):
            want = generate(tm, torch.from_numpy(row[None, :n]), 5, temperature=0).numpy()[0]
            np.testing.assert_array_equal(got, want)
    finally:
        server.stop()
        engine.stop()


def _train_checkpoint(tmp_path) -> Path:
    """A checkpoint of the port's train_lm at the CLI's widths, on the CPU."""
    ckpt = tmp_path / "ckpt"
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(PYTHONPATH=str(ROOT), EDL_TPU_CKPT_DIR=str(ckpt))
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.train_lm", "--device", "cpu",
                          "--vocab", "53", "--layers", "1", "--embed", "32", "--heads", "2",
                          "--mlp", "64", "--seq_len", "16", "--batch_size", "2",
                          "--steps_per_epoch", "3", "--epochs", "1"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return ckpt


def _boot_cli(tmp_path, extra_args, timeout=120):
    """Start the CLI with its output in a file; returns (proc, endpoint)."""
    log = tmp_path / f"serve-{time.monotonic_ns()}.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "edl_tpu_torch.serve_lm", *CLI_ARGS,
                                 "--port", "0", *extra_args],
                                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        text = log.read_text()
        if "[serve_lm] serving on" in text:
            return proc, text.split("serving on")[1].split()[0]
        if proc.poll() is not None:
            raise AssertionError(f"serve_lm exited {proc.returncode}: {text[-3000:]}")
        time.sleep(0.1)
    proc.kill()
    raise AssertionError("serve_lm never announced its endpoint")


def _stop_cli(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        assert proc.wait(timeout=30) == 0
    except subprocess.TimeoutExpired:
        proc.kill()
        raise


@pytest.mark.parametrize("continuous", [0, 2], ids=["batch", "continuous"])
def test_cli_restores_a_train_lm_checkpoint(tmp_path, continuous):
    """The served params are the checkpoint's: greedy tokens over the wire
    equal in-process generation from the checkpoint's model weights."""
    ckpt = _train_checkpoint(tmp_path)
    (step,) = [p for p in ckpt.iterdir() if p.name.isdigit()]
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **SMALL)
    tm = ttf.TransformerLM(tc)
    tm.load_state_dict(torch.load(step / "state.pt", weights_only=True)["model"])
    proc, endpoint = _boot_cli(tmp_path, ["--checkpoint_dir", str(ckpt), "--device", "cpu",
                                          "--continuous", str(continuous)])
    try:
        prompts = np.asarray([[2, 4, 6]], np.int32)
        toks = _jax_request(endpoint, prompts)
        want = generate(tm, torch.from_numpy(prompts), 4, temperature=0).numpy()
        np.testing.assert_array_equal(toks, want)
        # the checkpoint is not the seed-0 init the CLI falls back to
        assert not torch.equal(tm.lm_head.weight, ttf.TransformerLM(tc).lm_head.weight)
    finally:
        _stop_cli(proc)


def test_cli_runs_on_the_card_unless_asked(tmp_path):
    """Without a card the CLI raises NoCardError by default; a missing
    checkpoint is an error, not a random model."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.serve_lm", *CLI_ARGS],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "NoCardError" in out.stderr
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.serve_lm", *CLI_ARGS,
                          "--device", "cpu", "--checkpoint_dir", str(tmp_path / "none")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "no checkpoint" in out.stderr


def test_register_against_the_jax_coord_server(coord_server):
    """The key is present, with its value, while registered; an update
    lands; the key is gone after stop (the lease revoked)."""
    from edl_tpu_torch.coord.client import CoordClient
    from edl_tpu_torch.coord.register import Register, leased_register
    from edl_tpu_torch.distill.balance import server_key

    store = CoordClient(f"127.0.0.1:{coord_server.port}", timeout=10)
    key = server_key("lm", "10.0.0.1:1234")
    reg = Register(store, key, b"v1", ttl=2.0)
    try:
        assert store.get(key).value == b"v1" and store.get(key).lease_id == reg.lease_id
        reg.update(b"v2")
        time.sleep(2.5)                  # past one TTL: the keep-alive held it
        assert store.get(key).value == b"v2" and not reg.is_stopped
    finally:
        reg.stop()
    assert store.get(key) is None
    held = leased_register(store, "/seat", b"a", ttl=2.0)
    try:                                 # the client's put-if-absent respects a held key
        assert not store.put_if_absent("/seat", b"b", held.lease_id)
        assert store.get("/seat").value == b"a"
    finally:
        held.stop()
    assert store.put_if_absent("/seat", b"b") and store.get("/seat").value == b"b"
    store.delete("/seat")
    store.close()


def test_register_heals_a_lost_lease(coord_server):
    from edl_tpu_torch.coord.client import CoordClient
    from edl_tpu_torch.coord.register import Register

    store = CoordClient(f"127.0.0.1:{coord_server.port}", timeout=10)
    reg = Register(store, "/heal", b"x", ttl=1.0)
    try:
        old = reg.lease_id
        store.lease_revoke(old)              # the key goes with the lease
        deadline = time.monotonic() + 10
        while store.get("/heal") is None:
            assert time.monotonic() < deadline, "the key was never re-put"
            time.sleep(0.05)
        assert store.get("/heal").value == b"x" and reg.lease_id != old
    finally:
        reg.stop()
        store.close()


def test_teacher_advert_in_the_jax_coord_server(coord_server, pair):
    from edl_tpu.coord.client import CoordClient as JaxCoordClient
    from edl_tpu_torch.coord.client import CoordClient

    store = CoordClient(f"127.0.0.1:{coord_server.port}", timeout=10)
    server = TeacherServer(build_predict_fn(pair[2], 2, 0.0, 0), host="127.0.0.1")
    try:
        server.register(store, "lm", ttl=2.0, advert_period=0.1)
        request(server.endpoint, np.asarray([[1, 2]], np.int32), timeout=60)
        jstore = JaxCoordClient(f"127.0.0.1:{coord_server.port}")
        key = f"/edl_tpu_distill/lm/nodes/{server.endpoint}"
        deadline = time.monotonic() + 10
        while json.loads(jstore.get(key).value)["rows"] != 1:
            assert time.monotonic() < deadline, "the advert never showed the served row"
            time.sleep(0.05)
        assert json.loads(jstore.get(key).value)["endpoint"] == server.endpoint
    finally:
        server.stop()
    assert jstore.get(key) is None
    jstore.close()
    store.close()


def _interface_address() -> str:
    """A non-loopback IPv4 address of this host that accepts a connection
    from here, else the loopback address (read from the interfaces; no
    packet is sent)."""
    import fcntl
    import socket
    import struct

    from edl_tpu_torch.utils.network import _self_connectable

    for _, name in socket.if_nameindex():
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            try:                         # SIOCGIFADDR
                packed = fcntl.ioctl(s.fileno(), 0x8915, struct.pack("256s", name[:15].encode()))
            except OSError:
                continue
        ip = socket.inet_ntoa(packed[20:24])
        if not ip.startswith("127.") and _self_connectable(ip):
            return ip
    return "127.0.0.1"


@pytest.mark.parametrize("kind", ["teacher", "continuous"])
def test_advert_names_the_interface_that_reaches_the_store(pair, kind):
    """A server built without a host advertises the interface that routes
    to the store, as the JAX package's ``local_ip`` finds it, and not the
    loopback address when the store is reached over another interface."""
    from edl_tpu.coord.client import CoordClient as JaxCoordClient
    from edl_tpu.coord.server import start_server
    from edl_tpu.utils.network import local_ip as jax_local_ip
    from edl_tpu_torch.coord.client import CoordClient

    ip = _interface_address()
    coord = start_server("0.0.0.0", 0)
    store = CoordClient(f"{ip}:{coord.port}", timeout=10)
    if kind == "teacher":
        server = TeacherServer(build_predict_fn(pair[2], 2, 0.0, 0))
        server.register(store, "lm", ttl=2.0)
    else:
        server = _ContinuousServer(ContinuousBatcher(pair[2], slots=1, temperature=0.0,
                                                     prefill_buckets=(8,)), max_new_tokens=2)
        server.register(store, "lm")
    jstore = JaxCoordClient(f"127.0.0.1:{coord.port}")
    try:
        host, _, port = server.endpoint.rpartition(":")
        assert host == ip == jax_local_ip(ip)   # its probe takes a host
        assert (host == "127.0.0.1") == ip.startswith("127.")
        records, _ = jstore.get_prefix("/edl_tpu_distill/lm/nodes/")
        assert [r.key for r in records] == [f"/edl_tpu_distill/lm/nodes/{server.endpoint}"]
        np.testing.assert_array_equal(      # and peers reach it there
            _jax_request(server.endpoint, np.asarray([[1, 2]], np.int32)),
            request(f"127.0.0.1:{port}", np.asarray([[1, 2]], np.int32), timeout=60))
    finally:
        server.stop()
        jstore.close()
        store.close()
        coord.stop()
