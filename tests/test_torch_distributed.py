"""The port's elastic multi-process trainer on the CPU: a 2-rank gloo world
formed from a launcher-shaped env against the single-process run and the
JAX package's train step, a stop-resume across a world change 2 -> 1, the
train-status and heartbeat records against the JAX package's store, and
``initialize_from_env``'s gates.  Each worker process has its own time
limit, so a hung rendezvous fails its test."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from edl_tpu.cluster import heartbeat as jax_heartbeat
from edl_tpu.cluster import train_status as jax_train_status
from edl_tpu.coord.client import CoordClient as JaxCoordClient
from edl_tpu.models import transformer as jtf
from edl_tpu.rpc import framing as jax_framing
from edl_tpu.train.state import TrainState as JaxTrainState
from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster import heartbeat, train_status
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.coord.client import CoordClient, connect, connect_wait
from edl_tpu_torch.data.elastic_input import device_put_stream
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.rpc import framing
from edl_tpu_torch.train import distributed
from edl_tpu_torch.train import lr as lr_mod
from edl_tpu_torch.utils.network import find_free_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "helpers" / "torch_dp_worker.py"
REFORM_WORKER = ROOT / "tests" / "helpers" / "torch_reform_worker.py"
WORKER_TIMEOUT = 120      # seconds per worker process
# the 2-rank world's shape: 2 layers, width 64, 2 rows a rank, pure data
# parallelism (--tp 1; train_lm's auto tp would split this world over tp)
SMALL = dict(vocab_size=97, num_layers=2, embed_dim=64, num_heads=2, mlp_dim=128, max_len=16)
FLAGS = ["--device", "cpu", "--vocab", "97", "--layers", "2", "--embed", "64", "--heads", "2",
         "--mlp", "128", "--seq_len", "16", "--batch_size", "2", "--fused_ce", "--ce_block", "64",
         "--lr", "3e-3", "--tp", "1"]
# f32 parameters after 3 AdamW steps at lr 3e-3, against one process on the
# global batch and against the JAX step: they differ by the order of f32
# sums (the all-reduce of two half-batch gradients; another framework's
# kernels), which AdamW's normalised steps carry into the weights (measured
# on a CPU: at most 5.7e-7 and 3.5e-6 absolute, losses 1e-7 relative)
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
LOSS_RTOL = 1e-6


def _launch_env(rank, world, port, **extra):
    """The env the launcher exports to one trainer (one trainer a pod)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update({"PYTHONPATH": str(ROOT), "EDL_TPU_JOB_ID": "dp-test",
                "EDL_TPU_TRAINER_ID": str(rank), "EDL_TPU_TRAINER_RANK_IN_POD": "0",
                "EDL_TPU_TRAINERS_NUM": str(world), "EDL_TPU_COORDINATOR": f"127.0.0.1:{port}",
                "EDL_TPU_TRAINER_ENDPOINTS": ",".join(f"127.0.0.1:{port + r}"
                                                      for r in range(world)),
                "EDL_TPU_POD_ID": f"pod-{rank}", "EDL_TPU_POD_RANK": str(rank),
                "OMP_NUM_THREADS": "2"})
    env.update(extra)
    return env


def _run_world(mode, io_dir, argv, world=2, **extra):
    """Run ``world`` worker ranks to completion; each is killed at its time
    limit.  Output goes to files: a rank blocked on a full pipe would hold
    its peers in a collective."""
    port = find_free_port()
    logs = [open(io_dir / f"log{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), mode, str(io_dir), *argv],
                              env=_launch_env(r, world, port, **extra), cwd=ROOT,
                              stdout=log, stderr=subprocess.STDOUT, text=True)
             for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    outs = [(io_dir / f"log{r}.txt").read_text() for r in range(world)]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [torch.load(io_dir / f"out{r}.pt", weights_only=True) for r in range(world)], outs


def _jax_init(ids):
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, attention_impl="dense", **SMALL)
    jm = jtf.TransformerLM(jc)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(ids[:, :-1]))["params"]
    return jc, jm, params


def _jax_steps(jc, jm, params, batches, lr=3e-3):
    """The JAX trainer's step body on the global batches: the fused CE
    loss, its gradient, optax AdamW."""
    @jax.jit
    def jstep(state, ids):
        def lf(p):
            h = jm.apply({"params": p}, ids[:, :-1], return_hidden=True)
            return jtf.lm_loss_fused(p, h, ids[:, 1:], jc, block_size=64)
        loss, grads = jax.value_and_grad(lf)(state.params)
        return state.apply_gradients(grads), loss

    state = JaxTrainState.create(params, optax.adamw(lr))
    losses = []
    for ids in batches:
        state, loss = jstep(state, jnp.asarray(ids))
        losses.append(float(loss))
    return state.params, losses


def test_two_rank_gloo_world_matches_one_process_and_jax(tmp_path):
    """(a) 3 steps of a 2-rank world, each rank on half of every global
    batch: both ranks end with identical parameters, equal to one process
    on the whole global batch and to the JAX step; the logged loss is the
    global mean; evaluate over ragged shards (2 batches and 1) is the
    global sample-weighted mean."""
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, SMALL["vocab_size"], (4, 17)).astype(np.int32) for _ in range(3)]
    evals = [rng.integers(0, SMALL["vocab_size"], (2, 17)).astype(np.int32) for _ in range(3)]
    jc, jm, jparams = _jax_init(batches[0])
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **SMALL)
    weights = params_from_jax(jax.tree.map(np.asarray, jparams), tc)
    torch.save({"weights": weights, "batches": [torch.from_numpy(b) for b in batches],
                "eval": [torch.from_numpy(b) for b in evals]}, tmp_path / "in.pt")
    (out0, out1), _ = _run_world("steps", tmp_path, FLAGS)
    assert out0["world"] == out1["world"] == 2 and (out0["rank"], out1["rank"]) == (0, 1)
    for name, p0 in out0["params"].items():
        assert torch.equal(p0, out1["params"][name]), name
    assert out0["losses"] == out1["losses"] and out0["eval"] == out1["eval"]

    # one process on the concatenated global batch
    args = train_lm.parse_args(FLAGS)
    cfg, trainer, _, tx = train_lm.build_trainer(args, torch.device("cpu"))

    def init():
        model = ttf.TransformerLM(cfg)
        model.load_state_dict(weights)
        return model, None

    state = trainer.create_state(init, tx)
    losses = []
    for batch, _ in device_put_stream(({"ids": ids} for ids in batches), trainer.device):
        state, metrics = trainer.step_fn(state, batch, torch.Generator().manual_seed(0))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(out0["losses"], losses, rtol=LOSS_RTOL, atol=0)
    for name, p in state.model.state_dict().items():
        torch.testing.assert_close(out0["params"][name], p, atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   msg=name)
    val = trainer.evaluate(state, [{"ids": b} for b in evals], train_lm.metric_fn)
    np.testing.assert_allclose(out0["eval"]["nll"], val["nll"], rtol=1e-5)

    # the JAX package's train step on the same global batches and weights
    jfinal, jlosses = _jax_steps(jc, jm, jparams, batches)
    np.testing.assert_allclose(out0["losses"], jlosses, rtol=LOSS_RTOL, atol=0)
    for name, p in params_from_jax(jax.tree.map(np.asarray, jfinal), tc).items():
        torch.testing.assert_close(out0["params"][name], p, atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   msg=name)


def test_world_change_two_to_one_resumes_and_rescales_lr(tmp_path, monkeypatch):
    """(b) A 2-rank world saves at an epoch's end; one process restores it:
    rank 0's parameters, the next epoch, the history [2, 1], and the LR
    scale 0.5 under EDL_TPU_LR_RESCALE=1 (1.0 without it)."""
    ckpt = tmp_path / "ckpt"
    flags = FLAGS + ["--steps_per_epoch", "2"]
    (out0, out1), logs = _run_world("main", tmp_path, flags + ["--epochs", "1"],
                                    EDL_TPU_CKPT_DIR=str(ckpt), EDL_TPU_LR_RESCALE="1")
    assert "rank=0/2" in logs[0] and "rank=1/2" in logs[1], logs
    assert '"world": 2' in logs[0]
    assert out0["epoch_worlds"] == [2] and out0["lr_scale"] == 1.0 and out0["step"] == 2
    plain = tmp_path / "plain"
    shutil.copytree(ckpt, plain)

    for var in [k for k in os.environ if k.startswith("EDL_TPU_")]:
        monkeypatch.delenv(var)
    monkeypatch.setenv("EDL_TPU_LR_RESCALE", "1")
    args = train_lm.parse_args(flags)
    _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"), str(ckpt))
    state, meta = trainer.restore_or_create(init_fn, tx)
    assert (state.step, meta.next_epoch, trainer.world_size) == (2, 1, 1)
    assert lr_mod.lr_scale(state) == 0.5
    for name, p in state.model.state_dict().items():
        assert torch.equal(p, out0["params"][name]), name

    monkeypatch.setenv("EDL_TPU_CKPT_DIR", str(ckpt))
    state, meta = train_lm.main(flags + ["--epochs", "2"])
    assert [e.world_size for e in meta.epochs] == [2, 1] and meta.next_epoch == 2
    assert state.step == 4 and lr_mod.lr_scale(state) == 0.5

    monkeypatch.delenv("EDL_TPU_LR_RESCALE")
    monkeypatch.setenv("EDL_TPU_CKPT_DIR", str(plain))
    state, meta = train_lm.main(flags + ["--epochs", "2"])
    assert [e.world_size for e in meta.epochs] == [2, 1] and lr_mod.lr_scale(state) == 1.0


def test_framing_bytes_are_the_jax_servers():
    for obj in ({"m": "kv_put", "a": {"key": "/k", "value": b"\x00v", "lease_id": 0}},
                {"s": None, "r": {"rec": ["/k", b"v", 3, 0]}}, [1, 2.5, "x", None]):
        assert framing.pack(obj) == jax_framing.pack(obj)


def test_status_and_heartbeat_wire_compatible_with_the_jax_store(coord_server):
    """(c) The port's client writes train statuses and beats the JAX
    package's functions read back from the JAX coordination server, and
    the reverse."""
    ep = f"127.0.0.1:{coord_server.port}"
    ours, theirs = connect(ep), JaxCoordClient(ep)
    try:
        train_status.save_train_status(ours, "j", "pod-a", train_status.TrainStatus.NEARTHEEND)
        heartbeat.beat(ours, "j", "pod-a", now=123.5, threshold=240.0)
        assert jax_train_status.load_train_statuses(theirs, "j") == {
            "pod-a": jax_train_status.TrainStatus.NEARTHEEND}
        assert jax_heartbeat.last_beat_info(theirs, "j", "pod-a") == (123.5, 240.0)

        jax_train_status.save_train_status(theirs, "j", "pod-b",
                                           jax_train_status.TrainStatus.RUNNING)
        jax_heartbeat.beat(theirs, "j", "pod-b", now=7.25)
        assert train_status.load_train_statuses(ours, "j") == {
            "pod-a": train_status.TrainStatus.NEARTHEEND,
            "pod-b": train_status.TrainStatus.RUNNING}
        assert heartbeat.last_beat_info(ours, "j", "pod-b") == (7.25, None)
        assert train_status.SCALABLE == tuple(train_status.TrainStatus(s.value)
                                              for s in jax_train_status.SCALABLE)
        heartbeat.clear(ours, "j", "pod-b")
        assert jax_heartbeat.last_beat_info(theirs, "j", "pod-b") is None
        # connect_wait seats on the live endpoint, and gives up on a dead one
        waited = connect_wait(f"127.0.0.1:{find_free_port()},{ep}", wait=10.0)
        assert waited.endpoint == ep
        waited.close()
        with pytest.raises(ConnectionError):
            connect_wait(f"127.0.0.1:{find_free_port()}", wait=0.5)
    finally:
        ours.close()
        theirs.close()


class _RecordingClient(CoordClient):
    """The port's client, recording every key it writes."""

    def __init__(self, ep):
        super().__init__(ep)
        self.puts = []

    def put(self, key, value, lease_id=0, _timeout=None):
        self.puts.append((key, value))
        return super().put(key, value, lease_id, _timeout)


def test_trainer_reports_status_and_beats(coord_server):
    """The trainer under a store: RUNNING, NEARTHEEND for the last epoch,
    SUCCEED, read back by the JAX loader, and a heartbeat after the first
    step with the auto threshold's floor (rank 0 in the pod)."""
    ep = f"127.0.0.1:{coord_server.port}"
    store = _RecordingClient(ep)
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": "j", "EDL_TPU_POD_ID": "pod-a",
                       "EDL_TPU_COORD_ENDPOINTS": ep})
    args = train_lm.parse_args(FLAGS + ["--steps_per_epoch", "2"])
    _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"), "", store, tenv)
    state, meta = trainer.restore_or_create(init_fn, tx)

    def data_fn(epoch):
        gen = train_lm.markov_corpus(args, epoch)
        for _ in range(args.steps_per_epoch):
            yield next(gen)

    trainer.fit(state, meta, data_fn, epochs=3)
    statuses = [v.decode() for k, v in store.puts if "/train_status/" in k]
    assert statuses == ["running", "neartheend", "succeed"], statuses
    beats = [v for k, v in store.puts if "/heartbeat/" in k]
    assert len(beats) == 1, beats          # throttled to heartbeat_every (10 s)
    theirs = JaxCoordClient(ep)
    try:
        assert jax_train_status.load_train_status(theirs, "j", "pod-a") == \
            jax_train_status.TrainStatus.SUCCEED
        ts, thr = jax_heartbeat.last_beat_info(theirs, "j", "pod-a")
        assert thr == heartbeat.AUTO_FLOOR == jax_heartbeat.AUTO_FLOOR and ts > 0
    finally:
        theirs.close()
        store.close()


def test_initialize_from_env_gates(monkeypatch, memkv):
    """(d) World 1 forms no group; under the launcher's live-reshard path
    (EDL_TPU_RESIZE_DELTA, on unless 0) world 1 still forms none, and the
    resizable world forms (a group of one here) through the store, gated by
    the stage's world record the JAX package publishes; a world with no
    coordinator raises."""
    from edl_tpu.cluster import resize as jax_resize

    base = {"EDL_TPU_TRAINERS_NUM": "1", "EDL_TPU_TRAINER_ID": "0"}
    for var in [k for k in os.environ if k.startswith("EDL_TPU_")]:
        monkeypatch.delenv(var)
    tenv = distributed.initialize_from_env(TrainerEnv(base), "cpu")
    assert tenv.world_size == 1 and not dist.is_initialized()
    assert distributed.connect_store(tenv) is None and distributed.is_coordinator(tenv)

    launched = {**base, "EDL_TPU_CLUSTER_STAGE": "s1", "EDL_TPU_COORD_ENDPOINTS": "127.0.0.1:1",
                "EDL_TPU_JOB_ID": "gate"}
    for value in ("1", None):
        if value is None:
            monkeypatch.delenv("EDL_TPU_RESIZE_DELTA")
        else:
            monkeypatch.setenv("EDL_TPU_RESIZE_DELTA", value)
        assert distributed.initialize_from_env(TrainerEnv(launched), "cpu").world_size == 1
        assert not dist.is_initialized()
        jax_resize.publish_world_service(memkv, "gate", "s1", f"10.0.0.1:{value}", 1)
        distributed.form_world(TrainerEnv(launched), memkv, "cpu", timeout=30.0)
        try:
            assert dist.is_initialized() and dist.get_world_size() == 1
            t = torch.ones(3)
            dist.all_reduce(t)
            assert t.tolist() == [1.0, 1.0, 1.0]
            gate = json.loads(memkv.get("/edl_tpu/gate/torchworld/s1/gate").value)
            assert gate["nonce"] == f"10.0.0.1:{value}" and gate["world"] == 1
        finally:
            distributed.leak_world()
        assert not dist.is_initialized()
    monkeypatch.setenv("EDL_TPU_RESIZE_DELTA", "0")
    assert distributed.initialize_from_env(TrainerEnv(launched), "cpu").world_size == 1
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no coordinator"):
        distributed.initialize_from_env(TrainerEnv({"EDL_TPU_TRAINERS_NUM": "2"}), "cpu")


def test_resizable_world_reforms_in_place(coord_server, tmp_path):
    """(e) The resizable world through the store rendezvous, as the launcher
    drives it: a gloo world of 2 forms from the launcher's env (gated by the
    stage's world record the JAX package publishes), re-forms in place to 3
    when a third process joins, forms the same stage again under a new
    nonce, and shrinks to 1.  The same processes throughout (pids), a
    correct all-reduce after each formation, and the env updated in place;
    each process under its 120 s limit."""
    import time

    from edl_tpu.cluster import resize as jax_resize
    from edl_tpu_torch.cluster.cluster import Cluster
    from edl_tpu_torch.cluster.pod import Pod, Trainer

    ep = f"127.0.0.1:{coord_server.port}"
    kv = JaxCoordClient(ep)
    job = "reform"
    base = f"/edl_tpu/{job}"

    def env(pod, rank, world, stage):
        e = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
        e.update({"PYTHONPATH": str(ROOT), "EDL_TPU_JOB_ID": job, "EDL_TPU_POD_ID": pod,
                  "EDL_TPU_TRAINER_ID": str(rank), "EDL_TPU_TRAINER_RANK_IN_POD": "0",
                  "EDL_TPU_TRAINERS_NUM": str(world), "EDL_TPU_CLUSTER_STAGE": stage,
                  "EDL_TPU_COORD_ENDPOINTS": ep, "EDL_TPU_SPAWN_TS": repr(time.time()),
                  "OMP_NUM_THREADS": "1"})
        return e

    def cluster(stage, pods):
        ps = []
        for name in pods:
            p = Pod(pod_id=name)
            p.trainers = [Trainer(endpoint=f"127.0.0.1:{find_free_port()}")]
            ps.append(p)
        c = Cluster.from_pods(ps)
        c.stage = stage
        kv.put(f"{base}/cluster/cluster", c.to_json().encode())

    def outputs(n, pods):
        deadline = time.monotonic() + WORKER_TIMEOUT
        while True:
            got = {p: kv.get(f"{base}/test/out/{n}/{p}") for p in pods}
            if all(v is not None for v in got.values()):
                return {p: json.loads(v.value) for p, v in got.items()}
            assert time.monotonic() < deadline, f"phase {n} never reported: {got}"
            for proc, log in procs.values():
                assert proc.poll() in (None, 0), log.read_text()[-3000:]
            time.sleep(0.1)

    procs = {}

    def spawn(pod, rank, world, stage):
        log = tmp_path / f"{pod}.txt"
        procs[pod] = (subprocess.Popen([sys.executable, str(REFORM_WORKER)],
                                       env=env(pod, rank, world, stage), cwd=ROOT,
                                       stdout=open(log, "w"), stderr=subprocess.STDOUT), log)

    try:
        jax_resize.publish_world_service(kv, job, "s1", "10.0.0.1:1", 2)
        cluster("s1", ["p0", "p1"])
        spawn("p0", 0, 2, "s1")
        spawn("p1", 1, 2, "s1")
        first = outputs(0, ["p0", "p1"])
        assert [first[p]["sum"] for p in ("p0", "p1")] == [3.0, 3.0], first
        assert {r["nonce"] for r in first.values()} == {"10.0.0.1:1"}

        # grow: a third process joins stage s2; the two re-form in place
        jax_resize.publish_world_service(kv, job, "s2", "10.0.0.1:2", 3)
        cluster("s2", ["p0", "p1", "p2"])
        spawn("p2", 2, 3, "s2")
        kv.put(f"{base}/test/step/1", json.dumps({"stage": "s2"}).encode())
        grown = outputs(1, ["p0", "p1"])
        grown["p2"] = outputs(0, ["p2"])["p2"]
        assert {p: (r["rank"], r["world"], r["sum"]) for p, r in grown.items()} == {
            "p0": (0, 3, 6.0), "p1": (1, 3, 6.0), "p2": (2, 3, 6.0)}, grown
        assert all(grown[p]["pid"] == first[p]["pid"] for p in ("p0", "p1"))
        assert grown["p1"]["env_world"] == "3"

        # the same stage formed again under the launcher's new record
        t_again = time.time()
        jax_resize.publish_world_service(kv, job, "s2", "10.0.0.1:3", 3)
        kv.put(f"{base}/test/step/2",
               json.dumps({"stage": "s2", "again": True, "ts": t_again - 1.0}).encode())
        again = outputs(2, ["p0", "p1", "p2"])
        assert {r["sum"] for r in again.values()} == {6.0}, again
        assert {r["nonce"] for r in again.values()} == {"10.0.0.1:3"}

        # shrink: only p0 stays; a world of 1 forms no group
        cluster("s3", ["p0"])
        kv.put(f"{base}/test/step/3", json.dumps({"stage": "s3"}).encode())
        shrunk = outputs(3, ["p0", "p1", "p2"])
        assert shrunk["p1"].get("left") and shrunk["p2"].get("left"), shrunk
        p0 = shrunk["p0"]
        assert (p0["pid"], p0["rank"], p0["world"], p0["initialized"]) == (
            first["p0"]["pid"], 0, 1, False), p0
        kv.put(f"{base}/test/step/4", json.dumps({"end": True}).encode())
        for pod, (proc, log) in procs.items():
            assert proc.wait(timeout=WORKER_TIMEOUT) == 0, log.read_text()[-3000:]
    finally:
        for proc, _log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        kv.close()


def test_coord_rendezvous_store_answers_as_torch_hash_store(memkv):
    """The store the resizable world forms through gives torch's in-process
    ``HashStore`` answers for the same calls: set/get, add (a counter),
    compare_set on an absent, an equal and a different value, check,
    delete_key and num_keys; a get of an unset key times out."""
    import datetime

    ours = distributed.CoordRendezvousStore(memkv, "/edl_tpu/j/torchworld/s/n/", 0.3)
    ref = dist.HashStore()
    ref.set_timeout(datetime.timedelta(seconds=0.3))
    for st in (ours, ref):
        st.set("a", b"1")
    assert ours.get("a") == ref.get("a") == b"1"
    assert [ours.add("c", 2), ours.add("c", 3)] == [ref.add("c", 2), ref.add("c", 3)] == [2, 5]
    assert ours.get("c") == ref.get("c") == b"5"
    for expected, desired in ((b"", b"x"), (b"x", b"y"), (b"nope", b"z")):
        assert ours.compare_set("k", expected, desired) == ref.compare_set("k", expected, desired)
    assert ours.compare_set("absent", b"e", b"d") == ref.compare_set("absent", b"e", b"d")
    assert ours.check(["a", "k"]) and not ours.check(["a", "none"])
    assert ours.num_keys() == 3
    assert ours.delete_key("a") and not ours.check(["a"])
    with pytest.raises(RuntimeError):
        ours.get("none")
    ours.wait(["c", "k"])
