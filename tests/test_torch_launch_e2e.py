"""Elastic training end to end with the PyTorch port's trainer under the
unchanged JAX-package launcher: real launchers, a real coordination
server, ``edl_tpu_torch/train_lm.py`` trainers on the CPU.

- The launcher's defaults (the live reshard, the peer checkpoint cache and
  the delta plane on): pod B joins pod A's run and A's trainer re-forms the
  world in place; then B is killed and A's failed collective becomes a
  shrink reshard, again in the same process (the twin of
  ``scripts/resize_smoke.py``'s grow and shrink).
- A live mid-run join with stop-resume: pod A trains solo; pod B joins
  once A has committed two epoch checkpoints; A's trainer is restarted
  into a 2-rank gloo world with B's (train_lm's auto tp: tp = 2), both
  resume from the checkpoint at the next epoch, the epoch history records
  the mesh's batch divisor (1 throughout: the tp ranks train the same
  rows), and the resize's
  recovery record (the launcher's half and the trainers') is complete (the
  model of ``tests/test_elastic_training_e2e.py::
  test_elastic_join_resumes_training``).
- A SIGTERM preemption: both trainers of a 2-pod world checkpoint at an
  agreed step and exit ``PREEMPT_EXIT_CODE``, the signalled pod departs,
  and the survivor stop-resumes solo from the preemption-point checkpoint
  (the twin of ``tests/test_elastic_training_e2e.py::
  test_sigterm_preemption_checkpoint``).
- ``edl_tpu_torch/train_resnet.py --data_service`` against the JAX
  launcher's ``DataService``: two pods train both epochs in one 2-rank
  world (the twin of ``tests/test_resnet_example.py::
  test_two_pod_resnet_data_service``), and after a hard kill of one pod
  mid-epoch the survivor resumes solo in the same epoch from the
  checkpointed record spans (the twin of
  ``test_resnet_data_service_survives_mid_epoch_kill``).
"""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from edl_tpu.cluster.recovery import summarize_recovery
from edl_tpu.cluster.status import Status, load_job_status
from edl_tpu.cluster.train_status import TrainStatus, load_train_statuses
from edl_tpu.coord.client import CoordClient
from edl_tpu_torch.cluster.state import State
from tests.test_launch_integration import FAST, finish

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "edl_tpu_torch", "train_lm.py")
TRAIN_RESNET = os.path.join(REPO, "edl_tpu_torch", "train_resnet.py")
TRAIN_ARGS = ["--device", "cpu", "--vocab", "64", "--layers", "2", "--embed", "64",
              "--heads", "2", "--mlp", "128", "--seq_len", "32", "--batch_size", "4",
              "--steps_per_epoch", "4", "--epochs", "10", "--lr", "1e-2"]


def spawn(job_id, coord_ep, tmp, name, ckpt_dir, args=TRAIN_ARGS, extra_env=None,
          trainer=TRAIN, nodes_range="1:2", live=False):
    """A launcher with one trainer; ``live``: the launcher's defaults,
    else stop-resume (``EDL_TPU_RESIZE_DELTA=0``)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(FAST)
    env.update({
        "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
        "JAX_PLATFORMS": "cpu",
        "EDL_TPU_HOST_IP": "127.0.0.1",
        **({} if live else {"EDL_TPU_RESIZE_DELTA": "0"}),
        "EDL_TPU_DEMO_STEP_SLEEP": "0.25",
        "EDL_TPU_DEMO_MARKER": os.path.join(tmp, f"marker-{name}"),
        "OMP_NUM_THREADS": "2",
        **(extra_env or {}),
    })
    log = open(os.path.join(tmp, f"launcher-{name}.log"), "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu.collective.launch",
         "--job_id", job_id, "--coord_endpoints", coord_ep,
         "--nodes_range", nodes_range, "--nproc_per_node", "1",
         "--checkpoint_dir", ckpt_dir,
         "--log_dir", os.path.join(tmp, f"log-{name}"), trainer, "--", *args],
        env=env, cwd=tmp, stdout=log, stderr=subprocess.STDOUT)
    proc._logfile = log  # noqa: SLF001
    return proc


def _committed(ckpt):
    return sorted(int(d) for d in (os.listdir(ckpt) if os.path.isdir(ckpt) else [])
                  if d.isdigit())


def _spawns(log: str) -> list[int]:
    return [int(p) for p in re.findall(r"spawned trainer global_rank=\d+ pid=(\d+)", log)]


@pytest.mark.slow
def test_torch_trainers_reshard_live_under_the_launcher_defaults(coord_server, tmp_path):
    """The unchanged launcher with its defaults: pod B joins (1 -> 2), B is
    SIGKILLed (2 -> 1).  Pod A's trainer process survives both (one spawn),
    A writes the done record of each new stage, both resizes are live with a
    cache source, every epoch completes once, and the run learns."""
    from edl_tpu.cluster import resize as jax_resize
    from edl_tpu.memstate.advert import read_committed_step
    from tests.helpers.harness import kill_tree

    ep = f"127.0.0.1:{coord_server.port}"
    ckpt = str(tmp_path / "ckpt")
    args = [*TRAIN_ARGS, "--epochs", "24"]
    env = {"EDL_TPU_PREEMPT_CHECK_SECONDS": "1", "EDL_TPU_PREEMPT_CHECK_STEPS": "2"}
    la = tmp_path / "launcher-a.log"
    pa = spawn("torch-live", ep, str(tmp_path), "a", ckpt, args, env, live=True)
    pb = None
    try:
        deadline = time.time() + 180
        while len(_committed(ckpt)) < 2:
            assert time.time() < deadline, "pod A never committed 2 epoch checkpoints"
            assert pa.poll() is None, "pod A died during solo warmup"
            time.sleep(0.25)
        pb = spawn("torch-live", ep, str(tmp_path), "b", ckpt, args, env, live=True)
        deadline = time.time() + 120
        while "live reshard complete" not in _logs(str(tmp_path)):
            assert time.time() < deadline, "no live grow: " + _logs(str(tmp_path))[-6000:]
            assert pa.poll() is None and pb.poll() is None, _logs(str(tmp_path))[-6000:]
            time.sleep(0.25)
        grown = max(_committed(ckpt))
        watch = CoordClient(ep)
        try:
            # an epoch of the 2-rank world, saved and sealed in the cache: the
            # kill then lands inside an epoch, not between a save and its seal
            while not (max(_committed(ckpt)) > grown and read_committed_step(
                    watch, "torch-live") == max(_committed(ckpt))):
                assert time.time() < deadline, "the grown world sealed no epoch"
                time.sleep(0.05)
        finally:
            watch.close()
        kill_tree(pb)
        assert finish(pa, 300) == 0, _logs(str(tmp_path))[-8000:]
    finally:
        for p in (pa, pb):
            if p is not None and p.poll() is None:
                kill_tree(p)
                p.wait()

    logs = _logs(str(tmp_path))
    log_a = la.read_text(errors="replace")
    assert len(_spawns(log_a)) == 1, log_a[-3000:]     # A's trainer survived both
    client = CoordClient(ep)
    try:
        assert load_job_status(client, "torch-live") == Status.SUCCEED
        stages = [s for s in summarize_recovery(client, "torch-live") if "total" in s]
        pod_a = json.loads(client.get(f"/edl_tpu/torch-live/cluster/cluster").value)["pods"][0][
            "pod_id"]
        done = {s["stage"]: jax_resize.load_done(client, "torch-live", s["stage"])
                for s in stages}
    finally:
        client.close()
    print(f"recovery: {stages}")
    assert [s["resize_mode"] for s in stages] == ["delta", "delta"], stages
    assert all(s["restore_source"] in ("peer", "delta") for s in stages), stages
    assert all(set(d) == {pod_a} and d[pod_a]["source"] == "delta" for d in done.values()), done
    worker_a = next((tmp_path / "log-a").rglob("workerlog.0")).read_text(errors="replace")
    assert worker_a.count("live reshard complete") == 2, worker_a[-6000:]
    meta = _last_meta(ckpt)
    epochs = sorted(meta.epochs, key=lambda e: e.epoch_no)
    assert [e.epoch_no for e in epochs] == list(range(24)), epochs
    # the batch divisor: 1 solo, 1 in the 2-rank world at auto tp 2, 1 again
    worlds = [e.world_size for e in epochs]
    assert worlds == [1] * 24, worlds
    assert "'tp': 2" in worker_a, worker_a[-6000:]
    done_a = [line for line in (tmp_path / "marker-a").read_text().splitlines()
              if line.startswith("done")]
    rec = json.loads(done_a[-1].split(" ", 1)[1])
    assert rec["world"] == 1 and rec["val_nll"] < rec["unigram_nll"], rec


@pytest.mark.slow
def test_torch_trainers_join_and_resume_under_the_launcher(coord_server, tmp_path):
    ep = f"127.0.0.1:{coord_server.port}"
    ckpt = str(tmp_path / "ckpt")
    pa = spawn("torch-e2e", ep, str(tmp_path), "a", ckpt)
    pb = None
    try:
        deadline = time.time() + 180
        while len(_committed(ckpt)) < 2:
            assert time.time() < deadline, "pod A never committed 2 epoch checkpoints"
            assert pa.poll() is None, "pod A died during solo warmup"
            time.sleep(0.25)
        pb = spawn("torch-e2e", ep, str(tmp_path), "b", ckpt)
        assert finish(pa, 300) == 0
        assert finish(pb, 300) == 0
    finally:
        for p in (pa, pb):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()

    client = CoordClient(ep)
    try:
        assert load_job_status(client, "torch-e2e") == Status.SUCCEED
        statuses = load_train_statuses(client, "torch-e2e")
        assert statuses and set(statuses.values()) == {TrainStatus.SUCCEED}, statuses
        # the join's resize record: the JAX launcher's half and the torch
        # trainers' half, merged by the JAX package's summary
        stages = [s for s in summarize_recovery(client, "torch-e2e") if "total" in s]
    finally:
        client.close()
    print(f"recovery: {stages}")
    assert stages, "no complete resize record"
    assert all(0 < s["restored_to_first_step"] <= s["total"] for s in stages), stages
    # the trainers restore from the launchers' peer checkpoint cache (on by
    # default; the committed set, or rolled forward along a delta chain);
    # storage only when the kill landed between a save and its seal in the
    # cache, a stale cached step the restore refuses and logs
    sources = {s["restore_source"] for s in stages}
    assert sources and sources <= {"peer", "delta", "storage"}, stages
    if "storage" in sources:
        assert "cache miss (stale" in _logs(str(tmp_path)), stages

    # the last checkpoint's sidecar: every epoch once, each recording the
    # mesh's batch divisor: 1 solo, and 1 in the 2-rank world at tp 2
    last = _committed(ckpt)[-1]
    with open(os.path.join(ckpt, str(last), "meta", "metadata")) as f:
        meta = State().from_json(f.read())
    worlds = [e.world_size for e in sorted(meta.epochs, key=lambda e: e.epoch_no)]
    assert [e.epoch_no for e in sorted(meta.epochs, key=lambda e: e.epoch_no)] == list(range(10))
    assert worlds == [1] * 10, worlds

    # the finishing run was a 2-rank world at auto tp 2 and learned
    done = [line for line in (tmp_path / "marker-a").read_text().splitlines()
            if line.startswith("done")]
    rec = json.loads(done[-1].split(" ", 1)[1])
    assert rec["world"] == 2 and rec["mesh"]["tp"] == 2, rec
    assert rec["val_nll"] < rec["unigram_nll"], rec
    # A's log shows the resize restart resuming from a nonzero epoch
    log_a = (tmp_path / "launcher-a.log").read_bytes().decode(errors="replace")
    resumes = [int(r) for r in re.findall(r"resume_epoch=(\d+)", log_a)]
    assert len(resumes) >= 2 and resumes[0] == 0 and resumes[-1] > 0, log_a[-3000:]
    assert "rank=0/2" in log_a, log_a[-3000:]


def _last_meta(ckpt):
    with open(os.path.join(ckpt, str(_committed(ckpt)[-1]), "meta", "metadata")) as f:
        return State().from_json(f.read())


@pytest.mark.slow
def test_sigterm_preemption_checkpoint_with_torch_trainers(coord_server, tmp_path):
    """SIGTERM one pod of a 2-pod world mid-run: its launcher flags the
    preemption, both torch trainers checkpoint at an agreed step and exit
    PREEMPT_EXIT_CODE, the signalled pod departs (exit 0), and the survivor
    stop-resumes solo from the preemption-point checkpoint: every epoch
    completes once."""
    import signal

    ep = f"127.0.0.1:{coord_server.port}"
    ckpt = str(tmp_path / "ckpt")
    args = [*TRAIN_ARGS, "--epochs", "8"]          # 8 epochs of 4 steps (the last flag wins)
    env = {"EDL_TPU_PREEMPT_CHECK_STEPS": "2"}
    pa = spawn("preempt-e2e", ep, str(tmp_path), "a", ckpt, args, env)
    pb = spawn("preempt-e2e", ep, str(tmp_path), "b", ckpt, args, env)
    try:
        deadline = time.time() + 240
        while not _committed(ckpt):
            assert time.time() < deadline, "no checkpoint committed before the preemption"
            assert pa.poll() is None and pb.poll() is None, "a pod died in warm-up"
            time.sleep(0.25)
        pb.send_signal(signal.SIGTERM)
        assert finish(pb, 240) == 0, "the preempted pod must exit cleanly (DESCALED)"
        assert finish(pa, 300) == 0
    finally:
        for p in (pa, pb):
            if p.poll() is None:
                p.kill()
                p.wait()

    client = CoordClient(ep)
    try:
        assert load_job_status(client, "preempt-e2e") == Status.SUCCEED
    finally:
        client.close()
    lb = (tmp_path / "launcher-b.log").read_bytes().decode(errors="replace")
    assert "flagging preemption" in lb, lb[-2000:]
    assert "preemption checkpoint complete; departing" in lb, lb[-2000:]
    m = re.search(r"preemption flagged: checkpointing at step (\d+)", lb)
    assert m, lb[-3000:]
    preempt_step = int(m.group(1))
    la = (tmp_path / "launcher-a.log").read_bytes().decode(errors="replace")
    assert "peer preempted; waiting for the shrunk cluster" in la, la[-2000:]
    assert f"preemption flagged: checkpointing at step {preempt_step}" in la, la[-3000:]
    # the survivor's restart resumed from the preemption-point checkpoint:
    # the epoch the preempt step sat in (at an epoch's last step, that epoch)
    resumes = [int(x) for x in re.findall(r"resume_epoch=(\d+)", la)]
    assert len(resumes) >= 2, la[-2000:]
    assert resumes[-1] in (preempt_step // 4, (preempt_step - 1) // 4), (resumes, preempt_step)
    print(f"preempted at step {preempt_step}; survivor resumed at epoch {resumes[-1]}")
    meta = _last_meta(ckpt)
    epochs = sorted(meta.epochs, key=lambda e: e.epoch_no)
    assert [e.epoch_no for e in epochs] == list(range(8))
    assert epochs[-1].world_size == 1
    done = [line for line in (tmp_path / "marker-a").read_text().splitlines()
            if line.startswith("done")]
    assert done and json.loads(done[-1].split(" ", 1)[1])["world"] == 1


def _resnet_args(data, bench, *extra):
    return ["--device", "cpu", "--data_service", "--synthetic", "4", "--synthetic_per_file", "48",
            "--synthetic_files", "2", "--data_dir", data, "--model", "resnet18", "--width", "16",
            "--image_size", "32", "--epochs", "2", "--batch_size", "8", "--steps_per_epoch", "0",
            "--base_lr", "0.05", "--warmup_epochs", "0", "--num_workers", "2",
            "--bench_dump", bench, *extra]


def _logs(tmp):
    out = []
    for root, _, names in os.walk(tmp):
        for n in names:
            if n.endswith(".log") or n.startswith("workerlog"):
                p = os.path.join(root, n)
                out.append(f"==== {p} ====\n" + open(p, errors="replace").read())
    return "\n".join(out)


@pytest.mark.slow
def test_two_pod_torch_resnet_data_service(coord_server, tmp_path):
    """Two pods feed torch ResNet trainers from the JAX launcher's
    DataService: dynamic file handout and the masked ragged tail in one
    2-rank gloo world; both epochs, job SUCCEED."""
    ep = f"127.0.0.1:{coord_server.port}"
    tmp = str(tmp_path)
    args = _resnet_args(os.path.join(tmp, "data"), os.path.join(tmp, "bench.json"))
    procs = [spawn("rn-ds-torch", ep, tmp, name, os.path.join(tmp, "ckpt"), args,
                   trainer=TRAIN_RESNET, nodes_range="2:2") for name in ("a", "b")]
    try:
        for p in procs:
            assert finish(p, 420) == 0, _logs(tmp)[-6000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    client = CoordClient(ep)
    try:
        assert load_job_status(client, "rn-ds-torch") == Status.SUCCEED
    finally:
        client.close()
    for name in ("a", "b"):
        marker = (tmp_path / f"marker-{name}").read_text()
        assert "world=2" in marker and "epochs=[0, 1]" in marker, marker
    dump = json.load(open(tmp_path / "bench.json"))
    assert dump["world"] == 2 and len(dump["epochs"]) == 2
    assert all("val_top1" in e and "decode_img_s" in e for e in dump["epochs"]), dump


@pytest.mark.slow
def test_torch_resnet_data_service_survives_mid_epoch_kill(coord_server, tmp_path):
    """A hard kill of one pod inside epoch 1: the survivor stop-resumes solo,
    re-enters the same epoch from the checkpointed record spans, and
    finishes the job."""
    from tests.helpers.harness import kill_tree

    ep = f"127.0.0.1:{coord_server.port}"
    tmp = str(tmp_path)
    ckpt = os.path.join(tmp, "ckpt")
    # 16 paced steps an epoch, no eval, a mid-epoch save every 4 steps
    args = _resnet_args(os.path.join(tmp, "data"), os.path.join(tmp, "bench.json"),
                        "--epochs", "3", "--synthetic_per_file", "128", "--no-eval",
                        "--save_every_steps", "4")
    pa = spawn("rn-kill-torch", ep, tmp, "a", ckpt, args, trainer=TRAIN_RESNET)
    pb = spawn("rn-kill-torch", ep, tmp, "b", ckpt, args, trainer=TRAIN_RESNET)
    la = tmp_path / "launcher-a.log"
    try:
        deadline = time.monotonic() + 300
        while not (la.exists() and '"epoch": 0,' in la.read_text(errors="replace")):
            assert time.monotonic() < deadline, "epoch 0 never completed: " + _logs(tmp)[-3000:]
            time.sleep(0.25)
        # kill once a mid-epoch save past epoch 0's 16 steps has committed
        deadline = time.monotonic() + 120
        while not any(s > 16 for s in _committed(ckpt)):
            assert time.monotonic() < deadline, "no mid-epoch-1 save: " + _logs(tmp)[-3000:]
            time.sleep(0.25)
        kill_tree(pb)
        assert finish(pa, 420) == 0, _logs(tmp)[-6000:]
    finally:
        for p in (pa, pb):
            if p.poll() is None:
                p.kill()
                p.wait()
    client = CoordClient(ep)
    try:
        assert load_job_status(client, "rn-kill-torch") == Status.SUCCEED
    finally:
        client.close()
    marker = (tmp_path / "marker-a").read_text()
    assert "epochs=[0, 1, 2]" in marker and "world=1" in marker, marker
    text = la.read_text(errors="replace")
    resumes = re.findall(r"resume_epoch=(\d+) in_epoch=(-?\d+) resumed_spans=(\d+)", text)
    assert len(resumes) >= 2, text[-2000:]
    # the restart after the kill resumed from a committed checkpoint with its
    # record spans, never a cold start
    assert any((int(e) >= 1 or int(ie) >= 0) and int(sp) > 0 for e, ie, sp in resumes[1:]), resumes
