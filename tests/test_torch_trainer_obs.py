"""The port trainer's observability (``edl_tpu_torch/train/trainer.py`` on
``obs/``) against the JAX trainer's: one epoch of the same small LM on the
CPU moves ``edl_train_steps_total``, ``edl_train_examples_total``,
``edl_train_epochs_total`` and ``edl_train_step_seconds_count`` by the same
amounts in each package's registry; live ``edl_mfu`` is the analytic FLOPs
of a step over the step EMA over the peak; with no obs env a trainer starts
no server and writes no file; ``train_resnet --profile_steps`` writes a
trace; the JAX aggregator scrapes a port trainer's advertised ``/metrics``;
and the port's advert payload is the JAX one."""

import json
import os
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
# PyTorch makes its compile cache's directory (torchinductor_<user>, under the
# temp directory) when torch._dynamo is first imported, which the optimizers
# do: imported here, before a test points TMPDIR at a directory it watches
import torch._dynamo  # noqa: F401

from edl_tpu.cluster.state import State as JaxState
from edl_tpu.models import transformer as jtf
from edl_tpu.obs import advert as jax_advert
from edl_tpu.obs import metrics as jax_metrics
from edl_tpu.obs.agg import Aggregator
from edl_tpu.parallel import MeshSpec as JaxMeshSpec
from edl_tpu.train.trainer import ElasticTrainer as JaxTrainer
from edl_tpu.train.trainer import TrainConfig as JaxTrainConfig
from edl_tpu_torch import train_lm, train_resnet
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.cluster.state import State
from edl_tpu_torch.coord.memory import MemoryKV
from edl_tpu_torch.obs import advert as torch_advert
from edl_tpu_torch.obs import exposition
from edl_tpu_torch.obs import metrics as torch_metrics
from edl_tpu_torch.obs import profile as torch_profile
from edl_tpu_torch.obs import trace as torch_trace
from edl_tpu_torch.obs.flops import analytic_lm_flops_per_token

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("edl_train_steps_total", "edl_train_examples_total", "edl_train_epochs_total",
            "edl_train_step_seconds_count")
ARGV = ["--device", "cpu", "--vocab", "64", "--layers", "2", "--embed", "32", "--heads", "4",
        "--mlp", "64", "--seq_len", "16", "--batch_size", "4", "--steps_per_epoch", "5"]
OBS_ENV = ("EDL_TPU_METRICS_PORT", "EDL_TPU_METRICS_DIR", "EDL_TPU_TRACE_DIR",
           "EDL_TPU_TRACE_CONTEXT", "EDL_TPU_PROFILE_DIR", "EDL_TPU_STEP_LEDGER",
           "EDL_TPU_PEAK_TFLOPS")


@pytest.fixture
def no_obs_env(monkeypatch):
    for var in OBS_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(exposition, "_server", None)


def _counts(registry) -> dict:
    parsed = (jax_metrics if registry is jax_metrics.REGISTRY
              else torch_metrics).parse_exposition(registry.render())
    return {n: parsed.get((n, ()), 0.0) for n in COUNTERS}


def _batches(args, n):
    rng = np.random.default_rng(5)
    return [{"ids": rng.integers(0, args.vocab, (args.batch_size, args.seq_len + 1)).astype(
        np.int32)} for _ in range(n)]


def _jax_epoch(args, batches):
    cfg = jtf.TransformerConfig(vocab_size=args.vocab, num_layers=args.layers,
                                embed_dim=args.embed, num_heads=args.heads, mlp_dim=args.mlp,
                                max_len=args.seq_len, dtype=jnp.float32, remat=False,
                                attention_impl="dense")
    model = jtf.TransformerLM(cfg)

    def loss_fn(params, extra, batch, rng):
        ids = batch["ids"]
        logits = model.apply({"params": params}, ids[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, ids[:, 1:]).mean(), (extra, {})

    trainer = JaxTrainer(loss_fn, JaxTrainConfig(mesh_spec=JaxMeshSpec(dp=1)),
                         devices=jax.devices()[:1])
    init = lambda: (model.init(jax.random.key(0), jnp.asarray(batches[0]["ids"][:, :-1]))  # noqa: E731
                    ["params"], None)
    state = trainer.create_state(init, optax.adamw(1e-3))
    trainer.fit(state, JaxState(), lambda e: iter(batches), epochs=1)


def _torch_epoch(args, batches):
    _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"))
    state = trainer.create_state(init_fn, tx)
    trainer.fit(state, State(), lambda e: iter(batches), epochs=1)
    return trainer


def test_one_epoch_moves_the_counters_as_the_jax_trainer(no_obs_env):
    args = train_lm.parse_args(ARGV)
    batches = _batches(args, args.steps_per_epoch)
    jax_before, torch_before = _counts(jax_metrics.REGISTRY), _counts(torch_metrics.REGISTRY)
    _jax_epoch(args, batches)
    _torch_epoch(args, batches)
    jax_d = {n: v - jax_before[n] for n, v in _counts(jax_metrics.REGISTRY).items()}
    torch_d = {n: v - torch_before[n] for n, v in _counts(torch_metrics.REGISTRY).items()}
    assert torch_d == jax_d == {"edl_train_steps_total": 5, "edl_train_examples_total": 20,
                                "edl_train_epochs_total": 1, "edl_train_step_seconds_count": 4}


def test_live_mfu_is_the_analytic_step_flops_over_the_ema_over_the_peak(no_obs_env,
                                                                         monkeypatch):
    monkeypatch.setenv("EDL_TPU_PEAK_TFLOPS", "0.5")
    args = train_lm.parse_args(ARGV)
    trainer = _torch_epoch(args, _batches(args, args.steps_per_epoch))
    cfg = train_lm.build_config(args, torch.device("cpu"))
    per_token = analytic_lm_flops_per_token(cfg.num_layers, cfg.embed_dim, cfg.mlp_dim,
                                            cfg.vocab_size, args.seq_len)
    flops_step = per_token * args.seq_len * args.batch_size
    assert trainer.cfg.flops_per_example == per_token * args.seq_len
    want_tflops = flops_step / trainer._step_ema / 1e12
    assert torch_metrics.REGISTRY.get("edl_tflops_per_chip").value == pytest.approx(
        want_tflops, rel=1e-9)
    assert torch_metrics.REGISTRY.get("edl_mfu").value == pytest.approx(want_tflops / 0.5,
                                                                        rel=1e-9)
    # an MoE model has no analytic count: the trainer leaves the gauges alone
    assert train_lm.flops_per_example(train_lm.parse_args(ARGV + ["--moe", "4"]), cfg) == 0.0


def test_no_obs_env_starts_no_server_and_writes_no_file(no_obs_env, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setattr("tempfile.tempdir", None)
    (tmp_path / "tmp").mkdir()
    monkeypatch.chdir(tmp_path)
    args = train_lm.parse_args(ARGV)
    trainer = _torch_epoch(args, _batches(args, 3))
    assert exposition.installed_server() is None
    assert isinstance(torch_trace.get_tracer(), torch_trace.NullTracer)
    assert trainer._window is None
    assert sorted(p.name for p in tmp_path.rglob("*")) == ["tmp"]
    # the entry point as a process: stdout only, nothing written around it
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(PYTHONPATH=ROOT, HOME=str(tmp_path / "tmp"), TMPDIR=str(tmp_path / "tmp"))
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.train_lm", *ARGV, "--epochs", "1",
                          "--steps_per_epoch", "2"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"world": 1' in out.stdout
    assert sorted(p.name for p in tmp_path.rglob("*")) == ["tmp"]


def test_train_resnet_profile_steps_writes_a_trace(no_obs_env, tmp_path, monkeypatch):
    for var in [k for k in os.environ if k.startswith("EDL_TPU_")]:
        monkeypatch.delenv(var)
    out = tmp_path / "profile"
    train_resnet.main(["--device", "cpu", "--synthetic", "4", "--synthetic_per_file", "24",
                       "--synthetic_files", "1", "--data_dir", str(tmp_path / "data"),
                       "--model", "resnet18", "--width", "8", "--image_size", "32",
                       "--batch_size", "8", "--epochs", "1", "--no-eval", "--num_workers", "2",
                       "--profile_steps", "1:2", "--profile_dir", str(out)])
    (trace,) = out.glob("*.pt.trace.json")
    assert "steps-1-2" in trace.name
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "aten::convolution" in names and "Optimizer.step#SGD.step" in names


def test_the_jax_aggregator_scrapes_a_port_trainers_metrics(no_obs_env, monkeypatch):
    monkeypatch.setenv("EDL_TPU_METRICS_PORT", "0")
    monkeypatch.setenv("EDL_TPU_HOST_IP", "127.0.0.1")
    store = MemoryKV()
    tenv = TrainerEnv({"EDL_TPU_JOB_ID": "obs-job", "EDL_TPU_POD_ID": "pod-a"})
    args = train_lm.parse_args(ARGV)
    try:
        _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"), store=store,
                                                         tenv=tenv)
        state = trainer.create_state(init_fn, tx)
        trainer.fit(state, State(), lambda e: iter(_batches(args, 3)), epochs=1)
        (target,) = torch_advert.list_metrics_targets(store, "obs-job").values()
        assert target["component"] == "trainer" and target["pod"] == "pod-a"
        assert target["endpoint"] == exposition.installed_server().endpoint
        merged, info = Aggregator(store, "obs-job", cache_s=0.0, include_self=False).collect()
        assert len(info["targets"]) == 1 and not info["errors"]
        parsed = jax_metrics.parse_exposition(merged)
        steps = [v for (name, labels), v in parsed.items()
                 if name == "edl_train_steps_total" and dict(labels).get("component") == "trainer"]
        assert steps and steps[0] >= 3
        trainer._obs_register.stop()
    finally:
        exposition.shutdown_installed()
        store.close()


def test_the_port_advert_payload_is_the_jax_one(monkeypatch):
    from edl_tpu.coord.memory import MemoryKV as JaxMemoryKV

    class Clock:
        @staticmethod
        def time():
            return 1_700_000_000.5

    monkeypatch.setattr(jax_advert, "time", Clock)
    monkeypatch.setattr(torch_advert, "time", Clock)
    stores = (JaxMemoryKV(), MemoryKV())
    try:
        records = []
        for mod, store in zip((jax_advert, torch_advert), stores):
            reg = mod.advertise_metrics(store, "job", "trainer", "10.0.0.1:9100",
                                        name="trainer-7", ttl=30, extra={"pod": "p0"})
            recs, _ = store.get_prefix("/")
            records.append({r.key: json.loads(r.value.decode()) for r in recs})
            reg.stop()
            ctx = type("Ctx", (), {"trace_id": "abc"})()
            mod.publish_job_trace(store, "job", ctx, stage="s1")
        assert records[0] == records[1] and len(records[0]) == 1
        # each package's reader takes the other's trace record
        assert torch_advert.current_job_trace(stores[0], "job") == \
            jax_advert.current_job_trace(stores[1], "job") == {"trace_id": "abc",
                                                               "ts": 1_700_000_000.5,
                                                               "stage": "s1"}
    finally:
        for store in stores:
            store.close()


def test_a_scrape_over_http_reads_the_ledger_phases(no_obs_env, monkeypatch):
    monkeypatch.setenv("EDL_TPU_METRICS_PORT", "0")
    try:
        args = train_lm.parse_args(ARGV)
        _torch_epoch(args, _batches(args, 4))
        port = exposition.installed_server().port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            parsed = jax_metrics.parse_exposition(resp.read().decode())
        phases = {dict(labels)["phase"] for (name, labels) in parsed
                  if name == "edl_step_phase_seconds_count"}
        assert phases == {"data_wait", "h2d", "compute", "hooks", "checkpoint"}
        assert 0 < parsed[("edl_step_ledger_coverage_ratio", ())] <= 1.0
    finally:
        exposition.shutdown_installed()


def test_a_profile_capture_during_fit_traces_whole_steps(no_obs_env, tmp_path, monkeypatch):
    """``/profile``'s ``torch_profiler`` capture through the trainer's loop
    (forced on the CPU, the CPU activity only): armed mid-epoch, started and
    ended at step boundaries; each captured step's range in the trace holds
    its optimizer step, and the ledger's per-step events for exactly those
    steps come right before the ``profile/capture`` event."""
    monkeypatch.setenv("EDL_TPU_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("EDL_TPU_PROFILE_DIR", str(tmp_path / "profile"))
    args = train_lm.parse_args(ARGV)
    try:
        _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"))
        trainer._profiler.torch_profiler = True
        state = trainer.create_state(init_fn, tx)
        replies = []

        def data_fn(epoch):
            for i, batch in enumerate(_batches(args, 8)):
                if i == 2:
                    replies.append(trainer._profiler.trigger(duration_s=0.05))
                    replies.append(trainer._profiler.trigger(duration_s=0.05))
                yield batch

        trainer.fit(state, State(), data_fn, epochs=1)
    finally:
        torch_trace.install(torch_trace.NullTracer()).close()
    assert replies[0]["started"] and replies[1]["busy"]
    manifest = json.loads(open(replies[0]["manifest"]).read())
    assert manifest["kind"] == "torch_profiler" and manifest["steps"] >= 1
    # the captured steps are ProfilerStep#1..#steps, one optimizer step each
    by_step = torch_profile.events_by_step(manifest["artifact"], cats=("user_annotation",))
    assert [sum(n for name, n in by_step.get(i, {}).items()
                if name.startswith("Optimizer.step#AdamW.step"))
            for i in range(1, manifest["steps"] + 1)] == [1] * manifest["steps"]
    (path,) = (tmp_path / "trace").glob("trace-trainer-*.jsonl")
    events = [json.loads(line) for line in path.read_text().splitlines()]
    (end,) = [i for i, e in enumerate(events) if e["name"] == "profile/capture"]
    window = events[end - manifest["steps"]:end]
    assert all(e["name"] == "train/step_phases" and e["steps"] == 1 for e in window)
    assert sum(e["name"] == "train/step_phases" and e["steps"] == 1
               for e in events) == manifest["steps"]
