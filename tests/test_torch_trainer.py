"""The port's trainer, checkpoint and cluster-model copies against the JAX
package's: the AdamW loss trajectory of the LM step, stop-resume, and the
``State`` sidecar JSON read by either package."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.cluster.env import TrainerEnv as JaxTrainerEnv
from edl_tpu.cluster.state import State as JaxState
from edl_tpu.models import transformer as jtf
from edl_tpu.obs import flops as jflops
from edl_tpu.train.state import TrainState as JaxTrainState
from edl_tpu_torch import train_lm
from edl_tpu_torch.cluster.env import TrainerEnv
from edl_tpu_torch.cluster.state import State
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.obs import flops
from edl_tpu_torch.train.checkpoint import CheckpointManager
from edl_tpu_torch.train.state import adamw
from edl_tpu_torch.train.trainer import ElasticTrainer, TrainConfig
from edl_tpu_torch.utils.device import NoCardError, resolve_device

SMALL = dict(vocab_size=257, num_layers=2, embed_dim=128, num_heads=2, mlp_dim=256,
             max_len=32)
ARGV = ["--device", "cpu", "--vocab", "257", "--layers", "2", "--embed", "128",
        "--heads", "2", "--mlp", "256", "--seq_len", "32", "--batch_size", "2",
        "--fused_ce", "--ce_block", "64", "--steps_per_epoch", "3"]


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], (2, 33)).astype(np.int32) for _ in range(n)]


def test_adamw_trajectory_matches_jax_step():
    """5 steps of the trainer's step (fused CE, AdamW with optax's
    defaults) from one init follow the JAX trainer's step body."""
    lr, batches = 3e-3, _batches(5)
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, attention_impl="dense", **SMALL)
    jm = jtf.TransformerLM(jc)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(batches[0][:, :-1]))["params"]

    @jax.jit
    def jstep(state, ids):
        def lf(p):
            h = jm.apply({"params": p}, ids[:, :-1], return_hidden=True)
            return jtf.lm_loss_fused(p, h, ids[:, 1:], jc, block_size=64)
        loss, grads = jax.value_and_grad(lf)(state.params)
        return state.apply_gradients(grads), loss

    jstate = JaxTrainState.create(params, optax.adamw(lr))
    jlosses = []
    for ids in batches:
        jstate, loss = jstep(jstate, jnp.asarray(ids))
        jlosses.append(float(loss))

    args = train_lm.parse_args(ARGV + ["--lr", str(lr)])
    trainer = ElasticTrainer(train_lm.make_loss_fn(args), device="cpu")
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **SMALL)

    def init():
        model = ttf.TransformerLM(tc)
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
        return model, None

    state = trainer.create_state(init, adamw(lr))
    tlosses = []
    gen = torch.Generator().manual_seed(0)
    for ids in batches:
        state, metrics = trainer.step_fn(state, trainer.to_device({"ids": ids}), gen)
        tlosses.append(float(metrics["loss"]))
    assert state.step == 5
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4, atol=0)
    assert tlosses[-1] < tlosses[0]


def _run(ckpt_dir, epochs, save_every=0, extra=()):
    args = train_lm.parse_args(ARGV + list(extra))
    _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"), ckpt_dir)
    trainer.cfg.save_every_steps = save_every
    losses = []
    inner = trainer.loss_fn

    def recording(*a):
        loss, aux = inner(*a)
        losses.append(float(loss.detach()))
        return loss, aux

    trainer.loss_fn = recording
    state, meta = trainer.restore_or_create(init_fn, tx)
    start = (state.step, meta.next_epoch)

    def data_fn(epoch):
        gen = train_lm.markov_corpus(args, 1000 * (epoch + 1))
        for _ in range(args.steps_per_epoch):
            yield next(gen)

    state, meta = trainer.fit(state, meta, data_fn, epochs=epochs)
    return start, state, meta, losses


def test_stop_resume_reproduces_uninterrupted_run(tmp_path):
    _, straight, smeta, slosses = _run("", epochs=2)
    start_a, _, meta_a, losses_a = _run(str(tmp_path), epochs=1)
    start_b, resumed, meta_b, losses_b = _run(str(tmp_path), epochs=2)
    assert start_a == (0, 0) and start_b == (3, 1)
    assert meta_a.next_epoch == 1 and meta_b.next_epoch == 2 and resumed.step == 6
    assert [e.epoch_no for e in meta_b.epochs] == [0, 1]
    np.testing.assert_allclose(losses_a + losses_b, slosses, rtol=1e-6, atol=0)
    for a, b in zip(resumed.model.parameters(), straight.model.parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    assert CheckpointManager(str(tmp_path)).all_steps() == [3, 6]


def test_flash_attention_trains_and_resumes(tmp_path):
    """``python -m edl_tpu_torch.train_lm --attention flash --device cpu``:
    every layer's attention goes through the flash path (its plain versions
    on the CPU), the loss falls, and stop-resume reproduces the
    uninterrupted run."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "EDL_TPU_CKPT_DIR": str(tmp_path / "main"), "PYTHONPATH": str(root)}
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.train_lm", *ARGV,
                          "--attention", "flash", "--epochs", "2"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "attn=flash" in out.stdout
    rec = json.loads(out.stdout.strip().splitlines()[-1].split(" ", 1)[1])
    assert rec["nll_curve"][1] < rec["nll_curve"][0]

    flash = ["--attention", "flash"]
    _, straight, _, slosses = _run("", epochs=2, extra=flash)
    # causal self-attention: the same function as the default (dense) path
    np.testing.assert_allclose(slosses, _run("", epochs=2)[3], rtol=1e-5, atol=0)
    _, _, _, losses_a = _run(str(tmp_path / "ck"), epochs=1, extra=flash)
    start_b, resumed, meta_b, losses_b = _run(str(tmp_path / "ck"), epochs=2, extra=flash)
    assert start_b == (3, 1) and meta_b.next_epoch == 2 and resumed.step == 6
    np.testing.assert_allclose(losses_a + losses_b, slosses, rtol=1e-6, atol=0)
    for a, b in zip(resumed.model.parameters(), straight.model.parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_mid_epoch_save_reenters_the_epoch(tmp_path):
    """A save every 2 steps inside a 3-step epoch: the step-2 checkpoint's
    sidecar marks epoch 0 in progress, so a resume from it re-enters
    epoch 0; the epoch-end save commits step 3 with the epoch recorded."""
    _, state, meta, _ = _run(str(tmp_path), epochs=1, save_every=2)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [2, 3]
    mid = State().from_json((tmp_path / "2" / "meta" / "metadata").read_text())
    assert mid.in_epoch == 0 and mid.next_epoch == 0 and mid.step == 2
    end = State().from_json((tmp_path / "3" / "meta" / "metadata").read_text())
    assert end.in_epoch == -1 and end.next_epoch == 1 and end.epochs[0].step_num == 3


def test_sidecar_json_parses_in_both_packages(tmp_path):
    _run(str(tmp_path), epochs=1)
    body = json.loads((tmp_path / "3" / "meta" / "metadata").read_text())
    theirs = JaxState().from_dict(body)
    assert theirs.next_epoch == 1 and theirs.step == 3
    assert theirs.epochs[0].world_size == 1 and theirs.epochs[0].step_num == 3
    assert theirs.to_dict() == body
    # and the JAX package's sidecar parses here
    js = JaxState(total_batch_size=16)
    js.record_epoch(0, 4, 10, 0.5)
    js.data_checkpoint.mark_processed(0, 0, 8)
    js.in_epoch = 1
    ours = State().from_json(js.to_json())
    assert ours.to_dict() == js.to_dict() and ours.next_epoch == 1
    assert ours.data_checkpoint.is_processed(0, 7)


def test_checkpoint_keep_n_atomic_and_meta(tmp_path):
    (tmp_path / ".tmp-9-123").mkdir()           # a save killed mid-write
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert not (tmp_path / ".tmp-9-123").exists() and mgr.latest_step() is None
    args = train_lm.parse_args(ARGV)
    _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"))
    state = trainer.create_state(init_fn, tx)
    for step in (1, 2, 3):
        state.step = step
        assert mgr.save(step, state, State(total_batch_size=step))
    assert mgr.all_steps() == [2, 3]
    assert not mgr.save(3, state)                  # an existing step is kept
    meta = State(total_batch_size=99)
    assert mgr.save_meta(3, meta) and not mgr.save_meta(7, meta)
    fresh = trainer.create_state(init_fn, tx)
    restored, rmeta = mgr.restore(fresh)
    assert restored.step == 3 and rmeta.total_batch_size == 99
    assert mgr.restore(fresh, step=2)[1].total_batch_size == 2
    assert CheckpointManager(str(tmp_path / "empty")).restore(fresh) is None


def test_train_lm_main_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("EDL_TPU_CKPT_DIR", str(tmp_path))
    train_lm.main(ARGV + ["--epochs", "1"])
    out = capsys.readouterr().out
    rec = json.loads(out.strip().splitlines()[-1].split(" ", 1)[1])
    assert rec["device"] == "cpu" and len(rec["nll_curve"]) == 1
    assert np.isfinite(rec["val_nll"])
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


def test_markov_corpus_is_the_jax_examples():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "lm" / "train_lm.py"
    spec = importlib.util.spec_from_file_location("jax_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = train_lm.parse_args(["--vocab", "97", "--seq_len", "16", "--batch_size", "3"])
    a, b = train_lm.markov_corpus(args, 5), mod.markov_corpus(args, 5)
    for _ in range(2):
        np.testing.assert_array_equal(next(a)["ids"], next(b)["ids"])


def test_trainer_env_and_flops_match_jax():
    env = {"EDL_TPU_JOB_ID": "j", "EDL_TPU_TRAINER_ID": "3", "EDL_TPU_TRAINERS_NUM": "4",
           "EDL_TPU_TRAINER_ENDPOINTS": "a:1,b:2,c:3,d:4", "EDL_TPU_POD_ID": "p",
           "EDL_TPU_DEVICE_IDS": "0,1", "EDL_TPU_CKPT_DIR": "/ck", "EDL_TPU_POD_RANK": "1"}
    ours, theirs = TrainerEnv(env), JaxTrainerEnv(env)
    assert vars(ours) == vars(theirs)
    assert ours.endpoint == theirs.endpoint == "d:4" and ours.is_distributed
    args = (12, 768, 3072, 32000, 1024)
    assert flops.analytic_lm_flops_per_token(*args) == jflops.analytic_lm_flops_per_token(*args)
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert flops.peak_tflops("TPU v5 lite") is None


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(NoCardError):
        resolve_device()
    with pytest.raises(NoCardError):
        ElasticTrainer(lambda *a: None, TrainConfig())
    assert resolve_device("cpu") == torch.device("cpu")
