"""The port's Wide&Deep and its CTR trainer against the JAX package:
``WideDeep`` against flax on the same weights (forward and gradients of the
example's loss, f32 and the default bf16; ``tests/test_models.py:70``'s
shapes), the converter both ways, three Adam steps of ``train_wide_deep``
against the JAX example's on the same batches, the click model and the AUC
against the example's own, the tables cut over ``ep`` in a gloo world of two
(each rank half of every table, the losses of one process, a checkpoint that
resumes at ep 1 to the bit), the entry point's device default; and, ``slow``,
the twins of ``tests/test_ctr_example.py`` (AUC alone and under the
launcher)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models.wide_deep import WideDeep as JWideDeep
from edl_tpu_torch import train_wide_deep as twd
from edl_tpu_torch.models.convert import wide_deep_from_jax, wide_deep_to_jax
from edl_tpu_torch.models.wide_deep import WideDeep
from edl_tpu_torch.utils.device import NoCardError
from tests.helpers.flax_trees import (assert_bit_equal_trees, check_grads, close, err_of,
                                      example, flax_value_and_grad, random_tree)
from tests.helpers.torch_spawn import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "edl_tpu_torch", "train_wide_deep.py")
WORKER = os.path.join(REPO, "tests", "helpers", "torch_wide_deep_worker.py")
# f32: of each tensor's largest magnitude (rounding); bf16: in relative
# norm (the 8-bit mantissa through two products and a sum of 6 embedding
# rows; tests/helpers/flax_trees.py:err_of)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOSS_RTOL = 1e-5      # three Adam steps in f32, each loss
VOCABS, DENSE, EMBED, HIDDEN, BATCH = (1000, 1000, 500), 4, 8, (16,), 8
SMALL = ["--device", "cpu", "--slots", "3", "--vocab", "50", "--dense_features", "4",
         "--embed_dim", "8", "--hidden", "16", "8", "--batch_size", "16"]
CPU = torch.device("cpu")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(BATCH, DENSE)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, BATCH) for v in VOCABS], 1).astype(np.int32)
    label = (rng.random(BATCH) < 0.5).astype(np.float32)
    return dense, sparse, label


def _flax_run(dtype, params, dense, sparse, label, exact=False):
    """``(loss, logits, grads)`` of flax's ``WideDeep`` (float64 when
    ``exact``; grads None in f32, whose gradients are held to the exact
    ones)."""
    fmodel = JWideDeep(vocab_sizes=VOCABS, dense_features=DENSE, embed_dim=EMBED, hidden=HIDDEN,
                       dtype=jnp.float64 if exact else getattr(jnp, dtype))

    def loss(p):
        logits = fmodel.apply({"params": p}, dense, sparse)
        return optax.sigmoid_binary_cross_entropy(logits, label).mean(), logits
    (value, logits), grads = flax_value_and_grad(loss, params, exact,
                                                 grads=exact or dtype == "bfloat16")
    return value, logits, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_deep_matches_flax(dtype):
    """Logits, the example's loss and every gradient (bf16 gradients:
    ``flax_trees.check_grads``)."""
    dense, sparse, label = _inputs()
    params = random_tree(jax.eval_shape(lambda: JWideDeep(
        vocab_sizes=VOCABS, dense_features=DENSE, embed_dim=EMBED, hidden=HIDDEN).init(
        jax.random.key(0), dense, sparse))["params"])
    loss, logits, grads = _flax_run(dtype, params, dense, sparse, label)
    model = WideDeep(VOCABS, DENSE, EMBED, HIDDEN, dtype=getattr(torch, dtype))
    model.load_state_dict(wide_deep_from_jax(params))
    out = model(torch.from_numpy(dense), torch.from_numpy(sparse))
    assert out.dtype == torch.float32 and out.shape == (BATCH,)
    close(out.detach().numpy(), logits, TOL[dtype], "logits", err_of(dtype))
    tloss = twd.loss_fn(model, None, {"dense": torch.from_numpy(dense),
                                      "sparse": torch.from_numpy(sparse),
                                      "label": torch.from_numpy(label)}, None)[0]
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=TOL[dtype])
    check_grads(wide_deep_to_jax({k: p.grad for k, p in model.named_parameters()}), grads,
                dtype, lambda: _flax_run(dtype, params, dense, sparse, label, True)[2],
                TOL[dtype])
    assert_bit_equal_trees(wide_deep_to_jax(model.state_dict()), params)


def test_three_adam_steps_match_the_jax_example():
    """The example's loss and ``optax.adam(lr)`` from converted weights, f32,
    on three click-model batches: each loss within 1e-5."""
    args = twd.parse_args(SMALL)
    fmodel = JWideDeep(vocab_sizes=[args.vocab] * args.slots,
                       dense_features=args.dense_features, embed_dim=args.embed_dim,
                       hidden=tuple(args.hidden), dtype=jnp.float32)
    rng = np.random.default_rng(1000)
    data = [twd.click_model(args, rng, args.batch_size) for _ in range(3)]
    params = random_tree(jax.eval_shape(lambda: fmodel.init(
        jax.random.key(0), data[0]["dense"], data[0]["sparse"]))["params"])
    tx = optax.adam(args.lr)

    @jax.jit
    def jstep(p, opt, b):
        def loss(p):
            return optax.sigmoid_binary_cross_entropy(
                fmodel.apply({"params": p}, b["dense"], b["sparse"]), b["label"]).mean()
        value, grads = jax.value_and_grad(loss)(p)
        updates, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, updates), opt, value

    p, opt, jlosses = params, tx.init(params), []
    for b in data:
        p, opt, value = jstep(p, opt, b)
        jlosses.append(float(value))
    trainer, _, ttx = twd.build_trainer(args, CPU)

    def init():
        model = twd.make_model(args, CPU)
        model.load_state_dict(wide_deep_from_jax(params))
        return model, None

    state = trainer.create_state(init, ttx)
    losses = []
    for b in data:
        state, metrics = trainer.step_fn(state, {k: torch.from_numpy(v) for k, v in b.items()},
                                         torch.Generator())
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)


def test_click_model_and_auc_are_the_examples():
    jex = example("ctr/train_wide_deep.py", "jax_train_wide_deep")
    args = twd.parse_args(SMALL)
    ours = twd.click_model(args, np.random.default_rng(5), 64)
    theirs = jex.click_model(args, np.random.default_rng(5), 64)
    for k in ("dense", "sparse", "label"):
        np.testing.assert_array_equal(ours[k], theirs[k])
    rng = np.random.default_rng(6)
    scores = np.round(rng.normal(size=200), 1)        # ties included
    labels = (rng.random(200) < 0.4).astype(np.float32)
    assert twd.auc(scores, labels) == jex.auc(scores, labels)
    assert twd.auc(scores, np.zeros(200)) == jex.auc(scores, np.zeros(200)) == 0.5


def test_tables_over_ep_in_a_world_of_two(tmp_path):
    """dp 1 x ep 2 in a spawned gloo world: each rank holds half of every
    table's rows and reads the same rows of the batch; its 3 losses are the
    one process's (1e-5, f32); the checkpoint resumes at ep 1 with every
    table equal to the ranks' rows to the bit."""
    args = twd.parse_args(SMALL)
    rng = np.random.default_rng(1000)
    data = [twd.click_model(args, rng, args.batch_size) for _ in range(3)]
    torch.save({"argv": SMALL, "batches": data}, tmp_path / "batches.pt")
    outs = run_world(WORKER, tmp_path, 2, timeout=120)
    for r, out in enumerate(outs):
        assert out["mesh"]["ep"] == 2 and out["mesh"]["dp"] == 1 and out["data_rank"] == 0
        for name, t in out["tables"].items():
            assert t.shape[0] == args.vocab // 2, (r, name, tuple(t.shape))
    # one process, ep 1, the same seed-0 init and batches
    trainer, init_fn, tx = twd.build_trainer(args, CPU)
    state = trainer.create_state(init_fn, tx)
    losses = []
    for b in data:
        state, metrics = trainer.step_fn(state, {k: torch.from_numpy(v) for k, v in b.items()},
                                         torch.Generator())
        losses.append(float(metrics["loss"]))
    assert outs[0]["losses"] == outs[1]["losses"]
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=LOSS_RTOL)
    # the ep-2 checkpoint at ep 1: the global tables, to the bit
    resumed, _, _ = twd.build_trainer(args, CPU, str(tmp_path / "ckpt"))
    rstate, meta = resumed.restore_or_create(init_fn, tx)
    assert rstate.step == 3 and meta.step == 3
    params = dict(rstate.model.named_parameters())
    for name in outs[0]["tables"]:
        whole = torch.cat([outs[0]["tables"][name], outs[1]["tables"][name]])
        assert torch.equal(params[name].detach(), whole), name
        # and the one process's tables after the same steps
        close(params[name].detach().numpy(),
              dict(state.model.named_parameters())[name].detach().numpy(), 1e-5, name)


def test_entry_point_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("EDL_TPU_CKPT_DIR", str(tmp_path / "ckpt"))
    with pytest.raises(NoCardError):
        twd.main([])
    assert not (tmp_path / "ckpt").exists()


# -- slow: tests/test_ctr_example.py's twins --------------------------------------

CTR_ARGS = ["--device", "cpu", "--epochs", "2", "--steps_per_epoch", "40",
            "--batch_size", "128", "--vocab", "100", "--lr", "0.01"]


def _last_record(marker):
    return json.loads([line for line in marker.read_text().splitlines()
                       if line.startswith("done ")][-1][5:])


@pytest.mark.slow
def test_wide_deep_standalone_reaches_auc(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(PYTHONPATH=REPO, EDL_TPU_DEMO_MARKER=str(tmp_path / "marker"),
               EDL_TPU_CKPT_DIR=str(tmp_path / "ckpt"))
    out = subprocess.run([sys.executable, TRAIN, *CTR_ARGS], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = _last_record(tmp_path / "marker")
    assert rec["auc"] >= 0.8, rec


@pytest.mark.slow
def test_wide_deep_under_launcher(coord_server, tmp_path):
    """One pod of two torch trainers under the unchanged JAX launcher: a
    2-rank gloo world at dp 1 x ep 2."""
    from tests.test_launch_integration import FAST, finish
    ep = f"127.0.0.1:{coord_server.port}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(FAST)
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", EDL_TPU_HOST_IP="127.0.0.1",
               EDL_TPU_DEMO_MARKER=str(tmp_path / "marker"), OMP_NUM_THREADS="2")
    log = open(tmp_path / "launcher.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu.collective.launch", "--job_id", "ctr",
         "--coord_endpoints", ep, "--nodes_range", "1:1", "--nproc_per_node", "2",
         "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "log"),
         TRAIN, "--", *CTR_ARGS],
        env=env, cwd=str(tmp_path), stdout=log, stderr=subprocess.STDOUT)
    proc._logfile = log  # noqa: SLF001
    try:
        assert finish(proc, 420) == 0, \
            (tmp_path / "launcher.log").read_text(errors="replace")[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rec = _last_record(tmp_path / "marker")
    assert rec["auc"] >= 0.75 and rec["world"] == 2, rec
    logs = "".join(p.read_text(errors="replace") for p in (tmp_path / "log").rglob("*")
                   if p.is_file())
    assert "'ep': 2" in logs, logs[-3000:]
