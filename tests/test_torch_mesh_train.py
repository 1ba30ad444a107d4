"""The flagship LM on a mesh, on the CPU, against the JAX package: one
4-rank gloo world (``tests/helpers/torch_mesh_worker.py``, a 120 s limit
on each process) runs every multi-rank case; the JAX side runs on its
virtual CPU devices.

- ``ElasticTrainer`` at fsdp 2 x tp 2 (FSDP2 and the tensor-parallel
  forward) against the JAX trainer on the same ``MeshSpec``, same weights,
  same global batches: f32 losses and the parameters after 3 steps;
- parameters and both AdamW moments sharded 1/fsdp (and 1/tp);
- the LM's logits on dp 2 x tp 2 (MHA, and GQA at kv heads 2) against the
  JAX model on JAX's dp 2 x tp 2 mesh;
- the vocab-parallel fused CE against the JAX blockwise CE, an
  out-of-range target included, and its gradients;
- the fsdp 2 x tp 2 storage checkpoint resumed by one process at tp 1.

Besides: a live reshard from world 2 (tp 2) to world 3 (tp 1) on a
coordination server (3 processes), ``train_resnet --dcn_dp 2`` against
``--dcn_dp 1`` in a 2-rank world, and, in process, the peer cache's
restore by overlap onto a tp rank and onto one process.
"""

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

from edl_tpu.models import transformer as jtf
from edl_tpu.models.logical import logical_axes_from_paths
from edl_tpu.ops.ce import blockwise_cross_entropy as jax_blockwise_ce
from edl_tpu.parallel import MeshSpec as JaxMeshSpec
from edl_tpu.parallel import build_mesh as jax_build_mesh
from edl_tpu.parallel.sharding import ShardingRules as JaxRules
from edl_tpu.parallel.sharding import logical_sharding as jax_logical_sharding
from edl_tpu.parallel.sharding import shard_host_batch as jax_shard_host_batch
from edl_tpu.train.trainer import ElasticTrainer as JaxTrainer
from edl_tpu.train.trainer import TrainConfig as JaxTrainConfig
from edl_tpu_torch import train_lm
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.utils.network import find_free_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "helpers" / "torch_mesh_worker.py"
WORKER_TIMEOUT = 120      # seconds per worker process
WORLD = 4
# the JAX tests' sizes (tests/test_models.py:141)
SMALL = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=4, mlp_dim=64, max_len=16)
GQA = dict(SMALL, num_kv_heads=2)
FLAGS = ["--device", "cpu", "--vocab", "64", "--layers", "2", "--embed", "32", "--heads", "4",
         "--mlp", "64", "--seq_len", "16", "--batch_size", "2", "--fused_ce", "--ce_block", "16",
         "--lr", "3e-3"]
LR = 3e-3
# f32 throughout: the two packages sum in other orders (all-reduced partial
# products, FSDP2's reduce-scatter, XLA's collectives)
LOSS_ATOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
LOGITS_TOL = 2e-3          # rtol and atol, as the JAX test's
CE_TOL = 1e-5


def _jax_model(cfg):
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, attention_impl="dense", **cfg)
    return jc, jtf.TransformerLM(jc)


def _jax_params(jm, ids, seed=0):
    return jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(ids))["params"]


def _torch_weights(params, cfg):
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **cfg)
    return params_from_jax(jax.tree.map(np.asarray, params), tc)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, the 4-rank world's outputs (rank order) and its io dir."""
    io_dir = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 64, (4, 17)).astype(np.int32) for _ in range(3)]
    ids = rng.integers(0, 64, (4, 16)).astype(np.int32)
    _, jm = _jax_model(SMALL)
    params = _jax_params(jm, ids)
    _, gm = _jax_model(GQA)
    gparams = _jax_params(gm, ids, seed=1)
    V, D, N = 64, 32, 24
    ce = {"hidden": torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)),
          "weight": torch.from_numpy(rng.normal(size=(D, V)).astype(np.float32) * 0.2),
          "targets": torch.from_numpy(np.concatenate(
              [rng.integers(0, V, N - 2), [V + 3, -1]]).astype(np.int64)),
          "g": torch.from_numpy(rng.normal(size=N).astype(np.float32)), "block": 12}
    torch.save({"weights": _torch_weights(params, SMALL),
                "gqa_weights": _torch_weights(gparams, GQA), "gqa_cfg": GQA,
                "batches": [torch.from_numpy(b) for b in batches], "ids": torch.from_numpy(ids),
                "ce": ce, "flags": FLAGS}, io_dir / "in.pt")
    port = find_free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    logs = [open(io_dir / f"log{r}.txt", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(io_dir)], cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT, text=True,
        env={**env, "PYTHONPATH": str(ROOT), "EDL_TPU_TRAINER_ID": str(r),
             "EDL_TPU_TRAINERS_NUM": str(WORLD), "EDL_TPU_COORDINATOR": f"127.0.0.1:{port}",
             "OMP_NUM_THREADS": "1"})
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
    for r, p in enumerate(procs):
        assert p.returncode == 0, (io_dir / f"log{r}.txt").read_text()[-4000:]
    outs = [torch.load(io_dir / f"out{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"batches": batches, "ids": ids, "params": params, "gparams": gparams, "ce": ce,
            "outs": outs, "dir": io_dir}


def test_meshes_over_the_world(world):
    """``dcn_dp`` merges the pods pod-major into dp; the default mesh puts
    every rank on dp, ordered pod by pod."""
    for r, out in enumerate(world["outs"]):
        sizes, ranks, tp_rank = out["hybrid"]
        assert sizes == {"dp": 2, "fsdp": 1, "pp": 1, "sp": 1, "tp": 2, "ep": 1}
        assert np.asarray(ranks).reshape(2, 2).tolist() == [[0, 1], [2, 3]]
        assert tp_rank == r % 2
        assert out["default"]["dp"] == 4 and out["default_ranks"] == [1, 3, 0, 2]


def _jax_trainer_steps(world):
    """The JAX trainer at MeshSpec(fsdp 2, tp 2) on 4 devices: its losses and
    final parameters."""
    jc, jm = _jax_model(SMALL)

    def loss_fn(p, extra, batch, rng):
        ids = batch["ids"]
        h = jm.apply({"params": p}, ids[:, :-1], return_hidden=True)
        return jtf.lm_loss_fused(p, h, ids[:, 1:], jc, block_size=16), (extra, {})

    trainer = JaxTrainer(loss_fn, JaxTrainConfig(mesh_spec=JaxMeshSpec(dp=-1, fsdp=2, tp=2)),
                         devices=jax.devices()[:WORLD])
    logical = logical_axes_from_paths(world["params"], jtf.LOGICAL_RULES)
    state = trainer.create_state(lambda: (world["params"], None), optax.adamw(LR), logical)
    losses = []
    for ids in world["batches"]:
        g = jax_shard_host_batch({"ids": ids}, trainer.mesh, trainer.rules)
        state, metrics = trainer.step_fn(state, g, jax.random.key(0))
        losses.append(float(metrics["loss"]))
    return losses, jax.tree.map(np.asarray, state.params)


def test_fsdp_tp_trainer_matches_the_jax_trainer(world):
    """Three ``ElasticTrainer`` steps at fsdp 2 x tp 2 (4 gloo ranks) against
    the JAX trainer on the same MeshSpec, weights and global batches."""
    losses, jparams = _jax_trainer_steps(world)
    for out in world["outs"]:
        assert out["world_size"] == 2 and out["data_rank"] == out["rank"] // 2
        np.testing.assert_allclose(out["losses"], losses, atol=LOSS_ATOL, rtol=0)
    want = _torch_weights(jparams, SMALL)
    for name, p in world["outs"][0]["params"].items():
        torch.testing.assert_close(p, want[name], atol=PARAM_ATOL, rtol=PARAM_RTOL, msg=name)
    for out in world["outs"][1:]:
        for name, p in out["params"].items():
            assert torch.equal(p, world["outs"][0]["params"][name]), name


def test_fsdp_shards_params_and_momentum(world):
    """Every parameter and both AdamW moments hold 1/fsdp of their tp piece
    (DTensor shards on the fsdp dim), the tp-split ones 1/(fsdp x tp) of
    the leaf."""
    shapes = world["outs"][0]["shapes"]
    D, M, V, H = 32, 64, 64, 4
    want = {"tok_embed.weight": (V // 2, D // 2), "layers.0.attn_qkv.weight": (3 * D // 2, D // 2),
            "layers.0.attn_out.weight": (D // 2, D // 2), "layers.0.mlp_in.weight": (M // 2, D // 2),
            "layers.0.mlp_out.weight": (D // 2, M // 2), "layers.0.attn_norm.scale": (D // 2,),
            "lm_head.weight": (V // 2, D // 2), "final_norm.scale": (D // 2,)}
    for name, local in want.items():
        assert shapes[f"model/{name}"][0] == local, name
        for k in ("exp_avg", "exp_avg_sq"):
            assert shapes[f"{k}/{name}"] == (local, True), (k, name)
    assert H % 2 == 0 and sum(np.prod(s[0]) for n, s in shapes.items()
                              if n.startswith("model/")) * 2 * 2 >= ttf.param_count(
        ttf.TransformerConfig(**SMALL))


def test_fsdp_tp_pieces_cover_every_leaf_once(world):
    """The peer cache's pieces at fsdp 2 x tp 2: each rank snapshots its
    FSDP2 shard of its tp rows as boxes of the global leaf (a q|k|v shard
    is three), no box comes from two ranks (a norm scale, replicated over
    tp, only from tp rank 0; ``__struct__`` only from rank 0), and the
    boxes of all ranks assemble every parameter and both moments whole:
    the parameters equal the gathered ones."""
    from edl_tpu_torch.memstate import restore

    owners = {}
    for out in world["outs"]:
        for key in out["pieces"]:
            assert key not in owners, (key, owners.get(key), out["rank"])
            owners[key] = out["rank"]
    assert [k for k in owners if k.startswith("__struct__")] and all(
        owners[k] == 0 for k in owners if k.startswith("__struct__"))
    norm = [k for k in owners if k.startswith("model/final_norm.scale@")]
    assert sorted(owners[k] for k in norm) == [0, 2]      # tp rank 0 of each fsdp shard
    qkv = [k for k in owners if k.startswith("model/layers.0.attn_qkv.weight@")]
    assert len(qkv) == 4 * 3                              # 4 ranks, 3 boxes each
    holders, fetched = {}, {}
    for out in world["outs"]:
        for key, (ent, host) in out["pieces"].items():
            holders[key] = [(f"r{out['rank']}", ent, f"r{out['rank']}")]
            data = host.view(torch.int16) if host.dtype == torch.bfloat16 else host
            fetched[key] = data.numpy().tobytes()
    by_leaf = {}
    for key, cands in holders.items():
        by_leaf.setdefault(cands[0][1]["leaf"], []).append(key)
    params = world["outs"][0]["params"]
    moments = [leaf for leaf in by_leaf if leaf.startswith("optimizer/state/")
               and leaf.rsplit("/", 1)[1] in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 2 * len(params)
    for leaf, keys in by_leaf.items():
        if leaf == "__struct__":
            continue
        whole = restore._assemble(leaf, keys, holders, dict(fetched))
        assert whole is not None, leaf
        if leaf.startswith("model/"):
            assert torch.equal(whole, params[leaf[len("model/"):]]), leaf


@pytest.mark.parametrize("key,cfg,pkey", [("logits", SMALL, "params"),
                                          ("gqa_logits", GQA, "gparams")])
def test_transformer_tp_sharding_end_to_end(world, key, cfg, pkey):
    """Logits of the dp 2 x tp 2 torch world (each data coordinate's rows;
    both tp ranks give the whole vocabulary) against the JAX model on JAX's
    dp 2 x tp 2 mesh; GQA at kv heads 2 splits 1 kv head a tp rank."""
    jc, jm = _jax_model(cfg)
    mesh = jax_build_mesh(JaxMeshSpec(dp=2, tp=2), jax.devices()[:WORLD])
    rules = JaxRules()
    logical = logical_axes_from_paths(world[pkey], jtf.LOGICAL_RULES)
    params = jax.tree.map(lambda x, ax: jax.device_put(x, jax_logical_sharding(ax, mesh, rules)),
                          world[pkey], logical)
    gids = jax_shard_host_batch({"ids": world["ids"]}, mesh, rules)["ids"]
    want = np.asarray(jax.jit(lambda p, i: jm.apply({"params": p}, i))(params, gids))
    outs = world["outs"]
    got = np.concatenate([outs[0][key].numpy(), outs[2][key].numpy()])
    np.testing.assert_allclose(got, want, rtol=LOGITS_TOL, atol=LOGITS_TOL)
    for a, b in ((0, 1), (2, 3)):
        assert torch.equal(outs[a][key], outs[b][key])
    Hk, Dh = cfg.get("num_kv_heads") or cfg["num_heads"], cfg["embed_dim"] // cfg["num_heads"]
    qkv = outs[0][key + "_shapes"]["layers.0.attn_qkv.weight"]
    assert qkv == ((cfg["num_heads"] + 2 * Hk) * Dh // 2, cfg["embed_dim"])


def test_vocab_parallel_ce_matches_jax(world):
    """Each tp rank's NLL over the whole vocabulary from its 32 columns,
    against the JAX blockwise CE on the full weight (an out-of-range target
    and a negative one give ~1e30); dhidden (all-reduced) and each rank's
    dW columns against JAX's gradients of sum(nll * g)."""
    ce = world["ce"]
    h, w = jnp.asarray(ce["hidden"].numpy()), jnp.asarray(ce["weight"].numpy())
    t, g = jnp.asarray(ce["targets"].numpy()), jnp.asarray(ce["g"].numpy())
    nll, vjp = jax.vjp(lambda h, w: jax_blockwise_ce(h, w, t, block_size=ce["block"]), h, w)
    dh, dw = vjp(g)
    nll, dh, dw = np.asarray(nll), np.asarray(dh), np.asarray(dw)
    assert nll[-2] > 1e29 and nll[-1] > 1e29
    for out in world["outs"]:
        got = out["ce"]
        np.testing.assert_allclose(got["nll"][:-2].numpy(), nll[:-2], rtol=CE_TOL, atol=CE_TOL)
        np.testing.assert_allclose(got["nll"][-2:].numpy(), nll[-2:], rtol=1e-6)
        np.testing.assert_allclose(got["dh"].numpy(), dh, rtol=CE_TOL, atol=CE_TOL)
        a, b = got["cols"]
        np.testing.assert_allclose(got["dw"].numpy(), dw[:, a:b], rtol=CE_TOL, atol=CE_TOL)


def test_storage_resume_from_tp2_fsdp2_to_tp1(world, monkeypatch):
    """The fsdp 2 x tp 2 world's checkpoint (global leaves, written by rank
    0) restored by one process at tp 1: the gathered parameters, both
    moments' shapes, the step; its next step's loss equals the JAX
    trainer's 4th loss from the same state."""
    for var in [k for k in os.environ if k.startswith("EDL_TPU_")]:
        monkeypatch.delenv(var)
    assert all(out["saved"] for out in world["outs"])
    args = train_lm.parse_args(FLAGS)
    _, trainer, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"),
                                                     str(world["dir"] / "ckpt"))
    state, meta = trainer.restore_or_create(init_fn, tx, ttf.LOGICAL_RULES)
    assert state.step == 3 and not state.sharded and meta.epochs[0].world_size == 2
    for name, p in state.model.state_dict().items():
        assert torch.equal(p, world["outs"][0]["params"][name]), name
    for st in state.optimizer.state.values():
        assert {k for k in st} == {"step", "exp_avg", "exp_avg_sq"}
    ids = world["batches"][0]
    state, metrics = trainer.step_fn(state, {"ids": torch.from_numpy(ids)},
                                     torch.Generator().manual_seed(0))
    jlosses, _ = _jax_trainer_steps({**world, "batches": world["batches"] + [ids]})
    np.testing.assert_allclose(float(metrics["loss"]), jlosses[3], atol=LOSS_ATOL, rtol=0)


RESHARD_WORKER = ROOT / "tests" / "helpers" / "torch_mesh_reshard_worker.py"
RESHARD_FLAGS = ["--device", "cpu", "--vocab", "64", "--layers", "1", "--embed", "32",
                 "--heads", "2", "--mlp", "64", "--seq_len", "16", "--batch_size", "2",
                 "--steps_per_epoch", "4", "--fused_ce", "--ce_block", "16"]
RESHARD_EPOCHS = 4


def test_live_reshard_from_tp2_at_world2_to_tp1_at_world3(coord_server, tmp_path):
    """The launcher played on a coordination server: pods a and b train at
    auto tp 2 (world 2), each with its peer cache; after epoch 0 the test
    flags a grow to a, b, c and spawns c.  a and b pause, reform into
    world 3 (auto tp 1) and restore their tp-2 boxes by overlap from their
    own snapshots and each other's caches; c restores the same step.
    Every rank trains the same rows each step, so every loss equals the
    uninterrupted single-process run's at that step (within 1e-6)."""
    import time

    from edl_tpu_torch.cluster import resize
    from edl_tpu_torch.cluster.cluster import Cluster
    from edl_tpu_torch.cluster.pod import Pod, Trainer
    from edl_tpu_torch.coord.client import connect
    from tests.helpers.torch_cache import JOB

    ep = f"127.0.0.1:{coord_server.port}"
    ids = train_lm.markov_corpus(train_lm.parse_args(RESHARD_FLAGS), 5).__next__()["ids"]
    torch.save({"ids": torch.from_numpy(ids)}, tmp_path / "in.pt")
    ckpt = tmp_path / "ckpt"
    port = find_free_port()
    store = connect(ep)

    def cluster(names, stage):
        pods = []
        for i, name in enumerate(names):
            pod = Pod(pod_id=name)
            pod.trainers = [Trainer(endpoint=f"127.0.0.1:{port + i}")]
            pods.append(pod)
        c = Cluster.from_pods(pods)
        c.stage = stage
        store.put(f"/edl_tpu/{JOB}/cluster/cluster", c.to_json().encode())

    def spawn(rank, world, stage):
        env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
        env.update({"PYTHONPATH": str(ROOT), "EDL_TPU_JOB_ID": JOB,
                    "EDL_TPU_POD_ID": f"pod-{'abc'[rank]}", "EDL_TPU_POD_RANK": str(rank),
                    "EDL_TPU_CLUSTER_STAGE": stage, "EDL_TPU_COORD_ENDPOINTS": ep,
                    "EDL_TPU_TRAINER_ID": str(rank), "EDL_TPU_TRAINER_RANK_IN_POD": "0",
                    "EDL_TPU_TRAINERS_NUM": str(world), "EDL_TPU_CKPT_DIR": str(ckpt),
                    "EDL_TPU_TRAINER_ENDPOINTS": ",".join(f"127.0.0.1:{port + r}"
                                                          for r in range(world)),
                    "EDL_TPU_COORDINATOR": f"127.0.0.1:{port}",
                    "EDL_TPU_PREEMPT_CHECK_STEPS": "1", "EDL_TPU_PREEMPT_CHECK_SECONDS": "0",
                    "OMP_NUM_THREADS": "1"})
        log = open(tmp_path / f"log{rank}.txt", "w+")
        proc = subprocess.Popen([sys.executable, str(RESHARD_WORKER), str(tmp_path),
                                 str(RESHARD_EPOCHS), *RESHARD_FLAGS], cwd=ROOT, env=env,
                                stdout=log, stderr=subprocess.STDOUT, text=True)
        return proc, log

    cluster(["pod-a", "pod-b"], "st-1")
    procs = [spawn(0, 2, "st-1"), spawn(1, 2, "st-1")]
    try:
        deadline = time.monotonic() + WORKER_TIMEOUT
        while not (ckpt / "4").is_dir():
            assert time.monotonic() < deadline, (tmp_path / "log0.txt").read_text()[-4000:]
            assert all(p.poll() is None for p, _ in procs), (tmp_path / "log0.txt").read_text()
            time.sleep(0.05)
        resize.flag_resize(store, JOB, "st-1", "grow", "st-2", "pod-a")
        resize.write_go(store, JOB, "st-1", "st-2", "grow")
        cluster(["pod-a", "pod-b", "pod-c"], "st-2")
        procs.append(spawn(2, 3, "st-2"))
        for p, _ in procs:
            p.wait(timeout=WORKER_TIMEOUT)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        store.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"log{r}.txt").read_text()[-6000:]
    outs = {n: torch.load(tmp_path / f"out-pod-{n}.pt", weights_only=False) for n in "abc"}

    # the uninterrupted run: one process, the same rows every step
    args = train_lm.parse_args(RESHARD_FLAGS)
    _, tr, init_fn, tx = train_lm.build_trainer(args, torch.device("cpu"))
    state = tr.create_state(init_fn, tx, ttf.LOGICAL_RULES)
    want = []
    for _ in range(2 * RESHARD_EPOCHS * args.steps_per_epoch):
        state, metrics = tr.step_fn(state, {"ids": torch.from_numpy(ids)},
                                    torch.Generator().manual_seed(0))
        want.append(float(metrics["loss"]))

    for n in "ab":
        out = outs[n]
        [rs] = out["reshards"]
        assert rs["mode"] == "grow" and rs["source"] == "delta" and rs["world"] == 3, rs
        assert rs["local_bytes"] > 0 and rs["wire_bytes"] > 0, rs
        meshes = [tp for _, tp in out["losses"]]
        paused = rs["step"]
        assert meshes == [2] * paused + [1] * (len(meshes) - paused), meshes
        assert [loss for loss, _ in out["losses"]] == pytest.approx(want[:len(meshes)], rel=1e-6)
    c = outs["c"]
    assert c["first_step"] == outs["a"]["reshards"][0]["step"] > 4
    got = [loss for loss, _ in c["losses"]]
    assert got == pytest.approx(want[c["first_step"]:c["first_step"] + len(got)], rel=1e-6)
    assert {o["step"] for o in outs.values()} == {outs["a"]["step"]}
    assert all(o["mesh"]["tp"] == 1 and o["processes"] == 3 for o in outs.values())


_DCN_RANK = r"""
import os, sys
rank, port, io = int(sys.argv[1]), sys.argv[2], sys.argv[3]
# rank 0 on pod 1 and rank 1 on pod 0: the mesh orders ranks pod by pod
os.environ.update({"EDL_TPU_TRAINER_ID": str(rank), "EDL_TPU_TRAINERS_NUM": "2",
                   "EDL_TPU_POD_RANK": str(1 - rank)})
import numpy as np, torch, torch.distributed as dist
from edl_tpu_torch import train_resnet
from edl_tpu_torch.cluster.env import TrainerEnv
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
torch.set_num_threads(1)
out = {}
for dcn in (2, 1):
    args = train_resnet.parse_args([
        "--device", "cpu", "--synthetic", "4", "--synthetic_per_file", "16",
        "--synthetic_files", "2", "--data_dir", f"{io}/data", "--model", "resnet18",
        "--width", "8", "--image_size", "32", "--batch_size", "8", "--epochs", "1",
        "--steps_per_epoch", "2", "--num_workers", "1", "--dcn_dp", str(dcn)])
    state, meta = train_resnet.train(args, torch.device("cpu"), TrainerEnv(), None)
    out.update({f"{dcn}/{n}": t.numpy() for n, t in state.model.state_dict().items()})
np.savez(f"{io}/out{rank}.npz", **out)
"""


def test_train_resnet_dcn_dp_2_equals_dcn_dp_1(tmp_path):
    """``train_resnet --dcn_dp 2`` in a 2-rank world of two pods (rank 0 on
    pod 1): dp is the two pods' replica groups, pod-major, so rank 0 reads
    data shard 1 and rank 1 shard 0; the same run at ``--dcn_dp 1`` orders
    the ranks the same way, and the two runs end with equal weights, BN
    running statistics included."""
    from tests.test_torch_sync_bn import spawn_world

    outs = spawn_world(_DCN_RANK, tmp_path)
    logs = [(tmp_path / f"rank{r}.log").read_text() for r in range(2)]
    assert logs[0].count("rank=0/2 data_rank=1") == 2, logs[0][-2000:]
    assert logs[1].count("rank=1/2 data_rank=0") == 2, logs[1][-2000:]
    names = [k[2:] for k in outs[0] if k.startswith("2/")]
    assert names
    for out in outs:
        for n in names:
            np.testing.assert_array_equal(out[f"2/{n}"], out[f"1/{n}"], err_msg=n)
    for n in names:
        np.testing.assert_array_equal(outs[0][f"2/{n}"], outs[1][f"2/{n}"], err_msg=n)


def _tp_state(cfg, rank, seed=0):
    """A TrainState of the LM cut to tp rank ``rank`` of 2 (no process
    group: placing and restoring run no collective)."""
    from edl_tpu_torch.models.logical import logical_axes_from_paths
    from edl_tpu_torch.parallel.mesh import MeshSpec, mesh_layout
    from edl_tpu_torch.parallel.sharding import param_layouts, tp_slice
    from edl_tpu_torch.parallel.tp import TP
    from edl_tpu_torch.train.state import TrainState, adamw

    model = ttf.TransformerLM(cfg, torch.Generator().manual_seed(seed))
    layout = mesh_layout(MeshSpec(tp=2), 2)
    lays = param_layouts(model, logical_axes_from_paths(model, ttf.LOGICAL_RULES), layout)
    tp = TP(None, rank, 2)
    model.set_tp(tp)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = tp_slice(p.data, lays[name], tp).contiguous()
    model.param_layouts, model.tp, model.mesh = lays, tp, layout
    return TrainState.create(model, adamw(1e-3))


def test_restore_plans_by_overlap_on_the_new_mesh():
    """The peer cache of a tp-2 world (each rank's own boxes: a head-split
    q|k|v piece is three) restored onto tp rank 1: only the boxes that
    overlap rank 1's rows are planned, and the state equals rank 1's; onto
    one process at tp 1 every box is planned and the leaves are whole."""
    from edl_tpu_torch.memstate import restore, shards

    cfg = ttf.TransformerConfig(dtype=torch.float32, remat=False, **GQA)
    sources = {f"pod-{r}": shards.local_source(_tp_state(cfg, r)) for r in range(2)}
    holders, fetched = {}, {}
    for pod, src in sources.items():
        for key, (ent, data) in src.items():
            holders.setdefault(key, []).append((pod, ent, pod))
            fetched[key] = bytes(data)
    qkv = "model/layers.0.attn_qkv.weight"
    assert len([k for k in holders if k.startswith(qkv + "@")]) == 6

    def restored(target):
        needed = restore._needed(target)
        leaves = restore._plan(holders, target, needed)
        tensors = {leaf: restore._assemble(leaf, keys, holders, dict(fetched),
                                           restore._boxes_needed(needed, leaf))
                   for leaf, keys in leaves}
        skeleton = shards.load_skeleton(tensors.pop(shards.STRUCT_LEAF).numpy().tobytes())
        target.load_state_dict(shards.unflatten(skeleton, tensors))
        return dict(leaves)

    want = _tp_state(cfg, 1)
    target = _tp_state(cfg, 1, seed=5)
    planned = restored(target)
    own = {k for k in sources["pod-1"] if k.startswith(qkv + "@")}
    assert set(planned[qkv]) == own and len(own) == 3
    for name, p in target.model.named_parameters():
        assert torch.equal(p, dict(want.model.named_parameters())[name]), name

    from edl_tpu_torch.train.state import TrainState, adamw
    full = TrainState.create(ttf.TransformerLM(cfg, torch.Generator().manual_seed(5)), adamw(1e-3))
    planned = restored(full)
    assert len(planned[qkv]) == 6
    for name, p in ttf.TransformerLM(cfg).named_parameters():
        assert torch.equal(dict(full.model.named_parameters())[name], p), name
