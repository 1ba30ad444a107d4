"""Tensor-parallel serving of the port on the CPU, against the JAX package:
one 2-rank gloo world (``tests/helpers/torch_serving_tp_worker.py``, a
120 s limit on each process) runs every multi-rank case, rank 0 leading
each tp group and rank 1 following; the JAX side runs here, from the same
weights (seeded JAX inits converted), in f32.  Every greedy token a tp
group emits is held to JAX ``generate``'s on the same weights; sampled
draws to one process's port (the packages' generators differ).

- the tp-2 ``ContinuousBatcher``'s greedy tokens equal JAX ``generate``'s
  for MHA, GQA (kv heads 2, split) and MQA (kv heads 1, whole on each
  rank), as ``tests/test_serving_engine.py:106`` holds the JAX mesh
  engine;
- the paged pool on the tp group (``tests/test_serving_kv.py:248``), paged
  against unpaged (``tests/test_serving_fastpath.py:92``), a session
  migrated tp 2 -> tp 2, tp 2 -> tp 1 and tp 1 -> tp 2 (``:59``): warm and
  bit-exact, the exported blob the same layout whatever the mesh;
- speculative decoding with the draft on rank 0; ``module_teacher(mesh=)``
  against the JAX ``jit_teacher(mesh=)`` (``tests/test_serving_engine.py:
  133``); ``generate`` and serve_lm's batch path on a tp model; a
  ``ReplicaServer`` over a tp engine behind the ``Gateway``; serve_lm's
  checkpoint restore at tp 2;
- a follower whose leader is SIGKILLed leaves; ``python -m
  edl_tpu_torch.serve_lm --tp 2 --device cpu`` over the wire, and its
  follower dies with it.

Slow: the combined chunk + spec + paged case (``tests/test_serving_
fastpath.py:271``) and ``python -m edl_tpu_torch.serving.replica --tp 2``
behind the gateway on the JAX coordination server.
"""

import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.distill.teacher import jit_teacher
from edl_tpu.models import transformer as jtf
from edl_tpu.models.generate import generate as jax_generate
from edl_tpu.parallel import MeshSpec as JaxMeshSpec
from edl_tpu.parallel import build_mesh as jax_build_mesh
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax, params_to_jax
from edl_tpu_torch.models.generate import generate
from edl_tpu_torch.parallel.sharding import param_layouts, tp_ranges
from edl_tpu_torch.parallel.tp import TP
from edl_tpu_torch.utils.network import find_free_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "helpers" / "torch_serving_tp_worker.py"
WORKER_TIMEOUT = 120      # seconds per worker process
# the JAX serving tests' sizes (vocab 97 does not divide over tp 2: the
# embedding and head stay whole on each rank)
SMALL = dict(vocab_size=97, num_layers=2, embed_dim=64, num_heads=4, mlp_dim=128, max_len=64)
CFGS = {"mha": SMALL, "gqa": dict(SMALL, num_kv_heads=2), "mqa": dict(SMALL, num_kv_heads=1),
        # 3 kv heads over tp 2: whole on each rank, and a rank's 3 query
        # heads straddle two kv groups
        "gqa3": dict(SMALL, embed_dim=96, num_heads=6, num_kv_heads=3),
        # tests/test_serving_engine.py:133's teacher
        "teacher": dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=4, mlp_dim=64,
                        max_len=32)}
# f32 on both sides; the tp forward adds its row-parallel partial sums in
# another order than one matmul (the JAX test's own bound: atol 1e-5)
TEACHER_ATOL = 1e-5
# the blob of a tp-2 export against one process's: the same layout, values
# within f32 rounding of the two sum orders
BLOB_ATOL = 1e-5
CASES = "engine,paged,paged_vs_unpaged,migrate,spec,teacher,generate,replica,checkpoint"

_jax_generate = jax.jit(jax_generate, static_argnums=(0, 3), static_argnames=("temperature",))


def _jax_cfg(name):
    """The JAX config of ``CFGS[name]``, or of a dict of the same fields."""
    fields = CFGS[name] if isinstance(name, str) else name
    return jtf.TransformerConfig(dtype=jnp.float32, remat=False, attention_impl="dense",
                                 **fields)


def _jax_params(name, seed):
    jc = _jax_cfg(name)
    return jax.jit(jtf.TransformerLM(jc).init)(jax.random.key(seed),
                                              jnp.zeros((1, 4), jnp.int32))["params"]


def _port_model(weights, name):
    model = ttf.TransformerLM(ttf.TransformerConfig(dtype=torch.float32, remat=False,
                                                    **CFGS[name]), init=False)
    model.load_state_dict(weights)
    return model.requires_grad_(False).eval()


def _want_jax(name, params, p, n):
    return np.asarray(_jax_generate(_jax_cfg(name), params, jnp.asarray(p[None]), n,
                                    temperature=0.0))[0]


def _want_jax_of(model, p, n):
    """JAX ``generate``'s greedy tokens on a port model's weights."""
    c = model.cfg
    fields = dict(vocab_size=c.vocab_size, num_layers=c.num_layers, embed_dim=c.embed_dim,
                  num_heads=c.num_heads, num_kv_heads=c.num_kv_heads, mlp_dim=c.mlp_dim,
                  max_len=c.max_len)
    params = jax.tree.map(jnp.asarray, params_to_jax(model.state_dict(), c))
    return np.asarray(_jax_generate(_jax_cfg(fields), params, jnp.asarray(np.asarray(p)[None]),
                                    n, temperature=0.0))[0]


def _want(model, p, n):
    return generate(model, torch.from_numpy(np.asarray(p)[None]), n, temperature=0).numpy()[0]


def _inputs():
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, 97, (12,)).astype(np.int32)
    return {
        # tests/test_serving_engine.py:106
        "prompts": [rng.integers(1, 97, (n,)).astype(np.int32) for n in (3, 9, 14, 6)],
        "news": [7, 4, 10, 6],
        # tests/test_serving_kv.py:248
        "shared": [np.concatenate([prefix, rng.integers(1, 97, (n,)).astype(np.int32)])
                   for n in (3, 6, 2)],
        # tests/test_serving_fastpath.py:92
        "mixed": [np.concatenate([prefix[:9], rng.integers(1, 97, (n,)).astype(np.int32)])
                  for n in (2, 6, 3)] + [rng.integers(1, 97, (5,)).astype(np.int32)],
        "mixed_news": [5, 7, 4, 6],
        # tests/test_serving_fastpath.py:59 and :271
        "p1": [7, 11, 13, 5, 9, 2, 8, 3],
        "combined": [np.concatenate([prefix, rng.integers(1, 97, (n,)).astype(np.int32)])
                     for n in (3, 6)] + [rng.integers(1, 97, (40,)).astype(np.int32)],
        "teacher_ids": [np.random.default_rng(2).integers(0, 64, (2, 8)).astype(np.int32)],
    }


def spawn_world(io_dir, cases, env_extra=None):
    """The 2-rank world's processes, started (output to files)."""
    port = find_free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(PYTHONPATH=str(ROOT), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", OMP_NUM_THREADS="1", **(env_extra or {}))
    logs = [open(io_dir / f"log{r}.txt", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(io_dir), cases], cwd=ROOT,
                              stdout=log, stderr=subprocess.STDOUT, text=True,
                              env={**env, "RANK": str(r)})
             for r, log in enumerate(logs)]
    return procs, logs


def wait_world(io_dir, procs, logs, codes=(0, 0)):
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
    for r, (p, code) in enumerate(zip(procs, codes)):
        assert p.returncode == code, (io_dir / f"log{r}.txt").read_text()[-4000:]


def _write_inputs(io_dir, names_seeds):
    from edl_tpu_torch.train.checkpoint import CheckpointManager
    from edl_tpu_torch.train.state import TrainState, adamw

    params = {name: _jax_params(name, seed) for name, seed in names_seeds}
    tc = {name: ttf.TransformerConfig(dtype=torch.float32, remat=False, **CFGS[name])
          for name in params}
    weights = {name: params_from_jax(jax.tree.map(np.asarray, p), tc[name])
               for name, p in params.items()}
    ckpt = io_dir / "ckpt"
    if "gqa" in weights:
        CheckpointManager(str(ckpt)).save(1, TrainState.create(
            _port_model(weights["gqa"], "gqa"), adamw(1e-3)))
    torch.save({"weights": weights, "cfgs": CFGS, "ckpt": str(ckpt), **_inputs()},
               io_dir / "in.pt")
    return params, weights


def _jax_references(params, data):
    """JAX ``generate``'s greedy tokens for every multi-rank case, at the
    cases' seeds, prompts and lengths (f32)."""
    def want(name, prompts, news):
        return [_want_jax(name, params[name], p, n) for p, n in zip(prompts, news)]

    ref = {"engine": {name: want(name, data["prompts"], data["news"])
                      for name in ("mha", "gqa", "mqa", "gqa3")},
           "shared": want("mha", data["shared"], [5] * len(data["shared"])),
           "mixed": {name: want(name, data["mixed"], data["mixed_news"]) for name in ("mha", "mqa")},
           "migrate": {}}
    p1 = np.asarray(data["p1"], np.int32)
    for name in ("mha", "mqa"):
        out1 = _want_jax(name, params[name], p1, 8)
        p2 = np.concatenate([p1, out1, np.asarray([4, 1], np.int32)])   # the worker's turn 2
        ref["migrate"][name] = {"out1": out1, "p2": p2,
                                "out2": _want_jax(name, params[name], p2, 6)}
    pair = np.stack([data["prompts"][0][:3], data["prompts"][1][:3]])
    ref["generate"] = np.asarray(_jax_generate(_jax_cfg("gqa"), params["gqa"], jnp.asarray(pair),
                                               6, temperature=0.0))
    ref["batch"] = want("gqa", data["prompts"][:2], [5, 5])
    ref["checkpoint"] = _want_jax("gqa", params["gqa"], data["prompts"][2], 6)
    jm = jtf.TransformerLM(_jax_cfg("teacher"))
    mesh = jax_build_mesh(JaxMeshSpec(dp=-1, tp=2))
    predict = jit_teacher(jm.apply, {"params": params["teacher"]}, mesh=mesh,
                          logical_rules=jtf.LOGICAL_RULES)
    ref["teacher"] = [predict({"ids": ids})["logits"] for ids in data["teacher_ids"]]
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references, computed here while the world runs, and the
    world's outputs."""
    io_dir = tmp_path_factory.mktemp("serving_tp")
    params, weights = _write_inputs(io_dir, [("mha", 0), ("gqa", 1), ("mqa", 2),
                                             ("teacher", 3), ("gqa3", 4)])
    procs, logs = spawn_world(io_dir, CASES)
    data = _inputs()
    try:
        jax_ref = _jax_references(params, data)
    finally:
        wait_world(io_dir, procs, logs)
    out = torch.load(io_dir / "out.pt", weights_only=False)
    models = {name: _port_model(w, name) for name, w in weights.items()}
    return {"out": out, "data": data, "jax": jax_ref, "models": models, "dir": io_dir}


# -- the layout, with no process group ---------------------------------------------

@pytest.mark.parametrize("name,whole", [("mha", ()), ("gqa", ()), ("mqa", (1, 2))])
def test_decode_layout_keeps_what_does_not_divide_whole(name, whole):
    """A decode model at tp 2: the fused q|k|v rows split by heads, k and v
    whole where the kv heads do not divide (MQA); the vocabulary of 97 whole
    on each rank; a training model refuses MQA and the odd vocabulary."""
    model = ttf.decode_model(ttf.TransformerLM(ttf.TransformerConfig(
        dtype=torch.float32, remat=False, **CFGS[name])))
    sizes = {"dp": 1, "fsdp": 1, "pp": 1, "sp": 1, "tp": 2, "ep": 1}
    from edl_tpu_torch.models.logical import logical_axes_from_paths
    layouts = param_layouts(model, logical_axes_from_paths(model, ttf.LOGICAL_RULES), sizes)
    qkv = layouts["layers.0.attn_qkv.weight"]
    assert qkv.whole == whole
    H, Hk, Dh = 4, ttf.TransformerConfig(**CFGS[name]).kv_heads, 16
    kv_rows = Hk * Dh if whole else Hk * Dh // 2
    assert tp_ranges(qkv, 1, 2) == [(2 * Dh, 0, 2 * Dh), (H * Dh + (0 if whole else kv_rows),
                                                          2 * Dh, kv_rows),
                                    (H * Dh + Hk * Dh + (0 if whole else kv_rows),
                                     2 * Dh + kv_rows, kv_rows)]
    assert layouts["tok_embed.weight"].tp_dim is None          # 97 rows: whole
    assert layouts["layers.0.mlp_in.weight"].segments == (128,)
    train = ttf.TransformerLM(ttf.TransformerConfig(dtype=torch.float32, remat=False,
                                                    **CFGS[name]))
    with pytest.raises(ValueError, match="does not divide"):
        train.set_tp(TP(None, 0, 2))


# -- the world's cases ----------------------------------------------------------------

@pytest.mark.parametrize("name,cache_heads,qkv_rows",
                         [("mha", 2, 96), ("gqa", 1, 64), ("mqa", 1, 64)])
def test_tp_engine_greedy_parity_vs_jax_generate(world, name, cache_heads, qkv_rows):
    """``tests/test_serving_engine.py:106``: the tp-2 engine, four requests
    in flight at once, emits JAX ``generate``'s tokens exactly; each rank
    holds half the query heads, its kv heads (all of them for MQA) and half
    the MLP."""
    got = world["out"][f"engine_{name}"]
    for a, b in zip(got["tokens"], world["jax"]["engine"][name]):
        np.testing.assert_array_equal(a, b)
    assert (got["cache_heads"], got["qkv_rows"], got["mlp_rows"]) == (cache_heads, qkv_rows, 64)


def test_tp_engine_with_kv_groups_straddling_ranks(world):
    """6 query heads over 3 kv heads at tp 2: the kv heads stay whole, and
    each rank's query heads read their own global kv head (rank 1's heads
    3, 4, 5 read kv heads 1, 2, 2); the tokens equal JAX ``generate``'s
    and one process's."""
    got, model = world["out"]["engine_gqa3"], world["models"]["gqa3"]
    for p, n, out, want in zip(world["data"]["prompts"], world["data"]["news"], got["tokens"],
                               world["jax"]["engine"]["gqa3"]):
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(out, _want(model, p, n))
    assert (got["cache_heads"], got["qkv_rows"]) == (3, 3 * 16 + 2 * 3 * 16)


def test_tp_paged_engine_bit_exact_with_prefix_hits(world):
    """``tests/test_serving_kv.py:248``: shared-prefix traffic on a tp-2
    paged engine hits the one trie and stays bit-identical to JAX
    ``generate``; each rank's pool holds its 2 of the 4 kv heads."""
    got = world["out"]["paged"]
    for out, want in zip(got["tokens"], world["jax"]["shared"]):
        np.testing.assert_array_equal(out, want)
    assert got["stats"]["kv_prefix_hits"] >= 2, got["stats"]
    assert got["pool_heads"] == 2


@pytest.mark.parametrize("name", ["mha", "mqa"])
def test_tp_paged_matches_unpaged(world, name):
    """``tests/test_serving_fastpath.py:92``: one workload through a tp-2
    paged and a tp-2 unpaged engine, byte-identical and equal to JAX
    ``generate`` (MQA: a whole pool on each rank)."""
    runs = world["out"][f"paged_vs_unpaged_{name}"]
    for a, b, want in zip(runs["paged"], runs["unpaged"], world["jax"]["mixed"][name]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want)


@pytest.mark.parametrize("route", ["tp2_to_tp2", "tp2_to_tp1", "tp1_to_tp2"])
@pytest.mark.parametrize("name", ["mha", "mqa"])
def test_tp_session_migration_warm_and_bit_exact(world, name, route):
    """``tests/test_serving_fastpath.py:59`` across meshes: commit, drain,
    export on one engine, import into another; the next turn resumes from
    the whole chain (one hit, its tokens skipped) with JAX ``generate``'s
    tokens on both turns."""
    got, want = world["out"][f"migrate_{name}"], world["jax"]["migrate"][name]
    np.testing.assert_array_equal(got["out1"], want["out1"])
    np.testing.assert_array_equal(got["one_out1"], got["out1"])
    np.testing.assert_array_equal(got["p2"], want["p2"])
    run = got[route]
    exported = got["one_exported" if route == "tp1_to_tp2" else "exported"]
    tokens = exported[0][1]
    assert run["blocks"] > 0
    np.testing.assert_array_equal(run["out2"], want["out2"])
    assert run["stats"]["kv_prefix_hits"] == 1, run["stats"]
    assert run["stats"]["kv_prefill_tokens_skipped"] == len(tokens), run["stats"]


@pytest.mark.parametrize("name", ["mha", "mqa"])
def test_tp_export_blob_does_not_depend_on_the_mesh(world, name):
    """A tp-2 engine's export gathers every rank's heads: its meta, tokens
    and byte length equal one process's export of the same session, and
    its values agree within f32 rounding."""
    got = world["out"][f"migrate_{name}"]
    (s, tokens, meta, blob), = got["exported"]
    (s1, tokens1, meta1, blob1), = got["one_exported"]
    assert (s, tokens, meta) == (s1, tokens1, meta1)
    assert meta["layout"]["layer_0"][0] == ttf.TransformerConfig(**CFGS[name]).kv_heads
    assert len(blob) == len(blob1)
    np.testing.assert_allclose(np.frombuffer(blob, np.float32), np.frombuffer(blob1, np.float32),
                               atol=BLOB_ATOL)


def test_tp_spec_decoding_with_the_draft_on_rank0(world):
    """A self-draft on the tp group: every draft accepted and the tokens
    JAX ``generate``'s."""
    got = world["out"]["spec"]
    for out, want in zip(got["tokens"], world["jax"]["engine"]["mha"]):
        np.testing.assert_array_equal(out, want)
    assert got["stats"]["spec_accept_rate"] == 1.0 and got["stats"]["spec_rounds"] > 0


def test_tp_teacher_matches_jax_jit_teacher(world):
    """``tests/test_serving_engine.py:133``: ``module_teacher(mesh=,
    logical_rules=)`` on a tp-2 group against ``jit_teacher(mesh=)`` on
    JAX's tp-2 mesh, within ``TEACHER_ATOL``; the LM was cut to 2 heads a
    rank."""
    got = world["out"]["teacher"]
    for a, b in zip(got["logits"], world["jax"]["teacher"]):
        assert a.shape == b.shape == (2, 8, 64)
        np.testing.assert_allclose(a, b, atol=TEACHER_ATOL)
    assert got["qkv_rows"] == 2 * 3 * 8


def test_tp_teacher_module_without_a_tp_form_runs_whole(world):
    """A module with no tensor-parallel form (no ``set_tp``) runs whole on
    rank 0 of the group, as JAX replicates variables with no logical axes."""
    np.testing.assert_allclose(world["out"]["teacher"]["linear"],
                               np.full((2, 3), [3.3, 9.7, 16.1], np.float32), rtol=1e-6)


def test_tp_generate_every_rank_feeds_the_leaders_tokens(world):
    """``generate`` on a tp model: greedy equals JAX ``generate``'s; sampled,
    each rank with its own generator, every rank returns the leader's
    draws, which equal one process's draws from the leader's seed (the
    two packages' generators differ)."""
    got, model = world["out"]["generate"], world["models"]["gqa"]
    r0, r1 = got["ranks"]
    prompt = torch.from_numpy(got["prompt"])
    np.testing.assert_array_equal(r0["greedy"], world["jax"]["generate"])
    np.testing.assert_array_equal(r0["greedy"], r1["greedy"])
    np.testing.assert_array_equal(r0["sampled"], r1["sampled"])
    want = generate(model, prompt, 6, generator=torch.Generator().manual_seed(1),
                    temperature=0.8, top_k=20)
    np.testing.assert_array_equal(r0["sampled"], want)


def test_tp_serve_lm_batch_path(world):
    """serve_lm's batch-at-a-time path on the tp group
    (``build_predict_fn(mesh=)`` with ``follow_generate``): JAX
    ``generate``'s tokens."""
    for out, want in zip(world["out"]["generate"]["ranks"][0]["batch"], world["jax"]["batch"]):
        np.testing.assert_array_equal(out, want)


def test_tp_replica_behind_the_gateway(world):
    """A ReplicaServer over a tp-2 engine behind the Gateway: one replica in
    the fleet, every request answered over the wire with JAX
    ``generate``'s tokens."""
    got = world["out"]["replica"]
    assert got["replicas"] == ["tp"]
    for out, want in zip(got["tokens"], world["jax"]["engine"]["mha"]):
        np.testing.assert_array_equal(out, want)


def test_tp_checkpoint_restores_each_ranks_part(world):
    """serve_lm's ``--checkpoint_dir`` at tp 2: each rank restores its part
    of a one-process checkpoint (of the JAX init's weights), and the tokens
    are JAX ``generate``'s on those weights."""
    got = world["out"]["checkpoint"]
    assert got["qkv_rows"] == 2 * 16 + 2 * 16
    np.testing.assert_array_equal(got["tokens"], world["jax"]["checkpoint"])


# -- liveness -----------------------------------------------------------------------

def test_follower_exits_when_its_leader_is_killed(tmp_path):
    """Rank 0 serves a request, then SIGKILLs itself: the follower leaves
    ``follow`` with ``FollowerExit`` (exit code 3) within the channel's
    timeout, instead of waiting in a collective."""
    _write_inputs(tmp_path, [("mha", 0)])
    t0 = time.monotonic()
    procs, logs = spawn_world(tmp_path, "killed")
    wait_world(tmp_path, procs, logs, codes=(-signal.SIGKILL, 3))
    assert (tmp_path / "ready").exists()
    assert "leader is gone" in (tmp_path / "follower_exit").read_text()
    assert time.monotonic() - t0 < WORKER_TIMEOUT


def _children(pid):
    try:
        text = pathlib.Path(f"/proc/{pid}/task/{pid}/children").read_text()
    except OSError:
        return []
    return [int(c) for c in text.split()]


def _alive(pid):
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def test_serve_lm_tp2_over_the_wire_and_no_orphan(tmp_path):
    """``python -m edl_tpu_torch.serve_lm --tp 2 --device cpu --continuous
    2``: rank 0 spawns its follower, answers over the wire with JAX
    ``generate``'s tokens on the entry point's seeded weights (and one
    process's); SIGKILLed, its follower dies with it."""
    from edl_tpu_torch.serve_lm import request

    log = tmp_path / "serve.log"
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    argv = ["--device", "cpu", "--vocab", "97", "--layers", "2", "--embed", "64", "--heads",
            "4", "--kv_heads", "2", "--mlp", "128", "--max_len", "64", "--max_new_tokens", "5",
            "--temperature", "0", "--continuous", "2", "--tp", "2"]
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "edl_tpu_torch.serve_lm", *argv],
                                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    followers = []
    try:
        deadline = time.monotonic() + WORKER_TIMEOUT
        while "serving on" not in log.read_text():
            assert proc.poll() is None and time.monotonic() < deadline, log.read_text()
            time.sleep(0.1)
        endpoint = log.read_text().split("serving on ")[1].split()[0]
        followers = _children(proc.pid)
        assert len(followers) == 1, followers
        prompts = [np.asarray([5, 9, 2, 7], np.int32), np.asarray([3, 1, 4], np.int32)]
        outs = [request(endpoint, p[None], timeout=60)[0] for p in prompts]
        model = ttf.TransformerLM(ttf.TransformerConfig(dtype=torch.float32, remat=False,
                                                        **CFGS["gqa"]),
                                  torch.Generator().manual_seed(0))
        for p, out in zip(prompts, outs):
            np.testing.assert_array_equal(out, _want_jax_of(model, p, 5))
            np.testing.assert_array_equal(out, _want(model, p, 5))
        proc.kill()
        proc.wait()
        deadline = time.monotonic() + 30
        while any(_alive(c) for c in followers):
            assert time.monotonic() < deadline, "a follower outlived its server"
            time.sleep(0.1)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for c in followers:
            if _alive(c):
                os.kill(c, signal.SIGKILL)


# -- slow -------------------------------------------------------------------------

@pytest.mark.slow
def test_tp_chunk_spec_paged_combined_parity(tmp_path):
    """``tests/test_serving_fastpath.py:271``: the tp group, the paged pool,
    chunked prefill and a self-draft at once, over shared-prefix traffic
    with a long admission: JAX ``generate``'s tokens, chunks counted,
    drafts accepted, a prefix reused."""
    params, _ = _write_inputs(tmp_path, [("mha", 0)])
    procs, logs = spawn_world(tmp_path, "combined")
    data = _inputs()
    try:
        want = [_want_jax("mha", params["mha"], p, 8) for p in data["combined"]]
    finally:
        wait_world(tmp_path, procs, logs)
    got = torch.load(tmp_path / "out.pt", weights_only=False)["combined"]
    for a, b in zip(got["tokens"], want):
        np.testing.assert_array_equal(a, b)
    stats = got["stats"]
    assert stats["kv_prefix_hits"] >= 1, stats
    assert stats["prefill_chunks"] >= 2, stats
    assert stats["spec_accept_rate"] > 0.9, stats


@pytest.mark.slow
def test_replica_cli_tp2_behind_the_gateway(coord_server, tmp_path):
    """``python -m edl_tpu_torch.serving.replica --tp 2 --device cpu`` on the
    JAX coordination server: one replica in the gateway's fleet, requests
    answered with JAX ``generate``'s tokens on the replica's seeded weights; SIGTERM drains it, and both processes
    exit."""
    from edl_tpu_torch.coord.client import CoordClient
    from edl_tpu_torch.gateway import Gateway, GatewayConfig
    from edl_tpu_torch.serving.replica import _seeded_model

    ep = f"127.0.0.1:{coord_server.port}"
    log = tmp_path / "replica.log"
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_TPU_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "edl_tpu_torch.serving.replica", "--coord_endpoints", ep,
             "--job_id", "J", "--replica_id", "r0", "--host", "127.0.0.1", "--device", "cpu",
             "--heads", "4", "--embed", "32", "--tp", "2", "--ttl", "3"],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    store = CoordClient(ep)
    gw = Gateway(store, "J", GatewayConfig(request_timeout_s=60.0, wait_slice_s=0.05,
                                           poll_period_s=0.05))
    followers = []
    try:
        assert gw.wait_for_replicas(1, WORKER_TIMEOUT), log.read_text()
        followers = _children(proc.pid)
        assert sorted(gw.stats()["replicas"]) == ["r0"]
        model = _seeded_model(53, 1, 32, 4, 64, 64, 0, torch.device("cpu"))
        for p in ([3, 1, 4], [5, 9, 2, 6, 5]):
            out = gw.submit(np.asarray(p, np.int32), 6).result(60)
            np.testing.assert_array_equal(out, _want_jax_of(model, p, 6))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
        deadline = time.monotonic() + 30
        while any(_alive(c) for c in followers):
            assert time.monotonic() < deadline, "a follower outlived its replica"
            time.sleep(0.1)
    finally:
        gw.close()
        store.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
