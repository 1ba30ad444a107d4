"""One rank of a 2-rank gloo world on the CPU running the tensor-parallel
serving cases of ``tests/test_torch_serving_tp.py``; rank 0 leads every tp
group (engines, teachers, a replica), rank 1 follows:

    python tests/helpers/torch_serving_tp_worker.py <io_dir> <case>[,<case>...]
        # env: RANK, WORLD_SIZE (2), MASTER_ADDR, MASTER_PORT
        # io_dir/in.pt: {"weights": {name: state dict}, "cfgs": {name: config
        #   kwargs}, the cases' prompts, "ckpt": a one-process checkpoint's
        #   directory}; rank 0 writes io_dir/out.pt

Cases: ``engine`` (MHA, GQA, MQA, 6 heads over 3 kv heads), ``paged``, ``paged_vs_unpaged``,
``migrate`` (tp 2 -> tp 2, tp 2 -> tp 1, tp 1 -> tp 2), ``spec``,
``combined`` (chunked prefill + speculation + the paged pool), ``teacher``,
``generate`` (generate and serve_lm's batch path on a tp model),
``replica`` (a ReplicaServer over a tp engine behind a Gateway),
``checkpoint`` (serve_lm's restore of each rank's part), ``killed`` (rank 0
SIGKILLs itself once its engine is up).
"""

import os
import signal
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.generate import generate, shard_decode_model
from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from edl_tpu_torch.serving import ContinuousBatcher


def _model(data, name):
    model = ttf.TransformerLM(ttf.TransformerConfig(dtype=torch.float32, remat=False,
                                                    **data["cfgs"][name]), init=False)
    model.load_state_dict(data["weights"][name])
    return model.requires_grad_(False).eval()


def _engine_kw(**kw):
    kw.setdefault("slots", 3)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("temperature", 0.0)
    kw.setdefault("steps_per_sync", 4)
    return kw


def _serve(rank, mesh, model, fn, **kw):
    """Rank 0: ``fn(engine)`` over a tp engine, then stop it; rank 1: follow."""
    if rank == 0:
        eng = ContinuousBatcher(model, mesh=mesh, **_engine_kw(**kw))
        try:
            return fn(eng)
        finally:
            eng.stop()
    ContinuousBatcher.follow(model, mesh=mesh)
    return None


def _run(eng, prompts, news, session=None):
    return [eng.submit(p, n, session=session).result(120) for p, n in zip(prompts, news)]


def case_engine(rank, mesh, data, out):
    """``tests/test_serving_engine.py:106`` at MHA, GQA, MQA and 6 heads
    over 3 kv heads: every request in flight at once; and the per-rank
    cache and weight shapes."""
    for name in ("mha", "gqa", "mqa", "gqa3"):
        model = _model(data, name)

        def fn(eng):
            futs = [eng.submit(p, n) for p, n in zip(data["prompts"], data["news"])]
            got = [f.result(120) for f in futs]
            return {"tokens": got, "cache_heads": eng._cache.keys[0].shape[1],
                    "qkv_rows": eng._model.layers[0].attn_qkv.weight.shape[0],
                    "mlp_rows": eng._model.layers[0].mlp_in.weight.shape[0]}

        got = _serve(rank, mesh, model, fn)
        if rank == 0:
            out[f"engine_{name}"] = got


def case_paged(rank, mesh, data, out):
    """``tests/test_serving_kv.py:248``: shared-prefix traffic on a tp paged
    engine hits the trie."""
    model = _model(data, "mha")

    def fn(eng):
        toks = _run(eng, data["shared"], [5] * len(data["shared"]))
        return {"tokens": toks, "stats": eng.stats(), "pool_heads": eng._kv.k[0].shape[1]}

    got = _serve(rank, mesh, model, fn, slots=2, kv_block=4, kv_pool_blocks=64)
    if rank == 0:
        out["paged"] = got


def case_paged_vs_unpaged(rank, mesh, data, out):
    """``tests/test_serving_fastpath.py:92`` on MHA and MQA (a whole pool)."""
    for name in ("mha", "mqa"):
        model = _model(data, name)
        runs = {}
        for label, kv_block in (("paged", 4), ("unpaged", 0)):
            runs[label] = _serve(rank, mesh, model,
                                 lambda eng: _run(eng, data["mixed"], data["mixed_news"]),
                                 slots=2, prefill_buckets=(16,), steps_per_sync=2,
                                 kv_block=kv_block, kv_pool_blocks=64)
        if rank == 0:
            out[f"paged_vs_unpaged_{name}"] = runs


def _turn1(eng, p1):
    out1 = eng.submit(p1, 8, session="s").result(120)
    assert eng.drain(timeout=30)
    exported = eng.export_sessions()
    return out1, exported


def _turn2(eng, exported, p2):
    _, tokens, meta, blob = exported[0]
    blocks = eng.import_session("s", tokens, meta, blob)
    out2 = eng.generate(p2, 6, timeout=120)
    return {"blocks": blocks, "out2": out2, "stats": eng.stats()}


def case_migrate(rank, mesh, data, out):
    """``tests/test_serving_fastpath.py:59`` across meshes: a session
    exported from a tp-2 engine resumes in a tp-2 and in a one-process
    engine, and one exported from a one-process engine in a tp-2 engine."""
    p1 = np.asarray(data["p1"], np.int32)
    kw = dict(slots=2, steps_per_sync=2, kv_block=4, kv_pool_blocks=64)
    for name in ("mha", "mqa"):
        model = _model(data, name)
        first = _serve(rank, mesh, model, lambda eng: _turn1(eng, p1), **kw)
        if rank == 0:
            out1, exported = first
            conv = np.concatenate([p1, out1])
            p2 = np.concatenate([conv, np.asarray([4, 1], np.int32)])
            plain = ContinuousBatcher(model, **_engine_kw(**kw))
            try:
                one = _turn1(plain, p1)
            finally:
                plain.stop()
        else:
            exported = one = p2 = None
        tp_tp = _serve(rank, mesh, model, lambda eng: _turn2(eng, exported, p2), **kw)
        tp_one_to_tp = _serve(rank, mesh, model, lambda eng: _turn2(eng, one[1], p2), **kw)
        if rank == 0:
            plain = ContinuousBatcher(model, **_engine_kw(**kw))
            try:
                tp_to_one = _turn2(plain, exported, p2)
            finally:
                plain.stop()
            out[f"migrate_{name}"] = {"out1": out1, "one_out1": one[0], "p2": p2,
                                      "exported": exported, "one_exported": one[1],
                                      "tp2_to_tp2": tp_tp, "tp2_to_tp1": tp_to_one,
                                      "tp1_to_tp2": tp_one_to_tp}


def case_spec(rank, mesh, data, out):
    """Speculative decoding on the tp group with a self-draft, which runs
    whole on rank 0: every draft accepted, tokens those of plain decode."""
    model = _model(data, "mha")
    got = _serve(rank, mesh, model,
                 lambda eng: (_run(eng, data["prompts"], data["news"]), eng.stats()),
                 spec_k=2, draft_model=_model(data, "mha"), steps_per_sync=6)
    if rank == 0:
        out["spec"] = {"tokens": got[0], "stats": got[1]}


def case_combined(rank, mesh, data, out):
    """``tests/test_serving_fastpath.py:271``: the tp group, the paged pool,
    chunked prefill and a self-draft at once over shared-prefix traffic
    with a long admission."""
    model = _model(data, "mha")
    got = _serve(rank, mesh, model,
                 lambda eng: ([eng.generate(p, 8, timeout=180) for p in data["combined"]],
                              eng.stats()),
                 slots=2, steps_per_sync=2, kv_block=4, kv_pool_blocks=64, prefill_chunk=16,
                 spec_k=2, draft_model=_model(data, "mha"))
    if rank == 0:
        out["combined"] = {"tokens": got[0], "stats": got[1]}


def case_teacher(rank, mesh, data, out):
    """``module_teacher(mesh=)``: the LM cut over tp against its whole
    forward, and a module without a tp form computed whole by rank 0."""
    from edl_tpu_torch.distill.teacher import follow_teacher, module_teacher

    lm = ttf.TransformerLM(ttf.TransformerConfig(dtype=torch.float32, remat=False,
                                                 attention_impl="dense",
                                                 **data["cfgs"]["teacher"]), init=False)
    lm.load_state_dict(data["weights"]["teacher"])
    linear = torch.nn.Linear(8, 3)
    with torch.no_grad():
        linear.weight.copy_(torch.arange(24, dtype=torch.float32).reshape(3, 8) / 10)
        linear.bias.fill_(0.5)
    if rank == 0:
        predict = module_teacher(lm, mesh=mesh, logical_rules=ttf.LOGICAL_RULES)
        try:
            got = [predict({"ids": ids})["logits"] for ids in data["teacher_ids"]]
            qkv = tuple(lm.layers[0].attn_qkv.weight.shape)
        finally:
            predict.close()
        predict = module_teacher(linear, mesh=mesh)
        try:
            lin = predict({"x": np.ones((2, 8), np.float32)})["logits"]
        finally:
            predict.close()
        out["teacher"] = {"logits": got, "qkv_rows": qkv[0], "linear": lin}
    else:
        follow_teacher(lm, mesh=mesh, logical_rules=ttf.LOGICAL_RULES)
        follow_teacher(linear, mesh=mesh)


def case_generate(rank, mesh, data, out):
    """``generate`` on a tp model (every rank the same tokens: the leader
    samples and broadcasts), greedy and sampled; and serve_lm's batch path
    (``build_predict_fn(mesh=)`` / ``follow_generate``)."""
    from edl_tpu_torch import serve_lm

    model = _model(data, "gqa")
    dm = shard_decode_model(model, mesh)
    prompt = torch.from_numpy(np.stack([data["prompts"][0][:3], data["prompts"][1][:3]]))
    greedy = generate(dm, prompt, 6, temperature=0)
    gen = torch.Generator().manual_seed(rank + 1)        # the leader's draws count
    sampled = generate(dm, prompt, 6, generator=gen, temperature=0.8, top_k=20)
    res = {"greedy": greedy.numpy(), "sampled": sampled.numpy()}
    if rank == 0:
        predict = serve_lm.build_predict_fn(model, 5, 0.0, 0, mesh=mesh)
        try:
            res["batch"] = [predict({"ids": p[None]})["tokens"][0] for p in data["prompts"][:2]]
        finally:
            predict.close()
    else:
        serve_lm.follow_generate(model, 5, 0.0, 0, mesh=mesh)
    both = [None, None]
    dist.all_gather_object(both, res)
    if rank == 0:
        out["generate"] = {"ranks": both, "prompt": prompt.numpy()}


def case_replica(rank, mesh, data, out):
    """A ReplicaServer over a tp engine (rank 0) behind the Gateway, over the
    RPC wire, on a ``MemoryKV``; the gateway sees one replica."""
    from edl_tpu_torch.coord.memory import MemoryKV
    from edl_tpu_torch.gateway import Gateway, GatewayConfig
    from edl_tpu_torch.serving import ReplicaServer

    model = _model(data, "mha")

    def fn(eng):
        store = MemoryKV(sweep_period=0.1)
        srv = ReplicaServer(store, "job", eng, replica_id="tp", host="127.0.0.1", ttl=5,
                            advert_period=0.2)
        gw = Gateway(store, "job", GatewayConfig(max_inflight=4, max_queue=8,
                                                 request_timeout_s=60.0, wait_slice_s=0.05,
                                                 poll_period_s=0.05))
        try:
            assert gw.wait_for_replicas(1, 10)
            futs = [gw.submit(p, n) for p, n in zip(data["prompts"], data["news"])]
            toks = [f.result(120) for f in futs]
            replicas = sorted(gw.stats()["replicas"])
        finally:
            gw.close()
            srv.close()
            store.close()
        return {"tokens": toks, "replicas": replicas}

    got = _serve(rank, mesh, model, fn, slots=2)
    if rank == 0:
        out["replica"] = got


def case_checkpoint(rank, mesh, data, out):
    """serve_lm's ``--checkpoint_dir`` on a tp group: each rank restores its
    part of a one-process checkpoint into its cut of the decode model."""
    from edl_tpu_torch import serve_lm

    cfg = data["cfgs"]["gqa"]
    args = serve_lm.parse_args(["--device", "cpu", "--vocab", str(cfg["vocab_size"]),
                                "--layers", str(cfg["num_layers"]),
                                "--embed", str(cfg["embed_dim"]),
                                "--heads", str(cfg["num_heads"]),
                                "--kv_heads", str(cfg["num_kv_heads"]),
                                "--mlp", str(cfg["mlp_dim"]),
                                "--max_len", str(cfg["max_len"]),
                                "--checkpoint_dir", data["ckpt"]])
    model = serve_lm.build_model(args, torch.device("cpu"), mesh)
    prompt = torch.from_numpy(data["prompts"][2][None])
    toks = generate(model, prompt, 6, temperature=0)
    if rank == 0:
        out["checkpoint"] = {"tokens": toks.numpy()[0], "qkv_rows":
                             model.layers[0].attn_qkv.weight.shape[0]}


def case_killed(rank, mesh, data, out):
    """Rank 0 builds a tp engine, serves one request, then SIGKILLs itself;
    rank 1 must leave ``follow`` with ``FollowerExit``."""
    from edl_tpu_torch.serving.spmd import FollowerExit

    model = _model(data, "mha")
    if rank == 0:
        eng = ContinuousBatcher(model, mesh=mesh, **_engine_kw())
        eng.generate(data["prompts"][0], 3, timeout=60)
        open(os.path.join(data["dir"], "ready"), "w").close()
        os.kill(os.getpid(), signal.SIGKILL)
    try:
        ContinuousBatcher.follow(model, mesh=mesh)
    except FollowerExit as e:
        with open(os.path.join(data["dir"], "follower_exit"), "w") as f:
            f.write(str(e))
        os._exit(3)


CASES = {f.__name__[5:]: f for f in (case_engine, case_paged, case_paged_vs_unpaged,
                                      case_migrate, case_spec, case_combined, case_teacher,
                                      case_generate, case_replica, case_checkpoint,
                                      case_killed)}


def main(io_dir, cases):
    from edl_tpu_torch.serving.spmd import die_with_parent

    die_with_parent()           # no rank outlives the test that spawned it
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=2, timeout=timedelta(seconds=60))
    mesh = build_mesh(MeshSpec(dp=-1, tp=2), pods=[0, 0], device_type="cpu")
    data = torch.load(os.path.join(io_dir, "in.pt"), weights_only=False)
    data["dir"] = io_dir
    out = {}
    for case in cases.split(","):
        CASES[case](rank, mesh, data, out)
    if rank == 0:
        torch.save(out, os.path.join(io_dir, "out.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
