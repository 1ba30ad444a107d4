"""The port's mixture of experts (``edl_tpu_torch/ops/moe.py`` and the MoE
``TransformerLM``) on the CPU against the JAX package, on the same
numpy-seeded inputs and, through ``models/convert.py``, the same weights.
It mirrors the ten cases of ``tests/test_moe.py`` and the MoE cases of
``tests/test_generate.py`` and ``tests/test_serving_engine.py``:

- routing against ``compute_routing``: dispatch and drops exactly, combine
  and aux within 1e-6, with and without ``valid``, and with equal
  probabilities, where ``jax.lax.top_k`` takes the lower index first;
- ``MoEMLP``'s output, aux and gradients in f32 within 1e-5; the decode
  gather at top_k 10 of 12; one expert equal to the plain FFN;
- the MoE LM's logits, aux and gradients (with and without remat), its
  token mask, and its bf16 dtype flow;
- ``generate`` greedy tokens and ``return_drops``, starved (0.05) against
  ample (4.0); the engine's tokens against JAX ``generate`` and the JAX
  engine; ``moe_prefill_drops`` equal to the JAX engine's; the paged pool
  and speculative decoding with an MoE model; ``serve_lm --moe``'s stats;
- the CLI exits of ``train_lm`` and ``serve_lm`` against the JAX example's
  messages.

The multi-rank cases (ep, ep x tp, the tp engine) are in
``tests/test_torch_moe_mesh.py``.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import transformer as jtf
from edl_tpu.models.generate import generate as jax_generate
from edl_tpu.ops.moe import MoEMLP as JaxMoE
from edl_tpu.ops.moe import compute_routing as jax_routing
from edl_tpu.serving import ContinuousBatcher as JaxBatcher
from edl_tpu_torch import serve_lm, train_lm
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax, params_to_jax
from edl_tpu_torch.models.generate import generate
from edl_tpu_torch.ops.moe import MoEMLP, compute_routing
from edl_tpu_torch.serving import ContinuousBatcher

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX tests' MoE sizes (tests/test_moe.py:_moe_cfg)
MOE = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=4, mlp_dim=64, max_len=64,
           moe_experts=4, moe_top_k=2)
F32_TOL = 1e-5


def _jax_greedy(jc, params, prompt, n, return_drops=False):
    """JAX ``generate`` under jit (greedy), as its docstring asks."""
    fn = jax.jit(lambda p, x: jax_generate(jc, p, x, n, temperature=0.0,
                                           return_drops=return_drops))
    return fn(params, jnp.asarray(prompt))


def _probs(B=2, S=8, E=4, seed=0):
    logits = np.random.default_rng(seed).normal(size=(B, S, E)).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _ties(B=2, S=12, E=4):
    """Probabilities with equal entries: rows all equal, and rows whose two
    largest are equal."""
    p = np.full((B, S, E), 1.0 / E, np.float32)
    p[:, ::3] = np.asarray([0.3, 0.1, 0.3, 0.3], np.float32)
    p[:, 1::3] = np.asarray([0.1, 0.4, 0.1, 0.4], np.float32)
    return p


# name -> (probs, top_k, capacity, valid): the cases of tests/test_moe.py
ROUTING = {
    "ample": (_probs(), 2, 16, None),
    "over_capacity": (_probs(S=16), 2, 2, None),
    "position_bound": (_probs(B=1, S=32, E=2, seed=3), 1, 5, None),
    "pad_tokens": (_probs(B=1, S=12, E=4, seed=7), 2, 3, np.arange(12)[None, :] < 8),
    "drop_count": (np.full((1, 6, 1), 1.0, np.float32), 1, 2, None),
    "ties": (_ties(), 2, 5, None),
    "ties_valid": (_ties(), 2, 3, np.arange(12)[None, :] % 5 != 2),
}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_routing_matches_jax(case):
    """dispatch, combine, aux and drops against ``compute_routing`` on the
    same probabilities; dispatch and drops exactly."""
    probs, k, cap, valid = ROUTING[case]
    route = jax.jit(jax_routing, static_argnums=(1, 2))
    want = route(jnp.asarray(probs), k, cap, None if valid is None else jnp.asarray(valid))
    got = compute_routing(torch.tensor(probs), k, cap,
                          valid=None if valid is None else torch.tensor(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-6, rtol=1e-6)
    assert got[3].dtype == torch.int32 and int(got[3]) == int(want[3])
    B, S, _ = probs.shape
    assert float(got[0].max()) <= 1.0                        # one token per cell
    assert float(got[1].sum(dim=(2, 3)).max()) <= 1.0 + 1e-5
    if case == "ample":
        assert float(got[0].sum()) == B * S * k and int(got[3]) == 0
    if case == "drop_count":
        assert int(got[3]) == 4
    if valid is not None:
        pads = torch.from_numpy(~valid)[:, :, None, None].float()
        assert float((got[0] * pads).sum()) == 0.0 and float((got[1] * pads).sum()) == 0.0


def _mlp_pair(E, H, K, cf, M, decode=False, seed=0):
    jm = JaxMoE(num_experts=E, mlp_dim=H, top_k=K, capacity_factor=cf, dtype=jnp.float32,
                decode=decode)
    x = np.random.default_rng(seed + 1).normal(size=(2, 8 if not decode else 1, M)
                                               ).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(x))["params"]
    tm = MoEMLP(M, E, H, K, cf, torch.float32, decode)
    for name in ("gate", "w_in", "w_out"):
        getattr(tm, name).data = torch.from_numpy(np.array(params[name]))
    return jm, params, tm, x


def test_moe_mlp_forward_and_grad():
    """Output, aux and the gradients of ``mean(y^2) + 0.01 aux`` against
    flax on the same weights (f32 within 1e-5), every weight reached."""
    jm, params, tm, x = _mlp_pair(4, 16, 2, 1.25, 12)

    def loss(p, xx):
        y, aux = jm.apply({"params": p}, xx)
        return (y ** 2).mean() + 0.01 * aux, (y, aux)

    (jl, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                             has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux, drops = tm(xt)
    ((y ** 2).mean() + 0.01 * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=F32_TOL, rtol=0)
    assert drops.dtype == torch.int32
    for name in ("gate", "w_in", "w_out"):
        g = getattr(tm, name).grad
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]), atol=F32_TOL, rtol=0)
        assert float(g.abs().max()) > 0, name
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=F32_TOL, rtol=0)


def test_single_expert_equals_plain_ffn():
    """E=1, K=1, ample capacity: the port's MoE is ``silu(x w_in) w_out``."""
    jm, params, tm, x = _mlp_pair(1, 16, 1, 2.0, 8, seed=1)
    y, _, drops = tm(torch.from_numpy(x))
    want = torch.nn.functional.silu(torch.from_numpy(x) @ tm.w_in[0]) @ tm.w_out[0]
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-4)
    assert int(drops) == 0
    jy, _ = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=F32_TOL, rtol=0)


def test_decode_gather_any_top_k():
    """The drop-free decode gather at top_k 10 of 12 equals flax's gather
    and the capacity path with ample capacity."""
    jm, params, tm, x = _mlp_pair(12, 32, 10, 100.0, 16, decode=True, seed=2)
    with torch.no_grad():
        y, aux, drops = tm(torch.from_numpy(x))
    jy, _ = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL, rtol=0)
    assert float(aux) == 0.0 and int(drops) == 0
    tm.decode = False
    with torch.no_grad():
        y_cap, _, _ = tm(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_cap.numpy(), atol=F32_TOL, rtol=0)


def _lm_pair(seed=0, **kw):
    cfg = {**MOE, **kw}
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, attention_impl="dense", **cfg)
    params = jax.jit(jtf.TransformerLM(jc).init)(jax.random.key(seed),
                                                jnp.zeros((1, 4), jnp.int32))["params"]
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, attention_impl="dense", **cfg)
    tm = ttf.TransformerLM(tc, init=False)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
    return jc, params, tm


@pytest.fixture(scope="module")
def lm_grads():
    """The MoE LM's logits, aux and the gradients of ``mean(logits^2) +
    aux`` under flax, on seed-0 weights and seeded ids."""
    jc, params, _ = _lm_pair()
    ids = np.random.default_rng(4).integers(0, 64, (2, 16)).astype(np.int32)
    jm = jtf.TransformerLM(jc)

    def loss(p):
        logits, aux = jm.apply({"params": p}, jnp.asarray(ids), with_aux=True)
        return (logits ** 2).mean() + aux, (logits, aux)

    (_, (jl, jaux)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return params, ids, jl, jaux, jg


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_moe_lm_logits_aux_and_grads_match_jax(remat, lm_grads):
    """The MoE LM's logits, aux (the mean over layers) and the gradients of
    ``mean(logits^2) + aux`` against flax, f32 within 1e-5; with remat the
    backward recomputes each layer to the same routing."""
    params, ids, jl, jaux, jg = lm_grads
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=remat, attention_impl="dense", **MOE)
    tm = ttf.TransformerLM(tc, init=False)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
    logits, aux = tm(torch.from_numpy(ids), with_aux=True)
    ((logits ** 2).mean() + aux).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=F32_TOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, jg), tm.cfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=F32_TOL, rtol=0,
                                   err_msg=name)
    assert {n for n, _ in tm.named_parameters() if ".moe." in n} == {
        f"layers.{i}.moe.{p}" for i in range(2) for p in ("gate", "w_in", "w_out")}
    sd = {n: p.detach() for n, p in tm.named_parameters()}
    back = params_to_jax(sd, tm.cfg)
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b),
                                     params, back))
    split = params_to_jax(sd, tm.cfg, stacked=False)      # the decode params' layout
    assert set(split["layer_1"]["moe"]) == {"gate", "w_in", "w_out"}
    again = params_from_jax(split, tm.cfg)
    assert all(torch.equal(again[n], t) for n, t in sd.items())


def test_moe_lm_token_mask_and_fused_nll():
    """``token_mask`` leaves pad tokens out of routing as flax's does (the
    real rows' logits, and the aux, equal); the ``targets=`` path returns
    the fused NLL beside the aux."""
    jc, params, tm = _lm_pair(moe_capacity=0.5)
    ids = np.random.default_rng(5).integers(0, 64, (2, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < np.asarray([[11], [16]])
    jl, jaux = jax.jit(lambda p, i, m: jtf.TransformerLM(jc).apply(
        {"params": p}, i, with_aux=True, token_mask=m))(params, jnp.asarray(ids),
                                                         jnp.asarray(mask))
    with torch.no_grad():
        logits, aux = tm(torch.from_numpy(ids), with_aux=True, token_mask=torch.from_numpy(mask))
        nll, aux2 = tm(torch.from_numpy(ids[:, :-1]), targets=torch.from_numpy(ids[:, 1:]),
                       with_aux=True, ce_block=16)
        h, aux3 = tm(torch.from_numpy(ids[:, :-1]), return_hidden=True, with_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=F32_TOL, rtol=0)
    torch.testing.assert_close(nll, tm.fused_nll(h, torch.from_numpy(ids[:, 1:]), 16))
    assert float(aux2) == float(aux3)


def test_moe_lm_bf16_dtype_flow():
    """bf16 compute over f32 weights: the MoE output is bf16 (the residual
    stays bf16), the router reads f32, the logits are f32 and close to
    flax's bf16 logits."""
    cfg = dict(MOE, moe_capacity=4.0)
    jc = jtf.TransformerConfig(dtype=jnp.bfloat16, remat=False, attention_impl="dense", **cfg)
    params = jax.jit(jtf.TransformerLM(jc).init)(jax.random.key(0),
                                                jnp.zeros((1, 4), jnp.int32))["params"]
    tc = ttf.TransformerConfig(dtype=torch.bfloat16, remat=False, attention_impl="dense", **cfg)
    tm = ttf.TransformerLM(tc, init=False)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
    ids = np.random.default_rng(6).integers(0, 64, (2, 16)).astype(np.int32)
    emb = tm._embed(torch.from_numpy(ids).long())
    pos = torch.arange(16).expand(2, 16)
    with torch.no_grad():
        out, aux, _ = tm.layers[0](emb, pos)
        y, _, _ = tm.layers[0].moe(tm.layers[0].mlp_norm(emb))
        logits = tm(torch.from_numpy(ids))
    assert out.dtype == torch.bfloat16 and y.dtype == torch.bfloat16
    assert aux.dtype == torch.float32 and tm.layers[0].moe.gate.dtype == torch.float32
    jl = jax.jit(jtf.TransformerLM(jc).apply)({"params": params}, jnp.asarray(ids))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl, np.float32), atol=5e-2, rtol=0)


@pytest.mark.parametrize("capacity", [0.05, 4.0], ids=["starved", "ample"])
def test_generate_greedy_and_drops_match_jax(capacity):
    """Greedy tokens and the prefill's drop count equal JAX ``generate``'s
    (``return_drops``): starved capacity drops, ample drops nothing."""
    jc, params, tm = _lm_pair(moe_capacity=capacity, max_len=32)
    prompt = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(np.int32)
    want, jdrops = _jax_greedy(jc, params, prompt, 4, return_drops=True)
    toks, drops = generate(tm, torch.from_numpy(prompt), 4, temperature=0.0, return_drops=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    assert int(drops) == int(jdrops)
    assert (int(drops) > 0) == (capacity < 1), int(drops)
    assert toks.shape == (2, 4)


def _engine_kw(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("temperature", 0.0)
    kw.setdefault("steps_per_sync", 4)
    return kw


def test_engine_tokens_match_jax_generate():
    """The engine's padded prefills mask the pads out of routing: at ample
    capacity its greedy tokens equal JAX ``generate`` on the unpadded
    prompts; a dense-free MoE engine reports no drops."""
    jc, params, tm = _lm_pair(moe_capacity=4.0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 64, (n,)).astype(np.int32) for n in (3, 13)]
    eng = ContinuousBatcher(tm, **_engine_kw())
    try:
        got = [f.result(timeout=120) for f in [eng.submit(p, 6) for p in prompts]]
        stats = eng.stats()
    finally:
        eng.stop()
    for p, out in zip(prompts, got):
        want = np.asarray(_jax_greedy(jc, params, p[None], 6))[0]
        np.testing.assert_array_equal(out, want)
    assert stats["moe_prefill_drops"] == 0


def test_engine_prefill_drops_equal_the_jax_engine():
    """At capacity 0.05 the engine's ``moe_prefill_drops`` (one-pass and
    chunked prefills) equals the JAX engine's on the same padded shapes,
    and its tokens too; a dense engine reports 0."""
    jc, params, tm = _lm_pair(moe_capacity=0.05)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 64, (n,)).astype(np.int32) for n in (16, 5, 21)]
    kw = _engine_kw(slots=1, prefill_chunk=8)
    eng = ContinuousBatcher(tm, **kw)
    jeng = JaxBatcher(jc, params, **kw)
    try:
        got = [eng.generate(p, 3, timeout=120) for p in prompts]
        want = [jeng.generate(p, 3, timeout=120) for p in prompts]
        drops, jdrops = eng.stats()["moe_prefill_drops"], jeng.stats()["moe_prefill_drops"]
    finally:
        eng.stop()
        jeng.stop()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert drops == jdrops and drops > 0
    dense = ContinuousBatcher(ttf.TransformerLM(ttf.TransformerConfig(
        dtype=torch.float32, remat=False, **{**MOE, "moe_experts": 0})), **_engine_kw())
    try:
        dense.generate(prompts[1], 2, timeout=120)
        assert dense.stats()["moe_prefill_drops"] == 0
    finally:
        dense.stop()


def test_paged_pool_and_spec_with_moe():
    """An MoE target with the paged pool, prefix reuse and speculative
    decoding (its verify pass of k+1 tokens takes the capacity path):
    tokens equal the JAX engine's and plain greedy decode, and the
    ``spec_*`` counters the JAX engine's."""
    jc, params, tm = _lm_pair(moe_capacity=4.0)
    rng = np.random.default_rng(12)
    base = rng.integers(1, 64, (9,)).astype(np.int32)
    prompts = [base, np.concatenate([base, [5, 6]]).astype(np.int32),
               rng.integers(1, 64, (6,)).astype(np.int32)]
    keys = ("spec_proposed", "spec_accepted", "spec_rounds")
    kw = _engine_kw(kv_block=4, kv_pool_blocks=64, steps_per_sync=2, spec_k=3)
    eng = ContinuousBatcher(tm, draft_model=tm, **kw)
    jeng = JaxBatcher(jc, params, draft_cfg=jc, draft_params=params, **kw)
    try:
        got = [eng.generate(p, 5, timeout=120) for p in prompts]
        want = [jeng.generate(p, 5, timeout=120) for p in prompts]
        stats, jstats = eng.stats(), jeng.stats()
    finally:
        eng.stop()
        jeng.stop()
    for p, a, b in zip(prompts, got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, generate(tm, torch.from_numpy(p[None]), 5, temperature=0).numpy()[0])
    assert stats["kv_prefix_hits"] >= 1 and stats["spec_proposed"] > 0
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}


def test_serve_lm_moe_stats():
    """``serve_lm --moe``: both paths serve the MoE model and report
    ``moe_prefill_drops`` in the stats RPC, equal to what the JAX package
    counts on the same weights and prompts: JAX ``generate``'s
    ``return_drops`` for the batch path (``examples/lm/serve_lm.py``'s
    ``predict.stats``), the JAX engine's for the continuous one (prompts
    padded to its bucket)."""
    from edl_tpu_torch.rpc.client import RpcClient

    prompts = np.random.default_rng(2).integers(0, 64, (2, 28)).astype(np.int32)
    flags = ["--device", "cpu", "--vocab", "64", "--layers", "2", "--embed", "32", "--heads",
             "4", "--mlp", "64", "--max_len", "32", "--moe", "4", "--moe_top_k", "2",
             "--max_new_tokens", "3", "--temperature", "0"]
    tm = serve_lm.build_model(serve_lm.parse_args(flags), torch.device("cpu"))
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, **MOE | {"max_len": 32})
    params = params_to_jax({n: p for n, p in tm.state_dict().items()}, tm.cfg)
    want_toks, want_batch = _jax_greedy(jc, params, prompts, 3, return_drops=True)
    jeng = JaxBatcher(jc, params, slots=2, prefill_buckets=(32,), temperature=0.0)
    try:
        for p in prompts:
            jeng.generate(p, 3, timeout=120)
        want_engine = jeng.stats()["moe_prefill_drops"]
    finally:
        jeng.stop()
    for extra, want in (([], int(want_batch)), (["--continuous", "2"], want_engine)):
        server = serve_lm.serve(serve_lm.parse_args(flags + extra))
        try:
            toks = serve_lm.request(server.endpoint, prompts)
            client = RpcClient(server.endpoint)
            try:
                stats = client.call("stats")
            finally:
                client.close()
        finally:
            server.stop()
        np.testing.assert_array_equal(toks, np.asarray(want_toks))
        assert stats["moe_prefill_drops"] == want, (extra, stats["moe_prefill_drops"], want)
    assert want_batch > 0 and want_engine > 0, (int(want_batch), want_engine)


JAX_TRAIN_LM = (ROOT / "examples" / "lm" / "train_lm.py").read_text()
JAX_SERVE_LM = (ROOT / "examples" / "lm" / "serve_lm.py").read_text()


@pytest.mark.parametrize("argv,exc,message,jax_text", [
    (["--ep", "2"], SystemExit, "--ep needs --moe (no expert weights to shard)",
     "--ep needs --moe (no expert weights to shard)"),
    (["--sp", "0"], SystemExit, "--fsdp, --sp and --ep must be >= 1",
     "--fsdp, --sp and --ep must be >= 1"),
    (["--moe", "4", "--moe_top_k", "5"], SystemExit, "--moe_top_k 5 cannot exceed --moe 4 experts",
     'f"--moe_top_k {args.moe_top_k} cannot exceed "'),
    (["--moe", "4", "--sp", "2"], NotImplementedError, "ROADMAP.md Queue 1, MoE x sp", None),
    (["--pp", "2"], NotImplementedError, "ROADMAP.md Queue 1 item 7", None),
], ids=["ep_without_moe", "sp_zero", "top_k_over_experts", "moe_with_sp", "pp"])
def test_train_lm_cli_exits(argv, exc, message, jax_text):
    """The JAX example's exits with its messages (``jax_text``: the message
    in its source); the two it does not refuse name ROADMAP.md.
    ``serve_lm`` shares the top-k exit, as the JAX example's does."""
    with pytest.raises(exc) as err:
        train_lm.parse_args(["--device", "cpu", *argv])
    assert message in str(err.value)
    if jax_text is not None:
        assert jax_text in JAX_TRAIN_LM
    if "--moe_top_k" in argv:
        with pytest.raises(SystemExit, match=message):
            serve_lm.parse_args(["--device", "cpu", *argv])
        assert jax_text in JAX_SERVE_LM
