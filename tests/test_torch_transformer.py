"""The port's TransformerLM against the JAX package's, from the same
weights (carried across by ``edl_tpu_torch.models.convert``): logits,
hidden states, both losses and every parameter gradient, in f32; and the
bf16 dtype flow."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from edl_tpu.models import transformer as jtf
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax, params_to_jax
from edl_tpu_torch.parallel.tp import SP

SMALL = dict(num_layers=2, embed_dim=128, num_heads=2, mlp_dim=256, max_len=64)


def _configs(dtype_j=jnp.float32, dtype_t=torch.float32, **kw):
    jc = jtf.TransformerConfig(dtype=dtype_j, remat=False, attention_impl="dense",
                               **{**SMALL, **kw})
    tc = ttf.TransformerConfig(dtype=dtype_t, remat=False, **{**SMALL, **kw})
    return jc, tc


def _models(jc, tc, ids, seed=0):
    jm = jtf.TransformerLM(jc)
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(ids))["params"]
    tm = ttf.TransformerLM(tc)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tc))
    return jm, params, tm


def _ids(vocab, B=2, L=33, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).astype(np.int32)


def _close(got, want, atol=1e-4, rtol=1e-3):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("tied", [False, True])
def test_converter_round_trip(tied):
    jc, tc = _configs(vocab_size=257, tie_embeddings=tied)
    ids = _ids(257)
    _, params, tm = _models(jc, tc, ids[:, :-1])
    stacked = params_to_jax(tm.state_dict(), tc)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), params, stacked)
    # the split (per-layer) tree that generation uses loads to the same weights
    split = params_to_jax(tm.state_dict(), tc, stacked=False)
    assert f"layer_{tc.num_layers - 1}" in split and "layers" not in split
    again = params_from_jax(split, tc)
    for name, t in tm.state_dict().items():
        torch.testing.assert_close(again[name], t, atol=0, rtol=0)


@pytest.mark.parametrize("vocab,tied,kv", [(257, False, 0), (256, True, 0), (257, False, 1)],
                         ids=["untied_v257", "tied_v256", "gqa_kv1"])
def test_forward_losses_and_grads_match_jax(vocab, tied, kv):
    jc, tc = _configs(vocab_size=vocab, tie_embeddings=tied, num_kv_heads=kv)
    ids = _ids(vocab)
    jm, params, tm = _models(jc, tc, ids[:, :-1])
    x, y = jnp.asarray(ids[:, :-1]), jnp.asarray(ids[:, 1:])
    tx, ty = torch.from_numpy(ids[:, :-1]), torch.from_numpy(ids[:, 1:])

    # logits and hidden
    jlogits, jhidden = jax.jit(lambda p: (
        jm.apply({"params": p}, x), jm.apply({"params": p}, x, return_hidden=True)))(params)
    _close(tm(tx).detach(), jlogits)
    _close(tm(tx, return_hidden=True).detach(), jhidden)

    jlosses = (
        lambda p: jtf.lm_loss(jm.apply({"params": p}, x), y),
        lambda p: jtf.lm_loss_fused(p, jm.apply({"params": p}, x, return_hidden=True),
                                    y, jc, block_size=64))
    for which in (0, 1):
        jv, jg = jax.jit(jax.value_and_grad(jlosses[which]))(params)
        tm.zero_grad()
        if which == 0:
            tv = ttf.lm_loss(tm(tx), ty)
        else:
            tv = ttf.lm_loss_fused(tm, tm(tx, return_hidden=True), ty, block_size=64)
        tv.backward()
        _close(tv.item(), float(jv), atol=1e-5, rtol=1e-5)
        tg = params_to_jax({n: p.grad for n, p in tm.named_parameters()}, tc)
        jax.tree.map(lambda g_t, g_j: _close(g_t, g_j), tg, jg)


def test_bf16_dtype_flow_matches_jax():
    """RMSNorm normalises in f32, casts to bf16, then multiplies by the f32
    scale, so the hidden states come out f32 in both packages; layers keep
    a bf16 residual stream."""
    jc, tc = _configs(jnp.bfloat16, torch.bfloat16, vocab_size=257)
    ids = _ids(257)
    jm, params, tm = _models(jc, tc, ids[:, :-1])
    x, tx = jnp.asarray(ids[:, :-1]), torch.from_numpy(ids[:, :-1])
    jh = jax.jit(lambda p: jm.apply({"params": p}, x, return_hidden=True))(params)
    th = tm(tx, return_hidden=True)
    assert jh.dtype == jnp.float32 and th.dtype == torch.float32
    assert tm(tx).dtype == torch.float32
    emb = torch.nn.functional.embedding(tx.long(), tm.tok_embed.weight).to(torch.bfloat16)
    pos = torch.arange(tx.shape[1]).expand(tx.shape)
    assert tm.layers[0](emb, pos).dtype == torch.bfloat16
    assert tm.layers[0].attn_norm(emb).dtype == torch.float32
    # bf16 rounds at every layer output; the flows agree to bf16 precision
    _close(th.detach(), jh, atol=0.1, rtol=0.05)
    # the fused loss widens the head weight to the f32 hidden states
    jl = jtf.lm_loss_fused(params, jh, jnp.asarray(ids[:, 1:]), jc, block_size=64)
    tl = ttf.lm_loss_fused(tm, th, torch.from_numpy(ids[:, 1:]), block_size=64)
    _close(tl.item(), float(jl), atol=2e-2, rtol=1e-2)


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    _close(ttf.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           jtf.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), atol=1e-5, rtol=1e-5)
    h = rng.normal(size=(3, 32)).astype(np.float32)
    jn = jtf.RMSNorm(jnp.bfloat16)
    jp = jn.init(jax.random.key(0), jnp.asarray(h))
    jout = jn.apply(jp, jnp.asarray(h).astype(jnp.bfloat16))
    tout = ttf.RMSNorm(32, torch.bfloat16)(torch.from_numpy(h).to(torch.bfloat16))
    assert jout.dtype == jnp.float32 and tout.dtype == torch.float32
    _close(tout.detach(), jout, atol=1e-2, rtol=1e-2)


def test_remat_gives_the_same_grads():
    _, tc = _configs(vocab_size=257)
    ids = torch.from_numpy(_ids(257))
    grads = []
    for remat in (False, True):
        tm = ttf.TransformerLM(dataclasses.replace(tc, remat=remat),
                               torch.Generator().manual_seed(1))
        ttf.lm_loss(tm(ids[:, :-1]), ids[:, 1:]).backward()
        grads.append([p.grad for p in tm.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


class _CountOps(TorchDispatchMode):
    """Counts the aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_remat_keeps_the_projections():
    """The remat policy (JAX's ``dots_with_no_batch_dims_saveable``) keeps
    the ``Dense`` outputs: the backward runs as many ``mm``/``addmm`` with
    remat on as with it off (no projection is run again), while the
    attention products (``bmm``, batch dims) are recomputed."""
    _, tc = _configs(vocab_size=257)
    ids = torch.from_numpy(_ids(257))
    counts = {}
    for remat in (False, True):
        tm = ttf.TransformerLM(dataclasses.replace(tc, remat=remat),
                               torch.Generator().manual_seed(1))
        loss = ttf.lm_loss(tm(ids[:, :-1]), ids[:, 1:])
        with _CountOps() as mode:
            loss.backward()
        counts[remat] = mode.counts
    dense = ("aten.mm.default", "aten.addmm.default")
    assert [counts[True][op] for op in dense] == [counts[False][op] for op in dense]
    assert counts[False]["aten.mm.default"] > 0
    # the recomputed forward: each layer's two attention products
    assert counts[True]["aten.bmm.default"] == counts[False]["aten.bmm.default"] + 2 * tc.num_layers


@pytest.mark.parametrize("kw", [dict(), dict(tie_embeddings=True), dict(num_kv_heads=1)])
def test_param_count_and_auto_layout_match_jax(kw):
    jc = jtf.TransformerConfig(**kw)
    tc = ttf.TransformerConfig(**kw)
    assert ttf.param_count(tc) == jtf.param_count(jc)
    small = ttf.TransformerLM(dataclasses.replace(tc, num_layers=1, vocab_size=64,
                                                  embed_dim=64, mlp_dim=64, num_heads=2))
    assert sum(p.numel() for p in small.parameters()) == ttf.param_count(small.cfg)
    for hbm in (16e9, 80e9):
        for bs in (8, 16):
            assert (ttf.auto_layout(tc, bs, 1024, hbm_bytes=hbm).remat
                    == jtf.auto_layout(jc, bs, 1024, hbm_bytes=hbm).remat)


def test_init_families():
    tc = ttf.TransformerConfig(vocab_size=4096, num_layers=1, embed_dim=256, num_heads=2,
                               mlp_dim=512, dtype=torch.float32)
    tm = ttf.TransformerLM(tc, torch.Generator().manual_seed(0))
    again = ttf.TransformerLM(tc, torch.Generator().manual_seed(0))
    for a, b in zip(tm.parameters(), again.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert abs(tm.tok_embed.weight.std().item() - 256 ** -0.5) < 2e-3
    w = tm.layers[0].mlp_gate.weight                 # fan_in 256
    assert abs(w.std().item() - 256 ** -0.5) < 2e-3
    assert w.abs().max().item() <= 2 * 256 ** -0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(tm.final_norm.scale, torch.ones(256))


def test_unported_modes_raise():
    # decode mode is ported (tests/test_torch_generate.py); a decode-mode
    # model computes only against a KVCache
    decode = ttf.TransformerLM(ttf.TransformerConfig(decode=True, vocab_size=64, **SMALL))
    with pytest.raises(ValueError, match="KVCache"):
        decode(torch.zeros((1, 4), dtype=torch.int64))
    # MoE is ported (tests/test_torch_moe.py); MoE over sp is not
    moe = ttf.TransformerLM(ttf.TransformerConfig(moe_experts=4, vocab_size=64, **SMALL))
    with pytest.raises(NotImplementedError, match="MoE x sp"):
        moe.set_sp(SP(None, 0, 2))
