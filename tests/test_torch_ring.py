"""Ring attention and sequence parallelism (``edl_tpu_torch/ops/ring.py``,
the ``sp`` mesh axis) on the CPU, against the JAX package, mirroring
``tests/test_ring_attention.py``: one 4-rank gloo world
(``tests/helpers/torch_ring_worker.py``, a 120 s limit on each process)
runs every multi-rank case; the JAX side runs on its virtual CPU devices.

- ring attention against JAX ``dense_attention``, causal and not, at sp 4,
  dp 2 x sp 2, and dp 2 x sp 2 x tp 2 (the world holds sp 2 x tp 2; its
  two dp pieces run one after the other): outputs and dq/dk/dv of
  ``sum(out * g)`` against ``jax.vjp`` of dense, 2e-5 in f32;
- GQA (the kv groups expanded before the ring), bf16 (2e-2), a
  ``kv_chunk`` that leaves a masked tail, and the gathered sequence
  (``impl="dense"`` with an sp group);
- the LM at dp 2 x sp 2 with ring and with the gathered auto attention
  against the JAX model's logits;
- ``train_lm --sp 2``, with ``--attention ring`` (dp 2 x sp 2), with
  auto (sp 2 x tp 2) and with ``--fsdp 2`` (FSDP2, fsdp 2 x sp 2), 3 steps
  against the JAX trainer on the same ``MeshSpec``: losses and the
  parameters after them.

In process: a ring of one rank equals dense.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import transformer as jtf
from edl_tpu.models.logical import logical_axes_from_paths
from edl_tpu.ops.attention import dense_attention as jax_dense
from edl_tpu.parallel import MeshSpec as JaxMeshSpec
from edl_tpu.parallel.sharding import shard_host_batch as jax_shard_host_batch
from edl_tpu.train.trainer import ElasticTrainer as JaxTrainer
from edl_tpu.train.trainer import TrainConfig as JaxTrainConfig
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.ops.ring import ring_attention
from tests.helpers.torch_spawn import ROOT, run_world

WORKER = ROOT / "tests" / "helpers" / "torch_ring_worker.py"
WORKER_TIMEOUT = 120      # seconds per worker process
WORLD = 4
F32_TOL, BF16_TOL = 2e-5, 2e-2
LM = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=4, mlp_dim=64, max_len=16)
FLAGS = ["--device", "cpu", "--vocab", "64", "--layers", "2", "--embed", "32", "--heads", "4",
         "--mlp", "64", "--seq_len", "16", "--batch_size", "2", "--fused_ce", "--ce_block", "16",
         "--lr", "3e-3", "--remat", "off"]
LR = 3e-3
LOGITS_TOL = 2e-3          # rtol and atol, as tests/test_ring_attention.py's
LOSS_ATOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4


def _qkvg(B=2, L=32, H=4, D=16, Hk=None, seed=7):
    rng = np.random.default_rng(seed)
    shapes = [(B, L, H, D), (B, L, Hk or H, D), (B, L, Hk or H, D), (B, L, H, D)]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _case(mesh, causal=True, dtype=torch.float32, impl="ring", chunk=1024, dp_pieces=1, **kw):
    return dict(mesh=mesh, causal=causal, dtype=dtype, impl=impl, chunk=chunk,
                dp_pieces=dp_pieces, tensors=[torch.from_numpy(a) for a in _qkvg(**kw)])


CASES = {
    **{f"{name}_{'causal' if c else 'full'}": _case(mesh, causal=c, dp_pieces=pieces)
       for name, mesh, pieces in (("sp4", dict(dp=1, sp=4), 1),
                                  ("dp2_sp2", dict(dp=2, sp=2), 1),
                                  ("dp2_sp2_tp2", dict(dp=1, sp=2, tp=2), 2))
       for c in (True, False)},
    "gqa": _case(dict(dp=2, sp=2), Hk=2, seed=9),
    "bf16": _case(dict(dp=1, sp=4), dtype=torch.bfloat16),
    "tail_causal": _case(dict(dp=2, sp=2), chunk=3, L=28, H=2, D=8),
    "tail_full": _case(dict(dp=1, sp=4), causal=False, chunk=3, L=28, H=2, D=8),
    "chunk5": _case(dict(dp=1, sp=4), chunk=5),
    "gathered": _case(dict(dp=2, sp=2), impl="dense"),
}


def _jax_lm(impl="dense", mesh=None):
    jc = jtf.TransformerConfig(dtype=jnp.float32, remat=False, attention_impl=impl, mesh=mesh,
                               **LM)
    return jc, jtf.TransformerLM(jc)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    io_dir = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(23)
    batches = [rng.integers(0, 64, (4, 17)).astype(np.int32) for _ in range(3)]
    ids = rng.integers(0, 64, (4, 16)).astype(np.int32)
    _, jm = _jax_lm()
    params = jax.jit(jm.init)(jax.random.key(5), jnp.asarray(ids))["params"]
    tc = ttf.TransformerConfig(dtype=torch.float32, remat=False, **LM)
    torch.save({"attn": CASES,
                "lm": {"weights": params_from_jax(jax.tree.map(np.asarray, params), tc),
                       "cfg": dict(LM, dtype=torch.float32, remat=False),
                       "ids": torch.from_numpy(ids)},
                "batches": [torch.from_numpy(b) for b in batches], "flags": FLAGS},
               io_dir / "in.pt")
    outs = run_world(WORKER, io_dir, WORLD, WORKER_TIMEOUT)
    return {"outs": outs, "params": params, "ids": ids, "batches": batches, "tc": tc}


def _index(part, shape):
    """The slices of a global ``[B, L, H, D]`` tensor of a piece's
    ``(rows, seq, heads)``, each ``(index, ways)``."""
    out = []
    for (i, ways), n in zip(part, shape[:3]):
        c = n // ways
        out.append(slice(i * c, (i + 1) * c))
    return tuple(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_jax_dense(world, name):
    """Every rank's piece of the output and of dq, dk, dv against JAX dense
    attention and its vjp on the same inputs."""
    case = CASES[name]
    jdtype = jnp.bfloat16 if case["dtype"] == torch.bfloat16 else jnp.float32
    q, k, v, g = (jnp.asarray(t.numpy()).astype(jdtype) for t in case["tensors"])

    @jax.jit
    def reference(q, k, v, g):
        out, vjp = jax.vjp(lambda a, b, c: jax_dense(a, b, c, causal=case["causal"]), q, k, v)
        return out, vjp(g.astype(out.dtype))

    want, grads = reference(q, k, v, g)
    dq, dk, dv = (np.asarray(t, np.float32) for t in grads)
    want = np.asarray(want, np.float32)
    tol = BF16_TOL if jdtype == jnp.bfloat16 else F32_TOL
    seen = np.zeros(want.shape[:3], np.int32)
    for out in world["outs"]:
        for (rows, seq, hq, hk), o, gq, gk, gv in out["attn"][name]:
            iq, ik = _index((rows, seq, hq), want.shape), _index((rows, seq, hk), dk.shape)
            assert o.dtype == case["dtype"]
            np.testing.assert_allclose(o.float().numpy(), want[iq], atol=tol, rtol=tol)
            np.testing.assert_allclose(gq.float().numpy(), dq[iq], atol=tol, rtol=tol)
            np.testing.assert_allclose(gk.float().numpy(), dk[ik], atol=tol, rtol=tol)
            np.testing.assert_allclose(gv.float().numpy(), dv[ik], atol=tol, rtol=tol)
            seen[iq] += 1
    assert (seen == 1).all()            # the pieces tile the output once


@pytest.mark.parametrize("impl", ["ring", "auto"])
def test_transformer_with_sp_matches_dense(world, impl):
    """The LM at dp 2 x sp 2 (RoPE and the causal mask at global positions)
    against the JAX model's dense logits."""
    _, jm = _jax_lm()
    want = np.asarray(jax.jit(jm.apply)({"params": world["params"]}, jnp.asarray(world["ids"])))
    for r, out in enumerate(world["outs"]):
        d, s = r // 2, r % 2
        np.testing.assert_allclose(out[f"logits_{impl}"].numpy(),
                                   want[2 * d:2 * d + 2, 8 * s:8 * s + 8],
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)


def _jax_trainer_steps(world, spec, impl):
    trainer = JaxTrainer(lambda *a: None, JaxTrainConfig(mesh_spec=spec),
                         devices=jax.devices()[:WORLD])
    jc, jm = _jax_lm(impl, trainer.mesh if impl == "ring" else None)

    def loss_fn(p, extra, batch, rng):
        ids = batch["ids"]
        h = jm.apply({"params": p}, ids[:, :-1], return_hidden=True)
        return jtf.lm_loss_fused(p, h, ids[:, 1:], jc, block_size=16), (extra, {})

    trainer.loss_fn = loss_fn
    logical = logical_axes_from_paths(world["params"], jtf.LOGICAL_RULES)
    state = trainer.create_state(lambda: (world["params"], None), optax.adamw(LR), logical)
    losses = []
    for ids in world["batches"]:
        g = jax_shard_host_batch({"ids": ids}, trainer.mesh, trainer.rules)
        state, metrics = trainer.step_fn(state, g, jax.random.key(0))
        losses.append(float(metrics["loss"]))
    return losses, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("key,spec,impl,mesh", [
    ("train_ring", JaxMeshSpec(dp=2, sp=2), "ring", dict(dp=2, sp=2, tp=1)),
    ("train_auto", JaxMeshSpec(dp=1, sp=2, tp=2), "auto", dict(dp=1, sp=2, tp=2)),
    ("train_fsdp", JaxMeshSpec(dp=1, fsdp=2, sp=2), "auto", dict(fsdp=2, sp=2, tp=1)),
], ids=["ring_dp2_sp2", "auto_sp2_tp2", "auto_fsdp2_sp2"])
def test_train_lm_sp_matches_the_jax_trainer(world, key, spec, impl, mesh):
    """``train_lm --sp 2`` (ring, and the gathered auto attention) for 3
    steps against the JAX trainer on the same MeshSpec, weights and global
    batches: f32 losses and the parameters after them."""
    losses, jparams = _jax_trainer_steps(world, spec, impl)
    want = params_from_jax(jparams, world["tc"])
    for out in world["outs"]:
        got = out[key]
        assert {a: got["mesh"][a] for a in mesh} == mesh
        np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL, rtol=0)
        for name, p in got["params"].items():
            torch.testing.assert_close(p, want[name], atol=PARAM_ATOL, rtol=PARAM_RTOL, msg=name)


def test_ring_of_one_rank_equals_dense():
    """With no sp group the ring folds the whole sequence on this rank,
    chunked or not: JAX dense, and its gradient."""
    q, k, v, g = _qkvg(L=20)
    want = np.asarray(jax_dense(*(jnp.asarray(t) for t in (q, k, v)), causal=True))
    for chunk in (0, 6):
        tq = torch.from_numpy(q).requires_grad_(True)
        out = ring_attention(tq, torch.from_numpy(k), torch.from_numpy(v), None, causal=True,
                             kv_chunk=chunk)
        np.testing.assert_allclose(out.detach().numpy(), want, atol=F32_TOL, rtol=F32_TOL)
        (out * torch.from_numpy(g)).sum().backward()
        assert torch.isfinite(tq.grad).all()
