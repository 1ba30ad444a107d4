"""The port's mesh and logical sharding against the JAX package's
``parallel/`` (the mirrors of ``tests/test_parallel.py`` but its
sequence-parallel cases), with no process group: the rank layout is a pure
function of the spec, the world size and the pods; a sharding spec is
DTensor placements per mesh dim, held to the JAX ``PartitionSpec``.  The
multi-rank cases are in ``tests/test_torch_mesh_train.py``."""

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from edl_tpu.parallel import MeshSpec as JaxMeshSpec
from edl_tpu.parallel import build_mesh as jax_build_mesh
from edl_tpu.parallel.mesh import batch_divisor as jax_batch_divisor
from edl_tpu.parallel.sharding import ShardingRules as JaxRules
from edl_tpu_torch.models import transformer as ttf
from edl_tpu_torch.models.logical import logical_axes_from_paths
from edl_tpu_torch.parallel import MeshSpec, ShardingRules, logical_constraint, logical_sharding
from edl_tpu_torch.parallel.mesh import (AXIS_ORDER, batch_divisor, coordinate, data_index,
                                         mesh_layout, mesh_sizes, n_slices)
from edl_tpu_torch.parallel.sharding import (LeafLayout, local_boxes, param_layouts,
                                             shard_host_batch, tp_ranges, tp_slice)
from edl_tpu_torch.parallel.tp import TP


def _placements(**shard):
    """Placements per mesh dim: ``Shard(d)`` for the dims named."""
    return tuple(Shard(shard[a]) if a in shard else Replicate() for a in AXIS_ORDER)


def test_default_mesh_all_dp():
    sizes = mesh_sizes(mesh_layout(MeshSpec(), 8))
    assert sizes["dp"] == 8 and all(sizes[a] == 1 for a in AXIS_ORDER if a != "dp")


def test_spec_resolve_wildcard():
    assert MeshSpec(tp=2).resolve(8)["dp"] == 4
    assert MeshSpec(dp=2, tp=2, sp=2).resolve(8)["dp"] == 2
    with pytest.raises(ValueError):
        MeshSpec(dp=3).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(dp=-1, tp=3).resolve(8)
    with pytest.raises(ValueError, match="at most one -1"):
        MeshSpec(dp=-1, fsdp=-1).resolve(8)


@pytest.mark.parametrize("spec", [dict(dp=2, tp=2, sp=2), dict(fsdp=2, tp=2), dict(tp=4),
                                  dict(dp=2, fsdp=2, tp=2)])
def test_build_mesh_multi_axis(spec):
    """The layout's shape and batch divisor are the JAX mesh's."""
    layout = mesh_layout(MeshSpec(**spec), 8)
    jmesh = jax_build_mesh(JaxMeshSpec(**spec))
    assert mesh_sizes(layout) == dict(jmesh.shape)
    assert batch_divisor(layout) == jax_batch_divisor(jmesh)
    assert sorted(layout.reshape(-1).tolist()) == list(range(8))


def _jax_spec(axes, spec, rules=None):
    mesh = jax_build_mesh(JaxMeshSpec(**spec))
    return tuple((rules or JaxRules()).spec(axes, mesh))


@pytest.mark.parametrize("axes,spec,want", [
    # fsdp has size 1 -> batch maps to dp only; embed (fsdp) replicated
    (("batch", "embed", "mlp"), dict(dp=4, tp=2), dict(dp=0, tp=2)),
    (("batch", None, "mlp"), dict(dp=2, fsdp=2, tp=2), dict(dp=0, fsdp=0, tp=2)),
    (("vocab", "embed"), dict(fsdp=2, tp=2), dict(tp=0, fsdp=1)),
])
def test_logical_sharding_drops_size1_axes(axes, spec, want):
    layout = mesh_layout(MeshSpec(**spec), 8)
    assert logical_sharding(axes, layout) == _placements(**want)
    assert ShardingRules().partition(axes, layout) == _jax_spec(axes, spec)


def test_logical_sharding_tuple_axes():
    layout = mesh_layout(MeshSpec(dp=2, fsdp=2, tp=2), 8)
    assert ShardingRules().partition(("batch", None, "mlp"), layout) == (("dp", "fsdp"), None,
                                                                         "tp")


def test_no_mesh_axis_reuse_within_spec():
    layout = mesh_layout(MeshSpec(dp=4, tp=2), 8)
    rules = ShardingRules().updated(rows="tp", cols="tp")
    # tp may appear only once per spec; the second use is replicated
    assert rules.partition(("rows", "cols"), layout) == ("tp",)
    assert logical_sharding(("rows", "cols"), layout, rules) == _placements(tp=0)
    jrules = JaxRules().updated(rows="tp", cols="tp")
    assert rules.partition(("rows", "cols"), layout) == _jax_spec(("rows", "cols"),
                                                                  dict(dp=4, tp=2), jrules)


def test_shard_host_batch_and_constraint():
    """Each rank's rows of the global batch, split on the batch axes only:
    the tp ranks of one data coordinate get the same rows; a plain tensor
    passes ``logical_constraint`` unchanged."""
    batch = {"x": np.arange(64, dtype=np.float32).reshape(16, 4), "y": np.arange(16)}
    layout = mesh_layout(MeshSpec(dp=8), 8)
    parts = [shard_host_batch(batch, layout, r) for r in range(8)]
    assert np.array_equal(np.concatenate([p["x"] for p in parts]), batch["x"])
    assert all(p["y"].shape == (2,) for p in parts)
    tp_layout = mesh_layout(MeshSpec(dp=2, tp=4), 8)
    rows = [shard_host_batch(batch, tp_layout, r)["y"].tolist() for r in range(8)]
    assert rows[:4] == [list(range(8))] * 4 and rows[4:] == [list(range(8, 16))] * 4
    assert [data_index(tp_layout, r) for r in range(8)] == [0] * 4 + [1] * 4
    x = torch.ones(3)
    assert logical_constraint(x, ("batch",), layout) is x


def test_matmul_psum_over_tp_mesh():
    """A tp-split contraction: each rank's partial product over its slice of
    the contracted dim sums to the single-device product (the all-reduce
    that reduce_from runs)."""
    layout = mesh_layout(MeshSpec(dp=1, tp=8), 8)
    x = np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(16, 32)).astype(np.float32)
    xl = LeafLayout((4, 16), 1, (16,))
    wl = LeafLayout((16, 32), 0, (16,))
    parts = []
    for r in range(8):
        tp = TP(None, coordinate(layout, r)["tp"], 8)
        parts.append(tp_slice(torch.from_numpy(x), xl, tp) @ tp_slice(torch.from_numpy(w), wl, tp))
    np.testing.assert_allclose(sum(parts).numpy(), x @ w, rtol=1e-4, atol=1e-4)


def test_hybrid_mesh_dcn_groups():
    """dcn_dp spreads replica groups across pods; dp = dcn x inner dp, pod
    by pod, as the JAX package's slice-major fallback lays it out."""
    layout = mesh_layout(MeshSpec(dp=-1, tp=2, dcn_dp=2), 8)
    jmesh = jax_build_mesh(JaxMeshSpec(dp=-1, tp=2, dcn_dp=2))
    assert mesh_sizes(layout) == dict(jmesh.shape) and batch_divisor(layout) == 4
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    assert np.array_equal(layout, ids)
    parts = [shard_host_batch({"x": np.ones((8, 4), np.float32)}, layout, r)["x"]
             for r in range(8)]
    assert sum(float(p.sum()) for p in parts[::2]) == 32.0


def test_hybrid_mesh_auto_single_slice():
    """One pod is one slice (JAX: CPU devices have no slice index); auto
    dcn_dp then gives one group, as JAX's does."""
    from edl_tpu.parallel.mesh import n_slices as jax_n_slices

    assert jax_n_slices(jax.devices()) == 1
    assert n_slices([0] * 8) == 1 and n_slices([0, 0, 1, 1]) == 2
    assert mesh_sizes(mesh_layout(MeshSpec(dp=-1, dcn_dp=0), 8))["dp"] == 8
    # auto: one group per pod when each pod holds the per-group mesh, else 1
    assert mesh_layout(MeshSpec(dp=-1, tp=2, dcn_dp=0), 4, slices=2).shape[0] == 2
    assert mesh_sizes(mesh_layout(MeshSpec(dp=-1, tp=2, dcn_dp=0), 2, slices=2))["tp"] == 2


def test_hybrid_mesh_bad_group_count():
    with pytest.raises(ValueError, match="DCN groups"):
        mesh_layout(MeshSpec(dp=-1, dcn_dp=3), 8)
    with pytest.raises(ValueError, match="dcn_dp must be >= 0"):
        mesh_layout(MeshSpec(dcn_dp=-1), 8)


def test_lm_logical_rules_and_head_split_boxes():
    """The port's rules give each LM weight its torch dims' axes; the fused
    q|k|v weight is split by heads: rank r's rows are three boxes of the
    global leaf (its q, k and v heads), and GQA needs the kv heads to
    divide over tp."""
    cfg = ttf.TransformerConfig(vocab_size=64, num_layers=1, embed_dim=32, num_heads=4,
                                num_kv_heads=2, mlp_dim=64, dtype=torch.float32)
    model = ttf.TransformerLM(cfg)
    logical = logical_axes_from_paths(model, ttf.LOGICAL_RULES)
    assert logical["layers.0.attn_qkv.weight"] == ("heads", "embed")
    assert logical["lm_head.weight"] == ("vocab", "embed")
    layout = mesh_layout(MeshSpec(fsdp=2, tp=2), 4)
    lays = param_layouts(model, logical, layout)
    qkv = lays["layers.0.attn_qkv.weight"]
    assert (qkv.tp_dim, qkv.segments, qkv.fsdp_dim) == (0, (32, 16, 16), 1)
    assert lays["layers.0.attn_out.weight"].tp_dim == 1
    assert lays["final_norm.scale"] == LeafLayout((32,), None, (), None)
    assert tp_ranges(qkv, 1, 2) == [(16, 0, 16), (40, 16, 8), (56, 24, 8)]
    full = model.layers[0].attn_qkv.weight.detach()
    local = tp_slice(full, qkv, TP(None, 1, 2))
    boxes = local_boxes(local, qkv, TP(None, 1, 2))
    assert [b for b, _ in boxes] == [[[16, 32], [0, 32]], [[40, 48], [0, 32]],
                                     [[56, 64], [0, 32]]]
    for box, index in boxes:
        assert torch.equal(local[index], full[box[0][0]:box[0][1]])
    with pytest.raises(ValueError, match="kv heads 2 does not divide over tp = 4"):
        model.set_tp(TP(None, 0, 4))


@pytest.mark.parametrize("flag", [["--sp", "2"], ["--pp", "2"], ["--ep", "2"], ["--moe", "4"],
                                  ["--attention", "ring"]])
def test_train_lm_unported_mesh_flags_raise(flag):
    """Every mesh flag is ported: ``--pp`` parses with its microbatch count
    (``tests/test_torch_pipeline.py`` trains it); ``--ep`` without ``--moe``
    exits with the JAX example's message; the others parse."""
    from edl_tpu_torch import train_lm

    argv = ["--device", "cpu"] + flag
    if flag[0] == "--pp":
        args = train_lm.parse_args(argv)
        assert (args.pp, args.pp_microbatches) == (2, 4)
        assert train_lm.mesh_spec(args)(2).pp == 2
    elif flag[0] == "--ep":
        with pytest.raises(SystemExit, match="--ep needs --moe"):
            train_lm.parse_args(argv)
    else:
        args = train_lm.parse_args(argv)
        assert (args.sp, args.moe, args.attention) != (1, 0, "auto")


@pytest.mark.parametrize("flags,world,want", [
    ([], 1, dict(dp=1, tp=1)), ([], 2, dict(dp=1, tp=2)), ([], 3, dict(dp=3, tp=1)),
    ([], 4, dict(dp=2, tp=2)), (["--fsdp", "2"], 4, dict(fsdp=2, tp=2)),
    (["--fsdp", "2"], 2, dict(fsdp=2, tp=1)), (["--tp", "4"], 8, dict(dp=2, tp=4)),
    (["--tp", "1"], 2, dict(dp=2, tp=1))])
def test_train_lm_auto_tp_is_the_jax_examples(flags, world, want):
    """``--tp 0``: 2 when the ranks left by fsdp are even, else 1
    (``examples/lm/train_lm.py:259-262``, its devices the port's ranks)."""
    from edl_tpu_torch import train_lm

    spec = train_lm.mesh_spec(train_lm.parse_args(["--device", "cpu"] + flags))(world)
    sizes = mesh_sizes(mesh_layout(spec, world))
    assert {a: n for a, n in sizes.items() if n > 1} == {a: n for a, n in want.items() if n > 1}
