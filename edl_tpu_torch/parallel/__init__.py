"""Parallelism layer: meshes over the process world, logical shardings and
the tensor-parallel collectives.

The port of the JAX package's ``parallel/``.  In PyTorch one process
drives one card, so a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the world's ranks: ``fsdp`` is FSDP2 (``fully_shard``) on that dim,
and ``tp`` is Megatron-style tensor parallelism, written out as autograd
functions on the ``tp`` group (``parallel/tp.py``) whose only collective
is an all-reduce.
"""

from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh, default_mesh
from edl_tpu_torch.parallel.sharding import (
    ShardingRules,
    logical_constraint,
    logical_sharding,
    shard_host_batch,
    shard_init,
)

__all__ = [
    "MeshSpec", "build_mesh", "default_mesh",
    "ShardingRules", "logical_sharding", "logical_constraint",
    "shard_init", "shard_host_batch",
]
