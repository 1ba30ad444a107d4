"""Device-mesh construction over the process world.

The port of the JAX package's ``parallel/mesh.py``.  There a mesh is a
``jax.sharding.Mesh`` over the job's devices; here one process drives one
card, so a "device" is a rank of the ``torch.distributed`` world and a mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks,
with all six named dims (size-1 dims included).  A "slice" is a pod of the
launcher: its ranks share a host, and the pods are joined by the network,
as TPU slices are by DCN.

Canonical axis names (outermost -> innermost):

- ``dp``   pure data parallelism (params replicated)
- ``fsdp`` data parallelism with parameter sharding (FSDP2)
- ``pp``   pipeline stages (a run of the stacked layers a rank;
  ``ops/pipeline.py``)
- ``sp``   sequence/context parallelism (a chunk of every sequence a rank;
  ``ops/ring.py``)
- ``tp``   tensor parallelism (Megatron-style, ``parallel/tp.py``)
- ``ep``   expert parallelism (``ops/moe.py``)

The rank layout is a pure function, :func:`mesh_layout`, of the spec, the
world size and the number of slices (ranks are numbered pod by pod), so it
is tested with no process group; :func:`build_mesh` gathers each rank's pod
and wraps the layout in a ``DeviceMesh``.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger(__name__)

# Outermost-first canonical order; see module docstring.
AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "tp", "ep")
# the batch is split over these axes
BATCH_AXES = ("dp", "fsdp")


@dataclass(frozen=True)
class MeshSpec:
    """A declarative mesh shape.  At most one axis may be -1 (absorb all
    remaining ranks); every other axis must divide the rank count.

    ``dcn_dp`` spreads data-parallel replicas ACROSS slices (pods): the
    per-slice axes stay within a pod, and the resulting ``dp`` axis is
    ``dcn_dp x dp``-wide in slice-major order.  0 = auto: one replica group
    per pod when every pod holds a whole per-group mesh, else 1 (a pod of
    one card cannot hold a ``tp`` = 2 group, where a TPU slice always holds
    several chips)."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1
    dcn_dp: int = 1

    def sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Fill in the -1 axis and validate divisibility (``n_devices``
        is per DCN group when ``dcn_dp`` > 1; see :func:`mesh_layout`)."""
        sizes = self.sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes

    def build(self, pods=None, device_type: str | None = None):
        return build_mesh(self, pods, device_type)


def n_slices(pods) -> int:
    """Distinct pods among the ranks' pod indices (1 for none)."""
    return max(1, len(set(pods)))


def _groups(spec: MeshSpec, world: int, slices: int) -> int:
    """The number of DCN replica groups: ``dcn_dp``, or for 0 one per
    slice when each slice holds a whole per-group mesh, else 1."""
    if spec.dcn_dp < 0:
        # no wildcard here: 0 already means "one group per slice"
        raise ValueError(f"dcn_dp must be >= 0, got {spec.dcn_dp}")
    if spec.dcn_dp:
        return spec.dcn_dp
    if slices > 1 and world % slices == 0:
        try:
            spec.resolve(world // slices)
            return slices
        except ValueError:
            pass
    return 1


def mesh_layout(spec: MeshSpec, world: int, slices: int = 1) -> np.ndarray:
    """The rank array of ``spec`` over ``world`` ranks numbered pod by pod
    in ``slices`` equal pods: shape ``[dp, fsdp, pp, sp, tp, ep]``.  With
    more than one DCN group the per-group mesh is built over each group's
    consecutive ranks and the groups are merged slice-major into ``dp``
    (the JAX package's reshape fallback)."""
    dcn = _groups(spec, world, slices)
    if dcn > 1:
        if world % dcn:
            raise ValueError(f"{world} devices not divisible into {dcn} DCN groups")
        sizes = spec.resolve(world // dcn)
        shape = tuple(sizes[a] for a in AXIS_ORDER)
        per = np.arange(world).reshape((dcn,) + shape)
        return per.reshape((dcn * shape[0],) + shape[1:])
    sizes = spec.resolve(world)
    return np.arange(world).reshape(tuple(sizes[a] for a in AXIS_ORDER))


def rank_array(mesh) -> np.ndarray:
    """The rank array of a ``DeviceMesh`` or of a layout."""
    if isinstance(mesh, np.ndarray):
        return mesh
    return mesh.mesh.cpu().numpy()


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, a layout, or a dict of sizes
    (every axis absent is 1); None is the mesh of one rank."""
    if mesh is None:
        return {a: 1 for a in AXIS_ORDER}
    if isinstance(mesh, dict):
        return {a: int(mesh.get(a, 1)) for a in AXIS_ORDER}
    if isinstance(mesh, np.ndarray):
        return dict(zip(AXIS_ORDER, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def coordinate(mesh, rank: int) -> dict[str, int]:
    """``rank``'s index along each axis of ``mesh`` (zeros for None)."""
    if mesh is None:
        return {a: 0 for a in AXIS_ORDER}
    arr = rank_array(mesh)
    where = np.argwhere(arr == rank)
    if not len(where):
        raise ValueError(f"rank {rank} is not in the mesh")
    return dict(zip(AXIS_ORDER, (int(i) for i in where[0])))


def batch_divisor(mesh) -> int:
    """Number of ways the batch dimension is split on this mesh."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in BATCH_AXES)


def data_index(mesh, rank: int) -> int:
    """``rank``'s position along the batch axes (dp-major, then fsdp):
    which rows of the global batch it reads.  The sp, tp and ep ranks of
    one data coordinate read the same rows."""
    c, sizes = coordinate(mesh, rank), mesh_sizes(mesh)
    return c["dp"] * sizes["fsdp"] + c["fsdp"]


def pod_ranks() -> list[int]:
    """Every rank's pod (the launcher's ``EDL_TPU_POD_RANK``), gathered over
    the world in rank order; ``[0] * world`` outside the launcher."""
    from edl_tpu_torch.cluster.env import TrainerEnv
    from edl_tpu_torch.train.distributed import allgather_flag

    return [int(p) for p in allgather_flag(int(TrainerEnv().pod_rank or 0))]


def world_layout(spec: MeshSpec, pods) -> np.ndarray:
    """The rank array of ``spec`` over a world whose rank r is on pod
    ``pods[r]``: the ranks ordered pod by pod, then :func:`mesh_layout`."""
    world = len(pods)
    order = np.asarray(sorted(range(world), key=lambda r: (pods[r], r)))
    return order[mesh_layout(spec, world, n_slices(pods))]


def build_mesh(spec: MeshSpec, pods=None, device_type: str | None = None):
    """A ``DeviceMesh`` of ``spec`` over the formed world.  ``pods``: each
    rank's pod (default: gathered, collective); ranks are ordered pod by
    pod before :func:`mesh_layout` places them.  ``device_type`` defaults
    to the backend's: ``cuda`` under NCCL, ``cpu`` under gloo (gloo on
    CUDA tensors: pass ``cuda``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    pods = pod_ranks() if pods is None else list(pods)
    if len(pods) != world:
        raise ValueError(f"{len(pods)} pod indices for a world of {world}")
    ranks = world_layout(spec, pods)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    logger.info("mesh %s over %d ranks (%d pods)", mesh_sizes(ranks), world, n_slices(pods))
    return DeviceMesh(device_type, torch.from_numpy(ranks.copy()), mesh_dim_names=AXIS_ORDER)


def default_mesh(pods=None, device_type: str | None = None):
    """All ranks on the ``dp`` axis: pure data parallelism."""
    return build_mesh(MeshSpec(), pods, device_type)
