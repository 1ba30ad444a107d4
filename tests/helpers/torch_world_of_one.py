"""A process group of one rank (gloo, over an in-memory store) and its
mesh, every dim 1, for the tests that pass ``mesh=`` with no tp group wider
than 1 (``tests/test_torch_serving_tp.py`` runs the tp-2 groups)."""

import contextlib


@contextlib.contextmanager
def mesh_of_one():
    import torch.distributed as dist

    from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield build_mesh(MeshSpec(), pods=[0], device_type="cpu")
    finally:
        dist.destroy_process_group()
