"""LM serving: slot-based continuous batching (engine.py) over the paged KV
block pool with prefix reuse (kv_cache.py), and the replica server that
leases an engine into the gateway's fleet (replica.py)."""

from edl_tpu_torch.serving.engine import ContinuousBatcher
from edl_tpu_torch.serving.kv_cache import PagedKVCache

__all__ = ["ContinuousBatcher", "PagedKVCache", "ReplicaServer"]


def __getattr__(name):
    # the replica pulls in the RPC and store layers: `import
    # edl_tpu_torch.serving` stays light for engine-only users, and
    # `python -m edl_tpu_torch.serving.replica` finds it not yet imported
    if name == "ReplicaServer":
        from edl_tpu_torch.serving import replica
        return replica.ReplicaServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
