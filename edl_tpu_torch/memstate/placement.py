"""Replica placement of the peer checkpoint cache (a copy of the JAX
package's ``memstate/placement.py``): a pod's cached shard-set replicates to
exactly one other pod, chosen on the consistent-hash ring, so one pod loss
never empties the cache and a membership change moves only the placements
that touched the changed pod."""

from __future__ import annotations

from edl_tpu_torch.coord.consistent_hash import ConsistentHash


def replica_for(owner: str, pods: list[str]) -> str | None:
    """The pod that holds ``owner``'s replica set, or None when ``owner``
    is the only pod.  A pure function of the pod set."""
    return ConsistentHash(sorted(set(pods))).get_replica(owner, exclude=owner)
