"""The placement diff of a live reshard (a copy of the JAX package's
``memstate/reshard.py``): which cached shards must move when the pod set
changes, and from where.

A shard's owner is the pod whose trainer produced it.  Ranks are stable
across resizes (survivors keep their order, joiners append), so a surviving
owner keeps its shards and only a departed owner's shards move, sourced
from its ring replica when that survives.  Everything here is a pure
function of its inputs, except :func:`collect_shard_map`, which reads the
live services' manifests.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from edl_tpu_torch.memstate import placement

logger = logging.getLogger(__name__)


@dataclass
class Move:
    """One shard whose owner departed: fetch it from ``src`` (the surviving
    ring replica; None when no copy survives) for ``new_owner``."""

    key: str
    nbytes: int
    old_owner: str
    new_owner: str
    src: str | None


@dataclass
class ReshardPlan:
    ranking: list[str] = field(default_factory=list)  # canonical new ranks
    moves: list[Move] = field(default_factory=list)
    kept: list[str] = field(default_factory=list)     # unchanged-owner keys
    moved_bytes: int = 0
    kept_bytes: int = 0
    shards_total: int = 0

    @property
    def total_bytes(self) -> int:
        return self.moved_bytes + self.kept_bytes

    @property
    def kept_fraction(self) -> float:
        """The fraction of cached bytes that do not move (1.0 on a grow)."""
        total = self.total_bytes
        return 1.0 if total == 0 else self.kept_bytes / total


def stable_ranking(old_pods, new_pods) -> list[str]:
    """Survivors in their old relative order, then joiners sorted."""
    old = list(dict.fromkeys(old_pods))
    new = set(new_pods)
    return [p for p in old if p in new] + sorted(p for p in new if p not in set(old))


def reshard_plan(old_pods, new_pods, shards: dict) -> ReshardPlan:
    """Diff the old and new placements of ``shards`` (``{key: entry}``, of
    which only ``owner`` and ``nbytes`` are read).  A shard moves iff its
    owner departed; its new owner takes the departed owner's rank in the
    canonical new ranking (wrapping when the world shrank)."""
    old = list(dict.fromkeys(old_pods))
    ranking = stable_ranking(old, new_pods)
    new_set = set(ranking)
    old_rank = {p: i for i, p in enumerate(old)}
    plan = ReshardPlan(ranking=ranking)
    for key in sorted(shards):
        ent = shards[key]
        owner = ent["owner"]
        nbytes = int(ent.get("nbytes", 0))
        plan.shards_total += 1
        if owner in new_set:
            plan.kept.append(key)
            plan.kept_bytes += nbytes
            continue
        seat = old_rank.get(owner, 0) % max(1, len(ranking))
        replica = placement.replica_for(owner, old)
        plan.moves.append(Move(key=key, nbytes=nbytes, old_owner=owner,
                               new_owner=ranking[seat] if ranking else "",
                               src=replica if replica in new_set else None))
        plan.moved_bytes += nbytes
    return plan


def collect_shard_map(store, job_id: str, endpoints: dict[str, str] | None = None) -> dict:
    """The manifests of every live cache advert at the committed step,
    owner-held sets only: ``{key: {"owner", "nbytes"}}``.  An unreachable
    peer contributes nothing, as it would at restore time."""
    from edl_tpu_torch.memstate import advert
    from edl_tpu_torch.rpc.client import RpcClient

    committed = advert.read_committed_step(store, job_id)
    if committed is None:
        return {}
    if endpoints is None:
        endpoints = advert.list_adverts(store, job_id)
    shards: dict = {}
    for pod, ep in endpoints.items():
        client = RpcClient(ep)
        try:
            listing = client.call("cache_manifest")
        except Exception as e:  # noqa: BLE001 — a dead peer contributes nothing
            logger.debug("manifest probe of %s failed (%s)", pod[:8], e)
            continue
        finally:
            client.close()
        for owner, info in listing.items():
            if owner != pod or info.get("step") != committed:
                continue  # a replica copy, or a stale set
            for key, ent in info["shards"].items():
                shards[key] = {"owner": owner, "nbytes": int(ent.get("nbytes", 0))}
    return shards
