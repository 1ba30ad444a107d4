"""Consistent hash ring with virtual nodes and copy-on-write updates (a
copy of the JAX package's ``coord/consistent_hash.py``: the same MD5
placement, so both packages give every key the same owner).

Reference behavior (python/edl/discovery/consistent_hash.py:21-141):
300 virtual nodes per physical node, MD5 placement, lock-free reads via
copy-on-write for a single-writer/multi-reader pattern.  Used to shard
service names across discovery servers (balance_table.py:519-535).
"""

from __future__ import annotations

import bisect
import hashlib
import threading


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class _Ring:
    """Immutable snapshot: sorted virtual-node positions → node names."""

    __slots__ = ("points", "owners", "nodes")

    def __init__(self, nodes: list[str], vnodes: int):
        pairs = sorted(
            (_hash(f"{node}#{i}"), node) for node in nodes for i in range(vnodes)
        )
        self.points = [p for p, _ in pairs]
        self.owners = [n for _, n in pairs]
        self.nodes = sorted(nodes)

    def lookup(self, key: str) -> str | None:
        if not self.points:
            return None
        idx = bisect.bisect_right(self.points, _hash(key)) % len(self.points)
        return self.owners[idx]


class ConsistentHash:
    def __init__(self, nodes: list[str] | None = None, vnodes: int = 300):
        self._vnodes = vnodes
        self._lock = threading.Lock()  # writers only; readers grab the snapshot
        self._ring = _Ring(list(nodes or []), vnodes)

    @property
    def nodes(self) -> list[str]:
        return list(self._ring.nodes)

    def add_node(self, node: str) -> None:
        with self._lock:
            if node not in self._ring.nodes:
                self._ring = _Ring(self._ring.nodes + [node], self._vnodes)

    def remove_node(self, node: str) -> None:
        with self._lock:
            if node in self._ring.nodes:
                self._ring = _Ring([n for n in self._ring.nodes if n != node], self._vnodes)

    def set_nodes(self, nodes: list[str]) -> None:
        with self._lock:
            self._ring = _Ring(list(dict.fromkeys(nodes)), self._vnodes)

    def get_node(self, key: str) -> str | None:
        """Owner of ``key`` (reference get_node_nodes, :138-141)."""
        return self._ring.lookup(key)

    def get_replica(self, key: str, exclude: str) -> str | None:
        """Owner of ``key`` among nodes other than ``exclude`` — the
        replica seat for data whose primary is ``exclude`` (memstate
        peer checkpoint cache: a pod's shards replicate to its ring
        neighbor, so losing the pod never loses its cache entries).
        Deterministic for a given node set, and consistent-hash stable:
        membership changes only move placements that hashed to the
        changed nodes.  None when no other node exists."""
        ring = self._ring  # one snapshot: lookups must agree mid-update
        others = [n for n in ring.nodes if n != exclude]
        if not others:
            return None
        # salt the key until the placement leaves ``exclude``; the salt
        # cap only guards pathological hash streaks — the deterministic
        # sorted-order fallback keeps the result total either way
        for salt in range(64):
            node = ring.lookup(f"{key}#replica{salt}" if salt else key)
            if node != exclude:
                return node
        return others[0]
