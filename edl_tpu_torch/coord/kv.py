"""KV-store interface and the record type its clients return (the part of
the JAX package's ``coord/kv.py`` that a trainer uses: leases, the
put-if-absent transaction and watches serve the launcher, not ported).

Semantics follow what the reference used from etcd3: flat keys, prefix
range reads with a store-wide revision, and a guarded put.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class KVRecord:
    key: str
    value: bytes
    revision: int = 0          # store revision of last modification
    lease_id: int = 0          # 0 = no lease


class KVStore:
    """Abstract coordination store."""

    def put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        raise NotImplementedError

    def get(self, key: str) -> Optional[KVRecord]:
        raise NotImplementedError

    def get_prefix(self, prefix: str) -> tuple[list[KVRecord], int]:
        """Returns (records sorted by key, store revision)."""
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def put_if_equals(self, guard_key: str, guard_value: bytes, key: str, value: bytes,
                      lease_id: int = 0) -> bool:
        """Write ``key`` iff ``guard_key`` currently holds ``guard_value``."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    @contextlib.contextmanager
    def scoped_deadline(self, seconds: float):
        """Bound this thread's time for ops inside the block (liveness
        beats use it: a missed beat is recoverable, a stalled step is
        not).  A no-op here; clients override it."""
        yield self
