"""The in-memory peer checkpoint cache and the delta replication plane (a
port of the JAX package's ``memstate``).

The launcher hosts a :class:`~edl_tpu_torch.memstate.service.StateCacheService`
that outlives every trainer; a trainer tees each committed checkpoint into
it (``tee.py``), streams delta records of the changed shards to it and to
the pod's ring replica (``delta.py``), and restores from it before storage
(``restore.py``).  Every miss falls back to the storage checkpoint: the
cache can make a restore faster, never less safe.  The shard records, the
RPC methods and the store records are the JAX package's, so a torch trainer
uses a JAX launcher's service and the reverse.
"""

from __future__ import annotations

from edl_tpu_torch.utils import constants


def enabled() -> bool:
    """``EDL_TPU_MEMSTATE=0`` turns the whole subsystem off."""
    return constants.memstate()


def delta_enabled() -> bool:
    """Delta replication rides the cache: on when the cache is on and
    ``EDL_TPU_DELTA_EVERY`` > 0."""
    return enabled() and constants.delta_every() > 0
