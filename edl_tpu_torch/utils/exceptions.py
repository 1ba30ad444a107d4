"""The part of the JAX package's error hierarchy that the port uses: its
base classes, the cluster and store errors, and the wire round trip of
``utils/exceptions.py``.

A server sends an error as ``{"type": <class name>, "detail": ...}``; the
client raises the class of that name, so a store error reaches the
caller with the type the JAX server raised.
"""

from __future__ import annotations


class EdlError(Exception):
    """Base class for all framework errors."""


class EdlRetryableError(EdlError):
    """Base for errors that callers may retry (transient cluster states)."""


class EdlCoordError(EdlRetryableError):
    """Coordination-store communication failed."""


class EdlTableError(EdlRetryableError):
    """A coordination-store table is missing or malformed."""


class EdlInternalError(EdlError):
    """Unexpected server-side failure (carries remote traceback)."""


_REGISTRY = {cls.__name__: cls for cls in (EdlError, EdlRetryableError, EdlCoordError,
                                            EdlTableError, EdlInternalError)}


def deserialize(status: dict | None) -> None:
    """Wire dict -> raise the typed exception; no-op on OK.  A type the
    port does not copy is raised as :class:`EdlInternalError`, as the JAX
    client does for a name it does not know."""
    if not status:
        return
    cls = _REGISTRY.get(status.get("type", ""), EdlInternalError)
    raise cls(status.get("detail", ""))
