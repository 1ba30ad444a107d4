"""The part of the JAX package's error hierarchy that the port uses: its
base classes, the cluster, store, registration, serving (admission
overload included) and data-plane errors, and the wire round trip of ``utils/exceptions.py``.

A server sends an error as ``{"type": <class name>, "detail": ...}``; the
client raises the class of that name, so a store error reaches the
caller with the type the JAX server raised.
"""

from __future__ import annotations

import re
import traceback


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


class EdlRegisterError(EdlRetryableError):
    """TTL-leased registration could not be established/refreshed."""


class EdlUnavailableError(EdlRetryableError):
    """This server cannot take or finish the work (draining, stopped
    mid-generation) — try another replica or retry later."""


class EdlOverloadedError(EdlRetryableError):
    """Admission control rejected the request (queue full, rate limit).
    Carries ``retry_after`` seconds; only the (type, detail) pair crosses
    the wire, so the constructor recovers it from a ``retry_after=N``
    token in the detail, which the gateway writes there."""

    def __init__(self, detail: str = "", retry_after: float | None = None):
        super().__init__(detail)
        if retry_after is None:
            m = re.search(r"retry_after=([0-9.]+)", detail)
            retry_after = float(m.group(1)) if m else 1.0
        self.retry_after = float(retry_after)


class EdlStopIteration(EdlError):
    """Remote signals end-of-data (maps to StopIteration client-side)."""


class EdlDataError(EdlRetryableError):
    """Data-server state not ready, or a reader generation failed (a
    producer could not read a file; the generation was superseded)."""


class EdlReaderGoneError(EdlTableError):
    """The addressed DataService has no state for this reader generation (a
    successor leader with no or a torn journal).  Readers reattach, re-seeding
    the generation from their own checkpoint and claimed spans, instead of
    plain retrying: a retry alone would loop on the same answer."""


class EdlStreamError(EdlError):
    """Streamed-response protocol violation (sequence gap or duplicate, short
    stream, or a plain answer where frames were expected).  Not retryable on
    the same connection: the two ends have desynchronised and the transport
    is torn down."""


_REGISTRY = {cls.__name__: cls for cls in (EdlError, EdlRetryableError, EdlCoordError,
                                            EdlTableError, EdlInternalError, EdlRegisterError,
                                            EdlUnavailableError, EdlStopIteration, EdlDataError,
                                            EdlReaderGoneError, EdlStreamError,
                                            EdlOverloadedError)}


def serialize(exc: BaseException) -> dict:
    """Exception -> wire dict: a framework error by its class name, any
    other as :class:`EdlInternalError` carrying the traceback."""
    if isinstance(exc, EdlError):
        return {"type": type(exc).__name__, "detail": str(exc)}
    return {"type": "EdlInternalError",
            "detail": "".join(traceback.format_exception(exc))}


def deserialize(status: dict | None) -> None:
    """Wire dict -> raise the typed exception; no-op on OK.  A type the
    port does not copy is raised as :class:`EdlInternalError`, as the JAX
    client does for a name it does not know."""
    if not status:
        return
    cls = _REGISTRY.get(status.get("type", ""), EdlInternalError)
    raise cls(status.get("detail", ""))
