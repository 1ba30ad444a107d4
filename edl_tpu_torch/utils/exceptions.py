"""The part of the JAX package's error hierarchy that the cluster model
uses (a copy of ``utils/exceptions.py``'s base classes and
``EdlTableError``)."""

from __future__ import annotations


class EdlError(Exception):
    """Base class for all framework errors."""


class EdlRetryableError(EdlError):
    """Base for errors that callers may retry (transient cluster states)."""


class EdlTableError(EdlRetryableError):
    """A coordination-store table is missing or malformed."""
