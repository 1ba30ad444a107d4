"""Dapper-style distributed trace context (a copy of the JAX package's
``obs/context.py``: the wire, env and header forms are the same, so a
context crosses between the two packages either way).

A :class:`TraceContext` is the (trace_id, span_id, baggage) triple that
links causally-related events across processes: the gateway stamps one
per request, the launcher one per resize epoch, and every EDL1 RPC
carries the ambient context in its envelope (``rpc/client.py`` injects,
``rpc/server.py`` re-establishes), so a span emitted inside a handler —
or anything the handler calls: memstate fetch, coord kv ops, engine
submit — inherits the caller's trace_id.  ``edl-obs-dump --merge`` then
joins the per-process JSONL files back into one timeline by trace_id.

Ambient context is a :mod:`contextvars` variable, so concurrent handler
threads can never leak contexts into each other (a fresh thread starts
with no ambient context).  A process-wide *root* context
(``EDL_TPU_TRACE_CONTEXT``, set by the launcher when it spawns
trainers) is the fallback every thread sees when no explicit context is
active — that is how a whole trainer process joins its resize epoch's
trace.

The tracer (:mod:`edl_tpu_torch.obs.trace`) attaches ``trace_id`` /
``span_id`` / ``parent_id`` to every emitted event when a context is
ambient; with no context, events are unchanged — tracing without
distributed context keeps working exactly as before.
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import os
import uuid
from contextlib import contextmanager

ENV_VAR = "EDL_TPU_TRACE_CONTEXT"


def _trace_id() -> str:
    return uuid.uuid4().hex                # 128-bit


def _span_id() -> str:
    return uuid.uuid4().hex[:16]           # 64-bit


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Immutable: deriving a child produces a NEW context, so a context
    captured by one request/thread can never be mutated by another."""

    trace_id: str
    span_id: str
    parent_id: str | None = None
    baggage: dict = dataclasses.field(default_factory=dict)

    def child(self) -> "TraceContext":
        """Same trace, fresh span whose parent is this span."""
        return TraceContext(self.trace_id, _span_id(), self.span_id,
                            dict(self.baggage))

    # -- wire form (EDL1 RPC envelope key "tc") ------------------------------
    def to_wire(self) -> dict:
        d: dict = {"t": self.trace_id, "s": self.span_id}
        if self.baggage:
            d["b"] = dict(self.baggage)
        return d

    @staticmethod
    def from_wire(d) -> "TraceContext | None":
        """Tolerant: anything malformed → None (a bad peer must not be
        able to crash a handler by sending garbage context)."""
        if not isinstance(d, dict):
            return None
        t, s = d.get("t"), d.get("s")
        if not (isinstance(t, str) and t and isinstance(s, str) and s):
            return None
        b = d.get("b")
        return TraceContext(t, s,
                            baggage=dict(b) if isinstance(b, dict) else {})

    # -- env form (launcher -> spawned trainer processes) --------------------
    def to_env(self) -> str:
        return json.dumps(self.to_wire())

    @staticmethod
    def from_env_value(s: str) -> "TraceContext | None":
        try:
            return TraceContext.from_wire(json.loads(s))
        except ValueError:
            return None


def new_trace(**baggage) -> TraceContext:
    """A fresh root context: new trace_id, no parent."""
    return TraceContext(_trace_id(), _span_id(), None, dict(baggage))


# The ambient context.  contextvars, not threading.local: a fresh thread
# starts with the default (None) instead of inheriting whatever the
# spawning thread had active — exactly the no-leak property concurrent
# RPC handlers need.
_var: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "edl_tpu_trace_context", default=None)
_process_root: TraceContext | None = None


def current() -> TraceContext | None:
    """The active context: explicitly attached beats the process root."""
    ctx = _var.get()
    return ctx if ctx is not None else _process_root


def attach(ctx: TraceContext) -> contextvars.Token:
    """Low-level: make ``ctx`` ambient on THIS thread; pair with
    :func:`detach`.  Prefer :func:`use`."""
    return _var.set(ctx)


def detach(token: contextvars.Token) -> None:
    _var.reset(token)


@contextmanager
def use(ctx: TraceContext | None):
    """``with use(ctx): ...`` — ambient within the block; ``None`` is a
    no-op so call sites don't need to branch."""
    if ctx is None:
        yield None
        return
    token = _var.set(ctx)
    try:
        yield ctx
    finally:
        _var.reset(token)


def set_process_root(ctx: TraceContext | None) -> None:
    """Install the process-wide fallback context (every thread without
    an explicit context sees it)."""
    global _process_root
    _process_root = ctx


def install_from_env() -> TraceContext | None:
    """``EDL_TPU_TRACE_CONTEXT`` set (launcher spawning trainers into a
    resize epoch's trace) → install it as the process root."""
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    ctx = TraceContext.from_env_value(raw)
    if ctx is not None:
        set_process_root(ctx)
    return ctx
