"""Dependency-free, thread-safe metrics: Counter / Gauge / Histogram
with labels, rendered in the Prometheus text exposition format
(version 0.0.4 — the format every Prometheus-lineage scraper speaks).

A copy of the JAX package's ``obs/metrics.py``: names, help strings,
buckets and the rendered text are the same to the byte, so the JAX-side
aggregator and rules read a port process's page unchanged.

Design mirrors the prometheus_client idiom without the dependency:
instruments are get-or-created on a :class:`Registry` (re-registering
the same name with the same spec returns the existing instrument, so
module-level declarations are import-order safe; a *different* spec
raises), ``labels(...)`` returns a per-label-set child, and every
mutation is lock-guarded so hot paths (rpc handlers, the train loop)
can record from any thread.  :func:`parse_exposition` is the inverse
of :meth:`Registry.render`, used by the test suite and the CI smoke
to assert on scraped output instead of string-grepping it.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0, math.inf)

# elastic resizes span ~0.1 s (unit harness) to minutes (real pods)
RESIZE_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                  120.0, 300.0, math.inf)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _fmt(v: float) -> str:
    v = float(v)
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:
        return "NaN"
    return repr(v)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class _Value:
    """One numeric series (a counter or gauge child)."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class _HistogramValue:
    """One histogram child: per-bucket counts + running sum."""

    __slots__ = ("_lock", "_buckets", "_counts", "_sum")

    def __init__(self, buckets: tuple[float, ...]):
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._counts[bisect_left(self._buckets, value)] += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        """(per-bucket counts, sum, total count) — a consistent view."""
        with self._lock:
            counts = list(self._counts)
            return counts, self._sum, sum(counts)

    @property
    def count(self) -> int:
        return self.snapshot()[2]

    @property
    def sum(self) -> float:
        return self.snapshot()[1]


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass labels positionally or by name, not both")
            try:
                values = tuple(kv.pop(n) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"{self.name}: missing label {e}") from None
            if kv:
                raise ValueError(f"{self.name}: unknown labels {sorted(kv)}")
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}, "
                             f"got {values!r}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
            return child

    def _unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} requires labels {self.labelnames}; "
                f"use .labels(...)")
        return self.labels()

    def _sorted_children(self):
        with self._lock:
            return sorted(self._children.items())

    def _label_str(self, values: tuple[str, ...],
                   extra: tuple[tuple[str, str], ...] = ()) -> str:
        pairs = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(self.labelnames, values)]
        pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def _render_into(self, lines: list[str]) -> None:
        lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        self._render_samples(lines)

    def _render_samples(self, lines: list[str]) -> None:
        for values, child in self._sorted_children():
            lines.append(
                f"{self.name}{self._label_str(values)} {_fmt(child.value)}")


class Counter(_Metric):
    """Monotonically increasing count (name it ``*_total``)."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    @property
    def value(self) -> float:
        return self._unlabeled().value


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        super().inc(amount)

    def set(self, value):  # noqa: ARG002 — counters never go down
        raise AttributeError("counters cannot be set; use inc()")


class Gauge(_Metric):
    """A value that can go up and down."""

    kind = "gauge"

    def _new_child(self):
        return _Value()

    def set(self, value: float) -> None:
        self._unlabeled().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(-amount)

    @property
    def value(self) -> float:
        return self._unlabeled().value


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: ``le`` buckets
    are cumulative, ``+Inf`` always present, plus ``_sum``/``_count``)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        buckets = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not buckets or buckets[-1] != math.inf:
            buckets = buckets + (math.inf,)
        self.buckets = buckets

    def _new_child(self):
        return _HistogramValue(self.buckets)

    def observe(self, value: float) -> None:
        self._unlabeled().observe(value)

    @property
    def count(self) -> int:
        return self._unlabeled().count

    @property
    def sum(self) -> float:
        return self._unlabeled().sum

    def _render_samples(self, lines: list[str]) -> None:
        for values, child in self._sorted_children():
            counts, total, count = child.snapshot()
            acc = 0
            for le, c in zip(self.buckets, counts):
                acc += c
                ls = self._label_str(values, extra=(("le", _fmt(le)),))
                lines.append(f"{self.name}_bucket{ls} {_fmt(acc)}")
            ls = self._label_str(values)
            lines.append(f"{self.name}_sum{ls} {_fmt(total)}")
            lines.append(f"{self.name}_count{ls} {_fmt(count)}")


class Registry:
    """Named instruments + text exposition.  One process-wide default
    (:data:`REGISTRY`) serves the instrumented framework; tests build
    private instances for byte-exact assertions."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if (type(m) is not cls
                        or m.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}{m.labelnames}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        """The Prometheus text page: metrics sorted by name, children by
        label values — deterministic, so scrapes diff cleanly."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            m._render_into(lines)
        return "\n".join(lines) + "\n" if lines else ""


REGISTRY = Registry()


def counter(name, help="", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets)


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$')
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_exposition(text: str) -> dict:
    """Inverse of :meth:`Registry.render`: ``{(name, ((label, value),
    ...)): float}`` for every sample line (``_bucket``/``_sum``/
    ``_count`` appear as their own sample names; label pairs are sorted
    so lookups don't depend on exposition order).  Raises ValueError on
    a malformed non-comment line — the CI smoke uses this as the
    'serves VALID Prometheus text' check."""
    out: dict[tuple[str, tuple[tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labelstr, value = m.groups()
        labels: tuple[tuple[str, str], ...] = ()
        if labelstr:
            labels = tuple(sorted((k, _unescape_label(v))
                                  for k, v in _LABEL_PAIR_RE.findall(labelstr)))
        out[(name, labels)] = float(value)  # float() accepts +Inf/NaN
    return out
