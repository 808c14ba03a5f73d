"""Metrics core: Counter, Gauge and fixed-bucket Histogram in a
process-global registry, their Prometheus text exposition, the
time-windowed view of a histogram the rolling SLO windows read, and the
span ring of host-side request timelines with its Chrome-trace export
(``GET /trace.json``, ``--trace-out``) — veles_tpu/runtime/metrics.py,
which holds no JAX, cut to what the port sets: the StepCache's capture
counters, the trainer's anomaly and walk-back counters, the serving
engine's request, shed, preemption and swap counters, its latency
histograms, the SLO burn gauge, the memory ledger's gauges and the
deploy control plane's, the fleet router's and the job manager's —
and the scrape-side parsers the fleet router reads its replicas'
``/metrics`` text with (:func:`parse_samples`,
:func:`cumulative_buckets`).

Host-side only: nothing here runs inside a captured step.  Left out
until a slice reads it: the label cardinality cap (every label here
takes a handful of values: program kind, request outcome, priority
class, slo name, memory component, fleet replica).
"""

from __future__ import annotations

import collections
import itertools
import json
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..config import root

#: default latency buckets (seconds), the JAX package's
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _Metric:
    """Name, help, label names and one child per label-value tuple (the
    empty tuple is a label-less metric's only child)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        # reentrant: making a child allocates, and a garbage collection
        # there can run a finalizer that labels this metric again on the
        # same thread (runtime/memory.py drop_stamped_components)
        self._lock = threading.RLock()
        self._children: Dict[Tuple[str, ...], object] = {}  # guarded-by: self._lock

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}, "
                             f"got {tuple(kv)}")
        return self._child(tuple(str(kv[n]) for n in self.labelnames))

    def _child(self, key):
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled {self.labelnames}; "
                             "call .labels(...) first")
        return self._child(())

    def samples(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class _Value:
    """A counter's or gauge's value for one label tuple."""

    __slots__ = ("_lock", "_v", "_monotonic")

    def __init__(self, monotonic: bool):
        self._lock = threading.Lock()
        self._v = 0.0  # guarded-by: self._lock
        self._monotonic = monotonic

    def inc(self, amount: float = 1.0) -> None:
        if self._monotonic and amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._v += amount

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Counter(_Metric):
    """Monotonic count: ``inc()`` on a label-less counter,
    ``labels(program="train").inc()`` on a labelled one."""

    kind = "counter"

    def _make_child(self):
        return _Value(monotonic=True)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Metric):
    """Point-in-time value (``set``)."""

    kind = "gauge"

    def _make_child(self):
        return _Value(monotonic=False)

    def set(self, v: float) -> None:
        self._default().set(v)

    @property
    def value(self) -> float:
        return self._default().value


class _HistogramChild:
    __slots__ = ("_lock", "uppers", "_counts", "_sum", "_count")

    def __init__(self, uppers):
        self._lock = threading.Lock()
        self.uppers = uppers            # finite upper bounds, ascending
        self._counts = [0] * (len(uppers) + 1)  # guarded-by: self._lock
        self._sum = 0.0  # guarded-by: self._lock
        self._count = 0  # guarded-by: self._lock

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for u in self.uppers:
            if v <= u:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts incl. +Inf, sum, count) under one lock."""
        with self._lock:
            return list(self._counts), self._sum, self._count


class Histogram(_Metric):
    """Fixed-bucket distribution (Prometheus cumulative buckets)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets
                                    if float(b) != float("inf")))
        if not self.buckets:
            raise ValueError("histogram needs at least one finite bucket")
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def aggregate_snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts incl. +Inf, sum, count) summed over every
        label tuple — the view a rolling window snapshots."""
        counts = [0] * (len(self.buckets) + 1)
        total, n = 0.0, 0
        for _key, child in self.samples():
            c, s, cnt = child.snapshot()
            for i, v in enumerate(c):
                counts[i] += v
            total += s
            n += cnt
        return counts, total, n


class MetricsRegistry:
    """Named metrics in registration order.  Registering a name again
    returns the existing metric (engines, trainers and caches are built
    many times per process); another kind or other labels raise."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: self._lock

    def _register(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, tuple(labels), **kw)
            elif type(m) is not cls or m.labelnames != tuple(labels):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind} with labels {m.labelnames}")
            return m

    def counter(self, name: str, help: str,
                labels: Tuple[str, ...] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str,
              labels: Tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str,
                  labels: Tuple[str, ...] = (),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            lines += [f"# HELP {m.name} {m.help}", f"# TYPE {m.name} {m.kind}"]
            for key, child in m.samples():
                pairs = [f'{n}="{k}"' for n, k in zip(m.labelnames, key)]
                if m.kind != "histogram":
                    lab = "{" + ",".join(pairs) + "}" if pairs else ""
                    lines.append(f"{m.name}{lab} {child.value:g}")
                    continue
                counts, total, count = child.snapshot()
                acc = 0
                for le, c in zip(m.buckets + (float("inf"),), counts):
                    acc += c
                    le_s = "+Inf" if le == float("inf") else f"{le:g}"
                    lab = ",".join(pairs + [f'le="{le_s}"'])
                    lines.append(f"{m.name}_bucket{{{lab}}} {acc}")
                lab = "{" + ",".join(pairs) + "}" if pairs else ""
                lines.append(f"{m.name}_sum{lab} {total:g}")
                lines.append(f"{m.name}_count{lab} {count}")
        return "\n".join(lines) + "\n"


class HistogramWindow:
    """Time-windowed view over a cumulative histogram: a bounded ring of
    bucket snapshots taken at slice boundaries, so quantiles over "the
    last ``window_s`` seconds" come out of the same fixed buckets
    (veles_tpu/runtime/metrics.py:437-535, unchanged).

    ``source`` is a zero-arg callable returning the Histogram (or None
    before it is registered).  Rotation is lazy: every read (or an
    explicit :meth:`tick`) appends a snapshot once a slice elapsed.
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, source, window_s: float, slices: int = 12,
                 clock=time.monotonic):
        self._source = source
        self.window_s = max(float(window_s), 1e-9)
        self.slices = max(int(slices), 1)
        self.slice_s = self.window_s / self.slices
        self._clock = clock
        self._lock = threading.Lock()
        # ring of (t, cumulative counts incl. +Inf, sum, count); one
        # extra slot keeps a baseline just outside the window
        self._ring: collections.deque = collections.deque(
            maxlen=self.slices + 1)  # guarded-by: self._lock

    def _snap(self):
        hist = self._source()
        if hist is None:
            return None, [0], 0.0, 0
        counts, total, n = hist.aggregate_snapshot()
        return hist, counts, total, n

    def tick(self) -> bool:
        """Rotate if a slice boundary passed; returns whether a snapshot
        was appended."""
        now = self._clock()
        with self._lock:
            if self._ring and now - self._ring[-1][0] < self.slice_s:
                return False
            _hist, counts, total, n = self._snap()
            self._ring.append((now, counts, total, n))
            return True

    def delta(self):
        """(histogram, cumulative ``(le, count)`` pairs, count, sum) of
        the observations inside the window: current state minus the
        newest snapshot at least ``window_s`` old (or the oldest held)."""
        self.tick()
        now = self._clock()
        hist, counts, total, n = self._snap()
        if hist is None:
            return None, [], 0, 0.0
        base = None
        with self._lock:
            for t, c, s, cnt in self._ring:
                if base is None or t <= now - self.window_s:
                    base = (c, s, cnt)
        bc, bs, bn = base if base is not None \
            else ([0] * len(counts), 0.0, 0)
        if len(bc) != len(counts):      # ring predates the registration
            bc = [0] * len(counts)
        pairs, acc = [], 0
        for u, cur, old in zip(hist.buckets, counts, bc):
            acc += cur - old
            pairs.append((u, float(acc)))
        pairs.append((float("inf"),
                      float(acc + counts[-1] - bc[-1])))
        return hist, pairs, n - bn, total - bs


def fraction_over(pairs, threshold: float) -> float:
    """Fraction of observations above ``threshold`` from cumulative
    ``(le, count)`` pairs, interpolating linearly inside the bucket the
    threshold lands in — the burn-rate numerator of the SLO windows."""
    pairs = sorted(pairs)
    if not pairs or pairs[-1][1] <= 0:
        return 0.0
    total = pairs[-1][1]
    prev_le, prev_c = 0.0, 0.0
    for le, c in pairs:
        if threshold <= le:
            if le == float("inf"):
                return (total - prev_c) / total
            width = le - prev_le
            frac = (threshold - prev_le) / width if width > 0 else 1.0
            at = prev_c + frac * (c - prev_c)
            return max(0.0, (total - at) / total)
        prev_le, prev_c = le, c
    return 0.0


def quantile_from_cumulative(pairs, q: float) -> float:
    """Quantile estimate from cumulative ``(le, count)`` pairs: linear
    interpolation inside the target bucket, the last finite bound for
    the +Inf bucket (Prometheus ``histogram_quantile`` semantics)."""
    pairs = sorted(pairs)
    if not pairs or pairs[-1][1] <= 0:
        return 0.0
    q = min(max(float(q), 0.0), 1.0)
    target = q * pairs[-1][1]
    prev_le, prev_c = 0.0, 0.0
    for le, c in pairs:
        if c >= target:
            if le == float("inf"):
                return prev_le
            width_c = c - prev_c
            frac = (target - prev_c) / width_c if width_c > 0 else 1.0
            return prev_le + frac * (le - prev_le)
        if le != float("inf"):
            prev_le = le
        prev_c = c
    return prev_le


# -- scrape side (veles_tpu/runtime/metrics.py:645-697) -----------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape_label(s: str) -> str:
    """One pass over the escapes (sequential replaces would misread a
    backslash before an ``n``)."""
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPES.get(m.group(1), "\\" + m.group(1)), s)


def parse_samples(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Prometheus exposition text -> ``(name, labels, value)`` samples;
    comment, blank and malformed lines are skipped."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, raw_labels, raw_v = m.groups()
        labels = {k: _unescape_label(v)
                  for k, v in _LABEL_RE.findall(raw_labels or "")}
        try:
            out.append((name, labels, float(raw_v)))
        except ValueError:
            continue
    return out


def cumulative_buckets(samples, name: str) -> List[Tuple[float, float]]:
    """A histogram's ``_bucket`` samples, summed over every label but
    ``le``, as sorted ``[(le, cumulative count)]``."""
    agg: Dict[float, float] = {}
    for n, labels, v in samples:
        if n != name + "_bucket" or "le" not in labels:
            continue
        le = float(labels["le"])
        agg[le] = agg.get(le, 0.0) + v
    return sorted(agg.items())


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process registry."""
    return _REGISTRY


# -- request timelines (veles_tpu/runtime/metrics.py:565-654) ----------------

_T0 = time.monotonic()
_TRACE_IDS = itertools.count(1)


def next_trace_id() -> int:
    """Process-unique track id for a request timeline (``next`` on an
    itertools.count is atomic under the GIL)."""
    return next(_TRACE_IDS)


def _us(t: float) -> float:
    return round((t - _T0) * 1e6, 1)


class SpanRing:
    """Bounded ring of completed host-side spans in Chrome trace event
    format: a serving day keeps only the most recent ``capacity`` spans,
    the window an operator pulls when something is slow now."""

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))  # guarded-by: self._lock

    def add(self, name: str, start_s: float, dur_s: float, *,
            cat: str = "host", tid: int = 0, args: Optional[dict] = None):
        """One complete ("X") span: ``start_s``/``dur_s`` in
        ``time.monotonic()`` seconds."""
        ev = {"name": str(name), "cat": cat, "ph": "X",
              "ts": _us(start_s), "dur": round(max(dur_s, 0.0) * 1e6, 1),
              "pid": 0, "tid": int(tid)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def add_instant(self, name: str, at_s: float, *, cat: str = "event",
                    tid: int = 0, args: Optional[dict] = None):
        ev = {"name": str(name), "cat": cat, "ph": "i", "s": "g",
              "ts": _us(at_s), "pid": 0, "tid": int(tid)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return sorted(self._events, key=lambda e: e["ts"])

    def chrome_trace(self) -> dict:
        """The ``chrome://tracing`` / Perfetto document (the ``GET
        /trace.json`` body)."""
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": "veles_tpu_torch"}}]
        return {"traceEvents": meta + self.snapshot(),
                "displayTimeUnit": "ms"}


_SPANS_LOCK = threading.Lock()
_SPANS: Optional[SpanRing] = None  # guarded-by: _SPANS_LOCK


def span_ring() -> SpanRing:
    """The process span ring, sized by ``root.common.observe.span_ring``
    at first use."""
    global _SPANS
    with _SPANS_LOCK:
        if _SPANS is None:
            _SPANS = SpanRing(
                int(root.common.observe.get("span_ring", 512)))
        return _SPANS


def write_chrome_trace(path: str) -> str:
    """``--trace-out FILE``: the span ring as Chrome-trace JSON (open it
    in Perfetto)."""
    with open(path, "w") as f:
        json.dump(span_ring().chrome_trace(), f, default=repr)
    return path
