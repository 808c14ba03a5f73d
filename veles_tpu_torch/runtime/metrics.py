"""Metrics core: a Counter in a process-global registry and its
Prometheus text exposition (the counter half of
veles_tpu/runtime/metrics.py, which holds no JAX, cut to what the port
sets so far: the StepCache's capture counters, by program, and the
trainer's anomaly and walk-back counters).

Host-side only: nothing here runs inside a captured step.  Left out
until a slice sets them: gauges, histograms, the label cardinality cap,
the span ring and its Chrome-trace export.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple


class Counter:
    """Monotonic count per label-value tuple: ``inc()`` on a label-less
    counter, ``labels(program="train").inc()`` on a labelled one."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}  # guarded-by: self._lock

    def labels(self, **kv) -> "_Series":
        if set(kv) != set(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}, "
                             f"got {tuple(kv)}")
        return _Series(self, tuple(str(kv[n]) for n in self.labelnames))

    def inc(self, amount: float = 1.0) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled {self.labelnames}; "
                             "call .labels(...) first")
        self._add((), amount)

    @property
    def value(self) -> float:
        return self._get(())

    def _add(self, key, amount) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def _get(self, key) -> float:
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self):
        with self._lock:
            return sorted(self._values.items())


class _Series:
    """One label-value tuple of a labelled :class:`Counter`."""

    __slots__ = ("_counter", "_key")

    def __init__(self, counter: Counter, key: Tuple[str, ...]):
        self._counter = counter
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._counter._add(self._key, amount)

    @property
    def value(self) -> float:
        return self._counter._get(self._key)


class MetricsRegistry:
    """Named counters in registration order.  Registering a name again
    returns the existing counter (trainers and caches are built many
    times per process); other labels for that name raise."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Counter] = {}  # guarded-by: self._lock

    def counter(self, name: str, help: str,
                labels: Tuple[str, ...] = ()) -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help, labels)
            elif m.labelnames != tuple(labels):
                raise ValueError(f"metric {name!r} already registered with "
                                 f"labels {m.labelnames}")
            return m

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            lines += [f"# HELP {m.name} {m.help}", f"# TYPE {m.name} {m.kind}"]
            for key, v in m.samples():
                pairs = ",".join(f'{n}="{k}"'
                                 for n, k in zip(m.labelnames, key))
                lines.append(f"{m.name}{{{pairs}}} {v:g}" if pairs
                             else f"{m.name} {v:g}")
        return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process registry."""
    return _REGISTRY
