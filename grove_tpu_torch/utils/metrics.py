"""Metrics registry + Prometheus text exposition — the metrics-server analog.

The reference exposes controller-runtime's Prometheus registry on a
configurable bind address (`operator/internal/controller/manager.go:94-96`,
chart `operator/charts/templates/service.yaml`). Here: a dependency-free
registry (counters, gauges, histograms with labels) rendered in Prometheus
text format, served by the manager's HTTP endpoints at /metrics.

Thread-safety: metric mutation happens on the reconcile thread while the
probe-server thread renders scrapes, so every metric guards its state with a
lock. Values render via repr() (full float precision) — %g-style shortening
corrupts counters past ~1e6.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field
from typing import Optional


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    """Full-precision float, integer-valued floats without the trailing .0."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


@dataclass
class Counter:
    name: str
    help: str
    _values: dict[tuple, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            lines.append(f"{self.name}{_fmt_labels(dict(key))} {_fmt_value(v)}")
        return lines


@dataclass
class Gauge:
    name: str
    help: str
    _values: dict[tuple, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            lines.append(f"{self.name}{_fmt_labels(dict(key))} {_fmt_value(v)}")
        return lines


@dataclass
class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    name: str
    help: str
    buckets: tuple = (0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)
    _counts: dict[tuple, list] = field(default_factory=dict)
    _sums: dict[tuple, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            idx = bisect.bisect_left(self.buckets, value)
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            snapshot = [
                (key, list(counts), self._sums[key])
                for key, counts in sorted(self._counts.items())
            ]
        for key, counts, total in snapshot:
            labels = dict(key)
            cum = 0
            for ub, c in zip(self.buckets, counts):
                cum += c
                lines.append(
                    f"{self.name}_bucket{_fmt_labels({**labels, 'le': f'{ub:g}'})} {cum}"
                )
            cum += counts[-1]
            lines.append(
                f"{self.name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} {cum}"
            )
            lines.append(f"{self.name}_sum{_fmt_labels(labels)} {_fmt_value(total)}")
            lines.append(f"{self.name}_count{_fmt_labels(labels)} {cum}")
        return lines


class Registry:
    """Thread-safe named-metric registry with text exposition."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help), Gauge)

    def histogram(
        self, name: str, help: str = "", buckets: Optional[tuple] = None
    ) -> Histogram:
        factory = lambda: Histogram(name, help, buckets or Histogram.buckets)  # noqa: E731
        return self._get_or_create(name, factory, Histogram)

    def _get_or_create(self, name, factory, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise ValueError(f"metric {name!r} already registered as {type(m).__name__}")
            return m

    def render_text(self) -> str:
        with self._lock:
            metrics = [self._metrics[name] for name in sorted(self._metrics)]
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"


# Default process-wide registry (controller-runtime's global registry analog).
DEFAULT_REGISTRY = Registry()
