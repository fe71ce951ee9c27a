"""Process-wide metrics registry: counters, gauges, bounded reservoirs (a
copy of ``repro/obs/metrics.py``: identical observation streams give
identical snapshots in both packages).

Every subsystem that used to keep its own ad-hoc numbers (the trainer's
loss prints, ``TieredEmbeddingStore.stats``, the serving engine's
latency list) now registers **labeled series** here, so one snapshot at
end-of-run captures the whole resource story the paper's tables argue
about.

Series identity is ``name`` plus a sorted label set (``arch``, ``mesh``,
``bits``, ...), rendered ``name{k=v,...}`` in snapshots (prometheus
style). Three instrument kinds:

  * ``Counter`` — monotone float; ``inc(n)``.
  * ``Gauge`` — last-write-wins float; ``set(v)``.
  * ``Histogram`` — a **bounded reservoir** (Vitter's algorithm R with a
    deterministic per-series PRNG): O(capacity) memory regardless of
    stream length, exact percentiles while ``count <= capacity``,
    uniform-sample estimates after. ``count``/``sum``/``min``/``max``
    stay exact forever. This is what fixes the serving engine's
    linearly-growing latency list.

``snapshot()`` returns plain JSON-able dicts; ``diff(before, after)``
subtracts counters and histogram counts — the primitive nightly gates
and soak monitors window on.
"""

from __future__ import annotations

import random
import threading
import zlib

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "reset_registry", "diff", "series_key"]


def series_key(name: str, labels: dict | None = None) -> str:
    """Canonical series id: ``name`` or ``name{k=v,...}`` (sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded-reservoir distribution tracker (see module docstring).

    The reservoir PRNG is seeded from the series key, so a replayed run
    produces a bit-identical snapshot — determinism is part of the
    telemetry contract, same as everywhere else in this repo.
    """

    __slots__ = ("capacity", "count", "total", "vmin", "vmax", "_buf",
                 "_rng")

    def __init__(self, capacity: int = 1024, *, seed: int | str = 0):
        if capacity < 1:
            raise ValueError(f"reservoir capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._buf: list[float] = []
        if isinstance(seed, str):
            seed = zlib.crc32(seed.encode())
        self._rng = random.Random(seed)

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        if x < self.vmin:
            self.vmin = x
        if x > self.vmax:
            self.vmax = x
        if len(self._buf) < self.capacity:
            self._buf.append(x)
        else:
            # algorithm R: keep each of the n seen values with prob cap/n
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self._buf[j] = x

    def percentile(self, q: float) -> float:
        """q in [0, 100]; nearest-rank over the reservoir sample."""
        if not self._buf:
            return 0.0
        s = sorted(self._buf)
        idx = min(int(len(s) * q / 100.0), len(s) - 1)
        return s[idx]

    def snapshot(self) -> dict:
        return {"count": self.count,
                "sum": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "p50": self.percentile(50),
                "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Get-or-create registry of labeled series (thread-safe creation).

    Instrument mutation itself is unlocked: counters/gauges are single
    float writes (atomic enough under the GIL for telemetry), and the
    hot paths that feed them are single-writer by construction.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, table: dict, key: str, make):
        obj = table.get(key)
        if obj is None:
            with self._lock:
                obj = table.setdefault(key, make())
        return obj

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, series_key(name, labels), Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, series_key(name, labels), Gauge)

    def histogram(self, name: str, capacity: int = 1024,
                  **labels) -> Histogram:
        key = series_key(name, labels)
        return self._get(self._histograms, key,
                         lambda: Histogram(capacity, seed=key))

    # -- snapshots ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain JSON-able view: the summary schema's metric sections."""
        with self._lock:
            return {
                "counters": {k: c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {k: h.snapshot()
                               for k, h in sorted(self._histograms.items())},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


def diff(before: dict, after: dict) -> dict:
    """Windowed view between two ``snapshot()`` dicts.

    Counters and histogram counts subtract (series absent from
    ``before`` diff against zero); gauges report ``after``'s value —
    they are instantaneous, not cumulative.
    """
    out = {"counters": {}, "gauges": dict(after.get("gauges", {})),
           "histograms": {}}
    bc = before.get("counters", {})
    for k, v in after.get("counters", {}).items():
        out["counters"][k] = v - bc.get(k, 0.0)
    bh = before.get("histograms", {})
    for k, h in after.get("histograms", {}).items():
        prev = bh.get(k, {})
        out["histograms"][k] = dict(h)
        out["histograms"][k]["count"] = h["count"] - prev.get("count", 0)
        out["histograms"][k]["sum"] = h["sum"] - prev.get("sum", 0.0)
    return out


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every instrumented seam writes to."""
    return _DEFAULT


def reset_registry() -> None:
    """Drop all series on the process registry (test isolation)."""
    _DEFAULT.reset()
