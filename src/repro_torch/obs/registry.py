"""Dependency-free metrics registry: counters, gauges, log-bucket histograms.

Every subsystem in this repo grew its own ad-hoc counters (frontend hit rate,
resilience shed/degrade tallies, supervisor trip/rollback counts) and every
latency claim so far has been a bare median.  This module is the one
substrate they all share:

* :class:`Counter` / :class:`Gauge` — monotone tallies and last-value samples;
* :class:`Histogram` — log-bucketed (geometric bucket edges), O(1) record,
  exact count/sum/min/max, percentile export from the bucket CDF.  Built for
  latencies spanning microseconds to seconds: relative bucket error is
  bounded by the growth factor (default 2**0.25 ~ 19%), independent of scale;
* :class:`MetricsRegistry` — get-or-create by name (``subsystem/metric``
  naming scheme, e.g. ``serve.frontend/queue_wait_s``), one injectable clock
  shared by everything hanging off it (timers, event logs, supervisors), and
  a :meth:`~MetricsRegistry.group` view that lets legacy ``counters`` dicts
  keep their exact shape while the values live in the registry.

No threads, no deps, no global state: a registry is just an object you pass
around (tests inject a fake clock; production passes nothing).
"""
from __future__ import annotations

import math
import time
from collections.abc import MutableMapping
from contextlib import contextmanager


class Counter:
    """Monotone-ish tally (float-valued so duration accumulators fit too)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name, self.value = name, 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self):
        v = self.value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-written value (queue depth, pressure, lr scale...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name, self.value = name, 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Log-bucketed histogram with percentile export.

    Bucket ``i`` covers ``[lo * growth**i, lo * growth**(i+1))``; values below
    ``lo`` land in an underflow bucket, values at or above ``hi`` in an
    overflow bucket.  ``percentile`` interpolates inside the hit bucket's
    geometric span, so the reported quantile is within one growth factor of
    the true one — the standard HDR-style tradeoff: O(1) memory per bucket,
    no sample retention.
    """

    __slots__ = ("name", "lo", "growth", "_log_g", "n_buckets", "counts",
                 "count", "sum", "min", "max")

    def __init__(self, name: str, lo: float = 1e-6, hi: float = 3600.0,
                 growth: float = 2.0 ** 0.25):
        assert lo > 0 and hi > lo and growth > 1.0
        self.name, self.lo, self.growth = name, lo, growth
        self._log_g = math.log(growth)
        self.n_buckets = int(math.ceil(math.log(hi / lo) / self._log_g))
        # [0] underflow, [1..n] log buckets, [n+1] overflow
        self.counts = [0] * (self.n_buckets + 2)
        self.count, self.sum = 0, 0.0
        self.min, self.max = math.inf, -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        self.count += 1
        self.sum += v
        self.min, self.max = min(self.min, v), max(self.max, v)
        if v < self.lo:
            self.counts[0] += 1
        else:
            i = int(math.log(v / self.lo) / self._log_g)
            self.counts[min(i, self.n_buckets) + 1] += 1

    def _edges(self, i: int) -> tuple[float, float]:
        """(low, high) value edges of physical bucket index i."""
        if i == 0:
            return 0.0, self.lo
        lo = self.lo * self.growth ** (i - 1)
        return lo, lo * self.growth

    def percentile(self, p: float) -> float | None:
        """p in [0, 100].  None on an empty histogram.  Exact at the recorded
        min/max endpoints; geometric interpolation inside the hit bucket."""
        if self.count == 0:
            return None
        if p <= 0:
            return self.min
        if p >= 100:
            return self.max
        target = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo, hi = self._edges(i)
                lo, hi = max(lo, self.min), min(hi, self.max)
                if lo <= 0 or hi <= lo:
                    return max(lo, 0.0)
                frac = (target - seen) / c
                return lo * (hi / lo) ** frac
            seen += c
        return self.max

    def snapshot(self, percentiles=(50, 90, 99)) -> dict:
        out = {"count": self.count,
               "sum": round(self.sum, 9),
               "min": None if self.count == 0 else self.min,
               "max": None if self.count == 0 else self.max,
               "mean": (self.sum / self.count) if self.count else None}
        for p in percentiles:
            v = self.percentile(p)
            out[f"p{p:g}"] = None if v is None else round(v, 9)
        return out


class CounterGroup(MutableMapping):
    """Dict-shaped view over a family of registry counters.

    The legacy subsystems keep their ``self.counters["requests"] += 1`` idiom
    and their ``stats()`` shapes; the values live in the registry under
    ``<prefix>/<key>``, so one snapshot sees every subsystem with one naming
    scheme.  New keys may be added by assignment (mirrors dict semantics);
    deleting keys is not supported (metrics don't disappear mid-run).
    """

    def __init__(self, registry: "MetricsRegistry", prefix: str, keys=()):
        self._reg, self._prefix = registry, prefix
        self._keys: list[str] = []
        for k in keys:
            self._counter(k)

    def _counter(self, key: str) -> Counter:
        if key not in self._keys:
            self._keys.append(key)
        return self._reg.counter(f"{self._prefix}/{key}")

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        return self._reg.counter(f"{self._prefix}/{key}").snapshot()

    def __setitem__(self, key: str, value) -> None:
        self._counter(key).value = float(value)

    def __delitem__(self, key: str):
        raise TypeError("metrics are append-only; cannot delete "
                        f"{self._prefix}/{key}")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


class MetricsRegistry:
    """Get-or-create metric store with one injectable clock.

    Naming scheme: ``subsystem/metric`` with dotted subsystem paths —
    ``serve.frontend/dispatches``, ``train.supervisor/guard_trips``,
    ``obs.compile/backend_compiles``.  Durations are seconds and suffixed
    ``_s``.  Re-requesting a name returns the same object; requesting it as a
    different type is an error (catches naming collisions early).
    """

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, lo: float = 1e-6, hi: float = 3600.0,
                  growth: float = 2.0 ** 0.25) -> Histogram:
        return self._get(name, Histogram, lo, hi, growth)

    def group(self, prefix: str, keys=()) -> CounterGroup:
        return CounterGroup(self, prefix, keys)

    @contextmanager
    def timer(self, name: str):
        """Record one duration sample (registry clock) into histogram
        ``name``."""
        h = self.histogram(name)
        t0 = self.clock()
        yield h
        h.record(self.clock() - t0)

    def snapshot(self, prefix: str = "") -> dict:
        """Flat {name: value-or-histogram-dict}, optionally prefix-filtered.
        This is the JSONL ``metrics`` event payload and the heartbeat body."""
        return {name: m.snapshot() for name, m in sorted(self._metrics.items())
                if name.startswith(prefix)}
