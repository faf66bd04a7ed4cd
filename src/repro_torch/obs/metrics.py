"""Shared metrics registry: counters, gauges, fixed-bucket histograms.

One `MetricsRegistry` is the contract every layer publishes into —
`ServeMonitor` (per-class latency quantiles), `OnlineEngine` (compile
time), `SegmentStreamer` (prefetch hits, HBM high water), the
`AdmissionQueue` (admission outcomes), and the replay engine (step
counters) — so the serving tier and the CLI share one percentile path.

The JAX package's `obs.metrics`, line for line: the same operations give
byte-equal JSONL and Prometheus text in both packages.

`Histogram` quantiles come from a FIXED log-spaced bucket grid (no sorted
sample lists): `observe` is O(log #buckets) and memory is constant, while
``count``/``mean``/``min``/``max`` stay exact.  Quantiles interpolate
linearly inside the landing bucket and clamp to the exact observed
min/max, so worst-case quantile error is one bucket width (~4% at the
default growth of 1.04) — well inside every CI gate's cross-runner slack.

Exporters: `to_jsonl` writes one JSON object per metric (re-read with
`read_jsonl` for round-trips and CI artifacts); `to_prometheus` renders
the Prometheus text exposition format (histograms as summaries with
``quantile`` labels plus ``_count``/``_sum``).

A process-wide default registry is reachable via `get_registry()`;
components that must not accumulate across runs (one `ServeMonitor` per
bench sweep point) construct their own instance instead.
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry", "read_jsonl"]


class _Metric:
    """Shared identity fields; see the `repro_torch.obs` contract table."""

    kind = "metric"

    def __init__(self, name: str, unit: str = "", owner: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.unit = unit
        self.owner = owner
        self.labels = dict(labels or {})
        self._lock = threading.Lock()

    def _ident(self) -> Dict[str, Any]:
        return {"type": self.kind, "name": self.name, "unit": self.unit,
                "owner": self.owner, "labels": dict(self.labels)}


class Counter(_Metric):
    """Monotonically increasing count (int or float increments)."""

    kind = "counter"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {**self._ident(), "value": float(self._value)}


class Gauge(_Metric):
    """Last-set value plus its high-water mark."""

    kind = "gauge"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._value = 0.0
        self._high = -math.inf

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._high = max(self._high, self._value)

    def set_max(self, v: float) -> None:
        """Raise-only update (high-water gauges: HBM bytes, ring depth)."""
        with self._lock:
            v = float(v)
            if v > self._value:
                self._value = v
            self._high = max(self._high, v)

    @property
    def value(self) -> float:
        return self._value

    @property
    def high(self) -> float:
        return self._high if self._high != -math.inf else 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {**self._ident(), "value": float(self._value),
                "high": float(self.high)}


class Histogram(_Metric):
    """Fixed log-bucket latency/size histogram with exact count/mean/max.

    ``summary()`` returns the exact dict shape `ServeMonitor` has always
    reported (``{"count", "mean", "p50", "p95", "p99", "max"}``; just
    ``{"count": 0}`` when empty) so migrated call sites are drop-in.
    """

    kind = "histogram"

    #: default grid: 1e-6 .. 1e9 at 4% geometric steps (covers ns-scale
    #: span costs through multi-hour walls in any one unit)
    LO, HI, GROWTH = 1e-6, 1e9, 1.04

    def __init__(self, name: str, unit: str = "", owner: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 lo: float = LO, hi: float = HI, growth: float = GROWTH):
        super().__init__(name, unit=unit, owner=owner, labels=labels)
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        # bucket i covers [edges[i], edges[i+1]); one underflow bucket
        # below lo and one overflow bucket above hi bound the grid
        self._edges = lo * np.power(growth, np.arange(n + 1))
        self._counts = np.zeros(n + 2, dtype=np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            # searchsorted over the fixed edges: 0 is the underflow bucket
            self._counts[int(np.searchsorted(self._edges, v,
                                             side="right"))] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def _bucket_bounds(self, i: int) -> Tuple[float, float]:
        if i == 0:  # underflow: everything below the grid
            return min(self.min, self._edges[0]), self._edges[0]
        if i == len(self._counts) - 1:  # overflow
            return self._edges[-1], max(self.max, self._edges[-1])
        return self._edges[i - 1], self._edges[i]

    def quantile(self, q: float) -> float:
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q * self.count
            cum = np.cumsum(self._counts)
            i = int(np.searchsorted(cum, target, side="left"))
            i = min(i, len(self._counts) - 1)
            lo_e, hi_e = self._bucket_bounds(i)
            prev = float(cum[i - 1]) if i > 0 else 0.0
            in_bucket = float(self._counts[i])
            frac = (target - prev) / in_bucket if in_bucket else 0.0
            est = lo_e + frac * (hi_e - lo_e)
            return float(min(max(est, self.min), self.max))

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        return {"count": int(self.count), "mean": float(self.mean),
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99), "max": float(self.max)}

    def snapshot(self) -> Dict[str, Any]:
        out = self._ident()
        s = self.summary()
        out.update({"count": int(self.count), "sum": float(self.sum),
                    "min": float(self.min if self.count else 0.0),
                    "max": float(self.max if self.count else 0.0),
                    "p50": float(s.get("p50", 0.0)),
                    "p95": float(s.get("p95", 0.0)),
                    "p99": float(s.get("p99", 0.0))})
        return out


_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _prom(name: str) -> str:
    return _PROM_NAME.sub("_", name)


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{_prom(k)}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """Get-or-create metric store keyed by (name, labels)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            _Metric] = {}

    def _get(self, cls, name: str, unit: str, owner: str,
             labels: Optional[Dict[str, str]], **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, unit=unit, owner=owner,
                                             labels=labels, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, unit: str = "1", owner: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, unit, owner, labels)

    def gauge(self, name: str, unit: str = "1", owner: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, unit, owner, labels)

    def histogram(self, name: str, unit: str = "1", owner: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  **kw) -> Histogram:
        return self._get(Histogram, name, unit, owner, labels, **kw)

    # -- export --------------------------------------------------------------

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> List[Dict[str, Any]]:
        return [m.snapshot() for m in self.metrics()]

    def to_jsonl(self, path: str, mode: str = "w") -> str:
        """One JSON object per line per metric (the CI artifact format;
        `read_jsonl` parses it back)."""
        with open(path, mode) as f:
            for snap in self.snapshot():
                f.write(json.dumps(snap, sort_keys=True) + "\n")
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        seen_meta = set()
        for m in self.metrics():
            pname = _prom(m.name)
            if pname not in seen_meta:
                seen_meta.add(pname)
                help_bits = [b for b in (m.unit and f"unit={m.unit}",
                                         m.owner and f"owner={m.owner}")
                             if b]
                lines.append(f"# HELP {pname} "
                             + (", ".join(help_bits) or pname))
                ptype = {"counter": "counter", "gauge": "gauge",
                         "histogram": "summary"}[m.kind]
                lines.append(f"# TYPE {pname} {ptype}")
            if m.kind == "counter":
                lines.append(f"{pname}{_prom_labels(m.labels)} "
                             f"{m.value:.10g}")
            elif m.kind == "gauge":
                lines.append(f"{pname}{_prom_labels(m.labels)} "
                             f"{m.value:.10g}")
            else:
                for q in (0.5, 0.95, 0.99):
                    qlabel = 'quantile="%g"' % q
                    lines.append(
                        f"{pname}{_prom_labels(m.labels, qlabel)}"
                        f" {m.quantile(q):.10g}")
                lines.append(f"{pname}_count{_prom_labels(m.labels)} "
                             f"{m.count}")
                lines.append(f"{pname}_sum{_prom_labels(m.labels)} "
                             f"{m.sum:.10g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a `to_jsonl` artifact back into metric snapshots."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (engine/store/queue publish
    here; per-run components construct their own)."""
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _default
    _default = registry
    return _default
