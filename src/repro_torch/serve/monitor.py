"""Serving-tier metrics — the numbers the serve CLI's ``serving`` section
reports.

One `ServeMonitor` instance per scheduler. Every latency/size quantile
is served from `repro_torch.obs.metrics.Histogram` instances in the
monitor's registry — the same fixed-bucket implementation
`launch/serve.py` uses for its dispatch/blocked percentiles, so there is
exactly ONE quantile code path in the package. Recorded per request:
dispatch latency (enqueue → batch dispatch), e2e latency (enqueue →
replay drained), and whether the SLA-class deadline was met. Recorded
per batch: size, distinct tenants, ops. Counters: deadline misses per
class, admission rejections (scraped from the queue), add-capacity
retraces (a flush that re-bucketed the engine's staged device rows — in
the reference each one recompiles every replay program, which is what
admission-side accounting exists to prevent; the port pays nothing for
one, but counts it the same way).

The monitor defaults to a PRIVATE `MetricsRegistry` (bench sweeps build
one monitor per point; snapshots must not accumulate across points) —
pass ``registry=obs.metrics.get_registry()`` to publish a single serving
stack into the process-wide surface, as the serve CLI does.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.queue import AdmissionQueue, QueuedRequest

_OWN = "serve.monitor"


class ServeMonitor:
    """Per-class latency, queue, and batching telemetry."""

    def __init__(self,
                 registry: Optional[obs_metrics.MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else obs_metrics.MetricsRegistry()
        self._classes: set = set()
        self.deadline_misses: Counter = Counter()
        self.served: Counter = Counter()
        self.failed: Counter = Counter()
        self.batch_sizes: List[int] = []
        self.batch_tenants: List[int] = []
        self.batch_ops: Counter = Counter()
        self.cross_tenant_batches = 0
        self.add_capacity_retraces = 0

    # -- registry accessors --------------------------------------------------

    def _hist(self, name: str, cls: Optional[str] = None,
              unit: str = "ms") -> obs_metrics.Histogram:
        labels = {"class": cls} if cls is not None else None
        return self.registry.histogram(name, unit=unit, owner=_OWN,
                                       labels=labels)

    def _counter(self, name: str,
                 cls: Optional[str] = None) -> obs_metrics.Counter:
        labels = {"class": cls} if cls is not None else None
        return self.registry.counter(name, owner=_OWN, labels=labels)

    # -- observations --------------------------------------------------------

    def observe_request(self, req: QueuedRequest) -> None:
        cls = req.sla_class
        self._classes.add(cls)
        if req.error is not None:
            self.failed[cls] += 1
            self._counter("serve.failed", cls).inc()
            return
        self.served[cls] += 1
        self._counter("serve.served", cls).inc()
        if req.t_dispatch is not None:
            self._hist("serve.dispatch_ms", cls).observe(
                (req.t_dispatch - req.t_enqueue) * 1e3)
        if req.t_done is not None:
            self._hist("serve.e2e_ms", cls).observe(
                (req.t_done - req.t_enqueue) * 1e3)
        if req.missed_deadline:
            self.deadline_misses[cls] += 1
            self._counter("serve.deadline_misses", cls).inc()

    def observe_batch(self, batch: List[QueuedRequest],
                      retraced: bool = False) -> None:
        self.batch_sizes.append(len(batch))
        self._hist("serve.batch_size", unit="1").observe(len(batch))
        tenants = len({q.tenant for q in batch})
        self.batch_tenants.append(tenants)
        if tenants > 1:
            self.cross_tenant_batches += 1
        for q in batch:
            self.batch_ops[q.op] += 1
        if retraced:
            self.add_capacity_retraces += 1
            self._counter("serve.add_capacity_retraces").inc()

    def observe_depth(self, depth: int) -> None:
        self._hist("serve.queue_depth", unit="1").observe(int(depth))

    # -- snapshot ------------------------------------------------------------

    def snapshot(self, queue: Optional[AdmissionQueue] = None
                 ) -> Dict[str, Any]:
        classes = sorted(self._classes | set(self.served)
                         | set(self.failed))
        out: Dict[str, Any] = {
            "per_class": {
                cls: {
                    "served": int(self.served[cls]),
                    "failed": int(self.failed[cls]),
                    "deadline_misses": int(self.deadline_misses[cls]),
                    "dispatch_ms":
                        self._hist("serve.dispatch_ms", cls).summary(),
                    "e2e_ms": self._hist("serve.e2e_ms", cls).summary(),
                } for cls in classes
            },
            "batches": {
                "count": len(self.batch_sizes),
                "size_mean": (float(np.mean(self.batch_sizes))
                              if self.batch_sizes else 0.0),
                "size_max": int(max(self.batch_sizes, default=0)),
                "size_hist": dict(Counter(self.batch_sizes)),
                "cross_tenant": int(self.cross_tenant_batches),
                "tenants_mean": (float(np.mean(self.batch_tenants))
                                 if self.batch_tenants else 0.0),
                "ops": dict(self.batch_ops),
            },
            "queue_depth": self._hist("serve.queue_depth",
                                      unit="1").summary(),
            "add_capacity_retraces": int(self.add_capacity_retraces),
            "deadline_misses_total": int(sum(self.deadline_misses.values())),
        }
        if queue is not None:
            out["admission"] = {
                "admitted": queue.admitted,
                "rejected_depth": queue.rejected_depth,
                "rejected_tenant": queue.rejected_tenant,
                "rejected_add_capacity": queue.rejected_add_capacity,
                "blocked_admissions": queue.blocked_admissions,
            }
        return out
