"""Admission control for the unlearning serving tier.

`AdmissionQueue` is the front door: every request is checked — and either
admitted, rejected with a retry-after hint, or blocked until space frees —
BEFORE any session state changes, so a rejected request leaves no trace.
Three independent limits gate admission:

  * bounded depth (``max_depth``) — the global pending set never grows
    past it, so a stalled executor surfaces as backpressure at the edge
    instead of unbounded memory growth;
  * per-tenant quotas (`TenantQuota`) — one tenant's burst cannot starve
    the others out of the queue (its own requests bounce, everyone else
    keeps admitting);
  * add-capacity accounting (`AddCapacityLedger`) — addition rows are
    charged against the engine's staged pow2-bucketed device-row capacity
    IN BUCKET UNITS (padding columns included), so a burst of adds that
    would outgrow `Dataset.device_columns(capacity=...)` — and force a
    mid-flush retrace of every compiled replay program — is refused with
    retry-after instead of admitted.

In the port the bucket is the online engine's ``base_n``/``_row_cap``
bookkeeping: eager PyTorch compiles no replay program and pads no device
columns, so a "retrace" costs nothing here.  The ledger charges adds
exactly as the reference does all the same, because its decisions (which
adds admit, which bounce) and the monitor's ``add_capacity_retraces``
count are part of the served result.

The queue is thread-safe with a single condition variable: producers
(callers, the load generator) admit concurrently with the one consumer
(the executor) taking batches via `take()`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.engine import _next_pow2
from repro_torch.obs import metrics as obs_metrics


class RetryAfter(Exception):
    """Backpressure signal: the request was NOT admitted; try again in
    ``retry_after_s`` seconds (a hint from the queue's current drain
    rate, never a promise)."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(f"{reason} (retry after {retry_after_s:.3g}s)")
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


@dataclass
class TenantQuota:
    """Per-tenant admission bounds (None disables a bound)."""

    max_pending: Optional[int] = 64


@dataclass
class QueuedRequest:
    """One admitted request, from admission to completion.

    The queue owns it while pending; the executor stamps the completion
    fields and sets ``done``.  ``deadline`` is absolute (clock units of
    the owning scheduler): ``t_enqueue + sla.deadline_s``."""

    seq: int
    tenant: str
    sla_class: str
    op: str
    rows: Optional[Sequence[int]]
    data: Optional[Dict[str, np.ndarray]]
    coalesce: bool
    t_enqueue: float
    deadline: float
    # completion bookkeeping (executor-stamped)
    t_dispatch: Optional[float] = None
    t_done: Optional[float] = None
    error: Optional[Exception] = None
    batch_id: Optional[int] = None
    done: threading.Event = field(default_factory=threading.Event,
                                  repr=False)

    @property
    def n_rows(self) -> int:
        if self.rows is not None:
            return len(self.rows)
        return len(next(iter(self.data.values())))

    @property
    def e2e_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_enqueue

    @property
    def missed_deadline(self) -> Optional[bool]:
        return None if self.t_done is None else self.t_done > self.deadline


class AddCapacityLedger:
    """Pow2-bucket accounting for addition rows.

    The engine stages device columns at ``base_n + next_pow2(adds)`` rows;
    everything inside the bucket — INCLUDING the padding columns between
    the appended rows and the pow2 boundary — is capacity that admits
    additions without a retrace, and the first row past the boundary
    re-traces every compiled replay program.  The ledger therefore counts
    headroom as

        staged_rows − appended_rows − pending_rows

    where ``staged_rows`` is the full bucket (padding included — the fix
    for the pre-scheduler accounting, which compared against the raw add
    count and let bursts slip past the boundary) and ``pending_rows`` are
    admitted-but-not-yet-appended adds: rows sitting in the queue AND
    rows in a batch the executor has taken but not finished serving.  A
    charge is released only once the batch completes and the scheduler
    has refreshed ``appended_rows`` (`AdmissionQueue.note_served`), so
    in-flight rows are never counted as headroom."""

    def __init__(self) -> None:
        self.staged_rows = 0
        self.appended_rows = 0
        self.pending_rows = 0

    def refresh(self, staged_rows: int, appended_rows: int) -> None:
        """Sync the engine-side facts (called by the scheduler with
        ``row_cap − base_n`` and ``ds.n − base_n``)."""
        self.staged_rows = int(staged_rows)
        self.appended_rows = int(appended_rows)

    @property
    def headroom(self) -> int:
        return self.staged_rows - self.appended_rows - self.pending_rows

    def try_charge(self, k: int) -> bool:
        """Reserve `k` add rows inside the staged bucket; False when the
        charge would cross the pow2 boundary (the caller backpressures)."""
        if k > self.headroom:
            return False
        self.pending_rows += k
        return True

    def force_charge(self, k: int) -> None:
        """Charge past the boundary (enforcement off): the eventual
        retrace is the monitor's ``add_capacity_retraces`` to count."""
        self.pending_rows += k

    def release(self, k: int) -> None:
        """A charged request finished serving (its rows are now visible
        in ``appended_rows``) or failed without appending."""
        self.pending_rows = max(0, self.pending_rows - k)

    @staticmethod
    def bucket(adds: int) -> int:
        """Rows the engine stages for `adds` additions (pow2 padding)."""
        return _next_pow2(adds) if adds else 0


class AdmissionQueue:
    """Bounded, tenant-aware FIFO between callers and the executor."""

    def __init__(self, max_depth: int = 1024,
                 tenant_quota: Optional[TenantQuota] = None,
                 on_full: str = "reject",
                 block_timeout_s: float = 30.0,
                 clock: Callable[[], float] = None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None):
        if on_full not in ("reject", "block"):
            raise ValueError(f"on_full must be 'reject' or 'block', got "
                             f"{on_full!r}")
        import time as _time
        self.max_depth = int(max_depth)
        self.tenant_quota = tenant_quota or TenantQuota()
        self.on_full = on_full
        self.block_timeout_s = float(block_timeout_s)
        self.clock = clock if clock is not None else _time.monotonic
        self.ledger = AddCapacityLedger()
        self.cond = threading.Condition()
        self._pending: List[QueuedRequest] = []
        self._in_flight = 0
        self._seq = 0
        self._closed = False
        # admission outcome counters (monitor scrapes them); each is
        # mirrored into the registry as `queue.<name>` — the scheduler
        # passes its monitor's registry so the serving stack shares one
        # surface (see the contract table in `repro_torch.obs`)
        self.registry = registry if registry is not None \
            else obs_metrics.get_registry()
        self.admitted = 0
        self.rejected_depth = 0
        self.rejected_tenant = 0
        self.rejected_add_capacity = 0
        self.blocked_admissions = 0
        # EMA of observed drain rate (requests/s) — the retry-after hint
        self._drain_rate = 0.0
        self._last_take_t: Optional[float] = None

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        with self.cond:
            return len(self._pending)

    @property
    def depth(self) -> int:
        return len(self)

    @property
    def in_flight(self) -> int:
        """Requests taken by the executor but not yet finished serving.
        A drain (or a snapshot) is only between-requests when BOTH the
        depth and this are zero."""
        with self.cond:
            return self._in_flight

    def tenant_depth(self, tenant: str) -> int:
        with self.cond:
            return sum(1 for q in self._pending if q.tenant == tenant)

    def snapshot(self) -> List[QueuedRequest]:
        with self.cond:
            return list(self._pending)

    def _retry_hint(self, backlog: int) -> float:
        """Seconds until `backlog` requests drain at the observed rate
        (floor 1 ms; 50 ms default before any batch has drained)."""
        if self._drain_rate <= 0:
            return 0.05
        return max(1e-3, backlog / self._drain_rate)

    def _count(self, name: str) -> None:
        self.registry.counter("queue." + name, owner="serve.queue").inc()

    # -- admission -----------------------------------------------------------

    def admit(self, req: QueuedRequest,
              enforce_add_capacity: bool = True) -> QueuedRequest:
        """Admit or backpressure (`RetryAfter`).  Depth and quota checks
        honor ``on_full`` ("block" parks the caller until space frees,
        bounded by ``block_timeout_s``); the add-capacity check always
        rejects — blocking cannot create device capacity."""
        with self.cond:
            if self.on_full == "block":
                def has_room():
                    return (self._closed
                            or (len(self._pending) < self.max_depth
                                and self._tenant_room(req.tenant)))
                if not has_room():
                    self.blocked_admissions += 1
                    self._count("blocked_admissions")
                    if not self.cond.wait_for(has_room,
                                              timeout=self.block_timeout_s):
                        self.rejected_depth += 1
                        self._count("rejected_depth")
                        raise RetryAfter(
                            "queue full past block_timeout_s",
                            self._retry_hint(len(self._pending)))
            if self._closed:
                raise RuntimeError("queue is closed (scheduler stopped)")
            if len(self._pending) >= self.max_depth:
                self.rejected_depth += 1
                self._count("rejected_depth")
                raise RetryAfter(
                    f"queue depth {len(self._pending)} at max_depth "
                    f"{self.max_depth}",
                    self._retry_hint(1 + len(self._pending)
                                     - self.max_depth))
            if not self._tenant_room(req.tenant):
                self.rejected_tenant += 1
                self._count("rejected_tenant")
                raise RetryAfter(
                    f"tenant {req.tenant!r} at quota "
                    f"{self.tenant_quota.max_pending}",
                    self._retry_hint(1))
            if req.op == "add":
                if not self.ledger.try_charge(req.n_rows):
                    if enforce_add_capacity:
                        self.rejected_add_capacity += 1
                        self._count("rejected_add_capacity")
                        raise RetryAfter(
                            f"add of {req.n_rows} rows exceeds staged "
                            f"device capacity (headroom "
                            f"{self.ledger.headroom} rows incl. pow2 "
                            "padding)",
                            self._retry_hint(len(self._pending) + 1))
                    self.ledger.force_charge(req.n_rows)
            req.seq = self._seq
            self._seq += 1
            self._pending.append(req)
            self.admitted += 1
            self._count("admitted")
            self.cond.notify_all()
            return req

    def _tenant_room(self, tenant: str) -> bool:
        mp = self.tenant_quota.max_pending
        if mp is None:
            return True
        return sum(1 for q in self._pending if q.tenant == tenant) < mp

    # -- the consumer side ---------------------------------------------------

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Block the executor until something is pending (or timeout)."""
        with self.cond:
            return self.cond.wait_for(
                lambda: self._pending or self._closed, timeout=timeout)

    def take(self, chooser: Callable[[List[QueuedRequest]],
                                     List[QueuedRequest]]
             ) -> List[QueuedRequest]:
        """Atomically remove and return the batch `chooser` selects from
        the pending snapshot (the scheduler's EDF decision runs under the
        queue lock, so admissions cannot race the selection)."""
        with self.cond:
            batch = chooser(list(self._pending))
            if batch:
                picked = {q.seq for q in batch}
                self._pending = [q for q in self._pending
                                 if q.seq not in picked]
                # taken rows stay charged on the ledger until the batch
                # completes and `note_served` runs — releasing here would
                # overstate headroom while the rows are in flight
                self._in_flight += len(batch)
                now = self.clock()
                if self._last_take_t is not None:
                    dt = max(now - self._last_take_t, 1e-6)
                    inst = len(batch) / dt
                    self._drain_rate = (0.5 * self._drain_rate + 0.5 * inst
                                        if self._drain_rate else inst)
                self._last_take_t = now
                self.cond.notify_all()  # space freed: wake blocked admits
            return batch

    def note_served(self, batch: List[QueuedRequest]) -> None:
        """The executor finished (or abandoned) a taken batch: drop its
        in-flight count and release its add-row ledger charges.  Call
        AFTER `refresh_ledger` has absorbed the appended rows, so the
        charge hands off to ``appended_rows`` without a headroom gap."""
        with self.cond:
            self._in_flight = max(0, self._in_flight - len(batch))
            for q in batch:
                if q.op == "add":
                    self.ledger.release(q.n_rows)
            self.cond.notify_all()  # wake wait_idle / blocked admits

    def refresh_ledger(self, staged_rows: int, appended_rows: int) -> None:
        """Sync the ledger's engine-side facts under the queue lock (so
        a concurrent admit's `try_charge` never sees a half-updated
        view)."""
        with self.cond:
            self.ledger.refresh(staged_rows, appended_rows)

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until nothing is pending AND nothing is in flight (or
        timeout); True when idle.  This is the drain/snapshot barrier."""
        with self.cond:
            return self.cond.wait_for(
                lambda: not self._pending and not self._in_flight,
                timeout=timeout)

    def close(self) -> None:
        """Stop admitting (blocked admits wake and see the closed queue).
        Requests already pending stay takeable; `reopen()` reverses."""
        with self.cond:
            self._closed = True
            self.cond.notify_all()

    def reopen(self) -> None:
        with self.cond:
            self._closed = False
            self.cond.notify_all()
