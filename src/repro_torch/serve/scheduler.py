"""SLA-aware continuous-batching scheduler over `UnlearnerSession`.

The session's auto-flush policy is one global ``max_pending``/
``max_delay_s`` pair — a single-caller knob.  `ServingScheduler` replaces
it with PER-REQUEST-CLASS deadlines: every admitted request carries an
absolute deadline (``arrival + SLAClass.deadline_s``) and the scheduler
chooses flush moments by earliest-deadline-first over the pending set:

  * a request becomes READY at ``min(arrival + hold_s,
    deadline − slack·service_est)`` — ``hold_s`` is the class's deliberate
    batching delay (0 for interactive: dispatch at once; larger for bulk
    classes: let cross-tenant batches form), and the deadline term
    guarantees the request still dispatches early enough to finish on
    time under the current service-time estimate;
  * when any pending request is ready (or the pending set fills
    ``max_batch``), the EDF-first request anchors the batch and every
    compatible pending request — same op, ``coalesce=True``, ANY tenant —
    joins it in EDF order.  The batch is served as ONE session flush, so
    the planner coalesces it into one group replay; because group widths
    bucket to pow2 (`build_online_schedule`), cross-tenant batching hits
    the same compiled programs single-tenant bursts do — no new retraces
    (the reference's; the port compiles nothing per shape).

The scheduler decides WHEN to flush and WHAT to coalesce, never HOW to
replay: batches go through the unchanged session submit/coalesce/flush
path, so a batch replays what the session would replay for it.

`SessionFlushClock` is the degenerate scheduler — one default SLA class
whose deadline is the session's own ``max_delay_s``, driven by a daemon
tick thread.  It replaces the deprecated `core.session.AutoFlushTimer`
(the old name remains as a shim that warns and delegates here).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import _next_pow2
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.monitor import ServeMonitor
from repro_torch.serve.queue import AdmissionQueue, QueuedRequest, TenantQuota

# --------------------------------------------------------------------------
# SLA classes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SLAClass:
    """One request class: a deadline the scheduler works back from, and a
    hold — the deliberate batching delay the class tolerates (always
    trimmed by the deadline term, so a hold never causes a miss that the
    service-time estimate could have predicted)."""

    name: str
    deadline_s: float
    hold_s: float = 0.0


DEFAULT_CLASSES: Tuple[SLAClass, ...] = (
    SLAClass("interactive", deadline_s=0.05, hold_s=0.0),
    SLAClass("batch", deadline_s=0.5, hold_s=0.05),
    SLAClass("bulk_gdpr", deadline_s=5.0, hold_s=0.5),
)


@dataclass
class ServeConfig:
    """Scheduler + admission knobs (see the package docstring's guide)."""

    classes: Tuple[SLAClass, ...] = DEFAULT_CLASSES
    max_batch: int = 64              # requests per dispatched batch
    max_depth: int = 1024            # bounded admission queue
    tenant_max_pending: Optional[int] = 64
    on_full: str = "reject"          # "reject" (RetryAfter) | "block"
    block_timeout_s: float = 30.0
    # addition rows to pre-stage (pow2-bucketed device columns); admission
    # charges adds against this bucket — padding included — and rejects
    # past it instead of forcing a mid-flush retrace
    add_capacity: int = 0
    enforce_add_capacity: bool = True
    slack_factor: float = 2.0        # deadline urgency margin on est
    service_est_init_s: float = 0.005
    idle_tick_s: float = 0.02        # executor wake interval when idle


class ServeTicket:
    """Caller-facing handle for one admitted request."""

    def __init__(self, scheduler: "ServingScheduler", req: QueuedRequest):
        self._scheduler = scheduler
        self.req = req

    @property
    def done(self) -> bool:
        return self.req.done.is_set()

    @property
    def error(self) -> Optional[Exception]:
        return self.req.error

    @property
    def e2e_s(self) -> Optional[float]:
        return self.req.e2e_s

    @property
    def missed_deadline(self) -> Optional[bool]:
        return self.req.missed_deadline

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until served (pumping inline when no executor thread is
        running); True when done.  Raises the request's error, if any."""
        if self._scheduler.running:
            ok = self.req.done.wait(timeout)
        else:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while not self.req.done.is_set():
                self._scheduler.pump(force=True)
                if deadline is not None and time.monotonic() > deadline:
                    break
            ok = self.req.done.is_set()
        if ok and self.req.error is not None:
            raise RuntimeError(
                f"request {self.req.seq} failed: {self.req.error}"
            ) from self.req.error
        return ok


# --------------------------------------------------------------------------
# The scheduler
# --------------------------------------------------------------------------


class ServingScheduler:
    """Admission + EDF flush policy + cross-tenant batching over one
    `UnlearnerSession`.  Construction touches the session's algorithm (so
    capacity can be pre-staged); `start()` spins the executor thread, or
    call `pump()`/`drain()` inline for deterministic single-thread use
    (tests, virtual clocks)."""

    def __init__(self, session, config: Optional[ServeConfig] = None,
                 clock: Callable[[], float] = None,
                 monitor: Optional[ServeMonitor] = None):
        from repro_torch.serve.executor import Executor  # avoid import cycle

        self.session = session
        self.config = config or ServeConfig()
        self.clock = clock if clock is not None else time.monotonic
        self.classes: Dict[str, SLAClass] = {c.name: c
                                             for c in self.config.classes}
        if not self.classes:
            raise ValueError("ServeConfig.classes must name at least one "
                             "SLA class")
        self.default_class = self.config.classes[0].name
        self.monitor = monitor or ServeMonitor()
        # the queue mirrors its admission counters into the monitor's
        # registry, so one surface carries the whole serving stack
        self.queue = AdmissionQueue(
            max_depth=self.config.max_depth,
            tenant_quota=TenantQuota(self.config.tenant_max_pending),
            on_full=self.config.on_full,
            block_timeout_s=self.config.block_timeout_s,
            clock=self.clock,
            registry=self.monitor.registry)
        self.service_est_s = float(self.config.service_est_init_s)
        self.wait_hint: Optional[float] = None
        self.batch_log: List[Dict[str, Any]] = []
        self._batch_ids = 0
        self.executor = Executor(self)
        # bind the algorithm now and pre-stage the add bucket so admission
        # accounting sees the real staged capacity from the first request
        if (cfg_mp := session.config.max_pending) or session.config.max_delay_s:
            raise ValueError(
                "the session's own auto-flush policy (max_pending="
                f"{cfg_mp}, max_delay_s={session.config.max_delay_s}) "
                "would race the scheduler's flush decisions — disable it; "
                "SLA-class deadlines replace it")
        session.algorithm.begin_plan(self.config.add_capacity)
        self._refresh_ledger()
        self._last_row_cap: Optional[int] = None

    # -- capacity accounting -------------------------------------------------

    def _capacity_view(self) -> Optional[Tuple[int, int]]:
        """(staged_rows, appended_rows) for the serving algorithm: the
        pow2 bucket its device columns stage (padding included) and the
        rows physically appended past the cached run."""
        algo = self.session._algorithm
        if algo is None:
            return None
        eng = getattr(algo, "_engine", None)
        if eng is not None:
            cap = max(len(eng.added), eng.add_capacity)
            staged = _next_pow2(cap) if cap else 0
            return staged, self.session.dataset.n - eng._base_n
        row_cap = getattr(algo, "_row_cap", None)
        base_n = getattr(algo, "_base_n", None)
        if row_cap is None or base_n is None:
            return None
        return row_cap - base_n, self.session.dataset.n - base_n

    def _refresh_ledger(self) -> None:
        view = self._capacity_view()
        if view is not None:
            self.queue.refresh_ledger(*view)

    def _note_batch_done(self, batch: List[QueuedRequest]) -> None:
        """Settle a completed (or abandoned) batch with the queue: absorb
        the appended rows into the ledger FIRST, then release the batch's
        in-flight charges — in that order there is no instant where
        in-flight add rows count as headroom."""
        self._refresh_ledger()
        self.queue.note_served(batch)

    def _row_cap_now(self) -> Optional[int]:
        algo = self.session._algorithm
        src = getattr(algo, "_engine", None) or algo
        return getattr(src, "_row_cap", None)

    # -- admission -----------------------------------------------------------

    def submit(self, op: str, rows: Optional[Sequence[int]] = None,
               data: Optional[Dict[str, np.ndarray]] = None,
               tenant: str = "default",
               sla_class: Optional[str] = None,
               coalesce: bool = True) -> ServeTicket:
        """Admit one request (or raise `RetryAfter`); returns a ticket.
        Nothing touches the session here — the executor submits admitted
        requests at dispatch time, so a rejected request has no trace."""
        cls_name = sla_class or self.default_class
        try:
            cls = self.classes[cls_name]
        except KeyError:
            raise ValueError(
                f"unknown SLA class {cls_name!r}; configured: "
                f"{', '.join(sorted(self.classes))}") from None
        if op not in ("delete", "add"):
            raise ValueError(f"op must be 'delete' or 'add', got {op!r}")
        if op == "add" and rows is None and data is None:
            raise ValueError("add requests need data (or rows)")
        now = self.clock()
        self._refresh_ledger()
        req = QueuedRequest(
            seq=-1, tenant=tenant, sla_class=cls_name, op=op,
            rows=list(rows) if rows is not None else None, data=data,
            coalesce=coalesce, t_enqueue=now,
            deadline=now + cls.deadline_s)
        with obs_trace.span("serve.admit", op=op, tenant=tenant,
                            cls=cls_name):
            self.queue.admit(
                req, enforce_add_capacity=self.config.enforce_add_capacity)
        self.monitor.observe_depth(self.queue.depth)
        return ServeTicket(self, req)

    # -- EDF flush decision --------------------------------------------------

    def _ready_t(self, q: QueuedRequest) -> float:
        cls = self.classes[q.sla_class]
        margin = self.config.slack_factor * self.service_est_s
        return min(q.t_enqueue + cls.hold_s, q.deadline - margin)

    def _choose(self, pending: List[QueuedRequest], now: float,
                force: bool) -> List[QueuedRequest]:
        """The flush decision, run atomically under the queue lock: [] to
        keep waiting (`wait_hint` says how long), else the batch — the
        EDF-first request plus every compatible pending request (same op,
        coalesce=True, any tenant) in EDF order, capped at max_batch."""
        self.wait_hint = None
        if not pending:
            return []
        if not force and len(pending) < self.config.max_batch:
            t_fire = min(self._ready_t(q) for q in pending)
            if now < t_fire:
                self.wait_hint = max(1e-4, t_fire - now)
                return []
        edf = sorted(pending, key=lambda q: (q.deadline, q.seq))
        head = edf[0]
        if not head.coalesce:
            return [head]
        return [q for q in edf
                if q.op == head.op and q.coalesce][:self.config.max_batch]

    def take_batch(self, now: Optional[float] = None,
                   force: bool = False) -> List[QueuedRequest]:
        now = self.clock() if now is None else now
        return self.queue.take(lambda p: self._choose(p, now, force))

    def note_service(self, service_s: float, batch: List[QueuedRequest],
                     retraced: bool) -> None:
        """Executor feedback after each batch — the FULL batch, including
        requests whose submit failed (the monitor routes those to the
        per-class failed counter): service-time EMA for the deadline
        margin, the batch record for the monitor + trace log."""
        self.service_est_s = 0.5 * self.service_est_s + 0.5 * float(service_s)
        self.monitor.observe_batch(batch, retraced=retraced)
        for q in batch:
            self.monitor.observe_request(q)
        self._batch_ids += 1
        self.batch_log.append({
            "batch": self._batch_ids,
            "op": batch[0].op,
            "rows": [r for q in batch for r in (q.rows or [])],
            "tenants": sorted({q.tenant for q in batch}),
            "classes": sorted({q.sla_class for q in batch}),
            "coalesce": batch[0].coalesce,
        })

    # -- execution modes -----------------------------------------------------

    @property
    def running(self) -> bool:
        return self.executor.running

    def start(self) -> "ServingScheduler":
        """Spin the executor thread: one replay in flight at most, the
        queue admitting (and the next batch forming) underneath it."""
        self.executor.start()
        return self

    def stop(self) -> None:
        """Stop the executor thread (waking any blocked admits).  The
        scheduler remains usable inline (`pump()`/`drain()`/`submit`)
        and `start()` brings the thread back."""
        self.executor.stop()
        self.queue.reopen()

    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """Inline single-step (no thread): take one batch per the flush
        policy (`force=True` skips hold/deadline waiting — drain style)
        and serve it.  Returns requests served."""
        batch = self.take_batch(now=now, force=force)
        if not batch:
            return 0
        self.executor.serve_batch(batch)
        return len(batch)

    def drain(self) -> int:
        """Serve everything pending (queue AND session) to completion;
        returns requests served.  Safe next to a running executor thread —
        batches are taken atomically either way, and a batch the executor
        has already taken is waited out (`Executor.drain_wait`) before the
        final session flush, so a drain never lands mid-batch."""
        served = 0
        while True:
            n = self.pump(force=True) if not self.running else 0
            served += n
            if self.queue.depth == 0 and not n:
                # the queue is empty, but the executor may still be
                # serving a batch it took earlier — wait for it before
                # declaring the drain complete
                if not self.running or self.executor.drain_wait():
                    if self.queue.depth == 0 and self.queue.in_flight == 0:
                        break
            if self.running:
                time.sleep(0.002)
        self.session.flush()
        return served

    # -- snapshot consistency under load ------------------------------------

    def save(self, directory: str, step: Optional[int] = None,
             pending: str = "drain") -> str:
        """Snapshot the session UNDER LOAD, deterministically:

        ``pending="drain"`` serves every queued request first (the
        snapshot is a between-requests state — restoring and replaying
        the rest of a seeded trace is bitwise-identical to the
        uninterrupted run); ``pending="refuse"`` raises while anything is
        queued OR in flight, for callers that must not absorb latency
        here."""
        if pending not in ("drain", "refuse"):
            raise ValueError(f"pending must be 'drain' or 'refuse', got "
                             f"{pending!r}")
        if pending == "refuse":
            depth = self.queue.depth
            in_flight = self.queue.in_flight
            sess_pending = self.session.pending_count
            if depth or in_flight or sess_pending:
                raise RuntimeError(
                    f"save(pending='refuse') with {depth} queued + "
                    f"{in_flight} in-flight + {sess_pending} "
                    "session-pending request(s); drain first or "
                    "save(pending='drain')")
        else:
            self.drain()
        return self.session.save(directory, step)

    def stats(self) -> Dict[str, Any]:
        return self.monitor.snapshot(self.queue)


# --------------------------------------------------------------------------
# The degenerate scheduler: one default class over a bare session
# --------------------------------------------------------------------------


class SessionFlushClock:
    """Deadline clock for a session WITHOUT a full scheduler: one default
    SLA class whose deadline is the session's own ``max_delay_s``, driven
    by a daemon thread that ticks ``session.poll()`` so the deadline holds
    with ZERO further arrivals.  This is what the deprecated
    `core.session.AutoFlushTimer` now delegates to.

    A flush that raises (a failing request group) records the error on
    ``last_error`` and keeps ticking — the failing handles already resolve
    to the error through the session's usual path."""

    def __init__(self, session, interval_s: Optional[float] = None):
        deadline = session.config.max_delay_s
        if deadline is None:
            raise ValueError(
                "SessionFlushClock needs config.max_delay_s — there is no "
                "deadline to enforce (use ServingScheduler for SLA-class "
                "deadlines)")
        self.sla = SLAClass("default", deadline_s=float(deadline))
        # staleness is bounded by deadline + one tick interval, so default
        # to a small fraction of the deadline
        if interval_s is None:
            interval_s = self.sla.deadline_s / 8.0
        self.interval_s = max(1e-3, float(interval_s))
        self.ticks = 0
        self.last_error: Optional[Exception] = None
        self._session = session
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="unlearner-flush-clock")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.ticks += 1
            try:
                self._session.poll()
            except Exception as e:  # noqa: BLE001 — keep the clock alive
                self.last_error = e

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
