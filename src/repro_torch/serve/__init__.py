"""Continuous-batching unlearning scheduler — the serving tier above
`core.session.UnlearnerSession`.

DeltaGrad answers a *single* deletion request far cheaper than retraining;
a production right-to-be-forgotten service answers an open-loop STREAM of
them — bursty, multi-tenant, with wildly different urgency (an
interactive "delete my account" click vs a bulk GDPR backfill).  The
session's own auto-flush policy (one global ``max_pending``/
``max_delay_s``) is a single-caller knob; this package is the multi-tenant
serving layer, shaped like an LLM-inference continuous-batching scheduler.
It is the JAX package's `serve`, module for module, over the port's
session: the same request stream gives the same batches, the same
monitor counts and the same params (to the engine's parity bar):

    queue.py      AdmissionQueue — per-tenant quotas, bounded depth,
                  backpressure (reject-with-retry-after or block, the
                  caller's choice), add-capacity accounting in pow2-bucket
                  units so a tenant burst cannot admit more additions than
                  the engine's staged device columns will hold.
    scheduler.py  SLA classes + earliest-deadline-first flush decisions,
                  cross-tenant batch formation (same-op requests from any
                  tenant coalesce into ONE group replay — the planner's
                  pow2-bucketed index-set groups mean cross-tenant batching
                  costs no new retraces), and the deadline clock that
                  replaces the deprecated `AutoFlushTimer`.
    executor.py   Drives the session's existing submit/coalesce/flush
                  path with AT MOST ONE replay in flight; the queue keeps
                  admitting while a replay runs, so the next batch forms
                  under the current one (continuous batching).
    monitor.py    Per-class dispatch/e2e percentiles, queue depth, batch
                  size histogram, deadline-miss and retrace counters —
                  the ``serving`` section of the serve CLI's JSON.
    loadgen.py    Seeded open-loop arrivals (Poisson and diurnal traces,
                  multi-tenant delete/add mixes) plus the deterministic
                  fixed-interval and closed-loop modes parity tests use.

ARCHITECTURE — one request's life:

    caller ──▶ AdmissionQueue.admit()          (quota + depth + add-capacity
                   │                            checks; backpressure here)
                   ▼
    ServingScheduler.take_batch()              (EDF over the pending set:
                   │                            dispatch now / wait)
                   ▼
    Executor.serve_batch()                     (session.submit × batch,
                   │                            ONE flush, ONE device sync)
                   ▼
    ServeMonitor.observe_*()                   (e2e vs the class deadline)

SLA-CLASS SELECTION — pick the class whose deadline matches the caller's
contract; the scheduler holds a request only while its deadline affords
it, so looser classes batch harder and cost less per request:

    class        default deadline   typical caller             batching
    interactive  0.05 s             user-facing delete click   rarely waits
    batch        0.5  s             app-tier cleanup jobs      coalesces
    bulk_gdpr    5.0  s             compliance backfills       max batches

BACKPRESSURE SEMANTICS — admission fails BEFORE state changes, so a
rejected request has no trace.  ``on_full="reject"`` raises
`RetryAfter(retry_after_s)` with a hint derived from the current drain
rate; ``on_full="block"`` parks the submitting thread until the queue
drains (bounded by ``block_timeout_s``, then `RetryAfter`).  Per-tenant
quotas reject only the offending tenant; other tenants keep admitting.
Addition requests additionally charge the engine's pow2-bucketed add
capacity (padding columns included — see `queue.AddCapacityLedger`): adds
beyond the staged bucket are rejected with retry-after rather than forcing
a mid-flush retrace, and a retrace that still happens (capacity legally
re-bucketed between flushes) is surfaced as the monitor's
``add_capacity_retraces`` counter instead of silent recompile stalls.

The scheduler only decides WHEN to flush and WHAT to coalesce — never how
to replay: batches are served by the unchanged session/planner/engine
stack, so a served stream replays exactly what the session would serve
for the same batches.  See `core/session.py` for the
algorithm-selection guide (deltagrad / descent_to_delete /
retrain_oracle); every registered algorithm serves through this tier
unchanged.

Quickstart:

    from repro_torch.serve import ServeConfig, ServingScheduler
    sched = ServingScheduler(session, ServeConfig())
    sched.start()                                # executor thread
    t = sched.submit(op="delete", rows=[17], tenant="acme",
                     sla_class="interactive")
    t.wait()                                     # e2e includes queueing
    sched.drain(); sched.stop()                  # or sched.save(dir)
"""

from repro_torch.serve.executor import Executor
from repro_torch.serve.loadgen import (LoadGenerator, LoadResult, TraceEvent,
                                       diurnal_trace, fixed_trace,
                                       materialize, poisson_trace)
from repro_torch.serve.monitor import ServeMonitor
from repro_torch.serve.queue import (AddCapacityLedger, AdmissionQueue,
                                     QueuedRequest, RetryAfter, TenantQuota)
from repro_torch.serve.scheduler import (DEFAULT_CLASSES, ServeConfig,
                                         ServeTicket, ServingScheduler,
                                         SessionFlushClock, SLAClass)

__all__ = [
    "AddCapacityLedger", "AdmissionQueue", "QueuedRequest", "RetryAfter",
    "TenantQuota", "SLAClass", "DEFAULT_CLASSES", "ServeConfig",
    "ServeTicket", "ServingScheduler", "SessionFlushClock", "Executor",
    "ServeMonitor", "LoadGenerator", "LoadResult", "TraceEvent",
    "materialize", "poisson_trace", "diurnal_trace", "fixed_trace",
]
