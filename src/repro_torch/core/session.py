"""UnlearnerSession: the request-plan serving surface for DeltaGrad.

    sess = UnlearnerSession(objective, params0, dataset, UnlearnerConfig(),
                            device="cpu")   # None: the card
    sess.fit()                              # train once, caching the path
    h = sess.delete([3, 17, 256])           # returns a lazy RequestHandle
    sess.add(data={"x": new_x, "y": new_y})
    h.result().stats                        # force: flush + synchronise
    sess.save("ckpt/"); UnlearnerSession.restore("ckpt/", objective)

The JAX package's session, method for method:

  * REQUEST PLAN.  `submit()` enqueues typed `UnlearnRequest`s and returns
    `RequestHandle`s that resolve lazily: nothing executes until a handle
    is forced (`.result()`, `.params`) or `flush()` runs.  Every request,
    bursty or one at a time, is served by the session's ONE serving
    algorithm (`core.algorithms`), which for DeltaGrad is one
    `core.online.OnlineEngine` rewriting the cached path after each
    replay.
  * COALESCING PLANNER.  At flush, maximal runs of adjacent same-op
    requests with ``coalesce=True`` merge into ONE replay with the paper's
    group semantics (Algorithm 1 with an index set, on the current
    rewritten path): the GROUP correction, not the serial composition
    (``coalesce=False`` and the ``stream_*`` helpers keep the serial
    Algorithm-3 semantics).  A group's changed-row block pads to the next
    power of two of its size, capped at the batch, as the reference pads
    it.
  * SNAPSHOT/RESTORE.  `save()` writes the params through
    `train.checkpoint` (an .npz shard the JAX package's `restore` reads)
    with the history (any tier), the dataset, the algorithm's name and
    state, and the publication generator's state in the extra payload, all
    as numpy and plain dataclasses.  `restore()` rebuilds a session that
    serves the next request, and the next `publish()`, bitwise as the
    uninterrupted one would.  Objectives are code, not state: the caller
    passes the objective to `restore()`.

Algorithms (``UnlearnerConfig.algorithm``): ``"deltagrad"`` (Algorithm 3,
Laplace certificate from the §5.1 δ0 bound), ``"descent_to_delete"`` (I
full-batch steps per group, Gaussian certificate) and ``"retrain_oracle"``
(exact retraining through the same engine; ε = 0).  `publish()` draws the
noise from the session's `torch.Generator` on its device, seeded from
``config.seed`` at first use and advanced by each publish.

The deprecated auto-flush timer (`AutoFlushTimer`,
`start_autoflush_timer`) warns and delegates to the serving tier's
`repro_torch.serve.SessionFlushClock`, as in the reference.

Mesh placement: ``UnlearnerConfig.placement`` (a
`core.store.PlacementPolicy`) places the engine's store on a mesh over
the ranks of the default process group; every rank then builds the same
session and makes the same calls.  `save()` writes the snapshot from rank
0 (the policy pickled without its live group) after every rank has
served the pending requests, and every rank restores from it.

A snapshot of the JAX package cannot be restored whole here (its extra
payload pickles the reference's classes); its params shard can
(`train.checkpoint`).

`core.api.Unlearner` is a thin compatibility shim over this class.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.algorithms import (Certificate, DescentToDeleteConfig,
                                         UnlearningAlgorithm, get_algorithm)
from repro_torch.core.deltagrad import (DeltaGradConfig, Objective,
                                        RetrainStats, baseline_retrain,
                                        sgd_train_with_cache)
from repro_torch.core.engine import _sync, resolve_device
from repro_torch.core.history import HistoryMeta, TrainingHistory
from repro_torch.core.online import OnlineEngine, OnlineStats
from repro_torch.core.privacy import PrivacyConfig
from repro_torch.core.store import PlacementPolicy
from repro_torch.data.dataset import Dataset
from repro_torch.train import checkpoint as ckpt
from repro_torch.utils.tree import FlatParams


@dataclass
class UnlearnerConfig:
    steps: int = 100
    batch_size: int = 1 << 30  # default: deterministic full-batch GD
    lr: float = 0.1
    lr_schedule: Optional[Sequence] = None  # overrides lr if given
    seed: int = 0
    momentum: float = 0.0  # heavy-ball (beyond the paper; see HistoryMeta)
    deltagrad: DeltaGradConfig = field(default_factory=DeltaGradConfig)
    # None resolves to "stacked", or to "host" when history_codec is not
    # "f32" (stacked storage is uncompressed by construction)
    history_tier: Optional[str] = None
    history_codec: str = "f32"
    spill_dir: Optional[str] = None
    # mesh placement for the cached path and the replay
    # (core.store.PlacementPolicy; None: one device)
    placement: Optional[PlacementPolicy] = None
    # auto-flush policy: flush when max_pending requests are queued, or
    # when the OLDEST pending request has waited max_delay_s (checked at
    # submit and by poll()); None disables
    max_pending: Optional[int] = None
    max_delay_s: Optional[float] = None
    # which registered unlearning algorithm serves requests
    algorithm: str = "deltagrad"
    # certified-deletion constants; None resolves to PrivacyConfig()
    privacy: Optional[PrivacyConfig] = None
    # descent-to-delete knobs (finetune steps, lr, projection radius)
    descent: Optional[DescentToDeleteConfig] = None


@dataclass
class UnlearnRequest:
    """One typed unlearning request.

    op:       "delete" | "add".
    rows:     row ids: original or previously added rows for delete;
              already appended rows for add (filled in when `data` is
              given).
    data:     add payload (dict of columns), appended to the dataset at
              submit time so later requests can reference the new rows.
    coalesce: True: the planner may merge this request with adjacent
              same-op requests into ONE group replay; False: each row is
              its own Algorithm-3 replay, never merged."""

    op: str
    rows: Optional[Sequence[int]] = None
    data: Optional[Dict[str, np.ndarray]] = None
    coalesce: bool = True


@dataclass
class UnlearnResponse:
    """Resolved outcome of one request.

    stats holds one `RetrainStats` per replay that served the request:
    one entry when the request was coalesced into (or was) one group
    replay, len(rows) entries for a serial request.  `group_size` is the
    number of rows the replay(s) served.  `dispatch_s` is the group's host
    time to the end of its replays; `params` the post-request model."""

    request: UnlearnRequest
    stats: List[RetrainStats]
    group_size: int
    dispatch_s: float
    params: Any = None


class AutoFlushTimer:
    """DEPRECATED shim — the global auto-flush timer is superseded by the
    serving tier (`repro_torch.serve`): `ServingScheduler` for per-SLA-class
    deadlines, or `SessionFlushClock` for the degenerate one-class case
    this timer implemented.  Constructing it warns and returns a
    `SessionFlushClock` (same ``ticks``/``last_error``/``interval_s``/
    ``stop()`` surface), so existing callers keep working."""

    def __new__(cls, session: "UnlearnerSession",
                interval_s: Optional[float] = None):
        warnings.warn(
            "core.session.AutoFlushTimer is deprecated; use "
            "repro_torch.serve.SessionFlushClock (one default SLA class) or "
            "repro_torch.serve.ServingScheduler (per-class deadlines)",
            DeprecationWarning, stacklevel=2)
        from repro_torch.serve.scheduler import SessionFlushClock
        return SessionFlushClock(session, interval_s=interval_s)


class RequestHandle:
    """Lazy handle returned by `UnlearnerSession.submit`.

    Holding a handle costs nothing: the request executes when the session
    flushes (explicitly, or because some handle was forced).  `.result()`
    forces the flush and synchronises the device."""

    def __init__(self, session: "UnlearnerSession", ticket: int,
                 request: UnlearnRequest):
        self._session = session
        self._ticket = ticket
        self.request = request

    @property
    def done(self) -> bool:
        """True once the request has been served."""
        return self._ticket in self._session._responses

    def result(self, block: bool = True) -> UnlearnResponse:
        resp = self._session._resolve(self._ticket)
        if block:
            _sync(self._session.device)
        return resp

    @property
    def params(self) -> FlatParams:
        """Post-request model (forces resolution, synchronises)."""
        return self.result().params

    @property
    def stats(self) -> List[RetrainStats]:
        return self.result(block=False).stats


def plan_requests(pending: List[Tuple[int, UnlearnRequest]]
                  ) -> List[List[Tuple[int, UnlearnRequest]]]:
    """The coalescing planner: partition pending requests, in submission
    order, into serving groups.  Maximal runs of adjacent same-op requests
    with ``coalesce=True`` merge into one group (one replay);
    ``coalesce=False`` requests form singleton groups and break runs, so an
    explicitly serial request is never reordered past a burst."""
    groups: List[List[Tuple[int, UnlearnRequest]]] = []
    for ticket, req in pending:
        if (groups and req.coalesce
                and groups[-1][0][1].coalesce
                and groups[-1][0][1].op == req.op):
            groups[-1].append((ticket, req))
        else:
            groups.append([(ticket, req)])
    return groups


class UnlearnerSession:
    """Request-plan serving session over one cached training run, on
    `device` (None: the card; raises without one)."""

    def __init__(self, objective: Objective, params0: FlatParams,
                 dataset: Dataset, config: UnlearnerConfig, device=None):
        self.device = resolve_device(device)
        self.objective = objective
        self.params0 = params0.to(self.device)
        self.dataset = dataset
        self.config = config
        self.history: Optional[TrainingHistory] = None
        self.log: List[Dict] = []
        self._trained_params: FlatParams = self.params0
        self._algorithm: Optional[UnlearningAlgorithm] = None
        self._generator: Optional[torch.Generator] = None
        self._pending: List[Tuple[int, UnlearnRequest]] = []
        self._responses: Dict[int, UnlearnResponse] = {}
        self._failed: Dict[int, Exception] = {}
        self._tickets = 0
        # responses pin their post-request params on the device; beyond
        # this many, the oldest resolve to an "evicted" error instead of
        # holding memory for fire-and-forget submitters
        self.max_responses = 256
        # the lock serialises submit/flush/poll/save against each other
        self._lock = threading.RLock()
        self._oldest_pending_ts: Optional[float] = None
        self.autoflush_count = 0
        self.autoflush_reasons: Dict[str, int] = {"max_pending": 0,
                                                  "max_delay_s": 0}
        self._autoflush_timer = None
        # set by from_config(): the registry Model behind the objective
        self.model: Optional[Any] = None

    @classmethod
    def from_config(cls, name: str, dataset: Dataset, *,
                    reduced: Optional[Dict[str, Any]] = None,
                    config: Optional[UnlearnerConfig] = None, l2: float = 0.0,
                    remat: bool = False, loss_chunk: Optional[int] = None,
                    attn_impl: Optional[str] = None, init_seed: int = 1,
                    dtype: Optional[torch.dtype] = None,
                    params0: Optional[FlatParams] = None,
                    device=None) -> "UnlearnerSession":
        """A session from a registry model name.

        ``name`` is a `configs.registry` key (e.g. ``"internlm2-1.8b"``);
        ``reduced``, if given, is a dict of `ModelConfig.reduced` overrides
        (a smaller variant of the same architecture).  The model's loss
        becomes the objective through `Objective.from_model` (remat,
        loss_chunk, attn_impl and the compute dtype are forwarded), the
        initial params are ``model.init(init_seed)`` on `device` unless
        `params0` is given (weights carried across, say), and the built
        `models.registry.Model` is kept on ``session.model``."""
        from repro_torch.configs.registry import get_config
        from repro_torch.models.registry import build

        dev = resolve_device(device)
        model_cfg = get_config(name)
        if reduced is not None:
            model_cfg = model_cfg.reduced(**reduced)
        model = build(model_cfg)
        objective = Objective.from_model(
            model, remat=remat, loss_chunk=loss_chunk, l2=l2,
            attn_impl=attn_impl, dtype=dtype)
        if params0 is None:
            params0 = model.init(init_seed, device=dev)
        sess = cls(objective, params0, dataset, config or UnlearnerConfig(),
                   device=dev)
        sess.model = model
        return sess

    # -- phase 1: training with path caching --------------------------------

    def fit(self) -> FlatParams:
        if self._pending:
            raise RuntimeError(
                "flush() or resolve pending requests before refitting")
        c = self.config
        tier = c.history_tier
        if tier is None:
            tier = "host" if c.history_codec != "f32" else "stacked"
        meta = HistoryMeta(
            n=self.dataset.n,
            batch_size=min(c.batch_size, self.dataset.n),
            seed=c.seed,
            steps=c.steps,
            lr_schedule=tuple(c.lr_schedule) if c.lr_schedule else ((0, c.lr),),
            momentum=c.momentum,
        )
        self._trained_params, self.history = sgd_train_with_cache(
            self.objective, self.params0, self.dataset, meta, tier=tier,
            codec=c.history_codec, spill_dir=c.spill_dir,
            window=c.deltagrad.stream_window, device=self.device)
        self._algorithm = None
        return self._trained_params

    def _require_fit(self):
        if self.history is None:
            raise RuntimeError("call fit() (or restore()) before serving")

    # -- algorithm / engine / current model ---------------------------------

    @property
    def algorithm(self) -> UnlearningAlgorithm:
        """The session's ONE serving algorithm (created lazily from
        ``config.algorithm`` through the `core.algorithms` registry, bound
        to the cached run by `prepare()`)."""
        self._require_fit()
        if self._algorithm is None:
            algo_cls = get_algorithm(self.config.algorithm)
            algo = algo_cls(self.objective, self.dataset, self.config,
                            device=self.device)
            self._algorithm = algo.prepare(self.history, self._trained_params,
                                           self.params0)
        return self._algorithm

    @property
    def _engine(self) -> Optional[OnlineEngine]:
        """The algorithm's online engine, when it has one (deltagrad,
        retrain_oracle); None before the first request and for engine-less
        algorithms."""
        if self._algorithm is None:
            return None
        return getattr(self._algorithm, "_engine", None)

    def engine(self, placement: Optional[PlacementPolicy] = None
               ) -> OnlineEngine:
        """The session's online engine (created lazily; it owns liveness,
        the added rows' join columns and the rewritten cached path).  Only
        engine-backed algorithms (deltagrad, retrain_oracle) have one.

        `placement` overrides ``config.placement`` for the engine's store
        on FIRST creation; after that the engine, and its placement, is
        fixed for the session's life."""
        algo = self.algorithm
        if not hasattr(algo, "engine"):
            raise RuntimeError(
                f"algorithm {algo.name!r} does not serve through an "
                "OnlineEngine; use session.algorithm directly")
        return algo.engine(placement=placement)

    def warmup(self, specs=("delete",)) -> float:
        """The reference pre-compiles its request programs here; eager
        PyTorch compiles nothing, so this returns 0.0."""
        return self.algorithm.warmup(tuple(specs))

    @property
    def params(self) -> FlatParams:
        """Current model: forces every pending request and synchronises."""
        self.flush()
        p = self._algorithm.params if self._algorithm is not None \
            else self._trained_params
        _sync(self.device)
        return p

    # -- certified publication ----------------------------------------------

    def _publish_generator(self) -> torch.Generator:
        """The session's noise generator on its device, seeded from
        ``config.seed`` at first use; each publish advances it, and
        save()/restore() carries its state, so a restored session's next
        publish is bitwise the uninterrupted one's."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.config.seed)
        return self._generator

    def certificate(self, eps: Optional[float] = None,
                    delta: Optional[float] = None) -> Certificate:
        """The serving algorithm's current deletion certificate: no noise
        is drawn and no state changes."""
        self.flush()
        return self.algorithm.certificate(eps=eps, delta=delta)

    def publish(self, eps: Optional[float] = None,
                delta: Optional[float] = None):
        """(params, Certificate): certified release of the current model
        through the algorithm's mechanism, the noise drawn from the
        session's generator."""
        with self._lock:
            params = self.params  # flush + synchronise
            return self.algorithm.publish(self._publish_generator(), params,
                                          eps=eps, delta=delta)

    # -- phase 2: the request plan ------------------------------------------

    def submit(self, request: Optional[UnlearnRequest] = None, *,
               op: Optional[str] = None, rows: Optional[Sequence[int]] = None,
               data: Optional[Dict[str, np.ndarray]] = None,
               coalesce: bool = True) -> RequestHandle:
        """Enqueue one request; returns a lazy `RequestHandle`.

        Nothing executes until the session flushes.  Add payloads (`data`)
        ARE appended to the dataset here, so their row ids are assigned at
        submission and later requests may delete them."""
        with self._lock:
            return self._submit_locked(request, op=op, rows=rows, data=data,
                                       coalesce=coalesce)

    def _submit_locked(self, request, *, op, rows, data,
                       coalesce) -> RequestHandle:
        self._require_fit()
        if request is None:
            request = UnlearnRequest(op=op, rows=rows, data=data,
                                     coalesce=coalesce)
        if request.op not in ("delete", "add"):
            raise ValueError(f"op must be 'delete' or 'add', got "
                             f"{request.op!r}")
        if request.op == "add" and request.data is not None \
                and request.rows is None:
            request.rows = self.dataset.append(request.data).tolist()
        if request.rows is None or len(request.rows) == 0:
            raise ValueError("request names no rows")
        request.rows = [int(r) for r in request.rows]
        if len(set(request.rows)) != len(request.rows):
            raise ValueError(f"duplicate rows in request: {request.rows}")
        if request.op == "delete":
            pending_del = {r for _, q in self._pending if q.op == "delete"
                           for r in q.rows}
            for r in request.rows:
                if not 0 <= r < self.dataset.n:
                    raise ValueError(f"row {r} out of range")
                if self.dataset.removed[r] or r in pending_del:
                    raise ValueError(f"row {r} already deleted (or has a "
                                     "pending delete)")
        else:
            pending_add = {r for _, q in self._pending if q.op == "add"
                           for r in q.rows}
            already = (set(self._algorithm.added)
                       if self._algorithm is not None else set())
            base_n = self.history.meta.n
            for r in request.rows:
                if not base_n <= r < self.dataset.n:
                    raise ValueError(
                        "add requests name rows appended AFTER the cached "
                        f"training run (expected {base_n} <= row < "
                        f"{self.dataset.n}, got {r}); an original row "
                        "would be double-counted")
                if r in already or r in pending_add:
                    raise ValueError(f"row {r} already added (or has a "
                                     "pending add)")
        ticket = self._tickets
        self._tickets += 1
        if not self._pending:
            self._oldest_pending_ts = time.monotonic()
        self._pending.append((ticket, request))
        handle = RequestHandle(self, ticket, request)
        self._maybe_autoflush()
        return handle

    # -- deadline/size-triggered auto-flush ---------------------------------

    def _maybe_autoflush(self) -> bool:
        """Flush when the pending queue trips the configured size or
        staleness bound: size on every submit, the deadline at submit and
        through `poll()`."""
        c = self.config
        reason = None
        if (c.max_pending is not None and c.max_pending > 0
                and len(self._pending) >= c.max_pending):
            reason = "max_pending"
        elif (c.max_delay_s is not None and self._pending
              and time.monotonic() - self._oldest_pending_ts
              >= c.max_delay_s):
            reason = "max_delay_s"
        if reason is None:
            return False
        self.autoflush_count += 1
        self.autoflush_reasons[reason] += 1
        try:
            self.flush()
        except Exception:
            # a POLICY-triggered flush must not raise a failing group's
            # error out of submit(): the caller would lose the handle of
            # the request it just enqueued.  flush() already recorded the
            # failing tickets (their handles resolve to the error) and
            # requeued the groups behind them.
            pass
        return True

    def poll(self) -> bool:
        """Deadline tick for continuous-load serving: flushes (returning
        True) iff pending work has outstayed ``config.max_delay_s``."""
        with self._lock:
            return self._maybe_autoflush()

    def start_autoflush_timer(self, interval_s: Optional[float] = None):
        """DEPRECATED: drive the ``max_delay_s`` deadline from a daemon
        tick thread.  Returns a `repro_torch.serve.SessionFlushClock` (one
        default SLA class whose deadline is ``max_delay_s``; the old
        timer's ``ticks``/``stop()`` surface).  New code should construct
        `repro_torch.serve.ServingScheduler` for per-class deadlines,
        admission control and cross-tenant batching.  Starting a new clock
        stops the previous one."""
        warnings.warn(
            "session.start_autoflush_timer() is deprecated; serve through "
            "repro_torch.serve.ServingScheduler (SLA-class deadlines) or "
            "create repro_torch.serve.SessionFlushClock directly",
            DeprecationWarning, stacklevel=2)
        if self.config.max_delay_s is None:
            raise ValueError(
                "start_autoflush_timer() needs config.max_delay_s — there "
                "is no deadline for the timer to enforce")
        from repro_torch.serve.scheduler import SessionFlushClock
        if self._autoflush_timer is not None:
            self._autoflush_timer.stop()
        self._autoflush_timer = SessionFlushClock(self, interval_s=interval_s)
        return self._autoflush_timer

    @property
    def pending_age_s(self) -> float:
        """Seconds the OLDEST pending request has waited (0 if none)."""
        if not self._pending or self._oldest_pending_ts is None:
            return 0.0
        return time.monotonic() - self._oldest_pending_ts

    @property
    def pending_count(self) -> int:
        """Number of submitted but unserved requests."""
        return len(self._pending)

    def pending_requests(self) -> List[Tuple[int, UnlearnRequest]]:
        """The pending set as ``(ticket, request)`` pairs, in submission
        order: what the planner would group at the next flush."""
        with self._lock:
            return list(self._pending)

    def try_flush(self) -> Optional[List[UnlearnResponse]]:
        """Non-blocking `flush()`: serve the pending set IF the session
        lock is free right now, else return None without waiting."""
        if not self._lock.acquire(blocking=False):
            return None
        try:
            return self._flush_locked()
        finally:
            self._lock.release()

    def delete(self, rows: Sequence[int], coalesce: bool = True
               ) -> RequestHandle:
        return self.submit(op="delete", rows=list(rows), coalesce=coalesce)

    def add(self, data: Optional[Dict[str, np.ndarray]] = None,
            rows: Optional[Sequence[int]] = None, coalesce: bool = True
            ) -> RequestHandle:
        return self.submit(op="add", rows=rows, data=data, coalesce=coalesce)

    def _resolve(self, ticket: int) -> UnlearnResponse:
        if ticket not in self._responses and ticket not in self._failed:
            self.flush()
        if ticket in self._failed:
            err = self._failed[ticket]
            raise RuntimeError(
                f"request {ticket} was not served: {err}") from err
        return self._responses[ticket]

    def _record(self, ticket: int, resp: UnlearnResponse) -> None:
        self._responses[ticket] = resp
        while len(self._responses) > self.max_responses:
            old = next(iter(self._responses))  # oldest (insertion order)
            del self._responses[old]
            self._failed[old] = RuntimeError(
                "response evicted (more than max_responses unread "
                "responses); force handles promptly or raise "
                "session.max_responses")

    def flush(self) -> List[UnlearnResponse]:
        """Serve every pending request through the coalescing planner."""
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> List[UnlearnResponse]:
        if not self._pending:
            return []
        algo = self.algorithm
        pending, self._pending = self._pending, []
        ts0, self._oldest_pending_ts = self._oldest_pending_ts, None
        # size the add-column block for the whole plan once, as the
        # reference does (it keeps the schedule's width across the plan)
        n_adds = sum(len(q.rows) for _, q in pending if q.op == "add")
        algo.begin_plan(n_adds)
        out: List[UnlearnResponse] = []
        groups = plan_requests(pending)
        for gi, group in enumerate(groups):
            op = group[0][1].op
            rows = [r for _, q in group for r in q.rows]
            t0 = time.perf_counter()
            try:
                stats = algo.apply(op, rows, coalesce=group[0][1].coalesce)
            except Exception as e:
                # the failing group's handles resolve to this error; groups
                # after it go back on the queue (ahead of anything submitted
                # later) so their handles stay servable
                for ticket, _ in group:
                    self._failed[ticket] = e
                self._pending = [tr for g in groups[gi + 1:] for tr in g] \
                    + self._pending
                if self._pending:
                    # keep the ORIGINAL enqueue clock: requeued requests
                    # were already waiting
                    self._oldest_pending_ts = ts0 or time.monotonic()
                raise
            dispatch_s = time.perf_counter() - t0
            for ticket, req in group:
                resp = UnlearnResponse(request=req, stats=stats,
                                       group_size=len(rows),
                                       dispatch_s=dispatch_s,
                                       params=algo.params)
                self._record(ticket, resp)
                out.append(resp)
            self.log.append({"op": op, "rows": rows,
                             "coalesced": len(stats) == 1 and len(rows) > 1,
                             "stats": stats})
        return out

    # -- streams (serial Algorithm-3 semantics; the paper's request model) ---

    def serve_stream(self, ops: Sequence[Tuple[str, int]]) -> OnlineStats:
        """Serve ``(op, row)`` pairs one replay per row (never coalesced),
        returning aggregate `OnlineStats`; wall_time_s covers the replays
        and the final device synchronisation."""
        self._require_fit()
        self.flush()  # older pending work stays outside this stream's timer
        algo = self.algorithm
        handles = [self.submit(op=op, rows=[int(row)], coalesce=False)
                   for op, row in ops]
        stats = OnlineStats(compile_time_s=algo.compile_time_s)
        t0 = time.perf_counter()
        self.flush()
        _sync(self.device)
        stats.wall_time_s = time.perf_counter() - t0
        for h in handles:
            stats.per_request.extend(h.stats)
        return stats

    def stream_delete(self, rows: Sequence[int]) -> OnlineStats:
        return self.serve_stream([("delete", int(r)) for r in rows])

    def stream_add(self, data: Dict[str, np.ndarray]) -> OnlineStats:
        new_idx = self.dataset.append(data)
        return self.serve_stream([("add", int(r)) for r in new_idx])

    # -- reference: exact retraining (BaseL) ---------------------------------

    def baseline(self, indices, mode: str = "delete"):
        self._require_fit()
        idx = np.asarray(list(indices), dtype=np.int64)
        return baseline_retrain(self.objective, self.dataset,
                                self.history.meta, self.params0, idx, mode,
                                device=self.device)

    # -- snapshot / restore --------------------------------------------------

    def save(self, directory: str, step: Optional[int] = None,
             pending: str = "drain") -> str:
        """Write a restorable snapshot through `train.checkpoint`.

        ``pending="drain"`` (default) flushes every pending request first,
        so the snapshot is a consistent between-requests state;
        ``"refuse"`` raises `RuntimeError` while anything is pending.  The
        params ride as the checkpoint's shard; the history (any tier), the
        dataset (columns and deletion mask), the algorithm's name and state
        and the generator's state ride in the extra payload, as numpy.
        Returns the step directory.  Holds the session lock throughout."""
        if pending not in ("drain", "refuse"):
            raise ValueError(
                f"pending must be 'drain' or 'refuse', got {pending!r}")
        with self._lock:
            if pending == "refuse" and self._pending:
                raise RuntimeError(
                    f"save(pending='refuse') with {len(self._pending)} "
                    "pending request(s); flush() first or use "
                    "pending='drain'")
            return self._save_locked(directory, step)

    def _save_locked(self, directory: str, step: Optional[int]) -> str:
        self._require_fit()
        self.flush()
        params = self._algorithm.params if self._algorithm is not None \
            else self._trained_params
        step = self._tickets if step is None else int(step)
        extra = {
            "format": 2,
            "config": self.config,
            "params0": {k: v.detach().cpu().numpy()
                        for k, v in self.params0.items()},
            "history": self.history.state_dict(),
            "dataset": {
                "columns": {k: np.asarray(v)
                            for k, v in self.dataset.columns.items()},
                "removed": np.asarray(self.dataset.removed, dtype=bool).copy(),
            },
            "algorithm": ({
                "name": self._algorithm.name,
                "state": self._algorithm.state_dict(),
            } if self._algorithm is not None else None),
            # a CPU ByteTensor whatever the generator's device
            "generator_state": (self._generator.get_state().numpy()
                                if self._generator is not None else None),
            "tickets": self._tickets,
        }
        placement = self.config.placement
        if placement is None:
            return ckpt.save(directory, step, params, extra=extra)
        # every rank holds the same replicated state: rank 0 writes it, and
        # no rank returns (and may restore) before the write is whole
        if dist.get_rank() == 0:
            path = ckpt.save(directory, step, params, extra=extra)
        else:
            path = os.path.join(directory, f"step_{step:08d}")
        placement.barrier(self.device)
        return path

    @classmethod
    def restore(cls, directory: str, objective: Objective,
                step: Optional[int] = None, spill_dir: Optional[str] = None,
                device=None) -> "UnlearnerSession":
        """Rebuild a session from `save()` output on `device` (None: the
        card); the next request served is what the uninterrupted session
        would have served.  `objective` is code, not state: pass the one
        the saved session was built with.  A disk-tier history reads its
        windows where they were saved, or from a copy in `spill_dir`."""
        if step is None:
            step = ckpt.latest_step(directory)
            if step is None:
                raise FileNotFoundError(
                    f"no complete checkpoint under {directory}")
        dev = resolve_device(device)
        extra = ckpt.restore_extra(directory, step)
        if extra is None or extra.get("format") != 2:
            raise ValueError(f"{directory} step {step} holds no session "
                             "snapshot of this package (format 2)")
        history = TrainingHistory.from_state_dict(
            extra["history"], device=dev, spill_dir=spill_dir)
        ds = Dataset(extra["dataset"]["columns"])
        ds.removed = np.asarray(extra["dataset"]["removed"], dtype=bool).copy()
        params = ckpt.restore(directory, step, like=history.final_params)
        sess = cls(objective,
                   FlatParams.from_tensors(extra["params0"], device=dev), ds,
                   extra["config"], device=dev)
        sess.history = history
        sess._trained_params = params
        sess._tickets = int(extra.get("tickets", 0))
        gen_state = extra.get("generator_state")
        if gen_state is not None:
            sess._generator = torch.Generator(device=dev)
            sess._generator.set_state(torch.from_numpy(np.array(gen_state)))
        algo_desc = extra.get("algorithm")
        if algo_desc is not None:
            if algo_desc["name"] != sess.config.algorithm:
                raise ValueError(
                    f"snapshot was served by {algo_desc['name']!r} but the "
                    f"restored config selects {sess.config.algorithm!r}")
            sess.algorithm.load_state(algo_desc["state"], params)
        return sess
