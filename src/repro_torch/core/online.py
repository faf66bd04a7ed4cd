"""DeltaGrad online deletion and addition: the paper's Algorithm 3
(Appendix C.2).

Requests arrive one at a time.  After each request the cached path is
REWRITTEN, so the next request corrects the previous DeltaGrad path rather
than the original training run:

  explicit steps:  w_t <- w^I_t,  g_t <- the exact mean gradient of the
                   post-request objective at w^I_t;
  approx steps:    w_t <- w^I_t,  g_t <- g^a_t, the approximated gradient
                   (eq. (S62)), which keeps each request's cost independent
                   of how many came before.

The minibatch schedule is always replayed against the ORIGINAL row
numbering: deletions shrink each batch's effective size ``B_t(k) = B -
|batch_t ∩ R_k|`` (the paper's n - k bookkeeping), and rows appended by
earlier ADD requests join each batch through their precomputed,
prefix-stable join masks (`data.sampler`).  Heavy-ball histories replay
with the velocity rebuilt from ``vel_0 = 0`` in every request.

`OnlineEngine` owns the stream's state (liveness over original and added
rows, the added rows' join masks) and serves every request, delete or add,
a row or a group of rows, SGD or momentum, through
`core.engine.run_online_request`, against the history served by a
`core.store.HistoryStore`: resident, or streamed in windows from the host
or disk tier, whose rewrites go back through the codec; on a
`core.store.PlacementPolicy`'s mesh, the rank's shard of either, each
rank serving every request with its part of every batch (the gradients
summed over the data axis) and the whole-vector update.

Each request runs under an ``online.request`` span (op, k, and the
whole replay's roofline ``pred_s``); `OnlineEngine.warmup` emits
``online.warmup`` and sets the ``online.compile_time_s`` gauge, which
reads 0.0 here (the reference compiles its request programs there).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.deltagrad import Objective
from repro_torch.core.engine import (DeltaGradConfig, RetrainStats,
                                     _next_pow2, _scan_pred, resolve_device,
                                     run_online_request)
from repro_torch.core.history import TrainingHistory
from repro_torch.core.store import (HistoryStore, PlacementPolicy,
                                   make_psum_grad_fn)
from repro_torch.data.dataset import Dataset
from repro_torch.data.sampler import (ReplaySchedule, addition_mask_all,
                                      batch_indices_all, build_online_schedule)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.tree import FlatParams


@dataclass
class OnlineStats:
    per_request: List[RetrainStats] = field(default_factory=list)
    wall_time_s: float = 0.0
    # the reference's first-request compile cost; eager PyTorch compiles
    # nothing per shape, so it stays 0.0
    compile_time_s: float = 0.0

    @property
    def grad_examples(self) -> int:
        return sum(s.grad_examples for s in self.per_request)

    @property
    def grad_examples_baseline(self) -> int:
        return sum(s.grad_examples_baseline for s in self.per_request)

    @property
    def theoretical_speedup(self) -> float:
        return self.grad_examples_baseline / max(self.grad_examples, 1)


Request = Union[int, Tuple[str, int]]


class OnlineEngine:
    """Algorithm-3 request engine over one cached training run, on the
    history's device.

    Owns what outlives a request: the (T, B) original schedule, liveness
    over original and added rows, and the added rows' join masks, grown
    prefix-stably as adds arrive.  The added-column block of the schedule
    is padded to a power of two, as the reference pads it, so both
    packages replay identical schedules.  `close` stops the store's
    threads (a streamed history).  With `placement`, every rank of the
    default process group builds the engine and serves every request."""

    def __init__(self, objective: Objective, history: TrainingHistory,
                 ds: Dataset, cfg: DeltaGradConfig, add_capacity: int = 0,
                 device=None, placement: Optional[PlacementPolicy] = None):
        dev = resolve_device(device)
        if history.device.type != dev.type:
            raise ValueError(f"history lives on {history.device}, requests "
                             f"asked for {dev}")
        self.objective, self.history, self.ds, self.cfg = (objective, history,
                                                           ds, cfg)
        self.device = dev
        # a larger block up front keeps the schedule's width constant
        # across an addition stream
        self.add_capacity = int(add_capacity)
        meta = history.meta
        self.idx_all = batch_indices_all(meta.seed, meta.steps, meta.n,
                                         meta.batch_size)
        # rows deleted before (by an earlier stream over this rewritten
        # history) stay masked out of the replayed batches
        self.live = ~np.asarray(ds.removed, dtype=bool)
        self.added: List[int] = []
        self._joins: Optional[np.ndarray] = None  # (T, capacity) bool
        self.params: FlatParams = history.final_params
        # the reference's pow2-bucketed row capacity, kept as snapshot
        # bookkeeping only: eager PyTorch needs no fixed column shapes, so
        # the device columns are never padded to it
        self._base_n = ds.n
        self._row_cap = ds.n + (_next_pow2(self.add_capacity)
                                if self.add_capacity else 0)
        # the last request's pair ring: snapshot state only (every request
        # rebuilds its ring from the rewritten path)
        self.last_ring: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.store = HistoryStore.create(history, placement=placement,
                                         window=cfg.stream_window,
                                         decode=cfg.stream_decode)
        runner = self.store.sharded_replay()
        self.grad_fn = (objective.make_grad_fn() if runner is None
                        else make_psum_grad_fn(objective, runner.data_group))

    def close(self) -> None:
        self.store.close()

    # -- stream state --------------------------------------------------------

    @property
    def _add_pad(self) -> int:
        need = max(len(self.added), self.add_capacity)
        return _next_pow2(need) if need else 0

    def _ensure_joins(self, n_cols: int) -> None:
        if n_cols and (self._joins is None or self._joins.shape[1] < n_cols):
            meta = self.history.meta
            self._joins = addition_mask_all(meta.seed, meta.steps, meta.n,
                                            meta.batch_size, _next_pow2(n_cols))

    def _schedule(self, op: str, rows: Sequence[int]) -> ReplaySchedule:
        meta = self.history.meta
        K = len(rows)
        self._ensure_joins(len(self.added) + (K if op == "add" else 0))
        if op == "delete":
            # a step's changed rows are at most its batch's originals plus
            # the group's previously added rows: cap the pad there
            n_added_in = len(set(rows) & set(self.added)) if self.added else 0
            r_eff = min(K, min(meta.batch_size, meta.n) + n_added_in)
        else:
            r_eff = K  # an add group carries all K rows in the changed block
        return build_online_schedule(
            meta.seed, meta.steps, meta.n, meta.batch_size, rows, op,
            meta.lr_at, self.live, np.asarray(self.added, np.int64),
            self._joins, self._add_pad, idx_all=self.idx_all,
            r_pad=_next_pow2(r_eff))

    def _cols(self) -> Dict[str, torch.Tensor]:
        """The device columns, with the row capacity grown as the
        reference grows it (a raised ``add_capacity`` counts)."""
        need = max(len(self.added), self.add_capacity)
        self._row_cap = max(self._row_cap,
                            self._base_n + (_next_pow2(need) if need else 0))
        if self.ds.n > self._row_cap:
            self._row_cap = self._base_n + _next_pow2(self.ds.n - self._base_n)
        return self.ds.device_columns(self.device)

    # -- requests ------------------------------------------------------------

    def warmup(self, ops=("delete",)) -> float:
        """The reference compiles its request programs here, on throwaway
        requests; eager PyTorch compiles nothing, so this returns 0.0.  It
        keeps the reference's bookkeeping: the row capacity grows to the
        raised ``add_capacity`` (`_cols`, which also uploads the columns),
        under an ``online.warmup`` span, and the ``online.compile_time_s``
        gauge is set."""
        if not self.live[:self.history.meta.n].any():
            return 0.0
        with obs_trace.span("online.warmup", ops=len(ops)):
            self._cols()
        obs_metrics.get_registry().gauge(
            "online.compile_time_s", unit="s", owner="core.online").set(0.0)
        return 0.0

    def request(self, op: str, row: int) -> RetrainStats:
        """Serve one delete or add request, rewriting the history."""
        return self.request_group(op, [int(row)])

    def request_group(self, op: str, rows: Sequence[int]) -> RetrainStats:
        """Serve a group of same-op requests as ONE replay: deletion with
        the paper's index-set semantics (Algorithm 1 with R = `rows`) on
        the current rewritten path, addition with every new row joining
        through its own mask column.  The result is the group correction,
        not the composition of single-row corrections."""
        if op not in ("delete", "add"):
            raise ValueError(f"op must be 'delete' or 'add', got {op!r}")
        rows = [int(r) for r in rows]
        if len(rows) != len(set(rows)):
            raise ValueError(f"duplicate rows in {rows}")
        if max(rows) >= len(self.live):  # the dataset grew since construction
            grown = np.ones(self.ds.n, dtype=bool)
            grown[:len(self.live)] = self.live
            self.live = grown
        if op == "delete":
            gone = [r for r in rows if not self.live[r]]
            if gone:
                raise ValueError(f"rows already deleted: {gone}")
        else:
            n0 = self.history.meta.n
            for row in rows:
                if not n0 <= row < self.ds.n:
                    raise ValueError(
                        "add requests name rows appended after the cached "
                        f"training run (expected {n0} <= row < {self.ds.n}, "
                        f"got {row}); an original row would count twice")
                if row in self.added:
                    raise ValueError(f"row {row} already added")
        sched = self._schedule(op, rows)
        meta = self.history.meta
        # the whole replay's roofline bound (None, and not computed, while
        # tracing is off); the tracer stamps the measured time on exit
        pred = _scan_pred(self.params.numel, meta.steps, sched.r_pad,
                          self.cfg.history_size, bool(meta.momentum))
        with obs_trace.span("online.request", op=op, k=len(rows), pred_s=pred):
            params, rstat = run_online_request(
                self.grad_fn, self.store, self._cols(), sched, self.cfg)
        ring = rstat.extra.pop("lbfgs_ring", None)
        if ring is not None:
            self.last_ring = ring
        if op == "delete":
            for row in rows:
                self.live[row] = False
                self.ds.removed[row] = True
        else:
            self.added.extend(rows)
        self.params = params
        return rstat

    # -- snapshot and restore --------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """Stream state the dataset cannot rebuild: liveness over original
        and added rows, the added rows' order (their join columns), the
        add capacity, the original row count and row capacity, and the
        last request's pair ring (numpy; recorded only, since every request
        rebuilds its ring)."""
        ring = None if self.last_ring is None else tuple(
            x.detach().cpu().numpy() for x in self.last_ring)
        return {"live": np.asarray(self.live, dtype=bool).copy(),
                "added": list(self.added),
                "add_capacity": int(self.add_capacity),
                "base_n": int(self._base_n),
                "row_cap": int(self._row_cap),
                "lbfgs_ring": ring}

    def load_state(self, state: Dict[str, Any]) -> None:
        self.live = np.asarray(state["live"], dtype=bool).copy()
        self.added = list(state["added"])
        self.add_capacity = int(state["add_capacity"])
        self._base_n = int(state.get("base_n", self.ds.n))
        self._row_cap = max(int(state.get("row_cap", self.ds.n)), self.ds.n)
        ring = state.get("lbfgs_ring")
        self.last_ring = None if ring is None else tuple(
            torch.from_numpy(np.asarray(x)).to(self.device) for x in ring)
        self._joins = None
        self._ensure_joins(len(self.added))


def online_deltagrad(objective: Objective, history: TrainingHistory,
                     ds: Dataset, requests: Sequence[Request],
                     cfg: DeltaGradConfig, mode: str = "delete",
                     device=None, placement: Optional[PlacementPolicy] = None
                     ) -> Tuple[FlatParams, OnlineStats]:
    """Serve requests one after the other, rewriting the history.

    `requests` is a sequence of row ids (all of `mode`) or of ``(op,
    row)`` pairs for a mixed stream.  Rows to add must already be
    appended to `ds` (``ds.n > history.meta.n``); each joins the replayed
    batches through `data.sampler.addition_mask`, with the inclusion
    probability of an original row.  Each request's ``wall_time_s`` runs
    to the end of its device work.  With `placement`, every rank of the
    default process group makes this call (`OnlineEngine`)."""
    if mode not in ("delete", "add"):
        raise ValueError(f"mode must be 'delete' or 'add', got {mode!r}")
    requests = list(requests)
    ops = [r[0] if isinstance(r, (tuple, list)) else mode for r in requests]
    engine = OnlineEngine(objective, history, ds, cfg,
                          add_capacity=ops.count("add"), device=device,
                          placement=placement)
    stats = OnlineStats()
    t_start = time.perf_counter()
    try:
        for r in requests:
            op, row = r if isinstance(r, (tuple, list)) else (mode, r)
            stats.per_request.append(engine.request(op, int(row)))
    finally:
        engine.close()
    stats.wall_time_s = time.perf_counter() - t_start
    return engine.params, stats
