"""Seeded load generation for the unlearning serving tier.

Production deletion traffic is OPEN-LOOP: requests arrive on their own
clock whether or not the service keeps up, which is what exposes queueing
behavior (throughput-vs-p99 curves, deadline misses past the knee) that a
closed loop — submit, wait, repeat — structurally cannot.  This module
generates both, deterministically from a seed:

  * `poisson_trace`   — memoryless arrivals at a fixed offered load, the
                        bench's default (`--trace poisson`);
  * `diurnal_trace`   — a Poisson process whose rate follows a sinusoidal
                        day curve (thinning construction), for burst
                        behavior across load swings;
  * `fixed_trace`     — deterministic equal spacing (the old serve.py
                        ``--arrival-ms`` behavior, kept as the
                        reproducible mode tests drive);
  * `materialize`     — binds rows/payloads to a trace deterministically:
                        deletes draw DISJOINT rows from a seeded
                        permutation of the live set, adds carry seeded
                        resampled payloads — so the same (trace_seed,
                        rows_seed) pair replays bitwise-identically no
                        matter how the scheduler batches it;
  * `LoadGenerator`   — drives a trace at a `ServingScheduler` open-loop
                        (wall-clock sleeps to each arrival) or
                        closed-loop (parity tests), counting backpressure
                        rejections instead of dying on them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.queue import RetryAfter
from repro_torch.serve.scheduler import ServeTicket, ServingScheduler


@dataclass
class TraceEvent:
    """One arrival: offset `t` seconds from trace start, fully typed; rows
    and add payloads are bound later by `materialize` so arrival shape and
    row identity replay independently."""

    t: float
    op: str
    tenant: str
    sla_class: str
    n_rows: int = 1
    rows: Optional[List[int]] = None
    data: Optional[Dict[str, np.ndarray]] = None


def _mix_names(mix) -> Tuple[List[str], np.ndarray]:
    """Normalize a mix ({name: weight} or [names]) to (names, probs)."""
    if isinstance(mix, dict):
        names = sorted(mix)
        w = np.asarray([float(mix[k]) for k in names], dtype=np.float64)
    else:
        names = list(mix)
        w = np.ones(len(names), dtype=np.float64)
    return names, w / w.sum()


def _assign(rng: np.random.Generator, times: np.ndarray, tenants,
            classes, add_frac: float) -> List[TraceEvent]:
    t_names, t_p = _mix_names(tenants)
    c_names, c_p = _mix_names(classes)
    events = []
    for t in times:
        op = "add" if rng.random() < add_frac else "delete"
        events.append(TraceEvent(
            t=float(t), op=op,
            tenant=t_names[int(rng.choice(len(t_names), p=t_p))],
            sla_class=c_names[int(rng.choice(len(c_names), p=c_p))]))
    return events


def poisson_trace(rate: float, n_events: int, seed: int,
                  tenants=("default",), classes=("interactive",),
                  add_frac: float = 0.0) -> List[TraceEvent]:
    """Open-loop Poisson arrivals at `rate` requests/s (exponential
    inter-arrival gaps), deterministic per seed."""
    assert rate > 0 and n_events > 0
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA221]))
    gaps = rng.exponential(1.0 / rate, size=n_events)
    return _assign(rng, np.cumsum(gaps), tenants, classes, add_frac)


def diurnal_trace(base_rate: float, peak_rate: float, period_s: float,
                  n_events: int, seed: int,
                  tenants=("default",), classes=("interactive",),
                  add_frac: float = 0.0) -> List[TraceEvent]:
    """Non-homogeneous Poisson by thinning: the instantaneous rate swings
    sinusoidally between base and peak over `period_s` (a compressed
    day), so the scheduler sees both idle valleys and overload crests."""
    assert peak_rate >= base_rate > 0
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD10]))
    times, t = [], 0.0
    while len(times) < n_events:
        t += rng.exponential(1.0 / peak_rate)
        rate_t = base_rate + (peak_rate - base_rate) * 0.5 * (
            1.0 + np.sin(2.0 * np.pi * t / period_s))
        if rng.random() < rate_t / peak_rate:
            times.append(t)
    return _assign(rng, np.asarray(times), tenants, classes, add_frac)


def fixed_trace(interval_s: float, n_events: int, seed: int = 0,
                tenants=("default",), classes=("interactive",),
                add_frac: float = 0.0) -> List[TraceEvent]:
    """Deterministic fixed-interval arrivals (the legacy ``--arrival-ms``
    load shape).  Ops/tenants/classes still draw from the seeded rng so
    mixes work, but arrival TIMES carry no randomness."""
    assert interval_s > 0 and n_events > 0
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xF18ED]))
    times = interval_s * np.arange(1, n_events + 1)
    return _assign(rng, times, tenants, classes, add_frac)


def materialize(events: Sequence[TraceEvent], dataset, seed: int,
                base_n: Optional[int] = None) -> List[TraceEvent]:
    """Bind rows/payloads deterministically: delete events consume
    DISJOINT rows from a seeded permutation of the currently-live original
    rows (so no batching order can conflict), add events get payloads
    resampled (seeded) from the original rows.  Returns the same event
    objects, filled in."""
    base_n = int(base_n if base_n is not None else dataset.n)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x805]))
    live = np.flatnonzero(~np.asarray(dataset.removed[:base_n], dtype=bool))
    perm = rng.permutation(live)
    cursor = 0
    for ev in events:
        if ev.rows is not None or ev.data is not None:
            continue
        if ev.op == "delete":
            if cursor + ev.n_rows > perm.size:
                raise ValueError(
                    f"trace deletes {cursor + ev.n_rows} rows but only "
                    f"{perm.size} live rows exist")
            ev.rows = [int(r) for r in perm[cursor:cursor + ev.n_rows]]
            cursor += ev.n_rows
        else:
            src = rng.integers(0, base_n, size=ev.n_rows)
            ev.data = {k: np.asarray(v)[src]
                       for k, v in dataset.columns.items()}
    return events


@dataclass
class LoadResult:
    """What a generator run produced: tickets in submission order plus
    backpressure accounting (a rejected arrival is dropped and counted —
    open-loop clients retry on their own clock, not ours)."""

    tickets: List[ServeTicket] = field(default_factory=list)
    events: List[TraceEvent] = field(default_factory=list)
    rejected: int = 0
    retry_after_s: List[float] = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def served(self) -> int:
        return sum(1 for t in self.tickets if t.done and t.error is None)


class LoadGenerator:
    """Drives a materialized trace at a scheduler."""

    def __init__(self, scheduler: ServingScheduler):
        self.scheduler = scheduler

    def _submit(self, ev: TraceEvent, out: LoadResult) -> None:
        try:
            t = self.scheduler.submit(op=ev.op, rows=ev.rows, data=ev.data,
                                      tenant=ev.tenant,
                                      sla_class=ev.sla_class)
            out.tickets.append(t)
            out.events.append(ev)
        except RetryAfter as e:
            out.rejected += 1
            out.retry_after_s.append(e.retry_after_s)

    def open_loop(self, events: Sequence[TraceEvent],
                  time_scale: float = 1.0) -> LoadResult:
        """Submit each event at its arrival time (wall-clock), regardless
        of service progress — the queue, not the caller, absorbs overload.
        `time_scale` stretches the trace (2.0 = half the offered load)."""
        out = LoadResult()
        t0 = time.perf_counter()
        for ev in events:
            delay = ev.t * time_scale - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            self._submit(ev, out)
        out.wall_s = time.perf_counter() - t0
        return out

    def closed_loop(self, events: Sequence[TraceEvent],
                    timeout_s: float = 60.0) -> LoadResult:
        """Submit-wait-repeat (arrival times ignored): the deterministic
        mode parity and snapshot tests replay, since batches degenerate
        to submission order."""
        out = LoadResult()
        t0 = time.perf_counter()
        for ev in events:
            self._submit(ev, out)
            if out.tickets:
                out.tickets[-1].wait(timeout=timeout_s)
        out.wall_s = time.perf_counter() - t0
        return out
