"""Batch executor — drives the session's submit/coalesce/flush path.

One executor per scheduler, with AT MOST ONE replay in flight: a batch is
submitted to the session, flushed (one dispatch), and drained (one
synchronisation with the session's device, `core.engine._sync`) before
the next batch is taken.  The admission queue keeps admitting the whole
time, so the next batch forms WHILE the current replay runs — that
overlap is the continuous-batching throughput win: under load, every
drain's worth of arrivals coalesces into the next group replay instead
of queueing serial replays.

The executor never interprets requests — validation errors surface from
`session.submit`, group failures from `session.flush`; either way the
failing request's ticket resolves to the error and the rest of the batch
is served (the session's flush already isolates failing groups).

On the card the executor's thread makes the session's device current
before it serves anything, so its launches land on that device's default
stream, the one every other caller of the session uses: a threaded run
and an inline run of the same batches give bitwise the same params."""

from __future__ import annotations

import threading
from typing import List

import torch

from repro_torch.core.engine import _sync
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.queue import QueuedRequest


class Executor:
    """Single-consumer serving loop (thread-run or pumped inline)."""

    def __init__(self, scheduler):
        self.scheduler = scheduler
        self._thread = None
        self._stop = threading.Event()
        self._serve_lock = threading.Lock()  # one replay in flight, ever
        self._cuda_index = None
        self.batches_served = 0

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        # the card the thread launches on: the session's, or for a session
        # on "cuda" with no index, the starting thread's current card
        dev = self.scheduler.session.device
        self._cuda_index = None
        if dev.type == "cuda":
            self._cuda_index = (dev.index if dev.index is not None
                                else torch.cuda.current_device())
        self._stop.clear()
        self.scheduler.queue.reopen()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="unlearner-executor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.scheduler.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        sched = self.scheduler
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        tick = sched.config.idle_tick_s
        while not self._stop.is_set():
            if not sched.queue.wait_for_work(timeout=tick):
                continue
            batch = sched.take_batch()
            if not batch:
                # the flush policy says wait (hold / deadline slack) —
                # sleep exactly until the earliest ready time, but stay
                # interruptible so stop() never hangs on a held batch
                wait = sched.wait_hint if sched.wait_hint else tick
                self._stop.wait(min(wait, tick))
                continue
            self.serve_batch(batch)

    # -- one batch, one flush, one drain ------------------------------------

    def serve_batch(self, batch: List[QueuedRequest]) -> None:
        sched = self.scheduler
        session = sched.session
        with self._serve_lock, obs_trace.span(
                "serve.batch", size=len(batch),
                op=batch[0].op if batch else ""):
            try:
                cap_before = sched._row_cap_now()
                t_disp = sched.clock()
                handles = []
                for q in batch:
                    try:
                        h = session.submit(op=q.op, rows=q.rows,
                                           data=q.data, coalesce=q.coalesce)
                        # adds resolve their appended row ids at submit
                        # time; reflect them so the trace log / parity
                        # replays see the served rows
                        q.rows = list(h.request.rows)
                        handles.append((q, h))
                    except Exception as e:  # noqa: BLE001 — per-req fault
                        q.error = e
                        q.t_dispatch = t_disp
                        q.t_done = sched.clock()
                        q.batch_id = sched._batch_ids + 1
                        q.done.set()
                # one flush per batch: the planner coalesces the run into
                # one group replay.  flush() isolates a failing group by
                # requeueing the groups behind it, so keep flushing until
                # the session's pending set is empty (bounded by the
                # batch size).
                for _ in range(max(1, len(handles))):
                    try:
                        session.flush()
                    except Exception:  # noqa: BLE001 — outcomes below
                        pass
                    if session.pending_count == 0:
                        break
                if handles:
                    try:
                        _sync(session.device)
                    except Exception:  # noqa: BLE001 — per-handle below
                        pass
                t_done = sched.clock()
                for q, h in handles:
                    q.t_dispatch = t_disp
                    q.t_done = t_done
                    q.batch_id = sched._batch_ids + 1
                    try:
                        h.result(block=False)
                    except Exception as e:  # noqa: BLE001
                        q.error = e
                    q.done.set()
                cap_after = sched._row_cap_now()
                retraced = (cap_before is not None
                            and self.batches_served > 0
                            and cap_after != cap_before)
                self.batches_served += 1
                # the FULL batch, failed submits included: the monitor's
                # failed counter and the batch/trace log must record them
                sched.note_service(max(t_done - t_disp, 1e-9), batch,
                                   retraced)
            finally:
                # always settle the batch with the queue — refresh the
                # ledger's appended_rows, THEN release the in-flight rows
                # and count, so drain()/save() see a true between-requests
                # state and add headroom never double-counts
                sched._note_batch_done(batch)

    def drain_wait(self, timeout: float = 30.0) -> bool:
        """Wait (thread mode) until the queue is empty AND no taken batch
        is still being served; True on success.  `ServingScheduler.drain`
        uses this so a drain (and a ``pending="drain"`` snapshot) never
        lands mid-batch."""
        return self.scheduler.queue.wait_idle(timeout=timeout)
