"""The port's serving tier (`repro_torch.serve`), its session shims and the
``unlearn`` CLI, against the JAX package on the CPU.

Each class is the counterpart of one class of the reference's
`tests/test_serve.py`.  A queue scenario runs in both packages and must
give the same admissions, rejections and retry hints.  A scenario that
serves a stream runs both packages' sessions (the same numpy data and
initial weights) under the same virtual clock and must give the same batch
sequence, the same monitor summary (under the virtual clock every
latency is deterministic, so the whole summary is compared) and final
params within 1e-6.  Load-generator traces are bitwise equal.  The
threaded executor's batches depend on wall time, so that run's logged
batch sequence is re-served inline: on a restored snapshot of the port's
session (bitwise) and on a JAX session (1e-6).
"""

import copy
import threading
import time
import warnings
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

import repro.serve as jserve
from repro.core.deltagrad import DeltaGradConfig as JDGConfig
from repro.core.session import UnlearnerConfig as JConfig
from repro.core.session import UnlearnerSession as JSession
from repro.data.synthetic import binary_classification as j_binary
from repro.models.simple import logreg_objective as j_logreg

import repro_torch.serve as tserve
from repro_torch.core.deltagrad import DeltaGradConfig
from repro_torch.core.engine import _next_pow2
from repro_torch.core.session import (AutoFlushTimer, UnlearnerConfig,
                                      UnlearnerSession)
from repro_torch.data.synthetic import binary_classification as t_binary
from repro_torch.models.simple import logreg_objective, params_from_jax
from repro_torch.obs.metrics import Histogram
from repro_torch.serve import (AddCapacityLedger, AdmissionQueue,
                               LoadGenerator, RetryAfter, ServeConfig,
                               ServingScheduler, SessionFlushClock, SLAClass,
                               TenantQuota, fixed_trace, materialize,
                               poisson_trace)

TOL = 1e-6
N, D = 200, 16
CFG = dict(period=5, burn_in=10, history_size=2)
META = dict(steps=30, batch_size=64, lr=0.2, seed=0)
L2 = 1e-3


def _p0():
    rng = np.random.default_rng(1)
    return {"w": (0.01 * rng.normal(size=D)).astype(np.float32),
            "b": np.zeros((), np.float32)}


PKG = {
    "jax": SimpleNamespace(
        serve=jserve, session=JSession, config=JConfig, dg=JDGConfig,
        data=j_binary, obj=j_logreg,
        init=lambda: {k: jnp.asarray(v) for k, v in _p0().items()}, kw={}),
    "torch": SimpleNamespace(
        serve=tserve, session=UnlearnerSession, config=UnlearnerConfig,
        dg=DeltaGradConfig, data=t_binary, obj=logreg_objective,
        init=lambda: params_from_jax(_p0(), "cpu"),
        kw={"device": "cpu"}),
}


def _session(pkg="torch", **kw):
    """The reference test's problem (n 200, d 16, T 30, B 64), fitted."""
    ns = PKG[pkg]
    cfg = ns.config(deltagrad=ns.dg(**CFG), **META, **kw)
    sess = ns.session(ns.obj(l2=L2), ns.init(), ns.data(n=N, d=D, seed=0),
                      cfg, **ns.kw)
    sess.fit()
    return sess


def _flat(pkg, params):
    if pkg == "torch":
        return params.flat.detach().cpu().numpy()
    return np.concatenate([np.asarray(params[k], np.float32).reshape(-1)
                           for k in sorted(params)])


def _req(serve, seq=0, tenant="t", op="delete", rows=(1,), sla="interactive",
         t=0.0, deadline=1.0, coalesce=True, data=None):
    return serve.QueuedRequest(seq=seq, tenant=tenant, sla_class=sla, op=op,
                               rows=list(rows) if rows is not None else None,
                               data=data, coalesce=coalesce, t_enqueue=t,
                               deadline=deadline)


class VirtualClock:
    """Deterministic monotonic clock: a fixed tick per call; `t` may be
    moved forward to an arrival."""

    def __init__(self, tick_s=1e-3):
        self.t = 0.0
        self.tick_s = tick_s

    def __call__(self):
        self.t += self.tick_s
        return self.t


def _both(scenario):
    """Run `scenario(pkg)` in both packages: (jax result, port result)."""
    return scenario("jax"), scenario("torch")


def _batches(sched):
    """The batch sequence: each batch's (op, rows, tenants, classes,
    coalesce)."""
    return [(r["op"], list(r["rows"]), r["tenants"], r["classes"],
             r["coalesce"]) for r in sched.batch_log]


def _served(pkg, sched, tickets=()):
    """What a served stream must agree on across packages."""
    seqs = {}
    for tk in tickets:
        seqs.setdefault(tk.req.batch_id, []).append(tk.req.seq)
    return dict(batches=_batches(sched), stats=sched.stats(),
                seqs=sorted(seqs.items(), key=lambda kv: (kv[0] is None,
                                                          kv[0] or 0)),
                params=_flat(pkg, sched.session.params))


def _same_stream(a, b):
    assert b["batches"] == a["batches"]
    assert b["seqs"] == a["seqs"]
    assert b["stats"] == a["stats"]
    np.testing.assert_allclose(b["params"], a["params"], rtol=0, atol=TOL)


# --------------------------------------------------------------------------
# Admission queue: bounds, quotas, backpressure
# --------------------------------------------------------------------------


def _outcome(fn):
    """(True, value), or (False, exception type, what the exception says:
    the reason's first word and the retry hint, or the message)."""
    try:
        return (True, fn())
    except RetryAfter as e:
        return (False, "RetryAfter", e.reason.split(" ")[0], e.retry_after_s)
    except jserve.RetryAfter as e:
        return (False, "RetryAfter", e.reason.split(" ")[0], e.retry_after_s)
    except RuntimeError as e:
        return (False, "RuntimeError", str(e))


def _counts(q):
    return (q.admitted, q.rejected_depth, q.rejected_tenant,
            q.rejected_add_capacity, q.blocked_admissions, q.depth,
            q.in_flight)


class TestAdmissionQueue:
    def test_depth_bound_rejects_with_retry_after(self):
        def scenario(pkg):
            s = PKG[pkg].serve
            q = s.AdmissionQueue(max_depth=2)
            out = [_outcome(lambda: q.admit(_req(s)).seq) for _ in range(4)]
            return out, _counts(q)

        j, t = _both(scenario)
        assert t == j
        (out, counts) = t
        assert [o[0] for o in out] == [True, True, False, False]
        assert counts[:2] == (2, 2) and out[2][3] > 0

    def test_tenant_quota_isolates_tenants(self):
        def scenario(pkg):
            s = PKG[pkg].serve
            q = s.AdmissionQueue(max_depth=100,
                                 tenant_quota=s.TenantQuota(max_pending=2))
            out = [_outcome(lambda tn=tn: q.admit(_req(s, tenant=tn)).seq)
                   for tn in ("a", "a", "a", "b")]
            return out, _counts(q), q.tenant_depth("a"), q.tenant_depth("b")

        j, t = _both(scenario)
        assert t == j
        assert [o[0] for o in t[0]] == [True, True, False, True]
        assert t[1][2] == 1 and t[2:] == (2, 1)

    def test_take_frees_quota(self):
        q = AdmissionQueue(max_depth=100, tenant_quota=TenantQuota(max_pending=1))
        q.admit(_req(tserve, tenant="a"))
        with pytest.raises(RetryAfter):
            q.admit(_req(tserve, tenant="a"))
        q.take(lambda p: list(p))
        q.admit(_req(tserve, tenant="a"))  # quota freed by the take
        assert q.rejected_tenant == 1 and q.admitted == 2

    def test_block_mode_times_out_to_retry_after(self):
        q = AdmissionQueue(max_depth=1, on_full="block", block_timeout_s=0.05)
        q.admit(_req(tserve))
        with pytest.raises(RetryAfter, match="block_timeout_s"):
            q.admit(_req(tserve))
        assert q.blocked_admissions == 1 and q.rejected_depth == 1

    def test_block_mode_wakes_when_space_frees(self):
        q = AdmissionQueue(max_depth=1, on_full="block", block_timeout_s=5.0)
        q.admit(_req(tserve))
        admitted = threading.Event()

        def blocked_producer():
            q.admit(_req(tserve, seq=1))
            admitted.set()

        th = threading.Thread(target=blocked_producer, daemon=True)
        th.start()
        assert not admitted.wait(0.05)  # parked: the queue is full
        q.take(lambda p: p[:1])         # space frees -> producer wakes
        assert admitted.wait(2.0)
        th.join(timeout=2.0)

    def test_closed_queue_raises_runtime_error_and_reopens(self):
        def scenario(pkg):
            s = PKG[pkg].serve
            q = s.AdmissionQueue(max_depth=4)
            q.close()
            a = _outcome(lambda: q.admit(_req(s)).seq)
            q.reopen()
            return a, _outcome(lambda: q.admit(_req(s)).seq)

        j, t = _both(scenario)
        assert t == j
        assert t[0][:2] == (False, "RuntimeError") and "closed" in t[0][2]
        assert t[1] == (True, 0)

    def test_take_is_atomic_choice(self):
        def scenario(pkg):
            s = PKG[pkg].serve
            q = s.AdmissionQueue(max_depth=10)
            for i in range(4):
                q.admit(_req(s, rows=[i]))
            batch = q.take(lambda p: [x for x in p if x.seq % 2 == 0])
            return [b.seq for b in batch], [b.seq for b in q.snapshot()]

        j, t = _both(scenario)
        assert t == j == ([0, 2], [1, 3])

    def test_taken_batch_is_in_flight_until_noted_served(self):
        q = AdmissionQueue(max_depth=10)
        q.admit(_req(tserve))
        batch = q.take(lambda p: list(p))
        assert q.depth == 0 and q.in_flight == 1
        assert not q.wait_idle(timeout=0.01)
        q.note_served(batch)
        assert q.in_flight == 0 and q.wait_idle(timeout=0.01)

    def test_retry_hints_follow_the_drain_rate(self):
        """Under one virtual clock both packages estimate the same drain
        rate, so they hand out the same retry-after hints."""
        def scenario(pkg):
            s = PKG[pkg].serve
            q = s.AdmissionQueue(max_depth=3, clock=VirtualClock(0.01))
            hints = []
            for i in range(12):
                hints.append(_outcome(lambda i=i: q.admit(_req(s, rows=[i])).seq))
                if i % 4 == 3:
                    q.take(lambda p: p[:2])
            return hints, _counts(q)

        j, t = _both(scenario)
        assert t == j
        assert any(not o[0] for o in t[0])


# --------------------------------------------------------------------------
# Add-capacity ledger
# --------------------------------------------------------------------------


class TestAddCapacityLedger:
    def test_padding_counts_as_capacity(self):
        led = AddCapacityLedger()
        led.refresh(staged_rows=_next_pow2(5), appended_rows=5)
        assert led.headroom == 3
        assert led.try_charge(3)
        assert not led.try_charge(1)   # the 4th row crosses the boundary
        led.release(3)
        assert led.headroom == 3

    def test_bucket_equals_the_reference(self):
        for adds in range(0, 130):
            assert AddCapacityLedger.bucket(adds) \
                == jserve.AddCapacityLedger.bucket(adds)
        assert [AddCapacityLedger.bucket(k) for k in (0, 1, 5)] == [0, 1, 8]

    def test_ledger_decisions_equal_the_reference(self):
        """A seeded stream of refreshes, charges, forced charges and
        releases: the same decisions and headroom in both packages."""
        def scenario(pkg):
            led = PKG[pkg].serve.AddCapacityLedger()
            rng = np.random.default_rng(5)
            out = []
            for _ in range(200):
                op = rng.integers(4)
                k = int(rng.integers(0, 6))
                if op == 0:
                    led.refresh(_next_pow2(k + 1), int(rng.integers(0, k + 1)))
                    out.append(("refresh", led.headroom))
                elif op == 1:
                    out.append(("charge", led.try_charge(k), led.headroom))
                elif op == 2:
                    led.force_charge(k)
                    out.append(("force", led.headroom))
                else:
                    led.release(k)
                    out.append(("release", led.headroom))
            return out

        j, t = _both(scenario)
        assert t == j

    def test_queue_rejects_add_past_headroom(self):
        data = {"x": np.zeros((4, D)), "y": np.zeros(4)}
        for mode in ("reject", "block"):  # blocking cannot create capacity
            q = AdmissionQueue(max_depth=10, on_full=mode)
            q.ledger.refresh(staged_rows=2, appended_rows=0)
            with pytest.raises(RetryAfter, match="staged"):
                q.admit(_req(tserve, op="add", rows=None, data=data))
            assert q.rejected_add_capacity == 1

    def test_take_keeps_add_charge_until_served(self):
        q = AdmissionQueue(max_depth=10)
        q.ledger.refresh(staged_rows=4, appended_rows=0)
        data = {"x": np.zeros((4, D)), "y": np.zeros(4)}
        q.admit(_req(tserve, op="add", rows=None, data=data))
        batch = q.take(lambda p: list(p))
        assert q.ledger.pending_rows == 4 and q.ledger.headroom == 0
        with pytest.raises(RetryAfter, match="staged"):
            q.admit(_req(tserve, op="add", rows=None,
                         data={k: v[:1] for k, v in data.items()}))
        q.refresh_ledger(staged_rows=4, appended_rows=4)
        q.note_served(batch)
        assert q.ledger.pending_rows == 0 and q.ledger.headroom == 0

    def test_enforcement_off_force_charges(self):
        q = AdmissionQueue(max_depth=10)
        q.ledger.refresh(staged_rows=1, appended_rows=0)
        data = {"x": np.zeros((4, D)), "y": np.zeros(4)}
        q.admit(_req(tserve, op="add", rows=None, data=data),
                enforce_add_capacity=False)
        assert q.ledger.pending_rows == 4


# --------------------------------------------------------------------------
# Scheduler: EDF flush policy, cross-tenant batching, SLA accounting
# --------------------------------------------------------------------------


def _sched(pkg="torch", sess=None, sess_kw=None, **cfg_kw):
    s = PKG[pkg].serve
    sess = sess or _session(pkg, **(sess_kw or {}))
    clock = VirtualClock()
    return s.ServingScheduler(sess, s.ServeConfig(**cfg_kw), clock=clock), clock


def _add_data(sess, k, start=0):
    return {c: np.asarray(v)[start:start + k]
            for c, v in sess.dataset.columns.items()}


class TestServingScheduler:
    def test_rejects_session_with_own_autoflush_policy(self):
        sess = _session(max_pending=3)
        with pytest.raises(ValueError, match="max_pending"):
            ServingScheduler(sess, ServeConfig())

    def test_unknown_sla_class_rejected(self):
        sched, _ = _sched()
        with pytest.raises(ValueError, match="unknown SLA class"):
            sched.submit("delete", rows=[1], sla_class="platinum")
        with pytest.raises(ValueError, match="op must be"):
            sched.submit("rename", rows=[1])

    def test_edf_head_anchors_cross_tenant_batch(self):
        def scenario(pkg):
            sched, _ = _sched(pkg)
            tk = [sched.submit("delete", rows=[1], tenant="a",
                               sla_class="bulk_gdpr"),
                  sched.submit("delete", rows=[2], tenant="b",
                               sla_class="interactive"),
                  sched.submit("delete", rows=[3], tenant="c",
                               sla_class="batch")]
            assert sched.pump(force=True) == 3
            return _served(pkg, sched, tk)

        j, t = _both(scenario)
        _same_stream(j, t)
        (rec,) = t["batches"]
        assert rec[1] == [2, 3, 1]        # EDF order, not arrival order
        assert rec[2] == ["a", "b", "c"]
        assert t["stats"]["batches"]["cross_tenant"] == 1

    def test_mixed_ops_do_not_coalesce(self):
        def scenario(pkg):
            sched, _ = _sched(pkg, add_capacity=4)
            sess = sched.session
            tk = [sched.submit("delete", rows=[1], sla_class="interactive"),
                  sched.submit("add", data=_add_data(sess, 1),
                               sla_class="interactive")]
            assert sched.pump(force=True) == 1   # the EDF head's op only
            assert sched.pump(force=True) == 1
            return _served(pkg, sched, tk)

        j, t = _both(scenario)
        _same_stream(j, t)
        assert sorted(b[0] for b in t["batches"]) == ["add", "delete"]

    def test_no_coalesce_request_served_alone(self):
        def scenario(pkg):
            sched, _ = _sched(pkg)
            tk = [sched.submit("delete", rows=[1], sla_class="bulk_gdpr"),
                  sched.submit("delete", rows=[2], sla_class="interactive",
                               coalesce=False)]
            assert sched.pump(force=True) == 1
            assert sched.pump(force=True) == 1
            return _served(pkg, sched, tk)

        j, t = _both(scenario)
        _same_stream(j, t)
        assert t["batches"][0][1] == [2] and t["batches"][0][4] is False

    def test_hold_delays_dispatch_until_ready(self):
        classes = (SLAClass("batch", deadline_s=10.0, hold_s=1.0),)
        sched, _ = _sched(classes=classes, service_est_init_s=0.01)
        sched.submit("delete", rows=[1], sla_class="batch")
        t0 = sched.queue.snapshot()[0].t_enqueue
        assert sched.take_batch(now=t0 + 0.1) == []
        assert sched.wait_hint == pytest.approx(0.9)
        assert len(sched.take_batch(now=t0 + 1.1)) == 1

    def test_deadline_trims_hold(self):
        classes = (SLAClass("batch", deadline_s=0.5, hold_s=10.0),)
        sched, _ = _sched(classes=classes, slack_factor=2.0,
                          service_est_init_s=0.1)
        sched.submit("delete", rows=[1], sla_class="batch")
        q = sched.queue.snapshot()[0]
        assert sched._ready_t(q) == pytest.approx(q.deadline - 0.2)

    def test_full_pending_set_dispatches_without_waiting(self):
        classes = (SLAClass("batch", deadline_s=10.0, hold_s=5.0),)
        sched, _ = _sched(classes=classes, max_batch=2)
        sched.submit("delete", rows=[1], sla_class="batch")
        sched.submit("delete", rows=[2], sla_class="batch")
        assert len(sched.take_batch()) == 2

    def test_deadline_miss_detected_and_counted(self):
        def scenario(pkg):
            s = PKG[pkg].serve
            classes = (s.SLAClass("rush", deadline_s=1e-6, hold_s=0.0),)
            sched, _ = _sched(pkg, classes=classes)
            tk = sched.submit("delete", rows=[1], sla_class="rush")
            tk.wait(timeout=30.0)
            assert tk.missed_deadline is True
            return _served(pkg, sched, [tk])

        j, t = _both(scenario)
        _same_stream(j, t)
        assert t["stats"]["deadline_misses_total"] == 1
        assert t["stats"]["per_class"]["rush"]["deadline_misses"] == 1

    def test_service_estimate_ema_updates(self):
        def scenario(pkg):
            sched, _ = _sched(pkg)
            est0 = sched.service_est_s
            sched.submit("delete", rows=[1], sla_class="interactive")
            sched.pump(force=True)
            return est0, sched.service_est_s

        j, t = _both(scenario)
        assert t == j and t[1] != t[0]

    def test_ticket_error_surfaces(self):
        def scenario(pkg):
            sched, _ = _sched(pkg)
            tk = sched.submit("delete", rows=[10 ** 9],
                              sla_class="interactive")
            with pytest.raises(RuntimeError, match="failed"):
                tk.wait(timeout=30.0)
            return _served(pkg, sched, [tk])

        j, t = _both(scenario)
        _same_stream(j, t)
        assert t["stats"]["per_class"]["interactive"]["failed"] == 1

    def test_partial_batch_failure_counts_failed_request(self):
        def scenario(pkg):
            sched, _ = _sched(pkg)
            ok = sched.submit("delete", rows=[1], sla_class="interactive")
            bad = sched.submit("delete", rows=[10 ** 9],
                               sla_class="interactive")
            assert sched.pump(force=True) == 2   # one coalesced batch
            assert ok.done and bad.done
            assert bad.error is not None and ok.error is None
            return _served(pkg, sched, [ok, bad])

        j, t = _both(scenario)
        _same_stream(j, t)
        cls = t["stats"]["per_class"]["interactive"]
        assert cls["served"] == 1 and cls["failed"] == 1

    def test_add_over_capacity_rejected_at_admission(self):
        def scenario(pkg):
            s = PKG[pkg].serve
            sched, _ = _sched(pkg, add_capacity=2)
            sess = sched.session
            with pytest.raises(s.RetryAfter, match="staged"):
                sched.submit("add", data=_add_data(sess, 4))
            ok = sched.submit("add", data=_add_data(sess, 2))
            ok.wait(timeout=30.0)
            return _served(pkg, sched, [ok])

        j, t = _both(scenario)
        _same_stream(j, t)
        assert t["stats"]["admission"]["rejected_add_capacity"] == 1
        assert t["stats"]["add_capacity_retraces"] == 0

    def test_unenforced_add_burst_counts_retrace(self):
        """The retrace count is part of the served result: the port pays
        nothing for a re-bucketing, but counts it as the reference does."""
        def scenario(pkg):
            sched, _ = _sched(pkg, add_capacity=1, enforce_add_capacity=False)
            tk = [sched.submit("delete", rows=[0])]
            sched.pump(force=True)
            tk.append(sched.submit("add", data=_add_data(sched.session, 3)))
            sched.pump(force=True)
            return _served(pkg, sched, tk)

        j, t = _both(scenario)
        _same_stream(j, t)
        assert t["stats"]["add_capacity_retraces"] == 1


def _drive(sched, clock, events):
    """Serve a trace inline under the virtual clock: each event is
    submitted at its arrival time, the EDF policy decides (non-forced
    pumps) between arrivals, and the tail drains once every hold ran
    out.  Returns the tickets."""
    tickets = []
    for ev in events:
        clock.t = max(clock.t, ev.t)
        try:
            tickets.append(sched.submit(op=ev.op, rows=ev.rows, data=ev.data,
                                        tenant=ev.tenant,
                                        sla_class=ev.sla_class))
        except (RetryAfter, jserve.RetryAfter):
            pass  # backpressure: the monitor's admission counts record it
        while sched.pump():
            pass
    clock.t += 10.0
    while sched.pump():
        pass
    sched.drain()
    return tickets


STREAMS = {
    # (trace, n_events, interval / rate, tenants, classes, add_frac, seed)
    "fixed-mixed": ("fixed", 10, 0.02, ("a", "b"),
                    {"interactive": 0.5, "batch": 0.3, "bulk_gdpr": 0.2},
                    0.25, 4),
    "fixed-bulk": ("fixed", 12, 0.01, ("a", "b", "c"),
                   ("batch", "bulk_gdpr"), 0.0, 7),
    "poisson-mixed": ("poisson", 12, 80.0, {"a": 0.6, "b": 0.4},
                      {"interactive": 0.5, "batch": 0.3, "bulk_gdpr": 0.2},
                      0.2, 3),
    "diurnal-deletes": ("diurnal", 10, 60.0, ("a", "b"),
                        ("interactive", "batch"), 0.0, 11),
}


def _trace(s, kind, n, x, tenants, classes, add_frac, seed):
    if kind == "fixed":
        return s.fixed_trace(x, n, seed, tenants=tenants, classes=classes,
                             add_frac=add_frac)
    if kind == "poisson":
        return s.poisson_trace(x, n, seed, tenants=tenants, classes=classes,
                               add_frac=add_frac)
    return s.diurnal_trace(x / 2, 2 * x, 0.1, n, seed, tenants=tenants,
                           classes=classes, add_frac=add_frac)


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_served_stream_equals_the_reference(case):
    """A seeded multi-tenant trace through the scheduler under a virtual
    clock: batches, monitor summary and params against the JAX package."""
    def scenario(pkg):
        s = PKG[pkg].serve
        sched, clock = _sched(pkg, add_capacity=4)
        events = s.materialize(_trace(s, *STREAMS[case]),
                               sched.session.dataset, seed=9)
        return _served(pkg, sched, _drive(sched, clock, events))

    j, t = _both(scenario)
    _same_stream(j, t)
    st = t["stats"]
    served = sum(c["served"] for c in st["per_class"].values())
    assert served + st["admission"]["rejected_add_capacity"] \
        == STREAMS[case][1]
    assert st["batches"]["count"] < served  # batches formed


def test_monitor_quantiles_equal_the_shared_histogram():
    """The one quantile path: the monitor's per-class quantiles are the
    shared Histogram's, and equal the reference monitor's."""
    sample = [3.0, 1.0, 40.0, 7.5, 0.4, 12.0, 12.0, 95.0, 2.2, 6.1]
    mons = {}
    for pkg in ("jax", "torch"):
        s = PKG[pkg].serve
        mon = s.ServeMonitor()
        for i, ms in enumerate(sample):
            mon.observe_request(s.QueuedRequest(
                tenant="t0", sla_class="interactive", op="delete", rows=[1],
                data=None, coalesce=True, t_enqueue=0.0, deadline=1e9, seq=i,
                t_dispatch=ms / 1e3, t_done=ms / 1e3))
        mons[pkg] = mon.snapshot()
    ref = Histogram("ref", unit="ms")
    for ms in sample:
        ref.observe(ms)
    got = mons["torch"]["per_class"]["interactive"]["dispatch_ms"]
    assert got == ref.summary()
    assert mons["torch"] == mons["jax"]
    import repro_torch.launch.serve as launch_serve
    import repro_torch.serve.monitor as serve_monitor
    assert not hasattr(serve_monitor, "_pcts")
    assert not hasattr(launch_serve, "_pcts")


# --------------------------------------------------------------------------
# Load generation
# --------------------------------------------------------------------------

TRACES = {
    "poisson": lambda s, seed: s.poisson_trace(
        100.0, 50, seed=seed, tenants={"a": 0.5, "b": 0.5},
        classes=("interactive", "batch"), add_frac=0.3),
    "poisson-default": lambda s, seed: s.poisson_trace(7.5, 20, seed=seed),
    "diurnal": lambda s, seed: s.diurnal_trace(
        20.0, 200.0, 0.5, 40, seed=seed, tenants=("x", "y", "z"),
        classes={"interactive": 0.2, "bulk_gdpr": 0.8}, add_frac=0.1),
    "fixed": lambda s, seed: s.fixed_trace(
        0.003, 30, seed=seed, tenants=("a", "b"), add_frac=0.5),
}


def _fields(events):
    return [(e.t, e.op, e.tenant, e.sla_class, e.n_rows) for e in events]


@pytest.mark.parametrize("kind", sorted(TRACES))
@pytest.mark.parametrize("seed", [0, 7, 8])
def test_trace_is_bitwise_the_references(kind, seed):
    a = TRACES[kind](jserve, seed)
    b = TRACES[kind](tserve, seed)
    assert _fields(b) == _fields(a)  # floats compared exactly
    assert _fields(TRACES[kind](tserve, seed)) == _fields(b)
    if kind != "fixed":  # fixed arrival times carry no randomness
        assert [e.t for e in TRACES[kind](tserve, seed + 1)] \
            != [e.t for e in b]


def test_fixed_trace_times_carry_no_randomness():
    ev = fixed_trace(0.01, 5, seed=3)
    assert [e.t for e in ev] == pytest.approx([0.01, 0.02, 0.03, 0.04, 0.05])


@pytest.mark.parametrize("seed", [5, 6])
def test_materialize_is_bitwise_the_references(seed):
    """Deletes draw disjoint rows, adds resample payloads: the same rows
    and the same payload bytes as the reference."""
    out = {}
    for pkg in ("jax", "torch"):
        s = PKG[pkg].serve
        ds = PKG[pkg].data(n=50, d=4, seed=0)
        ds.removed[[3, 9]] = True  # only live rows are drawn
        out[pkg] = s.materialize(
            s.fixed_trace(0.01, 10, seed=1, add_frac=0.4), ds, seed=seed)
    for a, b in zip(out["jax"], out["torch"]):
        assert (b.op, b.rows) == (a.op, a.rows)
        if a.data is not None:
            assert sorted(b.data) == sorted(a.data)
            for k in a.data:
                assert b.data[k].dtype == a.data[k].dtype
                np.testing.assert_array_equal(b.data[k], a.data[k])
    rows = [r for e in out["torch"] if e.op == "delete" for r in e.rows]
    assert len(set(rows)) == len(rows) and not {3, 9} & set(rows)


def test_materialize_exhausting_live_rows_raises():
    ds = t_binary(n=5, d=4, seed=0)
    with pytest.raises(ValueError, match="live rows"):
        materialize(fixed_trace(0.01, 6, seed=1), ds, seed=5)


def test_closed_loop_serves_every_event_inline():
    """Closed loop degenerates batches to submission order, so the batch
    sequence and the params are the reference's."""
    def scenario(pkg):
        s = PKG[pkg].serve
        sess = _session(pkg)
        sched = s.ServingScheduler(sess, s.ServeConfig(add_capacity=4))
        ev = s.materialize(s.fixed_trace(0.001, 6, seed=2, tenants=("a", "b"),
                                         add_frac=0.25),
                           sess.dataset, seed=9)
        res = s.LoadGenerator(sched).closed_loop(ev, timeout_s=60.0)
        assert res.rejected == 0 and res.served == 6
        return _batches(sched), _flat(pkg, sess.params)

    (bj, pj), (bt, pt) = _both(scenario)
    assert bt == bj
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL)


# --------------------------------------------------------------------------
# Snapshot consistency under load
# --------------------------------------------------------------------------


class TestSnapshotUnderLoad:
    def test_save_refuse_raises_with_queued_work(self, tmp_path):
        sched, _ = _sched()
        sched.submit("delete", rows=[1], sla_class="bulk_gdpr")
        with pytest.raises(RuntimeError, match="refuse"):
            sched.save(str(tmp_path), pending="refuse")
        assert sched.queue.depth == 1
        sched.drain()
        sched.save(str(tmp_path), pending="refuse")  # now clean: fine
        with pytest.raises(ValueError, match="pending"):
            sched.save(str(tmp_path), pending="later")

    def test_save_refuse_counts_in_flight_batch(self, tmp_path):
        sched, _ = _sched()
        sched.submit("delete", rows=[1], sla_class="bulk_gdpr")
        batch = sched.take_batch(force=True)   # taken, not yet served
        assert sched.queue.in_flight == 1
        with pytest.raises(RuntimeError, match="in-flight"):
            sched.save(str(tmp_path), pending="refuse")
        sched.executor.serve_batch(batch)
        assert sched.queue.in_flight == 0
        sched.save(str(tmp_path), pending="refuse")

    def test_save_drain_serves_queue_first(self, tmp_path):
        sched, _ = _sched()
        t = sched.submit("delete", rows=[3], sla_class="bulk_gdpr")
        sched.save(str(tmp_path), pending="drain")
        assert t.done and sched.queue.depth == 0

    def test_restore_and_replay_is_bitwise_identical(self, tmp_path):
        """Drain-save mid-trace, restore, replay the remainder: bitwise the
        uninterrupted run; the uninterrupted run equals the reference's."""
        def replay(sched, events):
            for e in events:
                sched.submit(op=e.op, rows=e.rows, data=e.data,
                             tenant=e.tenant, sla_class=e.sla_class)
                while sched.pump(force=True):
                    pass

        runs = {}
        for pkg in ("jax", "torch"):
            s = PKG[pkg].serve
            sess = _session(pkg)
            ev = s.materialize(s.fixed_trace(0.001, 8, seed=4,
                                             tenants=("a", "b"),
                                             add_frac=0.25),
                               sess.dataset, seed=11)
            sched = s.ServingScheduler(sess, s.ServeConfig(add_capacity=4))
            runs[pkg] = (copy.deepcopy(ev), sched)
            replay(sched, ev)
        ev_mid, sched_ref = runs["torch"]
        sess_a = _session()
        sched_a = ServingScheduler(sess_a, ServeConfig(add_capacity=4))
        replay(sched_a, ev_mid[:4])
        sched_a.save(str(tmp_path), pending="drain")
        sess_b = UnlearnerSession.restore(str(tmp_path), logreg_objective(L2),
                                          device="cpu")
        sched_b = ServingScheduler(sess_b, ServeConfig(add_capacity=4))
        replay(sched_b, ev_mid[4:])
        assert np.array_equal(_flat("torch", sched_b.session.params),
                              _flat("torch", sched_ref.session.params))
        plans = lambda s: [(r["op"], tuple(r["rows"])) for r in s.batch_log]  # noqa: E731
        assert plans(sched_a) + plans(sched_b) == plans(sched_ref)
        sched_j = runs["jax"][1]
        assert plans(sched_ref) == plans(sched_j)
        np.testing.assert_allclose(_flat("torch", sched_ref.session.params),
                                   _flat("jax", sched_j.session.params),
                                   rtol=0, atol=TOL)


# --------------------------------------------------------------------------
# Deprecation shims
# --------------------------------------------------------------------------


class TestDeprecationShims:
    def test_start_autoflush_timer_warns_and_delegates(self):
        sess = _session(max_delay_s=0.05)
        with pytest.warns(DeprecationWarning, match="SessionFlushClock"):
            clock = sess.start_autoflush_timer()
        try:
            assert isinstance(clock, SessionFlushClock)
            assert clock.sla.deadline_s == pytest.approx(0.05)
            assert clock.interval_s == pytest.approx(0.05 / 8)
            with pytest.warns(DeprecationWarning):
                second = sess.start_autoflush_timer(interval_s=0.01)
            assert second is not clock and not clock._thread.is_alive()
            clock = second
        finally:
            clock.stop()

    def test_autoflush_timer_class_warns_and_delegates(self):
        sess = _session(max_delay_s=0.05)
        with pytest.warns(DeprecationWarning, match="SessionFlushClock"):
            timer = AutoFlushTimer(sess)
        try:
            assert isinstance(timer, SessionFlushClock)
        finally:
            timer.stop()

    def test_shims_without_a_deadline_are_rejected(self):
        sess = _session()
        with pytest.raises(ValueError, match="max_delay_s"):
            SessionFlushClock(sess)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(ValueError, match="max_delay_s"):
                sess.start_autoflush_timer()

    def test_flush_clock_holds_deadline_with_zero_arrivals(self):
        sess = _session(max_delay_s=0.05)
        clock = SessionFlushClock(sess)
        try:
            h = sess.submit(op="delete", rows=[1])
            deadline = time.monotonic() + 10.0
            while not h.done and time.monotonic() < deadline:
                time.sleep(0.005)
            assert h.done and clock.ticks >= 1 and clock.last_error is None
        finally:
            clock.stop()


# --------------------------------------------------------------------------
# Threaded executor: continuous batching end to end
# --------------------------------------------------------------------------


def _logged_batches(sched, tickets):
    """[(op, [requests in batch order])] from the monitor's batch log: a
    batch's rows are logged in the order its requests were submitted to
    the session."""
    by_row = {}
    for tk in tickets:
        for r in tk.req.rows:
            by_row[(tk.req.op, r)] = tk.req
    out = []
    for rec in sched.batch_log:
        reqs = []
        for r in rec["rows"]:
            q = by_row[(rec["op"], r)]
            if not reqs or reqs[-1] is not q:
                reqs.append(q)
        out.append(reqs)
    return out


def _serve_inline(pkg, sess, batches, add_capacity):
    """Serve `batches` on `sess` through a scheduler's executor, inline."""
    s = PKG[pkg].serve
    sched = s.ServingScheduler(sess, s.ServeConfig(add_capacity=add_capacity),
                               clock=VirtualClock())
    for reqs in batches:
        fresh = [_req(s, seq=i, tenant=q.tenant, op=q.op,
                      rows=None if q.op == "add" else q.rows,
                      data=q.data if q.op == "add" else None,
                      sla=q.sla_class, coalesce=q.coalesce, deadline=1e9)
                 for i, q in enumerate(reqs)]
        sched.executor.serve_batch(fresh)
        assert all(q.error is None for q in fresh)
    return sched


class TestThreadedExecutor:
    def test_open_loop_burst_coalesces_under_thread(self, tmp_path):
        """The threaded run's logged batches, re-served inline on the
        snapshot taken before it, give bitwise its params; on a JAX
        session, the same params within 1e-6."""
        sess = _session()
        sched = ServingScheduler(sess, ServeConfig(add_capacity=8))
        sched.save(str(tmp_path))
        ev = materialize(poisson_trace(400.0, 12, seed=6, tenants=("a", "b"),
                                       classes=("batch",), add_frac=0.25),
                         sess.dataset, seed=13)
        sched.start()
        try:
            res = LoadGenerator(sched).open_loop(ev)
            for tk in res.tickets:
                assert tk.wait(timeout=30.0)
        finally:
            sched.stop()
        assert res.served == 12 and sched.queue.depth == 0
        stats = sched.stats()
        assert stats["batches"]["count"] < 12       # batching happened
        assert stats["batches"]["cross_tenant"] >= 1
        batches = _logged_batches(sched, res.tickets)
        assert sum(len(b) for b in batches) == 12
        restored = UnlearnerSession.restore(str(tmp_path),
                                            logreg_objective(L2),
                                            device="cpu")
        again = _serve_inline("torch", restored, batches, 8)
        assert np.array_equal(_flat("torch", restored.params),
                              _flat("torch", sess.params))
        assert [(r["op"], r["rows"]) for r in again.batch_log] \
            == [(r["op"], r["rows"]) for r in sched.batch_log]
        jsess = _session("jax")
        _serve_inline("jax", jsess, batches, 8)
        np.testing.assert_allclose(_flat("torch", sess.params),
                                   _flat("jax", jsess.params),
                                   rtol=0, atol=TOL)

    def test_drain_waits_for_in_flight_batch(self, monkeypatch):
        sess = _session()
        sched = ServingScheduler(sess, ServeConfig())
        entered = threading.Event()
        real_flush = sess.flush

        def slow_flush():
            entered.set()
            out = real_flush()
            time.sleep(0.2)       # batch still in flight after the flush
            return out

        monkeypatch.setattr(sess, "flush", slow_flush)
        sched.start()
        try:
            t = sched.submit("delete", rows=[2], sla_class="interactive")
            assert entered.wait(30.0)   # the executor took the batch
            sched.drain()
            assert t.done and sched.queue.in_flight == 0
        finally:
            sched.stop()

    def test_stop_then_inline_use_still_works(self):
        sched, _ = _sched()
        sched.start()
        assert sched.running
        sched.stop()
        assert not sched.running
        t = sched.submit("delete", rows=[5], sla_class="interactive")
        assert t.wait(timeout=30.0)


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------

CLI = ("--n 160 --d 8 --steps 20 --batch 64 --requests 4 --burst 2 "
       "--rate 50").split()


def _keys(x, path=""):
    """The key structure of a results dict; dicts keyed by data (batch
    sizes, op counts) reduce to their type."""
    if not isinstance(x, dict):
        return type(x).__name__ if x is None or isinstance(x, bool) \
            else "value"
    if path.endswith(("size_hist", "ops")):
        return "dict"
    return {k: _keys(v, f"{path}.{k}") for k, v in x.items()}


def test_cli_writes_the_reference_key_set(tmp_path):
    import json

    from repro.launch.serve import unlearn_main as j_main

    from repro_torch.launch.serve import unlearn_main
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    trace = str(tmp_path / "trace.json")
    j_main(CLI + ["--bench-out", jpath])
    out = unlearn_main(["--device", "cpu"] + CLI
                       + ["--bench-out", tpath, "--trace-out", trace])
    jres, tres = json.load(open(jpath)), json.load(open(tpath))
    # per-class summaries hold the classes the trace served; the seeded
    # trace is the same, so the classes are too
    assert _keys(tres) == _keys(jres)
    assert tres["config"] == jres["config"] and out["config"] == tres["config"]
    assert tres["serving"]["admission"] == jres["serving"]["admission"]
    assert tres["serving"]["lone_request_served"]
    assert tres["coalesce"]["parity_vs_python"] < 1e-5
    doc = json.load(open(trace))
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"serve.batch", "serve.admit", "replay.scan", "replay.explicit",
            "replay.commit", "online.request", "online.warmup"} <= names
    assert (tmp_path / "trace.json.metrics.jsonl").exists()


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        launch_serve.unlearn_main(["--device", "cpu", "--impl", "python"])
    # the batched-decode mode is ported: main() without "unlearn" decodes
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "internlm2-1.8b",
                                     "--reduced", "--device", "cpu",
                                     "--batch", "2", "--prompt-len", "3",
                                     "--gen", "2"])
    launch_serve.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill 3 tok x 2 in ")
    assert out[1].startswith("sample row 0: [")
    # the default results path writes nothing (no committed file is
    # overwritten from the repository root)
    assert launch_serve.unlearn_main.__module__ == "repro_torch.launch.serve"
    monkeypatch.chdir(tmp_path)
    launch_serve.unlearn_main(["--device", "cpu", "--n", "120", "--d", "4",
                               "--steps", "12", "--batch", "32",
                               "--requests", "2", "--burst", "0",
                               "--rate", "100"])
    assert list(tmp_path.iterdir()) == []


def test_package_surface_equals_the_reference():
    import repro.obs as jobs

    import repro_torch.obs as tobs
    assert tserve.__all__ == jserve.__all__
    assert tobs.__all__ == jobs.__all__
    assert all(hasattr(tserve, n) for n in tserve.__all__)
    assert all(hasattr(tobs, n) for n in tobs.__all__)
