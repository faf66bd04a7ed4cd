"""The port's `UnlearnerSession` surface (request plan, coalescing planner,
snapshots, `core.api.Unlearner`, `from_config`) and `train.checkpoint`,
against the JAX package on the CPU.

Sizes are the reference's `tests/test_session.py` (n 800, d 10, T 40-50,
B 256) and `examples/quickstart.py` (n 5000, d 200, T 100, B 1024).
Tolerances: the planner's groups exactly; every per-request counter
exactly; parameters within 1e-6 of the reference's through delete bursts,
serial deletes, added groups and short addition streams (two adds; the
1e-4 of tests/test_torch_online.py is for its fourth add); the port's own
snapshot round trip and a params shard carried between the packages
bitwise.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.deltagrad import DeltaGradConfig as JDGConfig
from repro.core.session import UnlearnerConfig as JConfig
from repro.core.session import UnlearnerSession as JSession
from repro.core.session import UnlearnRequest as JRequest
from repro.core.session import plan_requests as j_plan
from repro.data.synthetic import binary_classification as j_binary
from repro.data.synthetic import multiclass_classification as j_multiclass
from repro.data.synthetic import token_stream as j_token_stream
from repro.models.simple import logreg_objective as j_logreg
from repro.models.simple import multiclass_objective as j_multiclass_obj
from repro.train import checkpoint as j_ckpt

from repro_torch.core import online
from repro_torch.core.api import Unlearner
from repro_torch.core.deltagrad import DeltaGradConfig, Objective
from repro_torch.core.history import HistoryMeta, TrainingHistory
from repro_torch.core.session import (UnlearnerConfig, UnlearnerSession,
                                      UnlearnRequest, plan_requests)
from repro_torch.core.store import PlacementPolicy
from repro_torch.data.synthetic import binary_classification as t_binary
from repro_torch.data.synthetic import multiclass_classification as t_multiclass
from repro_torch.data.synthetic import token_stream
from repro_torch.models.registry import build, count_params
from repro_torch.models.registry import params_from_jax as nested_from_jax
from repro_torch.models.simple import (logreg_objective, multiclass_objective,
                                       params_from_jax)
from repro_torch.configs.registry import get_config
from repro_torch.core import deltagrad as tdg
from repro_torch.train import checkpoint as ckpt
from repro_torch.utils.tree import FlatParams

TOL = 1e-6
COUNTERS = ("explicit_steps", "approx_steps", "guard_fallbacks",
            "skipped_steps", "grad_examples", "grad_examples_baseline")
ALGORITHMS = ("deltagrad", "descent_to_delete", "retrain_oracle")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread for this file's tests and its module
    fixtures alike (a fixture computed on more threads sums in another
    order): the suite runs its files in several worker processes on the
    same cores, and every worker's thread pool spinning for them slows the
    port's small CPU ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(params):
    return np.concatenate([np.asarray(params[k], np.float32).reshape(-1)
                           for k in sorted(params)])


def _port_flat(params):
    return params.flat.detach().cpu().numpy()


def _init(kind, d, classes=3, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "logreg":
        return {"w": (0.01 * rng.normal(size=d)).astype(np.float32),
                "b": np.zeros((), np.float32)}
    return {"w": (0.01 * rng.normal(size=(d, classes))).astype(np.float32),
            "b": np.zeros(classes, np.float32)}


def _data(pkg, kind, n, d, seed=0):
    if kind == "logreg":
        return (j_binary if pkg == "jax" else t_binary)(n=n, d=d, seed=seed)
    return (j_multiclass if pkg == "jax" else t_multiclass)(
        n=n, d=d, num_classes=3, seed=seed)


def make_pair(kind="logreg", n=800, d=10, steps=50, batch=256, lr=0.4,
              momentum=0.0, seed=0, dg=None, **cfg_kw):
    """The same fitted session in both packages: (jax, port)."""
    dg = dg or dict(period=5, burn_in=8, history_size=2)
    p0 = _init(kind, d)
    kw = dict(steps=steps, batch_size=batch, lr=lr, seed=seed,
              momentum=momentum, **cfg_kw)
    jobj = j_logreg(5e-3) if kind == "logreg" else j_multiclass_obj(5e-3)
    tobj = logreg_objective(5e-3) if kind == "logreg" \
        else multiclass_objective(5e-3)
    j = JSession(jobj, {k: jnp.asarray(v) for k, v in p0.items()},
                 _data("jax", kind, n, d, seed),
                 JConfig(deltagrad=JDGConfig(**dg), **kw))
    t = UnlearnerSession(tobj, params_from_jax(p0, "cpu"),
                         _data("torch", kind, n, d, seed),
                         UnlearnerConfig(deltagrad=DeltaGradConfig(**dg),
                                         **kw),
                         device="cpu")
    j.fit()
    t.fit()
    return j, t


def make_session(**kw):
    """A fitted port session alone, at the reference test's problem."""
    n, d = kw.pop("n", 800), kw.pop("d", 10)
    dg = kw.pop("dg", dict(period=5, burn_in=8, history_size=2))
    sess = UnlearnerSession(
        logreg_objective(5e-3), params_from_jax(_init("logreg", d), "cpu"),
        t_binary(n=n, d=d, seed=0),
        UnlearnerConfig(deltagrad=DeltaGradConfig(**dg),
                        **{**dict(steps=50, batch_size=256, lr=0.4, seed=0),
                           **kw}),
        device="cpu")
    sess.fit()
    return sess, sess.dataset


def _same_counters(a, b):
    for k in COUNTERS:
        assert getattr(a, k) == getattr(b, k), (k, a, b)


# -- the planner -----------------------------------------------------------

PLANS = {
    "reference-test": [("delete", [1], True), ("delete", [2, 3], True),
                       ("add", [800], True), ("delete", [4], True),
                       ("delete", [5], False), ("delete", [6], True)],
    "one-burst": [("delete", [1], True), ("delete", [2], True),
                  ("delete", [3, 4], True)],
    "all-serial": [("delete", [1], False), ("delete", [2], False),
                   ("add", [800], False)],
    "alternating": [("delete", [1], True), ("add", [800], True),
                    ("delete", [2], True), ("add", [801], True)],
    "serial-between-adds": [("add", [800], True), ("add", [801], False),
                            ("add", [802], True), ("add", [803], True)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_planner_groups_like_the_reference(case):
    reqs = PLANS[case]
    jp = j_plan([(i, JRequest(op, rows, coalesce=c))
                 for i, (op, rows, c) in enumerate(reqs)])
    tp = plan_requests([(i, UnlearnRequest(op, rows, coalesce=c))
                        for i, (op, rows, c) in enumerate(reqs)])
    assert [[t for t, _ in g] for g in tp] == [[t for t, _ in g] for g in jp]


# -- the session flow against the reference --------------------------------


def _flow(sess, ds, n):
    """fit -> coalesced delete burst -> serial deletes -> add -> burst (a
    delete burst that also deletes an added row).  Returns each phase's
    stats list and params."""
    out = []
    r = sess.delete([3, 17, 40, 41, 99, 150, 151, 200]).result()
    out.append((r.stats, sess.params))
    st = sess.stream_delete([5, 260])
    out.append((st.per_request, sess.params))
    r = sess.add(data={k: np.asarray(v[:2]) for k, v in ds.columns.items()}
                 ).result()
    out.append((r.stats, sess.params))
    hs = [sess.delete([7]), sess.delete([8, 9]), sess.delete([n])]
    r = hs[-1].result()
    assert r.group_size == 4 and all(h.done for h in hs)
    out.append((r.stats, sess.params))
    return out


FLOWS = {"logreg-sgd": ("logreg", 0.0, 0.4),
         "logreg-heavy-ball": ("logreg", 0.9, 0.1),
         "multiclass-sgd": ("multiclass", 0.0, 0.4),
         "multiclass-heavy-ball": ("multiclass", 0.9, 0.1)}


@pytest.mark.parametrize("case", sorted(FLOWS))
def test_session_flow_matches_reference(case):
    kind, momentum, lr = FLOWS[case]
    j, t = make_pair(kind, momentum=momentum, lr=lr)
    fj, ft = _flow(j, j.dataset, 800), _flow(t, t.dataset, 800)
    for phase, ((sj, wj), (st, wt)) in enumerate(zip(fj, ft)):
        assert len(st) == len(sj)
        for a, b in zip(st, sj):
            _same_counters(a, b)
        np.testing.assert_allclose(_port_flat(wt), _flat(wj), rtol=0,
                                   atol=TOL, err_msg=f"phase {phase}")
    np.testing.assert_array_equal(t.dataset.removed, j.dataset.removed)
    assert t._engine.added == j._engine.added == [800, 801]
    np.testing.assert_array_equal(t._engine.live, j._engine.live)
    assert t.log[-1]["coalesced"] and len(t.log) == len(j.log)


def test_quickstart_flow_matches_reference():
    """examples/quickstart.py: train, then 50 rows deleted in ONE coalesced
    replay, against exact retraining."""
    j, t = make_pair(n=5000, d=200, steps=100, batch=1024, lr=0.3,
                     dg=dict(period=5, burn_in=10, history_size=2))
    rows = np.random.default_rng(3).choice(5000, 50, replace=False)
    wu_j, bj = j.baseline(rows)
    wu_t, bt = t.baseline(rows)
    rj = j.delete(rows.tolist()).result()
    rt = t.delete(rows.tolist()).result()
    assert rt.group_size == rj.group_size == 50 and len(rt.stats) == 1
    _same_counters(rt.stats[0], rj.stats[0])
    _same_counters(bt, bj)
    np.testing.assert_allclose(_port_flat(t.params), _flat(j.params), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(_port_flat(wu_t), _flat(wu_j), rtol=0,
                               atol=TOL)
    d_ui = float((wu_t.flat - t.params.flat).norm())
    d_us = float((wu_t.flat - t._trained_params.flat).norm())
    assert d_ui < 0.5 * d_us, (d_ui, d_us)
    assert t.history.nbytes() == 2 * 100 * 201 * 4


def test_partial_ring_matches_reference():
    """burn_in < history_size: the first approx steps solve over a partly
    filled ring, in both packages alike."""
    rows = np.random.default_rng(11).choice(800, 6, replace=False).tolist()
    j, t = make_pair(dg=dict(period=3, burn_in=2, history_size=4))
    rj, rt = j.delete(rows).result(), t.delete(rows).result()
    _same_counters(rt.stats[0], rj.stats[0])
    np.testing.assert_allclose(_port_flat(t.params), _flat(j.params), rtol=0,
                               atol=TOL)


def test_interleaved_batch_stream_matches_reference():
    """delete (coalesced) -> stream_add (serial) -> delete again: the
    interleaving keeps the engine's state in both packages alike."""
    j, t = make_pair(steps=40)
    for sess in (j, t):
        sess.delete([3, 17]).result()
        sess.stream_add({k: v[:2] for k, v in sess.dataset.columns.items()})
        sess.delete([40, 41]).result()
    np.testing.assert_allclose(_port_flat(t.params), _flat(j.params), rtol=0,
                               atol=TOL)
    assert t._engine.added == [800, 801]
    assert not t._engine.live[[3, 17, 40, 41]].any()


def test_group_delete_r_pad_capped_at_batch_size():
    """A K >> B delete group pads its changed-row block to pow2(min(K, B)),
    where the reference pads it."""
    j, t = make_pair(batch=64, steps=30)
    rows = list(range(100))
    st = t.engine()._schedule("delete", rows)
    sj = j.engine()._schedule("delete", rows)
    assert st.changed_idx.shape == sj.changed_idx.shape == (30, 64)
    rt, rj = t.delete(rows).result(), j.delete(rows).result()
    assert rt.group_size == 100
    _same_counters(rt.stats[0], rj.stats[0])


def test_engine_row_capacity_grows_like_the_reference():
    """The pow2 row capacity is snapshot state: the port keeps the
    reference's numbers (its device columns stay unpadded)."""
    j, t = make_pair(steps=40)
    caps = []
    for i in range(5):
        for sess in (j, t):
            sess.stream_add({k: v[i:i + 1]
                             for k, v in sess.dataset.columns.items()})
        caps.append((t._engine._row_cap, j._engine._row_cap))
        # the engine takes ds.n at its creation, after the first append
        assert t._engine._base_n == j._engine._base_n == 801
    assert [a for a, _ in caps] == [b for _, b in caps]
    assert t._engine._cols()["x"].shape[0] == t.dataset.n


# -- session behaviour (the reference's tests/test_session.py) --------------


def test_handles_are_lazy_and_share_one_group_replay():
    sess, ds = make_session(steps=40)
    h1 = sess.delete([1, 2, 3])
    h2 = sess.delete([10, 11])
    h3 = sess.add(data={k: v[:2] for k, v in ds.columns.items()})
    assert sess._engine is None and not h1.done and not h3.done
    r1 = h1.result()
    assert h2.done and h3.done  # forcing ONE handle flushes the whole plan
    assert r1.group_size == 5 and len(r1.stats) == 1
    assert h2.result().stats[0] is r1.stats[0]
    assert h3.result().group_size == 2
    assert ds.removed[[1, 2, 3, 10, 11]].all()
    assert sess._engine.added == [800, 801]


def test_submit_validates_rows():
    sess, _ = make_session(steps=40)
    sess.delete([7]).result()
    with pytest.raises(ValueError, match="already deleted"):
        sess.delete([7])
    sess.delete([8])  # pending
    with pytest.raises(ValueError, match="already deleted"):
        sess.delete([8])
    with pytest.raises(ValueError, match="out of range"):
        sess.delete([10_000])
    with pytest.raises(ValueError, match="duplicate"):
        sess.delete([9, 9])
    with pytest.raises(ValueError, match="names no rows"):
        sess.delete([])
    with pytest.raises(ValueError, match="op must be"):
        sess.submit(op="rename", rows=[1])


def test_submit_validates_add_rows():
    sess, ds = make_session(steps=40)
    with pytest.raises(ValueError, match="appended AFTER"):
        sess.add(rows=[3])  # an original row would be double-counted
    new = ds.append({k: v[:1] for k, v in ds.columns.items()})
    h = sess.add(rows=new.tolist())
    with pytest.raises(ValueError, match="pending add"):
        sess.add(rows=new.tolist())
    h.result()
    with pytest.raises(ValueError, match="already added"):
        sess.add(rows=new.tolist())


def test_submitting_before_fit_raises():
    sess = UnlearnerSession(logreg_objective(5e-3),
                            params_from_jax(_init("logreg", 4), "cpu"),
                            t_binary(n=50, d=4, seed=0), UnlearnerConfig(),
                            device="cpu")
    with pytest.raises(RuntimeError, match="fit"):
        sess.delete([1])


def test_flush_failure_keeps_later_requests_servable(monkeypatch):
    """A group that dies mid-plan must not strand the rest of the plan:
    later groups go back on the queue, and the failed group's handles
    resolve to a clear error."""
    sess, ds = make_session(steps=40)
    h1 = sess.delete([1])
    h2 = sess.delete([2], coalesce=False)  # this group will fail
    h3 = sess.delete([3])
    orig = online.OnlineEngine.request_group

    def boom(self, op, rows):
        if rows == [2]:
            raise RuntimeError("boom")
        return orig(self, op, rows)

    monkeypatch.setattr(online.OnlineEngine, "request_group", boom)
    with pytest.raises(RuntimeError, match="boom"):
        h1.result()  # forces the flush that hits the failure
    monkeypatch.undo()

    assert h1.result().group_size == 1  # served before the failure
    with pytest.raises(RuntimeError, match="not served"):
        h2.result()
    r3 = h3.result()  # re-queued and served on the next flush
    assert r3.group_size == 1 and ds.removed[3] and not ds.removed[2]


def test_response_eviction_bounds_memory():
    sess, _ = make_session(steps=40)
    sess.max_responses = 2
    handles = [sess.delete([r], coalesce=False) for r in (1, 2, 3)]
    sess.flush()
    with pytest.raises(RuntimeError, match="evicted"):
        handles[0].result()
    assert handles[2].result().group_size == 1


def test_auto_flush_on_max_pending_and_max_delay():
    sess, _ = make_session(steps=30, max_pending=3)
    h = [sess.delete([r]) for r in (1, 2)]
    assert not h[0].done and sess.pending_count == 2
    h.append(sess.delete([3]))  # the third trips max_pending
    assert all(x.done for x in h) and sess.pending_count == 0
    assert sess.autoflush_reasons == {"max_pending": 1, "max_delay_s": 0}
    assert h[0].result().group_size == 3

    sess.config = dataclasses.replace(sess.config, max_pending=None,
                                      max_delay_s=0.0)
    h4 = sess.delete([4])  # a zero deadline flushes at submit
    assert h4.done and sess.autoflush_reasons["max_delay_s"] == 1
    sess.config = dataclasses.replace(sess.config, max_delay_s=3600.0)
    h5 = sess.delete([5])
    assert not sess.poll() and not h5.done and sess.pending_age_s >= 0.0
    assert [t for t, _ in sess.pending_requests()] == [h5._ticket]
    assert len(sess.try_flush()) == 1 and h5.done
    assert sess.try_flush() == []


def test_save_refuses_while_pending_and_drains_otherwise(tmp_path):
    sess, _ = make_session(steps=30)
    h = sess.delete([1])
    with pytest.raises(RuntimeError, match="pending"):
        sess.save(str(tmp_path), pending="refuse")
    with pytest.raises(ValueError, match="drain"):
        sess.save(str(tmp_path), pending="later")
    assert not h.done
    step_dir = sess.save(str(tmp_path))  # drains
    assert h.done and os.path.exists(os.path.join(step_dir, "MANIFEST.json"))


def test_restore_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        UnlearnerSession.restore(str(tmp_path / "nope"),
                                 logreg_objective(5e-3), device="cpu")


def test_unlearner_shim_batch_after_stream_keeps_state():
    """Batch delete()/add() after stream_* reuse the session's engine:
    added rows and liveness survive."""
    ds = t_binary(n=400, d=8, seed=3)
    unl = Unlearner(logreg_objective(5e-3),
                    params_from_jax(_init("logreg", 8, seed=4), "cpu"), ds,
                    UnlearnerConfig(steps=30, batch_size=64, lr=0.3,
                                    deltagrad=DeltaGradConfig(period=5,
                                                              burn_in=4)),
                    device="cpu")
    unl.fit()
    unl.stream_add({k: v[:2] for k, v in ds.columns.items()})
    eng = unl._online
    assert eng is not None and eng.added == [400, 401]
    stats = unl.delete([5, 6])  # batch request on the SAME engine
    assert unl._online is eng and eng.added == [400, 401]
    assert not eng.live[[5, 6]].any()
    assert stats.approx_steps > 0
    unl.stream_delete([400])  # deleting a previously added row
    assert unl._online is eng and not eng.live[400]
    st = unl.stream([("delete", 7), ("delete", 401)])
    assert len(st.per_request) == 2 and not eng.live[[7, 401]].any()
    with pytest.raises(TypeError, match="pairs"):
        unl.stream([8])
    assert unl.params is unl.session.params and unl.history is unl.session.history


def test_coalesced_burst_tracks_baseline_and_serial():
    """The coalesced group correction and the serial stream both land far
    closer to exact retraining than the original model."""
    rows = np.random.default_rng(6).choice(800, 8, replace=False).tolist()
    sess_c, _ = make_session()
    w_star = sess_c.params
    w_u, _ = sess_c.baseline(rows)
    w_coal = sess_c.delete(rows).params
    sess_s, _ = make_session()
    sess_s.stream_delete(rows)
    d = lambda a, b: float((a.flat - b.flat).norm())  # noqa: E731
    d_0u = d(w_star, w_u)
    assert d(w_coal, w_u) < 0.3 * d_0u
    assert d(sess_s.params, w_u) < 0.3 * d_0u
    assert d(w_coal, sess_s.params) < 0.5 * d_0u


def test_session_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UnlearnerSession(logreg_objective(5e-3),
                         params_from_jax(_init("logreg", 4), "cpu"),
                         t_binary(n=50, d=4, seed=0), UnlearnerConfig())


def test_config_takes_a_placement_policy():
    pol = PlacementPolicy(mesh_shape=(2,), axis_names=("data",))
    cfg = UnlearnerConfig(placement=pol)
    assert cfg.placement is pol and cfg.placement.data_size == 2


def test_engine_placement_after_the_engine_exists_raises():
    """The reference's rule: a placement is chosen before the first
    request; once the engine exists, engine(placement=) raises."""
    sess, _ = make_session(steps=10)
    engine = sess.engine()
    assert sess.engine() is engine and engine.store.sharded_replay() is None
    with pytest.raises(RuntimeError, match="engine already exists"):
        sess.engine(placement=PlacementPolicy(mesh_shape=(2,),
                                              axis_names=("data",)))


def test_warmup_compiles_nothing():
    sess, _ = make_session(steps=20)
    assert sess.warmup() == 0.0 and sess.warmup([("delete", 8)]) == 0.0
    st = sess.stream_delete([3])
    assert st.compile_time_s == 0.0 and len(st.per_request) == 1


# -- snapshots -------------------------------------------------------------

TIERS = {"stacked": {}, "host-f32": dict(history_tier="host"),
         "host-int8": dict(history_tier="host", history_codec="int8"),
         "disk-delta_int8": dict(history_tier="disk",
                                 history_codec="delta_int8")}


def _rest_of_stream(sess):
    """What the session serves after the snapshot: a serial delete, a
    burst, an add and a publish."""
    sess.stream_delete([30])
    sess.delete([40, 41]).result()
    sess.add(data={k: v[5:6] for k, v in sess.dataset.columns.items()}
             ).result()
    out, _ = sess.publish(eps=1.0)
    return sess.params, out, [s for e in sess.log[-3:] for s in e["stats"]]


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_snapshot_roundtrip_mid_stream_is_bitwise(tmp_path, algorithm, tier):
    """save() mid-stream and restore(): the restored session serves the
    rest of the stream bitwise as the uninterrupted one does, with equal
    counters, on every tier and for every algorithm."""
    from repro_torch.core.privacy import PrivacyConfig

    cfg = dict(TIERS[tier], algorithm=algorithm,
               privacy=PrivacyConfig(mu=0.5, c0=0.1, c2=0.1))
    if "history_tier" in cfg and cfg["history_tier"] == "disk":
        cfg["spill_dir"] = str(tmp_path / "spill")
    sess, ds = make_session(**cfg)
    sess.delete([1, 2, 3]).result()
    sess.stream_add({k: v[:2] for k, v in ds.columns.items()})
    sess.publish(eps=1.0)
    sess.save(str(tmp_path / "snap"))
    restored = UnlearnerSession.restore(
        str(tmp_path / "snap"), logreg_objective(5e-3),
        spill_dir=str(tmp_path / "spill2") if tier.startswith("disk") else None,
        device="cpu")
    assert torch.equal(restored.params.flat, sess.params.flat)
    assert restored.history.tier == sess.history.tier
    assert restored.algorithm.added == sess.algorithm.added
    np.testing.assert_array_equal(restored.algorithm.live, sess.algorithm.live)
    if algorithm != "descent_to_delete":
        assert restored._engine.last_ring is not None

    wa, pa, sa = _rest_of_stream(sess)
    wb, pb, sb = _rest_of_stream(restored)
    assert torch.equal(wa.flat, wb.flat)
    assert torch.equal(pa.flat, pb.flat)
    assert len(sa) == len(sb)
    for a, b in zip(sa, sb):
        _same_counters(a, b)
    assert torch.equal(sess.history.final_params.flat,
                       restored.history.final_params.flat)
    np.testing.assert_array_equal(sess.dataset.removed,
                                  restored.dataset.removed)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_history_state_dict_roundtrip(tmp_path, tier):
    """`TrainingHistory.state_dict` -> `from_state_dict`: every entry, the
    final params and the stored bytes bitwise, on each tier."""
    kw = {"stacked": {}, "host-f32": dict(tier="host"),
          "host-int8": dict(tier="host", codec="int8"),
          "disk-delta_int8": dict(tier="disk", codec="delta_int8",
                                  spill_dir=str(tmp_path / "a"),
                                  spill_window=7)}[tier]
    ds = t_binary(n=300, d=6, seed=0)
    meta = HistoryMeta(n=300, batch_size=64, seed=2, steps=20,
                       lr_schedule=((0, 0.3),))
    _, h = tdg.sgd_train_with_cache(logreg_objective(5e-3),
                                    params_from_jax(_init("logreg", 6), "cpu"),
                                    ds, meta, device="cpu", **kw)
    state = h.state_dict()
    h2 = TrainingHistory.from_state_dict(
        state, device="cpu",
        spill_dir=str(tmp_path / "b") if tier.startswith("disk") else None)
    assert (h2.tier, h2.codec.name, len(h2), h2.meta) == \
        (h.tier, h.codec.name, len(h), h.meta)
    for t in range(len(h)):
        for x, y in zip(h.entry(t), h2.entry(t)):
            assert torch.equal(x, y), t
    assert torch.equal(h.final_params.flat, h2.final_params.flat)
    assert h2.nbytes() == h.nbytes()
    if tier.startswith("disk"):  # the copy is the restored history's own
        assert all(p.startswith(str(tmp_path / "b")) for p in h2._win_paths)
        assert h2.disk_nbytes() == h.disk_nbytes()


# -- the checkpoint shard, carried between the packages ---------------------


def _trees():
    rng = np.random.default_rng(0)
    logreg = {"w": rng.normal(size=10).astype(np.float32),
              "b": np.float32(0.25) * np.ones((), np.float32)}
    lm = {"embed": rng.normal(size=(16, 4)).astype(np.float32),
          "u0": {"mixer": {"wq": rng.normal(size=(4, 8)).astype(np.float32),
                           "wo": rng.normal(size=(8, 4)).astype(np.float32)},
                 "norm": rng.normal(size=4).astype(np.float32)}}
    return {"logreg": logreg, "nested": lm}


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["logreg", "nested"])
def test_reference_params_shard_restores_bitwise(tmp_path, name):
    tree = _trees()[name]
    j_ckpt.save(str(tmp_path), 7, _jax_tree(tree))
    want = nested_from_jax(tree, "cpu")
    like = want.with_flat(torch.zeros_like(want.flat))
    got = ckpt.restore(str(tmp_path), 7, like=like)
    assert got.shapes == want.shapes and torch.equal(got.flat, want.flat)
    assert ckpt.latest_step(str(tmp_path)) == j_ckpt.latest_step(str(tmp_path))


@pytest.mark.parametrize("name", ["logreg", "nested"])
def test_port_params_shard_restores_in_the_reference(tmp_path, name):
    tree = _trees()[name]
    ckpt.save(str(tmp_path), 4, nested_from_jax(tree, "cpu"))
    like = _jax_tree({k: v for k, v in tree.items()})
    got = j_ckpt.restore(str(tmp_path), 4, like=like)
    for a, b in zip(jax_leaves(got), jax_leaves(tree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def jax_leaves(tree):
    """Leaves of a nested dict in key-path order (jax's tree order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(jax_leaves(v) if isinstance(v, dict) else [v])
    return out


def test_checkpoint_keeps_the_last_steps_and_ignores_incomplete(tmp_path):
    params = params_from_jax(_trees()["logreg"], "cpu")
    for step in range(5):
        ckpt.save(str(tmp_path), step, params, keep_last=3)
    assert ckpt.complete_steps(str(tmp_path)) == [2, 3, 4]
    os.makedirs(tmp_path / "step_00000009")  # no manifest: incomplete
    assert ckpt.latest_step(str(tmp_path)) == 4
    with pytest.raises(FileNotFoundError, match="incomplete"):
        ckpt.restore(str(tmp_path), 9, like=params)
    assert ckpt.restore_extra(str(tmp_path), 4) is None
    assert ckpt.complete_steps(str(tmp_path / "missing")) == []
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 4,
                     like=FlatParams(torch.zeros(11), {"w": (11,)}))
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 4,
                     like=FlatParams(torch.zeros(3), {"v": (3,)}))


# -- from_config on the LM -------------------------------------------------

LM_REDUCED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab=128, d_head=16)
LM_DG = dict(period=2, burn_in=2, history_size=2)


def test_from_config_builds_the_lm_session():
    """`from_config` on the InternLM2 architecture: the same session as one
    wired by hand from `build` and `Objective.from_model` (bitwise), with
    counters equal to the reference's `from_config` session's."""
    cfg = dict(steps=6, batch_size=8, lr=0.02, seed=5)
    docs = token_stream(32, 16, LM_REDUCED["vocab"], seed=0)
    sess = UnlearnerSession.from_config(
        "internlm2-1.8b", docs, reduced=LM_REDUCED, attn_impl="flash",
        dtype=torch.float32, loss_chunk=16,
        config=UnlearnerConfig(deltagrad=DeltaGradConfig(**LM_DG), **cfg),
        device="cpu")
    assert sess.model is not None and sess.model.cfg.head_dim == 16
    assert sess.params0.numel == count_params(sess.model.cfg)
    model = build(get_config("internlm2-1.8b").reduced(**LM_REDUCED))
    hand = UnlearnerSession(
        Objective.from_model(model, attn_impl="flash", dtype=torch.float32,
                             loss_chunk=16),
        model.init(1, device="cpu"),
        token_stream(32, 16, LM_REDUCED["vocab"], seed=0),
        UnlearnerConfig(deltagrad=DeltaGradConfig(**LM_DG), **cfg),
        device="cpu")
    jdocs = j_token_stream(32, 16, LM_REDUCED["vocab"], seed=0)
    ref = JSession.from_config(
        "internlm2-1.8b", jdocs, reduced=LM_REDUCED, loss_chunk=16,
        config=JConfig(deltagrad=JDGConfig(**LM_DG), **cfg))
    rows = [3, 11, 25, 30]
    stats = []
    for s in (sess, hand, ref):
        s.fit()
        stats.append(s.delete(rows).result().stats[0])
    assert torch.equal(sess.params.flat, hand.params.flat)
    assert np.isfinite(_port_flat(sess.params)).all()
    _same_counters(stats[0], stats[2])
    assert stats[0].approx_steps > 0
