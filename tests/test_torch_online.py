"""Algorithm 3 in the port (online delete and add requests with the history
rewrite) against the JAX package on the CPU, at the reference's own test
sizes (n = 1000 to 1200, d = 10 to 12, T = 60, B = 256).

Tolerances: schedules bitwise; the masked compact solve bitwise the
unmasked one on a full ring and within 1e-6 of the reference's at every
fill level; streams of deletions (SGD and heavy-ball) and mixed streams
within 1e-6 of the reference's parameters with every counter of every
request exactly equal.  Addition streams hold the counters exactly and
the parameters within 1e-4: in the fourth addition, the new row joins its
first batch at t = 9, and the explicit steps before it admit L-BFGS pairs
whose dw is f32 rounding (||dw|| ~ 4e-8 against ||w|| ~ 2.2: w^I_t
differs from the cached w_t only in how the batch mean was rounded), so
the approx steps after the join solve over noise.  Two f32
implementations' noise differs: the reference's own scan and python paths
part there by 1.6e-5 (SGD) and 7.3e-5 (heavy-ball), more than the port
parts from its scan path (1.2e-5, 3.3e-5).
`test_online_add_stream_gap_is_the_references_own` holds each request to
that, and the first three requests of either stream stay within 1e-6.
No ``curvature_eps`` separates those pairs: their <dg, dw>/<dw, dw> is
as large as the real pairs' (the witness test prints both ranges), and the
stream parts alike at ``curvature_eps=1e-8``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deltagrad as jdg
from repro.core import lbfgs as jlbfgs
from repro.core.history import HistoryMeta as JMeta
from repro.core.online import OnlineEngine as JEngine
from repro.core.online import online_deltagrad as j_online
from repro.data import sampler as jsampler
from repro.data.synthetic import binary_classification as j_binary
from repro.models.simple import logreg_objective as j_logreg

from repro_torch.core import deltagrad as tdg
from repro_torch.core import lbfgs as tlbfgs
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.core.online import OnlineEngine as TEngine
from repro_torch.core.online import online_deltagrad as t_online
from repro_torch.data import sampler as tsampler
from repro_torch.data.synthetic import binary_classification as t_binary
from repro_torch.models.simple import (logreg_objective, params_from_jax,
                                       params_to_numpy)

TOL = 1e-6
ADD_TOL = 1e-4
COUNTERS = ("explicit_steps", "approx_steps", "guard_fallbacks",
            "skipped_steps", "grad_examples", "grad_examples_baseline")


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
    return _flat(params_to_numpy(params))


# --------------------------------------------------------------------------
# the masked ring
# --------------------------------------------------------------------------


def _ring(m, p, fill, seed=0):
    """A newest-last (m, p) ring holding `fill` pairs, empty slots exact
    zeros, and a direction v."""
    rng = np.random.default_rng(seed)
    dW = np.zeros((m, p), np.float32)
    dG = np.zeros((m, p), np.float32)
    for i in range(m - fill, m):
        dW[i] = rng.normal(size=p)
        dG[i] = 0.7 * dW[i] + 0.1 * rng.normal(size=p)  # positive curvature
    return dW, dG, rng.normal(size=p).astype(np.float32)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_masked_solve_is_bitwise_the_unmasked_on_a_full_ring(m):
    dW, dG, v = (torch.from_numpy(x) for x in _ring(m, 257, m, seed=m))
    from repro_torch.kernels.lbfgs.ref import multidot_ref
    sw, sy, wv, gv = multidot_ref(dW, dG, v)
    valid = tlbfgs.ring_valid_mask(dW)
    assert bool(valid.all())
    a = tlbfgs.compact_coeffs(sw, sy, wv, gv)
    b = tlbfgs.compact_coeffs_masked(sw, sy, wv, gv, valid)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fill", [0, 1, 2, 3])
def test_masked_hvp_matches_the_reference_at_every_fill(fill):
    dW, dG, v = _ring(3, 301, fill, seed=fill + 10)
    mask_t = tlbfgs.ring_valid_mask(torch.from_numpy(dW))
    mask_j = jlbfgs.ring_valid_mask(jnp.asarray(dW))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert int(mask_t.sum()) == fill
    from repro_torch.kernels.lbfgs.ops import lbfgs_hvp_fused
    got = lbfgs_hvp_fused(torch.from_numpy(dW), torch.from_numpy(dG),
                          torch.from_numpy(v), mask_t).numpy()
    ref = np.asarray(jlbfgs.lbfgs_hvp_stacked_pytree(
        jnp.asarray(dW), jnp.asarray(dG), jnp.asarray(v), masked=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(1.0, np.abs(ref).max()))
    if fill == 0:
        assert not got.any()  # an empty ring is B v = 0


# --------------------------------------------------------------------------
# the online schedule
# --------------------------------------------------------------------------


def _sched_args(op, n=180, bs=48, T=14):
    """(positional args but `live`, `added`, `joins`, `add_pad`) of a
    stream state with two earlier adds and one earlier delete."""
    live = np.ones(n + 6, bool)
    live[7] = False  # deleted earlier
    added = np.asarray([n, n + 1], np.int64)
    joins = jsampler.addition_mask_all(3, T, n, bs, 8)
    return live, added, joins


CASES = {
    "delete-one": ("delete", [11], 4),
    "delete-group": ("delete", [11, 12, 40, 41, 99], 4),
    "delete-added-row": ("delete", [181, 30], 4),
    "add-one": ("add", [182], 4),
    "add-group": ("add", [182, 183, 184], 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_online_schedule_is_bitwise_the_reference(case):
    op, rows, add_pad = CASES[case]
    live, added, joins = _sched_args(op)
    lr_at = lambda t: 0.3 if t < 5 else 0.1  # noqa: E731
    kw = dict(idx_all=None, r_pad=None)
    j = jsampler.build_online_schedule(3, 14, 180, 48, rows, op, lr_at, live,
                                       added, joins, add_pad, **kw)
    t = tsampler.build_online_schedule(3, 14, 180, 48, rows, op, lr_at, live,
                                       added, joins, add_pad, **kw)
    assert (t.mode, t.r_pad) == (j.mode, j.r_pad)
    for f in ("idx", "kept_w", "changed_idx", "changed_w", "dB", "kept", "lr"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_online_schedule_rejects_bad_requests():
    live, added, joins = _sched_args("delete")
    with pytest.raises(ValueError, match="distinct"):
        tsampler.build_online_schedule(3, 14, 180, 48, [5, 5], "delete",
                                       lambda t: 0.1, live, added, joins, 4)
    with pytest.raises(ValueError, match="add_pad"):
        tsampler.build_online_schedule(3, 14, 180, 48, [5], "delete",
                                       lambda t: 0.1, live, added, joins, 1)


# --------------------------------------------------------------------------
# streams against the reference
# --------------------------------------------------------------------------


def _p0(d):
    rng = np.random.default_rng(1)
    return {"w": (0.01 * rng.normal(size=d)).astype(np.float32),
            "b": np.zeros((), np.float32)}


def _setup(pkg_name, n=1200, d=12, momentum=0.0, lr=0.3, steps=60,
           batch=256, tier=None):
    """Data, objective, meta, initial weights, trained model and history of
    one package, at the reference's `tests/test_engine.py` problem."""
    ds = (j_binary if pkg_name == "jax" else t_binary)(n=n, d=d, seed=0)
    if pkg_name == "jax":
        meta = JMeta(n=ds.n, batch_size=batch, seed=7, steps=steps,
                     lr_schedule=((0, lr),), momentum=momentum)
        obj, init = j_logreg(5e-3), {k: jnp.asarray(v) for k, v in _p0(d).items()}
        w_star, hist = jdg.sgd_train_with_cache(obj, init, ds, meta)
    else:
        meta = TMeta(n=ds.n, batch_size=batch, seed=7, steps=steps,
                     lr_schedule=((0, lr),), momentum=momentum)
        obj, init = logreg_objective(5e-3), params_from_jax(_p0(d), "cpu")
        w_star, hist = tdg.sgd_train_with_cache(obj, init, ds, meta,
                                                device="cpu", **(tier or {}))
    return ds, obj, meta, init, w_star, hist


def _requests(kind, ds):
    """(requests, mode) of a stream; appends the rows an add stream needs."""
    if kind == "delete":
        return [3, 17, 101, 640], "delete"
    if kind == "add":
        return ds.append({k: v[np.arange(4)]
                          for k, v in ds.columns.items()}).tolist(), "add"
    new = ds.append({k: v[np.arange(3)] for k, v in ds.columns.items()}).tolist()
    return [("delete", 5), ("add", new[0]), ("delete", 101), ("add", new[1]),
            ("delete", new[0]), ("add", new[2])], "delete"


def _stream_both(kind, momentum, cfg_kw):
    out = {}
    for name in ("jax", "torch"):
        ds, obj, meta, init, w_star, hist = _setup(name, momentum=momentum)
        reqs, mode = _requests(kind, ds)
        if name == "jax":
            w, st = j_online(obj, hist, ds, reqs,
                             jdg.DeltaGradConfig(**cfg_kw), mode=mode)
        else:
            w, st = t_online(obj, hist, ds, reqs,
                             tdg.DeltaGradConfig(**cfg_kw), mode=mode,
                             device="cpu")
        out[name] = (w, st, hist, ds)
    return out


STREAMS = {
    "delete": ("delete", 0.0, dict(period=5, burn_in=8, history_size=2)),
    "delete-momentum": ("delete", 0.9, dict(period=5, burn_in=8,
                                            history_size=2)),
    "mixed": ("mixed", 0.0, dict(period=5, burn_in=8, history_size=2)),
    "mixed-momentum": ("mixed", 0.9, dict(period=5, burn_in=8,
                                          history_size=2)),
    "delete-m3-guard": ("delete", 0.0, dict(period=4, burn_in=6,
                                            history_size=3, guard=True,
                                            curvature_eps=1e-8)),
    "delete-guard-fallback": ("delete", 0.0, dict(period=5, burn_in=8,
                                                  guard=True,
                                                  guard_norm_clip=0.0)),
    "add": ("add", 0.0, dict(period=5, burn_in=8, history_size=2)),
    "add-momentum": ("add", 0.9, dict(period=5, burn_in=8, history_size=2)),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_online_stream_matches_reference(case):
    kind, momentum, cfg_kw = STREAMS[case]
    res = _stream_both(kind, momentum, cfg_kw)
    (wj, sj, hj, dsj), (wt, st, ht, dst) = res["jax"], res["torch"]
    assert len(st.per_request) == len(sj.per_request)
    for a, b in zip(st.per_request, sj.per_request):
        for k in COUNTERS:
            assert getattr(a, k) == getattr(b, k), (k, a, b)
        assert a.approx_steps > 0 or case == "delete-guard-fallback"
    if case == "delete-guard-fallback":
        assert all(s.guard_fallbacks > 0 for s in st.per_request)
    tol = ADD_TOL if kind == "add" else TOL
    np.testing.assert_allclose(_port_flat(wt), _flat(wj), rtol=0, atol=tol)
    # the rewritten caches agree too: they seed the next request
    for t in (0, 30, 59):
        np.testing.assert_allclose(ht.entry(t)[0].numpy(),
                                   _flat(hj.entry(t)[0]), rtol=0, atol=tol)
        np.testing.assert_allclose(ht.entry(t)[1].numpy(),
                                   _flat(hj.entry(t)[1]), rtol=0, atol=tol)
    np.testing.assert_array_equal(dst.removed, dsj.removed)
    assert st.theoretical_speedup == sj.theoretical_speedup


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_online_add_stream_first_requests_match_reference(momentum):
    """Before any noise-level pair enters the ring, an addition stream
    holds the 1e-6 bar request by request."""
    engines = {}
    for name, cls in (("jax", JEngine), ("torch", TEngine)):
        ds, obj, meta, init, w_star, hist = _setup(name, momentum=momentum)
        new = ds.append({k: v[np.arange(3)] for k, v in ds.columns.items()})
        cfg = (jdg if name == "jax" else tdg).DeltaGradConfig(
            period=5, burn_in=8, history_size=2)
        kw = {} if name == "jax" else {"device": "cpu"}
        engines[name] = (cls(obj, hist, ds, cfg, add_capacity=4, **kw), new)
    for i in range(3):
        engines["jax"][0].request("add", int(engines["jax"][1][i]))
        engines["torch"][0].request("add", int(engines["torch"][1][i]))
        np.testing.assert_allclose(_port_flat(engines["torch"][0].params),
                                   _flat(engines["jax"][0].params), rtol=0,
                                   atol=TOL, err_msg=f"request {i}")
    engines["torch"][0].close()


@pytest.mark.parametrize("momentum,eps", [(0.0, 0.0), (0.9, 0.0),
                                         (0.0, 1e-8)])
def test_online_add_stream_gap_is_the_references_own(momentum, eps,
                                                     monkeypatch):
    """The 4-add stream of `test_online_stream_matches_reference[add*]`,
    request by request: the port's gap to the reference's scan path stays
    within the larger of 1e-6 and the reference's own scan-to-python gap,
    and a request that parts by more than 1e-6 admitted a pair whose dw is
    rounding noise (||dw|| < 1e-6 ||w||) into the port's ring."""
    from repro_torch.core import engine

    admitted = []
    real = engine._ring_append

    def spy(dW, dG, dw, dg, admit, eps):
        if admit[1] > 0 and admit[0] >= eps * admit[1]:
            admitted.append((float(dw.norm()), float(admit[0] / admit[1])))
        return real(dW, dG, dw, dg, admit, eps)

    monkeypatch.setattr(engine, "_ring_append", spy)
    engines = {}
    for name, cls, impl in (("scan", JEngine, "scan"),
                            ("python", JEngine, "python"),
                            ("torch", TEngine, None)):
        ds, obj, meta, init, w_star, hist = _setup(
            "torch" if impl is None else "jax", momentum=momentum)
        new = ds.append({k: v[np.arange(4)] for k, v in ds.columns.items()})
        if impl is None:
            cfg, kw = tdg.DeltaGradConfig(period=5, burn_in=8, history_size=2,
                                          curvature_eps=eps), {"device": "cpu"}
            w_norm = float(hist.final_params.flat.norm())
        else:
            cfg, kw = jdg.DeltaGradConfig(period=5, burn_in=8, history_size=2,
                                          curvature_eps=eps, impl=impl), {}
        engines[name] = (cls(obj, hist, ds, cfg, add_capacity=4, **kw), new)
    parted = 0
    for i in range(4):
        admitted.clear()
        for eng, new in engines.values():
            eng.request("add", int(new[i]))
        w = {k: (_port_flat if k == "torch" else _flat)(e.params)
             for k, (e, _) in engines.items()}
        port = np.abs(w["torch"] - w["scan"]).max()
        own = np.abs(w["python"] - w["scan"]).max()
        noise = min(n for n, _ in admitted) / w_norm
        curv = {kind: [c for n, c in admitted if (n < 1e-6 * w_norm) == small]
                for kind, small in (("noise", True), ("real", False))}
        print(f"momentum {momentum} eps {eps} add {i}: port vs scan "
              f"{port:.2e}, python vs scan {own:.2e}, least admitted "
              f"||dw||/||w|| {noise:.1e}; <dg,dw>/<dw,dw> "
              + ", ".join(f"{k} pairs {min(c):.2f} to {max(c):.2f}"
                          for k, c in curv.items() if c))
        assert port <= max(TOL, own), (i, port, own)
        if port > TOL:
            parted += 1
            assert noise < 1e-6, (i, noise)
    assert parted >= 1  # the stream reaches the noise pairs
    engines["torch"][0].close()


# --------------------------------------------------------------------------
# the reference's own assertions (tests/test_online.py), on the port
# --------------------------------------------------------------------------


def _retrain(meta, init, obj, changed, mode):
    ds = t_binary(n=1000, d=10, seed=0)
    if mode == "add":
        ds.append({k: v[changed] for k, v in ds.columns.items()})
        changed = np.arange(1000, 1000 + len(changed))
    return tdg.baseline_retrain(obj, ds, meta, init, changed, mode=mode,
                                device="cpu")[0]


@pytest.mark.parametrize("kind", ["delete", "add", "momentum-delete"])
def test_online_tracks_scratch_retrain(kind):
    momentum, lr = (0.9, 0.1) if kind == "momentum-delete" else (0.0, 0.5)
    ds, obj, meta, init, w_star, hist = _setup(
        "torch", n=1000, d=10, momentum=momentum, lr=lr)
    cfg = tdg.DeltaGradConfig(period=5, burn_in=8, history_size=2)
    if kind == "add":
        src = np.random.default_rng(6).choice(meta.n, 5, replace=False)
        reqs = ds.append({k: v[src] for k, v in ds.columns.items()}).tolist()
        w_u = _retrain(meta, init, obj, src, "add")
        mode = "add"
    else:
        reqs = np.random.default_rng(5).choice(ds.n, size=6, replace=False)
        w_u = _retrain(meta, init, obj, reqs, "delete")
        mode = "delete"
    w_i, ostats = t_online(obj, hist, ds, reqs, cfg, mode=mode, device="cpu")
    d_ui = float((w_u.flat - w_i.flat).norm())
    d_us = float((w_u.flat - w_star.flat).norm())
    assert d_ui < 0.3 * d_us, (d_ui, d_us)
    assert len(ostats.per_request) == len(reqs)
    assert ostats.theoretical_speedup > 2.0


def test_online_rewrites_history_and_dataset():
    ds, obj, meta, init, w_star, hist = _setup("torch", n=1000, d=10,
                                                steps=40, lr=0.5)
    w_i, _ = t_online(obj, hist, ds, [3, 17],
                      tdg.DeltaGradConfig(period=5, burn_in=6), device="cpu")
    assert torch.equal(hist.final_params.flat, w_i.flat)
    assert set(np.nonzero(ds.removed)[0].tolist()) == {3, 17}
    with pytest.raises(ValueError, match="already deleted"):
        t_online(obj, hist, ds, [17], tdg.DeltaGradConfig(period=5, burn_in=6),
                 device="cpu")


def test_online_single_request_close_to_batch_mode():
    ds, obj, meta, init, w_star, hist = _setup("torch", n=1000, d=10,
                                                steps=50, lr=0.5)
    cfg = tdg.DeltaGradConfig(period=5, burn_in=8)
    w_batch, _ = tdg.deltagrad_retrain(obj, hist, ds, np.array([11]), cfg,
                                       device="cpu")
    w_online, _ = t_online(obj, hist, ds, [11], cfg, device="cpu")
    assert float((w_batch.flat - w_online.flat).norm()) < 1e-4


def test_online_requests_need_a_card_by_default(monkeypatch):
    ds, obj, meta, init, w_star, hist = _setup("torch", n=200, d=4, steps=10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_online(obj, hist, ds, [1], tdg.DeltaGradConfig())


# --------------------------------------------------------------------------
# streamed histories, the engine's state
# --------------------------------------------------------------------------


def _port_stream(tier, kind="mixed", momentum=0.0, decode="auto", window=0):
    ds, obj, meta, init, w_star, hist = _setup("torch", momentum=momentum,
                                                tier=tier)
    reqs, mode = _requests(kind, ds)
    cfg = tdg.DeltaGradConfig(period=5, burn_in=8, history_size=2,
                              stream_window=window, stream_decode=decode)
    w, st = t_online(obj, hist, ds, reqs, cfg, mode=mode, device="cpu")
    return w, st, hist


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_streamed_f32_stream_is_bitwise_the_resident_one(momentum):
    w_r, st_r, h_r = _port_stream(None, momentum=momentum)
    w_s, st_s, h_s = _port_stream(dict(tier="host", codec="f32", window=7),
                                  momentum=momentum, window=7)
    assert torch.equal(w_s.flat, w_r.flat)
    assert st_s.per_request[0].extra["store"] == "streamed"
    for a, b in zip(st_s.per_request, st_r.per_request):
        assert a.counters() == b.counters()
    for t in range(60):
        assert all(torch.equal(x, y) for x, y in zip(h_s.entry(t), h_r.entry(t)))


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_streamed_delta_int8_kernel_mode_is_bitwise_fetch_mode(tier, tmp_path):
    spill = dict(spill_dir=str(tmp_path / "k")) if tier == "disk" else {}
    rec = dict(tier=tier, codec="delta_int8", window=7, **spill)
    w_k, st_k, h_k = _port_stream(rec, decode="kernel", window=7)
    if tier == "disk":
        rec["spill_dir"] = str(tmp_path / "f")
    w_f, st_f, h_f = _port_stream(rec, decode="fetch", window=7)
    assert st_k.per_request[0].extra["stream_decode"] == "kernel"
    assert st_f.per_request[0].extra["stream_decode"] == "fetch"
    assert torch.equal(w_k.flat, w_f.flat)
    for a, b in zip(st_k.per_request, st_f.per_request):
        assert a.counters() == b.counters()
        assert a.approx_steps > 0
    for t in (0, 9, 33, 59):  # the rewritten codes decode alike
        assert all(torch.equal(x, y) for x, y in zip(h_k.entry(t), h_f.entry(t)))


def test_engine_state_dict_round_trips():
    ds, obj, meta, init, w_star, hist = _setup("torch", n=600, d=6, steps=30)
    new = ds.append({k: v[:2] for k, v in ds.columns.items()})
    cfg = tdg.DeltaGradConfig(period=5, burn_in=6)
    eng = TEngine(obj, hist, ds, cfg, add_capacity=2, device="cpu")
    eng.request("delete", 4)
    eng.request("add", int(new[0]))
    state = eng.state_dict()
    assert state["added"] == [int(new[0])] and not state["live"][4]
    assert state["lbfgs_ring"][0].shape == (2, 7)
    twin = TEngine(obj, hist, ds, cfg, device="cpu")
    twin.load_state(state)
    assert twin.added == eng.added and twin._add_pad == eng._add_pad
    np.testing.assert_array_equal(twin.live, eng.live)
    a, b = eng.request("add", int(new[1])), twin.request_group("delete", [9])
    assert a.explicit_steps > 0 and b.explicit_steps > 0
    with pytest.raises(ValueError, match="appended after"):
        twin.request("add", 3)
    eng.close()
    twin.close()
