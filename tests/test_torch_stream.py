"""The streamed replay of host- and disk-tier histories against the JAX
package, and the port's own bitwise invariants.

The small MLP of `test_torch_slice.py` (d = 20, hidden 32, 4 classes, the
paper-MLP recipe at T = 24).  Against JAX: an f32 host-tier run trained in
both packages, and lossy codes trained and encoded by JAX then replayed by
both on the same codes (`TrainingHistory.from_state_dict`): parameters
within 1e-5 (absolute; f32 sums taken in another order), all seven
counters exactly equal.  Inside the port, bitwise: the streamed f32 replay
equals the resident one, and kernel mode equals fetch mode for every lossy
codec, at stream windows 8 and 12 (neither divides the key interval 16
nor T = 24 evenly, so windows straddle keyframes and end short).

Plain int8 codes quantize w_t by a per-leaf absmax step, which at this
size swamps dw = w_I - w_t: the curvature check rejects every pair, in
both packages, and every step runs explicit.  So int8 is also run under a
recipe that admits every pair ("int8-admit"), which puts its approx steps,
and the dequant kernels' path, to work.
"""

import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import deltagrad as jdg
from repro.core.history import HistoryMeta as JMeta
from repro.core.store import SegmentStreamer as JStreamer
from repro.data.synthetic import multiclass_classification as j_multiclass
from repro.models.simple import mlp_objective as j_mlp_objective

from repro_torch.core import deltagrad as tdg
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.core.history import TrainingHistory as THistory
from repro_torch.core.store import (HistoryStore, SegmentStreamer,
                                   decode_row)
from repro_torch.data.synthetic import multiclass_classification as t_multiclass
from repro_torch.models.simple import mlp_objective, params_from_jax

PARAM_TOL = 1e-5
LOSSY = ("bf16", "int8", "delta_bf16", "delta_int8")
LR = ((0, 0.2), (10, 0.1))
N, STEPS, D, HIDDEN, CLASSES = 1200, 24, 20, 32, 4
CFG = dict(period=2, burn_in=6, history_size=2, guard=True, curvature_eps=1e-8)
ADMIT_ALL = dict(period=2, burn_in=6, history_size=2, guard=False,
                 curvature_eps=-1e9)
# case -> (codec, recipe)
CASES = {"bf16": ("bf16", CFG), "int8": ("int8", CFG),
         "int8-admit": ("int8", ADMIT_ALL), "delta_bf16": ("delta_bf16", CFG),
         "delta_int8": ("delta_int8", CFG)}


def _init():
    rng = np.random.default_rng(6)
    return {
        "w1": (rng.normal(size=(D, HIDDEN)) / np.sqrt(D)).astype(np.float32),
        "b1": np.zeros(HIDDEN, np.float32),
        "w2": (rng.normal(size=(HIDDEN, CLASSES)) / np.sqrt(HIDDEN)).astype(np.float32),
        "b2": np.zeros(CLASSES, np.float32),
    }


def _changed():
    return np.random.default_rng(2).choice(N, size=12, replace=False)


def _tmeta():
    return TMeta(n=N, batch_size=1 << 30, seed=7, steps=STEPS, lr_schedule=LR)


@functools.lru_cache(maxsize=None)
def _jax_run(codec, window, case=None):
    """JAX: host-tier training under `codec`, then the streamed replay
    under `case`'s recipe (the paper's by default)."""
    recipe = CASES[case][1] if case else CFG
    ds = j_multiclass(n=N, d=D, num_classes=CLASSES, seed=5)
    meta = JMeta(n=N, batch_size=1 << 30, seed=7, steps=STEPS, lr_schedule=LR)
    p0 = {k: jnp.asarray(v) for k, v in _init().items()}
    obj = j_mlp_objective(l2=1e-3)
    _, hist = jdg.sgd_train_with_cache(obj, p0, ds, meta, tier="host",
                                       codec=codec, window=window)
    w, st = jdg.deltagrad_retrain(obj, hist, ds, _changed(), jdg.DeltaGradConfig(
        stream_window=window, **recipe))
    return hist.state_dict(), np.asarray(ravel_pytree(w)[0]), st


@functools.lru_cache(maxsize=None)
def _port_history(tier, codec, window=8):
    ds = t_multiclass(n=N, d=D, num_classes=CLASSES, seed=5)
    return tdg.sgd_train_with_cache(
        mlp_objective(l2=1e-3), params_from_jax(_init(), "cpu"), ds, _tmeta(),
        tier=tier, codec=codec, window=window,
        spill_dir="auto" if tier == "disk" else None, device="cpu")


def _replay(hist, recipe=CFG, **cfg):
    ds = t_multiclass(n=N, d=D, num_classes=CLASSES, seed=5)
    return tdg.deltagrad_retrain(mlp_objective(l2=1e-3), hist, ds, _changed(),
                                 tdg.DeltaGradConfig(**recipe, **cfg),
                                 device="cpu")


def _counters_equal(port, ref):
    for k, v in port.counters().items():
        assert v == getattr(ref, k), (k, port.counters(), ref)


def test_f32_host_tier_trained_in_both_matches_jax():
    _, j_w, j_st = _jax_run("f32", 8)
    w_star, hist = _port_history("host", "f32")
    w, st = _replay(hist, stream_window=8)
    np.testing.assert_allclose(w.flat.numpy(), j_w, rtol=0, atol=PARAM_TOL)
    _counters_equal(st, j_st)
    assert st.extra["store"] == "streamed" == j_st.extra["store"]
    assert st.extra["windows"] > 1 and st.extra["stream_decode"] == "fetch"
    assert st.approx_steps > 0


@pytest.mark.parametrize("mode", ["kernel", "fetch"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lossy_codes_replay_like_jax(case, mode):
    codec, recipe = CASES[case]
    state, j_w, j_st = _jax_run(codec, 8, case)
    hist = THistory.from_state_dict(state, _tmeta(), device="cpu")
    w, st = _replay(hist, recipe, stream_window=8, stream_decode=mode)
    np.testing.assert_allclose(w.flat.numpy(), j_w, rtol=0, atol=PARAM_TOL)
    _counters_equal(st, j_st)
    assert st.extra["store"] == "streamed"
    assert st.extra["stream_decode"] == mode
    # the reference fetches windows for approx segments only (its explicit
    # steps read the history row by row); the port's explicit steps read
    # their rows from the windows too, so each of the 3 windows of 8 steps
    # is fetched exactly once, whatever the steps' kinds
    assert st.extra["windows"] == 3 >= j_st.extra.get("windows", 0)
    if case == "int8":
        assert st.approx_steps == 0 and st.pairs_rejected == st.explicit_steps
    else:
        assert st.approx_steps > 0


@pytest.mark.parametrize("window", [8, 12])
def test_streamed_f32_replay_is_bitwise_the_resident_one(window):
    _, stacked = _port_history("stacked", "f32")
    w_star, host = _port_history("host", "f32", window)
    w_res, st_res = _replay(stacked)
    w, st = _replay(host, stream_window=window)
    assert torch.equal(w.flat, w_res.flat)
    assert st.counters() == st_res.counters()
    # about two windows (the current one and the next, prefetched) of the
    # path on the device; at window 12 that is all 24 steps
    row_bytes = 2 * w.numel * 4
    assert st.extra["hbm_high_water"] <= 2 * window * row_bytes
    assert st.extra["hbm_high_water"] <= st_res.extra["hbm_high_water"]
    if 2 * window < STEPS:
        assert st.extra["hbm_high_water"] < st_res.extra["hbm_high_water"]


@pytest.mark.parametrize("window", [8, 12])
@pytest.mark.parametrize("case", sorted(set(CASES) - {"int8"}))  # int8-admit
def test_kernel_mode_is_bitwise_fetch_mode(case, window):
    codec, recipe = CASES[case]
    _, host = _port_history("host", codec)
    w_k, st_k = _replay(host, recipe, stream_window=window,
                        stream_decode="kernel")
    w_f, st_f = _replay(host, recipe, stream_window=window,
                        stream_decode="fetch")
    w_a, st_a = _replay(host, recipe)  # the auto window and decode mode
    assert st_k.approx_steps > 0
    assert torch.equal(w_k.flat, w_f.flat) and torch.equal(w_k.flat, w_a.flat)
    assert st_k.counters() == st_f.counters() == st_a.counters()
    assert st_a.extra["stream_decode"] == "kernel"
    # the encoded window holds less of the device than the decoded one
    assert st_k.extra["hbm_high_water"] < st_f.extra["hbm_high_water"]
    assert st_k.extra["encoded_bytes_high"] == st_f.extra["encoded_bytes_high"]


def test_disk_tier_replays_bitwise_the_host_tier():
    _, host = _port_history("host", "delta_int8")
    _, disk = _port_history("disk", "delta_int8")
    w_h, st_h = _replay(host, stream_window=12)
    w_d, st_d = _replay(disk, stream_window=12)
    assert torch.equal(w_h.flat, w_d.flat) and st_h.counters() == st_d.counters()
    assert st_d.extra["spill_io_read_s"] > 0 and st_d.extra["spill_io_write_s"] > 0
    assert "spill_io_read_s" not in st_h.extra
    assert st_d.extra["compression_ratio"] > 2


def test_guard_retry_inside_a_window_matches_jax():
    """clip 0 trips the guard on every approx step: each segment is re-run
    up to the tripped step inside its window."""
    cfg = dict(CFG, guard_norm_clip=0.0)
    ds = j_multiclass(n=N, d=D, num_classes=CLASSES, seed=5)
    meta = JMeta(n=N, batch_size=1 << 30, seed=7, steps=STEPS, lr_schedule=LR)
    p0 = {k: jnp.asarray(v) for k, v in _init().items()}
    obj = j_mlp_objective(l2=1e-3)
    _, jh = jdg.sgd_train_with_cache(obj, p0, ds, meta, tier="host",
                                     codec="delta_int8", window=8)
    j_w, j_st = jdg.deltagrad_retrain(obj, jh, ds, _changed(),
                                      jdg.DeltaGradConfig(stream_window=8, **cfg))
    hist = THistory.from_state_dict(jh.state_dict(), _tmeta(), device="cpu")
    tds = t_multiclass(n=N, d=D, num_classes=CLASSES, seed=5)
    w, st = tdg.deltagrad_retrain(mlp_objective(l2=1e-3), hist, tds, _changed(),
                                  tdg.DeltaGradConfig(stream_window=8, **cfg),
                                  device="cpu")
    assert st.guard_fallbacks > 0
    _counters_equal(st, j_st)
    np.testing.assert_allclose(w.flat.numpy(), np.asarray(ravel_pytree(j_w)[0]),
                               rtol=0, atol=PARAM_TOL)


@pytest.mark.parametrize("codec,asked,got", [
    ("f32", "auto", "fetch"), ("f32", "kernel", "fetch"),
    ("f32", "fetch", "fetch"), ("int8", "auto", "kernel"),
    ("delta_int8", "auto", "kernel"), ("delta_int8", "fetch", "fetch"),
    ("bf16", "kernel", "kernel")])
def test_decode_mode_resolves_as_in_the_reference(codec, asked, got):
    state, _, _ = _jax_run(codec, 8)
    from repro.core.history import TrainingHistory as JHistory

    jstore = JStreamer(JHistory.from_state_dict(state), decode=asked)
    store = HistoryStore.create(
        THistory.from_state_dict(state, _tmeta(), device="cpu"), decode=asked)
    try:
        assert isinstance(store, SegmentStreamer)
        assert store.decode_mode == jstore.decode_mode == got
        assert store.window_len == jstore.window_len == STEPS
    finally:
        store.close()
        jstore._pool.shutdown()


def test_unknown_decode_mode_is_refused_like_the_reference():
    _, host = _port_history("host", "int8")
    with pytest.raises(ValueError, match="unknown decode mode"):
        _replay(host, stream_decode="eager")


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_staging_threads_keep_the_streamer_accounts(tier):
    """Every window of one step staged at once by more threads than cores
    (a short switch interval forces interleaving): each window arrives
    intact, and the shared byte counts and the pinned pool's bookkeeping
    add up after close."""
    _, hist = _port_history(tier, "delta_int8")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        store = SegmentStreamer(hist, window=1, decode="kernel",
                                max_prefetch=32, stage_threads=32)
        for wid in range(STEPS):
            store._prefetch(wid)
        for t in range(STEPS):
            W, G, off = store.window(t, t + 1)
            w_t, g_t = hist.entry(t)
            assert torch.equal(decode_row(W, t - off), w_t)
            assert torch.equal(decode_row(G, t - off), g_t)
        assert store.prefetch_hits == STEPS == store.windows_fetched
        store.close()
        assert store._inflight_bytes == 0 and store._hbm_now == 0
        assert 0 < store.hbm_high_water() <= STEPS * store.enc_bytes_high
    finally:
        sys.setswitchinterval(old)
