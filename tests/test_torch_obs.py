"""The port's observability (`repro_torch.obs`, `repro_torch.roofline`) and
the engine's, store's and online engine's instrumentation, against the JAX
package on the CPU.

Tolerances: exported metric text (JSONL and Prometheus) byte for byte;
`Histogram` quantiles exactly; the Chrome export under a virtual clock
exactly; the roofline's costs exactly for one explicit `HwSpec`; the span
names and their step args (t0, t1, steps, r, t, prefix, regions, op, k,
wid, parent) of a resident replay, a host-tier streamed replay and an
online request exactly, in order, with the engine's and the store's
counters equal.
"""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import deltagrad as jdg
from repro.core.history import HistoryMeta as JMeta
from repro.core.online import OnlineEngine as JEngine
from repro.data.synthetic import binary_classification as j_binary
from repro.models.simple import logreg_objective as j_logreg
from repro.obs import metrics as j_metrics
from repro.obs import trace as j_trace
from repro.roofline import hw as j_hw
from repro.roofline import replay as j_replay

from repro_torch.core import deltagrad as tdg
from repro_torch.core import engine as tengine
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.core.online import OnlineEngine as TEngine
from repro_torch.data.synthetic import binary_classification as t_binary
from repro_torch.models.simple import logreg_objective, params_from_jax
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace
from repro_torch.obs.metrics import Histogram, MetricsRegistry, read_jsonl
from repro_torch.obs.trace import NOOP_SPAN, Tracer
from repro_torch.roofline import hw as t_hw
from repro_torch.roofline import replay as t_replay

PKGS = {"jax": (j_metrics, j_trace), "torch": (t_metrics, t_trace)}


@pytest.fixture(autouse=True)
def _tracers_clean():
    """Never leak an enabled tracer or a swapped registry between tests."""
    olds = [m.get_registry() for m, _ in PKGS.values()]
    for _, tr in PKGS.values():
        tr.disable()
    yield
    for (m, tr), old in zip(PKGS.values(), olds):
        tr.disable()
        m.set_registry(old)


class _VirtualClock:
    """Monotonic fake: every read advances by `step` seconds (thread-safe
    enough for the GIL: one attribute update per read)."""

    def __init__(self, start=100.0, step=0.25):
        self.t = start
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


# --------------------------------------------------------------------------
# metrics: byte-equal exports
# --------------------------------------------------------------------------


def _exercise(metrics_mod, seed):
    """One fixed sequence of registry operations (seeded samples)."""
    rng = np.random.default_rng(seed)
    reg = metrics_mod.MetricsRegistry()
    reg.counter("engine.replays", owner="core.engine").inc()
    reg.counter("engine.approx_steps", owner="core.engine").inc(45)
    reg.counter("store.host_wait_s", unit="s",
                owner="core.store").inc(float(rng.random()))
    g = reg.gauge("store.hbm_high_water_bytes", unit="B", owner="core.store")
    g.set_max(float(rng.integers(1, 1 << 30)))
    g.set_max(3.0)
    reg.gauge("online.compile_time_s", unit="s", owner="core.online").set(0.0)
    for cls in ("interactive", "batch", "bulk_gdpr"):
        reg.counter("serve.served", owner="serve.monitor",
                    labels={"class": cls}).inc(int(rng.integers(0, 9)))
        h = reg.histogram("serve.e2e_ms", unit="ms", owner="serve.monitor",
                          labels={"class": cls})
        for v in rng.lognormal(3.0, 1.0, size=int(rng.integers(1, 300))):
            h.observe(float(v))
    reg.histogram("serve.batch_size", owner="serve.monitor")  # empty
    h = reg.histogram("launch.dispatch_ms", unit="ms", owner="launch.serve")
    for v in (0.0, 1e-9, 5.0, 1e12):  # underflow, tiny, mid, overflow
        h.observe(v)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_exports_are_byte_equal_to_the_reference(seed, tmp_path):
    rj, rt = _exercise(j_metrics, seed), _exercise(t_metrics, seed)
    assert rt.to_prometheus() == rj.to_prometheus()
    pj = rj.to_jsonl(str(tmp_path / "j.jsonl"))
    pt = rt.to_jsonl(str(tmp_path / "t.jsonl"))
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert b.read() == a.read()
    assert read_jsonl(pt) == rt.snapshot()


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "constant",
                                  "two-points", "tiny"])
def test_histogram_quantiles_equal_the_reference(dist):
    rng = np.random.default_rng(7)
    sample = {"lognormal": rng.lognormal(2.0, 1.2, 4000),
              "uniform": rng.uniform(0.0, 50.0, 777),
              "constant": np.full(10, 3.5),
              "two-points": np.asarray([1.0] * 30 + [900.0] * 3),
              "tiny": rng.uniform(0.0, 1e-7, 50)}[dist]
    hj, ht = j_metrics.Histogram("x", unit="ms"), Histogram("x", unit="ms")
    for v in sample:
        hj.observe(float(v))
        ht.observe(float(v))
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert ht.quantile(q) == hj.quantile(q), q
    assert ht.summary() == hj.summary()
    assert ht.snapshot() == hj.snapshot()


def test_histogram_tracks_np_percentile():
    rng = np.random.default_rng(0)
    sample = rng.lognormal(mean=2.0, sigma=1.2, size=5000)
    h = Histogram("lat", unit="ms")
    for v in sample:
        h.observe(float(v))
    s = h.summary()
    assert s["count"] == 5000
    assert s["mean"] == pytest.approx(float(np.mean(sample)))
    for key, q in (("p50", 50), ("p95", 95), ("p99", 99)):
        exact = float(np.percentile(sample, q))
        assert abs(s[key] - exact) / exact < 0.05, (key, s[key], exact)


def test_empty_histogram_and_registry_basics():
    assert Histogram("x").summary() == {"count": 0}
    reg = MetricsRegistry()
    c = reg.counter("engine.replays")
    c.inc()
    c.inc(3)
    assert reg.counter("engine.replays").value == 4
    g = reg.gauge("store.hbm_high_water_bytes", unit="B")
    g.set_max(100)
    g.set_max(40)
    assert g.value == 100 and g.high == 100
    g.set(10)
    assert g.value == 10 and g.high == 100
    with pytest.raises(TypeError):
        reg.histogram("engine.replays")
    a = reg.counter("serve.served", labels={"class": "interactive"})
    b = reg.counter("serve.served", labels={"class": "batch"})
    a.inc()
    assert b.value == 0
    assert reg.to_prometheus().endswith("\n")
    assert MetricsRegistry().to_prometheus() == ""


def test_default_registry_swap():
    old = t_metrics.get_registry()
    fresh = t_metrics.set_registry(MetricsRegistry())
    assert t_metrics.get_registry() is fresh and fresh is not old


# --------------------------------------------------------------------------
# the tracer
# --------------------------------------------------------------------------


def test_disabled_tracer_is_the_shared_noop():
    assert not t_trace.enabled() and t_trace.get_tracer() is None
    s = t_trace.span("replay.scan", t0=0, t1=8)
    assert s is NOOP_SPAN and t_trace.span("x") is s
    with s as inner:
        assert inner.set(b=2) is NOOP_SPAN


def test_disabled_overhead_bound():
    """The disabled call is an attr load + None check: bound it loosely
    (20 µs a call, the reference test's bound) so a slow runner never
    flakes."""
    iters = 50_000
    t0 = time.perf_counter()
    for _ in range(iters):
        t_trace.span("replay.scan", t0=0, t1=8)
    assert (time.perf_counter() - t0) / iters < 20e-6


def test_scan_pred_computes_nothing_while_tracing_is_off():
    assert tengine._scan_pred(10_000, 8, 4, 2, False) is None
    t_trace.enable(Tracer())
    want = t_replay.scan_segment_cost(10_000, 8, 4, 2).pred_s
    assert tengine._scan_pred(10_000, 8, 4, 2, False) == want > 0


def test_enable_disable_roundtrip():
    tr = t_trace.enable()
    assert t_trace.enabled() and t_trace.get_tracer() is tr
    assert t_trace.enable() is tr
    assert t_trace.disable() is tr
    assert not t_trace.enabled() and t_trace.disable() is None


def _nested_spans(trace_mod, clock):
    tr = trace_mod.enable(trace_mod.Tracer(clock=clock))
    with trace_mod.span("serve.batch", size=3, op="delete"):
        with trace_mod.span("online.request", op="delete", k=3, pred_s=0.5):
            with trace_mod.span("replay.scan", t0=11, t1=15,
                                pred_s=0.125) as s:
                s.set(extra=np.float32(2.5))
            with trace_mod.span("replay.commit", regions=2):
                pass
    with trace_mod.span("serve.admit", op="add", tenant="a",
                        cls="interactive"):
        pass
    trace_mod.disable()
    return tr


def test_chrome_export_equals_the_reference_under_a_virtual_clock(tmp_path):
    trj = _nested_spans(j_trace, _VirtualClock())
    trt = _nested_spans(t_trace, _VirtualClock())
    assert trt.to_chrome() == trj.to_chrome()
    pj = trj.export_chrome(str(tmp_path / "j.json"))
    pt = trt.export_chrome(str(tmp_path / "t.json"))
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert b.read() == a.read()
    doc = json.load(open(pt))
    scan = next(e for e in doc["traceEvents"] if e["name"] == "replay.scan")
    assert scan["args"]["parent"] == "online.request"
    assert scan["args"]["measured_s"] == pytest.approx(0.25)
    assert scan["args"]["roofline_ratio"] == pytest.approx(2.0)


def test_cross_thread_spans_get_own_track():
    tr = t_trace.enable(Tracer())
    started, release = threading.Event(), threading.Event()

    def worker():
        with t_trace.span("store.window_stage", wid=3):
            started.set()
            release.wait(timeout=5)

    th = threading.Thread(target=worker, name="history-stage-0")
    with t_trace.span("replay.scan"):
        th.start()
        assert started.wait(timeout=5)
        release.set()
        th.join(timeout=5)
    t_trace.disable()
    by_name = {e["name"]: e for e in tr.events()}
    assert by_name["store.window_stage"]["tid"] != by_name["replay.scan"]["tid"]
    assert "parent" not in by_name["store.window_stage"]["args"]
    names = {m["args"]["name"] for m in tr.to_chrome()["traceEvents"]
             if m.get("ph") == "M"}
    assert "history-stage-0" in names


def test_max_events_drops_not_grows():
    tr = t_trace.enable(Tracer(max_events=3))
    for i in range(5):
        with t_trace.span(f"s{i}"):
            pass
    t_trace.disable()
    assert len(tr.events()) == 3 and tr.dropped == 2
    tr.clear()
    assert tr.events() == [] and tr.dropped == 0


# --------------------------------------------------------------------------
# the roofline
# --------------------------------------------------------------------------

SPEC = dict(name="test", peak=100e12, bw=2e12, link=50e9, hbm=16e9)


def _specs():
    """The same machine for both packages: the reference prices FLOPs at
    ``peak_flops_bf16``, the port at ``peak_flops_f32``."""
    j = j_hw.HwSpec(name=SPEC["name"], peak_flops_bf16=SPEC["peak"],
                    hbm_bw=SPEC["bw"], ici_link_bw=SPEC["link"],
                    hbm_bytes=SPEC["hbm"])
    t = t_hw.HwSpec(name=SPEC["name"], peak_flops_bf16=4 * SPEC["peak"],
                    peak_flops_f32=SPEC["peak"], hbm_bw=SPEC["bw"],
                    link_bw=SPEC["link"], hbm_bytes=SPEC["hbm"])
    return j, t


@pytest.mark.parametrize("shape", [(238_510, 64, 2, False),
                                   (47_237, 32, 2, True),
                                   (504_899_584, 4, 2, False),
                                   (1, 1, 0, False), (300, 1024, 8, True)])
@pytest.mark.parametrize("steps", [1, 9])
def test_replay_costs_equal_the_reference(shape, steps):
    P, r, m, mom = shape
    hj, ht = _specs()
    for dtype_bytes in (4, 2):
        a = j_replay.replay_step_cost(P, r, m, momentum=mom,
                                      dtype_bytes=dtype_bytes, hw=hj)
        b = t_replay.replay_step_cost(P, r, m, momentum=mom,
                                      dtype_bytes=dtype_bytes, hw=ht)
        assert (b.flops, b.hbm_bytes, b.t_compute, b.t_memory, b.pred_s,
                b.bound) == (a.flops, a.hbm_bytes, a.t_compute, a.t_memory,
                             a.pred_s, a.bound)
        a = j_replay.scan_segment_cost(P, steps, r, m, momentum=mom,
                                       dtype_bytes=dtype_bytes, hw=hj)
        b = t_replay.scan_segment_cost(P, steps, r, m, momentum=mom,
                                       dtype_bytes=dtype_bytes, hw=ht)
        assert (b.flops, b.hbm_bytes, b.t_compute, b.t_memory,
                b.pred_s) == (a.flops, a.hbm_bytes, a.t_compute, a.t_memory,
                              a.pred_s)


def test_h100_is_the_default_spec_and_f32_prices_the_flops():
    h = t_hw.H100_SXM5_80GB
    assert (h.peak_flops_bf16, h.peak_flops_f32, h.hbm_bw, h.link_bw,
            h.hbm_bytes) == (989e12, 67e12, 3.35e12, 900e9, 80e9)
    c = t_replay.replay_step_cost(47_237, 32, 2)
    assert c.t_compute == c.flops / h.peak_flops_f32
    assert c.t_memory == c.hbm_bytes / h.hbm_bw
    assert not hasattr(t_hw, "TPU_V5E")


# --------------------------------------------------------------------------
# the engine, store and online engine under a live tracer
# --------------------------------------------------------------------------

N, D, T, BATCH = 320, 10, 24, 64
# every window of 4 steps holds an approx step, so both packages fetch
# every window: a window of explicit steps only the reference reads row by
# row from the history, and the port fetches (it reads explicit steps'
# rows from their windows too)
DG = dict(period=5, burn_in=2, history_size=2)
# the spans' step args; timings, roofline numbers and host bytes differ by
# construction (another clock, another chip, another storage)
ARGS = ("t0", "t1", "steps", "r", "t", "prefix", "regions", "op", "k", "wid",
        "parent", "ops")
ENGINE_COUNTERS = ("engine.replays", "engine.explicit_steps",
                   "engine.approx_steps", "engine.guard_fallbacks",
                   "engine.grad_examples", "store.windows_fetched",
                   "store.prefetch_hits")


def _p0():
    rng = np.random.default_rng(1)
    return {"w": (0.01 * rng.normal(size=D)).astype(np.float32),
            "b": np.zeros((), np.float32)}


def _trained(pkg, tier):
    if pkg == "jax":
        ds = j_binary(n=N, d=D, seed=0)
        meta = JMeta(n=N, batch_size=BATCH, seed=3, steps=T,
                     lr_schedule=((0, 0.3),))
        obj = j_logreg(5e-3)
        _, hist = jdg.sgd_train_with_cache(
            obj, {k: jnp.asarray(v) for k, v in _p0().items()}, ds, meta,
            tier="device" if tier == "stacked" else tier, window=4)
        return obj, ds, hist
    ds = t_binary(n=N, d=D, seed=0)
    meta = TMeta(n=N, batch_size=BATCH, seed=3, steps=T,
                 lr_schedule=((0, 0.3),))
    obj = logreg_objective(5e-3)
    _, hist = tdg.sgd_train_with_cache(obj, params_from_jax(_p0(), "cpu"), ds,
                                       meta, tier=tier, window=4,
                                       device="cpu")
    return obj, ds, hist


def _traced(pkg, case):
    """Run one case under a fresh tracer (virtual clock) and a fresh
    registry; returns (main-thread events, every event, registry)."""
    metrics_mod, trace_mod = PKGS[pkg]
    tier = "host" if case == "streamed-replay" else "stacked"
    obj, ds, hist = _trained(pkg, tier)
    dgm = jdg if pkg == "jax" else tdg
    cfg = dgm.DeltaGradConfig(stream_window=4, **DG)
    reg = metrics_mod.set_registry(metrics_mod.MetricsRegistry())
    tr = trace_mod.enable(trace_mod.Tracer(clock=_VirtualClock()))
    # enough rows that every batch holds one: the first pairs admit at
    # once, so every window runs an approx segment
    rows = list(range(3, N, 9))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    if case == "online-request":
        eng = (JEngine if pkg == "jax" else TEngine)(obj, hist, ds, cfg, **kw)
        try:
            eng.request_group("delete", rows)
        finally:
            if pkg == "torch":
                eng.close()
    else:
        dgm.deltagrad_retrain(obj, hist, ds, np.asarray(rows), cfg, **kw)
    trace_mod.disable()
    main = threading.get_ident()
    events = tr.events()
    tid_main = tr._tids.get(main)
    return [e for e in events if e["tid"] == tid_main], events, reg


def _keyed(events, prefixes=(), names=()):
    return [(e["name"], {k: e["args"][k] for k in ARGS if k in e["args"]})
            for e in events
            if e["name"].startswith(prefixes) or e["name"] in names]


@pytest.mark.parametrize("case", ["resident-replay", "streamed-replay",
                                  "online-request"])
def test_spans_and_counters_equal_the_reference(case):
    mj, allj, rj = _traced("jax", case)
    mt, allt, rt = _traced("torch", case)
    # replay and online spans: the same names and step args, in order
    want = _keyed(mj, ("replay.", "online."))
    assert _keyed(mt, ("replay.", "online.")) == want
    names = [n for n, _ in want]
    assert "replay.scan" in names and "replay.explicit" in names
    if case == "online-request":
        assert names[-1] == "online.request" and "replay.commit" in names
    else:
        assert names[0] == "replay.schedule_build"
    # the store's window spans: the same windows, from the same segments
    wins = _keyed(mj, names=("store.window",))
    assert _keyed(mt, names=("store.window",)) == wins
    assert bool(wins) == (case == "streamed-replay")
    stores = {e["name"] for e in allt if e["name"].startswith("store.")}
    assert stores == {e["name"] for e in allj if e["name"].startswith("store.")}
    if case == "streamed-replay":
        assert {"store.window", "store.window_stage",
                "store.prefetch_wait"} <= stores
    # every replay span carries its roofline prediction and ratio
    for e in allt:
        if e["name"] in ("replay.scan", "online.request"):
            a = e["args"]
            assert a["pred_s"] > 0 and a["roofline_ratio"] == pytest.approx(
                a["measured_s"] / a["pred_s"])
            # device times come from CUDA events: on the CPU, host time only
            assert "device_s" not in a and "device_roofline_ratio" not in a
    # the counters: the engine's exactly, the store's fetches and hits
    cj = {(s["name"]): s for s in rj.snapshot()}
    ct = {(s["name"]): s for s in rt.snapshot()}
    assert set(ct) == set(cj)
    for name in ENGINE_COUNTERS:
        if name in cj:
            assert ct[name]["value"] == cj[name]["value"], name
    assert ct["engine.approx_steps"]["value"] > 0
    if case == "streamed-replay":
        assert ct["store.windows_fetched"]["value"] == T // 4
        assert "store.host_wait_s" in ct
    assert ct["store.hbm_high_water_bytes"]["value"] > 0


def test_online_warmup_span_and_compile_gauge():
    obj, ds, hist = _trained("torch", "stacked")
    reg = t_metrics.set_registry(MetricsRegistry())
    tr = t_trace.enable(Tracer(clock=_VirtualClock()))
    eng = TEngine(obj, hist, ds, tdg.DeltaGradConfig(**DG), device="cpu")
    assert eng.warmup([("delete", 1), ("delete", 4), ("add", 2)]) == 0.0
    t_trace.disable()
    (ev,) = tr.events()
    assert ev["name"] == "online.warmup" and ev["args"] == {"ops": 3}
    (snap,) = reg.snapshot()
    assert (snap["name"], snap["value"]) == ("online.compile_time_s", 0.0)
