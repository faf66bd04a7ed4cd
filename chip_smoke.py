#!/usr/bin/env python3
"""Drive the PyTorch port of DeltaGrad on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card and
nvcc.  The first run builds the kernels from ``src/repro_torch/csrc`` into
``src/repro_torch/_build``.  Phases:

  1. environment: the card, its power limit, versions, the kernels' build;
  2. each CUDA kernel against its plain PyTorch version on the card, in f32
     and bf16, at the main path's shapes and a ragged one;
  3. each kernel's time on the card beside its bound, its plain version's
     and the matching PyTorch library call's;
  4. the main path (train -> BaseL -> DeltaGrad replay) on the paper MLP
     at full width (p = 238,510), n = 60,000, T = 40, r = 60, with the
     kernels' launch counts of that run, and the add-mode replay;
  5. determinism: every repeated replay gives bitwise the same
     parameters; the spread of BaseL's and the replay's times;
  6. parity: the card's replay against the port's CPU run at a small size;
  7. a profile of the replay: the device's busy share, launches, top ops.

It prints one JSON line of per-kernel results, then the card's name and
power limit, and as its last line the JSON result.  It exits non-zero,
printing no result, when a phase fails or no card is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the tensor
# cores (the kernels do f32 FMAs), dense, at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

MAIN = dict(n=60_000, steps=40, r=60, seed=0)
PARITY = dict(n=1200, d=20, hidden=32, classes=4, steps=24, r=12)
PARITY_TOL = 1e-5
REPEATS = 5  # timed BaseL / replay runs at full width
FAILURES: list = []


def fail(msg: str) -> None:
    FAILURES.append(msg)
    print(f"FAIL: {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fn, calls: int = 50, replays: int = 20) -> float:
    """Device time of one fn() in ms: `calls` calls captured in a CUDA graph
    and replayed, timed with CUDA events, so host launch overhead is out."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def eager_ms(torch, fn, calls: int = 200) -> float:
    """Wall time of one eager call in ms (host launch cost included)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def bound_ms(nbytes: float, flops: float):
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.configs.paper_mlp import CONFIG
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.history import HistoryMeta
    from repro_torch.data.synthetic import multiclass_classification
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_update.ops import update
    from repro_torch.kernels.fused_update.ref import deltagrad_update_ref
    from repro_torch.kernels.lbfgs.ops import multidot, rank_update
    from repro_torch.kernels.lbfgs.ref import multidot_ref, rank_update_ref
    from repro_torch.models.simple import (mlp_accuracy, mlp_init,
                                           mlp_objective, params_from_jax)

    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # -- 1. environment and build ---------------------------------------------
    print(f"device: {kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    build_s = _build.build_all()
    print(f"build: {build_s:.2f} s for {', '.join(_build.sources())} "
          "(nvcc, sm_90a, one process per source)", flush=True)
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    kernels = {
        "fused_update": dict(wrapper=update, source="src/repro_torch/csrc/fused_update.cu",
                             replaces="src/repro/kernels/fused_update/kernel.py:33"),
        "multidot": dict(wrapper=multidot, source="src/repro_torch/csrc/lbfgs.cu",
                         replaces="src/repro/kernels/lbfgs/kernel.py:55"),
        "rank_update": dict(wrapper=rank_update, source="src/repro_torch/csrc/lbfgs.cu",
                            replaces="src/repro/kernels/lbfgs/kernel.py:103"),
    }
    for k in kernels.values():
        k["max_abs_err"] = 0.0

    # -- 2. each kernel against its plain version ------------------------------
    gen = torch.Generator(device=dev).manual_seed(1234)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        dname = "f32" if dtype == torch.float32 else "bf16"
        for m, p in ((2, 238_510), (8, 238_510), (3, 100_003)):
            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device=dev).to(dtype)

            dW, dG, v, w, g, gc = rnd(m, p), rnd(m, p), rnd(p), rnd(p), rnd(p), rnd(p)
            a = torch.randn(m, generator=gen, device=dev)
            b = torch.randn(m, generator=gen, device=dev)
            sigma = torch.rand((), generator=gen, device=dev)
            main_shape = dtype == torch.float32 and (m, p) == (2, 238_510)

            got = update(w, g, v, gc, 0.1, 60000.0, 37.0, 1.0)
            ref = deltagrad_update_ref(w, g, v, gc, 0.1, 60000.0, 37.0, 1.0)
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            print(f"check fused_update {dname} p={p}: rel_err={rel:.3e} "
                  f"abs_err={err:.3e} tol={tol}")
            if not rel <= tol:
                fail(f"fused_update {dname} p={p} rel_err {rel:.3e} > {tol}")
            if main_shape:
                kernels["fused_update"]["max_abs_err"] = err

            sums = multidot(dW, dG, v)
            plain = multidot_ref(dW, dG, v)
            w64, g64, v64 = dW.double(), dG.double(), v.double()
            exact = (w64 @ w64.T, w64 @ g64.T, w64 @ v64, g64 @ v64)
            scale = (w64.abs() @ w64.abs().T, w64.abs() @ g64.abs().T,
                     w64.abs() @ v64.abs(), g64.abs() @ v64.abs())
            per_entry = max(((s.double() - e).abs() / c).max().item()
                            for s, e, c in zip(sums, exact, scale))
            err = max((s - q).abs().max().item() for s, q in zip(sums, plain))
            print(f"check multidot {dname} m={m} p={p}: per-entry "
                  f"|err|/sum|a*b| vs f64 = {per_entry:.3e} tol=1e-06; "
                  f"abs_err vs plain = {err:.3e}")
            if not per_entry <= 1e-6:
                fail(f"multidot {dname} m={m} p={p} per-entry {per_entry:.3e}")
            if main_shape:
                kernels["multidot"]["max_abs_err"] = err
            again = multidot(dW, dG, v)
            if not all(torch.equal(x, y) for x, y in zip(sums, again)):
                fail(f"multidot {dname} m={m} p={p} differs between two calls")

            got = rank_update(dW, dG, v, a, b, sigma)
            ref = rank_update_ref(dW, dG, v, a, b, sigma)
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            print(f"check rank_update {dname} m={m} p={p}: rel_err={rel:.3e} "
                  f"abs_err={err:.3e} tol={tol}")
            if not rel <= tol:
                fail(f"rank_update {dname} m={m} p={p} rel_err {rel:.3e} > {tol}")
            if main_shape:
                kernels["rank_update"]["max_abs_err"] = err
    torch.cuda.synchronize()

    # -- 3. time each kernel at the main path's shape (m = 2, f32) ----------------
    m, p = 2, CONFIG.n_params
    dW, dG = (torch.randn(m, p, generator=gen, device=dev) for _ in range(2))
    v, w, g, gc = (torch.randn(p, generator=gen, device=dev) for _ in range(4))
    a, b = torch.randn(m, device=dev), torch.randn(m, device=dev)
    sigma = torch.tensor(0.5, device=dev)
    X = torch.cat([dW, dG])
    Y = torch.cat([dW, dG, v[None]])
    coef = torch.cat([a, b])
    es = 4
    n_terms = m * (m + 1) // 2 + m * m + 2 * m
    timing = {
        "fused_update": dict(
            fn=lambda: update(w, g, v, gc, 0.1, 60000.0, 37.0, 1.0),
            plain=lambda: deltagrad_update_ref(w, g, v, gc, 0.1, 60000.0, 37.0, 1.0),
            library=None, nbytes=5 * p * es, flops=7 * p),
        "multidot": dict(
            fn=lambda: multidot(dW, dG, v),
            plain=lambda: multidot_ref(dW, dG, v),
            library=lambda: torch.mm(X, Y.T),
            nbytes=(2 * m + 1) * p * es + (2 * m * m + 2 * m) * 4,
            flops=2 * n_terms * p),
        "rank_update": dict(
            fn=lambda: rank_update(dW, dG, v, a, b, sigma),
            plain=lambda: rank_update_ref(dW, dG, v, a, b, sigma),
            library=lambda: torch.addmv(v, X.T, coef, beta=0.5, alpha=-1.0),
            nbytes=(2 * m + 1) * p * es + (2 * m + 1) * 4 + p * es,
            flops=(4 * m + 1) * p),
    }
    for name, t in timing.items():
        k = kernels[name]
        k["ms"] = graph_ms(torch, t["fn"])
        k["plain_ms"] = graph_ms(torch, t["plain"])
        k["library_ms"] = graph_ms(torch, t["library"]) if t["library"] else None
        k["bound_ms"], k["bound_by"] = bound_ms(t["nbytes"], t["flops"])
        k["eager_call_ms"] = eager_ms(torch, t["fn"])
        print(f"time {name} m={m} p={p} f32 (CUDA graph, L2-warm): "
              f"kernel_ms={k['ms']:.5f} plain_ms={k['plain_ms']:.5f} "
              f"library_ms={k['library_ms']} bound_ms={k['bound_ms']:.5f} "
              f"({k['bound_by']}) eager_call_ms={k['eager_call_ms']:.5f}",
              flush=True)

    # -- 4. the main path at full width ---------------------------------------
    obj = mlp_objective(l2=CONFIG.l2)
    ds = multiclass_classification(MAIN["n"], CONFIG.d_in, CONFIG.vocab,
                                   seed=MAIN["seed"])
    params0 = mlp_init(CONFIG.d_in, CONFIG.d_model, CONFIG.vocab,
                       generator=torch.Generator().manual_seed(MAIN["seed"]),
                       device=dev)
    T = MAIN["steps"]
    meta = HistoryMeta(n=ds.n, batch_size=ds.n, seed=MAIN["seed"], steps=T,
                       lr_schedule=CONFIG.lr_schedule)
    cfg = dg.DeltaGradConfig(period=CONFIG.period, burn_in=CONFIG.burn_in(T),
                             history_size=CONFIG.history_size,
                             guard=CONFIG.guard,
                             curvature_eps=CONFIG.curvature_eps)
    removed = np.random.default_rng(MAIN["seed"] + 1).choice(
        ds.n, size=MAIN["r"], replace=False)
    # warm-up, counted as set-up: cuBLAS and the solver's first calls, the
    # dataset's upload, every kernel's first launch
    warm_meta = HistoryMeta(n=ds.n, batch_size=ds.n, seed=0, steps=6,
                            lr_schedule=CONFIG.lr_schedule)
    _, warm_hist = dg.sgd_train_with_cache(obj, params0, ds, warm_meta)
    dg.baseline_retrain(obj, ds, warm_meta, params0, removed)
    dg.deltagrad_retrain(obj, warm_hist, ds, removed, dg.DeltaGradConfig(
        period=2, burn_in=1, history_size=2, guard=True, curvature_eps=1e-8))

    for k in kernels.values():
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    w_star, hist = dg.sgd_train_with_cache(obj, params0, ds, meta)
    train_s = time.perf_counter() - t0
    w_u, st_u = dg.baseline_retrain(obj, ds, meta, params0, removed)
    w_i, st = dg.deltagrad_retrain(obj, hist, ds, removed, cfg)
    launches = {n: k["wrapper"].launches for n, k in kernels.items()}
    for n, k in kernels.items():
        k["launches"] = launches[n]

    d_ui = (w_u.flat - w_i.flat).norm().item()
    d_us = (w_u.flat - w_star.flat).norm().item()
    print(f"full: paper-mlp p={w_i.numel} n={ds.n} T={T} r={MAIN['r']} "
          f"history {hist.nbytes() / 1e6:.1f} MB")
    print(f"full: train_s={train_s:.4f} baseline_s={st_u.wall_time_s:.4f} "
          f"replay_s={st.wall_time_s:.4f}")
    print(f"full: {' '.join(f'{k}={v}' for k, v in st.counters().items())} "
          f"theoretical_speedup={st.theoretical_speedup:.3f}")
    print(f"full: d_ui={d_ui:.4e} d_us={d_us:.4e} accuracy w*="
          f"{mlp_accuracy(w_star, ds):.4f} w_I={mlp_accuracy(w_i, ds):.4f}")
    print(f"full: launches {json.dumps(launches)}", flush=True)
    if not (w_i.flat.shape == (CONFIG.n_params,)
            and bool(torch.isfinite(w_i.flat).all())):
        fail("replay parameters are not finite of the expected shape")
    if not d_ui < 0.5 * d_us:
        fail(f"d_ui {d_ui:.3e} not below half of d_us {d_us:.3e}")
    for n, c in launches.items():
        if c <= 0:
            fail(f"{n} was not launched on the main path")
        elif st.guard_fallbacks == 0 and c != st.approx_steps:
            fail(f"{n}: {c} launches, {st.approx_steps} approx steps")

    n_add = MAIN["r"]
    ds_add = multiclass_classification(MAIN["n"], CONFIG.d_in, CONFIG.vocab,
                                       seed=MAIN["seed"])
    added = ds_add.append({k: c[removed] for k, c in ds_add.columns.items()})
    w_ua, _ = dg.baseline_retrain(obj, ds_add, meta, params0, added, mode="add")
    w_ia, st_a = dg.deltagrad_retrain(obj, hist, ds_add, added, cfg, mode="add")
    d_ui_a = (w_ua.flat - w_ia.flat).norm().item()
    d_us_a = (w_ua.flat - w_star.flat).norm().item()
    print(f"add: r={n_add} {' '.join(f'{k}={v}' for k, v in st_a.counters().items())} "
          f"replay_s={st_a.wall_time_s:.4f} d_ui={d_ui_a:.4e} d_us={d_us_a:.4e}")
    if not d_ui_a < 0.5 * d_us_a:
        fail(f"add: d_ui {d_ui_a:.3e} not below half of d_us {d_us_a:.3e}")

    # -- 5. determinism, and the spread of the end-to-end times ----------------
    base_s, replay_s = [st_u.wall_time_s], [st.wall_time_s]
    worst = 0.0
    for _ in range(REPEATS - 1):  # BaseL and replay in turns
        base_s.append(dg.baseline_retrain(obj, ds, meta, params0, removed)[1]
                      .wall_time_s)
        w_i2, st2 = dg.deltagrad_retrain(obj, hist, ds, removed, cfg)
        replay_s.append(st2.wall_time_s)
        worst = max(worst, (w_i2.flat - w_i.flat).abs().max().item())
        if st2.counters() != st.counters():
            fail("a repeated replay counted differently")
    print(f"determinism: {REPEATS - 1} more replays, max |diff| to the first "
          f"= {worst}")
    if worst != 0.0:
        fail(f"repeated replays differ by {worst}")
    for name, xs in (("baseline_s", base_s), ("replay_s", replay_s)):
        print(f"repeat: {name} median={statistics.median(xs):.4f} "
              f"min={min(xs):.4f} max={max(xs):.4f} n={len(xs)} "
              f"all={[round(x, 4) for x in xs]}")

    # -- 6. parity: card against the port's CPU run --------------------------
    rng = np.random.default_rng(6)
    P = PARITY
    p0 = {"w1": (rng.normal(size=(P["d"], P["hidden"])) / np.sqrt(P["d"])).astype(np.float32),
          "b1": np.zeros(P["hidden"], np.float32),
          "w2": (rng.normal(size=(P["hidden"], P["classes"])) / np.sqrt(P["hidden"])).astype(np.float32),
          "b2": np.zeros(P["classes"], np.float32)}
    for mode in ("delete", "add"):
        res = {}
        for where in ("cuda", "cpu"):
            dsp = multiclass_classification(P["n"], P["d"], P["classes"], seed=5)
            ch = np.random.default_rng(2).choice(P["n"], size=P["r"], replace=False)
            if mode == "add":
                ch = dsp.append({k: c[ch] for k, c in dsp.columns.items()})
            mp = HistoryMeta(n=P["n"], batch_size=P["n"], seed=7, steps=P["steps"],
                             lr_schedule=CONFIG.lr_schedule)
            cp = dg.DeltaGradConfig(period=2, burn_in=P["steps"] // 4,
                                    history_size=2, guard=True,
                                    curvature_eps=1e-8)
            init = params_from_jax(p0, where)
            _, hp = dg.sgd_train_with_cache(obj, init, dsp, mp, device=where)
            wp, sp = dg.deltagrad_retrain(obj, hp, dsp, ch, cp, mode=mode,
                                          device=where)
            res[where] = (wp.flat.cpu(), sp.counters())
        gap = (res["cuda"][0] - res["cpu"][0]).abs().max().item()
        same = res["cuda"][1] == res["cpu"][1]
        print(f"parity {mode}: card vs cpu params max |gap| {gap:.3e} "
              f"(tol {PARITY_TOL}); counters "
              + " ".join(f"{k}={res['cuda'][1][k]}/{res['cpu'][1][k]}"
                         for k in res["cpu"][1]))
        if not (gap <= PARITY_TOL and same):
            fail(f"parity {mode}: gap {gap:.3e}, counters equal: {same}")

    # -- 7. profile of one replay ------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dg.deltagrad_retrain(obj, hist, ds, removed, cfg)
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end_us = 0.0, float("-inf")  # union of the device's busy spans
    for a, b in spans:
        if b > end_us:
            busy_us += b - max(a, end_us)
            end_us = b
    rows = prof.key_averages()
    launches_host = sum(e.count for e in rows if e.key == "cudaLaunchKernel")
    if busy_us > 0:
        print(f"profile replay: wall_ms={wall_ms:.3f} (under the profiler) "
              f"device_busy_ms={busy_us / 1e3:.3f} "
              f"busy_share={busy_us / 1e3 / wall_ms:.3f} "
              f"device_ops={len(spans)} cudaLaunchKernel={launches_host}")
        dev_rows = [e for e in rows if e.device_type == DeviceType.CUDA]
        for e in sorted(dev_rows, key=lambda e: e.self_device_time_total,
                        reverse=True)[:12]:
            print(f"profile replay: device {e.self_device_time_total / 1e3:9.3f} "
                  f"ms x{e.count:<5d} {e.key[:70]}")
    else:
        print("profile replay: the profiler recorded no device time "
              "(busy share not measured)")

    # -- 8. results ----------------------------------------------------------------
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failure(s)", file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [dict(name=n, route="cuda",
                             **{k: v[k] for k in keys if k != "route"})
                        for n, v in kernels.items()]}
    print(json.dumps(line))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
