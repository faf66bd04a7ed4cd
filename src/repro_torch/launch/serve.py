"""Serving drivers.

  * ``unlearn`` — the DeltaGrad request server, built on
    ``core.session.UnlearnerSession``: trains with path caching, answers a
    stream of online delete/add requests (one lazy `submit()` per request
    — DISPATCH latency is what the server's queue sees, and is reported
    separately from BLOCKED latency, the device-drained time a
    per-request sync would pay), serves a burst of ``--burst`` deletes
    both serially and COALESCED into one group replay, then drives a
    seeded multi-tenant trace (``--trace poisson|diurnal|fixed``, mixed
    SLA classes) through `repro_torch.serve.ServingScheduler` — admission,
    EDF flush, cross-tenant batching, and the lone-tail deadline tick.
    Summary percentiles include p99; machine-readable results go to
    ``--bench-out`` (no file unless a path is given).  The JAX package's
    ``launch/serve.py unlearn``, flag for flag, plus ``--device`` (the
    card unless ``cpu`` is asked for):

        PYTHONPATH=src python -m repro_torch.launch.serve unlearn \
            --device cpu --n 800 --d 32 --steps 40 --requests 6 --burst 4

    ``--model <name>`` swaps the default logreg problem for a reduced
    registry LM (`UnlearnerSession.from_config`): the dataset becomes a
    synthetic token stream (``--n`` docs of ``--seq-len`` tokens) and the
    reported score is an exp(-loss) proxy instead of accuracy.

    ``--impl`` takes ``scan`` only: the reference's per-step python
    oracle is not ported (ROADMAP.md, queue 1 item 9), so the coalesced
    burst's ``parity_vs_python`` holds the group replay against the port's
    Algorithm 1 replay (`core.deltagrad.deltagrad_retrain`) of the same
    rows on the same cached path, the replay the first group request
    computes.  ``--profile-dir`` captures a `torch.profiler` trace (CPU and,
    on the card, CUDA activity) into that directory.

  * batched decode (the default mode, the reference's flags plus
    ``--device``): prefill a prompt batch by stepping the KV caches, then
    generate greedily (or by ``--temperature`` sampling from a generator
    seeded by ``--seed``):

        PYTHONPATH=src python -m repro_torch.launch.serve --arch \
            internlm2-1.8b --reduced --device cpu --batch 4 \
            --prompt-len 32 --gen 16
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def unlearn_main(argv) -> dict:
    """Stand up the online unlearning service and drive a request stream;
    returns the results dict it writes to ``--bench-out``."""
    from repro_torch.core.deltagrad import DeltaGradConfig, deltagrad_retrain
    from repro_torch.core.engine import _sync, resolve_device
    from repro_torch.core.privacy import PrivacyConfig
    from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
    from repro_torch.data.dataset import Dataset
    from repro_torch.data.synthetic import binary_classification
    from repro_torch.models.simple import (logreg_accuracy, logreg_init,
                                           logreg_objective)

    ap = argparse.ArgumentParser(prog="serve unlearn")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--model", default="",
                    help="configs.registry name — serve a reduced LM "
                         "instead of the default logreg problem "
                         "(UnlearnerSession.from_config); --n becomes the "
                         "document count")
    ap.add_argument("--seq-len", type=int, default=32,
                    help="tokens per synthetic document (with --model)")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--d", type=int, default=500)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--l2", type=float, default=5e-3)
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--period", type=int, default=5)
    ap.add_argument("--burn-in", type=int, default=10)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--add-frac", type=float, default=0.25,
                    help="fraction of requests that are additions")
    ap.add_argument("--impl", default="scan", choices=("scan", "python"),
                    help="replay implementation; only 'scan' is ported")
    ap.add_argument("--algorithm", default="deltagrad",
                    help="registered unlearning algorithm serving the "
                         "stream (core.algorithms registry)")
    ap.add_argument("--eps", type=float, default=1.0,
                    help="certified-deletion epsilon for the published "
                         "model / certificate report")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--burst", type=int, default=8,
                    help="K for the coalesced-vs-serial delete burst")
    ap.add_argument("--trace", default="poisson",
                    choices=("poisson", "diurnal", "fixed"),
                    help="arrival process for the continuous-serving "
                         "section (seeded; 'fixed' is the deterministic "
                         "equal-spacing mode driven by --arrival-ms)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered load in requests/s for poisson/diurnal "
                         "traces (0 derives it from --arrival-ms)")
    ap.add_argument("--arrival-ms", type=float, default=2.0,
                    help="inter-arrival gap for --trace fixed (and the "
                         "rate fallback for the seeded traces)")
    ap.add_argument("--sla-class", default="mixed",
                    choices=("mixed", "interactive", "batch", "bulk_gdpr"),
                    help="SLA class for generated requests ('mixed' draws "
                         "from all three)")
    ap.add_argument("--bench-out", default="",
                    help="machine-readable results path ('' writes none)")
    ap.add_argument("--trace-out", default="",
                    help="enable the span tracer and write a Chrome/"
                         "Perfetto trace-event JSON here ('' disables); "
                         "the metrics registry lands beside it as "
                         "<path>.metrics.jsonl")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace into this "
                         "directory ('' disables) — opt-in, for a kernel-"
                         "level view under the obs spans")
    args = ap.parse_args(argv)
    if args.impl == "python":
        raise NotImplementedError(
            "--impl python: the per-step python replay oracle is not ported "
            "(ROADMAP.md, queue 1 item 9); serve with --impl scan")

    dev = resolve_device(args.device)
    if args.trace_out:
        obs_trace.enable()
    prof = None
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    # the logreg-scale lr/batch defaults destroy a transformer (the
    # L-BFGS correction blows past the guard clip at lr=0.3): when
    # --model is set and the user left them at the logreg defaults,
    # swap in the LM recipe the reference's examples/unlearn_lm.py uses
    if args.model:
        if args.lr == ap.get_default("lr"):
            args.lr = 0.02
        if args.batch == ap.get_default("batch"):
            args.batch = 64

    cfg = UnlearnerConfig(
        steps=args.steps, batch_size=args.batch, lr=args.lr, seed=args.seed,
        momentum=args.momentum, algorithm=args.algorithm,
        privacy=PrivacyConfig(eps=args.eps, mu=0.5, L=1.0, c0=0.1, c2=0.1),
        # non-convex models need the Algorithm-4 curvature guard (the
        # paper's DNN recipe); the convex logreg path keeps it off
        deltagrad=DeltaGradConfig(period=args.period, burn_in=args.burn_in,
                                  guard=bool(args.model),
                                  curvature_eps=1e-8 if args.model else 0.0))

    # the reference's CI-sized LM reduction; the serve surface downstream
    # is model-agnostic
    lm_reduced = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab=128, d_head=16)
    obj = None if args.model else logreg_objective(l2=args.l2)
    # every session serves the same seeded data: generate it once, and
    # give each session its own Dataset over the shared arrays (append
    # builds new arrays, so no session sees another's rows)
    if args.model:
        from repro_torch.data.synthetic import token_stream
        base_cols = token_stream(n_docs=args.n, seq_len=args.seq_len,
                                 vocab=lm_reduced["vocab"],
                                 seed=args.seed).columns
    else:
        base_cols = binary_classification(n=args.n, d=args.d,
                                          seed=args.seed).columns

    def build_session(config=cfg):
        ds = Dataset(dict(base_cols))
        if args.model:
            sess = UnlearnerSession.from_config(
                args.model, ds, reduced=lm_reduced, config=config,
                loss_chunk=args.seq_len, device=dev)
        else:
            p0 = logreg_init(args.d,
                             generator=torch.Generator().manual_seed(1),
                             device=dev)
            sess = UnlearnerSession(obj, p0, ds, config, device=dev)
        sess.fit()
        return sess, ds

    def score(sess, params, ds) -> float:
        """Accuracy for logreg; an exp(-token-CE) proxy for an LM."""
        if not args.model:
            return float(logreg_accuracy(params, ds))
        toks = torch.from_numpy(np.asarray(ds.columns["tokens"][:64])).to(dev)
        with torch.no_grad():
            loss = sess.model.loss_fn(params, {"tokens": toks}, remat=False,
                                      loss_chunk=args.seq_len)
        return float(torch.exp(-loss))

    t0 = time.perf_counter()
    sess, ds = build_session()
    _sync(dev)
    what = "model=" + args.model if args.model else "d=%d" % args.d
    print(f"trained {args.steps} steps (n={ds.n}, {what}) "
          f"with path cache in {time.perf_counter() - t0:.2f}s; "
          f"score {score(sess, sess.params, ds):.4f}")

    # additions are served from a pre-appended row pool; staging the
    # expected count keeps the engine's pow2-bucketed row capacity (the
    # reference's) from re-bucketing mid-stream
    rng = np.random.default_rng(args.seed + 1)
    pool_src = rng.integers(0, args.n, size=args.requests)
    add_pool = list(ds.append({k: v[pool_src] for k, v in ds.columns.items()}))
    algo = sess.algorithm
    algo.begin_plan(args.requests)

    warm = [("delete", 1)] + ([("add", 1)] if args.add_frac > 0 else [])
    compile_s = sess.warmup(warm)
    print(f"session up (algorithm={algo.name}); first-request compile "
          f"{compile_s * 1e3:.0f} ms")

    # -- latency loop: dispatch (what the request queue sees) vs blocked
    # (dispatch + device drain), each from the shared obs.metrics histogram
    # (the one quantile path ServeMonitor uses too)
    reg = obs_metrics.get_registry()
    reg.gauge("online.compile_time_s", unit="s",
              owner="core.online").set(compile_s)
    h_disp = reg.histogram("launch.dispatch_ms", unit="ms",
                           owner="launch.serve")
    h_block = reg.histogram("launch.blocked_ms", unit="ms",
                            owner="launch.serve")
    for i in range(args.requests):
        if add_pool and rng.random() < args.add_frac:
            op, row = "add", int(add_pool.pop(0))
        else:
            live = np.flatnonzero(algo.live[:args.n])
            op, row = "delete", int(rng.choice(live))
        t0 = time.perf_counter()
        h = sess.submit(op=op, rows=[row], coalesce=False)
        sess.flush()
        t_disp = time.perf_counter() - t0
        _sync(dev)
        t_block = time.perf_counter() - t0
        h_disp.observe(t_disp * 1e3)
        h_block.observe(t_block * 1e3)
        st = h.stats[0]
        print(f"  request {i:3d} {op:6s} row {row:5d}: dispatch "
              f"{t_disp * 1e3:7.1f} ms, blocked {t_block * 1e3:7.1f} ms  "
              f"(approx {st.approx_steps}, explicit {st.explicit_steps}, "
              f"grad-eval speedup x{st.theoretical_speedup:.1f})")
    dp, bp = h_disp.summary(), h_block.summary()
    print(f"served {args.requests} requests: dispatch p50 {dp['p50']:.1f} / "
          f"p95 {dp['p95']:.1f} / p99 {dp['p99']:.1f} ms, blocked p50 "
          f"{bp['p50']:.1f} / p95 {bp['p95']:.1f} / p99 {bp['p99']:.1f} ms; "
          f"score {score(sess, sess.params, ds):.4f}")

    # -- certified release: the certificate the stream's cumulative
    # deletions buy at --eps (noise from the session's generator)
    published, cert = sess.publish(eps=args.eps)
    print(f"certificate: algorithm={cert.algorithm} "
          f"mechanism={cert.mechanism} eps={cert.eps:g} "
          f"delta={cert.delta:g} bound={cert.bound:.3e} "
          f"noise_scale={cert.noise_scale:.3e} removals={cert.removals}")

    # -- coalesced burst: K deletes as ONE group replay vs the serial path
    K = args.burst
    results = {
        "config": {"n": args.n, "d": args.d, "steps": args.steps,
                   "batch": args.batch, "requests": args.requests,
                   "add_frac": args.add_frac, "impl": args.impl,
                   "momentum": args.momentum, "burst": K,
                   "algorithm": args.algorithm, "eps": args.eps,
                   "trace": args.trace, "sla_class": args.sla_class,
                   "arrival_ms": args.arrival_ms},
        "compile_s": compile_s,
        "latency_ms": {"dispatch": dp, "blocked": bp},
        "accuracy": score(sess, sess.params, ds),
        "certificate": cert.as_dict(),
        "published_accuracy": score(sess, published, ds),
    }
    if args.model:
        results["config"]["model"] = args.model
        results["config"]["seq_len"] = args.seq_len
    del sess, ds, algo, published  # each session holds its device columns
    if K > 0 and args.algorithm == "deltagrad":
        burst_rows = np.random.default_rng(args.seed + 2).choice(
            args.n, size=K, replace=False).tolist()

        sess_a, _ = build_session()          # serial Algorithm-3 stream
        sess_a.warmup([("delete", 1)])
        t0 = time.perf_counter()
        sess_a.stream_delete(burst_rows)
        t_serial = time.perf_counter() - t0

        sess_b, ds_b = build_session()       # ONE coalesced group replay
        sess_b.warmup([("delete", K)])
        # the oracle: Algorithm 1 on the same rows and the same cached
        # path, taken before the group request rewrites the path
        w_oracle, _ = deltagrad_retrain(sess_b.objective, sess_b.history,
                                        ds_b, burst_rows, cfg.deltagrad,
                                        device=dev)
        t0 = time.perf_counter()
        hb = sess_b.delete(burst_rows)
        w_b = hb.params  # forces the handle and synchronises
        t_coal = time.perf_counter() - t0

        parity = float((w_b.flat - w_oracle.flat).norm())
        drift = float((w_b.flat - sess_a.params.flat).norm())
        results["coalesce"] = {
            "k": K,
            "serial_ms_per_req": t_serial / K * 1e3,
            "coalesced_ms_per_req": t_coal / K * 1e3,
            "per_request_speedup": t_serial / max(t_coal, 1e-9),
            "parity_vs_python": parity,
            "serial_vs_coalesced_dist": drift,
        }
        print(f"burst K={K}: serial {t_serial / K * 1e3:.1f} ms/req, "
              f"coalesced {t_coal / K * 1e3:.1f} ms/req "
              f"(x{t_serial / max(t_coal, 1e-9):.1f}); parity vs Algorithm 1 "
              f"{parity:.2e}; serial-vs-coalesced dist {drift:.2e}")
        del sess_a, sess_b, ds_b, w_oracle, w_b, hb

    # -- continuous serving: a seeded open-loop trace through the serving
    # tier (repro_torch.serve) — admission control, SLA-class deadlines,
    # EDF flush, cross-tenant batching, one replay in flight.  The lone
    # tail request at the end shows the deadline holds with ZERO further
    # arrivals: the executor's idle tick serves it
    if args.requests > 0:
        from repro_torch.serve import (LoadGenerator, ServeConfig,
                                       ServingScheduler, diurnal_trace,
                                       fixed_trace, materialize,
                                       poisson_trace)
        from repro_torch.serve.monitor import ServeMonitor

        sess_f, ds_f = build_session()
        rate = args.rate or (1e3 / args.arrival_ms if args.arrival_ms
                             else 200.0)
        class_mix = ({"interactive": 0.5, "batch": 0.3, "bulk_gdpr": 0.2}
                     if args.sla_class == "mixed" else (args.sla_class,))
        tenants = {"tenant-a": 0.6, "tenant-b": 0.4}
        if args.trace == "poisson":
            events = poisson_trace(rate, args.requests, args.seed + 3,
                                   tenants=tenants, classes=class_mix,
                                   add_frac=args.add_frac)
        elif args.trace == "diurnal":
            events = diurnal_trace(
                max(rate / 2, 1e-3), rate * 2,
                period_s=max(0.25, args.requests / rate),
                n_events=args.requests, seed=args.seed + 3,
                tenants=tenants, classes=class_mix,
                add_frac=args.add_frac)
        else:
            events = fixed_trace((args.arrival_ms or 2.0) / 1e3,
                                 args.requests, args.seed + 3,
                                 tenants=tenants, classes=class_mix,
                                 add_frac=args.add_frac)
        materialize(events, ds_f, seed=args.seed + 4)
        n_add_rows = sum(ev.n_rows for ev in events if ev.op == "add")
        # one serving stack per CLI run — its monitor publishes into the
        # process-wide registry, so --trace-out exports queue and serve
        # metrics beside the engine/store ones
        sched = ServingScheduler(
            sess_f, ServeConfig(add_capacity=max(1, n_add_rows)),
            monitor=ServeMonitor(registry=reg))
        warm = [("delete", k) for k in (1, 2, 4, 8)]
        if n_add_rows:
            warm += [("add", k) for k in (1, 2, 4)]
        sess_f.warmup(warm)
        sched.start()
        res = LoadGenerator(sched).open_loop(events)
        for tk in res.tickets:
            tk.wait(timeout=60.0)
        # lone tail, then silence: only the executor's deadline tick fires
        used = {r for ev in events if ev.rows for r in ev.rows}
        live = np.flatnonzero(sess_f.algorithm.live[:args.n])
        lone_row = next(int(r) for r in live if int(r) not in used)
        lone = sched.submit("delete", rows=[lone_row],
                            sla_class=("interactive"
                                       if args.sla_class == "mixed"
                                       else args.sla_class))
        lone_ok = lone.wait(timeout=10.0)
        sched.stop()
        st = sched.stats()
        results["serving"] = {
            "trace": args.trace,
            "rate_rps": rate,
            "arrival_ms": args.arrival_ms,
            "sla_class": args.sla_class,
            "rejected": res.rejected,
            "lone_request_served": bool(lone_ok),
            "lone_missed_deadline": bool(lone.missed_deadline),
            **st,
        }
        bt = st["batches"]
        miss = st["deadline_misses_total"]
        print(f"serving: {st['admission']['admitted']} admitted "
              f"({res.rejected} rejected), {bt['count']} batches "
              f"(mean {bt['size_mean']:.1f} rows, {bt['cross_tenant']} "
              f"cross-tenant), {miss} deadline misses, "
              f"{st['add_capacity_retraces']} capacity retraces; lone "
              f"tail served by deadline tick: {lone_ok}")

    if args.bench_out:
        with open(args.bench_out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.bench_out}")

    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "torch_profile.json")
        prof.export_chrome_trace(path)
        print(f"wrote torch profiler trace {path}")
    if args.trace_out:
        tracer = obs_trace.disable()
        tracer.export_chrome(args.trace_out)
        reg.to_jsonl(args.trace_out + ".metrics.jsonl")
        n_scan = sum(1 for e in tracer.events()
                     if e["name"] == "replay.scan")
        print(f"wrote {args.trace_out} ({len(tracer.events())} spans, "
              f"{n_scan} replay.scan) + {args.trace_out}.metrics.jsonl")
    return results


def generate(model, params, prompt: np.ndarray, gen: int, *,
             temperature: float = 0.0, seed: int = 0, device=None,
             caches=None) -> dict:
    """Prefill `prompt` (B, P) by stepping fresh KV caches (or `caches`,
    made by the caller for P + gen tokens: an encoder-decoder's with its
    cross K/V filled, `models.encdec.fill_cross_caches`), then generate
    `gen` tokens: greedy, or sampled at `temperature` from a generator on
    the device seeded by `seed`.  `params` may be bf16 already
    (`transformer.decode_step` casts float32 leaves only).  Returns
    ``tokens`` (B, gen) and ``margins`` (each step's top-2 logit margin)
    as numpy, ``prompt_logits`` (the logits after the last prompt token),
    and ``prefill_s``/``gen_s`` (host clock, each ending in a sync).  The
    one host sync per generated token is the token's fetch, as in the
    reference."""
    from repro_torch.core.engine import _sync
    from repro_torch.train.loop import make_serve_step

    dev = torch.device(device)
    batch, prompt_len = prompt.shape
    if caches is None:
        caches = model.cache_init(batch, prompt_len + gen, device=dev)
    decode = make_serve_step(model.decode_fn)
    prompt_dev = torch.from_numpy(prompt).to(dev)

    # prefill by stepping, as the reference's driver does (`prefill` is
    # the model's full-sequence pass)
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, caches = decode(params, {"tokens": prompt_dev[:, t:t + 1]},
                                caches)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prompt_logits = logits

    generator = torch.Generator(device=dev).manual_seed(seed)
    out_tokens, margins = [], []
    t0 = time.perf_counter()
    for _ in range(gen):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)
        else:
            nxt = torch.argmax(logits, dim=-1, keepdim=True)
        top2 = torch.topk(logits, 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        nxt = nxt.to(torch.int32)
        out_tokens.append(nxt.cpu().numpy())
        logits, caches = decode(params, {"tokens": nxt}, caches)
    _sync(dev)
    t_gen = time.perf_counter() - t0
    return {"tokens": (np.concatenate(out_tokens, axis=1) if out_tokens
                       else np.zeros((batch, 0), np.int32)),
            "margins": (torch.stack(margins, dim=1).cpu().numpy() if margins
                        else np.zeros((batch, 0), np.float32)),
            "prompt_logits": prompt_logits, "prefill_s": t_prefill,
            "gen_s": t_gen}


def decode_main(argv=None) -> dict:
    """Batched decode on random weights from ``--seed``; prints the
    reference's two lines and returns `generate`'s results with the
    ``prompt``, the bf16 ``params`` it decoded with, ``tok_s`` and
    ``ms_per_token``.

    The f32 master weights are cast to bf16 once, before the loop:
    `transformer.decode_step` casts float32 leaves on every call and uses
    bf16 ones as they are, so the logits are the same, and the f32 tree is
    freed.  An encoder-decoder decodes, as the reference's CLI does,
    against 64 cross K/V slots of zeros: no frames are encoded."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import resolve_device
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import cast_params
    from repro_torch.utils.tree import nested

    ap = argparse.ArgumentParser(prog="serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device to decode on (default: the card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    params = cast_params(nested(model.init(args.seed, device=dev)),
                         torch.bfloat16)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len),
                          dtype=np.int32)
    caches = None
    if cfg.family == "audio":
        caches = model.cache_init(args.batch, args.prompt_len + args.gen,
                                  enc_len=64, device=dev)
    res = generate(model, params, prompt, args.gen,
                   temperature=args.temperature, seed=args.seed, device=dev,
                   caches=caches)
    tok_s = args.batch * args.gen / max(res["gen_s"], 1e-9)
    print(f"prefill {args.prompt_len} tok x {args.batch} in "
          f"{res['prefill_s']:.2f}s; generated {args.gen} tok x {args.batch} "
          f"in {res['gen_s']:.2f}s ({tok_s:.1f} tok/s)")
    print("sample row 0:", res["tokens"][0].tolist())
    return {**res, "prompt": prompt, "params": params, "tok_s": tok_s,
            "ms_per_token": res["gen_s"] * 1e3 / max(args.gen, 1)}


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "unlearn":
        unlearn_main(sys.argv[2:])
    else:
        decode_main(sys.argv[1:])


if __name__ == "__main__":
    main()
