"""Observability: span tracing and the shared metrics registry.

The JAX package's `obs`, for the port: the same names, the same args and
the same exported text, so a trace or a metrics file of either package
reads the same way.

  * `obs.trace`   — thread-safe monotonic span tracer with Chrome/Perfetto
                    trace-event export; near-zero cost while disabled.
  * `obs.metrics` — counters / gauges / fixed-bucket histograms in one
                    registry, with JSONL and Prometheus-text exporters.

Enable tracing with ``repro_torch.obs.trace.enable()`` (the serve CLI's
``--trace-out`` flag does this and exports the trace); metrics publish
unconditionally — read them with
``repro_torch.obs.metrics.get_registry().snapshot()`` or either exporter.

A span measures HOST time, as in the reference.  On the card a span that
ends before the kernels it launched have finished (``replay.scan``: the
approx segment dispatches its launches and returns) reads dispatch time;
the spans that end in a synchronisation (``serve.batch``: the executor
syncs once per batch) read device time.  No span adds a synchronisation.

SPAN CONTRACT — every span name, where it is emitted, and its args:

    span                    owner module        args
    ----------------------- ------------------- ---------------------------
    replay.schedule_build   core.engine         steps, r
    replay.scan             core.engine         t0, t1, pred_s, measured_s,
                                                roofline_ratio
    replay.explicit         core.engine         t0, steps
    replay.guard_retry      core.engine         t, prefix
    replay.commit           core.engine         regions
    online.warmup           core.online         ops
    online.request          core.online         op, k, pred_s, measured_s,
                                                roofline_ratio
    store.window_stage      core.store          wid  (staging-pool thread)
    store.prefetch_wait     core.store          wid
    store.window            core.store          wid, hit
    serve.admit             serve.scheduler     op, tenant, cls
    serve.batch             serve.executor      size, op

    ``pred_s`` is the roofline-predicted span cost attached by
    `repro_torch.roofline.replay` (H100 SXM5 peaks); the tracer stamps
    ``measured_s`` and ``roofline_ratio`` (measured / predicted) on span
    exit, so every replay span in a trace carries predicted-vs-measured
    cost.

METRIC CONTRACT — every metric name, its type/unit, and the owner that
publishes it:

    metric                       type       unit  owner
    ---------------------------- ---------- ----- ---------------------
    engine.replays               counter    1     core.engine
    engine.explicit_steps        counter    1     core.engine
    engine.approx_steps          counter    1     core.engine
    engine.guard_fallbacks       counter    1     core.engine
    engine.grad_examples         counter    1     core.engine
    online.compile_time_s        gauge      s     core.online
    store.hbm_high_water_bytes   gauge      B     core.store
    store.windows_fetched        counter    1     core.store
    store.prefetch_hits          counter    1     core.store
    store.host_wait_s            counter    s     core.store
    queue.admitted               counter    1     serve.queue
    queue.rejected_depth         counter    1     serve.queue
    queue.rejected_tenant        counter    1     serve.queue
    queue.rejected_add_capacity  counter    1     serve.queue
    queue.blocked_admissions     counter    1     serve.queue
    serve.dispatch_ms{class}     histogram  ms    serve.monitor
    serve.e2e_ms{class}          histogram  ms    serve.monitor
    serve.queue_depth            histogram  1     serve.monitor
    serve.batch_size             histogram  1     serve.monitor
    serve.served{class}          counter    1     serve.monitor
    serve.failed{class}          counter    1     serve.monitor
    serve.deadline_misses{class} counter    1     serve.monitor
    serve.add_capacity_retraces  counter    1     serve.monitor
    launch.dispatch_ms           histogram  ms    launch.serve
    launch.blocked_ms            histogram  ms    launch.serve

    ``online.compile_time_s`` reads 0.0: eager PyTorch compiles no
    request program (the reference records its XLA compile time there).
    `ServeMonitor` keeps one PRIVATE registry per instance by default —
    pass ``registry=get_registry()`` to publish a single serving stack
    into the process-wide surface, as the serve CLI does.
"""

from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, get_registry,
                                     read_jsonl, set_registry)
from repro_torch.obs.trace import (Span, Tracer, disable, enable, enabled,
                                   get_tracer, span)

__all__ = [
    "metrics", "trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "set_registry", "read_jsonl",
    "Span", "Tracer", "span", "enable", "disable", "enabled", "get_tracer",
]
