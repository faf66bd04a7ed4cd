"""The DeltaGrad engine: training with a cached path, BaseL, and the replay.

Mapping to Wu et al., ICML 2020 (and to the JAX package's `core.engine`):

  SCHEDULE  `data.sampler.build_schedule` precomputes the replay plan
            ((T, B) batch indices, overlap masks, learning rates) on the
            host; `to_device` uploads it once.  Every per-step scalar the
            host needs (kept, dB, lr) is read from the numpy plan, so a
            step's control flow costs no device sync.
  RECORD    `run_training`: Algorithm 1's original GD/SGD run, writing
            (w_t, g_t) into two preallocated (T, p) device buffers, the
            `TrainingHistory`; on the host and disk tiers one window of
            steps at a time, each row encoded on the device and its codes
            copied to the host, so the device never holds more than a
            window.
  BASEL     `run_baseline`: exact retraining on the changed data.
  REPLAY    `run_replay`: explicit steps (t <= j0, every T0, and whenever
            the L-BFGS buffer is empty) are host-driven because they admit
            pairs under the Algorithm-4 curvature check: one sync of two
            inner products per explicit step.  Every run of approx steps
            between two explicit steps is one segment, a Python loop on the
            device with no sync inside: the changed-rows gradient, B v from
            the `kernels.lbfgs` pair (multidot -> compact solve ->
            rank_update), and the `kernels.fused_update` step.  With the
            guard on, the segment's flags are read once at its end; a
            segment with a failing step is re-run up to that step, which
            then runs as an explicit step.  The history is read through a
            `core.store.HistoryStore`: resident, or streamed in windows (a
            segment then also splits at window ends).  An ENCODED window
            (a lossy codec in kernel mode) feeds the approx step through
            `kernels.dequant_update`: dequant_sub gives v = w - w_t and
            dequant_update the step, each decoding its row in registers.
  MOMENTUM  heavy-ball histories (``meta.momentum``): vel <- mom vel + g,
            w <- w - lr vel, in training, BaseL and the replay, with the
            velocity rebuilt from vel_0 = 0 (the cache stores plain
            gradients).  The momentum approx step is plain tensor math, as
            in the reference; its B v still runs the `kernels.lbfgs` pair.
  ONLINE    `run_online_request`: Algorithm 3 (Appendix C.2), one delete or
            add request (a row or a group of rows) against the current
            cached path, which it rewrites: explicit steps w_t <- w^I_t,
            g_t <- the exact post-request gradient; approx steps g_t <- the
            approximated gradient (eq. (S62)).  The L-BFGS pairs live in a
            zeros-initialised (m, p) device ring from step 0: every explicit
            step appends its pair where the admission check passes
            (`_ring_append`, on the device), and approx steps solve over
            the occupied slots (`core.lbfgs.compact_coeffs_masked`), so a
            request reads no scalar back per explicit step (guard off).
            An SGD approx step runs `kernels.fused_update` (on an encoded
            window `kernels.dequant_update`) in its estimate form: one pass
            writes both the rewritten g_t and the step taken with it.
            Rewrites are kept until the request ends and land in one
            `store.commit` (each step reads only its original row).
  MESH      on a store placed on a mesh (`core.store.PlacementPolicy`:
            every rank of the default process group runs the same call),
            each rank takes the gradients of its part of every batch,
            summed over the data axis (`core.store.make_psum_grad_fn`),
            reads w_t and g_t through the per-step gather of the packed
            shards (`core.store.ShardedReplay`), and runs the L-BFGS
            kernels on the replicated pairs; the replay's SGD approx step
            launches `kernels.fused_update` on the rank's tile of the data
            axis and all-gathers the tiles, an online request's updates
            the whole vector.  ``stats.extra["mesh"]`` describes the mesh.

Parameters are one flat f32 buffer (`utils.tree.FlatParams`, the order of
jax's ``ravel_pytree``), so each kernel runs once per step over all of p.

Precision: the entry points turn TF32 off for matmuls and cuDNN
(`resolve_device`), because the reference computes in full f32.

Observability (`repro_torch.obs`): the reference's spans at the
reference's places, with its args — ``replay.schedule_build``,
``replay.explicit``, ``replay.scan`` (an approx segment, with its
roofline ``pred_s``), ``replay.guard_retry`` and ``replay.commit`` — and
one finished replay's counters in the metrics registry.  While tracing is
off a span is a shared no-op and the roofline is not computed; no span
synchronises with the card.  A span's own times are the host's (on the
card, dispatch); traced on the card, each ``replay.scan`` also gets its
segment's device time (``device_s``, ``device_roofline_ratio``) from two
CUDA events around it, read at the replay's end-of-replay sync.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.history import HistoryMeta, TrainingHistory
from repro_torch.core.lbfgs import LbfgsBuffer, ring_valid_mask
from repro_torch.core.store import (EncodedWindow, HistoryStore,
                                   SegmentStreamer, _row, auto_window,
                                   make_psum_grad_fn)
from repro_torch.data.dataset import Dataset
from repro_torch.data.sampler import (ReplaySchedule, batch_indices_all,
                                      build_schedule)
from repro_torch.kernels.dequant_update.ops import (dequant_sub,
                                                    dequant_update)
from repro_torch.kernels.fused_update.ops import update as fused_update
from repro_torch.kernels.lbfgs.ops import MAX_M, lbfgs_hvp_fused
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.roofline.replay import scan_segment_cost
from repro_torch.utils.tree import (FlatParams, tree_all_finite, tree_norm,
                                    tree_vdot)


def resolve_device(device=None) -> torch.device:
    """None means the card.  Raises when CUDA is asked for and absent.

    Also turns TF32 off for matmuls and cuDNN convolutions (process-wide):
    the reference computes in full f32, and TF32 keeps ~3 decimal digits."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' for the plain PyTorch path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# --------------------------------------------------------------------------
# Config / stats
# --------------------------------------------------------------------------


@dataclass
class DeltaGradConfig:
    period: int = 5  # T0: explicit gradient every T0 steps
    burn_in: int = 10  # j0: initial explicit steps
    history_size: int = 2  # m: L-BFGS memory, 1..8 (the kernels' range)
    curvature_eps: float = 0.0  # pair admission threshold (Alg. 4 guard)
    guard: bool = False  # enable non-convex fallback checks
    guard_norm_clip: float = 1e4  # fallback if ||Bv|| > clip * ||v||
    # width of the changed-row block per step; 0 -> the next power of two
    # of min(r, B), which holds every step's overlap
    removal_pad: int = 0
    # steps per device window when the history lives on an offload tier
    # (served by core.store.SegmentStreamer); 0 -> auto
    stream_window: int = 0
    # streamed-window read path: "kernel" keeps windows ENCODED on the
    # device and the approx steps decode per step, "fetch" decodes each
    # window to f32 on arrival, "auto" -> kernel for every non-f32 codec
    stream_decode: str = "auto"

    def __post_init__(self):
        if not 1 <= self.history_size <= MAX_M:
            raise ValueError(f"history_size must be in 1..{MAX_M} (the L-BFGS "
                             f"kernels' range), got {self.history_size}")
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {self.period}")
        if self.removal_pad < 0:
            raise ValueError(f"removal_pad must be >= 0 (0: automatic), got "
                             f"{self.removal_pad}")

    def is_explicit(self, t: int) -> bool:
        if t <= self.burn_in:
            return True
        return (t - self.burn_in) % self.period == 0


@dataclass
class RetrainStats:
    explicit_steps: int = 0
    approx_steps: int = 0
    guard_fallbacks: int = 0
    skipped_steps: int = 0  # empty effective batch (paper: no update)
    pairs_rejected: int = 0
    grad_examples: int = 0  # per-example gradient evaluations (DeltaGrad)
    grad_examples_baseline: int = 0  # what BaseL would have paid
    wall_time_s: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def theoretical_speedup(self) -> float:
        return self.grad_examples_baseline / max(self.grad_examples, 1)

    def counters(self) -> Dict[str, int]:
        """The seven counters that must equal the reference's."""
        return {k: getattr(self, k) for k in (
            "explicit_steps", "approx_steps", "guard_fallbacks",
            "skipped_steps", "pairs_rejected", "grad_examples",
            "grad_examples_baseline")}


def _scan_pred(n_params: int, steps: int, r: int, m: int,
               momentum: bool) -> Optional[float]:
    """Roofline-predicted cost (seconds) of an approx segment, attached as
    ``pred_s`` to ``replay.scan`` spans.  Returns None (and computes
    nothing) while tracing is off."""
    if not obs_trace.enabled():
        return None
    return scan_segment_cost(n_params, steps, r, m, momentum=momentum).pred_s


def _publish_replay_metrics(stats: RetrainStats, store) -> None:
    """Publish one finished replay's counters into the process-wide
    `repro_torch.obs.metrics` registry (the contract table in `obs`)."""
    reg = obs_metrics.get_registry()
    own = "core.engine"
    reg.counter("engine.replays", owner=own).inc()
    reg.counter("engine.explicit_steps", owner=own).inc(stats.explicit_steps)
    reg.counter("engine.approx_steps", owner=own).inc(stats.approx_steps)
    reg.counter("engine.guard_fallbacks",
                owner=own).inc(stats.guard_fallbacks)
    reg.counter("engine.grad_examples", owner=own).inc(stats.grad_examples)
    hw = store.hbm_high_water() if store is not None else 0
    if hw:
        reg.gauge("store.hbm_high_water_bytes", unit="B",
                  owner="core.store").set_max(hw)


# --------------------------------------------------------------------------
# Step plan and device schedule
# --------------------------------------------------------------------------

SKIP, EXPLICIT, APPROX = 0, 1, 2


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def build_plan(cfg: DeltaGradConfig, sched: ReplaySchedule,
               online: bool = False) -> np.ndarray:
    """Per-step codes.  SKIP (an emptied batch under deletion, paper §3)
    takes precedence over the explicit/approx cadence.  A batch replay
    skips every emptied batch; an online request only where the REQUEST
    row sits in a batch whose other rows are all gone (kept == 0 and
    dB > 0), Algorithm 3's condition: other empty batches still run, as
    steps on the l2 term alone."""
    T = sched.steps
    codes = np.full(T, APPROX, dtype=np.int8)
    for t in range(T):
        if cfg.is_explicit(t):
            codes[t] = EXPLICIT
    if sched.mode == "delete":
        empty = sched.kept <= 0
        codes[empty & (sched.dB > 0) if online else empty] = SKIP
    return codes


class DeviceSchedule(NamedTuple):
    """`ReplaySchedule` uploaded to the device once per retraining run."""

    idx: torch.Tensor  # (T, B) int64
    kept_w: torch.Tensor  # (T, B) f32
    changed_idx: torch.Tensor  # (T, R) int64
    changed_w: torch.Tensor  # (T, R) f32


def to_device(sched: ReplaySchedule, device) -> DeviceSchedule:
    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return DeviceSchedule(idx=up(sched.idx), kept_w=up(sched.kept_w),
                          changed_idx=up(sched.changed_idx),
                          changed_w=up(sched.changed_w))


def _gather(cols: Dict[str, torch.Tensor], rows: torch.Tensor):
    return {k: c[rows] for k, c in cols.items()}


# --------------------------------------------------------------------------
# Update math (one definition for training, BaseL, the replay and online)
# --------------------------------------------------------------------------


def _step(w: torch.Tensor, vel: Optional[torch.Tensor], g: torch.Tensor,
          lr: float, mom: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """SGD (``vel`` None) or heavy-ball: vel <- mom vel + g; w <- w - lr vel."""
    if vel is None:
        return w - lr * g, None
    vel = mom * vel + g
    return w - lr * vel, vel


def _approx_math(g_t: torch.Tensor, bv: torch.Tensor, g_changed: torch.Tensor,
                 B: float, dB: float, sign: int) -> torch.Tensor:
    """Paper eq. (2)/(S7): the leave-r-out (add-r) gradient estimate
    (B (g_t + Bv) - sign dB g_c) / max(B - sign dB, 1), as a tensor, for
    the heavy-ball step (the SGD step goes through `kernels.fused_update`,
    which also returns this estimate where the online request needs it)."""
    denom = max(B - sign * dB, 1.0)
    return (B * (g_t + bv) - (sign * dB) * g_changed) / denom


# --------------------------------------------------------------------------
# RECORD: the original training run
# --------------------------------------------------------------------------


def run_training(objective, params0: FlatParams, ds: Dataset,
                 meta: HistoryMeta, device=None, tier: str = "stacked",
                 codec: str = "f32", spill_dir: Optional[str] = None,
                 window: int = 0, spill_window: Optional[int] = None
                 ) -> Tuple[FlatParams, TrainingHistory]:
    """Train w_t by SGD (the paper's optimizer; heavy-ball when
    ``meta.momentum``), caching (w_t, g_t).

    ``stacked``: in two (T, p) f32 buffers on `device`.  ``host`` /
    ``disk``: through `codec`, one window of `window` steps (0: auto) at a
    time; the disk tier writes one .npz per `spill_window` steps (None:
    the window)."""
    dev = resolve_device(device)
    L = auto_window(meta.steps, window)
    if spill_window is None:
        spill_window = L if tier == "disk" else 0
    history = TrainingHistory(meta, tier=tier, codec=codec,
                              spill_dir=spill_dir, spill_window=spill_window)
    grad_fn = objective.make_grad_fn()
    B = min(meta.batch_size, meta.n)
    idx = torch.from_numpy(
        batch_indices_all(meta.seed, meta.steps, meta.n, meta.batch_size)).to(dev)
    cols = ds.device_columns(dev)
    ones = torch.ones(B, device=dev)
    params = params0.to(dev)
    if tier == "stacked":
        L = meta.steps
    else:
        history.set_layout(params.shapes, dev)
    W = torch.empty((L, params.numel), device=dev)
    G = torch.empty_like(W)
    vel = torch.zeros_like(params.flat) if meta.momentum else None
    for a in range(0, meta.steps, L):
        b = min(meta.steps, a + L)
        for t in range(a, b):
            g = grad_fn(params, _gather(cols, idx[t]), ones)
            W[t - a] = params.flat
            G[t - a] = g
            new, vel = _step(params.flat, vel, g, meta.lr_at(t), meta.momentum)
            params = params.with_flat(new)
        if tier != "stacked":  # the window goes to the host, through the codec
            for i in range(b - a):  # encoded on the device; W is reused
                history.append(W[i], G[i])
    if tier == "stacked":
        history.set_stacked(W, G, final_params=params)
    else:
        history.finalize(params)
    _sync(dev)
    return params, history


# --------------------------------------------------------------------------
# BaseL: exact retraining from scratch
# --------------------------------------------------------------------------


def run_baseline(objective, ds: Dataset, meta: HistoryMeta,
                 params0: FlatParams, changed_idx: np.ndarray,
                 mode: str = "delete", device=None
                 ) -> Tuple[FlatParams, RetrainStats]:
    """BaseL: exact retraining on the modified dataset, replaying the
    original schedule (paper eq. (1) / (S6))."""
    if mode not in ("delete", "add"):
        raise ValueError(f"mode must be 'delete' or 'add', got {mode!r}")
    dev = resolve_device(device)
    changed_idx = np.asarray(changed_idx, dtype=np.int64)
    grad_fn = objective.make_grad_fn()
    stats = RetrainStats()
    t0 = time.perf_counter()
    r_pad = _next_pow2(max(1, len(changed_idx)))
    sched = build_schedule(meta.seed, meta.steps, meta.n, meta.batch_size,
                           changed_idx, mode, r_pad, meta.lr_at)

    eff = sched.kept.astype(np.int64) \
        + (sched.dB.astype(np.int64) if mode == "add" else 0)
    nonskip = eff > 0
    stats.grad_examples = int(eff[nonskip].sum())
    stats.skipped_steps = int((~nonskip).sum())
    stats.explicit_steps = meta.steps

    sd = to_device(sched, dev)
    cols = ds.device_columns(dev)
    if mode == "add":  # each step's batch is its B rows plus the joining rows
        rows_all = torch.cat([sd.idx, sd.changed_idx], dim=1)
        w_all = torch.cat([sd.kept_w, sd.changed_w], dim=1)
    else:
        rows_all, w_all = sd.idx, sd.kept_w
    params = params0.to(dev)
    vel = torch.zeros_like(params.flat) if meta.momentum else None
    for t in range(meta.steps):
        if mode == "delete" and sched.kept[t] <= 0:
            continue  # the whole batch was deleted: no update
        g = grad_fn(params, _gather(cols, rows_all[t]), w_all[t])
        new, vel = _step(params.flat, vel, g, float(sched.lr[t]), meta.momentum)
        params = params.with_flat(new)
    _sync(dev)
    stats.wall_time_s = time.perf_counter() - t0
    return params, stats


# --------------------------------------------------------------------------
# REPLAY: Algorithm 1
# --------------------------------------------------------------------------


class _DeviceTimed:
    """A span with a CUDA event recorded on the current stream just before
    it opens and just after it closes; the pair goes to `sink`."""

    __slots__ = ("span", "sink", "start")

    def __init__(self, span, sink: list):
        self.span, self.sink, self.start = span, sink, None

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self.span.__enter__()

    def __exit__(self, *exc) -> bool:
        self.span.__exit__(*exc)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.sink.append((self.span, self.start, end))
        return False


class _Steps:
    """What every step of one replay or online request reads: the gradient
    function, the history's store, the device columns and the schedule
    (numpy for the host's scalars, `DeviceSchedule` for the rows).  On a
    mesh-placed store (``runner``, a `core.store.ShardedReplay`) the rows
    are this rank's part of each batch and the history's rows come
    through the per-step gather."""

    def __init__(self, grad_fn, store: HistoryStore, cols, sched, dev,
                 momentum: float):
        self.grad_fn, self.store, self.cols = grad_fn, store, cols
        self.runner = store.sharded_replay()
        self.sched, self.sd = sched, to_device(sched, dev)
        if self.runner is not None:
            self.sd = self.runner.local_schedule(self.sd)
        self.sign = 1 if sched.mode == "delete" else -1
        self.mom = float(momentum)
        self._zeros: Optional[torch.Tensor] = None
        self._true: Optional[torch.Tensor] = None
        # traced segments on the card: (span, start event, end event)
        self.scan_events: List[Tuple[Any, Any, Any]] = []

    def zero_vel(self, params: FlatParams) -> Optional[torch.Tensor]:
        """vel_0 = 0 for a heavy-ball history, None for plain SGD."""
        return torch.zeros_like(params.flat) if self.mom else None

    def changed_grad(self, params: FlatParams, t: int) -> torch.Tensor:
        """Gradient over step t's changed rows; exact zeros when none of
        them is in the batch (the reference multiplies by ``dB > 0``)."""
        if self.sched.dB[t] > 0:
            return self.grad_fn(params, _gather(self.cols, self.sd.changed_idx[t]),
                                self.sd.changed_w[t])
        if self._zeros is None:
            self._zeros = torch.zeros_like(params.flat)
        return self._zeros

    def kept_grad(self, params: FlatParams, t: int) -> torch.Tensor:
        return self.grad_fn(params, _gather(self.cols, self.sd.idx[t]),
                            self.sd.kept_w[t])

    def true_flag(self, params: FlatParams) -> torch.Tensor:
        """The guard flag of a SKIP step, which leaves everything as is."""
        if self._true is None:
            self._true = torch.ones((), dtype=torch.bool,
                                    device=params.flat.device)
        return self._true

    def scan_span(self, params: FlatParams, a: int, b: int):
        """The ``replay.scan`` span of approx segment [a, b) (the
        subclasses hold ``cfg``).  Traced on the card, two CUDA events
        bracket it, recorded outside the span so that it stays sync-free;
        `read_device_times` reads them at the end-of-replay sync."""
        sp = obs_trace.span(
            "replay.scan", t0=a, t1=b,
            pred_s=_scan_pred(params.numel, b - a, self.sched.r_pad,
                              self.cfg.history_size, bool(self.mom)))
        if sp is obs_trace.NOOP_SPAN or params.flat.device.type != "cuda":
            return sp
        return _DeviceTimed(sp, self.scan_events)

    def read_device_times(self) -> None:
        """Once the replay has synced: each traced segment's device time
        (``device_s``, and ``device_roofline_ratio``, device_s over
        pred_s) set on its span beside its host ``measured_s``."""
        for sp, start, end in self.scan_events:
            device_s = start.elapsed_time(end) / 1e3
            sp.set(device_s=device_s)
            if sp.args.get("pred_s"):
                sp.set(device_roofline_ratio=device_s / float(sp.args["pred_s"]))
        self.scan_events.clear()

    def rows(self, W, G, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Row i of a window as flat f32 rows (an encoded one decoded on its
        own; a packed one gathered)."""
        if self.runner is not None:
            return self.runner.entry_at(W, G, i)
        return _row(W, G, i)

    def encoded_kernels(self, W) -> bool:
        """True where the SGD approx step reads an encoded window through
        `kernels.dequant_update` (off a mesh: on one, each row is decoded
        before its gather)."""
        return isinstance(W, EncodedWindow) and self.runner is None


class _Replay(_Steps):
    """The state one `run_replay` call shares between its steps."""

    def __init__(self, objective, store: HistoryStore, cols, sched, dev,
                 plan, cfg: DeltaGradConfig, B: int, stats: RetrainStats):
        runner = store.sharded_replay()
        grad_fn = (objective.make_grad_fn() if runner is None
                   else make_psum_grad_fn(objective, runner.data_group))
        super().__init__(grad_fn, store, cols, sched, dev,
                         store.history.meta.momentum)
        self.plan, self.cfg, self.B = plan, cfg, B
        # the SGD approx update: per tile of the data axis on a mesh
        self.update = fused_update if self.runner is None \
            else self.runner.fused_update
        self.stats = stats
        self.buffer = LbfgsBuffer(cfg.history_size,
                                  curvature_eps=cfg.curvature_eps)

    def explicit_step(self, params: FlatParams, vel, t: int):
        """One explicit step (the JAX engine's `_host_explicit_step` and
        `_explicit_step`): kept and changed gradients, the pair with its
        two admission inner products (one host sync), the update."""
        k, dB, B = float(self.sched.kept[t]), float(self.sched.dB[t]), self.B
        w_t, g_t = self.store.entry(t)
        g_kept = self.kept_grad(params, t)
        g_changed = self.changed_grad(params, t)
        if self.sign > 0:  # delete: the pair's gradient is over the ORIGINAL batch
            g_full = (k * g_kept + dB * g_changed) / B
            g_step = g_kept
        else:  # add
            g_full = g_kept
            g_step = (B * g_kept + dB * g_changed) / (B + dB)
        # drop each p-length gradient once it is read (at an LM's p each
        # is gigabytes of the card's peak)
        del g_kept, g_changed
        dw = params.flat - w_t
        dg = g_full - g_t
        del g_full
        curv, ss = torch.stack([tree_vdot(dg, dw), tree_vdot(dw, dw)]).tolist()
        if not self.buffer.add_pair(dw, dg, curv, ss):
            self.stats.pairs_rejected += 1
        self.stats.grad_examples += int(k + dB)
        self.stats.explicit_steps += 1
        new, vel = _step(params.flat, vel, g_step, float(self.sched.lr[t]),
                         self.mom)
        return params.with_flat(new), vel

    def segment(self, params: FlatParams, vel, a: int, b: int):
        """Approx steps [a, b) on the device, no host sync (the JAX
        engine's `_replay_segment_impl`, as a Python loop).  Returns the
        parameters, the velocity and, with the guard on, one device flag
        per step (True on SKIP steps, which leave the parameters as they
        are).  Plain SGD updates through `kernels.fused_update` (or, on an
        encoded window, `kernels.dequant_update`); heavy-ball through
        `_approx_math`.  Carries the ``replay.scan`` span."""
        with self.scan_span(params, a, b):
            return self._segment(params, vel, a, b)

    def _segment(self, params: FlatParams, vel, a: int, b: int):
        W, G, off = self.store.window(a, b)
        encoded = self.encoded_kernels(W)
        dW, dG = self.buffer.stacked()
        guard, clip = self.cfg.guard, float(self.cfg.guard_norm_clip)
        flags: List[torch.Tensor] = []
        for t in range(a, b):
            if self.plan[t] == SKIP:  # deletion emptied the batch: no update
                if guard:
                    flags.append(self.true_flag(params))
                continue
            g_changed = self.changed_grad(params, t)
            lr, dB = float(self.sched.lr[t]), float(self.sched.dB[t])
            i = t - off
            if vel is not None:  # heavy-ball: the estimate, then the step
                w_t, g_t = self.rows(W, G, i)
                v = params.flat - w_t
                bv = lbfgs_hvp_fused(dW, dG, v)
                g_est = _approx_math(g_t, bv, g_changed, self.B, dB, self.sign)
                new, vel = _step(params.flat, vel, g_est, lr, self.mom)
                finite = tree_all_finite(g_est)
            elif encoded:  # decode w_t and g_t in the kernels' registers
                q, scale, base = W.row(i)
                v = dequant_sub(params.flat, q, scale, W.bounds, base)
                bv = lbfgs_hvp_fused(dW, dG, v)
                q, scale, base = G.row(i)
                new = dequant_update(params.flat, q, bv, g_changed, lr,
                                     self.B, dB, self.sign, scale, G.bounds,
                                     base)
                finite = tree_all_finite(new)
            else:
                w_t, g_t = self.rows(W, G, i)
                v = params.flat - w_t
                bv = lbfgs_hvp_fused(dW, dG, v)
                new = self.update(params.flat, g_t, bv, g_changed,
                                  lr, self.B, dB, self.sign)
                finite = tree_all_finite(new)
            if guard:
                flags.append(finite & (tree_norm(bv) <= clip * tree_norm(v)))
            params = params.with_flat(new)
        return params, vel, (torch.stack(flags) if guard and flags else None)


def run_replay(objective, history: TrainingHistory, ds: Dataset,
               changed_idx: np.ndarray, cfg: DeltaGradConfig,
               mode: str = "delete", params0: Optional[FlatParams] = None,
               device=None, placement=None,
               store: Optional[HistoryStore] = None
               ) -> Tuple[FlatParams, RetrainStats]:
    """Algorithm 1 (GD + SGD unified; GD == SGD with batch_size >= n) on
    `device` (None: the card), reading the history through `store` or the
    store its tier calls for (`HistoryStore.create`: resident, or streamed
    in windows of ``cfg.stream_window`` steps, read as
    ``cfg.stream_decode`` says).  With `placement` (a
    `core.store.PlacementPolicy`) every rank of the default process group
    runs this call: the store holds the rank's shard of the path, the
    schedule's batches split over the data axis and the gradients are
    summed over it (the module note of `core.store`)."""
    if mode not in ("delete", "add"):
        raise ValueError(f"mode must be 'delete' or 'add', got {mode!r}")
    dev = resolve_device(device)
    if history.device.type != dev.type:
        raise ValueError(f"history lives on {history.device}, replay asked "
                         f"for {dev}")
    changed_idx = np.asarray(changed_idx, dtype=np.int64)
    if store is not None:  # the caller's, which it closes
        return _run_replay(objective, history, store, ds, changed_idx, cfg,
                           mode, params0, dev)
    store = HistoryStore.create(history, placement=placement,
                                window=cfg.stream_window,
                                decode=cfg.stream_decode)
    try:
        return _run_replay(objective, history, store, ds, changed_idx, cfg,
                           mode, params0, dev)
    finally:
        store.close()


def _run_replay(objective, history: TrainingHistory, store: HistoryStore,
                ds: Dataset, changed_idx: np.ndarray, cfg: DeltaGradConfig,
                mode: str, params0: Optional[FlatParams], dev: torch.device
                ) -> Tuple[FlatParams, RetrainStats]:
    meta = history.meta
    r = len(changed_idx)
    B = min(meta.batch_size, meta.n)
    # room for every changed row, unless the caller fixes the width
    r_pad = cfg.removal_pad or _next_pow2(max(1, min(r, B)))
    stats = RetrainStats()

    t_start = time.perf_counter()
    cols = ds.device_columns(dev)
    with obs_trace.span("replay.schedule_build", steps=meta.steps, r=r):
        sched = build_schedule(meta.seed, meta.steps, meta.n,
                               meta.batch_size, changed_idx, mode, r_pad,
                               meta.lr_at)
        plan = build_plan(cfg, sched)
        rp = _Replay(objective, store, cols, sched, dev, plan, cfg, B, stats)
    if params0 is None:  # w_0, read through the store like every row
        params0 = FlatParams(store.entry(0)[0].clone(), history.shapes)
    params = params0.to(dev)
    vel = rp.zero_vel(params)
    T = meta.steps
    seg_flags: List[Tuple[int, int, Optional[np.ndarray]]] = []

    def explicit_step(p, v, tt):
        with obs_trace.span("replay.explicit", t0=tt, steps=1):
            return rp.explicit_step(p, v, tt)

    t = 0
    while t < T:
        code = plan[t]
        if code == EXPLICIT or (code == APPROX and len(rp.buffer) == 0):
            params, vel = explicit_step(params, vel, t)
            t += 1
        elif code == SKIP and len(rp.buffer) == 0:
            t += 1
        else:
            t2 = t
            while t2 < T and plan[t2] != EXPLICIT:
                t2 += 1
            while t < t2:
                b = store.span_end(t, t2)
                p_in, v_in = params, vel
                params, vel, flags = rp.segment(p_in, v_in, t, b)
                oks = None if flags is None else flags.cpu().numpy()
                if cfg.guard and oks is not None:
                    # one host sync per segment: if a step tripped the
                    # Algorithm-4 guard, keep the all-ok prefix, run the
                    # tripped step as an explicit step (admitting its pair),
                    # and continue with the enlarged buffer
                    fell = np.flatnonzero((plan[t:b] != SKIP) & ~oks)
                    if fell.size:
                        tf = t + int(fell[0])
                        with obs_trace.span("replay.guard_retry", t=tf,
                                            prefix=tf - t):
                            if tf > t:
                                params, vel, flags_p = rp.segment(p_in, v_in,
                                                                  t, tf)
                                seg_flags.append((t, tf,
                                                  flags_p.cpu().numpy()))
                            else:
                                params, vel = p_in, v_in
                            stats.guard_fallbacks += 1
                            params, vel = explicit_step(params, vel, tf)
                        t = tf + 1
                        continue
                seg_flags.append((t, b, oks))
                t = b

    for t0_, t1_, oks in seg_flags:
        nonskip = plan[t0_:t1_] != SKIP
        dB_i = sched.dB[t0_:t1_].astype(np.int64)
        if cfg.guard and oks is not None:
            stats.approx_steps += int((nonskip & oks).sum())
        else:
            stats.approx_steps += int(nonskip.sum())
        stats.grad_examples += int(dB_i[nonskip].sum())
    stats.skipped_steps = int((plan == SKIP).sum())
    base = sched.kept.astype(np.int64) if mode == "delete" \
        else sched.kept.astype(np.int64) + sched.dB.astype(np.int64)
    stats.grad_examples_baseline = int(base.sum())
    _sync(dev)
    stats.wall_time_s = time.perf_counter() - t_start
    rp.read_device_times()
    stats.extra.update(buffer_admitted=rp.buffer.admitted,
                       buffer_rejected=rp.buffer.rejected, store=store.kind,
                       segments=max(1, len(seg_flags)), device=str(dev),
                       hbm_high_water=store.hbm_high_water())
    if isinstance(store, SegmentStreamer):
        stats.extra.update(
            windows=store.windows_fetched, prefetch_depth=store.depth_used,
            host_wait_s=store.host_wait_s,
            host_stage_high=store.host_stage_high,
            stream_decode=store.decode_mode,
            encoded_bytes_high=store.enc_bytes_high,
            compression_ratio=store.compression_ratio)
    if history.tier == "disk":
        stats.extra.update(spill_io_read_s=history.io_read_s,
                           spill_io_write_s=history.io_write_s)
    if rp.runner is not None:
        stats.extra["mesh"] = rp.runner.placement.describe()
    _publish_replay_metrics(stats, store)
    return params, stats


# --------------------------------------------------------------------------
# ONLINE: Algorithm 3, one request with the history rewrite
# --------------------------------------------------------------------------


def _ring_append(dW: torch.Tensor, dG: torch.Tensor, dw: torch.Tensor,
                 dg: torch.Tensor, admit: torch.Tensor, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift-append (dw, dg) to the newest-last (m, p) ring where the
    admission check ``<dg, dw> >= eps <dw, dw>`` and ``<dw, dw> > 0`` holds,
    resolved on the device (`admit` = [<dg, dw>, <dw, dw>]): a rejected
    pair leaves the ring as it was, and empty slots stay exact zeros."""
    ok = (admit[1] > 0.0) & (admit[0] >= eps * admit[1])
    dW = torch.where(ok, torch.cat([dW[1:], dw[None]]), dW)
    dG = torch.where(ok, torch.cat([dG[1:], dg[None]]), dG)
    return dW, dG


class _Online(_Steps):
    """The state of one online request: `_Steps`, the device pair ring and
    the deferred rewrites {t: (w_t, g_t)}."""

    def __init__(self, grad_fn, store: HistoryStore, cols, sched, dev,
                 plan, cfg: DeltaGradConfig, params: FlatParams):
        super().__init__(grad_fn, store, cols, sched, dev,
                         store.history.meta.momentum)
        self.plan, self.cfg = plan, cfg
        self.dW = torch.zeros((cfg.history_size, params.numel),
                              device=params.flat.device)
        self.dG = torch.zeros_like(self.dW)
        self.rewrites: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def explicit_step(self, params: FlatParams, vel, t: int):
        """The reference's `_online_explicit_fused`: the gradients over the
        scheduled kept rows (g_base: the post-request batch for a delete,
        the pre-request one for an add) and the request rows (g_one), the
        pair against the PRE-request gradient appended to the ring on the
        device, the update with the POST-request gradient, which is also
        the rewrite of g_t."""
        kept, dB = float(self.sched.kept[t]), float(self.sched.dB[t])
        w_t, g_t = self.store.entry(t)
        g_base = self.kept_grad(params, t)
        g_one = self.changed_grad(params, t)
        mix = (kept * g_base + dB * g_one) / max(kept + dB, 1.0) if dB > 0 \
            else g_base
        g_cur, g_prev = (g_base, mix) if self.sign > 0 else (mix, g_base)
        dw = params.flat - w_t
        dg = g_prev - g_t
        admit = torch.stack([tree_vdot(dg, dw), tree_vdot(dw, dw)])
        self.dW, self.dG = _ring_append(self.dW, self.dG, dw, dg, admit,
                                        self.cfg.curvature_eps)
        self.rewrites[t] = (params.flat, g_cur)
        new, vel = _step(params.flat, vel, g_cur, float(self.sched.lr[t]),
                         self.mom)
        return params.with_flat(new), vel

    def segment(self, params: FlatParams, vel, a: int, b: int):
        """Approx steps [a, b) on the device, no host sync (the reference's
        `_online_segment_impl`).  Each step's batch size is its own
        (B_t = kept + dB before a delete, kept before an add: Algorithm 3's
        n - k bookkeeping), B v solves over the ring's occupied slots, and
        the rewrite is (w^I_t, the estimated gradient): on an SGD step the
        update kernel's second output, so the rewritten g_t is the one the
        step took.  Returns the
        parameters, the velocity, the rewrites and, with the guard on, one
        flag per step; the caller keeps the rewrites of an accepted
        segment only.  SKIP steps change nothing and rewrite nothing.
        Carries the ``replay.scan`` span."""
        with self.scan_span(params, a, b):
            return self._segment(params, vel, a, b)

    def _segment(self, params: FlatParams, vel, a: int, b: int):
        W, G, off = self.store.window(a, b)
        encoded = self.encoded_kernels(W)
        valid = ring_valid_mask(self.dW)
        guard, clip = self.cfg.guard, float(self.cfg.guard_norm_clip)
        flags: List[torch.Tensor] = []
        rewrites: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        for t in range(a, b):
            if self.plan[t] == SKIP:
                if guard:
                    flags.append(self.true_flag(params))
                continue
            g_one = self.changed_grad(params, t)
            lr, kept, dB = (float(self.sched.lr[t]), float(self.sched.kept[t]),
                            float(self.sched.dB[t]))
            b_prev = kept + dB if self.sign > 0 else kept
            i = t - off
            if vel is not None:  # heavy-ball: the estimate, then the step
                w_t, g_t = self.rows(W, G, i)
                v = params.flat - w_t
                bv = lbfgs_hvp_fused(self.dW, self.dG, v, valid)
                g_new = _approx_math(g_t, bv, g_one, b_prev, dB, self.sign)
                new, vel = _step(params.flat, vel, g_new, lr, self.mom)
            elif encoded:  # decode w_t and g_t in the kernels' registers
                q, scale, base = W.row(i)
                v = dequant_sub(params.flat, q, scale, W.bounds, base)
                bv = lbfgs_hvp_fused(self.dW, self.dG, v, valid)
                q, scale, base = G.row(i)
                new, g_new = dequant_update(params.flat, q, bv, g_one, lr,
                                            b_prev, dB, self.sign, scale,
                                            G.bounds, base, with_g=True)
            else:  # the whole vector on every rank of a mesh
                w_t, g_t = self.rows(W, G, i)
                v = params.flat - w_t
                bv = lbfgs_hvp_fused(self.dW, self.dG, v, valid)
                new, g_new = fused_update(params.flat, g_t, bv, g_one, lr,
                                          b_prev, dB, self.sign, with_g=True)
            if guard:
                flags.append(tree_all_finite(new)
                             & (tree_norm(bv) <= clip * tree_norm(v)))
            rewrites[t] = (params.flat, g_new)
            params = params.with_flat(new)
        return (params, vel, rewrites,
                torch.stack(flags) if guard and flags else None)


def run_online_request(grad_fn, store: HistoryStore, cols,
                       sched: ReplaySchedule, cfg: DeltaGradConfig
                       ) -> Tuple[FlatParams, RetrainStats]:
    """One online request (a row or a group of rows; delete or add, as
    ``sched.mode`` says) against the current cached path, served through
    `store`, whose history it rewrites (`store.commit`) before returning.

    `sched` comes from `data.sampler.build_online_schedule`; the caller
    (`core.online.OnlineEngine`) owns the stream's state.  The L-BFGS pairs
    live in the request's zeros-initialised device ring from step 0 (the
    module note), so with the guard off the request reads nothing back
    from the device before its end; with the guard on, one flag vector per
    approx segment, as in `run_replay`.  A heavy-ball history replays with
    the velocity rebuilt from vel_0 = 0, and the cache keeps storing plain
    gradients, so every request is self-contained."""
    history = store.history
    meta = history.meta
    dev = history.device
    t_start = time.perf_counter()
    plan = build_plan(cfg, sched, online=True)
    params = FlatParams(store.entry(0)[0].clone(), history.shapes)  # w_0 stays
    on = _Online(grad_fn, store, cols, sched, dev, plan, cfg, params)
    vel = on.zero_vel(params)
    stats = RetrainStats()
    T = meta.steps
    seg_flags: List[Tuple[int, int, Optional[np.ndarray]]] = []
    ring_started = False  # the first step that is not skipped is explicit
    # the contiguous regions of rewritten steps, counted as the reference
    # lands them (one assembly per region): the ``replay.commit`` arg
    regions, write_end = 0, -1

    def note(t, span):
        nonlocal regions, write_end
        if regions == 0 or t != write_end:
            regions += 1
        write_end = t + span

    def explicit(params, vel, t, r2):
        """Explicit steps [t, r2), under one ``replay.explicit`` span."""
        nonlocal ring_started
        with obs_trace.span("replay.explicit", t0=t, steps=r2 - t):
            for tt in range(t, r2):
                params, vel = on.explicit_step(params, vel, tt)
                note(tt, 1)
        ring_started = True
        stats.grad_examples += int((sched.kept[t:r2] + sched.dB[t:r2]).sum())
        stats.explicit_steps += r2 - t
        return params, vel

    t = 0
    while t < T:
        code = plan[t]
        if code == EXPLICIT or (code == APPROX and not ring_started):
            r2 = t + 1
            if code == EXPLICIT:
                while r2 < T and plan[r2] == EXPLICIT:
                    r2 += 1
            params, vel = explicit(params, vel, t, r2)
            t = r2
        elif code == SKIP and not ring_started:
            t += 1  # the entry stays as it is
        else:
            t2 = t
            while t2 < T and plan[t2] != EXPLICIT:
                t2 += 1
            while t < t2:
                b = store.span_end(t, t2)
                p_in, v_in = params, vel
                params, vel, rw, flags = on.segment(p_in, v_in, t, b)
                oks = None if flags is None else flags.cpu().numpy()
                if cfg.guard and oks is not None:
                    # as in `run_replay`: the tripped step runs explicitly
                    # (admitting its pair and rewriting the exact gradient),
                    # and the failed segment's rewrites are dropped
                    fell = np.flatnonzero((plan[t:b] != SKIP) & ~oks)
                    if fell.size:
                        tf = t + int(fell[0])
                        with obs_trace.span("replay.guard_retry", t=tf,
                                            prefix=tf - t):
                            if tf > t:
                                params, vel, rw, flags_p = on.segment(
                                    p_in, v_in, t, tf)
                                on.rewrites.update(rw)
                                note(t, tf - t)
                                seg_flags.append((t, tf,
                                                  flags_p.cpu().numpy()))
                            else:
                                params, vel = p_in, v_in
                            stats.guard_fallbacks += 1
                            params, vel = explicit(params, vel, tf, tf + 1)
                        t = tf + 1
                        continue
                on.rewrites.update(rw)
                note(t, b - t)
                seg_flags.append((t, b, oks))
                t = b

    with obs_trace.span("replay.commit", regions=regions):
        store.commit(on.rewrites, final_params=params)
    for t0_, t1_, oks in seg_flags:
        nonskip = plan[t0_:t1_] != SKIP
        if cfg.guard and oks is not None:
            stats.approx_steps += int((nonskip & oks).sum())
        else:
            stats.approx_steps += int(nonskip.sum())
        stats.grad_examples += int(
            sched.dB[t0_:t1_].astype(np.int64)[nonskip].sum())
    stats.skipped_steps = int((plan == SKIP).sum())
    base = sched.kept.astype(np.int64)
    if sched.mode == "add":
        base = base + sched.dB.astype(np.int64)
    stats.grad_examples_baseline = int(base.sum())
    _sync(dev)
    stats.wall_time_s = time.perf_counter() - t_start
    on.read_device_times()
    stats.extra.update(store=store.kind, hbm_high_water=store.hbm_high_water(),
                       segments=max(1, len(seg_flags)), device=str(dev))
    if isinstance(store, SegmentStreamer):
        stats.extra.update(windows=store.windows_fetched,
                           stream_decode=store.decode_mode)
    if on.runner is not None:
        stats.extra["mesh"] = on.runner.placement.describe()
    if ring_started:  # the end-of-request pair ring, for stream snapshots
        stats.extra["lbfgs_ring"] = (on.dW, on.dG)
    _publish_replay_metrics(stats, store)
    return params, stats
