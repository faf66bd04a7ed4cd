"""The DeltaGrad engine: training with a cached path, BaseL, and the replay.

Mapping to Wu et al., ICML 2020 (and to the JAX package's `core.engine`):

  SCHEDULE  `data.sampler.build_schedule` precomputes the replay plan
            ((T, B) batch indices, overlap masks, learning rates) on the
            host; `to_device` uploads it once.  Every per-step scalar the
            host needs (kept, dB, lr) is read from the numpy plan, so a
            step's control flow costs no device sync.
  RECORD    `run_training`: Algorithm 1's original GD/SGD run, writing
            (w_t, g_t) into two preallocated (T, p) device buffers, the
            `TrainingHistory`.
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
            then runs as an explicit step.

Parameters are one flat f32 buffer (`utils.tree.FlatParams`, the order of
jax's ``ravel_pytree``), so each kernel runs once per step over all of p.

Precision: the entry points turn TF32 off for matmuls and cuDNN
(`resolve_device`), because the reference computes in full f32.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.history import HistoryMeta, TrainingHistory
from repro_torch.core.lbfgs import LbfgsBuffer
from repro_torch.core.store import ResidentStore
from repro_torch.data.dataset import Dataset
from repro_torch.data.sampler import (ReplaySchedule, batch_indices_all,
                                      build_schedule)
from repro_torch.kernels.fused_update.ops import update as fused_update
from repro_torch.kernels.lbfgs.ops import MAX_M, lbfgs_hvp_fused
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

    def __post_init__(self):
        if not 1 <= self.history_size <= MAX_M:
            raise ValueError(f"history_size must be in 1..{MAX_M} (the L-BFGS "
                             f"kernels' range), got {self.history_size}")
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {self.period}")

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


# --------------------------------------------------------------------------
# Step plan and device schedule
# --------------------------------------------------------------------------

SKIP, EXPLICIT, APPROX = 0, 1, 2


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def build_plan(cfg: DeltaGradConfig, sched: ReplaySchedule) -> np.ndarray:
    """Per-step codes.  SKIP (an emptied batch under deletion, paper §3)
    takes precedence over the explicit/approx cadence."""
    T = sched.steps
    codes = np.full(T, APPROX, dtype=np.int8)
    for t in range(T):
        if cfg.is_explicit(t):
            codes[t] = EXPLICIT
    if sched.mode == "delete":
        codes[sched.kept <= 0] = SKIP
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


def _check_plain_sgd(meta: HistoryMeta) -> None:
    if meta.momentum:
        raise NotImplementedError(
            "momentum is not ported yet; this slice replays plain SGD/GD")


# --------------------------------------------------------------------------
# RECORD: the original training run
# --------------------------------------------------------------------------


def run_training(objective, params0: FlatParams, ds: Dataset,
                 meta: HistoryMeta, device=None
                 ) -> Tuple[FlatParams, TrainingHistory]:
    """Train w_t by plain SGD (the paper's optimizer), caching (w_t, g_t)
    in two (T, p) f32 buffers on `device`."""
    dev = resolve_device(device)
    _check_plain_sgd(meta)
    grad_fn = objective.make_grad_fn()
    B = min(meta.batch_size, meta.n)
    idx = torch.from_numpy(
        batch_indices_all(meta.seed, meta.steps, meta.n, meta.batch_size)).to(dev)
    cols = ds.device_columns(dev)
    ones = torch.ones(B, device=dev)
    params = params0.to(dev)
    W = torch.empty((meta.steps, params.numel), device=dev)
    G = torch.empty_like(W)
    for t in range(meta.steps):
        g = grad_fn(params, _gather(cols, idx[t]), ones)
        W[t] = params.flat
        G[t] = g
        params = params.with_flat(params.flat - meta.lr_at(t) * g)
    history = TrainingHistory(meta)
    history.set_stacked(W, G, final_params=params)
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
    _check_plain_sgd(meta)
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
    for t in range(meta.steps):
        if mode == "delete" and sched.kept[t] <= 0:
            continue  # the whole batch was deleted: no update
        g = grad_fn(params, _gather(cols, rows_all[t]), w_all[t])
        params = params.with_flat(params.flat - float(sched.lr[t]) * g)
    _sync(dev)
    stats.wall_time_s = time.perf_counter() - t0
    return params, stats


# --------------------------------------------------------------------------
# REPLAY: Algorithm 1
# --------------------------------------------------------------------------


class _Replay:
    """The state one `run_replay` call shares between its steps."""

    def __init__(self, objective, store: ResidentStore, cols, sd, sched,
                 plan, cfg: DeltaGradConfig, B: int, sign: int,
                 stats: RetrainStats):
        self.grad_fn = objective.make_grad_fn()
        self.store, self.cols, self.sd, self.sched = store, cols, sd, sched
        self.plan, self.cfg, self.B, self.sign = plan, cfg, B, sign
        self.stats = stats
        self.buffer = LbfgsBuffer(cfg.history_size,
                                  curvature_eps=cfg.curvature_eps)
        self._zeros: Optional[torch.Tensor] = None
        self._true: Optional[torch.Tensor] = None

    def changed_grad(self, params: FlatParams, t: int) -> torch.Tensor:
        """Gradient over step t's changed rows; exact zeros when none of
        them is in the batch (the reference multiplies by ``dB > 0``)."""
        if self.sched.dB[t] > 0:
            return self.grad_fn(params, _gather(self.cols, self.sd.changed_idx[t]),
                                self.sd.changed_w[t])
        if self._zeros is None:
            self._zeros = torch.zeros_like(params.flat)
        return self._zeros

    def explicit_step(self, params: FlatParams, t: int) -> FlatParams:
        """One explicit step (the JAX engine's `_host_explicit_step` and
        `_explicit_step`): kept and changed gradients, the pair with its
        two admission inner products (one host sync), the SGD update."""
        k, dB, B = float(self.sched.kept[t]), float(self.sched.dB[t]), self.B
        lr = float(self.sched.lr[t])
        w_t, g_t = self.store.entry(t)
        g_kept = self.grad_fn(params, _gather(self.cols, self.sd.idx[t]),
                              self.sd.kept_w[t])
        g_changed = self.changed_grad(params, t)
        if self.sign > 0:  # delete: the pair's gradient is over the ORIGINAL batch
            g_full = (k * g_kept + dB * g_changed) / B
            g_step = g_kept
        else:  # add
            g_full = g_kept
            g_step = (B * g_kept + dB * g_changed) / (B + dB)
        dw = params.flat - w_t
        dg = g_full - g_t
        curv, ss = torch.stack([tree_vdot(dg, dw), tree_vdot(dw, dw)]).tolist()
        if not self.buffer.add_pair(dw, dg, curv, ss):
            self.stats.pairs_rejected += 1
        self.stats.grad_examples += int(k + dB)
        self.stats.explicit_steps += 1
        return params.with_flat(params.flat - lr * g_step)

    def segment(self, params: FlatParams, a: int, b: int
                ) -> Tuple[FlatParams, Optional[torch.Tensor]]:
        """Approx steps [a, b) on the device, no host sync (the JAX
        engine's `_replay_segment_impl`, as a Python loop).  Returns the
        parameters and, with the guard on, one device flag per step (True
        on SKIP steps, which leave the parameters as they are)."""
        W, G, off = self.store.window(a, b)
        dW, dG = self.buffer.stacked()
        guard, clip = self.cfg.guard, float(self.cfg.guard_norm_clip)
        flags: List[torch.Tensor] = []
        for t in range(a, b):
            if self.plan[t] == SKIP:  # deletion emptied the batch: no update
                if guard:
                    if self._true is None:
                        self._true = torch.ones((), dtype=torch.bool,
                                                device=params.flat.device)
                    flags.append(self._true)
                continue
            g_changed = self.changed_grad(params, t)
            v = params.flat - W[t - off]
            bv = lbfgs_hvp_fused(dW, dG, v)
            new = fused_update(params.flat, G[t - off], bv, g_changed,
                               float(self.sched.lr[t]), self.B,
                               float(self.sched.dB[t]), self.sign)
            if guard:
                flags.append(tree_all_finite(new)
                             & (tree_norm(bv) <= clip * tree_norm(v)))
            params = params.with_flat(new)
        return params, (torch.stack(flags) if guard and flags else None)


def run_replay(objective, history: TrainingHistory, ds: Dataset,
               changed_idx: np.ndarray, cfg: DeltaGradConfig,
               mode: str = "delete", params0: Optional[FlatParams] = None,
               device=None) -> Tuple[FlatParams, RetrainStats]:
    """Algorithm 1 (GD + SGD unified; GD == SGD with batch_size >= n) over
    a device-resident history on `device` (None: the card)."""
    if mode not in ("delete", "add"):
        raise ValueError(f"mode must be 'delete' or 'add', got {mode!r}")
    dev = resolve_device(device)
    if history.device.type != dev.type:
        raise ValueError(f"history lives on {history.device}, replay asked "
                         f"for {dev}")
    meta = history.meta
    _check_plain_sgd(meta)
    changed_idx = np.asarray(changed_idx, dtype=np.int64)
    r = len(changed_idx)
    B = min(meta.batch_size, meta.n)
    sign = 1 if mode == "delete" else -1
    r_pad = _next_pow2(max(1, min(r, B)))  # room for every changed row
    store = ResidentStore(history)
    stats = RetrainStats()

    t_start = time.perf_counter()
    sched = build_schedule(meta.seed, meta.steps, meta.n, meta.batch_size,
                           changed_idx, mode, r_pad, meta.lr_at)
    plan = build_plan(cfg, sched)
    rp = _Replay(objective, store, ds.device_columns(dev), to_device(sched, dev),
                 sched, plan, cfg, B, sign, stats)
    params = (params0 if params0 is not None else history.params_at(0)).to(dev)
    T = meta.steps
    seg_flags: List[Tuple[int, int, Optional[np.ndarray]]] = []

    t = 0
    while t < T:
        code = plan[t]
        if code == EXPLICIT or (code == APPROX and len(rp.buffer) == 0):
            params = rp.explicit_step(params, t)
            t += 1
        elif code == SKIP and len(rp.buffer) == 0:
            t += 1
        else:
            t2 = t
            while t2 < T and plan[t2] != EXPLICIT:
                t2 += 1
            while t < t2:
                b = store.span_end(t, t2)
                p_in = params
                params, flags = rp.segment(p_in, t, b)
                oks = None if flags is None else flags.cpu().numpy()
                if cfg.guard and oks is not None:
                    # one host sync per segment: if a step tripped the
                    # Algorithm-4 guard, keep the all-ok prefix, run the
                    # tripped step as an explicit step (admitting its pair),
                    # and continue with the enlarged buffer
                    fell = np.flatnonzero((plan[t:b] != SKIP) & ~oks)
                    if fell.size:
                        tf = t + int(fell[0])
                        if tf > t:
                            params, flags_p = rp.segment(p_in, t, tf)
                            seg_flags.append((t, tf, flags_p.cpu().numpy()))
                        else:
                            params = p_in
                        stats.guard_fallbacks += 1
                        params = rp.explicit_step(params, tf)
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
    stats.extra.update(buffer_admitted=rp.buffer.admitted,
                       buffer_rejected=rp.buffer.rejected, store=store.kind,
                       segments=max(1, len(seg_flags)), device=str(dev),
                       hbm_high_water=store.hbm_high_water())
    return params, stats
