"""Where the replay reads the history from.

Every store gives the engine the same three methods: ``window(a, b) ->
(W, G, off)`` for an approx segment [a, b) (step t's rows are
``W[t - off]``), ``span_end(t, t2)`` (where a segment must split), and
``entry(t)`` for explicit steps.  `HistoryStore.create` picks the store for
the history's tier.

``ResidentStore`` serves a stacked (device-resident) history whole: every
approx segment runs at once and reads its rows in place.

An online request's history rewrites land through ``commit``: a scatter
into the resident tensors, or the codec's write-back of every rewritten
row on the offload tiers.

``SegmentStreamer`` serves a host- or disk-tier history in windows of
``window`` steps (`auto_window`).  Worker threads stage each window's
encoded rows into pinned host buffers and copy them to the device on a
side CUDA stream; the compute stream waits on the copy's event before it
reads the window, so the copy of window s+1 runs while the replay computes
on window s.  The prefetch depth grows past 1 when staging is measurably
slower than the replay of a window, within a budget of pinned host bytes.
Windows before the current one are evicted, so the device holds about two
windows of the path, not all of it.  Explicit steps read their rows from
the windows too (`entry`), so no row of the path is copied on its own.

Read paths (``decode``): ``"fetch"`` decodes each window to f32 on
arrival; ``"kernel"`` keeps it ENCODED on the device (`EncodedWindow`)
and the replay's approx steps decode one row at a time in registers
(`kernels.dequant_update`); ``"auto"`` is kernel for every codec but f32,
whose windows have nothing to decode.  Both paths decode with
`kernels.dequant_update.ref.dequant_ref`'s one expression, which keeps
kernel-mode and fetch-mode replays bitwise equal.

The streamer emits the reference's spans (``store.window_stage`` on the
staging thread, ``store.prefetch_wait``, ``store.window``) and counters
(``store.prefetch_hits``, ``store.host_wait_s``, ``store.windows_fetched``,
the ``store.hbm_high_water_bytes`` gauge) into `repro_torch.obs`.

On a mesh (`PlacementPolicy`, over the ranks of the default
``torch.distributed`` process group; every rank runs the same program):

  * ``ResidentStore(history, placement=)`` keeps only the rank's PACKED
    SHARD of the path, (T, p_rank) per quantity: the columns
    `dist.sharding.shard_index` gives under the leaves'
    `stacked_spec_for_leaf` placements (the time axis is never cut), so
    the device's history bytes drop by the mesh factor on sharded leaves;
  * ``ShardedStreamer`` is the host/disk tier on a mesh: each rank stages
    and uploads only its packed slice of every window (f32, or encoded,
    with the keyframes' slices), decoded on arrival (fetch) or one row at
    a time (kernel);
  * `ShardedReplay` is what the engines read through on both: one
    ``all_gather`` of the packed row per quantity per step, then one fixed
    gather into the flat row (a replicated position from the lowest rank
    holding it; an encoded row is decoded before its gather), the
    schedule's batch padded (`pad_schedule_batch`) and cut to the rank's
    part of the data axis, and the fused update run per tile of the data
    axis, each rank launching the kernel on its tile;
  * `make_psum_grad_fn` is the weighted-mean gradient of the objective
    over the data axis: each rank's weighted sum and weight total are
    ``all_reduce``d, and l2 is added once.

The collectives are ``all_reduce``, ``all_gather`` (list form) and
``broadcast``, which gloo (CPU and CUDA tensors) and NCCL both implement.
Parameters and L-BFGS pairs are replicated, bitwise equal on every rank.
"""

from __future__ import annotations

import math
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.history import TrainingHistory
from repro_torch.dist.sharding import (Mesh, ShardingPlan, gather_map,
                                       shard_index)
from repro_torch.kernels.dequant_update.ref import dequant_ref
from repro_torch.kernels.fused_update.ops import update as fused_update
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.tree import key_order

DECODE_MODES = ("auto", "kernel", "fetch")
# host bytes that windows staged ahead may pin at once: at an LM's p one
# window is gigabytes, and pinned memory is host RAM the history needs too
STAGE_BUDGET = 16 << 30


def auto_window(steps: int, window: int = 0) -> int:
    """Steps per device-resident window on the offload tiers: one knob
    shared by the recorder (`core.engine.run_training`) and the read path
    (`SegmentStreamer`)."""
    return int(window) if window else max(1, min(steps, 32))


# --------------------------------------------------------------------------
# Encoded windows
# --------------------------------------------------------------------------


class EncodedWindow(NamedTuple):
    """One quantity's window kept ENCODED on the device.

    ``q`` (L, p) int8 or bf16; ``scale`` (L, n_leaves) f32, one per leaf
    per step, or None (bf16); for the delta codecs ``base`` stacks the f32
    keyframes (n_kw, p) of every key window the steps touch and ``kidx``
    (L,) maps each step to its keyframe row (also kept on the host as
    ``kidx_np``, so the host picks a step's base row without a sync), so
    any stream window works with any key interval.  ``bounds`` are the
    leaves' offsets."""

    q: torch.Tensor
    scale: Optional[torch.Tensor]
    base: Optional[torch.Tensor]
    kidx: Optional[torch.Tensor]
    kidx_np: Optional[np.ndarray]
    bounds: Tuple[int, ...]

    def row(self, i: int):
        """(q, scale, base) of row i, as views (the kernels' operands)."""
        return (self.q[i], None if self.scale is None else self.scale[i],
                None if self.base is None else self.base[int(self.kidx_np[i])])

    def decoded_nbytes(self) -> int:
        return self.q.numel() * 4


def decode_window(win: EncodedWindow) -> torch.Tensor:
    """The whole window as (L, p) f32: the fetch-mode read path."""
    base = None if win.base is None else win.base.index_select(0, win.kidx)
    return dequant_ref(win.q, win.scale, win.bounds, base)


def decode_row(win: EncodedWindow, i: int) -> torch.Tensor:
    """Row i as (p,) f32; bitwise row i of `decode_window`."""
    q, scale, base = win.row(i)
    return dequant_ref(q, scale, win.bounds, base)


Window = Union[torch.Tensor, EncodedWindow]


def _row(W: Window, G: Window, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row i of a window pair as f32 (an encoded one decoded on its own)."""
    if isinstance(W, EncodedWindow):
        return decode_row(W, i), decode_row(G, i)
    return W[i], G[i]


# --------------------------------------------------------------------------
# Placement policy (a picklable mesh descriptor over torch.distributed)
# --------------------------------------------------------------------------


@dataclass
class PlacementPolicy:
    """The replay mesh over the ranks of the default process group.

    Rank r sits at the row-major coordinates of r in ``mesh_shape``;
    ``data_axis`` names the axis whose ranks split each minibatch (their
    gradients are summed over it).  The policy is plain data, so
    `UnlearnerSession.save()` round-trips it; the live data-axis group is
    made at first use on each rank and dropped when the policy is pickled.
    The caller initializes the default group (``torch.distributed.
    init_process_group``) with the backend it names before the policy is
    used; the policy never starts one."""

    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("data", "model")
    data_axis: str = "data"
    model_cfg: Any = None  # optional ModelConfig for the MoE spec rules

    def __post_init__(self):
        self.mesh_shape = tuple(int(s) for s in self.mesh_shape)
        self.axis_names = tuple(self.axis_names)
        self._data_group = None  # (group,) once made

    @classmethod
    def from_mesh(cls, mesh: Mesh, data_axis: str = "data",
                  model_cfg=None) -> "PlacementPolicy":
        return cls(mesh_shape=mesh.shape, axis_names=mesh.axis_names,
                   data_axis=data_axis, model_cfg=model_cfg)

    @classmethod
    def local(cls, data: Optional[int] = None) -> "PlacementPolicy":
        """1-D data mesh over the ranks of the default process group (or
        of `data` ranks)."""
        if data is None:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    "PlacementPolicy.local() spans the default process "
                    "group: call torch.distributed.init_process_group "
                    "first, or pass data=")
            data = dist.get_world_size()
        return cls(mesh_shape=(int(data),), axis_names=("data",))

    @property
    def size(self) -> int:
        return math.prod(self.mesh_shape)

    @property
    def data_size(self) -> int:
        if self.data_axis not in self.axis_names:
            return 1
        return self.mesh_shape[self.axis_names.index(self.data_axis)]

    def check_world(self) -> None:
        """Raise unless the default process group has one rank per mesh
        position."""
        have = (dist.get_world_size()
                if dist.is_available() and dist.is_initialized() else None)
        if have != self.size:
            raise ValueError(
                f"the placement asks for a {self.mesh_shape} mesh "
                f"({self.size} ranks) but the default process group "
                + ("is not initialized" if have is None else f"has {have}")
                + ": call torch.distributed.init_process_group with that "
                "world size on every rank, or drop the placement to replay "
                "on one device")

    @property
    def mesh(self) -> Mesh:
        """The mesh, bound to this process's rank."""
        self.check_world()
        return Mesh(self.mesh_shape, self.axis_names).at(dist.get_rank())

    def plan(self) -> ShardingPlan:
        bound = dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == self.size
        mesh = self.mesh if bound else Mesh(self.mesh_shape, self.axis_names)
        return ShardingPlan(mesh=mesh, cfg=self.model_cfg)

    def data_group(self):
        """The process group of this rank's line along the data axis (the
        default group when every other axis has size 1).  Every rank makes
        every line's group, in the same order, on first use."""
        if self._data_group is None:
            mesh = self.mesh
            if self.size == self.data_size:
                self._data_group = (None,)
            else:
                a = self.axis_names.index(self.data_axis)
                mine = None
                for r in range(self.size):
                    c = mesh.coords_of(r)
                    if c[a] != 0:
                        continue  # one group per line, made from its first rank
                    ranks = [int(np.ravel_multi_index(c[:a] + (d,) + c[a + 1:],
                                                      self.mesh_shape))
                             for d in range(self.mesh_shape[a])]
                    group = dist.new_group(ranks)
                    if dist.get_rank() in ranks:
                        mine = group
                self._data_group = (mine,)
        return self._data_group[0]

    def barrier(self, device) -> None:
        """Wait for every rank (one ``all_reduce`` of a one-element tensor on
        `device`, which the group's backend must take)."""
        dist.all_reduce(torch.zeros(1, device=device))

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_data_group"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def describe(self) -> Dict[str, Any]:
        """DISPLAY-only summary (``stats.extra["mesh"]``)."""
        return {"mesh_shape": list(self.mesh_shape),
                "axis_names": list(self.axis_names),
                "data_axis": self.data_axis}


# --------------------------------------------------------------------------
# Data-parallel gradients: the weighted mean as an all_reduce
# --------------------------------------------------------------------------


def make_psum_grad_fn(objective, group=None):
    """`Objective.make_grad_fn` semantics when each rank holds part of the
    batch: each rank takes the gradient of its rows' weighted loss SUM; the
    sums and the weight total are ``all_reduce``d over `group` (one call,
    one buffer), and the l2 term is added once after the reduction, which
    is the single-device weighted mean up to the order of the sums."""

    def grad_fn(params, batch, weights) -> torch.Tensor:
        names = key_order(params)
        with torch.enable_grad():
            leaves = {k: params[k].detach().requires_grad_(True) for k in names}
            total = (objective.per_example_loss(leaves, batch) * weights).sum()
            grads = torch.autograd.grad(total, [leaves[k] for k in names])
        buf = torch.cat([g.reshape(-1) for g in grads]
                        + [weights.sum().reshape(1)])
        dist.all_reduce(buf, group=group)
        g = buf[:-1] / torch.clamp(buf[-1], min=1.0)
        if objective.l2:
            g = g + objective.l2 * params.flat
        return g

    return grad_fn


def pad_schedule_batch(sd, multiple: int):
    """Pad the device schedule's batch-shaped dims (axis 1) to a multiple of
    the data-axis size with weight-0 rows, so the batch splits evenly.
    Zero-weight rows gather row 0 and add nothing to any gradient."""
    if multiple <= 1:
        return sd

    def pad(x):
        b = x.shape[1]
        want = -(-b // multiple) * multiple
        if want == b:
            return x
        return torch.nn.functional.pad(x, (0, want - b))

    return sd._replace(idx=pad(sd.idx), kept_w=pad(sd.kept_w),
                       changed_idx=pad(sd.changed_idx),
                       changed_w=pad(sd.changed_w))


class ShardedReplay:
    """What the engines read a mesh-placed store through (module note):
    the rank's packed shard of the flat row, the per-step gather, the
    rank's part of the schedule and the per-tile fused update."""

    def __init__(self, store: "HistoryStore"):
        pol = store.placement
        pol.check_world()
        self.placement = pol
        plan = pol.plan()
        shapes = store.history.shapes
        self.shard = shard_index(plan, shapes)
        dev = store.history.device
        self._src = torch.from_numpy(gather_map(plan, shapes)).to(dev)
        self.world = pol.size
        coords = plan.mesh.coords
        self.data_size = pol.data_size
        self.data_rank = (coords[pol.axis_names.index(pol.data_axis)]
                          if pol.data_axis in pol.axis_names else 0)
        self.data_group = pol.data_group()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The flat row from every rank's packed row `x`: one all_gather."""
        buf = torch.empty((self.world, x.numel()), dtype=x.dtype, device=x.device)
        dist.all_gather(list(buf.unbind(0)), x.contiguous())
        return buf.view(-1).index_select(0, self._src)

    def entry_at(self, W: Window, G: Window, i: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Row i of a packed window pair as flat f32 rows (an encoded row is
        decoded before its gather)."""
        w, g = _row(W, G, i)
        return self.gather(w), self.gather(g)

    def local_schedule(self, sd):
        """The schedule padded to the data axis and cut to this rank's
        columns of every batch-shaped dim."""
        sd = pad_schedule_batch(sd, self.data_size)

        def cut(x):
            b = x.shape[1] // self.data_size
            return x[:, self.data_rank * b:(self.data_rank + 1) * b].contiguous()

        return sd._replace(idx=cut(sd.idx), kept_w=cut(sd.kept_w),
                           changed_idx=cut(sd.changed_idx),
                           changed_w=cut(sd.changed_w))

    def fused_update(self, w, g_cached, bv, g_changed, lr, n, dB, sign):
        """`kernels.fused_update` routed per tile: the flat vector padded to
        a multiple of the data axis splits into equal tiles, each rank
        launches the kernel on its own, and the tiles are all-gathered and
        trimmed (the update is elementwise, so the split is exact)."""
        D = self.data_size
        if D == 1:
            return fused_update(w, g_cached, bv, g_changed, lr, n, dB, sign)
        p = w.numel()
        ps = -(-p // D)
        lo = min(p, self.data_rank * ps)
        hi = min(p, lo + ps)
        if hi - lo == ps:
            tile = fused_update(w[lo:hi], g_cached[lo:hi], bv[lo:hi],
                                g_changed[lo:hi], lr, n, dB, sign)
        else:  # the ragged last tiles: the kernel on what is left, zeros after
            tile = w.new_zeros(ps)
            if hi > lo:
                tile[:hi - lo] = fused_update(w[lo:hi], g_cached[lo:hi],
                                              bv[lo:hi], g_changed[lo:hi],
                                              lr, n, dB, sign)
        out = w.new_empty(D * ps)
        dist.all_gather(list(out.view(D, ps).unbind(0)), tile,
                        group=self.data_group)
        return out[:p]


# --------------------------------------------------------------------------
# Stores
# --------------------------------------------------------------------------


class HistoryStore:
    """Engine-facing read layer over one `TrainingHistory`."""

    kind = "abstract"

    placement: Optional[PlacementPolicy] = None

    @staticmethod
    def create(history: TrainingHistory,
               placement: Optional[PlacementPolicy] = None,
               window: int = 0, decode: str = "auto") -> "HistoryStore":
        """stacked -> `ResidentStore` (on `placement`'s mesh, when given);
        host/disk -> `SegmentStreamer` (``window`` steps per window, 0:
        auto; ``decode`` its read path), or `ShardedStreamer` on a
        placement of more than one rank."""
        if history.tier in ("host", "disk"):
            if placement is not None and placement.size > 1:
                return ShardedStreamer(history, placement, window=window,
                                       decode=decode)
            return SegmentStreamer(history, window=window, decode=decode)
        return ResidentStore(history, placement=placement)

    def span_end(self, t: int, t2: int) -> int:
        """Largest b <= t2 such that [t, b) fits one `window()`."""
        raise NotImplementedError

    def window(self, a: int, b: int) -> Tuple[Window, Window, int]:
        raise NotImplementedError

    def entry(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def hbm_high_water(self) -> int:
        """Most history bytes this store held on the device at once."""
        raise NotImplementedError

    def commit(self, rewrites: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
               final_params) -> None:
        """Land an online request's deferred rewrites {t: (w_t, g_t)} (flat
        device rows) in the history, and finalize `final_params` there."""
        raise NotImplementedError

    def sharded_replay(self) -> Optional[ShardedReplay]:
        """The mesh read path when the store is placed on a mesh."""
        return None

    def close(self) -> None:
        """Stop the store's threads and drop its device windows."""


class ResidentStore(HistoryStore):
    """The whole path on the device: the history's (T, p) tensors, or, on
    a placement, the rank's packed shard of them (T, p_rank), copied once.
    The history keeps its own rows where the recording put them."""

    kind = "resident"

    def __init__(self, history: TrainingHistory,
                 placement: Optional[PlacementPolicy] = None):
        self.history = history
        self.placement = placement
        self.W, self.G = history.stacked_view()
        self._sharded: Optional[ShardedReplay] = None
        if placement is not None:
            self._sharded = ShardedReplay(self)
            self._cols = torch.from_numpy(self._sharded.shard.index).to(
                self.W.device)
            self.W = self.W.index_select(1, self._cols)
            self.G = self.G.index_select(1, self._cols)

    def span_end(self, t: int, t2: int) -> int:
        return t2  # the whole path is resident; never split a segment

    def window(self, a: int, b: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        return self.W, self.G, 0

    def entry(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._sharded is not None:
            return self._sharded.entry_at(self.W, self.G, t)
        return self.W[t], self.G[t]

    def sharded_replay(self) -> Optional[ShardedReplay]:
        return self._sharded

    def hbm_high_water(self) -> int:
        """The device bytes of the store's (T, p) or (T, p_rank) tensors."""
        return 2 * self.W.numel() * self.W.element_size()

    def commit(self, rewrites, final_params) -> None:
        """One scatter per quantity into the history's resident (T, p)
        tensors, in place (the request read every row it rewrites before
        this), and into the rank's packed shard on a placement."""
        W, G = self.history.stacked_view()
        if rewrites:
            ts = sorted(rewrites)
            idx = torch.tensor(ts, device=W.device)
            w_rows = torch.stack([rewrites[t][0] for t in ts])
            g_rows = torch.stack([rewrites[t][1] for t in ts])
            W.index_copy_(0, idx, w_rows)
            G.index_copy_(0, idx, g_rows)
            if self._sharded is not None:
                self.W.index_copy_(0, idx, w_rows.index_select(1, self._cols))
                self.G.index_copy_(0, idx, g_rows.index_select(1, self._cols))
        self.history.replace_from_stacked(W, G, final_params=final_params)


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16,  # bf16 bit patterns
                 np.dtype(np.int64): torch.int64}


class _Staged(NamedTuple):
    """A window on its way: device tensors, the event of their copy, and
    the pinned host buffers the copy reads (keyed for reuse)."""

    dev: Dict[str, torch.Tensor]
    event: Optional[torch.cuda.Event]
    host: Dict[str, Tuple[tuple, torch.Tensor]]
    kidx_np: Optional[np.ndarray]
    nbytes: int  # device bytes of the window as staged


class SegmentStreamer(HistoryStore):
    """Serve a host/disk-tier history to the replay in device windows with
    asynchronous, double-buffered host-to-device copies (module note)."""

    kind = "streamed"
    _cols: Optional[np.ndarray] = None  # the columns staged (None: all)

    def __init__(self, history: TrainingHistory, window: int = 0,
                 decode: str = "auto", max_prefetch: int = 4,
                 stage_threads: Optional[int] = None):
        if history.tier not in ("host", "disk"):
            raise ValueError(f"SegmentStreamer serves host/disk tiers, got "
                             f"{history.tier!r}")
        if decode not in DECODE_MODES:
            raise ValueError(
                f"unknown decode mode {decode!r}; pick 'fetch' (decode "
                "windows to f32 on arrival), 'kernel' (keep windows "
                "encoded on device, dequantize per step in the replay), or "
                "'auto' (kernel for every non-f32 codec)")
        self.history = history
        # f32 windows have nothing to decode: kernel mode IS fetch mode
        if history.codec.name == "f32":
            decode = "fetch"
        elif decode == "auto":
            decode = "kernel"
        self.decode_mode = decode
        self.T = len(history)
        self.window_len = auto_window(self.T, window)
        self.device = history.device
        self._cuda = self.device.type == "cuda"
        self._bounds = history.bounds
        # depth > 1 pays only when that many windows stage at once, so the
        # depth cap is the worker count (default: the spare cores)
        workers = stage_threads if stage_threads is not None \
            else (os.cpu_count() or 2) - 1
        self.max_prefetch = max(1, min(int(max_prefetch), int(workers)))
        self._pool = ThreadPoolExecutor(max_workers=self.max_prefetch,
                                        thread_name_prefix="history-stage")
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._pinned: List[Tuple[tuple, torch.Tensor, Optional[torch.cuda.Event]]] = []
        self._lock = threading.Lock()  # the pinned pool and the meters
        self._buf: Dict[int, Tuple[Window, Window, int]] = {}  # W, G, bytes
        self._inflight: Dict[int, Future] = {}
        # device bytes: windows handed out (_hbm_now) and windows staged but
        # not yet fetched (_inflight_bytes, counted by the staging threads)
        self._hbm_now = 0
        self._inflight_bytes = 0
        self._hbm_high = 0
        self.enc_bytes_high = 0
        # decoded f32 bytes over staged bytes, summed over every window
        # fetched (a short tail window alone would misstate it)
        self.compression_ratio = 1.0
        self._decoded_total = 0
        self._staged_total = 0
        self.windows_fetched = 0
        self.prefetch_hits = 0
        self.host_wait_s = 0.0
        self.host_stage_high = 0  # host bytes of the largest staged window
        self.depth_used = 1  # the deepest prefetch chosen
        self._stack_ema = 0.0  # EMAs of staging time and of the replay
        self._scan_ema = 0.0  # time between two window() calls (seconds)
        self._last_return_ts: Optional[float] = None

    # -- staging (worker threads) ------------------------------------------------

    def _wid(self, t: int) -> int:
        return t // self.window_len

    def _window_bounds(self, wid: int) -> Tuple[int, int]:
        a = wid * self.window_len
        return a, min(self.T, a + self.window_len)

    def span_end(self, t: int, t2: int) -> int:
        return min(t2, self._window_bounds(self._wid(t))[1])

    def _host_buffer(self, name: str, shape: tuple, dtype) -> Tuple[tuple, torch.Tensor]:
        """A host buffer for one staged array: pinned on the card's machine,
        taken from the pool once the copy that last read it has finished."""
        key = (name, shape, dtype)
        if not self._cuda:
            return key, torch.empty(shape, dtype=dtype)
        with self._lock:
            for i, (k, buf, event) in enumerate(self._pinned):
                if k == key:
                    del self._pinned[i]
                    break
            else:
                return key, torch.empty(shape, dtype=dtype, pin_memory=True)
        if event is not None:
            event.synchronize()  # its last copy to the device is done
        return key, buf

    def _stage_window(self, wid: int) -> _Staged:
        """Stack the window's ENCODED rows (and, for the delta codecs, its
        keyframes) into host buffers, and start their copy to the device
        on the side stream."""
        a, b = self._window_bounds(wid)
        rows = [self.history.encoded_entry(t) for t in range(a, b)]
        host: Dict[str, Tuple[tuple, torch.Tensor]] = {}

        def put(name: str, arrays: List[np.ndarray], cut: bool = False) -> None:
            """Stack `arrays` into a host buffer; with `cut`, only the
            columns `_cols` (a mesh rank's packed shard) of each row."""
            first = arrays[0]
            cols = self._cols if cut else None
            shape = first.shape if cols is None else cols.shape
            key, buf = self._host_buffer(name, (len(arrays),) + shape,
                                         _TORCH_DTYPES[first.dtype])
            view = buf.numpy()
            for i, x in enumerate(arrays):
                if cols is None:
                    view[i] = x
                else:
                    np.take(x, cols, out=view[i])
            host[name] = (key, buf)

        for i, name in enumerate(("w", "g")):
            put(f"{name}_q", [r[i].q for r in rows], cut=True)
            if rows[0][i].scale is not None:
                put(f"{name}_scale", [r[i].scale for r in rows])
        kidx_np = None
        if self.history.is_delta:
            K = self.history.key_interval
            kwids = range(a // K, (b - 1) // K + 1)
            bases = [self.history.base_entry(k) for k in kwids]
            put("w_base", [w for w, _ in bases], cut=True)
            put("g_base", [g for _, g in bases], cut=True)
            kidx_np = np.asarray([t // K - a // K for t in range(a, b)],
                                 np.int64)
            put("kidx", list(kidx_np))
        staged_bytes = sum(buf.numel() * buf.element_size()
                           for _, buf in host.values())
        with self._lock:
            self.host_stage_high = max(self.host_stage_high, staged_bytes)
            self._inflight_bytes += staged_bytes  # the same bytes on the device
            self._note_high()
        if not self._cuda:
            return _Staged({k: buf for k, (_, buf) in host.items()}, None,
                           {}, kidx_np, staged_bytes)
        with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
            dev = {k: buf.to(self.device, non_blocking=True)
                   for k, (_, buf) in host.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return _Staged(dev, event, host, kidx_np, staged_bytes)

    def _note_high(self) -> None:
        """Call with `_lock` held."""
        self._hbm_high = max(self._hbm_high, self._hbm_now + self._inflight_bytes)

    def _landed(self, staged: _Staged, now_bytes: int) -> None:
        """A staged window's bytes leave the in-flight count; `now_bytes`
        of it stay on the device as a handed-out window."""
        with self._lock:
            self._inflight_bytes -= staged.nbytes
            self._hbm_now += now_bytes
            self._note_high()

    def _stack_host(self, wid: int) -> _Staged:
        """`_stage_window` and the staging-time EMA the prefetch depth
        follows."""
        t0 = time.perf_counter()
        with obs_trace.span("store.window_stage", wid=wid):
            staged = self._stage_window(wid)
        dt = time.perf_counter() - t0
        with self._lock:
            self._stack_ema = dt if self._stack_ema == 0.0 \
                else 0.5 * self._stack_ema + 0.5 * dt
        return staged

    # -- the read path (the engine's thread) -----------------------------------

    def _as_window(self, dev: Dict[str, torch.Tensor], name: str,
                   kidx_np) -> Window:
        q = dev[f"{name}_q"]
        if self.history.codec.name == "f32":
            return q
        if q.dtype == torch.int16:
            q = q.view(torch.bfloat16)
        base = dev.get(f"{name}_base")
        return EncodedWindow(
            q=q, scale=dev.get(f"{name}_scale"), base=base,
            kidx=dev.get("kidx"),
            kidx_np=kidx_np, bounds=self._bounds)

    def _fetch(self, wid: int) -> Tuple[Window, Window]:
        if wid in self._buf:
            return self._buf[wid][:2]
        reg = obs_metrics.get_registry()
        fut = self._inflight.pop(wid, None)
        t0 = time.perf_counter()
        if fut is not None:
            with obs_trace.span("store.prefetch_wait", wid=wid):
                staged = fut.result()
        else:
            staged = self._stack_host(wid)
        wait = time.perf_counter() - t0
        self.host_wait_s += wait
        if fut is not None:
            self.prefetch_hits += 1
            reg.counter("store.prefetch_hits", owner="core.store").inc()
        reg.counter("store.host_wait_s", unit="s", owner="core.store").inc(wait)
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(staged.event)
            for t in staged.dev.values():
                t.record_stream(compute)  # allocated on the side stream
            with self._lock:
                self._pinned.extend((key, buf, staged.event)
                                    for key, buf in staged.host.values())
        W = self._as_window(staged.dev, "w", staged.kidx_np)
        G = self._as_window(staged.dev, "g", staged.kidx_np)
        self.enc_bytes_high = max(self.enc_bytes_high, staged.nbytes)
        nbytes = staged.nbytes  # W and G share the kidx tensor
        if isinstance(W, EncodedWindow):
            self._decoded_total += W.decoded_nbytes() + G.decoded_nbytes()
            self._staged_total += staged.nbytes
            self.compression_ratio = self._decoded_total / self._staged_total
            if self.decode_mode == "fetch":
                W, G = decode_window(W), decode_window(G)
                nbytes = W.numel() * 4 + G.numel() * 4
                with self._lock:  # the encoded window lives until here
                    self._hbm_high = max(self._hbm_high, self._hbm_now
                                         + self._inflight_bytes + nbytes)
        self._buf[wid] = (W, G, nbytes)
        self._landed(staged, nbytes)
        self.windows_fetched += 1
        reg.counter("store.windows_fetched", owner="core.store").inc()
        return W, G

    def _evict_before(self, wid: int) -> None:
        for old in [w for w in self._buf if w < wid]:
            nbytes = self._buf.pop(old)[2]
            with self._lock:
                self._hbm_now -= nbytes
        for old in [w for w in self._inflight if w < wid]:
            self._drop(self._inflight.pop(old))

    def _drop(self, fut: Future) -> None:
        """Forget a staged window that will not be fetched."""
        fut.add_done_callback(
            lambda f: (not f.cancelled() and f.exception() is None
                       and self._landed(f.result(), 0)))

    def _prefetch(self, wid: int) -> None:
        if (wid in self._buf or wid in self._inflight
                or wid * self.window_len >= self.T):
            return
        self._inflight[wid] = self._pool.submit(self._stack_host, wid)

    def _choose_depth(self) -> int:
        """1 while staging keeps up with the replay; ceil(stage / replay)
        windows once staging is measurably (over 1 ms) slower, but no more
        than `STAGE_BUDGET` bytes of staged windows."""
        if (self._scan_ema <= 0.0 or self._stack_ema <= 1e-3
                or self._stack_ema <= self._scan_ema):
            return 1
        cap = self.max_prefetch
        if self.host_stage_high:
            cap = min(cap, STAGE_BUDGET // self.host_stage_high)
        return max(1, min(cap, int(np.ceil(self._stack_ema / self._scan_ema))))

    def window(self, a: int, b: int) -> Tuple[Window, Window, int]:
        now = time.perf_counter()
        if self._last_return_ts is not None:
            # the time since the last window was handed out ~ the replay
            # time that consumed it
            dt = now - self._last_return_ts
            self._scan_ema = dt if self._scan_ema == 0.0 \
                else 0.5 * self._scan_ema + 0.5 * dt
        wid = self._wid(a)
        if b > self._window_bounds(wid)[1]:
            raise ValueError(f"steps [{a}, {b}) cross the window of "
                             f"{self.window_len} steps at {wid}")
        with obs_trace.span("store.window", wid=wid,
                            hit=wid in self._buf or wid in self._inflight):
            W, G = self._acquire(wid)
        obs_metrics.get_registry().gauge(
            "store.hbm_high_water_bytes", unit="B",
            owner="core.store").set_max(self._hbm_high)
        self._last_return_ts = time.perf_counter()
        return W, G, wid * self.window_len

    def _acquire(self, wid: int) -> Tuple[Window, Window]:
        """Window `wid` on the device: evict the ones before it, fetch it,
        and start staging the next ones."""
        self._evict_before(wid)
        W, G = self._fetch(wid)
        depth = self._choose_depth()
        self.depth_used = max(self.depth_used, depth)
        for ahead in range(1, depth + 1):
            self._prefetch(wid + ahead)
        return W, G

    def entry(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Step t's rows for an explicit step, read from its window like
        an approx segment's (fetched, with the next ones prefetched, if it
        is not on the device yet), so no row takes a pageable copy of its
        own."""
        wid = self._wid(t)
        if wid not in self._buf:
            self._acquire(wid)
        W, G, _ = self._buf[wid]
        return _row(W, G, t - wid * self.window_len)

    def hbm_high_water(self) -> int:
        return self._hbm_high

    def commit(self, rewrites, final_params) -> None:
        """Write the rows back through the codec (`TrainingHistory.
        overwrite`), after the windows staging in the background have
        finished reading the rows they replace; then drop every window on
        the device or staged, which holds rows from before the request."""
        for fut in self._inflight.values():
            fut.exception()  # wait; a failed read of stale rows is harmless
        self._evict_before(self.T)  # window ids are below T
        if rewrites:
            ts = sorted(rewrites)
            ws = torch.stack([rewrites[t][0] for t in ts]).cpu().numpy()
            gs = torch.stack([rewrites[t][1] for t in ts]).cpu().numpy()
            for i, t in enumerate(ts):
                self.history.overwrite(t, ws[i], gs[i])
        self.history.finalize(final_params)

    def close(self) -> None:
        for fut in self._inflight.values():
            self._drop(fut)
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._inflight.clear()
        self._buf.clear()
        self._hbm_now = 0


class ShardedStreamer(SegmentStreamer):
    """A host/disk-tier history on a mesh: `SegmentStreamer` staging and
    uploading only this rank's packed slice of every window (the f32 rows,
    or the codes and the keyframes' slices; the per-leaf scales whole), so
    the device holds about two windows of the SHARD.  The windows' leaf
    offsets are the packed shard's, so a packed encoded row decodes with
    the one expression.  Explicit steps and approx steps read through the
    same `ShardedReplay` gather as a mesh-placed `ResidentStore`, which
    keeps the streamed and resident replays bitwise equal.  Online
    rewrites go back through the codec into the history's own entries,
    like `SegmentStreamer`'s; the slices are staged anew from them."""

    kind = "sharded_streamed"

    def __init__(self, history: TrainingHistory, placement: PlacementPolicy,
                 window: int = 0, decode: str = "auto", max_prefetch: int = 4,
                 stage_threads: Optional[int] = None):
        placement.check_world()
        super().__init__(history, window=window, decode=decode,
                         max_prefetch=max_prefetch, stage_threads=stage_threads)
        self.placement = placement
        self._sharded = ShardedReplay(self)
        self._cols = self._sharded.shard.index
        self._bounds = self._sharded.shard.bounds

    def entry(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        w, g = super().entry(t)
        return self._sharded.gather(w), self._sharded.gather(g)

    def sharded_replay(self) -> Optional[ShardedReplay]:
        return self._sharded
