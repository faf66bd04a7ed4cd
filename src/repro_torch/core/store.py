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
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.history import TrainingHistory
from repro_torch.kernels.dequant_update.ref import dequant_ref
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

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


# --------------------------------------------------------------------------
# Stores
# --------------------------------------------------------------------------


class HistoryStore:
    """Engine-facing read layer over one `TrainingHistory`."""

    kind = "abstract"

    @staticmethod
    def create(history: TrainingHistory, window: int = 0,
               decode: str = "auto") -> "HistoryStore":
        """stacked -> `ResidentStore`; host/disk -> `SegmentStreamer`
        (``window`` steps per window, 0: auto; ``decode`` its read path)."""
        if history.tier in ("host", "disk"):
            return SegmentStreamer(history, window=window, decode=decode)
        return ResidentStore(history)

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

    def close(self) -> None:
        """Stop the store's threads and drop its device windows."""


class ResidentStore(HistoryStore):
    kind = "resident"

    def __init__(self, history: TrainingHistory):
        self.history = history
        self.W, self.G = history.stacked_view()

    def span_end(self, t: int, t2: int) -> int:
        return t2  # the whole path is resident; never split a segment

    def window(self, a: int, b: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        return self.W, self.G, 0

    def entry(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.W[t], self.G[t]

    def hbm_high_water(self) -> int:
        return self.history.nbytes()

    def commit(self, rewrites, final_params) -> None:
        """One scatter per quantity into the resident (T, p) tensors, in
        place (the request read every row it rewrites before this)."""
        if rewrites:
            ts = sorted(rewrites)
            idx = torch.tensor(ts, device=self.W.device)
            self.W.index_copy_(0, idx, torch.stack([rewrites[t][0] for t in ts]))
            self.G.index_copy_(0, idx, torch.stack([rewrites[t][1] for t in ts]))
        self.history.replace_from_stacked(self.W, self.G,
                                          final_params=final_params)


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

        def put(name: str, arrays: List[np.ndarray]) -> None:
            first = arrays[0]
            key, buf = self._host_buffer(name, (len(arrays),) + first.shape,
                                         _TORCH_DTYPES[first.dtype])
            view = buf.numpy()
            for i, x in enumerate(arrays):
                view[i] = x
            host[name] = (key, buf)

        for i, name in enumerate(("w", "g")):
            put(f"{name}_q", [r[i].q for r in rows])
            if rows[0][i].scale is not None:
                put(f"{name}_scale", [r[i].scale for r in rows])
        kidx_np = None
        if self.history.is_delta:
            K = self.history.key_interval
            kwids = range(a // K, (b - 1) // K + 1)
            bases = [self.history.base_entry(k) for k in kwids]
            put("w_base", [w for w, _ in bases])
            put("g_base", [g for _, g in bases])
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
        i = t - wid * self.window_len
        if isinstance(W, EncodedWindow):
            return decode_row(W, i), decode_row(G, i)
        return W[i], G[i]

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
