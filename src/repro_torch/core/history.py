"""The optimization-path cache (w_t, g_t) of the original training run.

Rows are flat, in the parameter order of `utils.tree.FlatParams` (jax's
``ravel_pytree`` order); ``bounds`` are the leaves' offsets in that row.

Storage tiers:

  ``stacked``  two (T, p) f32 tensors on the device, written by the
               recording loop and read in place by the replay
               (`core.store.ResidentStore`);
  ``host``     entries offloaded to host RAM, encoded by a codec (the
               paper's choice: the device is freed of the path), and
               streamed to the replay in windows (`core.store.
               SegmentStreamer`);
  ``disk``     like ``host``, spilled as one ``.npz`` per ``spill_window``
               steps under ``spill_dir`` (``"auto"``: a fresh tempdir,
               removed when the process exits).

On a mesh (`core.store.PlacementPolicy`, every rank holding the whole
history it recorded), the replay's store keeps per rank only its PACKED
SHARD of each row, the positions of its slice of every leaf
(`dist.sharding.shard_index`): ``stacked`` through a mesh-placed
`core.store.ResidentStore`, 2 T p_rank f32 on the device (p_rank = p / the
mesh factor on the sharded leaves; replicated leaves whole), and ``host``
or ``disk`` through `core.store.ShardedStreamer`, which stages and uploads
only the rank's slice of each window, about two windows of the shard on
the device.

Codecs (host and disk; ``stacked`` stores only f32), per param per step
with both w_t and g_t counted:

  ``f32``         8 B     the rows as they are
  ``bf16``        4 B     round to nearest even
  ``int8``        ~2 B    symmetric per-leaf absmax: q = round(x / s),
                          s = max|x| / 127 (1.0 for an all-zero leaf)
  ``delta_bf16``  ~4 B    bf16 / int8 residual x_t - base against an f32
  ``delta_int8``  ~2.5 B  keyframe, the first entry of t's key window
                          (t // 16); bases are immutable once taken

Every stored row is an `Encoded` pair ``(q, scale)``: q (p,) f32, bf16 (as
its int16 bit pattern: numpy has no bfloat16) or int8, scale (n_leaves,)
f32 or None.  Decoding is `kernels.dequant_update.ref.dequant_ref`, the
one expression ``q.float() * scale (+ base)`` that every read path uses.
The codecs are the port's copy of the JAX package's, bitwise: the int8
encode is its expression, applied leaf by leaf.  Each codec encodes a
torch row on the row's own device (``encode_tensor``; a delta codec's
residual too), so a recording on the card copies only the codes to the
host; a numpy row goes through the same code on the CPU.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.dequant_update.ref import dequant_ref
from repro_torch.utils.tree import FlatParams, flatten_nested, key_order


@dataclass
class HistoryMeta:
    """Everything needed to replay the original training run."""

    n: int  # dataset size during original training
    batch_size: int  # B (== n for deterministic GD)
    seed: int  # sampler seed
    steps: int  # T
    lr_schedule: Tuple[Tuple[int, float], ...]  # piecewise-constant (from_step, lr)
    momentum: float = 0.0  # heavy-ball: vel <- mom vel + g; w <- w - lr vel

    def lr_at(self, t: int) -> float:
        lr = self.lr_schedule[0][1]
        for start, value in self.lr_schedule:
            if t >= start:
                lr = value
        return lr


def leaf_bounds(shapes: Mapping[str, Tuple[int, ...]]) -> Tuple[int, ...]:
    """(0, e_1, ..., p): the leaves' offsets in the flat row."""
    out = [0]
    for k in key_order(shapes):
        out.append(out[-1] + int(np.prod(shapes[k], dtype=np.int64)))
    return tuple(out)


# --------------------------------------------------------------------------
# Codecs
# --------------------------------------------------------------------------


class Encoded(NamedTuple):
    """One stored row: q (p,) and the per-leaf scale (n_leaves,) or None."""

    q: np.ndarray
    scale: Optional[np.ndarray] = None

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + (0 if self.scale is None else self.scale.nbytes)


def q_tensor(q: np.ndarray) -> torch.Tensor:
    """A stored q as a torch tensor of its codec's type (bf16 bit patterns
    are int16 in numpy and reinterpreted here, without a copy)."""
    t = torch.from_numpy(q)
    return t.view(torch.bfloat16) if t.dtype == torch.int16 else t


class F32Codec:
    name = "f32"

    def encode(self, row: np.ndarray, bounds) -> Encoded:
        return Encoded(np.asarray(row, dtype=np.float32))  # no copy: rows come fresh

    def encode_tensor(self, row: torch.Tensor, bounds) -> Encoded:
        return Encoded(_host_copy(row))


class BF16Codec:
    name = "bf16"

    def encode(self, row: np.ndarray, bounds) -> Encoded:
        x = torch.from_numpy(np.ascontiguousarray(row, dtype=np.float32))
        return self.encode_tensor(x, bounds)

    def encode_tensor(self, row: torch.Tensor, bounds) -> Encoded:
        return Encoded(row.to(torch.bfloat16).view(torch.int16).cpu().numpy())


class Int8Codec:
    """Symmetric per-leaf absmax int8 quantization."""

    name = "int8"

    def encode_tensor(self, row: torch.Tensor, bounds) -> Encoded:
        """The JAX package's expression on each leaf, on the row's device:
        the scale is max |x| / 127 in f32 (1 for an empty or all-zero
        leaf), and q = clip(round_half_even(x / scale), -127, 127).  Both
        divisions take a device tensor as divisor: on the card a CPU scalar
        divisor would turn the division into a product by its reciprocal,
        which rounds differently."""
        row = row.detach().float()
        q = torch.empty(row.shape, dtype=torch.int8, device=row.device)
        scales = torch.ones(len(bounds) - 1, device=row.device)
        c127 = torch.tensor(127.0, device=row.device)
        for i, (a, b) in enumerate(zip(bounds, bounds[1:])):
            if b == a:
                continue
            x = row[a:b]
            scale = x.abs().amax() / c127
            scale = torch.where(scale > 0, scale, scales[i])
            q[a:b] = torch.round(x / scale).clamp_(-127, 127)
            scales[i] = scale
        return Encoded(q.cpu().numpy(), scales.cpu().numpy())

    def encode(self, row: np.ndarray, bounds) -> Encoded:
        return self.encode_tensor(
            torch.from_numpy(np.ascontiguousarray(row, dtype=np.float32)), bounds)


class DeltaCodec:
    """Entry t stored as ``inner(x_t - base)`` against the f32 keyframe of
    its key window (t // key_interval), which `TrainingHistory` takes once
    and keeps: any entry decodes in O(1) from (residual, base)."""

    inner_cls: type = Int8Codec
    name = "delta_int8"
    key_interval = 16

    def __init__(self):
        self.inner = self.inner_cls()

    def encode(self, row, bounds):
        raise ValueError(
            f"codec {self.name!r} stores residuals against a per-key-window "
            "keyframe base; use encode_delta, or go through TrainingHistory "
            "which manages the bases")

    def encode_delta(self, row: np.ndarray, base: np.ndarray,
                     bounds) -> Encoded:
        return self.inner.encode(np.asarray(row, dtype=np.float32) - base,
                                 bounds)

    def encode_delta_tensor(self, row: torch.Tensor, base: torch.Tensor,
                            bounds) -> Encoded:
        """`encode_delta` on the row's device (the base on it too)."""
        return self.inner.encode_tensor(row.detach().float() - base, bounds)


class DeltaInt8Codec(DeltaCodec):
    inner_cls = Int8Codec
    name = "delta_int8"


class DeltaBF16Codec(DeltaCodec):
    inner_cls = BF16Codec
    name = "delta_bf16"


CODECS = {"f32": F32Codec, "bf16": BF16Codec, "int8": Int8Codec,
          "delta_int8": DeltaInt8Codec, "delta_bf16": DeltaBF16Codec}

# marks a `TrainingHistory.state_dict` of this package (the JAX package's
# state has no "format" key)
STATE_FORMAT = "repro_torch/1"


def _host_copy(x: torch.Tensor) -> np.ndarray:
    """A numpy copy that later in-place rewrites of `x` leave alone (a
    CPU tensor's ``.numpy()`` would share its memory)."""
    return x.detach().to("cpu", copy=True).numpy()


# --------------------------------------------------------------------------
# History
# --------------------------------------------------------------------------


class TrainingHistory:
    """Per-step (w_t, g_t) cache with tiered storage (see the module note).

    ``device`` is where the recording ran and where `entry` decodes to."""

    def __init__(self, meta: HistoryMeta, tier: str = "stacked",
                 codec: str = "f32", spill_dir: Optional[str] = None,
                 spill_window: int = 0, device=None):
        if tier not in ("stacked", "host", "disk"):
            raise ValueError(
                f"unknown history tier {tier!r}; pick one of 'stacked' "
                "(device-resident, fastest replay), 'host' (entries offloaded "
                "to host RAM, streamed to the replay per window), or 'disk' "
                "(.npz spill under spill_dir)")
        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r}; pick one of "
                             f"{sorted(CODECS)}")
        if codec != "f32" and tier == "stacked":
            raise ValueError(
                f"codec={codec!r} has no effect on tier='stacked': stacked "
                "storage keeps the exact rows the recording loop produced.  "
                "Use tier='host' (or 'disk') to store the path "
                f"{codec}-compressed (the SegmentStreamer still serves it to "
                "the replay), or drop the codec")
        if tier == "disk":
            if spill_dir is None:
                raise ValueError(
                    "tier='disk' spills every history entry to .npz files "
                    "and needs somewhere to put them: pass "
                    "spill_dir=<directory> (created if missing), or "
                    "spill_dir='auto' to opt into a fresh temporary "
                    "directory (removed when the process exits)")
            if spill_dir == "auto":
                import atexit
                import tempfile
                spill_dir = tempfile.mkdtemp(prefix="repro_torch_history_")
                atexit.register(shutil.rmtree, spill_dir, ignore_errors=True)
            os.makedirs(spill_dir, exist_ok=True)
        self.meta = meta
        self.tier = tier
        self.codec = CODECS[codec]()
        self.spill_dir = spill_dir
        self._device = None if device is None else torch.device(device)
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.final_params: Optional[FlatParams] = None
        # stacked tier: (T, p) f32 device tensors
        self.W: Optional[torch.Tensor] = None
        self.G: Optional[torch.Tensor] = None
        # host tier: encoded (w_t, g_t) rows
        self._enc: List[Tuple[Encoded, Encoded]] = []
        # delta codecs: key window -> (base_w, base_g) f32 keyframes
        self._bases: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        # the latest key window's bases on the recording's device
        self._dev_base: Optional[Tuple[int, torch.Tensor, torch.Tensor]] = None
        # disk tier: one .npz per spill_window steps (0: the stream window
        # `core.store.auto_window` would pick)
        if tier == "disk":
            spill_window = int(spill_window) or min(meta.steps, 32)
            if spill_window < 1:
                raise ValueError(f"spill_window must be >= 1, got {spill_window}")
        self.spill_window = spill_window if tier == "disk" else 0
        self._n = 0  # entries appended (host/disk)
        self._win_paths: List[str] = []
        self._spill_buf: List[Tuple[Encoded, Encoded]] = []
        self._spill_flushed = 0  # steps already on disk
        self._win_cache: Optional[Tuple[int, List[Tuple[Encoded, Encoded]]]] = None
        self._disk_lock = threading.Lock()  # the streamer reads from threads
        self.io_read_s = 0.0  # cumulative spill IO wall time
        self.io_write_s = 0.0

    def __len__(self) -> int:
        if self.tier == "stacked":
            return 0 if self.W is None else self.W.shape[0]
        return self._n

    @property
    def device(self) -> torch.device:
        if self.tier == "stacked" and self.W is not None:
            return self.W.device
        if self._device is None:
            raise ValueError("the history has no device yet")
        return self._device

    @property
    def bounds(self) -> Tuple[int, ...]:
        return leaf_bounds(self.shapes)

    @property
    def is_delta(self) -> bool:
        return isinstance(self.codec, DeltaCodec)

    @property
    def key_interval(self) -> int:
        return self.codec.key_interval if self.is_delta else 0

    # -- write path ------------------------------------------------------------

    def set_stacked(self, W: torch.Tensor, G: torch.Tensor,
                    final_params: FlatParams) -> None:
        """Adopt (W, G), the recording loop's (T, p) buffers, as the cache."""
        if self.tier != "stacked":
            raise ValueError(f"set_stacked on a {self.tier!r}-tier history")
        if W.shape != G.shape or W.dim() != 2:
            raise ValueError(f"W {tuple(W.shape)} and G {tuple(G.shape)} "
                             "must be equal (T, p)")
        self.W, self.G = W, G
        self.shapes = dict(final_params.shapes)
        self.final_params = final_params

    def set_layout(self, shapes: Mapping[str, Tuple[int, ...]],
                   device) -> None:
        """The parameter layout and device of an offload-tier history,
        before its first `append`."""
        self.shapes = {k: tuple(shapes[k]) for k in key_order(shapes)}
        self._device = torch.device(device)

    def base_entry(self, kwid: int) -> Tuple[np.ndarray, np.ndarray]:
        """(base_w, base_g) f32 keyframes of key window `kwid`."""
        return self._bases[kwid]

    def _base_for(self, t: int, w=None, g=None) -> Tuple[np.ndarray, np.ndarray]:
        kwid = t // self.codec.key_interval
        if kwid not in self._bases:
            if w is None:
                raise KeyError(f"no keyframe base for key window {kwid} "
                               f"(entry {t})")
            self._bases[kwid] = (np.array(w, dtype=np.float32),
                                 np.array(g, dtype=np.float32))
        return self._bases[kwid]

    def _device_base(self, t: int, w: torch.Tensor,
                     g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Entry t's keyframes on the rows' device: the latest key
        window's are kept there (taken from the rows themselves when they
        open a key window), so a recording copies each base once."""
        kwid = t // self.codec.key_interval
        if kwid not in self._bases:
            self._bases[kwid] = (_host_copy(w), _host_copy(g))
            self._dev_base = (kwid, w.detach().float().clone(),
                              g.detach().float().clone())
        elif (self._dev_base is None or self._dev_base[0] != kwid
              or self._dev_base[1].device != w.device):
            self._dev_base = (kwid,) + tuple(
                torch.from_numpy(b).to(w.device) for b in self._bases[kwid])
        return self._dev_base[1], self._dev_base[2]

    def _encode_pair(self, t: int, w, g) -> Tuple[Encoded, Encoded]:
        """Rows w_t, g_t through the codec: torch rows on their device
        (only the codes are copied to the host), numpy rows on the host (a
        fresh row, which the f32 codec keeps)."""
        bounds = self.bounds
        if isinstance(w, torch.Tensor):
            if self.is_delta:
                bw, bg = self._device_base(t, w, g)
                return (self.codec.encode_delta_tensor(w, bw, bounds),
                        self.codec.encode_delta_tensor(g, bg, bounds))
            return (self.codec.encode_tensor(w, bounds),
                    self.codec.encode_tensor(g, bounds))
        if self.is_delta:
            bw, bg = self._base_for(t, w, g)
            return (self.codec.encode_delta(w, bw, bounds),
                    self.codec.encode_delta(g, bg, bounds))
        return self.codec.encode(w, bounds), self.codec.encode(g, bounds)

    def append(self, w, g) -> None:
        """Encode and store entry t = len(self): rows (p,) of w_t, g_t, as
        torch tensors (encoded on their device; the caller may reuse them
        afterwards) or as host rows that nothing else writes (the f32
        codec keeps them as they are)."""
        if self.tier == "stacked":
            raise ValueError("append on a stacked history: the recording "
                             "loop hands it whole to set_stacked")
        if not self.shapes:
            raise ValueError("set_layout before the first append")
        pair = self._encode_pair(self._n, w, g)
        self._n += 1
        if self.tier == "host":
            self._enc.append(pair)
        else:
            self._spill_buf.append(pair)
            self._flush_spill()  # no-op until a window is complete

    def finalize(self, final_params: FlatParams) -> None:
        self.final_params = final_params
        self._dev_base = None
        if self.tier == "disk":
            self._flush_spill(everything=True)

    # -- windowed disk spill ---------------------------------------------------

    def _win_path(self, wid: int) -> str:
        return os.path.join(self.spill_dir, f"win_{wid:07d}.npz")

    def _write_win(self, wid: int, entries: List[Tuple[Encoded, Encoded]]) -> None:
        """One member per quantity stacked over the window's steps."""
        arrays = {"t0": wid * self.spill_window, "steps": len(entries)}
        for i, name in enumerate(("w", "g")):
            arrays[f"{name}_q"] = np.stack([e[i].q for e in entries])
            if entries[0][i].scale is not None:
                arrays[f"{name}_scale"] = np.stack([e[i].scale for e in entries])
        t0 = time.perf_counter()
        np.savez(self._win_path(wid), **arrays)
        self.io_write_s += time.perf_counter() - t0

    def _flush_spill(self, everything: bool = False) -> None:
        """Write buffered appends as window files: complete windows only,
        unless `everything` (finalize) also flushes the partial tail."""
        W = self.spill_window
        while self._spill_buf:
            wid, off = divmod(self._spill_flushed, W)
            take = min(W - off, len(self._spill_buf))
            if not everything and off + take < W:
                return  # keep the partial tail buffered
            with self._disk_lock:
                entries = (list(self._load_win(wid)) if off else []) \
                    + self._spill_buf[:take]
                self._write_win(wid, entries)
                if wid >= len(self._win_paths):
                    self._win_paths.append(self._win_path(wid))
                self._win_cache = (wid, entries)
            self._spill_flushed += take
            self._spill_buf = self._spill_buf[take:]

    def _load_win(self, wid: int) -> List[Tuple[Encoded, Encoded]]:
        """Window `wid`'s entries (call with `_disk_lock` held)."""
        if self._win_cache is not None and self._win_cache[0] == wid:
            return self._win_cache[1]
        t0 = time.perf_counter()
        with np.load(self._win_paths[wid]) as data:
            cols = []
            for name in ("w", "g"):
                q = data[f"{name}_q"]
                s = data[f"{name}_scale"] if f"{name}_scale" in data else None
                cols.append([Encoded(q[e], None if s is None else s[e])
                             for e in range(int(data["steps"]))])
        self.io_read_s += time.perf_counter() - t0
        entries = list(zip(*cols))
        self._win_cache = (wid, entries)
        return entries

    # -- read path -------------------------------------------------------------

    def encoded_entry(self, t: int) -> Tuple[Encoded, Encoded]:
        """(w_t, g_t) in stored form: no decode, no device copy (the
        streamer's read path; offload tiers only)."""
        if self.tier == "stacked":
            raise ValueError("encoded_entry on a stacked history")
        if not 0 <= t < self._n:
            raise IndexError(f"history entry {t} of {self._n}")
        if self.tier == "host":
            return self._enc[t]
        if t >= self._spill_flushed:  # still buffered, not yet on disk
            return self._spill_buf[t - self._spill_flushed]
        wid, off = divmod(t, self.spill_window)
        with self._disk_lock:
            return self._load_win(wid)[off]

    def entry(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_t, g_t) as flat f32 rows on the history's device."""
        if self.tier == "stacked":
            if not 0 <= t < len(self):
                raise IndexError(f"history entry {t} of {len(self)}")
            return self.W[t], self.G[t]
        bases = self._base_for(t) if self.is_delta else (None, None)
        return tuple(self._decode(e, b)
                     for e, b in zip(self.encoded_entry(t), bases))

    def _decode(self, e: Encoded, base: Optional[np.ndarray]) -> torch.Tensor:
        dev = self.device
        q = q_tensor(e.q).to(dev, copy=True)  # never a view of the store
        scale = None if e.scale is None else torch.from_numpy(e.scale).to(dev)
        b = None if base is None else torch.from_numpy(base).to(dev)
        return dequant_ref(q, scale, self.bounds, b)

    # -- in-place rewrite (online requests, Algorithm 3) ------------------------

    def overwrite(self, t: int, w, g) -> None:
        """Replace entry t with rows (p,) of w_t, g_t (tensors or numpy).
        Stacked: written into the (T, p) tensors in place.  Host and disk:
        encoded again through the codec, a delta codec against the entry's
        own keyframe (bases never change, so a rewrite stays local); the
        disk tier writes the entry's window file back."""
        if not 0 <= t < len(self):
            raise IndexError(f"history entry {t} of {len(self)}")
        if self.tier == "stacked":
            self.W[t] = torch.as_tensor(w, device=self.W.device)
            self.G[t] = torch.as_tensor(g, device=self.G.device)
            return

        def host(x) -> np.ndarray:  # a fresh row, which the codec may keep
            if isinstance(x, torch.Tensor):
                return _host_copy(x)
            return np.array(x, dtype=np.float32)

        pair = self._encode_pair(t, host(w), host(g))
        if self.tier == "host":
            self._enc[t] = pair
            return
        if t >= self._spill_flushed:  # still buffered, not yet on disk
            self._spill_buf[t - self._spill_flushed] = pair
            return
        wid, off = divmod(t, self.spill_window)
        with self._disk_lock:
            entries = list(self._load_win(wid))
            entries[off] = pair
            self._write_win(wid, entries)
            self._win_cache = (wid, entries)

    def replace_from_stacked(self, W: torch.Tensor, G: torch.Tensor,
                             final_params: Optional[FlatParams] = None) -> None:
        """Rewrite the whole cache from (T, p) rows; with `final_params`,
        finalize the post-request model in the same call.  Stacked: adopts
        (W, G) as its tensors; host and disk: every entry through
        `overwrite`."""
        if W.shape != G.shape or W.dim() != 2 or W.shape[0] != len(self):
            raise ValueError(f"W {tuple(W.shape)} and G {tuple(G.shape)} "
                             f"must be equal ({len(self)}, p)")
        if self.tier == "stacked":
            self.W, self.G = W, G
        else:
            for t in range(W.shape[0]):
                self.overwrite(t, W[t], G[t])
        if final_params is not None:
            self.finalize(final_params)

    def stacked_view(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.tier != "stacked" or self.W is None:
            raise ValueError("stacked_view() needs a filled stacked history")
        return self.W, self.G

    # -- sizes -----------------------------------------------------------------

    def nbytes(self) -> int:
        """Bytes the cache holds in memory: device bytes for ``stacked``,
        host RAM (encoded rows and keyframes) for the offload tiers."""
        if self.tier == "stacked":
            return 0 if self.W is None else 2 * self.W.numel() * self.W.element_size()
        rows = self._enc if self.tier == "host" else self._spill_buf
        total = sum(w.nbytes + g.nbytes for w, g in rows)
        return total + sum(w.nbytes + g.nbytes for w, g in self._bases.values())

    def disk_nbytes(self) -> int:
        """Bytes of the disk spill (0 for other tiers)."""
        return sum(os.path.getsize(p) for p in self._win_paths
                   if os.path.exists(p))

    # -- snapshots, and carrying a history across -------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """The history as numpy and plain data, for a session snapshot
        (`from_state_dict` reads it back on any device).  Stacked: the (T, p)
        buffers.  Host: the encoded rows and the keyframe bases.  Disk: the
        window files stay where they are, so the state names them (with
        ``spill_window`` and the flushed count), as the JAX package's
        does; the partial tail is flushed to disk first."""
        if self.tier == "disk":
            self._flush_spill(everything=True)
        state: Dict[str, Any] = {
            "format": STATE_FORMAT,
            "meta": self.meta,
            "tier": self.tier,
            "codec": self.codec.name,
            "shapes": dict(self.shapes),
            "final_params": (None if self.final_params is None else
                             _host_copy(self.final_params.flat)),
            "bases": dict(self._bases),
        }
        if self.tier == "stacked":
            state["W"], state["G"] = _host_copy(self.W), _host_copy(self.G)
        elif self.tier == "host":
            state["enc"] = list(self._enc)
        else:
            state.update(spill_dir=self.spill_dir,
                         spill_window=self.spill_window,
                         win_paths=list(self._win_paths),
                         spill_flushed=self._spill_flushed, n=self._n)
        return state

    @classmethod
    def _from_port_state(cls, state: Mapping[str, Any], device,
                         spill_dir: Optional[str]) -> "TrainingHistory":
        dev = torch.device(device)
        tier = state["tier"]
        h = cls(state["meta"], tier=tier, codec=state["codec"],
                spill_dir=(spill_dir or state["spill_dir"]) if tier == "disk"
                else None,
                spill_window=state.get("spill_window", 0), device=dev)
        final = None
        if state["final_params"] is not None:
            final = FlatParams(torch.from_numpy(state["final_params"]).to(dev),
                               state["shapes"])
        if tier == "stacked":
            h.set_stacked(torch.from_numpy(state["W"]).to(dev),
                          torch.from_numpy(state["G"]).to(dev), final)
            return h
        h.set_layout(state["shapes"], dev)
        h._bases = dict(state["bases"])
        if tier == "host":
            h._enc = list(state["enc"])
            h._n = len(h._enc)
        else:
            # a new spill_dir gets its own copy of the windows: rewrites go
            # to spill_dir, so the restored history must read from there
            h._win_paths = []
            for wid, path in enumerate(state["win_paths"]):
                if os.path.abspath(path) != os.path.abspath(h._win_path(wid)):
                    shutil.copyfile(path, h._win_path(wid))
                h._win_paths.append(h._win_path(wid))
            h._spill_flushed = h._n = int(state["spill_flushed"])
        h.final_params = final
        return h

    @classmethod
    def from_state_dict(cls, state: Mapping[str, Any],
                        meta: Optional[HistoryMeta] = None, device=None,
                        spill_dir: Optional[str] = None) -> "TrainingHistory":
        """A history from `state_dict` (any tier; `meta` is in the state,
        and a disk tier's `spill_dir` defaults to the saved one), or from
        the numpy layout of the JAX package's ``TrainingHistory.
        state_dict()`` of a host-tier history (with `meta`): per-entry
        (nested) trees of encoded leaves (``{"q", "scale"}`` dicts for
        int8, bf16 or f32 arrays otherwise), ``bases`` {kwid: (w_tree,
        g_tree)} and ``final_params``.  The codes are taken as they are,
        not re-encoded, so both packages replay the same bits.  ``device``:
        where `entry` decodes to (None: the card)."""
        if state.get("format") == STATE_FORMAT:
            return cls._from_port_state(
                state, torch.device("cuda" if device is None else device),
                spill_dir)
        if meta is None:
            raise ValueError("a JAX package history state needs `meta`")
        if state["tier"] != "host":
            raise ValueError(
                f"from_state_dict takes host-tier states, got a "
                f"{state['tier']!r}-tier one (its entries live elsewhere)")
        dev = torch.device("cuda" if device is None else device)
        final = FlatParams.from_tensors(
            {k: np.array(v) for k, v in
             flatten_nested(state["final_params"]).items()}, device=dev)
        h = cls(meta, tier="host", codec=state["codec"], device=dev)
        h.set_layout(final.shapes, dev)
        names = list(final.shapes)  # key paths, in the flat order

        def at(tree, name):
            """The leaf at key path `name` of a (nested) entry tree; an
            int8 leaf is itself a {"q", "scale"} dict."""
            for part in name.split("/"):
                tree = tree[part]
            return tree

        def flat(tree) -> Encoded:
            leaves = [at(tree, k) for k in names]
            if isinstance(leaves[0], dict):  # int8: {"q", "scale"} per leaf
                return Encoded(
                    np.concatenate([np.asarray(x["q"]).reshape(-1)
                                    for x in leaves]),
                    np.asarray([x["scale"] for x in leaves], np.float32))
            arrs = [np.asarray(x).reshape(-1) for x in leaves]
            if arrs[0].dtype.name == "bfloat16":
                return Encoded(np.concatenate([a.view(np.int16) for a in arrs]))
            return Encoded(np.concatenate(arrs).astype(np.float32, copy=False))

        def flat_f32(tree) -> np.ndarray:
            return np.concatenate([np.asarray(at(tree, k), np.float32).reshape(-1)
                                   for k in names])

        h._enc = [(flat(p), flat(g))
                  for p, g in zip(state["params"], state["grads"])]
        h._n = len(h._enc)
        h._bases = {int(k): (flat_f32(w), flat_f32(g))
                    for k, (w, g) in state.get("bases", {}).items()}
        h.final_params = final
        return h
