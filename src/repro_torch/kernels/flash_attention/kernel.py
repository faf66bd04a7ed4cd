"""ctypes bindings of ``csrc/flash_attention.cu`` (see its header note)."""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 12 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_MMA_ARGS = _ARGS[:-2] + [ctypes.c_void_p]  # no dtype: bf16 only


def _shape_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, causal: bool) -> list:
    """The arguments both entry points share, from the pointers to causal."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Hkv, Sq, Sk, D, *strides, 1.0 / math.sqrt(D), int(causal)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, causal: bool) -> None:
    """Launch on q's current stream (bf16: the wgmma instance; f32: the FMA
    one); q, out (B, Sq, H, D) and k, v (B, Sk, Hkv, D), already checked by
    ops.py."""
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGS)
    err = fn(*_shape_args(q, k, v, out, causal), _build.dtype_code(q),
             _build.stream_of(q))
    _build.check(err, "flash_attention")


def flash_attention_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, causal: bool) -> None:
    """The mma.sync instance on bf16 operands, the yardstick that
    chip_smoke.py and the cuda-marked tests hold the wgmma instance
    against; no path of the port calls it, and it counts no launch."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_mma: bf16 only, got {q.dtype}")
    fn = _build.function("flash_attention", "flash_attention_fwd_mma", _MMA_ARGS)
    err = fn(*_shape_args(q, k, v, out, causal), _build.stream_of(q))
    _build.check(err, "flash_attention_mma")
