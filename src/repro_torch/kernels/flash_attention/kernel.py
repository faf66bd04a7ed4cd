"""ctypes binding of ``csrc/flash_attention.cu`` (see its header note)."""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 12 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, causal: bool) -> None:
    """Launch on q's current stream; q, out (B, Sq, H, D) and k, v
    (B, Sk, Hkv, D), already checked by ops.py."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGS)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
             Hkv, Sq, Sk, D, *strides, 1.0 / math.sqrt(D), int(causal),
             _build.dtype_code(q), _build.stream_of(q))
    _build.check(err, "flash_attention")
