"""ctypes binding of ``csrc/fused_update.cu`` (see its header note)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_float] * 4 \
    + [ctypes.c_int, ctypes.c_void_p]


def deltagrad_update(w: torch.Tensor, g_cached: torch.Tensor, bv: torch.Tensor,
                     g_changed: torch.Tensor, out: torch.Tensor, lr: float,
                     n: float, dB: float, sign: float) -> None:
    """Launch on w's current stream; operands already checked by ops.py."""
    fn = _build.function("fused_update", "fused_update", _ARGTYPES)
    err = fn(w.data_ptr(), g_cached.data_ptr(), bv.data_ptr(),
             g_changed.data_ptr(), out.data_ptr(), w.numel(), lr, n, dB, sign,
             _build.dtype_code(w), _build.stream_of(w))
    _build.check(err, "fused_update")
