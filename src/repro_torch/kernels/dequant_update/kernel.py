"""ctypes binding of ``csrc/dequant_update.cu`` (see its header note)."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_UPDATE_ARGS = [_P] * 7 + [ctypes.c_int, _P, _P, ctypes.c_int64] \
    + [ctypes.c_float] * 4 + [ctypes.c_int, _P]
_SUB_ARGS = [_P] * 5 + [ctypes.c_int, _P, ctypes.c_int64, ctypes.c_int, _P]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def dequant_update(w, q, bv, g_changed, base, scale, ends, out, g_out, lr,
                   n, dB, sign) -> None:
    """Launch on w's current stream; operands already checked by ops.py.
    ``ends`` is the (n_leaves,) int64 device tensor of leaf end offsets;
    ``scale``, ``base`` and ``g_out`` (the estimate's buffer) may be None."""
    fn = _build.function("dequant_update", "dequant_update", _UPDATE_ARGS)
    err = fn(w.data_ptr(), q.data_ptr(), bv.data_ptr(), g_changed.data_ptr(),
             _ptr(base), _ptr(scale), _ptr(ends),
             0 if ends is None else ends.numel(), out.data_ptr(), _ptr(g_out),
             w.numel(), lr, n, dB, sign, _build.dtype_code(q),
             _build.stream_of(w))
    _build.check(err, "dequant_update")


def dequant_sub(w, q, base, scale, ends, out) -> None:
    """Launch on w's current stream (see `dequant_update`)."""
    fn = _build.function("dequant_update", "dequant_sub", _SUB_ARGS)
    err = fn(w.data_ptr(), q.data_ptr(), _ptr(base), _ptr(scale), _ptr(ends),
             0 if ends is None else ends.numel(), out.data_ptr(), w.numel(),
             _build.dtype_code(q), _build.stream_of(w))
    _build.check(err, "dequant_sub")
