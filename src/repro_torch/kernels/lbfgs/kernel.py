"""ctypes bindings of ``csrc/lbfgs.cu`` (see its header note)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_MULTIDOT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
_RANK_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_void_p]

# elements of p per block in multidot's first pass: ~230 blocks at the
# paper MLP's p, so every SM has work
MULTIDOT_CHUNK = 1024
MULTIDOT_MAX_BLOCKS = 2048


def multidot_blocks(p: int) -> int:
    """Blocks of the first pass; a function of p alone, so the order in
    which partial sums are added, and with it the result, is fixed."""
    return max(1, min(-(-p // MULTIDOT_CHUNK), MULTIDOT_MAX_BLOCKS))


def multidot(dW: torch.Tensor, dG: torch.Tensor, v: torch.Tensor,
             partials: torch.Tensor, out: torch.Tensor) -> None:
    """out (2m^2+2m,) f32 = [sw | sy | wv | gv]; partials is the wrapper's
    (multidot_blocks(p), m(m+1)/2 + m^2 + 2m) f32 scratch."""
    m, p = dW.shape
    fn = _build.function("lbfgs", "multidot", _MULTIDOT_ARGS)
    err = fn(dW.data_ptr(), dG.data_ptr(), v.data_ptr(), partials.data_ptr(),
             out.data_ptr(), m, p, partials.shape[0], _build.dtype_code(dW),
             _build.stream_of(dW))
    _build.check(err, "multidot")


def rank_update(dW: torch.Tensor, dG: torch.Tensor, v: torch.Tensor,
                coefs: torch.Tensor, out: torch.Tensor) -> None:
    """out (p,) = sigma v - a dW - b dG; coefs (2m+1,) f32 = [a | b | sigma]."""
    m, p = dW.shape
    fn = _build.function("lbfgs", "rank_update", _RANK_ARGS)
    err = fn(dW.data_ptr(), dG.data_ptr(), v.data_ptr(), coefs.data_ptr(),
             out.data_ptr(), m, p, _build.dtype_code(dW), _build.stream_of(dW))
    _build.check(err, "rank_update")
