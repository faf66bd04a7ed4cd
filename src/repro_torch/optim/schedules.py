"""Learning-rate schedules: pure functions of the (integer) step.

The port's copy of the JAX package's ``optim/schedules.py``.  Each value
is the reference's f32 bit for bit, as its train step computes it: under
``jax.jit``, where XLA's CPU backend turns ``x / c`` for a constant ``c``
into ``x * (1 / c)``, contracts ``a * b + c`` into one fused multiply-add,
and takes the cosine from the C library's ``cosf``.  So the schedules
compute on the host in numpy f32 with those same three steps, and return
the value as a Python float (exactly the f32 value): the step is a host
int, and no device is involved.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from fractions import Fraction
from functools import lru_cache

import numpy as np

f32 = np.float32


@lru_cache(maxsize=1)
def _libm_cosf():
    cosf = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    cosf.restype, cosf.argtypes = ctypes.c_float, [ctypes.c_float]
    return cosf


def _cos(x: np.float32) -> np.float32:
    """The C library's f32 cosine (numpy's and torch's differ from it in
    the last bit for some arguments)."""
    return f32(_libm_cosf()(float(x)))


def _fma(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a * b + c rounded once to f32 (to nearest, ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = f32(float(exact))
    cands = (np.nextafter(r, f32(-np.inf)), r, np.nextafter(r, f32(np.inf)))
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                     int(x.view(np.int32)) & 1))


def _recip(n: int) -> np.float32:
    return f32(1) / f32(n)


def constant(lr: float):
    return lambda step: float(f32(lr))


def piecewise_constant(points):
    """points: ((from_step, lr), ...) — the paper's MNIST^n schedule."""
    def f(step):
        lr = f32(points[0][1])
        for start, value in points:
            if step >= start:
                lr = f32(value)
        return float(lr)
    return f


def _cosine(step: int, lr: float, total_steps: int, final_frac: float):
    t = min(max(f32(step) * _recip(max(total_steps, 1)), f32(0)), f32(1))
    c = _cos(t * f32(np.pi))
    # lr * (ff + (1 - ff) * 0.5 * (1 + c)), with the constants folded
    return _fma(c + f32(1), f32(1 - final_frac) * f32(0.5),
                f32(final_frac)) * f32(lr)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    return lambda step: float(_cosine(step, lr, total_steps, final_frac))


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    decay_steps = max(total_steps - warmup, 1)
    # lr * (step + 1) / warmup, with lr / warmup folded
    warm_rate = f32(lr) * _recip(max(warmup, 1))

    def f(step):
        if step < warmup:
            return float(f32(step + 1) * warm_rate)
        return float(_cosine(step - warmup, lr, decay_steps, final_frac))
    return f
