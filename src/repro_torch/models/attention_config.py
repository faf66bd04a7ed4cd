"""Process-wide switch for the full-sequence attention implementation.

`models.layers.full_attention` reads it on every call:

  * ``"blockwise"``  the online-softmax loop over KV blocks
    (`layers.blockwise_attention`); the default, and the reference the
    kernel path is held against;
  * ``"flash"``      the flash kernel (`kernels.flash_attention`) where
    shapes allow (causal, no sliding window): on a CUDA tensor it launches
    the CUDA kernel or raises, on a CPU tensor it computes the kernel's
    plain version, `attention_ref`.

The JAX package also has ``"flash_interpret"``, Pallas's interpreter,
which has no counterpart here.  `core.deltagrad.Objective.from_model(...,
attn_impl=...)` pins the switch for every call of one objective.
"""

from __future__ import annotations

from contextlib import contextmanager

_IMPLS = ("blockwise", "flash")
_IMPL = "blockwise"


def attention_impl() -> str:
    """The currently selected implementation name."""
    return _IMPL


def check_impl(name: str) -> None:
    if name not in _IMPLS:
        raise ValueError(f"attention impl must be one of {_IMPLS}, "
                         f"got {name!r}")


def set_attention_impl(name: str) -> str:
    """Set the implementation; returns the previous one."""
    global _IMPL
    check_impl(name)
    prev, _IMPL = _IMPL, name
    return prev


@contextmanager
def use_attention_impl(name):
    """Scoped override; ``None`` is a no-op (keep whatever is active)."""
    if name is None:
        yield
        return
    prev = set_attention_impl(name)
    try:
        yield
    finally:
        set_attention_impl(prev)
