"""Shared neural building blocks (functions over dicts of tensors).

The port's copy of the JAX package's ``models/layers.py``, for the dense
GQA stack.  Conventions, as there:

  * parameters are dicts of tensors; ``*_init`` builds them, ``*_apply``
    consumes them;
  * activations run in the caller's compute dtype (bf16 by default);
    reductions (softmax, norms, losses) accumulate in f32.  Where the
    reference asks XLA for an f32 product of bf16 operands
    (``preferred_element_type``), the port upcasts the operands: products
    of bf16 values are exact in f32, so only the order of the sum differs;
  * attention is the blockwise online softmax (a loop over KV blocks), or
    the flash kernel where `models.attention_config` selects it; one
    decoded token attends to its KV cache with plain contractions
    (`decode_attention`), as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.attention_config import attention_impl


def dense_init(d_in: int, d_out: int, generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1/d_in) weights, drawn on the generator's device."""
    w = torch.randn(d_in, d_out, generator=generator, device=generator.device)
    return (w / math.sqrt(d_in)).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rmsnorm_init(d: int, device=None) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(d, device=device)}


class _RoundValue(torch.autograd.Function):
    """x's values rounded to `dtype`, kept in x's dtype; the gradient
    passes through unrounded."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """x as it is; its gradient rounded to `dtype` (and kept in x's)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def _rms(params, xf: torch.Tensor, eps: float) -> torch.Tensor:
    var = xf.square().mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * params["scale"]  # scale: f32 math


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return _rms(params, x.float(), eps).to(x.dtype)


class _FanOut(torch.autograd.Function):
    """x to `n` uses (views, no copy); their gradients summed in f32 in
    the uses' order and rounded once to x's dtype."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        s = gs[0].float()
        for g in gs[1:]:
            s = s + g.float()
        return s.to(gs[0].dtype), None


def fan_out(x: torch.Tensor, n: int):
    """x for `n` uses whose gradients XLA sums in f32 before it rounds
    them to x's dtype (autograd would add them one rounded bf16 add at a
    time): `_FanOut` under autograd, else x itself n times."""
    if torch.is_grad_enabled() and x.requires_grad and x.dtype != torch.float32:
        return _FanOut.apply(x, n)
    return (x,) * n


def _to_matmuls(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A norm's f32 output for several matmuls: its values rounded to
    `dtype`.  Under autograd it stays f32 with its gradient unrounded, and
    each matmul casts it on its own (`gqa_apply`, `mlp_apply`), so the
    matmuls' input gradients, each rounded to `dtype`, are summed in f32
    and reach the norm unrounded: the order and roundings of XLA's fused
    backward of the reference (the last two uses' sum rounded first for
    three, `gqa_apply`).  Without autograd, the values in `dtype`."""
    if torch.is_grad_enabled() and out.requires_grad and out.dtype != dtype:
        return _RoundValue.apply(out, dtype)
    return out.to(dtype)


def norm_to_matmuls(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """`rmsnorm` of x for the matmuls that read it (`_to_matmuls`)."""
    return _to_matmuls(_rms(params, x.float(), eps), x.dtype)


def residual_norm(params, x: torch.Tensor, h: torch.Tensor,
                  eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + h, rmsnorm(x + h)) as the jitted reference computes them: XLA
    fuses the add into the norm's f32 convert, so the norm reads the sum
    before it rounds to x's dtype, and only the residual stream is
    rounded (the same in f32).  Backward, as XLA's: the norm's input
    gradient is rounded to x's dtype before it joins the residual's, and
    the norm's output goes to its matmuls by `_to_matmuls`."""
    s = x.float() + h  # h promoted to f32 exactly, in the add's kernel
    n = _rms(params, _RoundGrad.apply(s, x.dtype), eps)
    return s.to(x.dtype), _to_matmuls(n, x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: (..., S).  Rotate-half:
    the two halves of D are the pairs, not interleaved lanes."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)  # (d/2,)
    ang = positions[..., :, None].float() * inv  # (..., S, d/2)
    cos = torch.cos(ang)[..., :, None, :]  # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Blockwise (flash-style) attention: the plain path, and the flash
# kernel's backward
# --------------------------------------------------------------------------


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        block_k: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention, looping over KV blocks.

    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); H = Hkv * G.  `window > 0`
    restricts attention to the last `window` positions; `q_offset` is the
    absolute position of q[0].  Scores are f32 from the storage-dtype
    operands, and P is cast back to v's dtype before the PV product, as in
    the reference (layers.py:155)."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    blk = min(block_k, Sk)
    Skp = -(-Sk // blk) * blk
    if Skp > Sk:
        k = F.pad(k, (0, 0, 0, 0, 0, Skp - Sk))
        v = F.pad(v, (0, 0, 0, 0, 0, Skp - Sk))
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)

    m = torch.full((B, Sq, Hkv, G), float("-inf"), device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, D), device=q.device)
    for start in range(0, Skp, blk):
        kblk, vblk = k[:, start:start + blk], v[:, start:start + blk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kblk.float()) * scale
        k_pos = start + torch.arange(blk, device=q.device)
        valid = (k_pos < Sk)[None, None, :]
        if causal:
            valid = valid & (k_pos[None, None, :] <= q_pos[None, :, None])
        if window > 0:
            valid = valid & (k_pos[None, None, :] > q_pos[None, :, None] - window)
        s = s.masked_fill(~valid[:, :, None, None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        p = p.masked_fill(~torch.isfinite(s), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, D).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """The flash kernel's forward with `blockwise_attention` as its backward.

    The counterpart of the reference's ``_flash_attention_ref_grad``
    (layers.py:173): the kernel is forward-only, but replay differentiates
    every attention call, so `backward` recomputes `blockwise_attention`
    on the saved (q, k, v) under autograd and returns its gradient, as the
    reference takes the VJP of its blockwise program.  This backward is the
    model's own plain PyTorch path, not a fallback for the kernel: the
    forward on a CUDA tensor always launches the kernel or raises, and the
    kernel's plain version (`attention_ref`) stays off the card's path."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_ops.attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = blockwise_attention(*qkv, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None


def full_attention(q, k, v, *, causal: bool = True,
                   window: int = 0) -> torch.Tensor:
    """Route the full-sequence attention contraction, as the reference
    does: flash takes the causal, non-windowed case when
    `models.attention_config` selects it; everything else is
    `blockwise_attention`."""
    if attention_impl() == "flash" and causal and window == 0:
        return FlashAttention.apply(q, k, v, causal)
    return blockwise_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against a fixed-size cache.

    q: (B, H, D); caches: (B, S, Hkv, D); cache_len: 0-d int tensor on the
    caches' device, the number of valid slots (the new token's k/v already
    written).  Scores and softmax in f32 over the whole cache, masked to
    the valid slots and, with `window > 0`, to the last `window` of them."""
    B, H, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    valid = pos < cache_len
    if window > 0:
        valid = valid & (pos > cache_len - 1 - window)
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------


def gqa_init(generator: torch.Generator, d_model: int, n_heads: int,
             n_kv: int, d_head: int) -> Dict[str, torch.Tensor]:
    return {
        "wq": dense_init(d_model, n_heads * d_head, generator),
        "wk": dense_init(d_model, n_kv * d_head, generator),
        "wv": dense_init(d_model, n_kv * d_head, generator),
        "wo": dense_init(n_heads * d_head, d_model, generator),
    }


def gqa_apply(params, x: torch.Tensor, *, n_heads: int, n_kv: int,
              d_head: int, rope_theta: float, causal: bool = True,
              window: int = 0, qk_norm: bool = False,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, S, _ = x.shape
    # cast per use (`_to_matmuls`): q's input gradient joins k's and v's,
    # summed first, as the reference's cotangents sum
    dt = params["wq"].dtype
    xq, xkv = x.to(dt), x.to(dt)
    q = (xq @ params["wq"]).reshape(B, S, n_heads, d_head)
    k = (xkv @ params["wk"]).reshape(B, S, n_kv, d_head)
    v = (xkv @ params["wv"]).reshape(B, S, n_kv, d_head)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    o = full_attention(q, k, v, causal=causal, window=window)
    return o.reshape(B, S, n_heads * d_head) @ params["wo"]


def gqa_decode(params, x: torch.Tensor, cache: Dict[str, torch.Tensor], *,
               n_heads: int, n_kv: int, d_head: int, rope_theta: float,
               window: int = 0, qk_norm: bool = False):
    """One-token decode: x (B, 1, d_model), cache ``{k, v: (B, S, Hkv, D),
    len: 0-d int32}``; returns (out (B, 1, d_model), new cache).

    The new token's k/v go to slot ``len`` through a device index, so no
    value is read back to the host; the cache's k and v are written in
    place (the reference's decode loop donates them to its jit) and the
    new cache holds them with ``len + 1``.  When `window > 0` and the
    cache holds `window` slots or fewer, it is a ring buffer: the write
    goes to ``len % size`` and every slot written so far is valid (RoPE
    is already in k, so the slots' order does not matter)."""
    B = x.shape[0]
    pos = cache["len"]
    size = cache["k"].shape[1]
    ring = window > 0 and size <= window
    q = (x[:, 0] @ params["wq"]).reshape(B, n_heads, d_head)
    k = (x[:, 0] @ params["wk"]).reshape(B, n_kv, d_head)
    v = (x[:, 0] @ params["wv"]).reshape(B, n_kv, d_head)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    posv = pos.expand(B, 1)
    q = apply_rope(q[:, None], posv, rope_theta)[:, 0]
    k = apply_rope(k[:, None], posv, rope_theta)[:, 0]
    slot = (torch.remainder(pos, size) if ring else pos).reshape(1).long()
    k_cache = cache["k"].index_copy_(1, slot, k[:, None].to(cache["k"].dtype))
    v_cache = cache["v"].index_copy_(1, slot, v[:, None].to(cache["v"].dtype))
    o = decode_attention(q, k_cache, v_cache, pos + 1,
                         window=0 if ring else window)
    out = o.reshape(B, 1, n_heads * d_head) @ params["wo"]
    return out, {"k": k_cache, "v": v_cache, "len": pos + 1}


def gqa_cache_init(batch: int, seq: int, n_kv: int, d_head: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    """An empty cache of `seq` slots on `device`: k, v zeros of `dtype`,
    len a 0-d int32 zero."""
    return {"k": torch.zeros(batch, seq, n_kv, d_head, dtype=dtype,
                             device=device),
            "v": torch.zeros(batch, seq, n_kv, d_head, dtype=dtype,
                             device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             kind: str) -> Dict[str, torch.Tensor]:
    if kind == "swiglu":
        return {"w_gate": dense_init(d_model, d_ff, generator),
                "w_up": dense_init(d_model, d_ff, generator),
                "w_down": dense_init(d_ff, d_model, generator)}
    if kind in ("relu_sq", "gelu"):
        return {"w_up": dense_init(d_model, d_ff, generator),
                "w_down": dense_init(d_ff, d_model, generator)}
    raise ValueError(kind)


def _rounded(value: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX uses it against an array of `dtype`:
    rounded to that dtype first."""
    return float(torch.tensor(value, dtype=dtype))


class _Logistic(torch.autograd.Function):
    """The reference's ``lax.logistic``: its value op by op, its gradient
    by JAX's rule for the primitive, g * (ans * (1 - ans))."""

    @staticmethod
    def forward(ctx, x):
        ans = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        return g * (ans * (1 - ans))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic as XLA computes the reference's ``jax.nn.sigmoid``:
    exp, the sum and the reciprocal each rounded to x's dtype
    (``torch.sigmoid`` rounds once, and parts from it in about a third of
    bf16 outputs); its gradient is JAX's rule for the primitive, each op
    rounded alike."""
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU as the reference's ``jax.nn.silu`` rounds in bf16: `sigmoid`,
    then the product in x's dtype (``F.silu`` rounds once, and parts from
    it in about a third of bf16 outputs)."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, ``x * (0.5 * (1 + tanh(c (x
    + 0.044715 x^3))))`` with c = sqrt(2 / pi), each constant rounded to
    x's dtype and each op rounded to it (``F.gelu(approximate="tanh")``
    rounds once, and parts from it in about two in five bf16 outputs)."""
    c = _rounded(math.sqrt(2 / math.pi), x.dtype)
    a = _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * x ** 3))))


def ffn_silu(x: torch.Tensor) -> torch.Tensor:
    """The FFNs' SiLU: `silu` where XLA rounds the reference's op by op
    (bf16), ``F.silu``'s one rounding in f32 (neither f32 form is the
    reference's bit for bit; they part from it by at most an ulp)."""
    return F.silu(x) if x.dtype == torch.float32 else silu(x)


def ffn_gelu(x: torch.Tensor) -> torch.Tensor:
    """The FFNs' tanh GeLU, chosen as `ffn_silu` is."""
    return F.gelu(x, approximate="tanh") if x.dtype == torch.float32 else gelu_tanh(x)


def ffn_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The MoE shared gate's logistic, chosen as `ffn_silu` is."""
    return torch.sigmoid(x) if x.dtype == torch.float32 else sigmoid(x)


def mlp_apply(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The FFN; in bf16 its activations round op by op as the reference's
    do under XLA (`ffn_silu`, `ffn_gelu`).  x is cast to the weights'
    dtype at each use (`_to_matmuls`)."""
    dt = params["w_up"].dtype
    if kind == "swiglu":
        h = ffn_silu(x.to(dt) @ params["w_gate"]) * (x.to(dt) @ params["w_up"])
    elif kind == "relu_sq":
        h = torch.square(F.relu(x.to(dt) @ params["w_up"]))
    elif kind == "gelu":
        h = ffn_gelu(x.to(dt) @ params["w_up"])
    else:
        raise ValueError(kind)
    return h @ params["w_down"]
