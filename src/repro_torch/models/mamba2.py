"""Mamba2 / SSD block (Dao & Gu 2024, arXiv:2405.21060).

The port's copy of the JAX package's ``models/mamba2.py``.  Training and
prefill use the chunked SSD algorithm (`ssd_chunked`): within each chunk
of Q positions the recurrence is a masked, attention-like contraction, and
the chunk boundary states are carried by a loop over the L / Q chunks (the
reference's ``lax.scan``).  Decode (`mamba2_decode`) carries a conv window
and the SSM state, O(1) in the sequence length.

As in the reference:

  * head h belongs to group ``h // (H / G)`` (``jnp.repeat``, which is
    `repeat_interleave`); the port broadcasts each group over its heads
    instead of materializing the repeat, which gives the same products;
  * the decay matrix is masked before the exp, so no masked entry
    overflows and the backward pass stays finite;
  * Q = min(chunk, L), and L must divide by Q (a `ValueError` here);
  * the dtypes follow JAX's promotion under `cast_params` (every float
    leaf in the compute dtype): ``xh * dt`` and ``dt + dt_bias`` are f32,
    the SSD contractions f32, and the causal conv sums its K shifted
    products in the compute dtype in Python's ``sum`` order; SiLU is
    ``x * (1 / (1 + exp(-x)))`` with every op rounded to the compute
    dtype, as XLA computes the reference's bf16 ``jax.nn.silu``;
  * the within-chunk cumulative decay is summed one position after
    another, the reference's order on the CPU;
  * the decode's conv window is f32 (the cache's dtype) with the new
    column promoted into it, and its conv and SSM state are f32; both
    states are written in place, as `layers.gqa_decode` writes K and V.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init, silu


def _dims(d_model: int, cfg: SSMConfig) -> Tuple[int, int, int]:
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    conv_dim = d_inner + 2 * cfg.n_groups * cfg.d_state
    return d_inner, n_heads, conv_dim


def mamba2_init(generator: torch.Generator, d_model: int,
                cfg: SSMConfig) -> Dict[str, object]:
    d_inner, n_heads, conv_dim = _dims(d_model, cfg)
    dev = generator.device
    gn = cfg.n_groups * cfg.d_state
    # w_in's columns: [z (gate), x, B, C, dt]
    w_in = dense_init(d_model, 2 * d_inner + 2 * gn + n_heads, generator)
    conv_w = 0.1 * torch.randn(cfg.d_conv, conv_dim, generator=generator,
                               device=dev)
    w_out = dense_init(d_inner, d_model, generator)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_dim, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev)),  # A = -exp(a_log)
        "dt_bias": torch.zeros(n_heads, device=dev),
        "d_skip": torch.ones(n_heads, device=dev),
        "out_norm": rmsnorm_init(d_inner, dev),
        "w_out": w_out,
    }


def mamba2_param_shapes(d_model: int, cfg: SSMConfig) -> Dict[str, Tuple[int, ...]]:
    """`mamba2_init`'s leaf shapes, by key path, without allocating."""
    d_inner, n_heads, conv_dim = _dims(d_model, cfg)
    return {"w_in": (d_model, 2 * d_inner + 2 * cfg.n_groups * cfg.d_state + n_heads),
            "conv_w": (cfg.d_conv, conv_dim), "conv_b": (conv_dim,),
            "a_log": (n_heads,), "dt_bias": (n_heads,), "d_skip": (n_heads,),
            "out_norm/scale": (d_inner,), "w_out": (d_inner, d_model)}


def _split_in(params, x: torch.Tensor, d_model: int, cfg: SSMConfig):
    """x @ w_in split into (z, x, B, C, dt) along the last axis."""
    d_inner, _, _ = _dims(d_model, cfg)
    gn = cfg.n_groups * cfg.d_state
    zxbcdt = x @ params["w_in"]
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner],
            zxbcdt[..., 2 * d_inner:2 * d_inner + gn],
            zxbcdt[..., 2 * d_inner + gn:2 * d_inner + 2 * gn],
            zxbcdt[..., 2 * d_inner + 2 * gn:])


def _causal_conv(conv_w: torch.Tensor, conv_b: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over u (B, L, C) with kernel (K, C), then
    SiLU: the K shifted products summed one by one in u's dtype."""
    K, L = conv_w.shape[0], u.shape[1]
    u_pad = F.pad(u, (0, 0, K - 1, 0))
    out = u_pad[:, 0:L] * conv_w[0]
    for i in range(1, K):
        out = out + u_pad[:, i:i + L] * conv_w[i]
    return silu(out + conv_b)


def cumsum_by_adds(a: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over axis 2, one f32 add after another."""
    out = [a[:, :, 0]]
    for i in range(1, a.shape[2]):
        out.append(out[-1] + a[:, :, i])
    return torch.stack(out, dim=2)


def _cumsum(a: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over axis 2 in f32, one add after another: the order
    of the reference's ``jnp.cumsum`` over a chunk on the CPU.  The decay
    matrix exponentiates differences of these sums, whose rounding grows
    with their size, so the order shows in the output.  On the card
    ``torch.cumsum`` sums an axis that is not the innermost in that order,
    in one launch (``chip_smoke.py`` holds it bitwise to `cumsum_by_adds`);
    on the CPU it accumulates in f64, so there the adds go one by one."""
    return torch.cumsum(a, dim=2) if a.is_cuda else cumsum_by_adds(a)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, cfg: SSMConfig,
                init_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (B, L, H, P); dt: (B, L, H) f32 (post-softplus); b_in, c_in: (B,
    L, G, N); init_state: (B, H, N, P) f32 or None.  Returns (y (B, L, H,
    P) in xh's dtype, final_state (B, H, P, N) f32)."""
    Bsz, L, H, P = xh.shape
    G, N = b_in.shape[-2], b_in.shape[-1]
    Q = min(cfg.chunk, L)
    if L % Q:
        raise ValueError(f"seq len {L} must divide by chunk {Q}")
    nc, hg = L // Q, H // G  # chunks, heads per group

    a = (-torch.exp(a_log))[None, None, :] * dt  # (B, L, H) log-decay, <= 0
    xbar = xh * dt[..., None]  # dt-scaled input, f32
    ac = a.reshape(Bsz, nc, Q, H)
    xc = xbar.reshape(Bsz, nc, Q, H, P).float()
    bc = b_in.reshape(Bsz, nc, Q, G, N).float()
    cc = c_in.reshape(Bsz, nc, Q, G, N).float()

    cum = _cumsum(ac)  # (B, nc, Q, H) within-chunk decay
    total = cum[:, :, -1]  # (B, nc, H)

    # intra-chunk: Lmask[i, j] = exp(cum_i - cum_j) for i >= j, masked
    # BEFORE the exp (a masked entry's exp overflows, and inf * 0 in the
    # backward pass is NaN)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()
    lmask = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                       float("-inf")))
    scores = torch.einsum("bnqgs,bnkgs->bnqkg", cc, bc)  # (B, nc, Q, Q, G)
    # head h of group h // hg: each group's scores over its hg heads
    att = (scores[..., None] * lmask.reshape(Bsz, nc, Q, Q, G, hg)
           ).reshape(Bsz, nc, Q, Q, H)
    y_diag = torch.einsum("bnqkh,bnkhp->bnqhp", att, xc)

    # chunk states: S_n = sum_j exp(total - cum_j) B_j (outer) xbar_j
    wts = torch.exp(total[:, :, None, :] - cum)  # (B, nc, Q, H)
    xw = (xc * wts[..., None]).reshape(Bsz, nc, Q, G, hg, P)
    states = torch.einsum("bcqgs,bcqghp->bcghsp", bc, xw).reshape(
        Bsz, nc, H, N, P)

    # inter-chunk recurrence: the state before each chunk
    s = (torch.zeros(Bsz, H, N, P, device=xh.device) if init_state is None
         else init_state)
    decay = torch.exp(total)  # (B, nc, H)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1).reshape(Bsz, nc, G, hg, N, P)

    y_off = torch.einsum("bcqgs,bcghsp->bcqghp", cc, prev_states).reshape(
        Bsz, nc, Q, H, P) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    # the state transposed to (B, H, P, N), the decode's convention
    return y.to(xh.dtype), s.transpose(-1, -2)


def mamba2_apply(params, x: torch.Tensor, d_model: int,
                 cfg: SSMConfig) -> torch.Tensor:
    """Full-sequence forward: x (B, L, d_model) -> (B, L, d_model)."""
    d_inner, n_heads, _ = _dims(d_model, cfg)
    Bsz, L, _ = x.shape
    gn = cfg.n_groups * cfg.d_state
    z, xin, b_in, c_in, dt = _split_in(params, x, d_model, cfg)
    u = _causal_conv(params["conv_w"], params["conv_b"],
                     torch.cat([xin, b_in, c_in], dim=-1))
    xh = u[..., :d_inner].reshape(Bsz, L, n_heads, cfg.head_dim)
    bg = u[..., d_inner:d_inner + gn].reshape(Bsz, L, cfg.n_groups, cfg.d_state)
    cg = u[..., d_inner + gn:].reshape(Bsz, L, cfg.n_groups, cfg.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, L, H) f32
    y, _ = ssd_chunked(xh, dt, params["a_log"], bg, cg, cfg)
    y = y + params["d_skip"][None, None, :, None] * xh
    y = rmsnorm(params["out_norm"], y.reshape(Bsz, L, d_inner) * silu(z))
    return y @ params["w_out"]


# -- decode ------------------------------------------------------------------


def mamba2_cache_init(batch: int, d_model: int, cfg: SSMConfig,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> Dict[str, torch.Tensor]:
    """Zero states on `device`: conv (B, d_conv - 1, conv_dim) of `dtype`,
    ssm (B, H, head_dim, d_state) f32."""
    _, n_heads, conv_dim = _dims(d_model, cfg)
    return {"conv": torch.zeros(batch, cfg.d_conv - 1, conv_dim, dtype=dtype,
                                device=device),
            "ssm": torch.zeros(batch, n_heads, cfg.head_dim, cfg.d_state,
                               device=device)}


def mamba2_decode(params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  d_model: int, cfg: SSMConfig):
    """One-token step: x (B, 1, d_model), cache ``{conv, ssm}``; returns
    (out (B, 1, d_model) in x's dtype, the cache, its two states written
    in place)."""
    d_inner, n_heads, _ = _dims(d_model, cfg)
    Bsz = x.shape[0]
    gn = cfg.n_groups * cfg.d_state
    z, xin, b_in, c_in, dt = _split_in(params, x[:, 0:1], d_model, cfg)
    u_new = torch.cat([xin, b_in, c_in], dim=-1)  # (B, 1, conv_dim)
    conv = cache["conv"]
    wdt = torch.promote_types(conv.dtype, u_new.dtype)
    window = torch.cat([conv.to(wdt), u_new.to(wdt)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            params["conv_w"].float()) + params["conv_b"]
    u = silu(conv_out)  # (B, conv_dim) f32
    conv.copy_(window[:, 1:])

    b_t = u[..., d_inner:d_inner + gn].reshape(Bsz, cfg.n_groups, cfg.d_state)
    c_t = u[..., d_inner + gn:].reshape(Bsz, cfg.n_groups, cfg.d_state)
    dt_t = F.softplus(dt[:, 0].float() + params["dt_bias"])  # (B, H)
    xh = u[..., :d_inner].reshape(Bsz, n_heads, cfg.head_dim)

    hg = n_heads // cfg.n_groups
    b_heads = torch.repeat_interleave(b_t, hg, dim=1)  # (B, H, N)
    c_heads = torch.repeat_interleave(c_t, hg, dim=1)
    decay = torch.exp(-torch.exp(params["a_log"])[None, :] * dt_t)  # (B, H)
    # s = s * decay + dt * x (outer) B
    upd = (dt_t[..., None] * xh)[..., None] * b_heads[:, :, None, :]
    ssm = cache["ssm"].mul_(decay[..., None, None]).add_(upd)
    y = torch.einsum("bhpn,bhn->bhp", ssm, c_heads)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(Bsz, d_inner).to(x.dtype)
    y = rmsnorm(params["out_norm"], y * silu(z[:, 0]))
    return (y @ params["w_out"])[:, None, :], {"conv": conv, "ssm": ssm}
