"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style).

The port's copy of the JAX package's ``models/mla.py``.  Train and
prefill use the expanded form (`mla_apply`); decode uses the *absorbed*
form (`mla_decode`): the per-head up-projections W_uk / W_uv fold into the
query and the output, so the KV cache stores only the latent ``c_kv``
(kv_lora_rank) and the shared RoPE key (qk_rope_head_dim) per position.

As in the reference:

  * the expanded form calls `layers.blockwise_attention` directly, not the
    flash switch, with v padded up to the qk head (nope + rope), so its
    scale is 1/sqrt(nope + rope), the absorbed form's too;
  * the latent norms take `rmsnorm`'s default eps, not the model's;
  * the cache is bf16 whatever the compute dtype, so an f32 decode rounds
    ``c_kv`` and ``k_rope`` to bf16 where it writes them;
  * the absorbed decode contracts in f32 (TF32 off on the card, as the
    entry points set), and its f32 output meets the compute-dtype ``wo``
    as f32 (JAX promotes the product; the port casts ``wo``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLAConfig
from repro_torch.models.layers import (apply_rope, blockwise_attention,
                                       dense_init, rmsnorm, rmsnorm_init)


def mla_init(generator: torch.Generator, d_model: int, n_heads: int,
             cfg: MLAConfig) -> Dict[str, object]:
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    dev = generator.device
    return {
        "w_dq": dense_init(d_model, cfg.q_lora_rank, generator),
        "q_norm": rmsnorm_init(cfg.q_lora_rank, dev),
        "w_uq": dense_init(cfg.q_lora_rank, n_heads * qk_head, generator),
        "w_dkv": dense_init(d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                            generator),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, dev),
        "w_uk": dense_init(cfg.kv_lora_rank, n_heads * cfg.qk_nope_head_dim,
                           generator),
        "w_uv": dense_init(cfg.kv_lora_rank, n_heads * cfg.v_head_dim, generator),
        "wo": dense_init(n_heads * cfg.v_head_dim, d_model, generator),
    }


def _project_q(params, x: torch.Tensor, n_heads: int, cfg: MLAConfig,
               positions: torch.Tensor, rope_theta: float):
    """x (B, S, d) -> (q_nope (B, S, H, nope), q_rope (B, S, H, rope))."""
    B, S, _ = x.shape
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    cq = rmsnorm(params["q_norm"], x @ params["w_dq"])
    q = (cq @ params["w_uq"]).reshape(B, S, n_heads, qk_head)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], positions, rope_theta)
    return q_nope, q_rope


def _project_kv_latent(params, x: torch.Tensor, cfg: MLAConfig,
                       positions: torch.Tensor, rope_theta: float):
    """x (B, S, d) -> (c_kv (B, S, kv_lora), k_rope (B, S, rope)): the
    normed latent and the RoPE key that every head shares."""
    ckv_full = x @ params["w_dkv"]
    c_kv = rmsnorm(params["kv_norm"], ckv_full[..., :cfg.kv_lora_rank])
    k_rope = ckv_full[..., cfg.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_apply(params, x: torch.Tensor, *, n_heads: int, cfg: MLAConfig,
              rope_theta: float, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """Expanded-form MLA for train and prefill: x (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q_nope, q_rope = _project_q(params, x, n_heads, cfg, positions, rope_theta)
    c_kv, k_rope = _project_kv_latent(params, x, cfg, positions, rope_theta)
    k_nope = (c_kv @ params["w_uk"]).reshape(B, S, n_heads, cfg.qk_nope_head_dim)
    v = (c_kv @ params["w_uv"]).reshape(B, S, n_heads, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, n_heads, cfg.qk_rope_head_dim)], dim=-1)
    # v padded up to the qk head, as the reference reuses its attention
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    v_pad = F.pad(v, (0, qk_head - cfg.v_head_dim))
    o = blockwise_attention(q, k, v_pad, causal=causal, window=window)
    o = o[..., :cfg.v_head_dim].reshape(B, S, n_heads * cfg.v_head_dim)
    return o @ params["wo"]


# -- decode (absorbed form, latent KV cache) --------------------------------


def mla_cache_init(batch: int, seq: int, cfg: MLAConfig,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    """An empty latent cache of `seq` slots on `device`: c_kv (B, S,
    kv_lora) and k_rope (B, S, rope) zeros of `dtype`, len a 0-d int32
    zero."""
    return {"c_kv": torch.zeros(batch, seq, cfg.kv_lora_rank, dtype=dtype,
                                device=device),
            "k_rope": torch.zeros(batch, seq, cfg.qk_rope_head_dim, dtype=dtype,
                                  device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def mla_decode(params, x: torch.Tensor, cache: Dict[str, torch.Tensor], *,
               n_heads: int, cfg: MLAConfig, rope_theta: float):
    """Absorbed-form one-token decode: x (B, 1, d), cache ``{c_kv, k_rope,
    len}``; returns (out (B, 1, d) in x's dtype, new cache).

        score_h(t) = (W_uk_h^T q_nope_h)^T c_t + q_rope_h^T k_rope_t
        out_h      = W_uv_h (sum_t p_t c_t)

    The new position's latent and RoPE key go to slot ``len`` through a
    device index (`index_copy_`, in place, as `layers.gqa_decode` writes
    k and v), and RoPE reads its position from ``len`` on the device, so
    no value is read back to the host."""
    B = x.shape[0]
    r, nope, v_dim = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    pos = cache["len"]
    posv = pos.expand(B, 1)
    q_nope, q_rope = _project_q(params, x, n_heads, cfg, posv, rope_theta)
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]  # (B, H, dims)
    c_new, kr_new = _project_kv_latent(params, x, cfg, posv, rope_theta)
    slot = pos.reshape(1).long()
    c_cache = cache["c_kv"].index_copy_(1, slot, c_new.to(cache["c_kv"].dtype))
    kr_cache = cache["k_rope"].index_copy_(1, slot,
                                           kr_new.to(cache["k_rope"].dtype))

    w_uk = params["w_uk"].reshape(r, n_heads, nope).float()
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope.float(), w_uk)  # absorbed query
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_head_dim)
    c_f = c_cache.float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c_f)
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_cache.float())) * scale
    valid = torch.arange(c_cache.shape[1], device=x.device) <= pos
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p, c_f)
    w_uv = params["w_uv"].reshape(r, n_heads, v_dim).float()
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv)
    out = o.reshape(B, 1, n_heads * v_dim) @ params["wo"].float()
    return out.to(x.dtype), {"c_kv": c_cache, "k_rope": kr_cache, "len": pos + 1}
