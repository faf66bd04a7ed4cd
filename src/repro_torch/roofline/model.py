"""First-order analytic FLOP / HBM-byte model per (arch x shape) cell.

The port's copy of the JAX package's ``roofline/model.py``: the same float
arithmetic in the same order, so that each cell's FLOPs, bytes and every
breakdown entry equal the reference's.  A profiler's count of a step covers
only what it traced, at the traced size; this model gives any layout at
any shape from the config's integers.  tests/test_torch_roofline.py holds
its FLOPs against ``torch.utils.flop_counter.FlopCounterMode``'s count of
one forward-and-backward step on reduced configs (the matmul FLOPs; the
model is matmul-exact and first-order).

Conventions: backward pass = 2x forward FLOPs (train = 3x forward);
causal attention averages S/2 context; HBM bytes count parameter,
activation-checkpoint, logits and KV-cache traffic at their storage widths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import layout_of


@dataclass
class AnalyticCost:
    flops_global: float  # whole step, all cards
    bytes_global: float
    breakdown: Dict[str, float]


def _attn_ctx(seq: int, causal: bool, window: int) -> float:
    ctx = seq / 2 if causal else seq
    if window:
        ctx = min(ctx, window)
    return ctx


def _block_fwd_flops(kind: str, cfg: ModelConfig, T: float, seq: int,
                     decode: bool) -> float:
    d = cfg.d_model
    if kind in ("attn", "attn_shared"):
        H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        ctx = seq if decode else _attn_ctx(seq, True, cfg.attn_window)
        if cfg.attn_window and decode:
            ctx = min(seq, cfg.attn_window)
        if cfg.attention == "mla":
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            f = 2 * T * d * m.q_lora_rank + 2 * T * m.q_lora_rank * H * qk
            f += 2 * T * d * (m.kv_lora_rank + m.qk_rope_head_dim)
            f += 2 * T * m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
            f += 2 * T * ctx * H * (qk + m.v_head_dim)
            f += 2 * T * H * m.v_head_dim * d
        else:
            f = 2 * T * d * (H + 2 * Hkv) * dh + 2 * T * d * H * dh
            f += 2 * T * ctx * H * dh * 2
        # mlp
        if cfg.mlp == "moe":
            mo = cfg.moe
            f += 2 * T * d * mo.num_experts  # router
            # capacity-padded dispatch computes E*(C+1) slots (see models/moe)
            cap = max(int(-(-mo.capacity_factor * mo.top_k * T // mo.num_experts)), 1)
            slots = mo.num_experts * (cap + 1)
            f += slots * 6 * d * mo.d_expert
            if mo.num_shared:
                f += 6 * T * d * mo.d_shared + 2 * T * d
        elif cfg.mlp == "swiglu":
            f += 6 * T * d * cfg.d_ff
        elif cfg.mlp in ("relu_sq", "gelu"):
            f += 4 * T * d * cfg.d_ff
        return f
    if kind == "mamba2":
        s = cfg.ssm
        di = s.expand * d
        H = di // s.head_dim
        gn = s.n_groups * s.d_state
        Q = 1 if decode else min(s.chunk, seq)
        f = 2 * T * d * (2 * di + 2 * gn + H)  # in_proj
        f += 2 * T * s.d_conv * (di + 2 * gn)  # conv
        f += 2 * T * Q * s.n_groups * s.d_state  # intra scores
        f += 2 * T * Q * di  # intra att @ x
        f += 4 * T * s.d_state * di  # states build + apply
        f += 2 * T * di * d  # out_proj
        return f
    if kind == "mlstm":
        pf = cfg.xlstm.proj_factor_mlstm
        di = int(pf * d)
        dh = di // cfg.n_heads
        Q = 1 if decode else min(256, seq)
        f = 2 * T * d * di * 2  # up + z
        f += 3 * 2 * T * di * di  # q, k, v
        f += 2 * T * Q * di * 2  # chunk scores + weighted v
        f += 4 * T * di * dh  # carry C q + state update
        f += 2 * T * di * d  # down
        return f
    if kind == "slstm":
        du = int(cfg.xlstm.proj_factor_slstm * d)
        dh = d // cfg.n_heads
        f = 2 * T * d * 4 * d  # w_in
        f += 2 * T * 4 * d * dh  # block-diagonal recurrence
        f += 2 * T * d * 2 * du + 2 * T * du * d  # GeGLU MLP
        return f
    raise ValueError(kind)


def _per_layer_param_bytes(cfg: ModelConfig) -> float:
    from repro_torch.models.registry import count_params

    return float(count_params(cfg))


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig, *, grad_accum: int = 1,
                  n_params: float = 0.0) -> AnalyticCost:
    decode = shape.is_decode
    B = shape.global_batch
    S = shape.seq_len
    T = float(B) * (1 if decode else S)
    seq_ctx = S  # decode context = cache length

    bd: Dict[str, float] = {}
    if cfg.family == "audio":
        # encoder (bidirectional, full ctx) + decoder (causal + cross)
        H, dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model
        if decode:
            enc_f = 0.0
            Tdec = T
            ctx_cross = 1500.0
        else:
            Tenc = float(B) * S
            enc_f = cfg.n_encoder_layers * (
                2 * Tenc * d * (H + 2 * cfg.n_kv_heads) * dh
                + 2 * Tenc * d * H * dh + 2 * Tenc * S * H * dh * 2
                + 4 * Tenc * d * cfg.d_ff)
            Tdec = T
            ctx_cross = float(S)
        self_ctx = seq_ctx if decode else S / 2
        dec_f = cfg.n_layers * (
            2 * Tdec * d * (H + 2 * cfg.n_kv_heads) * dh + 2 * Tdec * d * H * dh
            + 2 * Tdec * self_ctx * H * dh * 2  # self
            + 4 * Tdec * d * H * dh + 2 * Tdec * ctx_cross * H * dh * 2  # cross
            + 4 * Tdec * d * cfg.d_ff)
        head_f = 2 * Tdec * d * cfg.vocab
        bd["encoder"] = enc_f
        bd["decoder"] = dec_f
        bd["head"] = head_f
        fwd = enc_f + dec_f + head_f
    else:
        unit, n_units = layout_of(cfg)
        fwd = 0.0
        for kind in unit:
            f = _block_fwd_flops(kind, cfg, T, seq_ctx, decode) * n_units
            bd[kind] = bd.get(kind, 0.0) + f
            fwd += f
        head_f = 2 * T * cfg.d_model * cfg.vocab
        if decode:
            head_f = 2 * B * cfg.d_model * cfg.vocab
        bd["head"] = head_f
        fwd += head_f

    mult = 3.0 if shape.kind == "train" else 1.0
    flops = fwd * mult
    bd = {k: v * mult for k, v in bd.items()}

    # ---- HBM bytes -----------------------------------------------------
    P = n_params
    d = cfg.d_model
    L_eff = cfg.n_layers + cfg.n_encoder_layers
    bytes_total = 0.0
    if shape.kind == "train":
        # params: bf16 read per microbatch fwd+bwd; grads fp32 w+r;
        # adam m/v read+write + param update rw (fp32 master)
        bytes_total += P * (2.0 * 2 * grad_accum + 4 * 2 + 8 * 2 + 4 * 2)
        # activation checkpoints: carry per layer write (fwd) + read (bwd)
        # + recompute write
        bytes_total += 3 * L_eff * T * d * 2.0
        # logits: fp32 write+read fwd, write bwd (chunked but HBM-resident)
        bytes_total += 3 * T * cfg.vocab * 4.0
        bd["bytes_params"] = P * (2.0 * 2 * grad_accum + 32)
        bd["bytes_acts"] = 3 * L_eff * T * d * 2.0
        bd["bytes_logits"] = 3 * T * cfg.vocab * 4.0
    elif shape.kind == "prefill":
        bytes_total += P * 2.0
        bytes_total += 2 * L_eff * T * d * 2.0
        bytes_total += _cache_bytes(cfg, B, S)  # cache write
        bd["bytes_cache"] = _cache_bytes(cfg, B, S)
    else:  # decode
        bytes_total += P * 2.0  # weights stream once per step
        bytes_total += _cache_bytes(cfg, B, S)  # cache read
        bytes_total += 2 * B * cfg.vocab * 4.0
        bd["bytes_cache"] = _cache_bytes(cfg, B, S)
    bd["bytes_total"] = bytes_total

    return AnalyticCost(flops_global=flops, bytes_global=bytes_total, breakdown=bd)


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    """Decode-state bytes touched per step (read)."""
    if cfg.family == "audio":
        kv = cfg.n_layers * 2 * B * S * cfg.n_kv_heads * cfg.head_dim * 2.0
        cross = cfg.n_layers * 2 * B * 1500 * cfg.n_heads * cfg.head_dim * 2.0
        return kv + cross
    unit, n_units = layout_of(cfg)
    total = 0.0
    for kind in unit:
        if kind in ("attn", "attn_shared"):
            s_eff = min(S, cfg.attn_window) if cfg.attn_window else S
            if cfg.attention == "mla":
                m = cfg.mla
                total += n_units * B * s_eff * (m.kv_lora_rank
                                                + m.qk_rope_head_dim) * 2.0
            else:
                total += n_units * 2 * B * s_eff * cfg.n_kv_heads * \
                    cfg.head_dim * 2.0
        elif kind == "mamba2":
            s = cfg.ssm
            di = s.expand * cfg.d_model
            total += n_units * B * (di * s.d_state / s.head_dim * s.head_dim
                                    + (s.d_conv - 1) * (di + 2 * s.n_groups
                                                        * s.d_state)) * 4.0
            total += n_units * B * (di // s.head_dim) * s.head_dim * s.d_state * 4.0
        elif kind == "mlstm":
            di = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
            dh = di // cfg.n_heads
            total += n_units * B * cfg.n_heads * dh * dh * 4.0
        elif kind == "slstm":
            total += n_units * 4 * B * cfg.d_model * 4.0
    return total
