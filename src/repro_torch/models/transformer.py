"""Decoder-only LM: a stack of blocks over stacked layer weights.

The port's copy of the JAX package's ``models/transformer.py`` for the GQA
token decoders (InternLM2 and its kind), the MoE family (Qwen-MoE,
Moonlight), multi-head latent attention (MiniCPM3), the Mamba2 hybrid
(Zamba2) and xLSTM, with the reference's two frontends: token ids
(``batch["tokens"]``) or precomputed frame embeddings (``frontend=
"frames"``: ``batch["frames"]`` (B, S, d_model) in, ``batch["targets"]``
the loss's labels).  The encoder-decoder family is `models.encdec`.  A
model is ``n_units`` repeats of a unit of blocks
(`layout_of`): one attention block for the dense stacks, five ``mamba2``
blocks and one ``attn_shared`` block for Zamba2, an ``mlstm`` and an
``slstm`` block for xLSTM.  Parameters are one
`FlatParams` keyed by the reference's key paths: ``embed``,
``final_norm/scale``, ``lm_head``; for each unit position ``u{pos}`` its
blocks' weights stacked over the units on a leading axis, an attention
block's as ``u0/{ln1,ln2}/scale``, ``u0/mixer/{wk,wo,wq,wv}`` for GQA or
``u0/mixer/{kv_norm/scale, q_norm/scale,w_dkv,w_dq,w_uk,w_uq,w_uv,wo}``
for MLA, and ``u0/mlp/{w_down,w_gate,w_up}`` for a dense FFN or
``u0/mlp/{router,shared/{w_down,w_gate,w_up},shared_gate,w_down,w_gate,
w_up}`` for an MoE one, a Mamba2 block's as ``u0/ln1/scale`` and
``u0/mixer/{a_log,conv_b,conv_w,d_skip,dt_bias,out_norm/scale,w_in,
w_out}`` (no FFN), an mLSTM block's as ``u0/ln1/scale`` and
``u0/mixer/{cell_norm/scale,gate_bias,w_down,w_gates,w_k,w_q,w_up,w_v,
w_z}``, an sLSTM block's as ``u1/ln1/scale`` and ``u1/mixer/{bias,
cell_norm/scale,mlp_down,mlp_up,r,w_in}`` (no FFN either: each carries
its own up-projection); and an ``attn_shared`` position's one set of attention
block weights under ``shared/`` (no stack), used by every unit.  The flat
vector is the reference's ``ravel_pytree`` of its parameter tree.  The
reference scans over the units; the port loops over them, and inside each
unit over its positions.  ``remat`` maps to ``torch.utils.checkpoint`` per
block.

Forward flavours, as in the reference:

  * `lm_loss` (and its per-row form `lm_loss_rows`): train, full
    sequence, chunked cross-entropy, plus the MoE router's aux term;
  * `prefill`: full sequence, forward only, the last position's logits;
  * `decode_step`: one token against the caches of `init_caches`, one per
    unit position stacked over the units (an attention block's KV cache,
    an MLA block's latent cache (`models.mla`), a Mamba2 block's conv and
    SSM states (`models.mamba2`), an mLSTM block's matrix memory and an
    sLSTM block's scalar states (`models.xlstm`), and for ``attn_shared``
    a KV cache per occurrence, ``min(seq, attn_window)`` slots each).

An mLSTM block trains and prefills with the chunkwise-parallel form at
the reference's chunk of 256 (`xlstm.mlstm_chunked`), an sLSTM block with
a loop over time; each decodes one token with its recurrent step.

An MoE FFN routes each token group under its own capacity
(`models.moe`): the batch's tokens in `lm_loss` and `prefill`, each row's
in `lm_loss_rows` (the reference's per-row loss is its batch loss on a
batch of one row), each step's B tokens in `decode_step`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention_config import (attention_impl,
                                                 use_attention_impl)
from repro_torch.models.layers import (gqa_apply, gqa_cache_init, gqa_decode,
                                       gqa_init, mlp_apply, mlp_init,
                                       norm_to_matmuls, residual_norm, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.mamba2 import (mamba2_apply, mamba2_cache_init,
                                       mamba2_decode, mamba2_init,
                                       mamba2_param_shapes)
from repro_torch.models.mla import (mla_apply, mla_cache_init, mla_decode,
                                    mla_init)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.xlstm import (mlstm_cache_init, mlstm_chunked,
                                      mlstm_init, mlstm_step, slstm_apply,
                                      slstm_cache_init, slstm_init, slstm_step,
                                      xlstm_param_shapes)
from repro_torch.utils.tree import FlatParams, flatten_nested, nested


_BLOCKS = {"attn", "attn_shared", "mamba2", "mlstm", "slstm"}  # the kinds ported
_RECURRENT = ("mamba2", "mlstm", "slstm")  # blocks of ln1 and a mixer, no FFN


def layout_of(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int]:
    """(unit, n_units) of a decoder whose unit is made of attention blocks
    (GQA or MLA; ``attn_shared`` for one set of weights shared by every
    unit), Mamba2 blocks and mLSTM and sLSTM blocks, whatever its family
    label (the reference's `layout_of` looks only at the unit), with a
    dense or an MoE FFN and either frontend.  An encoder-decoder (family
    ``"audio"``) has no unit of blocks: its layers are `models.encdec`'s,
    and this raises for it, as for every other model."""
    unit = tuple(cfg.layout_unit) if cfg.layout_unit else ("attn",)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: an encoder-decoder (family 'audio') "
                         "is built from models.encdec, not from a unit of "
                         "blocks; models.registry.build gives its model")
    if cfg.frontend not in ("tokens", "frames"):
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r}; the "
                         "reference's are 'tokens' and 'frames'")
    if (cfg.mlp == "moe") != (cfg.moe is not None):
        raise ValueError(f"{cfg.name}: mlp {cfg.mlp!r} with moe {cfg.moe!r}; "
                         "an MoE FFN takes mlp='moe' and its MoEConfig")
    if (cfg.attention == "mla") != (cfg.mla is not None):
        raise ValueError(f"{cfg.name}: attention {cfg.attention!r} with mla "
                         f"{cfg.mla!r}; an MLA mixer takes attention='mla' "
                         "and its MLAConfig")
    if "mamba2" in unit and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: unit {unit} with ssm None; a mamba2 "
                         "block takes its SSMConfig")
    if {"mlstm", "slstm"} & set(unit) and cfg.xlstm is None:
        raise ValueError(f"{cfg.name}: unit {unit} with xlstm None; an mlstm "
                         "or slstm block takes its XLSTMConfig")
    if not (set(unit) <= _BLOCKS and cfg.attention in ("gqa", "mla")):
        raise NotImplementedError(
            f"{cfg.name}: unit {unit}, attention {cfg.attention!r} is not a "
            "model of the reference (ROADMAP.md queue 1 item 9)")
    if cfg.n_layers % len(unit):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                         f"whole units of {unit}")
    return unit, cfg.n_layers // len(unit)


def _stacked(unit) -> Tuple[int, ...]:
    """The unit positions whose blocks are stacked over the units (all but
    the shared attention)."""
    return tuple(pos for pos, kind in enumerate(unit) if kind != "attn_shared")


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def _block_init(kind: str, generator: torch.Generator,
                cfg: ModelConfig) -> Dict[str, Any]:
    dev = generator.device
    if kind in _RECURRENT:
        mixer = (mamba2_init(generator, cfg.d_model, cfg.ssm) if kind == "mamba2" else
                 (mlstm_init if kind == "mlstm" else slstm_init)(
                     generator, cfg.d_model, cfg.n_heads, cfg.xlstm))
        return {"ln1": rmsnorm_init(cfg.d_model, dev), "mixer": mixer}
    p: Dict[str, Any] = {"ln1": rmsnorm_init(cfg.d_model, dev),
                         "ln2": rmsnorm_init(cfg.d_model, dev),
                         "mixer": (mla_init(generator, cfg.d_model, cfg.n_heads,
                                            cfg.mla) if cfg.mla else
                                   gqa_init(generator, cfg.d_model, cfg.n_heads,
                                            cfg.n_kv_heads, cfg.head_dim)),
                         "mlp": (moe_init(generator, cfg.d_model, cfg.moe)
                                 if cfg.moe else
                                 mlp_init(generator, cfg.d_model, cfg.d_ff,
                                          cfg.mlp))}
    if cfg.qk_norm and not cfg.mla:  # the reference's MLA has no QK-norm
        p["mixer"]["q_norm"] = rmsnorm_init(cfg.head_dim, dev)
        p["mixer"]["k_norm"] = rmsnorm_init(cfg.head_dim, dev)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator) -> FlatParams:
    """Random weights drawn from `generator`, on its device: embedding
    N(0, 0.02^2), dense weights N(0, 1/d_in), norm scales 1.  The numbers
    differ from the JAX package's ``init_params`` (torch's generator is
    not jax.random); tests carry weights across with
    `models.registry.params_from_jax`.

    The draws go in the reference's order of keys: the embedding, the
    head, each stacked unit position's blocks unit by unit, then the
    shared block.  Each leaf lands in its slice of one flat f32 buffer:
    the embedding and the head are drawn in place, and each block is
    drawn whole and copied in, so the model is held once, plus a block."""
    unit, n_units = layout_of(cfg)
    dev = generator.device
    shapes = param_shapes(cfg)
    params = FlatParams(torch.empty(sum(math.prod(s) for s in shapes.values()),
                                    device=dev), shapes)
    params["embed"].normal_(generator=generator).mul_(0.02)
    params["final_norm/scale"].fill_(1.0)
    if not cfg.tie_embeddings:
        params["lm_head"].normal_(generator=generator).div_(math.sqrt(cfg.d_model))
    for pos in _stacked(unit):
        for u in range(n_units):
            for k, v in flatten_nested(_block_init(unit[pos], generator, cfg)).items():
                params[f"u{pos}/{k}"][u].copy_(v)
    if "attn_shared" in unit:
        for k, v in flatten_nested(_block_init("attn_shared", generator, cfg)).items():
            params[f"shared/{k}"].copy_(v)
    return params


def _block_shapes(kind: str, cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """One block's leaf shapes, by key path inside the block."""
    d, hd = cfg.d_model, cfg.head_dim
    if kind in _RECURRENT:
        mixer = (mamba2_param_shapes(d, cfg.ssm) if kind == "mamba2" else
                 xlstm_param_shapes(d, cfg.n_heads, cfg.xlstm)[kind])
        return {"ln1/scale": (d,), **{f"mixer/{k}": v for k, v in mixer.items()}}
    shapes = {"ln1/scale": (d,), "ln2/scale": (d,)}
    if cfg.mla:
        m, H = cfg.mla, cfg.n_heads
        shapes.update({
            "mixer/w_dq": (d, m.q_lora_rank),
            "mixer/q_norm/scale": (m.q_lora_rank,),
            "mixer/w_uq": (m.q_lora_rank,
                           H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
            "mixer/w_dkv": (d, m.kv_lora_rank + m.qk_rope_head_dim),
            "mixer/kv_norm/scale": (m.kv_lora_rank,),
            "mixer/w_uk": (m.kv_lora_rank, H * m.qk_nope_head_dim),
            "mixer/w_uv": (m.kv_lora_rank, H * m.v_head_dim),
            "mixer/wo": (H * m.v_head_dim, d)})
    else:
        shapes.update({"mixer/wq": (d, cfg.n_heads * hd),
                       "mixer/wk": (d, cfg.n_kv_heads * hd),
                       "mixer/wv": (d, cfg.n_kv_heads * hd),
                       "mixer/wo": (cfg.n_heads * hd, d)})
        if cfg.qk_norm:
            shapes["mixer/q_norm/scale"] = (hd,)
            shapes["mixer/k_norm/scale"] = (hd,)
    if cfg.moe:
        E, f, fs = cfg.moe.num_experts, cfg.moe.d_expert, cfg.moe.d_shared
        shapes.update({"mlp/router": (d, E), "mlp/w_gate": (E, d, f),
                       "mlp/w_up": (E, d, f), "mlp/w_down": (E, f, d)})
        if cfg.moe.num_shared > 0:
            shapes.update({"mlp/shared/w_gate": (d, fs), "mlp/shared/w_up": (d, fs),
                           "mlp/shared/w_down": (fs, d), "mlp/shared_gate": (d, 1)})
    else:
        shapes["mlp/w_up"] = (d, cfg.d_ff)
        shapes["mlp/w_down"] = (cfg.d_ff, d)
        if cfg.mlp == "swiglu":
            shapes["mlp/w_gate"] = (d, cfg.d_ff)
    return shapes


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's shape, by key path, without allocating."""
    unit, n_units = layout_of(cfg)
    shapes = {"embed": (cfg.vocab, cfg.d_model), "final_norm/scale": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab)
    for pos in _stacked(unit):
        shapes.update({f"u{pos}/{k}": (n_units,) + v
                       for k, v in _block_shapes(unit[pos], cfg).items()})
    if "attn_shared" in unit:
        shapes.update({f"shared/{k}": v
                       for k, v in _block_shapes("attn_shared", cfg).items()})
    return shapes


def cast_params(params: Mapping[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Float32 leaves of a nested parameter dict cast to the compute dtype
    (f32 master weights stay with the caller; norms, softmax and the loss
    still accumulate in f32)."""
    return {k: cast_params(v, dtype) if isinstance(v, Mapping)
            else (v.to(dtype) if v.dtype == torch.float32 else v)
            for k, v in params.items()}


def _embed(params, batch, cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    if cfg.frontend == "frames":
        return batch["frames"].to(dtype)  # precomputed stub embeddings
    return params["embed"][batch["tokens"].long()].to(dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D) with an f32 result from bf16 operands: the tensor cores'
    bf16 product with f32 output on the card (``torch.mm(...,
    out_dtype=float32)``, which the CPU build lacks), the upcast product on
    the CPU.  Products of bf16 values are exact in f32, so the two differ
    only in the order of the sum."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _HeadMatmul(torch.autograd.Function):
    """h @ w with f32 logits from bf16 h and w (the reference's
    ``preferred_element_type=f32``, transformer.py:216).  The backward
    rounds the f32 cotangent to bf16 and takes both products the same way,
    so every GEMM of the head runs on the tensor cores; the gradients come
    out in the operands' dtype, as the reference's do."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _mm_f32(h.reshape(-1, h.shape[-1]), w).reshape(
            *h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        h2 = h.reshape(-1, h.shape[-1])
        g2 = g.reshape(-1, g.shape[-1]).to(w.dtype)
        dh = _mm_f32(g2, w.t()).to(h.dtype).reshape(h.shape)
        dw = _mm_f32(h2.t(), g2).to(w.dtype)
        return dh, dw


def _lm_head(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    if h.dtype == torch.float32 and w.dtype == torch.float32:
        return h @ w
    return _HeadMatmul.apply(h, w)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _ffn(p, h: torch.Tensor, cfg: ModelConfig, per_row: bool):
    """The block's FFN on h (B, S, d): (out, aux).  An MoE FFN routes
    each row as its own token group when `per_row`, else the whole batch
    as one; aux is then (B,) or (1,).  A dense FFN's aux is None."""
    if cfg.moe is None:
        return mlp_apply(p, h, cfg.mlp), None
    h = h.to(p["w_up"].dtype)  # the norm's output, one cast for every use
    B, S, d = h.shape
    out, aux = moe_apply(p, h if per_row else h.reshape(1, B * S, d), cfg.moe)
    return out.reshape(B, S, d), aux


def _block_apply(kind: str, p, x: torch.Tensor, cfg: ModelConfig,
                 per_row: bool):
    if kind in _RECURRENT or cfg.mla:
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "mamba2":
        return x + mamba2_apply(p["mixer"], h, cfg.d_model, cfg.ssm), None
    if kind == "mlstm":
        return x + mlstm_chunked(p["mixer"], h, cfg.n_heads), None
    if kind == "slstm":
        return x + slstm_apply(p["mixer"], h, cfg.n_heads), None
    if cfg.mla:
        h = mla_apply(p["mixer"], h, n_heads=cfg.n_heads, cfg=cfg.mla,
                      rope_theta=cfg.rope_theta, window=cfg.attn_window)
    else:
        h = gqa_apply(p["mixer"], norm_to_matmuls(p["ln1"], x, cfg.norm_eps),
                      n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                      d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
                      window=cfg.attn_window, qk_norm=cfg.qk_norm)
    x, h2 = residual_norm(p["ln2"], x, h, cfg.norm_eps)
    out, aux = _ffn(p["mlp"], h2, cfg, per_row)
    return x + out, aux


def _unit_blocks(params, unit, u: int):
    """Unit u's blocks in order: (kind, weights), the shared attention's
    one set of weights at its position."""
    return [(kind, params["shared"] if kind == "attn_shared"
             else _slice(params[f"u{pos}"], u)) for pos, kind in enumerate(unit)]


def forward_hidden(params, x: torch.Tensor, cfg: ModelConfig, *,
                   remat: bool = False, per_row: bool = False):
    """Run the block stack on x (B, S, d), the embedded input, unit by unit
    and inside each unit position by position; returns (the final-normed
    hidden states, aux): aux is the MoE router's aux loss summed over the
    layers, per token group ((B,) f32 when `per_row`, else (1,)), and None
    for a dense FFN.  ``params`` is the nested (cast) dict."""
    unit, n_units = layout_of(cfg)
    impl = attention_impl()

    def block(kind, p, y):
        # the recompute runs in the backward pass, after the caller's
        # attention switch is gone: pin the one the forward pass used
        with use_attention_impl(impl):
            return _block_apply(kind, p, y, cfg, per_row)

    aux = None
    for u in range(n_units):
        for kind, p in _unit_blocks(params, unit, u):
            if remat:
                x, a = checkpoint(block, kind, p, x, use_reentrant=False)
            else:
                x, a = _block_apply(kind, p, x, cfg, per_row)
            if a is not None:
                aux = a if aux is None else aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _slice(tree, u: int):
    """Layer u's weights: a view of each stacked leaf."""
    return {k: _slice(v, u) if isinstance(v, Mapping) else v[u]
            for k, v in tree.items()}


def row_ce(params, h: torch.Tensor, targets: torch.Tensor, cfg: ModelConfig,
           loss_chunk: int = 512) -> torch.Tensor:
    """(B,) each row's mean token loss of the final hidden states h (B, S,
    d) against `targets` (B, S), the last position masked, as the
    reference's mask of S - 1 ones.  The logits are taken `loss_chunk`
    positions at a time (f32, from bf16 operands)."""
    B, S, _ = h.shape
    targets = targets.long()
    C = min(loss_chunk, S)
    total = torch.zeros(B, device=h.device)
    for a in range(0, S, C):
        logits = _lm_head(params, h[:, a:a + C], cfg)
        logz = torch.logsumexp(logits, dim=-1)
        true = logits.gather(-1, targets[:, a:a + C, None])[..., 0]
        valid = torch.arange(a, a + logits.shape[1], device=h.device) < S - 1
        total = total + ((logz - true) * valid).sum(dim=-1)
    return total / max(S - 1, 1)


def _loss_terms(params: Mapping[str, torch.Tensor], batch, cfg: ModelConfig,
                *, per_row: bool, dtype: torch.dtype = torch.bfloat16,
                remat: bool = True, loss_chunk: int = 512):
    """(ce (B,): each row's mean masked token loss, aux: the router term
    ``router_aux_weight * aux / n_units`` per token group, or None for a
    dense FFN).  The targets are the next tokens, or ``batch["targets"]``
    under the frames frontend."""
    p = cast_params(nested(params), dtype)
    h, aux = forward_hidden(p, _embed(p, batch, cfg, dtype), cfg, remat=remat,
                            per_row=per_row)
    if cfg.frontend == "frames":
        targets = batch["targets"]
    else:
        targets = F.pad(batch["tokens"].long()[:, 1:], (0, 1))
    ce = row_ce(p, h, targets, cfg, loss_chunk)
    if aux is None:
        return ce, None
    _, n_units = layout_of(cfg)
    return ce, cfg.moe.router_aux_weight * aux / n_units


def lm_loss_rows(params: Mapping[str, torch.Tensor], batch, cfg: ModelConfig,
                 **kw) -> torch.Tensor:
    """(B,) per-row loss: row i's value is what the reference's `lm_loss`
    gives on the batch of that one row, the mean masked token loss of
    document i plus, for an MoE FFN, the router's aux term of row i routed
    as its own token group.  Rows never mix in attention, and each row is
    its own MoE group here, so one batched forward computes every row's
    loss, and a row's loss does not depend on the other rows of its
    batch."""
    ce, aux = _loss_terms(params, batch, cfg, per_row=True, **kw)
    return ce if aux is None else ce + aux


def lm_loss_terms(params: Mapping[str, torch.Tensor], batch, cfg: ModelConfig,
                  **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two terms of `lm_loss`: (the batch's mean masked token loss,
    the MoE router's aux term ``router_aux_weight * aux / n_units`` with
    the batch's B*S tokens routed as one group; 0.0 for a dense FFN)."""
    ce, aux = _loss_terms(params, batch, cfg, per_row=False, **kw)
    return ce.mean(), (ce.new_zeros(()) if aux is None else aux[0])


def lm_loss(params: Mapping[str, torch.Tensor], batch, cfg: ModelConfig,
            **kw) -> torch.Tensor:
    """The reference's `lm_loss`: the batch's mean masked token loss (every
    row has S - 1 targets, so the mean of the rows' means) and, for an MoE
    FFN, the router's aux term over the batch as one token group, so the
    MoE batch loss is not the mean of `lm_loss_rows`."""
    ce, aux = lm_loss_terms(params, batch, cfg, **kw)
    return ce + aux


# --------------------------------------------------------------------------
# Serving: KV caches, one-token decode, prefill
# --------------------------------------------------------------------------


def _block_cache_init(kind: str, cfg: ModelConfig, batch: int, seq: int,
                      device=None) -> Dict[str, torch.Tensor]:
    if kind == "mamba2":  # f32 states, the reference's default
        return mamba2_cache_init(batch, cfg.d_model, cfg.ssm, device=device)
    if kind == "mlstm":  # f32 states, the stabiliser at -inf
        return mlstm_cache_init(batch, cfg.d_model, cfg.n_heads, cfg.xlstm,
                                device=device)
    if kind == "slstm":
        return slstm_cache_init(batch, cfg.d_model, cfg.n_heads, device=device)
    if cfg.mla:  # the latent cache: bf16, as the reference's default
        return mla_cache_init(batch, seq, cfg.mla, device=device)
    win = cfg.attn_window
    s = min(seq, win) if win else seq
    return gqa_cache_init(batch, s, cfg.n_kv_heads, cfg.head_dim,
                          device=device)


def _block_decode(kind: str, p, x: torch.Tensor, cache, cfg: ModelConfig):
    """One block on the step's x (B, 1, d); an MoE FFN routes the step's B
    tokens as one group, as the reference's ``moe_apply`` on (B, 1, d)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in _RECURRENT:
        if kind == "mamba2":
            out, cache = mamba2_decode(p["mixer"], h, cache, cfg.d_model, cfg.ssm)
        else:
            step = mlstm_step if kind == "mlstm" else slstm_step
            out, cache = step(p["mixer"], h, cache, cfg.n_heads)
        return x + out, cache
    if cfg.mla:
        h, cache = mla_decode(p["mixer"], h, cache, n_heads=cfg.n_heads,
                              cfg=cfg.mla, rope_theta=cfg.rope_theta)
    else:
        h, cache = gqa_decode(p["mixer"], h, cache, n_heads=cfg.n_heads,
                              n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
                              rope_theta=cfg.rope_theta, window=cfg.attn_window,
                              qk_norm=cfg.qk_norm)
    x, h2 = residual_norm(p["ln2"], x, h, cfg.norm_eps)
    out, _ = _ffn(p["mlp"], h2, cfg, per_row=False)
    return x + out, cache


def init_caches(cfg: ModelConfig, batch: int, seq: int,
                device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Empty caches for every block of the unit, stacked over the units on
    a leading axis: ``{"u0": {k, v: (n_units, B, S, Hkv, D) bf16, len:
    (n_units,) int32}}``, for MLA ``{"u0": {c_kv: (n_units, B, S,
    kv_lora), k_rope: (n_units, B, S, rope) bf16, len}}``, for a Mamba2
    position ``{conv: (n_units, B, d_conv - 1, conv_dim), ssm: (n_units,
    B, H, head_dim, d_state)}`` f32, for an mLSTM position ``{C: (n_units,
    B, H, dh, dh), n: (n_units, B, H, dh), m: (n_units, B, H)}`` f32, for
    an sLSTM position ``{c, n, h, m: (n_units, B, H, dh)}`` f32 (each m at
    -inf), and for the shared attention one KV cache per occurrence, of
    ``min(seq, attn_window)`` slots."""
    unit, n_units = layout_of(cfg)
    caches = {}
    for pos, kind in enumerate(unit):
        one = _block_cache_init(kind, cfg, batch, seq, device)
        caches[f"u{pos}"] = {k: v.expand((n_units,) + v.shape).clone()
                             for k, v in one.items()}
    return caches


@torch.no_grad()
def decode_step(params: Mapping[str, Any], batch, caches, cfg: ModelConfig,
                *, dtype: torch.dtype = torch.bfloat16):
    """One-token decode: batch ``{"tokens": (B, 1)}``; returns (logits (B,
    vocab) f32, new caches, every unit position's).  ``params`` is flat or
    nested; float32 leaves are cast to `dtype` on every call, as in the
    reference, and leaves already in `dtype` are used as they are (so a
    caller may cast once).  Each block's cache leaves but ``len`` are
    written in place (`layers.gqa_decode`, `mla.mla_decode`,
    `mamba2.mamba2_decode`, `xlstm.mlstm_step`, `xlstm.slstm_step`)."""
    unit, n_units = layout_of(cfg)
    p = cast_params(nested(params), dtype)
    x = _embed(p, batch, cfg, dtype)
    lens = {pos: [] for pos in range(len(unit)) if "len" in caches[f"u{pos}"]}
    for u in range(n_units):
        for pos, (kind, blk) in enumerate(_unit_blocks(p, unit, u)):
            c = caches[f"u{pos}"]
            x, new = _block_decode(kind, blk, x, {k: v[u] for k, v in c.items()},
                                   cfg)
            if pos in lens:
                lens[pos].append(new["len"])
    h = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    logits = _lm_head(p, h[:, 0], cfg)
    return logits, {f"u{pos}": {**caches[f"u{pos}"], **(
        {"len": torch.stack(lens[pos])} if pos in lens else {})}
        for pos in range(len(unit))}


@torch.no_grad()
def prefill(params: Mapping[str, Any], batch, cfg: ModelConfig, *,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inference prefill: the full-sequence forward, forward only, giving
    the last position's logits (B, vocab) f32.  A GQA block's attention
    goes through `layers.full_attention`, so the flash kernel takes it
    under ``use_attention_impl("flash")`` unless the block attends in a
    window (Zamba2's shared block); an MLA block's is blockwise whatever
    the switch, as in the reference.  A Mamba2 block runs the chunked
    SSD, an mLSTM block the chunkwise-parallel form, an sLSTM block its
    loop over time."""
    p = cast_params(nested(params), dtype)
    x = _embed(p, batch, cfg, dtype)
    h, _ = forward_hidden(p, x, cfg, remat=False)
    return _lm_head(p, h[:, -1], cfg)
