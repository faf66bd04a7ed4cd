"""Whisper-style encoder-decoder backbone (the conv audio frontend is a
stub: the batch carries precomputed frame embeddings (B, S_enc, d_model)).

The port's copy of the JAX package's ``models/encdec.py``, function for
function.  Encoder: ``n_encoder_layers`` blocks of bidirectional attention
(RoPE on the frames) and an MLP, then ``enc_norm``.  Decoder: ``n_layers``
blocks of causal self-attention, cross-attention to the encoder memory
and an MLP, then ``final_norm``.  Decode caches: per layer a bf16
self-attention KV cache and bf16 cross K/V computed once from the encoder
memory (`fill_cross_caches`) and read by every step.

Parameters are one `FlatParams` keyed by the reference's key paths:
``embed``, ``enc_norm/scale``, ``final_norm/scale``, ``lm_head``, the
encoder layers' ``enc/{ln1,ln2}/scale``, ``enc/attn/{wk,wo,wq,wv}`` and
``enc/mlp/{w_down,w_up}``, and the decoder layers'
``dec/{ln1,ln_x,ln2}/scale``, ``dec/self/{wk,wo,wq,wv}``,
``dec/cross/{wk,wo,wq,wv}`` and ``dec/mlp/{w_down,w_up}``, each stacked
over its layers on a leading axis.  The reference scans over the layers;
the port loops over them.  ``remat`` maps to ``torch.utils.checkpoint``
per layer.

Attention, as in the reference: the decoder's causal self-attention goes
through `layers.full_attention`, so the flash kernel takes it under
``use_attention_impl("flash")``; the encoder's bidirectional attention
and the cross-attention are `layers.blockwise_attention` (the memory's
S_enc keys padded to whole blocks of 512 and the padding masked), and one
decoded token attends to its caches with `layers.decode_attention`.
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
from repro_torch.models.layers import (blockwise_attention, decode_attention,
                                       dense_init, gqa_apply, gqa_cache_init,
                                       gqa_decode, gqa_init, mlp_apply,
                                       mlp_init, norm_to_matmuls,
                                       residual_norm, rmsnorm, rmsnorm_init)
from repro_torch.models.transformer import (_lm_head, _slice, cast_params,
                                            row_ce)
from repro_torch.utils.tree import FlatParams, flatten_nested, nested


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def _cross_init(generator: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"wq": dense_init(d, H * dh, generator),
            "wk": dense_init(d, H * dh, generator),
            "wv": dense_init(d, H * dh, generator),
            "wo": dense_init(H * dh, d, generator)}


def _layer_init(kind: str, generator: torch.Generator,
                cfg: ModelConfig) -> Dict[str, Any]:
    """One encoder (`kind` "enc") or decoder ("dec") layer's weights."""
    dev, d = generator.device, cfg.d_model
    attn = gqa_init(generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if kind == "enc":
        return {"ln1": rmsnorm_init(d, dev), "attn": attn,
                "ln2": rmsnorm_init(d, dev),
                "mlp": mlp_init(generator, d, cfg.d_ff, cfg.mlp)}
    return {"ln1": rmsnorm_init(d, dev), "self": attn,
            "ln_x": rmsnorm_init(d, dev), "cross": _cross_init(generator, cfg),
            "ln2": rmsnorm_init(d, dev),
            "mlp": mlp_init(generator, d, cfg.d_ff, cfg.mlp)}


def _layer_shapes(kind: str, cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """One layer's leaf shapes, by key path inside the layer."""
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {"wq": (d, H * dh), "wk": (d, Hkv * dh), "wv": (d, Hkv * dh),
            "wo": (H * dh, d)}
    mlp = {"w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}
    if cfg.mlp == "swiglu":
        mlp["w_gate"] = (d, cfg.d_ff)
    shapes = {"ln1/scale": (d,), "ln2/scale": (d,),
              **{f"mlp/{k}": v for k, v in mlp.items()}}
    if kind == "enc":
        shapes.update({f"attn/{k}": v for k, v in attn.items()})
    else:
        shapes["ln_x/scale"] = (d,)
        shapes.update({f"self/{k}": v for k, v in attn.items()})
        shapes.update({"cross/wq": (d, H * dh), "cross/wk": (d, H * dh),
                       "cross/wv": (d, H * dh), "cross/wo": (H * dh, d)})
    return shapes


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's shape, by key path, without allocating."""
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab, d), "enc_norm/scale": (d,),
              "final_norm/scale": (d,), "lm_head": (d, cfg.vocab)}
    for kind, n in (("enc", cfg.n_encoder_layers), ("dec", cfg.n_layers)):
        shapes.update({f"{kind}/{k}": (n,) + v
                       for k, v in _layer_shapes(kind, cfg).items()})
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator) -> FlatParams:
    """Random weights drawn from `generator`, on its device: embedding
    N(0, 0.02^2), dense weights N(0, 1/d_in), norm scales 1 (the numbers
    differ from the reference's; tests carry weights across with
    `models.registry.params_from_jax`).  The draws go the embedding, the
    encoder layers, the decoder layers, the head, the reference's order of
    keys; each leaf lands in its slice of one flat f32 buffer (a layer is
    drawn whole and copied in), so the model is held once, plus a layer."""
    dev = generator.device
    shapes = param_shapes(cfg)
    params = FlatParams(torch.empty(sum(math.prod(s) for s in shapes.values()),
                                    device=dev), shapes)
    params["embed"].normal_(generator=generator).mul_(0.02)
    for kind, n in (("enc", cfg.n_encoder_layers), ("dec", cfg.n_layers)):
        for u in range(n):
            for k, v in flatten_nested(_layer_init(kind, generator, cfg)).items():
                params[f"{kind}/{k}"][u].copy_(v)
    params["enc_norm/scale"].fill_(1.0)
    params["final_norm/scale"].fill_(1.0)
    params["lm_head"].normal_(generator=generator).div_(math.sqrt(cfg.d_model))
    return params


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _cross_apply(p, x: torch.Tensor, memory: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of x (B, S, d) to the encoder memory (B, Sm, d): no
    RoPE, no mask but the memory's block padding."""
    B, S, _ = x.shape
    Sm = memory.shape[1]
    H, dh = cfg.n_heads, cfg.head_dim
    q = (x.to(p["wq"].dtype) @ p["wq"]).reshape(B, S, H, dh)
    k = (memory @ p["wk"]).reshape(B, Sm, H, dh)
    v = (memory @ p["wv"]).reshape(B, Sm, H, dh)
    o = blockwise_attention(q, k, v, causal=False)
    return o.reshape(B, S, H * dh) @ p["wo"]


def _attn(p, h: torch.Tensor, cfg: ModelConfig, causal: bool) -> torch.Tensor:
    return gqa_apply(p, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                     d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
                     causal=causal)


def _enc_layer(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h, n = residual_norm(p["ln2"], h, _attn(p["attn"], norm_to_matmuls(p["ln1"], h),
                                            cfg, causal=False))
    return h + mlp_apply(p["mlp"], n, cfg.mlp)


def _dec_layer(p, h: torch.Tensor, memory: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    h, n = residual_norm(p["ln_x"], h, _attn(p["self"], norm_to_matmuls(p["ln1"], h),
                                             cfg, causal=True))
    h, n = residual_norm(p["ln2"], h, _cross_apply(p["cross"], n, memory, cfg))
    return h + mlp_apply(p["mlp"], n, cfg.mlp)


def _run_layers(layer, stacked, n: int, h: torch.Tensor, cfg: ModelConfig,
                remat: bool, *extra) -> torch.Tensor:
    """`layer` over the n stacked layers, each checkpointed when `remat`."""
    impl = attention_impl()

    def run(p, y, *e):
        # the recompute runs in the backward pass, after the caller's
        # attention switch is gone: pin the one the forward pass used
        with use_attention_impl(impl):
            return layer(p, y, *e, cfg)

    for u in range(n):
        p = _slice(stacked, u)
        h = (checkpoint(run, p, h, *extra, use_reentrant=False) if remat
             else layer(p, h, *extra, cfg))
    return h


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = False) -> torch.Tensor:
    """The encoder memory (B, S_enc, d) of `frames` (B, S_enc, d) in the
    compute dtype; ``params`` is the nested (cast) dict."""
    h = _run_layers(_enc_layer, params["enc"], cfg.n_encoder_layers, frames,
                    cfg, remat)
    return rmsnorm(params["enc_norm"], h)


def decode_train(params, tokens_embedded: torch.Tensor, memory: torch.Tensor,
                 cfg: ModelConfig, *, remat: bool = False) -> torch.Tensor:
    """The decoder's final-normed hidden states (B, S, d) over the
    embedded tokens, attending to `memory`."""
    h = _run_layers(_dec_layer, params["dec"], cfg.n_layers, tokens_embedded,
                    cfg, remat, memory)
    return rmsnorm(params["final_norm"], h)


def _hidden(params, batch, cfg: ModelConfig, dtype: torch.dtype, remat: bool):
    """(cast params, the decoder's hidden states) of a batch of frames and
    tokens."""
    p = cast_params(nested(params), dtype)
    memory = encode(p, batch["frames"].to(dtype), cfg, remat=remat)
    x = p["embed"][batch["tokens"].long()].to(dtype)
    return p, decode_train(p, x, memory, cfg, remat=remat)


def lm_loss_rows(params: Mapping[str, torch.Tensor], batch, cfg: ModelConfig,
                 *, dtype: torch.dtype = torch.bfloat16, remat: bool = True,
                 loss_chunk: int = 512) -> torch.Tensor:
    """(B,) per-row loss: row i's mean next-token loss given its own frames,
    which is the reference's `lm_loss` on the batch of that one row (rows
    never mix: the encoder, the decoder and the cross-attention attend
    within a row)."""
    p, h = _hidden(params, batch, cfg, dtype, remat)
    targets = F.pad(batch["tokens"].long()[:, 1:], (0, 1))
    return row_ce(p, h, targets, cfg, loss_chunk)


def lm_loss(params: Mapping[str, torch.Tensor], batch, cfg: ModelConfig,
            **kw) -> torch.Tensor:
    """The reference's `lm_loss`: the batch's mean masked next-token loss
    (every row has S - 1 targets, so the mean of `lm_loss_rows`)."""
    return lm_loss_rows(params, batch, cfg, **kw).mean()


@torch.no_grad()
def prefill(params: Mapping[str, Any], batch, cfg: ModelConfig, *,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inference prefill: encode the frames and run the decoder over the
    prompt, forward only; the last position's logits (B, vocab) f32."""
    p, h = _hidden(params, batch, cfg, dtype, remat=False)
    return _lm_head(p, h[:, -1], cfg)


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, seq: int, enc_len: int,
                device=None) -> Dict[str, Any]:
    """Empty caches stacked over the decoder layers: ``{"self": {k, v: (n,
    B, seq, Hkv, D) bf16, len: (n,) int32}, "cross_k", "cross_v": (n, B,
    enc_len, H, D) bf16 zeros}``."""
    n, H, dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    one = gqa_cache_init(batch, seq, cfg.n_kv_heads, dh, device=device)
    self_c = {k: v.expand((n,) + v.shape).clone() for k, v in one.items()}
    shape = (n, batch, enc_len, H, dh)
    return {"self": self_c,
            "cross_k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "cross_v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _promoted_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the two dtypes' promotion, as JAX multiplies bf16 by f32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


@torch.no_grad()
def fill_cross_caches(params: Mapping[str, Any], memory: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each decoder layer's cross K and V of the encoder memory (B, Sm, d),
    (n, B, Sm, H, D) bf16: the memory times the weights as given (f32
    master weights promote a bf16 memory to f32, as in the reference), then
    rounded to bf16."""
    cross = nested(params)["dec"]["cross"]
    B, Sm, _ = memory.shape
    H, dh = cfg.n_heads, cfg.head_dim
    ks, vs = (torch.empty((cfg.n_layers, B, Sm, H, dh), dtype=torch.bfloat16,
                          device=memory.device) for _ in range(2))
    for u in range(cfg.n_layers):
        ks[u] = _promoted_mm(memory, cross["wk"][u]).reshape(B, Sm, H, dh)
        vs[u] = _promoted_mm(memory, cross["wv"][u]).reshape(B, Sm, H, dh)
    return ks, vs


@torch.no_grad()
def decode_step(params: Mapping[str, Any], batch, caches, cfg: ModelConfig,
                *, dtype: torch.dtype = torch.bfloat16):
    """One decoder token, batch ``{"tokens": (B, 1)}``, against the caches
    of `init_caches` (the cross K/V already in them); returns (logits (B,
    vocab) f32, new caches).  The self-attention caches' k and v are
    written in place (`layers.gqa_decode`); the cross caches are read
    only.  float32 leaves of ``params`` are cast to `dtype` on every call,
    leaves already in `dtype` are used as they are."""
    p = cast_params(nested(params), dtype)
    x = p["embed"][batch["tokens"].long()].to(dtype)
    H, dh = cfg.n_heads, cfg.head_dim
    ck, cv = caches["cross_k"], caches["cross_v"]
    lens = []
    for u in range(cfg.n_layers):
        blk = _slice(p["dec"], u)
        a, new = gqa_decode(blk["self"], rmsnorm(blk["ln1"], x),
                            {k: v[u] for k, v in caches["self"].items()},
                            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                            d_head=dh, rope_theta=cfg.rope_theta)
        lens.append(new["len"])
        x, n = residual_norm(blk["ln_x"], x, a)
        B = x.shape[0]
        q = (n[:, 0].to(blk["cross"]["wq"].dtype) @ blk["cross"]["wq"]).reshape(B, H, dh)
        o = decode_attention(q, ck[u], cv[u], ck.shape[2])
        x, n = residual_norm(blk["ln2"], x, o.reshape(B, 1, H * dh) @ blk["cross"]["wo"])
        x = x + mlp_apply(blk["mlp"], n, cfg.mlp)
    h = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    logits = _lm_head(p, h[:, 0], cfg)
    return logits, {"self": {**caches["self"], "len": torch.stack(lens)},
                    "cross_k": ck, "cross_v": cv}
