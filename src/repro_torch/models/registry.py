"""The model facade: init, loss, decode and objective of a configuration.

The port's copy of the JAX package's ``models/registry.py`` for the GQA
token decoders, the MoE family, MLA, the Mamba2 hybrid (Zamba2), xLSTM
and the encoder-decoder family (Whisper, `EncDecModel` over
`models.encdec`), with `Model.input_specs` / `Model.sample_batch`, and the
bridge that carries the JAX model's weights across: `params_from_jax`
takes the reference's nested parameter tree (as numpy; a hybrid's
``shared`` block, every unit position ``u{pos}`` and an encoder-decoder's
``enc`` / ``dec`` stacks included) and gives the port's `FlatParams`, in
the same flat order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, transformer
from repro_torch.utils.tree import FlatParams, flatten_nested, key_order, nested


@dataclass
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device=None) -> FlatParams:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        (None: the card; raises without one)."""
        from repro_torch.core.engine import resolve_device
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return transformer.init_params(self.cfg, gen)

    def loss_fn(self, params, batch, **kw) -> torch.Tensor:
        """The batch's mean token loss, plus an MoE router's aux term
        (`transformer.lm_loss`)."""
        return transformer.lm_loss(params, batch, self.cfg, **kw)

    def per_row_loss_fn(self, params, batch, **kw) -> torch.Tensor:
        """(B,) each row's loss, as the batch loss of that row alone
        (`transformer.lm_loss_rows`)."""
        return transformer.lm_loss_rows(params, batch, self.cfg, **kw)

    def decode_fn(self, params, batch, caches, **kw):
        """(params, batch, caches) -> (logits, caches)
        (`transformer.decode_step`)."""
        return transformer.decode_step(params, batch, caches, self.cfg, **kw)

    def prefill_fn(self, params, batch, **kw) -> torch.Tensor:
        """(params, batch) -> the last position's logits
        (`transformer.prefill`)."""
        return transformer.prefill(params, batch, self.cfg, **kw)

    def cache_init(self, batch: int, seq: int, device=None):
        """Empty decode caches (`transformer.init_caches`: KV, latent,
        Mamba2 conv and SSM states, or xLSTM states (an mLSTM block's C, n
        and m, an sLSTM block's c, n, h and m), per unit position) on
        `device` (None: the card; raises without one)."""
        from repro_torch.core.engine import resolve_device
        return transformer.init_caches(self.cfg, batch, seq,
                                       device=resolve_device(device))

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{name: (shape, dtype)} of every model input of a cell: a decode
        step's tokens (B, 1); else the tokens (B, S), with the frames (B,
        S, d_model) bf16 of an encoder-decoder, or the frames and the
        targets in place of the tokens under a frames frontend."""
        cfg, B = self.cfg, shape.global_batch
        if shape.is_decode:
            return {"tokens": ((B, 1), torch.int32)}
        S = shape.seq_len
        frames = ((B, S, cfg.d_model), torch.bfloat16)
        if cfg.family == "audio":
            return {"frames": frames, "tokens": ((B, S), torch.int32)}
        if cfg.frontend == "frames":
            return {"frames": frames, "targets": ((B, S), torch.int32)}
        return {"tokens": ((B, S), torch.int32)}

    def sample_batch(self, shape: ShapeConfig, seed: int = 0,
                     device=None) -> Dict[str, torch.Tensor]:
        """Random inputs matching `input_specs`, drawn as the reference
        draws them from ``np.random.default_rng(seed)`` (ids uniform below
        the vocab, frames N(0, 1) rounded to bf16), on `device` (None: the
        card; raises without one)."""
        from repro_torch.core.engine import resolve_device
        rng = np.random.default_rng(seed)
        out = {}
        for k, (s, dtype) in self.input_specs(shape).items():
            if dtype == torch.int32:
                x = torch.from_numpy(rng.integers(0, max(self.cfg.vocab, 2),
                                                  size=s, dtype=np.int32))
            else:
                x = torch.from_numpy(rng.normal(size=s)).to(dtype)
            out[k] = x.to(resolve_device(device))
        return out

    def objective(self, *, remat: bool = False,
                  loss_chunk: Optional[int] = None, l2: float = 0.0,
                  attn_impl: Optional[str] = None,
                  dtype: Optional[torch.dtype] = None):
        """An engine `core.deltagrad.Objective` over this model's loss
        (`Objective.from_model`)."""
        from repro_torch.core.deltagrad import Objective
        return Objective.from_model(self, remat=remat, loss_chunk=loss_chunk,
                                    l2=l2, attn_impl=attn_impl, dtype=dtype)


class EncDecModel(Model):
    """The encoder-decoder family's facade (`models.encdec`): a batch is
    ``{"frames": (B, S_enc, d_model), "tokens": (B, S)}``, a decode step's
    ``{"tokens": (B, 1)}`` against caches whose cross K/V hold the
    encoder memory (`encdec.fill_cross_caches`)."""

    def init(self, seed: int = 0, device=None) -> FlatParams:
        from repro_torch.core.engine import resolve_device
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return encdec.init_params(self.cfg, gen)

    def loss_fn(self, params, batch, **kw) -> torch.Tensor:
        return encdec.lm_loss(params, batch, self.cfg, **kw)

    def per_row_loss_fn(self, params, batch, **kw) -> torch.Tensor:
        return encdec.lm_loss_rows(params, batch, self.cfg, **kw)

    def decode_fn(self, params, batch, caches, **kw):
        return encdec.decode_step(params, batch, caches, self.cfg, **kw)

    def prefill_fn(self, params, batch, **kw) -> torch.Tensor:
        return encdec.prefill(params, batch, self.cfg, **kw)

    def cache_init(self, batch: int, seq: int, enc_len: int = 1500, device=None):
        """Empty decode caches (`encdec.init_caches`): the self-attention
        KV caches of `seq` slots and `enc_len` cross K/V slots of zeros."""
        from repro_torch.core.engine import resolve_device
        return encdec.init_caches(self.cfg, batch, seq, enc_len,
                                  device=resolve_device(device))


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "audio":
        return EncDecModel(cfg=cfg)
    transformer.layout_of(cfg)  # raises for a model the reference lacks
    return Model(cfg=cfg)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's shape, by key path, of either kind of model."""
    return (encdec.param_shapes(cfg) if cfg.family == "audio"
            else transformer.param_shapes(cfg))


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (no allocation)."""
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def active_param_count(cfg: ModelConfig) -> int:
    """MoE: parameters touched per token (routed top-k of E + shared +
    dense); the total for a dense model."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    expert_p = 3 * cfg.d_model * cfg.moe.d_expert  # gate/up/down per expert
    _, n_units = transformer.layout_of(cfg)
    return total - n_units * (e - k) * expert_p


def params_from_jax(np_params: Mapping[str, Any], device) -> FlatParams:
    """The JAX model's nested parameter tree (numpy leaves, e.g. after
    ``jax.device_get``) as the port's flat parameters on `device`."""
    return FlatParams.from_tensors(flatten_nested(np_params), device=device)


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `params_from_jax`: a nested tree of f32 numpy arrays."""
    return nested({k: params[k].detach().float().cpu().numpy()
                   for k in key_order(params)})
