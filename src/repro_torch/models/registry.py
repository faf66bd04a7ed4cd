"""The model facade: init, loss, decode and objective of a configuration.

The port's copy of the JAX package's ``models/registry.py`` for the GQA
token decoders, the MoE family, MLA, the Mamba2 hybrid (Zamba2) and
xLSTM, and
the bridge that carries the JAX LM's weights across: `params_from_jax`
takes the reference's nested parameter tree (as numpy; a hybrid's
``shared`` block and every unit position ``u{pos}`` included) and gives
the port's `FlatParams`, in the same flat order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
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

    def objective(self, *, remat: bool = False,
                  loss_chunk: Optional[int] = None, l2: float = 0.0,
                  attn_impl: Optional[str] = None,
                  dtype: Optional[torch.dtype] = None):
        """An engine `core.deltagrad.Objective` over this model's loss
        (`Objective.from_model`)."""
        from repro_torch.core.deltagrad import Objective
        return Objective.from_model(self, remat=remat, loss_chunk=loss_chunk,
                                    l2=l2, attn_impl=attn_impl, dtype=dtype)


def build(cfg: ModelConfig) -> Model:
    transformer.layout_of(cfg)  # raises for a family not ported
    return Model(cfg=cfg)


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (no allocation)."""
    return sum(math.prod(s) for s in transformer.param_shapes(cfg).values())


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
    """The JAX LM's nested parameter tree (numpy leaves, e.g. after
    ``jax.device_get``) as the port's flat parameters on `device`."""
    return FlatParams.from_tensors(flatten_nested(np_params), device=device)


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `params_from_jax`: a nested tree of f32 numpy arrays."""
    return nested({k: params[k].detach().float().cpu().numpy()
                   for k in key_order(params)})
