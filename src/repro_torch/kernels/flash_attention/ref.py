"""Plain PyTorch version of the flash attention forward: dense softmax."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); GQA via H = Hkv * G.

    f32 scores and softmax, the output cast to q's dtype (the JAX
    package's ``attention_ref``)."""
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(D)
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)
