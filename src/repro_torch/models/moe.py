"""Shared + routed top-k Mixture-of-Experts FFN (Qwen-MoE / Moonlight family).

The port's copy of the JAX package's ``models/moe.py``.  Dispatch is
capacity-based (Switch/GShard style, without the O(T*E*C) dispatch
tensor): each token's k choices are placed into a fixed (E, C+1, d)
expert-input buffer, processed with three batched products, and gathered
back with their router weights.  A choice past its expert's capacity C
goes to the scratch slot C and falls through the residual
(dropless-up-to-capacity).  Expert weights are stacked along a leading E
axis.

Token groups.  `moe_apply` takes x as (G, T, d): each leading index is one
token group with its own capacity ``ceil(capacity_factor * k * T / E)``,
its own slot ranks and its own Switch aux loss.  The reference's
``moe_apply`` treats all tokens of its (B, S, d) input as one group, and
the callers reach it three ways, which the port's callers spell out:

  * per batch (``lm_loss``, ``prefill``, each train step): one group of
    B*S tokens, ``x.reshape(1, B * S, d)``;
  * per row (the DeltaGrad objective, which the reference builds by
    vmapping its loss over batch-1 slices): B groups of S tokens;
  * per decode step (the reference runs ``moe_apply`` on the (B, 1, d)
    step): one group of B tokens.

Routing under capacity mixes the tokens of a group, so the three
groupings give different outputs by the reference's design.

Determinism: two evaluations on the card are bitwise equal, forward and
gradient.  The slot ranks come from one stable sort (the reference's
"onehot" cumsum and "sort" argsort routes give the same ranks); the k
copies of a token are an ``expand`` (its backward is an ordered sum over
k), and the buffer and the combine are row gathers whose maps are
injective, so each backward is the gather through the inverse map and
adds nothing up (`_RowGather`).  No step accumulates with float atomics.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import (dense_init, fan_out, ffn_sigmoid,
                                      ffn_silu, mlp_apply, mlp_init)


def moe_init(generator: torch.Generator, d_model: int,
             cfg: MoEConfig) -> Dict[str, object]:
    """Router N(0, 1/d_model); expert weights (E, ...) N(0, 1/d_in); the
    shared expert a SwiGLU of width ``d_shared`` and its (d_model, 1)
    gate, when ``num_shared > 0``."""
    E, dff, dev = cfg.num_experts, cfg.d_expert, generator.device

    def normal(*shape, d_in):
        return torch.randn(*shape, generator=generator, device=dev) / math.sqrt(d_in)

    p: Dict[str, object] = {
        "router": dense_init(d_model, E, generator),
        "w_gate": normal(E, d_model, dff, d_in=d_model),
        "w_up": normal(E, d_model, dff, d_in=d_model),
        "w_down": normal(E, dff, d_model, d_in=dff),
    }
    if cfg.num_shared > 0:
        p["shared"] = mlp_init(generator, d_model, cfg.d_shared, "swiglu")
        p["shared_gate"] = dense_init(d_model, 1, generator)
    return p


def route(params, x: torch.Tensor, k: int):
    """The router on x (..., d): (probs (..., E) f32, gate_vals (..., k) f32
    renormalised with the reference's 1e-9 floor, gate_idx (..., k) int64).

    Logits are f32 from the upcast operands (the router weight as the
    caller cast it, as the reference's ``:48``); the top k in descending
    order, a tie going to the lower index (``jax.lax.top_k``'s order; a
    stable sort gives it)."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def capacity_of(cfg: MoEConfig, T: int) -> int:
    """Slots per expert for a group of T tokens (the reference's float
    expression, in its order)."""
    return max(int(math.ceil(cfg.capacity_factor * cfg.top_k * T / cfg.num_experts)), 1)


def slot_ranks(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """(G, N) int64 experts of each group's (token, choice) pairs in
    flattened (t, j) order -> each pair's rank within its expert, counted
    in that order: the reference's ranks under either ``dispatch`` route,
    by one stable sort per group."""
    G, N = e_flat.shape
    e_sorted, order = torch.sort(e_flat, dim=-1, stable=True)
    experts = torch.arange(E, device=e_flat.device).expand(G, E).contiguous()
    starts = torch.searchsorted(e_sorted, experts)  # (G, E) first of each
    pos_sorted = (torch.arange(N, device=e_flat.device)
                  - torch.gather(starts, 1, e_sorted))
    return torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)


def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx[r]] for idx[r] >= 0, zeros where idx[r] < 0."""
    out = a.index_select(0, idx.clamp(min=0))
    return out.masked_fill((idx < 0)[:, None], 0)


class _RowGather(torch.autograd.Function):
    """out[r] = a[idx[r]] (zeros where idx[r] < 0), with idx injective on
    its valid entries and `inv` its inverse map (-1 for a row of `a` that
    no r reads).  Each row of `a` reaches at most one output row, so the
    backward is the gather of the cotangent through `inv`: no
    accumulation, hence deterministic on the card."""

    @staticmethod
    def forward(ctx, a, idx, inv):
        ctx.save_for_backward(idx, inv)
        return _gather_rows(a, idx)

    @staticmethod
    def backward(ctx, g):
        idx, inv = ctx.saved_tensors
        return _gather_rows(g, inv), None, None


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (G, T, d), G token groups of T tokens (module note).  Returns
    (out (G, T, d) in x's dtype, aux (G,) f32: each group's Switch
    load-balancing loss ``E * sum_e f_e * p_e``)."""
    G, T, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    dev = x.device
    # x's uses: the router, the dispatch, the shared gate, the shared
    # experts; their input gradients summed in f32 (`layers.fan_out`)
    uses = fan_out(x, 4 if cfg.num_shared > 0 else 2)
    probs, gate_vals, gate_idx = route(params, uses[0], k)  # (G, T, E|k|k)

    # load-balancing aux loss (Switch), per group
    me = probs.mean(dim=1)
    ce = torch.zeros((G, E), device=dev)
    for j in range(k):
        ce = ce + F.one_hot(gate_idx[..., j], E).float().mean(dim=1)
    aux = E * torch.sum(me * ce / k, dim=-1)

    # joint dispatch across all k choices: one (E, G (C+1), d) buffer, its
    # rows (e, g, slot) in that order; overflow -> the scratch slot C
    C = capacity_of(cfg, T)
    N = T * k
    e_flat = gate_idx.reshape(G, N)
    pos = slot_ranks(e_flat, E)
    keep = pos < C
    slot = torch.where(keep, pos, torch.full_like(pos, C))
    groups = torch.arange(G, device=dev)[:, None]
    R = E * G * (C + 1)
    # dst: the buffer row each kept (token, choice) fills, -1 if dropped;
    # src: its inverse (scattered at unique rows; the dropped go to a
    # trash entry R that is cut off)
    row = (e_flat * G + groups) * (C + 1) + slot
    dst = torch.where(keep, row, torch.full_like(row, -1)).reshape(-1)
    src = torch.full((R + 1,), -1, dtype=torch.long, device=dev)
    src.scatter_(0, torch.where(keep, row, torch.full_like(row, R)).reshape(-1),
                 torch.arange(G * N, device=dev))
    src = src[:R]

    x_rep = uses[1].unsqueeze(2).expand(G, T, k, d).reshape(G * N, d)
    buf = _RowGather.apply(x_rep, src, dst).view(E, G * (C + 1), d)
    h = ffn_silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    y = torch.bmm(h, params["w_down"]).reshape(R, d)
    tok_y = _RowGather.apply(y, dst, src)  # (G N, d), dropped rows zero
    contrib = gate_vals.reshape(G * N, 1) * tok_y.float()
    out = contrib.view(G, T, k, d).sum(dim=2)

    if cfg.num_shared > 0:
        shared = mlp_apply(params["shared"], uses[3], "swiglu")
        sg = ffn_sigmoid(uses[2] @ params["shared_gate"])
        out = out + (sg * shared).float()
    return out.to(x.dtype), aux


def moe_ref(params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Dense oracle: every token of x (..., d) through its top-k experts,
    no capacity.  O(T * E) compute: tests only."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    _, gate_vals, gate_idx = route(params, xt, cfg.top_k)
    h = ffn_silu(torch.einsum("td,edf->tef", xt, params["w_gate"])) * torch.einsum(
        "td,edf->tef", xt, params["w_up"])
    y_all = torch.einsum("tef,efd->ted", h, params["w_down"])  # (T, E, d)
    out = torch.zeros(xt.shape, device=x.device)
    for j in range(cfg.top_k):
        yj = y_all[torch.arange(xt.shape[0], device=x.device), gate_idx[:, j]]
        out = out + gate_vals[:, j:j + 1] * yj
    if cfg.num_shared > 0:
        shared = mlp_apply(params["shared"], xt, "swiglu")
        sg = ffn_sigmoid(xt @ params["shared_gate"])
        out = out + (sg * shared).float()
    return out.reshape(x.shape).to(x.dtype)
