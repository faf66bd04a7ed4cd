"""xLSTM blocks (Beck et al. 2024, arXiv:2405.04517): mLSTM + sLSTM.

The port's copy of the JAX package's ``models/xlstm.py``.

mLSTM, the matrix-memory cell: trained and prefilled with the chunkwise
parallel form (`mlstm_chunked`: within a chunk of Q positions an
attention-like contraction under a cumulative forget-gate decay mask, the
chunk-boundary state (C, n, m) carried by a loop over the L / Q chunks,
the reference's ``lax.scan``), or the whole-sequence parallel form
(`mlstm_parallel`); decoded with the O(1)-state recurrent form
(`mlstm_step`).  The three are the same algebra.

sLSTM, the scalar-memory cell with block-diagonal recurrent weights: a
loop over time (`slstm_apply`, the reference's ``lax.scan``), then a
gated GeLU MLP.

As in the reference:

  * the stabilisers start at ``m = -inf``, and each ``where(isfinite(m),
    exp(...), 0)`` stands where the reference has it, so no NaN reaches a
    gradient;
  * the row maxima are `torch.amax`, whose gradient splits among ties as
    ``jnp.max``'s does;
  * the dtypes follow JAX's promotion under `cast_params` (every float
    leaf in the compute dtype): q is divided by ``np.sqrt(dh)``, a float64
    numpy scalar, so q is f32 whatever the compute dtype; k, v, z and the
    up-projections stay in it; the cells run in f32 and their output is
    cast back; SiLU is ``x * (1 / (1 + exp(-x)))`` and the tanh GeLU the
    reference's formula, with every op rounded to the compute dtype
    (`layers.silu`, XLA's bf16 logistic; `layers.gelu_tanh`);
  * Q = min(chunk, L), and L must divide by Q (a `ValueError` here).

The sLSTM's ``w_in`` gives z | i | f | o blocks of d, reordered to heads x
[z, i, f, o] x dh, and its ``bias`` goes through the same reorder.  The
port adds the bias to the input contribution once before the time loop
(the reference adds it every step, after the recurrent term; the two
part by f32 rounding), keeps the loop's states as (H, B, dh) so that the
recurrent product and the sum are one ``baddbmm`` a step, and writes the
decode states in place, as `layers.gqa_decode` writes K and V.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMConfig
from repro_torch.models.layers import (dense_init, gelu_tanh, rmsnorm,
                                      rmsnorm_init, silu)


def _mlstm_dims(d_model: int, n_heads: int, cfg: XLSTMConfig) -> Tuple[int, int]:
    d_inner = int(cfg.proj_factor_mlstm * d_model)
    return d_inner, d_inner // n_heads


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def mlstm_init(generator: torch.Generator, d_model: int, n_heads: int,
               cfg: XLSTMConfig) -> Dict[str, object]:
    d_inner, _ = _mlstm_dims(d_model, n_heads, cfg)
    dev = generator.device
    return {
        "w_up": dense_init(d_model, d_inner, generator),
        "w_z": dense_init(d_model, d_inner, generator),
        "w_q": dense_init(d_inner, d_inner, generator),
        "w_k": dense_init(d_inner, d_inner, generator),
        "w_v": dense_init(d_inner, d_inner, generator),
        "w_gates": dense_init(d_inner, 2 * n_heads, generator),  # (i, f) per head
        "gate_bias": torch.cat([torch.zeros(n_heads, device=dev),
                                torch.full((n_heads,), 3.0, device=dev)]),  # forget bias
        "cell_norm": rmsnorm_init(d_inner, dev),
        "w_down": dense_init(d_inner, d_model, generator),
    }


def _mlstm_qkv_gates(params, x: torch.Tensor, n_heads: int):
    B, L, _ = x.shape
    up = x @ params["w_up"]
    d_inner = up.shape[-1]
    dh = d_inner // n_heads
    q = (up @ params["w_q"]).reshape(B, L, n_heads, dh).float() / math.sqrt(dh)
    k = (up @ params["w_k"]).reshape(B, L, n_heads, dh)
    v = (up @ params["w_v"]).reshape(B, L, n_heads, dh)
    gates = (up @ params["w_gates"] + params["gate_bias"]).float()
    i_tilde = gates[..., :n_heads]  # (B, L, H)
    f_tilde = gates[..., n_heads:]
    z = x @ params["w_z"]
    return q, k, v, i_tilde, f_tilde, z, d_inner, dh


def _mlstm_out(params, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The cell's output h (B, L, d_inner), in the compute dtype, normed,
    gated by SiLU(z) and projected down."""
    h = rmsnorm(params["cell_norm"], h)
    return (h * silu(z)) @ params["w_down"]


def mlstm_parallel(params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Training/prefill forward over the whole sequence at once; x: (B, L,
    d_model)."""
    B, L, _ = x.shape
    q, k, v, i_tilde, f_tilde, z, d_inner, dh = _mlstm_qkv_gates(params, x, n_heads)
    logf = F.logsigmoid(f_tilde)  # (B, L, H)
    Fc = torch.cumsum(logf, dim=1).transpose(1, 2)  # (B, H, L)
    # D[b, h, i, j] = F_i - F_j + itilde_j   (j <= i)
    D = Fc[..., :, None] - Fc[..., None, :] + i_tilde.transpose(1, 2)[..., None, :]
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    D = torch.where(causal, D, float("-inf"))
    m = torch.amax(D, dim=-1)  # (B, H, L)
    S = torch.einsum("blhd,bmhd->bhlm", q, k.float())
    W = S * torch.exp(D - m[..., None])
    b = W.sum(dim=-1)  # (B, H, L)
    denom = torch.maximum(b.abs(), torch.exp(-m))
    h = torch.einsum("bhlm,bmhd->blhd", W, v.float())
    h = h / denom.transpose(1, 2)[..., None]
    return _mlstm_out(params, h.reshape(B, L, d_inner).to(x.dtype), z)


def mlstm_chunked(params, x: torch.Tensor, n_heads: int,
                  chunk: int = 256) -> torch.Tensor:
    """Chunkwise-parallel mLSTM: O(L Q) memory instead of O(L^2).

    The algebra of `mlstm_parallel`; the chunk-boundary state (C, n, m) is
    carried from chunk to chunk with the stabiliser folded in, as in the
    recurrent form."""
    B, L, _ = x.shape
    q, k, v, i_tilde, f_tilde, z, d_inner, dh = _mlstm_qkv_gates(params, x, n_heads)
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"seq len {L} must divide by chunk {Q}")
    nc = L // Q
    logf = F.logsigmoid(f_tilde)  # (B, L, H)

    def chunks(a):  # (B, L, H, *) -> (nc, B, H, Q, *)
        return a.reshape(B, nc, Q, *a.shape[2:]).transpose(2, 3).transpose(0, 1)

    qc, kc, vc = chunks(q), chunks(k.float()), chunks(v.float())
    ic, fc = chunks(i_tilde), chunks(logf)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()

    C = torch.zeros(B, n_heads, dh, dh, device=x.device)
    n = torch.zeros(B, n_heads, dh, device=x.device)
    m = torch.full((B, n_heads), float("-inf"), device=x.device)
    hs = []
    for c in range(nc):
        qb, kb, vb, ib, fb = qc[c], kc[c], vc[c], ic[c], fc[c]  # (B, H, Q, *)
        Fc = torch.cumsum(fb, dim=-1)  # (B, H, Q) local cumulative forget
        # intra-chunk decay D_ij = F_i - F_j + i_j
        D = Fc[..., :, None] - Fc[..., None, :] + ib[..., None, :]
        D = torch.where(causal, D, float("-inf"))
        m_intra = torch.amax(D, dim=-1)  # (B, H, Q)
        m_inter = Fc + m[..., None]  # decayed carry stabiliser
        m_i = torch.maximum(m_intra, m_inter)
        S = torch.einsum("bhqd,bhkd->bhqk", qb, kb)
        W = S * torch.exp(D - m_i[..., None])
        num = torch.einsum("bhqk,bhkd->bhqd", W, vb)
        den = W.sum(dim=-1)
        carry_scale = torch.where(torch.isfinite(m[..., None]),
                                  torch.exp(m_inter - m_i), 0.0)  # (B, H, Q)
        num = num + carry_scale[..., None] * torch.einsum("bhde,bhqe->bhqd", C, qb)
        den = den + carry_scale * torch.einsum("bhe,bhqe->bhq", n, qb)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
        # ---- chunk-boundary state update ---------------------------------
        Ftot = Fc[..., -1]  # (B, H)
        g = Ftot[..., None] - Fc + ib  # decay from j to the chunk's end
        m_next = torch.maximum(Ftot + m, torch.amax(g, dim=-1))
        c_old = torch.where(torch.isfinite(m), torch.exp(Ftot + m - m_next), 0.0)
        wj = torch.exp(g - m_next[..., None])  # (B, H, Q)
        C = c_old[..., None, None] * C + torch.einsum("bhq,bhqd,bhqe->bhde",
                                                      wj, vb, kb)
        n = c_old[..., None] * n + torch.einsum("bhq,bhqe->bhe", wj, kb)
        m = m_next
    # hs: nc x (B, H, Q, dh) -> (B, L, d_inner)
    h = torch.stack(hs, dim=1).transpose(2, 3).reshape(B, L, d_inner)
    return _mlstm_out(params, h.to(x.dtype), z)


def mlstm_cache_init(batch: int, d_model: int, n_heads: int, cfg: XLSTMConfig,
                     device=None) -> Dict[str, torch.Tensor]:
    """Empty f32 states on `device`: C (B, H, dh, dh), n (B, H, dh), and
    the stabiliser m (B, H) at -inf."""
    _, dh = _mlstm_dims(d_model, n_heads, cfg)
    return {"C": torch.zeros(batch, n_heads, dh, dh, device=device),
            "n": torch.zeros(batch, n_heads, dh, device=device),
            "m": torch.full((batch, n_heads), float("-inf"), device=device)}


def mlstm_step(params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               n_heads: int):
    """Single-token recurrent step; x: (B, 1, d_model).  Returns (out (B,
    1, d_model), the cache, its three states written in place)."""
    B = x.shape[0]
    q, k, v, i_tilde, f_tilde, z, d_inner, dh = _mlstm_qkv_gates(params, x, n_heads)
    q, k, v = q[:, 0], k[:, 0].float(), v[:, 0].float()  # (B, H, dh)
    i_t, logf = i_tilde[:, 0], F.logsigmoid(f_tilde[:, 0])  # (B, H)
    m_prev, C, n = cache["m"], cache["C"], cache["n"]
    m_new = torch.maximum(logf + m_prev, i_t)
    i_sc = torch.exp(i_t - m_new)
    f_sc = torch.where(torch.isfinite(m_prev), torch.exp(logf + m_prev - m_new), 0.0)
    C.mul_(f_sc[..., None, None]).add_(
        i_sc[..., None, None] * torch.einsum("bhd,bhe->bhde", v, k))
    n.mul_(f_sc[..., None]).add_(i_sc[..., None] * k)
    m_prev.copy_(m_new)
    num = torch.einsum("bhde,bhe->bhd", C, q)
    den = torch.maximum(torch.einsum("bhe,bhe->bh", n, q).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, d_inner).to(x.dtype)
    return _mlstm_out(params, h, z), cache


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def slstm_init(generator: torch.Generator, d_model: int, n_heads: int,
               cfg: XLSTMConfig) -> Dict[str, object]:
    dh = d_model // n_heads
    d_up = int(cfg.proj_factor_slstm * d_model)
    dev = generator.device
    return {
        "w_in": dense_init(d_model, 4 * d_model, generator),  # z, i, f, o
        "r": 0.1 * torch.randn(n_heads, dh, 4 * dh, generator=generator, device=dev),
        "bias": torch.cat([torch.zeros(2 * d_model, device=dev),
                           torch.full((d_model,), 3.0, device=dev),
                           torch.zeros(d_model, device=dev)]),
        "cell_norm": rmsnorm_init(d_model, dev),
        "mlp_up": dense_init(d_model, 2 * d_up, generator),  # GeGLU
        "mlp_down": dense_init(d_up, d_model, generator),
    }


def _per_head(a: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(..., 4 d) in z | i | f | o blocks of d -> (..., H, 4 dh), each
    head's [z, i, f, o] contiguous."""
    d = a.shape[-1] // 4
    return a.reshape(*a.shape[:-1], 4, n_heads, d // n_heads).transpose(-3, -2).reshape(
        *a.shape[:-1], n_heads, 4 * (d // n_heads))


def slstm_cell_step(gates: torch.Tensor, state):
    """One step of the cell from its pre-activations ``gates`` (..., 4 dh),
    each head's [z, i, f, o], and ``state`` (c, n, h, m), each (..., dh)
    f32; returns the new (c, n, h, m)."""
    c, n, _, m = state
    dh = gates.shape[-1] // 4
    zt = torch.tanh(gates[..., :dh])
    it = gates[..., dh:2 * dh]
    ft = gates[..., 2 * dh:3 * dh]
    ot = torch.sigmoid(gates[..., 3 * dh:])
    logf = F.logsigmoid(ft)
    lm = logf + m
    m_new = torch.maximum(lm, it)
    i_sc = torch.exp(it - m_new)
    f_sc = torch.where(torch.isfinite(m), torch.exp(lm - m_new), 0.0)
    c_new = f_sc * c + i_sc * zt
    n_new = f_sc * n + i_sc
    h_new = ot * c_new / torch.maximum(n_new, torch.exp(-m_new))
    return c_new, n_new, h_new, m_new


def _slstm_out(params, h: torch.Tensor) -> torch.Tensor:
    """The cell's output h (B, L, d), in the compute dtype, normed and
    through the gated GeLU MLP."""
    h = rmsnorm(params["cell_norm"], h)
    u, g = torch.chunk(h @ params["mlp_up"], 2, dim=-1)
    return (u * gelu_tanh(g)) @ params["mlp_down"]


def slstm_apply(params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Sequential forward over L, one step after another; x: (B, L,
    d_model)."""
    B, L, d = x.shape
    dh = d // n_heads
    wx = _per_head((x @ params["w_in"]).float(), n_heads)  # (B, L, H, 4 dh)
    bias = _per_head(params["bias"], n_heads).float()  # (H, 4 dh)
    # time first, then heads: (L, H, B, 4 dh), the bias added once
    wxb = (wx.permute(1, 2, 0, 3) + bias[:, None, :]).contiguous()
    r = params["r"].float()  # (H, dh, 4 dh)
    zeros = torch.zeros(n_heads, B, dh, device=x.device)
    state = (zeros, zeros, zeros, torch.full_like(zeros, float("-inf")))
    hs = []
    for t in range(L):
        state = slstm_cell_step(torch.baddbmm(wxb[t], state[2], r), state)
        hs.append(state[2])
    # (L, H, B, dh) -> (B, L, H * dh)
    h = torch.stack(hs).permute(2, 0, 1, 3).reshape(B, L, d)
    return _slstm_out(params, h.to(x.dtype))


def slstm_cache_init(batch: int, d_model: int, n_heads: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """Empty f32 states c, n, h (B, H, dh) on `device`, and m at -inf."""
    dh = d_model // n_heads
    return {"c": torch.zeros(batch, n_heads, dh, device=device),
            "n": torch.zeros(batch, n_heads, dh, device=device),
            "h": torch.zeros(batch, n_heads, dh, device=device),
            "m": torch.full((batch, n_heads, dh), float("-inf"), device=device)}


def slstm_step(params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               n_heads: int):
    """Single-token step; x: (B, 1, d_model).  Returns (out (B, 1,
    d_model), the cache, its four states written in place)."""
    B, _, d = x.shape
    wx = _per_head((x[:, 0] @ params["w_in"]).float(), n_heads)  # (B, H, 4 dh)
    rh = torch.einsum("bhd,hde->bhe", cache["h"], params["r"].float())
    gates = wx + rh + _per_head(params["bias"], n_heads).float()
    new = slstm_cell_step(gates, (cache["c"], cache["n"], cache["h"], cache["m"]))
    for key, value in zip("cnhm", new):
        cache[key].copy_(value)
    return _slstm_out(params, new[2].reshape(B, 1, d).to(x.dtype)), cache


def xlstm_param_shapes(d_model: int, n_heads: int,
                       cfg: XLSTMConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """`mlstm_init`'s and `slstm_init`'s leaf shapes, by block kind and
    key path, without allocating."""
    d_inner, _ = _mlstm_dims(d_model, n_heads, cfg)
    dh, d_up = d_model // n_heads, int(cfg.proj_factor_slstm * d_model)
    return {
        "mlstm": {"w_up": (d_model, d_inner), "w_z": (d_model, d_inner),
                  "w_q": (d_inner, d_inner), "w_k": (d_inner, d_inner),
                  "w_v": (d_inner, d_inner), "w_gates": (d_inner, 2 * n_heads),
                  "gate_bias": (2 * n_heads,), "cell_norm/scale": (d_inner,),
                  "w_down": (d_inner, d_model)},
        "slstm": {"w_in": (d_model, 4 * d_model), "r": (n_heads, dh, 4 * dh),
                  "bias": (4 * d_model,), "cell_norm/scale": (d_model,),
                  "mlp_up": (d_model, 2 * d_up), "mlp_down": (d_up, d_model)},
    }
