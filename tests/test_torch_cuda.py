"""The port's CUDA kernels and replay on the card (marked ``cuda``; each
skips without a GPU).  Imports no JAX, so it runs on a GPU machine that has
only PyTorch:  ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Tolerances: elementwise kernels 1e-5 (f32) and 1e-2 (bf16) against their
plain versions; multidot against an f64 reference within 1e-4 relative and
1e-4 * sqrt(p) absolute (f32 sums over p terms); the card's replay against
the port's CPU run within 1e-5 with equal counters.  The dequant kernels
are exact where the design makes them so: dequant_sub bitwise its plain
version, dequant_update bitwise fused_update on the decoded row (and within
1e-5 relative of its plain version, whose update rounds apart what nvcc
contracts).  The flash kernel against its plain version at the reference
sweep's tolerances, 2e-5 (f32) and 3e-2 (bf16), elementwise as
``assert_close`` counts them, and the bf16 kernel's mean |err|/(1+|ref|)
against the f32-P plain version below a quarter of the same mean for P
rounded to bf16; the wgmma instance bitwise the mma.sync instance kept as
its yardstick; the LM objective on the card against the CPU at the
reference's model bar (loss 5e-3, gradient 5e-2 relative).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import deltagrad as dg
from repro_torch.core.history import HistoryMeta
from repro_torch.data.synthetic import (binary_classification,
                                         multiclass_classification)
from repro_torch.kernels.dequant_update.ops import dequant_sub, dequant_update
from repro_torch.kernels.dequant_update.ref import (dequant_ref,
                                                    dequant_sub_ref,
                                                    dequant_update_ref)
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fused_update.ops import update
from repro_torch.kernels.fused_update.ref import deltagrad_update_ref
from repro_torch.kernels.lbfgs.ops import multidot, rank_update
from repro_torch.kernels.lbfgs.ref import rank_update_ref
from repro_torch.models.registry import build
from repro_torch.models.simple import mlp_init, mlp_objective

DTYPES = {"f32": (torch.float32, 1e-5), "bf16": (torch.bfloat16, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,p", [(2, 238510), (8, 238510), (3, 100003), (1, 5)])
def test_kernels_match_plain_versions_on_card(cuda, m, p, dtype):
    tdt, tol = DTYPES[dtype]
    g = torch.Generator(device="cpu").manual_seed(m * p)
    dW, dG = (torch.randn(m, p, generator=g).to(cuda, tdt) for _ in range(2))
    v, w, gc, gg = (torch.randn(p, generator=g).to(cuda, tdt) for _ in range(4))
    before = (update.launches, multidot.launches, rank_update.launches)
    got = update(w, gg, v, gc, 0.1, 60000.0, 37.0, 1.0)
    torch.testing.assert_close(got.float(), deltagrad_update_ref(
        w, gg, v, gc, 0.1, 60000.0, 37.0, 1.0).float(), rtol=tol, atol=tol)
    # the estimate form (the online request): both outputs
    got = update(w, gg, v, gc, 0.1, 60000.0, 37.0, 1.0, with_g=True)
    want = deltagrad_update_ref(w, gg, v, gc, 0.1, 60000.0, 37.0, 1.0,
                                with_g=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    sums = multidot(dW, dG, v)
    w64, g64, v64 = dW.double(), dG.double(), v.double()
    ref64 = (w64 @ w64.T, w64 @ g64.T, w64 @ v64, g64 @ v64)
    for s, r in zip(sums, ref64):
        torch.testing.assert_close(s.double(), r, rtol=1e-4, atol=1e-4 * p ** 0.5)
    a, b = torch.randn(m, device=cuda), torch.randn(m, device=cuda)
    sig = torch.tensor(0.3, device=cuda)
    torch.testing.assert_close(rank_update(dW, dG, v, a, b, sig).float(),
                               rank_update_ref(dW, dG, v, a, b, sig).float(),
                               rtol=tol, atol=tol * m)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(sums, multidot(dW, dG, v)))
    after = (update.launches, multidot.launches, rank_update.launches)
    assert after == (before[0] + 2, before[1] + 2, before[2] + 1)


@pytest.mark.cuda
def test_traced_replay_spans_carry_device_time(cuda):
    """Traced on the card, every ``replay.scan`` span carries its segment's
    device time from CUDA events read at the end-of-replay sync, and the
    traced replay is bitwise the untraced one (the spans hold no sync)."""
    from repro_torch.obs import trace

    obj = mlp_objective(l2=1e-3)
    ds = multiclass_classification(600, 12, 3, seed=1)
    ch = np.random.default_rng(3).choice(600, size=9, replace=False)
    meta = HistoryMeta(n=600, batch_size=200, seed=2, steps=20,
                       lr_schedule=((0, 0.2), (10, 0.1)))
    cfg = dg.DeltaGradConfig(period=2, burn_in=5, history_size=2,
                             guard=True, curvature_eps=1e-8)
    p0 = mlp_init(12, 16, 3, generator=torch.Generator().manual_seed(0),
                  device=cuda)
    _, hist = dg.sgd_train_with_cache(obj, p0, ds, meta, device=cuda)
    w0, _ = dg.deltagrad_retrain(obj, hist, ds, ch, cfg, device=cuda)
    tr = trace.enable(trace.Tracer())
    try:
        w1, st = dg.deltagrad_retrain(obj, hist, ds, ch, cfg, device=cuda)
    finally:
        trace.disable()
    scans = [e["args"] for e in tr.events() if e["name"] == "replay.scan"]
    assert scans and st.approx_steps > 0
    for a in scans:
        assert a["device_s"] > 0 and a["measured_s"] > 0
        assert a["device_roofline_ratio"] == a["device_s"] / a["pred_s"]
    assert torch.equal(w0.flat, w1.flat)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["delete", "add"])
def test_replay_on_card_matches_cpu(cuda, mode):
    obj = mlp_objective(l2=1e-3)
    out = {}
    for where in ("cuda", "cpu"):
        ds = multiclass_classification(600, 12, 3, seed=1)
        ch = np.random.default_rng(3).choice(600, size=9, replace=False)
        if mode == "add":
            ch = ds.append({k: c[ch] for k, c in ds.columns.items()})
        meta = HistoryMeta(n=600, batch_size=200, seed=2, steps=20,
                           lr_schedule=((0, 0.2), (10, 0.1)))
        cfg = dg.DeltaGradConfig(period=2, burn_in=5, history_size=2,
                                 guard=True, curvature_eps=1e-8)
        p0 = mlp_init(12, 16, 3, generator=torch.Generator().manual_seed(0),
                      device=where)
        _, hist = dg.sgd_train_with_cache(obj, p0, ds, meta, device=where)
        before = update.launches
        w, st = dg.deltagrad_retrain(obj, hist, ds, ch, cfg, mode=mode,
                                     device=where)
        out[where] = (w.flat.cpu(), st.counters(), update.launches - before)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-5)
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][2] >= out["cuda"][1]["approx_steps"] > 0
    assert out["cpu"][2] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("with_base", [False, True], ids=["plain", "base"])
@pytest.mark.parametrize("qdtype", ["int8", "bf16"])
@pytest.mark.parametrize("bounds", [(0, 300, 310, 235510, 238510),
                                    (0, 5, 50001, 100003), (0, 7)])
def test_dequant_kernels_match_plain_versions_on_card(cuda, bounds, qdtype,
                                                      with_base):
    p, n_leaves = bounds[-1], len(bounds) - 1
    g = torch.Generator(device="cpu").manual_seed(p + n_leaves)
    w, bv, gc, base = (torch.randn(p, generator=g).to(cuda) for _ in range(4))
    base = base if with_base else None
    if qdtype == "int8":
        q = torch.randint(-127, 128, (p,), generator=g, dtype=torch.int8).to(cuda)
        scale = (torch.rand(n_leaves, generator=g) * 1e-2 + 1e-4).to(cuda)
    else:
        q = (torch.randn(p, generator=g) * 1e-2).to(cuda, torch.bfloat16)
        scale = None
    before = (dequant_update.launches, dequant_sub.launches)
    got = dequant_sub(w, q, scale, bounds, base)
    assert torch.equal(got, dequant_sub_ref(w, q, scale, bounds, base))
    args = (0.1, 60000.0, 37.0, 1.0)
    got = dequant_update(w, q, bv, gc, *args, scale, bounds, base)
    torch.testing.assert_close(got, dequant_update_ref(
        w, q, bv, gc, *args, scale, bounds, base), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, update(w, dequant_ref(q, scale, bounds, base), bv,
                                   gc, *args))
    # the estimate form: both outputs bitwise fused_update's on the decoded row
    pair = dequant_update(w, q, bv, gc, *args, scale, bounds, base, with_g=True)
    want = update(w, dequant_ref(q, scale, bounds, base), bv, gc, *args,
                  with_g=True)
    assert all(torch.equal(a, b) for a, b in zip(pair, want))
    torch.testing.assert_close(pair[1], dequant_update_ref(
        w, q, bv, gc, *args, scale, bounds, base, with_g=True)[1], rtol=1e-5,
        atol=1e-5)
    torch.cuda.synchronize()
    assert (dequant_update.launches, dequant_sub.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["delta_int8", "bf16"])
def test_streamed_kernel_replay_on_card_matches_cpu(cuda, codec):
    obj = mlp_objective(l2=1e-3)
    out = {}
    for where in ("cuda", "cpu"):
        ds = multiclass_classification(600, 20, 3, seed=1)
        ch = np.random.default_rng(3).choice(600, size=9, replace=False)
        meta = HistoryMeta(n=600, batch_size=600, seed=2, steps=24,
                           lr_schedule=((0, 0.2), (10, 0.1)))
        cfg = dg.DeltaGradConfig(period=2, burn_in=6, history_size=2,
                                 guard=True, curvature_eps=1e-8,
                                 stream_window=12, stream_decode="kernel")
        p0 = mlp_init(20, 16, 3, generator=torch.Generator().manual_seed(0),
                      device=where)
        _, hist = dg.sgd_train_with_cache(obj, p0, ds, meta, tier="host",
                                          codec=codec, device=where)
        before = (dequant_update.launches, dequant_sub.launches,
                  update.launches)
        w, st = dg.deltagrad_retrain(obj, hist, ds, ch, cfg, device=where)
        after = (dequant_update.launches, dequant_sub.launches,
                 update.launches)
        out[where] = (w.flat.cpu(), st, [a - b for a, b in zip(after, before)])
    (w_card, st_card, n_card), (w_cpu, st_cpu, n_cpu) = out["cuda"], out["cpu"]
    torch.testing.assert_close(w_card, w_cpu, rtol=0, atol=1e-5)
    assert st_card.counters() == st_cpu.counters()
    assert st_card.extra["stream_decode"] == "kernel"
    assert st_card.approx_steps > 0
    assert n_card == [st_card.approx_steps, st_card.approx_steps, 0]
    assert n_cpu == [0, 0, 0]


# the reference's flash sweep (tests/test_kernels.py), the edges of the
# kernel's 64-row tiles (S = 1, 65, 127; causal S = 512 at G = 1 and 8;
# non-causal S = 256), the LM's shape cut to B 4, and chip_smoke.py's MoE
# (MHA, 16 heads of 128: prefill_fn of qwen2-moe and moonshot, the
# objective) and Whisper (20 heads of 64, S 448: the objective, prefill_fn)
# shapes
FLASH_SHAPES = [(2, 128, 4, 2, 64, True), (1, 256, 8, 8, 32, True),
                (2, 100, 4, 1, 64, True), (1, 128, 2, 2, 128, False),
                (1, 64, 4, 4, 16, True), (3, 1, 4, 2, 64, True),
                (2, 65, 8, 2, 128, True), (1, 127, 4, 4, 32, False),
                (1, 512, 4, 4, 64, True), (2, 512, 8, 1, 128, True),
                (2, 256, 4, 2, 64, False), (4, 512, 16, 8, 128, True),
                (16, 128, 16, 16, 128, True), (4, 32, 16, 16, 128, True),
                (32, 512, 16, 16, 128, True), (32, 448, 20, 20, 64, True),
                (16, 128, 20, 20, 64, True)]
FLASH_TOL = {"f32": 2e-5, "bf16": 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(FLASH_TOL))
@pytest.mark.parametrize("B,S,H,Hkv,D,causal", FLASH_SHAPES)
def test_flash_matches_plain_version_on_card(cuda, B, S, H, Hkv, D, causal,
                                             dtype):
    tdt = DTYPES[dtype][0]
    g = torch.Generator(device="cpu").manual_seed(B * 1000 + S + D)
    q = torch.randn(B, S, H, D, generator=g).to(cuda, tdt)
    k, v = (torch.randn(B, S, Hkv, D, generator=g).to(cuda, tdt) for _ in range(2))
    before = attention.launches
    out = attention(q, k, v, causal=causal)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal).transpose(1, 2)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert out.shape == q.shape and out.dtype == tdt and out.is_contiguous()
    assert torch.equal(out, attention(q, k, v, causal=causal))  # no atomics
    torch.cuda.synchronize()
    assert attention.launches == before + 2


def _softmax_bf16_p(q, k, v, causal):
    """`attention_ref` with P rounded to bf16 before P V: the numerics the
    bf16 kernel must not have (the reference's flash keeps P in f32)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(D)
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


# the LM's own shape, beside the sweep's reduced one
P_GAP_SHAPES = FLASH_SHAPES + [(32, 512, 16, 8, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal", P_GAP_SHAPES)
def test_flash_bf16_keeps_p_in_f32_on_card(cuda, B, S, H, Hkv, D, causal):
    """The bf16 kernel against the f32-P plain version, measured against
    the gap that rounding P to bf16 opens.  Both outputs are rounded to
    bf16, whose one-ulp flips set the MAX error of either (both ~5e-3), so
    the bar is on the MEAN of |err|/(1+|ref|): a flip's chance grows with
    the f32 difference under it, and the mean follows that difference.
    The kernel must stay below a quarter of the bf16-P gap (and within
    the sweep's 3e-2 elementwise)."""
    g = torch.Generator(device="cpu").manual_seed(B * 1000 + S + D + 7)
    q = torch.randn(B, S, H, D, generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn(B, S, Hkv, D, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ref = attention_ref(qt, kt, vt, causal=causal).float()
    gap = _softmax_bf16_p(qt, kt, vt, causal).float()
    out = attention(q, k, v, causal=causal).transpose(1, 2).float()
    err = (out - ref).abs() / (1 + ref.abs())
    gap_err = (gap - ref).abs() / (1 + ref.abs())
    assert err.max().item() <= 3e-2
    assert err.mean().item() <= 0.25 * gap_err.mean().item(), (
        err.mean().item(), gap_err.mean().item())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal", FLASH_SHAPES)
def test_flash_wgmma_is_bitwise_the_mma_sync_yardstick_on_card(cuda, B, S, H, Hkv,
                                                                 D, causal):
    """The wgmma instance (every bf16 call) against the mma.sync instance
    kept as its yardstick: one wgmma sums as the matching mma.sync calls
    do, bit for bit (PERF.md section 6, the probe), and the two kernels
    do the same arithmetic operation for operation, so their outputs are
    bitwise equal."""
    g = torch.Generator(device="cpu").manual_seed(B * 1000 + S + D + 11)
    q = torch.randn(B, S, H, D, generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn(B, S, Hkv, D, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    yard = torch.empty_like(q)
    flash_kernel.flash_attention_mma(q, k, v, yard, causal)
    out = attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, yard), (out.float() - yard.float()).abs().max().item()


@pytest.mark.cuda
def test_flash_wrapper_launches_only_the_wgmma_instance(cuda, monkeypatch):
    """ops.attention on a CUDA tensor counts one launch a call and reaches
    flash_attention_fwd (the wgmma instance for bf16), never the yardstick;
    the profiler names the kernel that ran."""
    called = []
    monkeypatch.setattr(flash_kernel, "flash_attention_mma",
                        lambda *a, **k: called.append("mma"))
    real = flash_kernel.flash_attention
    monkeypatch.setattr(flash_kernel, "flash_attention",
                        lambda *a, **k: (called.append("fwd"), real(*a, **k)))
    q = torch.randn(2, 200, 8, 128, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(2, 200, 4, 128, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    attention(q, k, v, causal=True)  # built and warm before the profile
    before = attention.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        attention(q, k, v, causal=True)
        torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert called == ["fwd", "fwd"]
    names = [e.name for e in prof.events() if "flash_fwd" in e.name]
    assert names and all("flash_fwd_bf16_wgmma" in n for n in names), names


@pytest.mark.cuda
def test_flash_wrapper_raises_instead_of_falling_back(cuda):
    kv = torch.randn(1, 64, 2, 16, device=cuda)
    before = attention.launches
    with pytest.raises(ValueError, match="contiguous"):
        attention(torch.randn(1, 4, 64, 16, device=cuda).transpose(1, 2), kv, kv)
    for d in (8, 48):  # not one of the kernel's head dims
        with pytest.raises(ValueError, match="head dims"):
            attention(torch.randn(1, 64, 4, d, device=cuda),
                      torch.randn(1, 64, 2, d, device=cuda),
                      torch.randn(1, 64, 2, d, device=cuda))
    with pytest.raises(ValueError, match="block-aligned"):
        attention(torch.randn(1, 200, 4, 16, device=cuda),
                  torch.randn(1, 200, 2, 16, device=cuda),
                  torch.randn(1, 200, 2, 16, device=cuda), causal=False)
    # contiguous, but 2 bytes past a 16-byte boundary: the bf16 kernel's
    # 16-byte copies refuse it
    kvb = kv.to(torch.bfloat16)
    off = torch.zeros(64 * 4 * 16 + 1, device=cuda,
                      dtype=torch.bfloat16)[1:].view(1, 64, 4, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention(off, kvb, kvb)
    # contiguous as torch counts it (a size-1 dim's stride is free), but a
    # head stride of 3 elements: TMA's tensor map takes only strides that
    # are multiples of 16 bytes, as the mma.sync instance's 16-byte copies
    # did; the launch is refused and nothing falls back
    q1 = torch.zeros(64 * 16 + 8, device=cuda, dtype=torch.bfloat16).as_strided(
        (1, 64, 1, 16), (1024, 16, 3, 1))
    k1 = torch.zeros(1, 64, 1, 16, device=cuda, dtype=torch.bfloat16)
    assert q1.is_contiguous()
    with pytest.raises(RuntimeError, match="cudaError_t"):
        attention(q1, k1, k1)
    assert attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_lm_flash_objective_on_card_matches_cpu(cuda, dtype):
    cfg = get_config("internlm2-1.8b").reduced(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=96,
        d_head=16)
    model = build(cfg)
    obj = model.objective(loss_chunk=8, attn_impl="flash", dtype=dtype)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 96, size=(6, 24))).long()
    out = {}
    for where in ("cuda", "cpu"):
        p = model.init(seed=1, device="cpu").to(where)
        batch, w = {"tokens": tokens.to(where)}, torch.ones(6, device=where)
        before = attention.launches
        loss = obj.weighted_mean_loss(p, batch, w)
        grad = obj.make_grad_fn()(p, batch, w)
        out[where] = (loss.item(), grad.cpu(), attention.launches - before)
    (l_c, g_c, n_c), (l_p, g_p, n_p) = out["cuda"], out["cpu"]
    assert abs(l_c - l_p) < 5e-3
    assert ((g_c - g_p).norm() / g_p.norm()).item() < 5e-2
    assert n_c == 2 * 2 and n_p == 0  # 2 layers x 2 forward passes


@pytest.mark.cuda
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_logreg_replay_on_card_matches_cpu(cuda, momentum):
    """Logistic regression (delete replay; heavy-ball too) on the card
    against the port's CPU run: parameters within 1e-6, counters equal,
    and the SGD replay through fused_update, multidot and rank_update."""
    from repro_torch.models.simple import logreg_init, logreg_objective

    obj = logreg_objective(l2=5e-3)
    out = {}
    for where in ("cuda", "cpu"):
        ds = binary_classification(2000, 40, seed=1)
        ch = np.random.default_rng(3).choice(2000, size=20, replace=False)
        meta = HistoryMeta(n=2000, batch_size=512, seed=2, steps=40,
                           lr_schedule=((0, 0.1),), momentum=momentum)
        cfg = dg.DeltaGradConfig(period=10, burn_in=10, history_size=2)
        p0 = logreg_init(40, generator=torch.Generator().manual_seed(0),
                         device=where)
        _, hist = dg.sgd_train_with_cache(obj, p0, ds, meta, device=where)
        before = (update.launches, multidot.launches, rank_update.launches)
        w, st = dg.deltagrad_retrain(obj, hist, ds, ch, cfg, device=where)
        n = (update.launches - before[0], multidot.launches - before[1],
             rank_update.launches - before[2])
        out[where] = (w.flat.cpu(), st.counters(), n)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-6)
    assert out["cuda"][1] == out["cpu"][1]
    a = out["cpu"][1]["approx_steps"]
    assert a > 0
    assert out["cuda"][2] == ((0 if momentum else a), a, a)
    assert out["cpu"][2] == (0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_online_stream_on_card_matches_cpu(cuda, momentum):
    """A mixed delete/add stream on the card against the port's CPU run:
    every request's counters exactly, parameters within 1e-6, and the
    masked ring's B v through multidot and rank_update."""
    from repro_torch.core.online import online_deltagrad
    from repro_torch.models.simple import logreg_init, logreg_objective

    obj = logreg_objective(l2=5e-3)
    out = {}
    for where in ("cuda", "cpu"):
        ds = binary_classification(1200, 12, seed=0)
        meta = HistoryMeta(n=1200, batch_size=256, seed=7, steps=60,
                           lr_schedule=((0, 0.3),), momentum=momentum)
        p0 = logreg_init(12, generator=torch.Generator().manual_seed(1),
                         device=where)
        _, hist = dg.sgd_train_with_cache(obj, p0, ds, meta, device=where)
        new = ds.append({k: v[:2] for k, v in ds.columns.items()}).tolist()
        reqs = [("delete", 5), ("add", new[0]), ("delete", 101),
                ("add", new[1]), ("delete", new[0])]
        before = (update.launches, multidot.launches)
        w, st = online_deltagrad(obj, hist, ds, reqs,
                                 dg.DeltaGradConfig(period=5, burn_in=8),
                                 device=where)
        out[where] = (w.flat.cpu(), [s.counters() for s in st.per_request],
                      (update.launches - before[0],
                       multidot.launches - before[1]))
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-6)
    assert out["cuda"][1] == out["cpu"][1]
    approx = sum(c["approx_steps"] for c in out["cpu"][1])
    assert approx > 0
    assert out["cuda"][2] == ((0 if momentum else approx), approx)
    assert out["cpu"][2] == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["deltagrad", "descent_to_delete",
                                       "retrain_oracle"])
def test_session_on_card_matches_cpu(cuda, algorithm, tmp_path):
    """The session surface on the card against the same session on the
    CPU: a coalesced burst, a serial stream with an add, counters equal per
    request, parameters within 1e-5; a snapshot restored on the card serves
    the next request bitwise as the uninterrupted session."""
    from repro_torch.core.privacy import PrivacyConfig
    from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
    from repro_torch.models.simple import logreg_init, logreg_objective

    out = {}
    for where in ("cuda", "cpu"):
        ds = binary_classification(800, 10, seed=0)
        cfg = UnlearnerConfig(
            steps=50, batch_size=256, lr=0.4, seed=0, algorithm=algorithm,
            privacy=PrivacyConfig(mu=0.5, c0=0.1, c2=0.1),
            deltagrad=dg.DeltaGradConfig(period=5, burn_in=8))
        p0 = logreg_init(10, generator=torch.Generator().manual_seed(1))
        sess = UnlearnerSession(logreg_objective(5e-3), p0, ds, cfg,
                                device=where)
        sess.fit()
        stats = list(sess.delete([1, 2, 3, 40]).result().stats)
        new = ds.append({k: v[:1] for k, v in ds.columns.items()})
        stats += sess.serve_stream([("delete", 30), ("add", int(new[0]))]
                                   ).per_request
        out[where] = (sess.params.flat.cpu(), [s.counters() for s in stats],
                      sess.certificate().as_dict())
        if where == "cuda":
            sess.save(str(tmp_path))
            restored = UnlearnerSession.restore(
                str(tmp_path), logreg_objective(5e-3), device=where)
            a = sess.delete([50]).params.flat
            b = restored.delete([50]).params.flat
            assert a.is_cuda and torch.equal(a, b)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-5)
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][2] == out["cpu"][2]


def _serving_session(where, n=800, d=64):
    from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
    from repro_torch.models.simple import logreg_init, logreg_objective

    cfg = UnlearnerConfig(steps=40, batch_size=256, lr=0.3, seed=0,
                          deltagrad=dg.DeltaGradConfig(period=5, burn_in=8))
    p0 = logreg_init(d, generator=torch.Generator().manual_seed(1))
    sess = UnlearnerSession(logreg_objective(5e-3), p0,
                            binary_classification(n, d, seed=0), cfg,
                            device=where)
    sess.fit()
    return sess


@pytest.mark.cuda
def test_threaded_serving_on_card_is_bitwise_inline(cuda, tmp_path):
    """The executor's thread launches on the session's device and its
    default stream: re-serving the threaded run's logged batches inline on
    the snapshot taken before it gives bitwise the same params."""
    from repro_torch.core.session import UnlearnerSession
    from repro_torch.models.simple import logreg_objective
    from repro_torch.serve import (LoadGenerator, QueuedRequest, ServeConfig,
                                   ServingScheduler, materialize,
                                   poisson_trace)

    sess = _serving_session(cuda)
    sched = ServingScheduler(sess, ServeConfig(add_capacity=8))
    sched.save(str(tmp_path))
    ev = materialize(poisson_trace(200.0, 16, seed=6, tenants=("a", "b"),
                                   classes=("batch", "interactive"),
                                   add_frac=0.25),
                     sess.dataset, seed=13)
    sched.start()
    try:
        res = LoadGenerator(sched).open_loop(ev)
        for tk in res.tickets:
            assert tk.wait(timeout=60.0) and tk.error is None
    finally:
        sched.stop()
    by_row = {(tk.req.op, r): tk.req for tk in res.tickets for r in tk.req.rows}
    restored = UnlearnerSession.restore(str(tmp_path), logreg_objective(5e-3),
                                        device=cuda)
    again = ServingScheduler(restored, ServeConfig(add_capacity=8))
    for rec in sched.batch_log:
        reqs = []
        for r in rec["rows"]:
            q = by_row[(rec["op"], r)]
            if not reqs or reqs[-1] is not q:
                reqs.append(q)
        batch = [QueuedRequest(seq=i, tenant=q.tenant, sla_class=q.sla_class,
                               op=q.op, rows=None if q.op == "add" else q.rows,
                               data=q.data if q.op == "add" else None,
                               coalesce=q.coalesce, t_enqueue=0.0,
                               deadline=1e9)
                 for i, q in enumerate(reqs)]
        again.executor.serve_batch(batch)
    a, b = sess.params.flat, restored.params.flat
    assert a.is_cuda and torch.equal(a, b)


@pytest.mark.cuda
def test_scheduler_flush_launches_the_replay_kernels_on_card(cuda):
    """One scheduler flush of a coalesced delete batch on the card runs
    every approx step through fused_update, multidot and rank_update."""
    from repro_torch.serve import ServeConfig, ServingScheduler

    sess = _serving_session(cuda)
    sched = ServingScheduler(sess, ServeConfig())
    tickets = [sched.submit("delete", rows=[r], tenant=f"t{r % 2}",
                            sla_class="bulk_gdpr") for r in (3, 17, 40, 99)]
    kernels = (update, multidot, rank_update)
    for k in kernels:
        k.launches = 0
    assert sched.pump(force=True) == 4
    assert all(tk.done and tk.error is None for tk in tickets)
    (entry,) = sess.log
    approx = entry["stats"][0].approx_steps
    assert approx > 0 and len(sched.batch_log) == 1
    assert [k.launches for k in kernels] == [approx] * 3


# -- the LM's decode path and the train CLI (reduced widths) ------------------------

DECODE_TOL = 6e-2  # two bf16 programs' logits (tests/test_torch_decode.py)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-32b"])
def test_decode_on_card_matches_cpu(cuda, arch):
    """The same bf16 weights decode on the card and on the CPU: the
    prompt's logits within 6e-2 (1e-2 mean), greedy tokens equal or first
    parting at a top-2 margin under 6e-2; prefill under flash launches the
    kernel once per layer and agrees with the stepped decode."""
    from repro_torch.launch import serve
    from repro_torch.models.attention_config import use_attention_impl
    from repro_torch.models.transformer import cast_params
    from repro_torch.utils.tree import flatten_nested, nested

    model = build(get_config(arch).reduced())
    params = cast_params(nested(model.init(seed=0, device=cuda)), torch.bfloat16)
    params_cpu = {k: v.cpu() for k, v in flatten_nested(params).items()}
    prompt = np.random.default_rng(0).integers(0, model.cfg.vocab, size=(2, 8),
                                               dtype=np.int32)
    card = serve.generate(model, params, prompt, 8, device=cuda)
    cpu = serve.generate(model, params_cpu, prompt, 8, device="cpu")
    gap = (card["prompt_logits"].cpu() - cpu["prompt_logits"]).abs()
    assert gap.max().item() <= DECODE_TOL and gap.mean().item() <= 1e-2
    for row in range(2):
        differ = np.nonzero(card["tokens"][row] != cpu["tokens"][row])[0]
        if len(differ):
            assert card["margins"][row, differ[0]] < DECODE_TOL
    attention.launches = 0
    with use_attention_impl("flash"):
        pre = model.prefill_fn(params, {"tokens": torch.from_numpy(prompt).to(cuda)})
    assert attention.launches == model.cfg.n_layers
    assert (pre - card["prompt_logits"]).abs().max().item() <= DECODE_TOL


@pytest.mark.cuda
def test_train_cli_resume_on_card_is_bitwise(cuda, tmp_path):
    """The train CLI (flash forward) run to step 8, its step-8 checkpoint
    removed, and the same command re-run: it resumes at step 4 and ends
    bitwise where the uninterrupted run did."""
    import shutil

    from repro_torch.launch import train
    from repro_torch.models.attention_config import use_attention_impl

    argv = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "8", "--batch",
            "4", "--seq", "32", "--ckpt", str(tmp_path), "--ckpt-every", "4"]
    with use_attention_impl("flash"):
        attention.launches = 0
        whole = train.main(argv)
        assert attention.launches == 8 * 2  # 8 steps x 2 layers, forward
        shutil.rmtree(tmp_path / "step_00000008")
        resumed = train.main(argv)
    assert resumed["start"] == 4 and resumed["state"].step == 8
    assert all(resumed["losses"][s] == whole["losses"][s] for s in range(4, 8))
    assert torch.equal(whole["state"].params.flat, resumed["state"].params.flat)
    for k in ("m", "v"):
        assert torch.equal(whole["state"].opt_state[k], resumed["state"].opt_state[k])
