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
contracts).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import deltagrad as dg
from repro_torch.core.history import HistoryMeta
from repro_torch.data.synthetic import multiclass_classification
from repro_torch.kernels.dequant_update.ops import dequant_sub, dequant_update
from repro_torch.kernels.dequant_update.ref import (dequant_ref,
                                                    dequant_sub_ref,
                                                    dequant_update_ref)
from repro_torch.kernels.fused_update.ops import update
from repro_torch.kernels.fused_update.ref import deltagrad_update_ref
from repro_torch.kernels.lbfgs.ops import multidot, rank_update
from repro_torch.kernels.lbfgs.ref import rank_update_ref
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
    assert after == (before[0] + 1, before[1] + 2, before[2] + 1)


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
    torch.cuda.synchronize()
    assert (dequant_update.launches, dequant_sub.launches) == (
        before[0] + 1, before[1] + 1)


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
