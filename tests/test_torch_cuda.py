"""The port's CUDA kernels and replay on the card (marked ``cuda``; each
skips without a GPU).  Imports no JAX, so it runs on a GPU machine that has
only PyTorch:  ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Tolerances: elementwise kernels 1e-5 (f32) and 1e-2 (bf16) against their
plain versions; multidot against an f64 reference within 1e-4 relative and
1e-4 * sqrt(p) absolute (f32 sums over p terms); the card's replay against
the port's CPU run within 1e-5 with equal counters.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import deltagrad as dg
from repro_torch.core.history import HistoryMeta
from repro_torch.data.synthetic import multiclass_classification
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
