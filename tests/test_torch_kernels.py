"""The port's kernel wrappers against the JAX package's kernels.

On the CPU a wrapper computes its plain version; these tests hold it
against the JAX ``ref.py`` oracle and the Pallas kernel in interpret mode on
the same numpy inputs.  Tolerances: f32 1e-6 relative for the elementwise
kernels, bf16 2e-2.  multidot's sums are held per entry against
sum_k |a_k b_k|, the scale a dot product's rounding grows with: in f32 the
port within 1e-6 of an f64 sum, and within 2e-6 of each JAX output, 1e-6
for each side's rounding (XLA's CPU dot alone is 1.15e-6 from f64 at
p = 4097, the port's plain version 1.3e-7).  The CUDA
kernels themselves are held against the plain versions on the card in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_update.ops import update as j_update
from repro.kernels.fused_update.ref import deltagrad_update_ref as j_update_ref
from repro.kernels.lbfgs.ops import multidot as j_multidot
from repro.kernels.lbfgs.ops import rank_update as j_rank_update
from repro.kernels.lbfgs.ref import multidot_ref as j_multidot_ref
from repro.kernels.lbfgs.ref import rank_update_ref as j_rank_update_ref

from repro_torch.kernels.fused_update.ops import update
from repro_torch.kernels.fused_update.ref import deltagrad_update_ref
from repro_torch.kernels.lbfgs.ops import multidot, rank_update
from repro_torch.kernels.lbfgs.ref import multidot_ref, rank_update_ref

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-6),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _pair(x, dtype):
    """The same numpy values as a torch CPU tensor and a jax array."""
    tdt, jdt, _ = DTYPES[dtype]
    t = torch.from_numpy(np.asarray(x, np.float32)).to(tdt)
    return t, jnp.asarray(np.asarray(x, np.float32), jdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- fused_update ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p,sign,dB", [(1000, 1, 3.0), (4099, -1, 5.0),
                                       (777, 1, 0.0), (64, 1, 40.0)])
def test_fused_update_matches_jax(p, sign, dB, dtype):
    rng = np.random.default_rng(p + int(dB))
    arrs = [_pair(rng.normal(size=p), dtype) for _ in range(4)]
    lr, n = 0.1, 40.0
    got = update(*[a[0] for a in arrs], lr, n, dB, sign)
    ref = j_update_ref(*[a[1] for a in arrs], lr, n, dB, sign)
    pallas = j_update(*[a[1] for a in arrs], lr, n, dB, sign, interpret=True)
    tol = DTYPES[dtype][2]
    assert got.dtype == DTYPES[dtype][0] and got.shape == (p,)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=tol, atol=tol)
    assert torch.equal(got, deltagrad_update_ref(*[a[0] for a in arrs], lr, n,
                                                 dB, sign))


# -- multidot / rank_update -------------------------------------------------------


def _history(m, p, dtype, seed):
    rng = np.random.default_rng(seed)
    return (_pair(rng.normal(size=(m, p)), dtype),
            _pair(rng.normal(size=(m, p)), dtype),
            _pair(rng.normal(size=p), dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,p", [(1, 512), (2, 1000), (3, 4097), (8, 777)])
def test_multidot_matches_jax(m, p, dtype):
    (dW, jdW), (dG, jdG), (v, jv) = _history(m, p, dtype, seed=m * 1000 + p)
    got = multidot(dW, dG, v)
    ref = j_multidot_ref(jdW, jdG, jv)
    pallas = j_multidot(jdW, jdG, jv, interpret=True)
    w, g, x = (_np(t).astype(np.float64) for t in (dW, dG, v))
    exact = (w @ w.T, w @ g.T, w @ x, g @ x)
    scale = (np.abs(w) @ np.abs(w).T, np.abs(w) @ np.abs(g).T,
             np.abs(w) @ np.abs(x), np.abs(g) @ np.abs(x))
    tol = 1e-6 if dtype == "f32" else DTYPES[dtype][2]
    for i, name in enumerate(("sw", "sy", "wv", "gv")):
        assert got[i].dtype == torch.float32
        err = np.abs(_np(got[i]) - exact[i])
        assert np.all(err <= tol * scale[i]), (name, "f64", err.max())
        for other in (ref[i], pallas[i]):
            err = np.abs(_np(got[i]) - _np(other))
            assert np.all(err <= 2 * tol * scale[i]), (name, err.max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,p", [(1, 512), (2, 1000), (5, 2222), (8, 777)])
def test_rank_update_matches_jax(m, p, dtype):
    (dW, jdW), (dG, jdG), (v, jv) = _history(m, p, dtype, seed=m + p)
    rng = np.random.default_rng(p)
    a, b = rng.normal(size=m).astype(np.float32), rng.normal(size=m).astype(np.float32)
    sigma = np.float32(0.7)
    got = rank_update(dW, dG, v, torch.from_numpy(a), torch.from_numpy(b),
                      torch.tensor(sigma))
    ref = j_rank_update_ref(jdW, jdG, jv, jnp.asarray(a), jnp.asarray(b),
                            jnp.asarray(sigma))
    pallas = j_rank_update(jdW, jdG, jv, jnp.asarray(a), jnp.asarray(b),
                           jnp.asarray(sigma), interpret=True)
    tol = DTYPES[dtype][2]
    assert got.dtype == DTYPES[dtype][0] and got.shape == (p,)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol * m)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=tol, atol=tol * m)


# -- wrapper contract --------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    (dW, _), (dG, _), (v, _) = _history(2, 300, "f32", seed=0)
    before = (update.launches, multidot.launches, rank_update.launches)
    sw, sy, wv, gv = multidot(dW, dG, v)
    for got, ref in zip((sw, sy, wv, gv), multidot_ref(dW, dG, v)):
        assert torch.equal(got, ref)
    a, b, s = torch.ones(2), torch.ones(2), torch.tensor(0.5)
    assert torch.equal(rank_update(dW, dG, v, a, b, s),
                       rank_update_ref(dW, dG, v, a, b, s))
    update(v, v, v, v, 0.1, 10.0, 1.0, 1.0)
    assert (update.launches, multidot.launches, rank_update.launches) == before


@pytest.mark.parametrize("bad", ["m9", "ragged", "f64", "strided", "meta"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    dW, dG, v = torch.zeros(2, 64), torch.zeros(2, 64), torch.zeros(64)
    if bad == "m9":
        dW, dG = torch.zeros(9, 64), torch.zeros(9, 64)
    elif bad == "ragged":
        dG = torch.zeros(2, 63)
    elif bad == "f64":
        dW, dG, v = dW.double(), dG.double(), v.double()
    elif bad == "strided":
        dW = torch.zeros(64, 2).T
    else:  # no kernel and no plain version for this device
        dW, dG, v = (x.to("meta") for x in (dW, dG, v))
    with pytest.raises(ValueError):
        multidot(dW, dG, v)
    with pytest.raises(ValueError):
        rank_update(dW, dG, v, torch.zeros(2), torch.zeros(2), torch.tensor(1.0))
    if bad in ("f64", "meta"):
        with pytest.raises(ValueError):
            update(v, v, v, v, 0.1, 1.0, 0.0, 1.0)
