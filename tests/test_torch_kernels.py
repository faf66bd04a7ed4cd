"""The port's kernel wrappers against the JAX package's kernels.

On the CPU a wrapper computes its plain version; these tests hold it
against the JAX ``ref.py`` oracle and the Pallas kernel in interpret mode on
the same numpy inputs.  Tolerances: f32 1e-6 relative for the elementwise
kernels, bf16 2e-2.  multidot's sums are held per entry against
sum_k |a_k b_k|, the scale a dot product's rounding grows with: in f32 the
port within 1e-6 of an f64 sum, and within 2e-6 of each JAX output, 1e-6
for each side's rounding (XLA's CPU dot alone is 1.15e-6 from f64 at
p = 4097, the port's plain version 1.3e-7).  The dequant
kernels take one launch over all leaves with a scale per leaf; the JAX
ones run per leaf, so each leaf's slice is held against its own JAX call:
dequant_sub bitwise against the eager JAX ``ref.py`` (one rounded
multiply, one rounded add, one rounded subtract), and both within 1e-6
relative of the Pallas kernels in interpret mode.  The CUDA
kernels themselves are held against the plain versions on the card in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dequant_update.ops import dequant_sub as j_dequant_sub
from repro.kernels.dequant_update.ops import dequant_update as j_dequant_update
from repro.kernels.dequant_update.ref import dequant_sub_ref as j_dequant_sub_ref
from repro.kernels.dequant_update.ref import (
    dequant_update_ref as j_dequant_update_ref)
from repro.kernels.fused_update.ops import update as j_update
from repro.kernels.fused_update.ref import deltagrad_update_ref as j_update_ref
from repro.kernels.lbfgs.ops import multidot as j_multidot
from repro.kernels.lbfgs.ops import rank_update as j_rank_update
from repro.kernels.lbfgs.ref import multidot_ref as j_multidot_ref
from repro.kernels.lbfgs.ref import rank_update_ref as j_rank_update_ref

from repro_torch.kernels.dequant_update.ops import dequant_sub, dequant_update
from repro_torch.kernels.dequant_update.ref import (dequant_ref,
                                                    dequant_sub_ref,
                                                    dequant_update_ref)
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


@pytest.mark.parametrize("p,sign,dB", [(1000, 1, 3.0), (4099, -1, 5.0),
                                       (777, 1, 0.0)])
def test_fused_update_estimate_form_matches_the_reference_online_math(p, sign,
                                                                      dB):
    """``with_g`` (the online request's form) returns the estimate and the
    step taken with it: the reference's online approx step, `_approx_math`
    then `_sgd_math`, within 1e-6; the estimate is bitwise the port's
    `_approx_math`, and the step bitwise w - lr*g."""
    from repro.core.engine import _approx_math as j_approx, _sgd_math as j_sgd
    from repro_torch.core.engine import _approx_math

    rng = np.random.default_rng(p + 1)
    arrs = [_pair(rng.normal(size=p), "f32") for _ in range(4)]
    w, g, bv, gc = (a[0] for a in arrs)
    lr, n = 0.1, 40.0
    new, est = update(w, g, bv, gc, lr, n, dB, sign, with_g=True)
    assert torch.equal(est, _approx_math(g, bv, gc, n, dB, sign))
    assert torch.equal(new, w - lr * est)
    jw, jg, jbv, jgc = (a[1] for a in arrs)
    j_est = j_approx(jg, jbv, jgc, n, dB, sign)
    np.testing.assert_allclose(est.numpy(), np.asarray(j_est), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(new.numpy(), np.asarray(j_sgd(jw, j_est, lr)),
                               rtol=1e-6, atol=1e-6)
    # the offline form is the same update to rounding
    np.testing.assert_allclose(new.numpy(),
                               update(w, g, bv, gc, lr, n, dB, sign).numpy(),
                               rtol=1e-6, atol=1e-6)


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


# -- dequant_update / dequant_sub ---------------------------------------------------

# ragged leaf splits, the MLP's sorted (b1, b2, w1, w2) one included
LEAVES = {"mlp": (32, 4, 640, 128), "ragged": (5, 1000, 3), "one": (777,)}


def _encoded(leaves, qdtype, with_base, seed):
    """Per-leaf numpy operands: w, bv, g_changed, base (f32), q, scale."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(leaves):
        w, bv, gc, base = (rng.normal(size=n).astype(np.float32) for _ in range(4))
        if qdtype == "int8":
            q = rng.integers(-127, 128, size=n).astype(np.int8)
            scale = np.float32(rng.uniform(1e-3, 1e-1))
        else:  # bf16 residuals carry no scale
            q = (0.01 * rng.normal(size=n)).astype(np.float32)
            scale = None
        out.append(dict(w=w, bv=bv, gc=gc, q=q, scale=scale,
                        base=base if with_base else None))
    return out


def _port_operands(parts, qdtype):
    cat = lambda k: torch.from_numpy(np.concatenate([x[k] for x in parts]))
    q = cat("q") if qdtype == "int8" else cat("q").to(torch.bfloat16)
    scale = None if parts[0]["scale"] is None else torch.tensor(
        [x["scale"] for x in parts])
    bounds = tuple(np.cumsum([0] + [len(x["w"]) for x in parts]))
    base = None if parts[0]["base"] is None else cat("base")
    return cat("w"), q, cat("bv"), cat("gc"), scale, bounds, base


def _jax_leaf(x, qdtype):
    q = jnp.asarray(x["q"]) if qdtype == "int8" \
        else jnp.asarray(x["q"], jnp.bfloat16)
    scale = jnp.float32(1.0) if x["scale"] is None else jnp.float32(x["scale"])
    base = None if x["base"] is None else jnp.asarray(x["base"])
    return jnp.asarray(x["w"]), q, jnp.asarray(x["bv"]), jnp.asarray(x["gc"]), \
        scale, base


@pytest.mark.parametrize("with_base", [False, True], ids=["plain", "base"])
@pytest.mark.parametrize("qdtype", ["int8", "bf16"])
@pytest.mark.parametrize("leaves", sorted(LEAVES))
def test_dequant_sub_matches_jax(leaves, qdtype, with_base):
    parts = _encoded(LEAVES[leaves], qdtype, with_base, seed=len(leaves))
    w, q, _, _, scale, bounds, base = _port_operands(parts, qdtype)
    got = dequant_sub(w, q, scale, bounds, base)
    assert got.dtype == torch.float32 and got.shape == w.shape
    assert torch.equal(got, dequant_sub_ref(w, q, scale, bounds, base))
    assert torch.equal(got, w - dequant_ref(q, scale, bounds, base))
    for i, x in enumerate(parts):
        jw, jq, _, _, js, jb = _jax_leaf(x, qdtype)
        mine = got[bounds[i]:bounds[i + 1]].numpy()
        assert np.array_equal(mine, np.asarray(j_dequant_sub_ref(jw, jq, js, jb)))
        pallas = np.asarray(j_dequant_sub(jw, jq, js, jb, interpret=True))
        np.testing.assert_allclose(mine, pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_base", [False, True], ids=["plain", "base"])
@pytest.mark.parametrize("qdtype", ["int8", "bf16"])
@pytest.mark.parametrize("leaves", sorted(LEAVES))
@pytest.mark.parametrize("sign,dB", [(1, 3.0), (-1, 5.0)])
def test_dequant_update_matches_jax(leaves, qdtype, with_base, sign, dB):
    parts = _encoded(LEAVES[leaves], qdtype, with_base, seed=7 + len(leaves))
    w, q, bv, gc, scale, bounds, base = _port_operands(parts, qdtype)
    lr, n = 0.1, 40.0
    got = dequant_update(w, q, bv, gc, lr, n, dB, sign, scale, bounds, base)
    assert torch.equal(got, dequant_update_ref(w, q, bv, gc, lr, n, dB, sign,
                                               scale, bounds, base))
    assert torch.equal(got, update(w, dequant_ref(q, scale, bounds, base), bv,
                                   gc, lr, n, dB, sign))
    # the estimate form, as the online request calls it
    pair = dequant_update(w, q, bv, gc, lr, n, dB, sign, scale, bounds, base,
                          with_g=True)
    want = update(w, dequant_ref(q, scale, bounds, base), bv, gc, lr, n, dB,
                  sign, with_g=True)
    assert all(torch.equal(a, b) for a, b in zip(pair, want))
    for i, x in enumerate(parts):
        jw, jq, jbv, jgc, js, jb = _jax_leaf(x, qdtype)
        mine = got[bounds[i]:bounds[i + 1]].numpy()
        for ref in (j_dequant_update_ref(jw, jq, jbv, jgc, lr, n, dB, sign, js, jb),
                    j_dequant_update(jw, jq, jbv, jgc, lr, n, dB, sign, js, jb,
                                     interpret=True)):
            np.testing.assert_allclose(mine, np.asarray(ref), rtol=1e-6,
                                       atol=1e-6)


def test_dequant_wrappers_on_cpu_count_no_launch():
    parts = _encoded(LEAVES["ragged"], "int8", True, seed=0)
    w, q, bv, gc, scale, bounds, base = _port_operands(parts, "int8")
    before = (dequant_update.launches, dequant_sub.launches)
    dequant_sub(w, q, scale, bounds, base)
    dequant_update(w, q, bv, gc, 0.1, 10.0, 1.0, 1.0, scale, bounds, base)
    assert (dequant_update.launches, dequant_sub.launches) == before


@pytest.mark.parametrize("bad", ["q-f32", "w-bf16", "q-short", "scale-count",
                                 "bounds-end", "bounds-order", "base-bf16",
                                 "meta"])
def test_dequant_wrappers_reject_what_the_kernels_do_not_take(bad):
    w, bv, gc, base = (torch.zeros(64) for _ in range(4))
    q = torch.zeros(64, dtype=torch.int8)
    scale, bounds = torch.ones(2), (0, 10, 64)
    if bad == "q-f32":
        q = torch.zeros(64)
    elif bad == "w-bf16":
        w, bv, gc, base = (x.to(torch.bfloat16) for x in (w, bv, gc, base))
    elif bad == "q-short":
        q = torch.zeros(63, dtype=torch.int8)
    elif bad == "scale-count":
        scale = torch.ones(3)
    elif bad == "bounds-end":
        bounds = (0, 10, 63)
    elif bad == "bounds-order":
        bounds = (0, 50, 40, 64)
        scale = torch.ones(3)
    elif bad == "base-bf16":
        base = base.to(torch.bfloat16)
    else:  # no kernel and no plain version for this device
        w, bv, gc, base, q, scale = (x.to("meta")
                                     for x in (w, bv, gc, base, q, scale))
    with pytest.raises(ValueError):
        dequant_sub(w, q, scale, bounds, base)
    with pytest.raises(ValueError):
        dequant_update(w, q, bv, gc, 0.1, 10.0, 1.0, 1.0, scale, bounds, base)
