"""The port's compact L-BFGS operator against the JAX package's.

Same numpy inputs to `repro.core.lbfgs` and `repro_torch.core.lbfgs` /
`repro_torch.kernels.lbfgs.ops` on the CPU.  Tolerance: 1e-5 relative to
the largest entry of B v (a 2m x 2m f32 solve sits between the two passes,
and its conditioning amplifies the Gram terms' rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lbfgs import bfgs_matrix_recursive
from repro.core.lbfgs import compact_coeffs as j_compact_coeffs
from repro.core.lbfgs import gram_terms_stacked as j_gram_terms
from repro.core.lbfgs import lbfgs_hvp_stacked as j_hvp_stacked

from repro_torch.core.lbfgs import LbfgsBuffer, compact_coeffs
from repro_torch.kernels.lbfgs.ops import lbfgs_hvp_fused, multidot

HVP_TOL = 1e-5


def _curvature_pairs(m, p, seed):
    """dG = dW H for an SPD H: pairs a convex objective would produce."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(p, p)).astype(np.float32) / p
    H = A @ A.T + np.eye(p, dtype=np.float32)
    dW = rng.normal(size=(m, p)).astype(np.float32)
    dG = (dW @ H).astype(np.float32)
    v = rng.normal(size=p).astype(np.float32)
    return dW, dG, v


def _close(got, ref, tol=HVP_TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= tol * scale, (
        float(np.abs(got - ref).max()), scale)


@pytest.mark.parametrize("m,p", [(1, 64), (2, 1024), (5, 777), (8, 300)])
def test_hvp_matches_jax_stacked(m, p):
    dW, dG, v = _curvature_pairs(m, p, seed=m + p)
    ref = j_hvp_stacked(jnp.asarray(dW), jnp.asarray(dG), jnp.asarray(v))
    t = [torch.from_numpy(x) for x in (dW, dG, v)]
    _close(lbfgs_hvp_fused(*t).numpy(), ref)


@pytest.mark.parametrize("m", [1, 3])
def test_gram_terms_and_coeffs_match_jax(m):
    dW, dG, v = _curvature_pairs(m, 200, seed=m)
    jt = j_gram_terms(jnp.asarray(dW), jnp.asarray(dG), jnp.asarray(v))
    tt = multidot(*[torch.from_numpy(x) for x in (dW, dG, v)])
    for got, ref in zip(tt, jt):
        _close(got.numpy(), ref, tol=1e-6)
    jc = j_compact_coeffs(*jt)
    tc = compact_coeffs(*[torch.from_numpy(np.array(x)) for x in jt])
    for got, ref in zip(tc, jc):
        _close(got.numpy(), ref, tol=1e-5)


def test_compact_form_equals_dense_bfgs():
    """B v from the compact form equals the recursive BFGS matrix (paper eq.
    (S11)) applied to v."""
    dW, dG, v = _curvature_pairs(3, 40, seed=11)
    B = np.asarray(bfgs_matrix_recursive(jnp.asarray(dW), jnp.asarray(dG)))
    got = lbfgs_hvp_fused(*[torch.from_numpy(x) for x in (dW, dG, v)])
    _close(got.numpy(), B @ v, tol=1e-4)


def test_buffer_admission_and_ring():
    buf = LbfgsBuffer(2, curvature_eps=0.1)
    pair = [torch.full((4,), float(i)) for i in range(4)]
    assert not buf.add_pair(pair[0], pair[0], curv=0.0, ss=0.0)  # dw == 0
    assert not buf.add_pair(pair[1], pair[1], curv=0.05, ss=1.0)  # curv < eps*ss
    assert buf.add_pair(pair[1], pair[1], curv=0.1, ss=1.0)  # curv == eps*ss
    assert buf.add_pair(pair[2], pair[2], curv=1.0, ss=1.0)
    dW, _ = buf.stacked()
    assert buf.stacked()[0] is dW  # cached until the next admission
    assert buf.add_pair(pair[3], pair[3], curv=1.0, ss=1.0)  # evicts the oldest
    dW, dG = buf.stacked()
    assert dW.shape == (2, 4) and dW.is_contiguous()
    assert torch.equal(dW[:, 0], torch.tensor([2.0, 3.0]))
    assert (len(buf), buf.admitted, buf.rejected) == (2, 3, 2)
    with pytest.raises(ValueError):
        LbfgsBuffer(2).stacked()
