"""The port's numpy-side copies, parameter layout and objective against the
JAX package.  Sampler and synthetic data must agree bitwise; gradients
within 1e-6 (f32, absolute, at gradient entries of order 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.data import sampler as jsampler
from repro.data.synthetic import binary_classification as j_binary
from repro.data.synthetic import multiclass_classification as j_multiclass
from repro.models.simple import mlp_objective as j_mlp_objective

from repro_torch.configs.paper_mlp import CONFIG
from repro_torch.data import sampler as tsampler
from repro_torch.data.dataset import Dataset
from repro_torch.data.synthetic import binary_classification as t_binary
from repro_torch.data.synthetic import multiclass_classification as t_multiclass
from repro_torch.models.simple import (mlp_init, mlp_objective,
                                       params_from_jax, params_to_numpy)
from repro_torch.utils.tree import (FlatParams, tree_all_finite, tree_norm,
                                    tree_sub, tree_vdot)

GRAD_TOL = 1e-6


def _mlp_params(d, hidden, classes, seed):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(d, hidden)) / np.sqrt(d)).astype(np.float32),
            "b1": rng.normal(size=hidden).astype(np.float32) * 0.1,
            "w2": rng.normal(size=(hidden, classes)).astype(np.float32),
            "b2": rng.normal(size=classes).astype(np.float32) * 0.1}


@pytest.mark.parametrize("n,bs", [(100, 32), (50, 1 << 30), (1000, 999)])
def test_sampler_is_bitwise_the_reference(n, bs):
    for seed in (0, 7):
        np.testing.assert_array_equal(
            tsampler.batch_indices_all(seed, 12, n, bs),
            jsampler.batch_indices_all(seed, 12, n, bs))
        np.testing.assert_array_equal(
            tsampler.addition_mask_all(seed, 12, n, bs, 9),
            jsampler.addition_mask_all(seed, 12, n, bs, 9))


@pytest.mark.parametrize("mode", ["delete", "add"])
@pytest.mark.parametrize("n,bs", [(200, 64), (120, 1 << 30)])
def test_build_schedule_is_bitwise_the_reference(mode, n, bs):
    changed = np.random.default_rng(1).choice(n, size=13, replace=False)
    if mode == "add":
        changed = np.arange(n, n + 13)
    lr_at = lambda t: 0.2 if t < 10 else 0.1  # noqa: E731
    t = tsampler.build_schedule(3, 20, n, bs, changed, mode, 16, lr_at)
    j = jsampler.build_schedule(3, 20, n, bs, changed, mode, 16, lr_at)
    for f in ("idx", "kept_w", "changed_idx", "changed_w", "dB", "kept", "lr"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (t.mode, t.r_pad) == (j.mode, j.r_pad)


def test_synthetic_data_is_bitwise_the_reference():
    for t, j in ((t_multiclass(300, 17, 5, seed=4), j_multiclass(300, 17, 5, seed=4)),
                 (t_binary(300, 9, seed=2), j_binary(300, 9, seed=2))):
        assert sorted(t.columns) == sorted(j.columns)
        for k in t.columns:
            assert t.columns[k].dtype == j.columns[k].dtype
            np.testing.assert_array_equal(t.columns[k], j.columns[k])


def test_dataset_device_columns_padded_batch_and_append():
    ds = Dataset({"x": np.arange(12, dtype=np.float32).reshape(6, 2),
                  "y": np.arange(6, dtype=np.int32)})
    cols = ds.device_columns("cpu")
    assert cols["y"].dtype == torch.int64 and cols["x"].dtype == torch.float32
    assert ds.device_columns("cpu") is cols  # cached
    batch, w = ds.padded_batch(np.array([4, 1]), 4)
    np.testing.assert_array_equal(batch["y"], [4, 1, 0, 0])
    np.testing.assert_array_equal(w, [1, 1, 0, 0])
    new = ds.append({"x": np.ones((2, 2), np.float32), "y": np.array([7, 8], np.int32)})
    np.testing.assert_array_equal(new, [6, 7])
    assert ds.device_columns("cpu")["y"].shape == (8,)
    with pytest.raises(ValueError):
        Dataset({"x": np.zeros(3), "y": np.zeros(4)})


def test_params_from_jax_round_trips_in_ravel_pytree_order():
    p = _mlp_params(7, 5, 3, seed=0)
    flat_j, _ = ravel_pytree({k: jnp.asarray(v) for k, v in p.items()})
    fp = params_from_jax(p, "cpu")
    assert list(fp) == ["b1", "b2", "w1", "w2"]
    np.testing.assert_array_equal(fp.flat.numpy(), np.asarray(flat_j))
    for k in p:
        assert fp[k]._base is fp.flat  # a view, not a copy
        np.testing.assert_array_equal(fp[k].numpy(), p[k])
    back = params_to_numpy(fp)
    assert sorted(back) == sorted(p)
    for k in p:
        np.testing.assert_array_equal(back[k], p[k])
    fp.flat.zero_()
    assert float(fp["w1"].abs().sum()) == 0.0
    with pytest.raises(ValueError):
        FlatParams(torch.zeros(3), {"a": (2,)})


def test_mlp_init_has_the_paper_width():
    fp = mlp_init(CONFIG.d_in, CONFIG.d_model, CONFIG.vocab,
                  generator=torch.Generator().manual_seed(0))
    assert fp.numel == CONFIG.n_params == 238_510
    assert fp.shapes == {"b1": (300,), "b2": (10,), "w1": (784, 300),
                         "w2": (300, 10)}
    again = mlp_init(CONFIG.d_in, CONFIG.d_model, CONFIG.vocab,
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(fp.flat, again.flat)


@pytest.mark.parametrize("k_live", [40, 0])
def test_objective_gradient_matches_jax_grad(k_live):
    """Weighted mean over live rows, denominator max(sum w, 1), plus the l2
    term: the gradient of a batch with no live row is l2 * w alone."""
    p = _mlp_params(6, 8, 3, seed=3)
    ds = t_multiclass(50, 6, 3, seed=1)
    w = np.zeros(50, np.float32)
    w[:k_live] = 1.0
    jobj = j_mlp_objective(l2=1e-3)
    gj = jobj.make_grad_fn()({k: jnp.asarray(v) for k, v in p.items()},
                             {k: jnp.asarray(v) for k, v in ds.columns.items()},
                             jnp.asarray(w))
    flat_gj, _ = ravel_pytree(gj)
    fp = params_from_jax(p, "cpu")
    gt = mlp_objective(l2=1e-3).make_grad_fn()(
        fp, ds.device_columns("cpu"), torch.from_numpy(w))
    np.testing.assert_allclose(gt.numpy(), np.asarray(flat_gj), rtol=0,
                               atol=GRAD_TOL)
    lj = jobj.weighted_mean_loss({k: jnp.asarray(v) for k, v in p.items()},
                                 {k: jnp.asarray(v) for k, v in ds.columns.items()},
                                 jnp.asarray(w))
    lt = mlp_objective(l2=1e-3).weighted_mean_loss(
        fp, ds.device_columns("cpu"), torch.from_numpy(w))
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)


def test_tree_helpers_match_jax():
    a, b = _mlp_params(4, 3, 2, seed=5), _mlp_params(4, 3, 2, seed=6)
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    d = tree_sub(ta, tb)
    assert sorted(d) == sorted(a)
    assert float(tree_vdot(ta, tb)) == pytest.approx(
        float(sum(jnp.vdot(ja[k], jb[k]) for k in a)), rel=1e-6)
    assert float(tree_norm(d)) == pytest.approx(
        float(jnp.sqrt(sum(jnp.sum((ja[k] - jb[k]) ** 2) for k in a))), rel=1e-6)
    assert bool(tree_all_finite(ta))
    ta["b1"][0] = float("nan")
    assert not bool(tree_all_finite(ta))
    assert not bool(tree_all_finite(torch.tensor([1.0, float("inf")])))
