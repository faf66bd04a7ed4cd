"""The port's paper models (logistic regression, multinomial logistic
regression), their config and data split, heavy-ball momentum,
``removal_pad`` and the §5 applications, against the JAX package on the
CPU.

The same numpy data and initial weights go through both packages.
Tolerances: losses, gradients and parameters within 1e-6 (absolute, f32),
accuracies and schedules equal, and every replay counter exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from repro.configs.registry import get_config as j_get_config
from repro.core import applications as japp
from repro.core import deltagrad as jdg
from repro.core.history import HistoryMeta as JMeta
from repro.data.synthetic import binary_classification as j_binary
from repro.data.synthetic import multiclass_classification as j_multiclass
from repro.data.synthetic import train_test_split as j_split
from repro.models import simple as jsimple

from repro_torch.configs.paper_logreg import RECIPE
from repro_torch.configs.registry import get_config
from repro_torch.core import applications as tapp
from repro_torch.core import deltagrad as tdg
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.data.synthetic import binary_classification as t_binary
from repro_torch.data.synthetic import multiclass_classification as t_multiclass
from repro_torch.data.synthetic import train_test_split as t_split
from repro_torch.models import simple as tsimple
from repro_torch.models.simple import params_from_jax, params_to_numpy

TOL = 1e-6
COUNTERS = ("explicit_steps", "approx_steps", "guard_fallbacks",
            "skipped_steps", "pairs_rejected", "grad_examples",
            "grad_examples_baseline")


def _flat(params):
    return np.concatenate([np.asarray(params[k], np.float32).reshape(-1)
                           for k in sorted(params)])


def _port_flat(params):
    return _flat(params_to_numpy(params))


def _logreg_p0(d, seed=1):
    rng = np.random.default_rng(seed)
    return {"w": (0.01 * rng.normal(size=d)).astype(np.float32),
            "b": np.zeros((), np.float32)}


def _multiclass_p0(d, c, seed=1):
    rng = np.random.default_rng(seed)
    return {"w": (0.3 * rng.normal(size=(d, c))).astype(np.float32),
            "b": (0.1 * rng.normal(size=c)).astype(np.float32)}


FAMILIES = {
    "logreg": dict(data=(j_binary, t_binary, dict(n=300, d=9, seed=3)),
                   p0=lambda: _logreg_p0(9),
                   jax=(jsimple.logreg_objective, jsimple.logreg_accuracy),
                   torch=(tsimple.logreg_objective, tsimple.logreg_accuracy)),
    "multiclass": dict(data=(j_multiclass, t_multiclass,
                             dict(n=300, d=9, num_classes=5, seed=3)),
                       p0=lambda: _multiclass_p0(9, 5),
                       jax=(jsimple.multiclass_objective,
                            jsimple.multiclass_accuracy),
                       torch=(tsimple.multiclass_objective,
                              tsimple.multiclass_accuracy)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_gradient_and_accuracy_match_jax(family):
    f = FAMILIES[family]
    jgen, tgen, kw = f["data"]
    jds, tds = jgen(**kw), tgen(**kw)
    p0 = f["p0"]()
    jobj, jacc = f["jax"][0](l2=5e-3), f["jax"][1]
    tobj, tacc = f["torch"][0](l2=5e-3), f["torch"][1]
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = params_from_jax(p0, "cpu")
    rows = np.arange(0, 300, 3)
    weights = (np.arange(len(rows)) % 4 != 0).astype(np.float32)
    jb = {k: jnp.asarray(v[rows]) for k, v in jds.columns.items()}
    tb = {k: v[rows] for k, v in tds.device_columns("cpu").items()}
    np.testing.assert_allclose(
        tobj.per_example_loss(tp, tb).numpy(),
        np.asarray(jobj.per_example_loss(jp, jb)), rtol=0, atol=TOL)
    jg = ravel_pytree(jobj.make_grad_fn()(jp, jb, jnp.asarray(weights)))[0]
    import torch
    tg = tobj.make_grad_fn()(tp, tb, torch.from_numpy(weights))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=TOL)
    assert tacc(tp, tds) == jacc(jp, jds)


def test_logreg_predict_matches_jax():
    ds = t_binary(n=200, d=7, seed=1)
    p0 = _logreg_p0(7, seed=4)
    p0["b"] = np.float32(0.05)
    np.testing.assert_array_equal(
        tsimple.logreg_predict(params_from_jax(p0, "cpu"), ds.columns["x"]),
        jsimple.logreg_predict({k: jnp.asarray(v) for k, v in p0.items()},
                               ds.columns["x"]))


@pytest.mark.parametrize("family", ["logreg", "multiclass"])
def test_weights_carry_across_in_ravel_pytree_order(family):
    if family == "logreg":
        jp = jsimple.logreg_init(11, seed=2)
        tp = tsimple.logreg_init(11)
    else:
        jp = jsimple.multiclass_init(11, 4, seed=2)
        tp = tsimple.multiclass_init(11, 4)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    np_params = {k: np.array(v) for k, v in jax.device_get(jp).items()}
    carried = params_from_jax(np_params, "cpu")
    np.testing.assert_array_equal(carried.flat.numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))
    back = params_to_numpy(carried)
    for k, v in np_params.items():
        assert back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("frac,seed", [(0.2, 0), (0.25, 7), (0.0, 3)])
def test_train_test_split_is_bitwise_the_reference(frac, seed):
    jtr, jte = j_split(j_binary(n=137, d=5, seed=2), frac, seed=seed)
    ttr, tte = t_split(t_binary(n=137, d=5, seed=2), frac, seed=seed)
    for j, t in ((jtr, ttr), (jte, tte)):
        assert t.n == j.n
        for k in j.columns:
            assert t.columns[k].dtype == j.columns[k].dtype
            np.testing.assert_array_equal(t.columns[k], j.columns[k])


def test_paper_logreg_config_is_the_reference():
    t, j = get_config("paper-logreg"), j_get_config("paper-logreg")
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (RECIPE.l2, RECIPE.lr, RECIPE.period, RECIPE.burn_in,
            RECIPE.history_size) == (5e-3, 0.1, 10, 10, 2)
    assert get_config("internlm2-1.8b").family == "dense"


# --------------------------------------------------------------------------
# training, BaseL and the replay on logreg: momentum and removal_pad
# --------------------------------------------------------------------------


def _run_both(mode, momentum, cfg_kw, n=600, d=8, batch=128, steps=40,
              lr=0.3, r=9):
    """Train, BaseL and replay in both packages on the same logreg data."""
    p0 = _logreg_p0(d)
    changed = np.random.default_rng(4).choice(n, size=r, replace=False)
    out = {}
    for name, pkg, meta_cls, gen, obj, kw in (
            ("jax", jdg, JMeta, j_binary, jsimple.logreg_objective(5e-3), {}),
            ("torch", tdg, TMeta, t_binary, tsimple.logreg_objective(5e-3),
             {"device": "cpu"})):
        ds = gen(n=n, d=d, seed=0)
        meta = meta_cls(n=ds.n, batch_size=batch, seed=7, steps=steps,
                        lr_schedule=((0, lr),), momentum=momentum)
        ch = changed
        if mode == "add":
            ch = ds.append({k: v[changed] for k, v in ds.columns.items()})
        init = ({k: jnp.asarray(v) for k, v in p0.items()} if name == "jax"
                else params_from_jax(p0, "cpu"))
        w_star, hist = pkg.sgd_train_with_cache(obj, init, ds, meta, **kw)
        w_u, st_u = pkg.baseline_retrain(obj, ds, meta, init, ch, mode=mode,
                                         **kw)
        w_i, st = pkg.deltagrad_retrain(obj, hist, ds, ch,
                                        pkg.DeltaGradConfig(**cfg_kw),
                                        mode=mode, **kw)
        out[name] = dict(w_star=w_star, w_u=w_u, w_i=w_i, st=st, st_u=st_u)
    return out


REPLAYS = {
    "sgd-delete": dict(mode="delete", momentum=0.0,
                       cfg=dict(period=5, burn_in=6, history_size=2)),
    "sgd-add": dict(mode="add", momentum=0.0,
                    cfg=dict(period=5, burn_in=6, history_size=2)),
    "momentum-delete": dict(mode="delete", momentum=0.9,
                            cfg=dict(period=5, burn_in=6, history_size=2)),
    "momentum-add": dict(mode="add", momentum=0.9,
                         cfg=dict(period=4, burn_in=5, history_size=3)),
    "momentum-guard": dict(mode="delete", momentum=0.9,
                           cfg=dict(period=3, burn_in=4, history_size=2,
                                    guard=True, guard_norm_clip=0.0)),
    "removal-pad-16": dict(mode="delete", momentum=0.0,
                           cfg=dict(period=5, burn_in=6, history_size=2,
                                    removal_pad=16)),
}


@pytest.mark.parametrize("case", sorted(REPLAYS))
def test_logreg_training_baseline_and_replay_match_jax(case):
    c = REPLAYS[case]
    res = _run_both(c["mode"], c["momentum"], c["cfg"])
    j, t = res["jax"], res["torch"]
    for key in ("w_star", "w_u", "w_i"):
        np.testing.assert_allclose(_port_flat(t[key]), _flat(j[key]), rtol=0,
                                   atol=TOL, err_msg=key)
    for k in COUNTERS:
        assert getattr(t["st"], k) == getattr(j["st"], k), k
    for k in ("explicit_steps", "skipped_steps", "grad_examples"):
        assert getattr(t["st_u"], k) == getattr(j["st_u"], k), k
    if case == "momentum-guard":
        assert t["st"].guard_fallbacks > 0
    else:
        assert t["st"].approx_steps > 0
    # Theorem 1 holds for the port's replay as for the reference's
    d_ui = np.linalg.norm(_port_flat(t["w_u"]) - _port_flat(t["w_i"]))
    d_us = np.linalg.norm(_port_flat(t["w_u"]) - _port_flat(t["w_star"]))
    assert d_ui < 0.5 * d_us, (d_ui, d_us)


def _wide_shape(scale):
    """The rcv1.binary training shape (n 20,242, d 47,236; B 4096, r 20)
    scaled by `scale` in every size, so d > n as there; T 60."""
    return dict(n=round(20242 * scale), d=round(47236 * scale),
                batch=round(4096 * scale), r=max(1, round(20 * scale)),
                steps=60, lr=RECIPE.lr)


def _ratio(res, f):
    """d_ui / d_us of one package's run (`f` flattens its parameters)."""
    return (np.linalg.norm(f(res["w_u"]) - f(res["w_i"]))
            / np.linalg.norm(f(res["w_u"]) - f(res["w_star"])))


PAPER_CFG = dict(period=RECIPE.period, burn_in=RECIPE.burn_in,
                 history_size=RECIPE.history_size)


@pytest.mark.parametrize("mode,momentum", [("delete", 0.0), ("add", 0.0),
                                           ("delete", 0.9)])
def test_logreg_replay_at_a_wide_shape_matches_jax(mode, momentum):
    """paper_logreg's recipe where d > n (the rcv1.binary shape at a tenth
    of its size): the port's replays equal the reference's, parameters
    within 1e-6 and counters exactly, so d_ui/d_us is the reference's own
    (the delete replay reads 3.62 in both: Theorem 1's 0.5 is not what
    DeltaGrad gives on this recipe at d > n)."""
    res = _run_both(mode, momentum, PAPER_CFG, **_wide_shape(0.1))
    j, t = res["jax"], res["torch"]
    for key in ("w_star", "w_u", "w_i"):
        np.testing.assert_allclose(_port_flat(t[key]), _flat(j[key]), rtol=0,
                                   atol=TOL, err_msg=key)
    for k in COUNTERS:
        assert getattr(t["st"], k) == getattr(j["st"], k), k
    assert t["st"].approx_steps > 0
    r_j, r_t = _ratio(j, _flat), _ratio(t, _port_flat)
    print(f"d_ui/d_us {mode} momentum {momentum}: jax {r_j:.4f} port {r_t:.4f}")
    assert abs(r_t - r_j) <= 1e-3 * r_j, (r_t, r_j)


def test_momentum_changes_the_path():
    """Heavy-ball really runs: the trained model differs from plain SGD's."""
    sgd = _run_both("delete", 0.0, dict(period=5, burn_in=6))["torch"]
    mom = _run_both("delete", 0.9, dict(period=5, burn_in=6))["torch"]
    assert np.abs(_port_flat(sgd["w_star"]) - _port_flat(mom["w_star"])).max() > 1e-3


@pytest.mark.parametrize("pad", [0, 4, 16])
def test_removal_pad_sets_the_changed_block_width(pad, monkeypatch):
    """0 is the next power of two of min(r, B) (here 8 for r = 5); any
    other width is taken as given, and every width replays the same."""
    from repro_torch.core import engine

    widths = []
    real = engine.build_schedule

    def spy(*a, **kw):
        sched = real(*a, **kw)
        widths.append(sched.changed_idx.shape[1])
        return sched

    monkeypatch.setattr(engine, "build_schedule", spy)
    res = _run_both("delete", 0.0, dict(period=5, burn_in=6,
                                        removal_pad=pad), r=5)
    assert widths[-1] == (pad or 8)
    np.testing.assert_allclose(_port_flat(res["torch"]["w_i"]),
                               _flat(res["jax"]["w_i"]), rtol=0, atol=TOL)


def test_removal_pad_too_small_or_negative_raises():
    with pytest.raises(ValueError, match="removal_pad"):
        tdg.DeltaGradConfig(removal_pad=-1)
    ds = t_binary(n=64, d=3, seed=0)
    meta = TMeta(n=64, batch_size=64, seed=0, steps=4, lr_schedule=((0, 0.1),))
    p0 = params_from_jax(_logreg_p0(3), "cpu")
    obj = tsimple.logreg_objective()
    _, hist = tdg.sgd_train_with_cache(obj, p0, ds, meta, device="cpu")
    with pytest.raises(ValueError, match="removal_pad"):
        tdg.deltagrad_retrain(obj, hist, ds, np.arange(5),
                              tdg.DeltaGradConfig(removal_pad=2), device="cpu")


# --------------------------------------------------------------------------
# §5 applications
# --------------------------------------------------------------------------


def _app_setup():
    """Both packages trained on the same data, and a shared config."""
    p0 = _logreg_p0(6)
    out = {}
    for name, pkg, meta_cls, gen, obj, kw in (
            ("jax", jdg, JMeta, j_binary, jsimple.logreg_objective(5e-3), {}),
            ("torch", tdg, TMeta, t_binary, tsimple.logreg_objective(5e-3),
             {"device": "cpu"})):
        ds = gen(n=240, d=6, seed=1)
        meta = meta_cls(n=ds.n, batch_size=1 << 30, seed=3, steps=30,
                        lr_schedule=((0, 0.5),))
        init = ({k: jnp.asarray(v) for k, v in p0.items()} if name == "jax"
                else params_from_jax(p0, "cpu"))
        _, hist = pkg.sgd_train_with_cache(obj, init, ds, meta, **kw)
        out[name] = (obj, hist, ds, pkg.DeltaGradConfig(period=5, burn_in=5))
    return out


def test_leave_one_out_models_and_data_values_match_jax():
    s = _app_setup()
    idx = [0, 17, 101, 239]
    jm = japp.leave_one_out_models(*s["jax"][:3], idx, s["jax"][3])
    tm = tapp.leave_one_out_models(*s["torch"][:3], idx, s["torch"][3],
                                   device="cpu")
    assert len(tm) == len(idx)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(_port_flat(a), _flat(b), rtol=0, atol=TOL)
    jv = japp.data_values(*s["jax"][:3], idx, s["jax"][3])
    tv = tapp.data_values(*s["torch"][:3], idx, s["torch"][3], device="cpu")
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL)
    assert np.all(tv > 0)


def test_jackknife_bias_correct_matches_jax():
    s = _app_setup()
    idx = [3, 50, 77, 200, 201]

    def est_j(p):
        return np.asarray(p["w"])[:3]

    def est_t(p):
        return params_to_numpy(p)["w"][:3]

    j = japp.jackknife_bias_correct(est_j, *s["jax"][:3], s["jax"][3], idx)
    t = tapp.jackknife_bias_correct(est_t, *s["torch"][:3], s["torch"][3],
                                    idx, device="cpu")
    for k in ("estimate", "bias", "corrected"):
        # the bias multiplies a mean of 1e-6-close fits by n - 1 = 239
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=239 * TOL,
                                   err_msg=k)


def test_cross_conformal_matches_jax():
    s = _app_setup()
    x_test = np.random.default_rng(9).normal(size=(12, 6)).astype(np.float32)

    def pred_j(p, x):
        return np.asarray(x @ np.asarray(p["w"]) + float(p["b"]))

    def pred_t(p, x):
        q = params_to_numpy(p)
        return np.asarray(x @ q["w"] + float(q["b"]))

    j = japp.cross_conformal(*s["jax"][:3], pred_j, x_test, K=4, alpha=0.1,
                             cfg=s["jax"][3], seed=2)
    t = tapp.cross_conformal(*s["torch"][:3], pred_t, x_test, K=4, alpha=0.1,
                             cfg=s["torch"][3], seed=2, device="cpu")
    np.testing.assert_allclose(t.lower, j.lower, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.upper, j.upper, rtol=0, atol=1e-5)
    assert t.coverage_level == j.coverage_level
    assert np.all(t.lower < t.upper)


if __name__ == "__main__":
    # d_ui/d_us of both packages at scaled rcv1.binary shapes, paper_logreg's
    # recipe: PYTHONPATH=src python tests/test_torch_models.py 0.05 0.1 0.2 0.3
    import sys

    for scale in map(float, sys.argv[1:]):
        shape = _wide_shape(scale)
        for mode, momentum in (("delete", 0.0), ("add", 0.0), ("delete", 0.9)):
            res = _run_both(mode, momentum, PAPER_CFG, **shape)
            gap = np.abs(_port_flat(res["torch"]["w_i"])
                         - _flat(res["jax"]["w_i"])).max()
            print(f"scale {scale} n={shape['n']} d={shape['d']} "
                  f"B={shape['batch']} r={shape['r']} {mode} momentum "
                  f"{momentum}: d_ui/d_us jax {_ratio(res['jax'], _flat):.4f} port "
                  f"{_ratio(res['torch'], _port_flat):.4f}; max |w_I gap| {gap:.2e}",
                  flush=True)
