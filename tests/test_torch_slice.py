"""The port's Algorithm-1 slice end to end against the JAX package.

The same numpy data and initial parameters go through
`repro.core.deltagrad` and `repro_torch.core.deltagrad` on the CPU: the
paper MLP's recipe (T0 = 2, a quarter of the steps as burn-in, guard on,
curvature threshold 1e-8) at d = 20, hidden 32, 4 classes.  Tolerance:
every parameter within 1e-5 (absolute; f32 sums taken in another order
over 24 steps), and all seven replay counters exactly equal.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deltagrad as jdg
from repro.core.history import HistoryMeta as JMeta
from repro.data.synthetic import multiclass_classification as j_multiclass
from repro.models.simple import mlp_objective as j_mlp_objective

from repro_torch.core import deltagrad as tdg
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.data.synthetic import multiclass_classification as t_multiclass
from repro_torch.models.simple import (mlp_accuracy, mlp_objective,
                                       params_from_jax, params_to_numpy)

PARAM_TOL = 1e-5
COUNTERS = ("explicit_steps", "approx_steps", "guard_fallbacks",
            "skipped_steps", "pairs_rejected", "grad_examples",
            "grad_examples_baseline")
LR = ((0, 0.2), (10, 0.1))


def _init(d, hidden, classes, seed):
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.normal(size=(d, hidden)) / np.sqrt(d)).astype(np.float32),
        "b1": np.zeros(hidden, np.float32),
        "w2": (rng.normal(size=(hidden, classes)) / np.sqrt(hidden)).astype(np.float32),
        "b2": np.zeros(classes, np.float32),
    }


def _flat_np(params):
    return np.concatenate([np.asarray(params[k], np.float32).reshape(-1)
                           for k in sorted(params)])


def _run_both(mode, n, batch_size, steps, changed, cfg_kw, d=20, hidden=32,
              classes=4):
    """Train, BaseL and replay in both packages; returns both results."""
    p0 = _init(d, hidden, classes, seed=6)
    out = {}
    for name, pkg, meta_cls, gen, obj in (
            ("jax", jdg, JMeta, j_multiclass, j_mlp_objective(l2=1e-3)),
            ("torch", tdg, TMeta, t_multiclass, mlp_objective(l2=1e-3))):
        ds = gen(n=n, d=d, num_classes=classes, seed=5)
        meta = meta_cls(n=ds.n, batch_size=batch_size, seed=7, steps=steps,
                        lr_schedule=LR)
        ch = np.asarray(changed, np.int64)
        if mode == "add":
            ch = ds.append({k: v[ch] for k, v in ds.columns.items()})
        cfg = pkg.DeltaGradConfig(**cfg_kw)
        if name == "jax":
            init = {k: jnp.asarray(v) for k, v in p0.items()}
            kw = {}
        else:
            init = params_from_jax(p0, "cpu")
            kw = {"device": "cpu"}
        w_star, hist = pkg.sgd_train_with_cache(obj, init, ds, meta, **kw)
        w_u, st_u = pkg.baseline_retrain(obj, ds, meta, init, ch, mode=mode, **kw)
        w_i, st = pkg.deltagrad_retrain(obj, hist, ds, ch, cfg, mode=mode, **kw)
        out[name] = dict(w_star=w_star, w_u=w_u, w_i=w_i, st=st, st_u=st_u,
                         ds=ds)
    return out


CASES = {
    # the paper MLP recipe, GD, with deletion and addition
    "gd-delete": dict(mode="delete", n=1200, batch_size=1 << 30, steps=24,
                      r=12, cfg=dict(period=2, burn_in=6, history_size=2,
                                     guard=True, curvature_eps=1e-8)),
    "gd-add": dict(mode="add", n=1200, batch_size=1 << 30, steps=24, r=12,
                   cfg=dict(period=2, burn_in=6, history_size=2, guard=True,
                            curvature_eps=1e-8)),
    # minibatch SGD with a longer period and m = 3
    "sgd-delete": dict(mode="delete", n=1200, batch_size=256, steps=24, r=40,
                       cfg=dict(period=3, burn_in=4, history_size=3,
                                guard=True, curvature_eps=1e-8)),
    # clip 0 trips the guard on every approx step: the segment-splitting
    # retry runs each tripped step explicitly
    "guard-fallback": dict(mode="delete", n=1200, batch_size=1 << 30, steps=24,
                           r=12, cfg=dict(period=3, burn_in=3, history_size=2,
                                          guard=True, guard_norm_clip=0.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_matches_reference(case):
    c = CASES[case]
    changed = np.random.default_rng(2).choice(c["n"], size=c["r"], replace=False)
    res = _run_both(c["mode"], c["n"], c["batch_size"], c["steps"], changed,
                    c["cfg"])
    j, t = res["jax"], res["torch"]
    for key in ("w_star", "w_u", "w_i"):
        got = _flat_np(params_to_numpy(t[key]))
        ref = _flat_np(j[key])
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, ref, rtol=0, atol=PARAM_TOL, err_msg=key)
    for k in COUNTERS:
        assert getattr(t["st"], k) == getattr(j["st"], k), (k, t["st"], j["st"])
    for k in ("explicit_steps", "skipped_steps", "grad_examples"):
        assert getattr(t["st_u"], k) == getattr(j["st_u"], k), k
    if case == "guard-fallback":
        assert t["st"].guard_fallbacks > 0 and t["st"].approx_steps == 0
    else:
        assert t["st"].approx_steps > 0
    assert mlp_accuracy(t["w_i"], t["ds"]) == pytest.approx(
        mlp_accuracy(t["w_u"], t["ds"]), abs=0.02)


def test_whole_batch_deleted_skips_like_reference():
    """Deleting every row of one minibatch makes that step SKIP in both."""
    from repro.data.sampler import batch_indices

    n, bs = 48, 8
    changed = batch_indices(7, 0, n, bs)  # the rows of step 0's batch
    res = _run_both("delete", n, bs, 16, changed,
                    dict(period=3, burn_in=2, history_size=2, guard=True,
                         curvature_eps=1e-8))
    j, t = res["jax"], res["torch"]
    assert t["st"].skipped_steps >= 1
    for k in COUNTERS:
        assert getattr(t["st"], k) == getattr(j["st"], k), k
    np.testing.assert_allclose(_flat_np(params_to_numpy(t["w_i"])),
                               _flat_np(j["w_i"]), rtol=0, atol=PARAM_TOL)


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = t_multiclass(n=16, d=4, num_classes=2, seed=0)
    meta = TMeta(n=16, batch_size=16, seed=0, steps=2, lr_schedule=((0, 0.1),))
    p0 = params_from_jax(_init(4, 3, 2, seed=0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdg.sgd_train_with_cache(mlp_objective(), p0, ds, meta)
    _, hist = tdg.sgd_train_with_cache(mlp_objective(), p0, ds, meta,
                                       device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdg.baseline_retrain(mlp_objective(), ds, meta, p0, np.array([1]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdg.deltagrad_retrain(mlp_objective(), hist, ds, np.array([1]),
                              tdg.DeltaGradConfig())


def test_history_size_is_bounded_by_the_kernels():
    with pytest.raises(ValueError, match="history_size"):
        tdg.DeltaGradConfig(history_size=9)


ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted(f for f in (ROOT / "src" / "repro_torch").rglob("*.py")
                   if "_build" not in f.parts)
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        bad = [r for r in roots if r in FORBIDDEN]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
