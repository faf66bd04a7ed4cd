"""The port's Zamba2 hybrid against the JAX package on the CPU, end to end:
its losses, the DeltaGrad objective, and train -> BaseL -> replay.

The same numpy documents, made from a seed, go through the JAX package and
the port at the reference's reduced hybrid (``ModelConfig.reduced()`` of
zamba2-7b: one unit of five Mamba2 blocks and the shared attention block,
d_model 64, vocab 256; d_state 16, head_dim 16, chunk 16), with the JAX
weights carried across (`params_from_jax`).  Tolerances:

  * `lm_loss`, `lm_loss_rows` and the objective's gradient in f32: 1e-5;
    in bf16, the reference's model bars, 5e-3 on the loss and 5e-2
    relative on the gradient; with remat on and off;
  * train -> BaseL -> replay in f32: each pair's admission alike but one
    noise pair the reference admits (dw of rounding size, where the port's
    dw is exactly 0), so the counters are exactly equal but for that one
    rejection, and the parameters within 1e-5 relative.

The modules, the caches, prefill and decode and the entry points are in
``tests/test_torch_mamba2.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.registry import get_config as j_get_config
from repro.core import deltagrad as jdg
from repro.core.history import HistoryMeta as JMeta
from repro.data.synthetic import token_stream as j_token_stream
from repro.models.registry import build as j_build

from repro_torch.configs.registry import get_config
from repro_torch.core import deltagrad as tdg
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.data.synthetic import token_stream
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build, params_from_jax

ARCH = "zamba2-7b"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
N_DOCS, SEQ, STEPS, BATCH = 32, 32, 10, 8
REMOVED = np.asarray([3, 11, 25], np.int64)
DG = dict(period=2, burn_in=4, history_size=2, guard=True, curvature_eps=1e-8)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


def _rel(a, b) -> float:
    a, b = np.ravel(_np(a)), np.ravel(_np(b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread per test: the suite runs its files in
    several worker processes on the same cores, and every worker's thread
    pool spinning for them slows the port's small CPU ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The reference's reduced hybrid and its weights (seed 1), once."""
    jm = j_build(j_get_config(ARCH).reduced())
    return jm, jm.init(1)


@pytest.fixture(scope="module")
def hybrid():
    jm, jp = _jax_model()
    return jm, build(get_config(ARCH).reduced()), jp, params_from_jax(
        jax.device_get(jp), "cpu")


# -- the model's losses and its objective -------------------------------------------


def _docs():
    return token_stream(N_DOCS, SEQ, 256, seed=0)


def _jax_objective(model, dtype):
    """`Objective.from_model`'s vmap over batch-1 slices, at a compute
    dtype (None: the model's default, which `from_model` itself uses)."""
    if dtype is None:
        return jdg.Objective.from_model(model, loss_chunk=SEQ)

    def per_example_loss(params, batch):
        return jax.vmap(lambda row: model.loss_fn(
            params, jax.tree.map(lambda c: c[None], row), remat=False,
            loss_chunk=SEQ, dtype=dtype))(batch)

    return jdg.Objective(per_example_loss=per_example_loss)


@functools.lru_cache(maxsize=None)
def _jax_values(dtype):
    """JAX's per-row losses, weighted loss, flat gradient and batch loss on
    the first 8 documents (once per dtype)."""
    jm, jp = _jax_model()
    jb = {"tokens": jnp.asarray(_docs().columns["tokens"][:8])}
    jd = DTYPES[dtype][0]
    jo = _jax_objective(jm, jd if dtype == "f32" else None)
    w = jnp.asarray(np.linspace(0.0, 1.0, 8).astype(np.float32))
    loss, grad = jo.make_value_grad_fn()(jp, jb, w)
    rows, batch = jax.jit(lambda p, b: (jo.per_example_loss(p, b), jm.loss_fn(
        p, b, dtype=jd, remat=False, loss_chunk=SEQ)))(jp, jb)
    return rows, loss, ravel_pytree(grad)[0], batch


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("remat", [False, True])
def test_losses_and_objective_match(hybrid, dtype, remat):
    _, tm, _, tp = hybrid
    td = DTYPES[dtype][1]
    tb = {"tokens": torch.from_numpy(_docs().columns["tokens"][:8])}
    to = tm.objective(loss_chunk=SEQ, remat=remat,
                      dtype=torch.float32 if dtype == "f32" else None)
    w = torch.from_numpy(np.linspace(0.0, 1.0, 8).astype(np.float32))
    j_rows, j_loss, j_grad, j_batch = _jax_values(dtype)
    t_rows = to.per_example_loss(tp, tb)
    t_loss = to.weighted_mean_loss(tp, tb, w)
    t_grad = to.make_grad_fn()(tp, tb, w)
    t_batch = tm.loss_fn(tp, tb, remat=remat, loss_chunk=SEQ, dtype=td)
    assert torch.isfinite(t_grad).all()
    if dtype == "f32":
        _close(t_rows, j_rows, 1e-5)
        assert abs(float(t_loss) - float(j_loss)) < 1e-5
        _close(t_grad, j_grad, 1e-5)
        assert abs(float(t_batch) - float(j_batch)) < 1e-5
    else:
        _close(t_rows, j_rows, 5e-3)
        assert _rel(t_grad, j_grad) < 5e-2
        assert abs(float(t_loss) - float(j_loss)) < 5e-3
        assert abs(float(t_batch) - float(j_batch)) < 5e-3
    # the shared block's gradient sums over its uses: nonzero, as the rest
    g = tp.with_flat(t_grad)
    assert all(bool(g[k].abs().sum() > 0) for k in g if k.startswith("shared/mixer"))
    # a dense FFN: the batch loss is the mean of the rows, and no aux term
    ce, aux = tt.lm_loss_terms(tp, tb, tm.cfg, remat=remat, loss_chunk=SEQ, dtype=td)
    assert float(aux) == 0.0 and torch.equal(ce, t_batch)
    assert abs(float(t_rows.mean()) - float(t_batch)) < 1e-5


# -- the slice as a whole, f32 --------------------------------------------------------


def _recording_pairs(monkeypatch, cls, into):
    """Record each L-BFGS pair's (curv, ss, admitted) as `cls.add_pair`
    decides it."""
    add = cls.add_pair

    def recording(self, dw, dg, curv, ss):
        out = add(self, dw, dg, curv, ss)
        into.append((float(curv), float(ss), out))
        return out

    monkeypatch.setattr(cls, "add_pair", recording)


def test_slice_matches_jax_in_f32(hybrid, monkeypatch):
    """Train -> BaseL -> replay: the same steps, pairs and parameters.  One
    difference is the reference's: at t = 1 (no deleted row in batch 0)
    its replay's w_1 parts from the recorded one by rounding (ss 3e-14)
    and it admits that noise pair, where the port's replay repeats the
    recorded step bitwise (dw = 0, rejected).  The buffer keeps two pairs,
    so the noise pair is gone before the first approx step: every other
    decision, and the parameters, agree."""
    from repro.core import lbfgs as j_lbfgs
    from repro_torch.core import lbfgs as t_lbfgs

    jm, tm, jp, tp = hybrid
    j_pairs, t_pairs = [], []
    _recording_pairs(monkeypatch, j_lbfgs.LbfgsBuffer, j_pairs)
    _recording_pairs(monkeypatch, t_lbfgs.LbfgsBuffer, t_pairs)
    kw = dict(n=N_DOCS, batch_size=BATCH, seed=5, steps=STEPS, lr_schedule=((0, 0.01),))
    jmeta, tmeta = JMeta(**kw), TMeta(**kw)
    jo = _jax_objective(jm, jnp.float32)
    jdocs = j_token_stream(N_DOCS, SEQ, 256, seed=0)
    jw_star, jh = jdg.sgd_train_with_cache(jo, jp, jdocs, jmeta)
    jw_u, _ = jdg.baseline_retrain(jo, jdocs, jmeta, jp, REMOVED)
    jw_i, jst = jdg.deltagrad_retrain(jo, jh, jdocs, REMOVED, jdg.DeltaGradConfig(**DG))

    to = tm.objective(loss_chunk=SEQ, dtype=torch.float32, attn_impl="flash")
    docs = _docs()
    w_star, hist = tdg.sgd_train_with_cache(to, tp, docs, tmeta, device="cpu")
    w_u, _ = tdg.baseline_retrain(to, docs, tmeta, tp, REMOVED, device="cpu")
    w_i, st = tdg.deltagrad_retrain(to, hist, docs, REMOVED,
                                    tdg.DeltaGradConfig(**DG), device="cpu")
    assert len(t_pairs) == len(j_pairs) == st.explicit_steps
    noise = [i for i, (t, j) in enumerate(zip(t_pairs, j_pairs)) if t[2] != j[2]]
    assert noise == [1] and t_pairs[1] == (0.0, 0.0, False)
    assert j_pairs[1][2] and 0 < j_pairs[1][1] < 1e-12
    for (tc, ts, _), (jc, js, _) in zip(t_pairs[2:], j_pairs[2:]):
        assert abs(tc - jc) <= 1e-3 * abs(jc) and abs(ts - js) <= 1e-3 * js
    for k, v in st.counters().items():
        want = getattr(jst, k) + (len(noise) if k == "pairs_rejected" else 0)
        assert v == want, (k, st.counters(), jst)
    assert st.approx_steps > 0 and st.explicit_steps > 0
    for t, j in ((w_star, jw_star), (w_u, jw_u), (w_i, jw_i)):
        assert _rel(t.flat, ravel_pytree(j)[0]) <= 1e-5
    t_ui = float((w_u.flat - w_i.flat).double().norm())
    t_us = float((w_u.flat - w_star.flat).double().norm())
    assert t_ui < t_us
