"""The port's xLSTM stack against the JAX package on the CPU, end to end:
its losses and the DeltaGrad objective, prefill and decode, the entry
points, and train -> BaseL -> replay.

The same numpy documents, made from a seed, go through the JAX package and
the port at the reference's reduced xLSTM (``ModelConfig.reduced()`` of
xlstm-350m: one unit of an mLSTM and an sLSTM block, d_model 64, 4 heads,
vocab 256), with the JAX weights carried across (`params_from_jax`).
Tolerances:

  * `lm_loss`, `lm_loss_rows` and the objective's gradient in f32: 1e-5
    (the gradient elementwise), with remat on and off, and every gradient
    finite, at S 64 and at S 512 (two mLSTM chunks of 256, where the
    chunk-boundary stabiliser starts at -inf); in bf16 the reference's
    model bars, 5e-3 on the losses and 5e-2 relative on the gradient;
  * `prefill` against the stepped `decode_step`, and each against the
    other package's: in f32 the states at 1e-5 and the logits at the
    reference's own bar between its mLSTM forms, 2e-5
    (``tests/test_models_smoke.py``): the first step's mLSTM output is
    v (k.q) / max(|k.q|, exp(-i)), k.q a cancelling sum of 32 products,
    scaled up by the cell norm, and the packages' first logits part by up
    to 1.8e-5 (4.1e-6 at the prefill, 3e-6 between each package's own
    prefill and decode); in bf16 the
    logits at the bar of two programs' bf16 logits, 6e-2, and the port's
    prefill-to-decode gap within the reference's own + 6e-2;
  * ``decode_main``: greedy tokens equal; the train CLI's printed loss:
    5e-3 (bf16 compute);
  * train -> BaseL -> replay in f32: the counters and every L-BFGS pair's
    admission exactly equal, the parameters within 1e-5 relative.

The cells and the copies are in ``tests/test_torch_xlstm.py``.
"""

import ast
import contextlib
import dataclasses
import functools
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.registry import get_config as j_get_config
from repro.core import deltagrad as jdg
from repro.core import lbfgs as j_lbfgs
from repro.core.history import HistoryMeta as JMeta
from repro.data.synthetic import token_stream as j_token_stream
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.models.registry import build as j_build

from repro_torch.configs.registry import get_config
from repro_torch.core import deltagrad as tdg
from repro_torch.core import engine as t_engine
from repro_torch.core import lbfgs as t_lbfgs
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build, params_from_jax

ARCH = "xlstm-350m"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = 3e-2
N_DOCS, STEPS, BATCH = 32, 10, 8
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
    """The reference's reduced xLSTM and its weights (seed 1), once."""
    jm = j_build(j_get_config(ARCH).reduced())
    return jm, jm.init(1)


@pytest.fixture(scope="module")
def xlstm():
    jm, jp = _jax_model()
    return jm, build(get_config(ARCH).reduced()), jp, params_from_jax(
        jax.device_get(jp), "cpu")


def _docs(seq):
    return token_stream(N_DOCS, seq, 256, seed=0)


# -- the model's losses and its objective -------------------------------------------


def _jax_objective(model, dtype, seq):
    """`Objective.from_model`'s vmap over batch-1 slices at a compute
    dtype."""

    def per_example_loss(params, batch):
        return jax.vmap(lambda row: model.loss_fn(
            params, jax.tree.map(lambda c: c[None], row), remat=False,
            loss_chunk=seq, dtype=dtype))(batch)

    return jdg.Objective(per_example_loss=per_example_loss)


@functools.lru_cache(maxsize=None)
def _jax_values(dtype, seq):
    """JAX's per-row losses, weighted loss, flat gradient and batch loss on
    the first 4 documents (once per dtype and length)."""
    jm, jp = _jax_model()
    jb = {"tokens": jnp.asarray(_docs(seq).columns["tokens"][:4])}
    jd = DTYPES[dtype][0]
    jo = _jax_objective(jm, jd, seq)
    w = jnp.asarray(np.linspace(0.0, 1.0, 4).astype(np.float32))
    loss, grad = jo.make_value_grad_fn()(jp, jb, w)
    rows, batch = jax.jit(lambda p, b: (jo.per_example_loss(p, b), jm.loss_fn(
        p, b, dtype=jd, remat=False, loss_chunk=seq)))(jp, jb)
    return rows, loss, ravel_pytree(grad)[0], batch


@pytest.mark.parametrize("dtype,seq,remat", [("f32", 64, False), ("f32", 64, True),
                                             ("f32", 512, True), ("bf16", 64, False)])
def test_losses_and_objective_match(xlstm, dtype, seq, remat):
    _, tm, _, tp = xlstm
    td = DTYPES[dtype][1]
    tb = {"tokens": torch.from_numpy(_docs(seq).columns["tokens"][:4])}
    to = tm.objective(loss_chunk=seq, remat=remat, dtype=td)
    w = torch.from_numpy(np.linspace(0.0, 1.0, 4).astype(np.float32))
    j_rows, j_loss, j_grad, j_batch = _jax_values(dtype, seq)
    t_rows = to.per_example_loss(tp, tb)
    t_loss = to.weighted_mean_loss(tp, tb, w)
    t_grad = to.make_grad_fn()(tp, tb, w)
    t_batch = tm.loss_fn(tp, tb, remat=remat, loss_chunk=seq, dtype=td)
    assert torch.isfinite(t_grad).all() and np.isfinite(np.asarray(j_grad)).all()
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
    # every block's weights get a gradient
    g = tp.with_flat(t_grad)
    assert all(bool(g[k].abs().sum() > 0) for k in g)
    # no FFN, no aux term: the batch loss is the mean of the rows
    ce, aux = tt.lm_loss_terms(tp, tb, tm.cfg, remat=remat, loss_chunk=seq, dtype=td)
    assert float(aux) == 0.0 and torch.equal(ce, t_batch)
    assert abs(float(t_rows.mean()) - float(t_batch)) < 1e-5


# -- caches, prefill and decode ---------------------------------------------------------


def test_decode_cache_structure_matches(xlstm):
    jm, tm, _, _ = xlstm
    jc, tc = jm.cache_init(3, 10), tm.cache_init(3, 10, device="cpu")
    assert list(tc) == list(jc) == ["u0", "u1"]
    assert sorted(tc["u0"]) == sorted(jc["u0"]) == ["C", "m", "n"]
    assert sorted(tc["u1"]) == sorted(jc["u1"]) == ["c", "h", "m", "n"]
    for pos in ("u0", "u1"):
        for k, t in tc[pos].items():
            j = jc[pos][k]
            assert tuple(t.shape) == j.shape and t.shape[0] == 1
            assert t.dtype == torch.float32 and str(j.dtype) == "float32"
            assert torch.equal(t, torch.from_numpy(np.asarray(j)))  # m at -inf
    # the mLSTM's matrix memory: B x H x dh x dh, dh = 2 d_model / H
    assert tuple(tc["u0"]["C"].shape) == (1, 3, 4, 32, 32)
    assert tuple(tc["u1"]["h"].shape) == (1, 3, 4, 16)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_and_stepped_decode_match(xlstm, dtype):
    """The full-sequence prefill (chunked mLSTM, the sLSTM's loop) against
    the stepped decode of the same tokens, in each package, and each
    against the other package's; the caches come back."""
    jm, tm, jp, tp = xlstm
    jd, td = DTYPES[dtype]
    T = 24
    toks = np.random.default_rng(0).integers(0, 256, size=(2, T), dtype=np.int32)
    jc, tc = jm.cache_init(2, T), tm.cache_init(2, T, device="cpu")
    jdec = jax.jit(lambda p, b, c: jm.decode_fn(p, b, c, dtype=jd))
    tol = 2e-5 if dtype == "f32" else 2 * BF16_TOL
    for t in range(T):
        jlog, jc = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
        tlog, tc = tm.decode_fn(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                tc, dtype=td)
        assert tlog.dtype == torch.float32 and tlog.shape == (2, 256)
        _close(tlog, jlog, tol)
    for pos, keys in (("u0", "Cnm"), ("u1", "cnhm")):
        for k in keys:
            _close(tc[pos][k], jc[pos][k], 1e-5 if dtype == "f32" else BF16_TOL)
    tpre = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, dtype=td)
    jpre = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, dtype=jd)
    _close(tpre, jpre, tol)
    t_gap = float(np.abs(_np(tpre) - _np(tlog)).max())
    j_gap = float(np.abs(_np(jpre) - _np(jlog)).max())
    if dtype == "f32":
        assert t_gap <= 1e-5 and j_gap <= 1e-5, (t_gap, j_gap)
    else:
        assert t_gap <= j_gap + 2 * BF16_TOL, (t_gap, j_gap)


def test_prefill_needs_whole_chunks(xlstm):
    """A prompt over one mLSTM chunk (256) that is not whole chunks raises,
    as the reference's assertion does; no padding."""
    _, tm, _, tp = xlstm
    toks = torch.zeros(1, 300, dtype=torch.int32)
    with pytest.raises(ValueError, match="must divide by chunk 256"):
        tm.prefill_fn(tp, {"tokens": toks}, dtype=torch.float32)


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


# lr 0.001: on this model and recipe both packages' replays miss d_ui < d_us
# alike (1.4643 in each); at lr 0.003 to 0.01 their approx steps grow w^I - w
# (d_ui/d_us 190-1934 in each, the counters still equal), which multiplies
# the packages' training gap, so the parameters are held where the replay
# does not diverge; phase 18 (d)'s recipe is measured below, over draws
def test_slice_matches_jax_in_f32(xlstm, monkeypatch):
    """Train -> BaseL -> replay: the same steps, pairs and parameters, and
    the same d_ui/d_us."""
    jm, tm, jp, tp = xlstm
    j_pairs, t_pairs = [], []
    _recording_pairs(monkeypatch, j_lbfgs.LbfgsBuffer, j_pairs)
    _recording_pairs(monkeypatch, t_lbfgs.LbfgsBuffer, t_pairs)
    seq = 32
    kw = dict(n=N_DOCS, batch_size=BATCH, seed=5, steps=STEPS, lr_schedule=((0, 0.001),))
    jmeta, tmeta = JMeta(**kw), TMeta(**kw)
    jo = _jax_objective(jm, jnp.float32, seq)
    jdocs = j_token_stream(N_DOCS, seq, 256, seed=0)
    jw_star, jh = jdg.sgd_train_with_cache(jo, jp, jdocs, jmeta)
    jw_u, _ = jdg.baseline_retrain(jo, jdocs, jmeta, jp, REMOVED)
    jw_i, jst = jdg.deltagrad_retrain(jo, jh, jdocs, REMOVED, jdg.DeltaGradConfig(**DG))

    to = tm.objective(loss_chunk=seq, dtype=torch.float32)
    docs = _docs(seq)
    w_star, hist = tdg.sgd_train_with_cache(to, tp, docs, tmeta, device="cpu")
    w_u, _ = tdg.baseline_retrain(to, docs, tmeta, tp, REMOVED, device="cpu")
    w_i, st = tdg.deltagrad_retrain(to, hist, docs, REMOVED,
                                    tdg.DeltaGradConfig(**DG), device="cpu")
    assert len(t_pairs) == len(j_pairs) == st.explicit_steps
    assert [t[2] for t in t_pairs] == [j[2] for j in j_pairs]
    for (tc, ts, _), (jc, js, _) in zip(t_pairs, j_pairs):
        assert abs(tc - jc) <= 1e-3 * abs(jc) + 1e-12 and abs(ts - js) <= 1e-3 * js + 1e-12
    assert st.counters() == {k: getattr(jst, k) for k in st.counters()}
    assert st.approx_steps > 0 and st.explicit_steps > 0
    for t, j in ((w_star, jw_star), (w_u, jw_u), (w_i, jw_i)):
        assert _rel(t.flat, ravel_pytree(j)[0]) <= 1e-5
    flat = [np.asarray(ravel_pytree(t)[0], np.float64) for t in (jw_star, jw_u, jw_i)]
    j_ui, j_us = np.linalg.norm(flat[1] - flat[2]), np.linalg.norm(flat[1] - flat[0])
    t_ui = float((w_u.flat - w_i.flat).double().norm())
    t_us = float((w_u.flat - w_star.flat).double().norm())
    assert abs(t_ui / t_us - j_ui / j_us) <= 1e-4 * j_ui / j_us


# -- the entry points -----------------------------------------------------------------


def _jax_init_for(monkeypatch):
    """The port's `Model.init` drawing the JAX package's weights, so the two
    CLIs run the same model."""

    def init(self, seed=0, device=None):
        jp = j_build(j_get_config(self.cfg.name).reduced()).init(seed)
        return params_from_jax(jax.device_get(jp), device)

    monkeypatch.setattr(t_registry.Model, "init", init)


def test_decode_main_greedy_tokens_match_the_reference(monkeypatch):
    argv = ["--arch", ARCH, "--reduced", "--batch", "4", "--prompt-len", "16",
            "--gen", "12"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_serve.decode_main()
    j_row0 = ast.literal_eval(out.getvalue().splitlines()[-1].split(":", 1)[1].strip())
    _jax_init_for(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = t_serve.decode_main(argv + ["--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("prefill 16 tok x 4 in ")
    assert lines[1] == "sample row 0: " + str(res["tokens"][0].tolist())
    assert res["tokens"].shape == res["margins"].shape == (4, 12)
    assert res["tokens"][0].tolist() == j_row0


def test_train_cli_step_matches_the_reference(monkeypatch):
    _jax_init_for(monkeypatch)
    argv = ["--arch", ARCH, "--reduced", "--steps", "1", "--batch", "4",
            "--seq", "32", "--log-every", "1"]
    outs = []
    for main, extra in ((j_train.main, []), (t_train.main, ["--device", "cpu"])):
        buf = io.StringIO()
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        with contextlib.redirect_stdout(buf):
            res = main() if not extra else main(argv + extra)
        outs.append(float(buf.getvalue().split("loss", 1)[1].split()[0]))
    assert abs(outs[0] - outs[1]) < 5e-3, outs
    assert res["state"].step == 1 and np.isfinite(res["losses"][0])


def test_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(get_config(ARCH).reduced())
    for call in (lambda: model.init(0), lambda: model.cache_init(2, 4),
                 lambda: t_serve.decode_main(["--arch", ARCH, "--reduced"]),
                 lambda: t_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    caches = model.cache_init(2, 4, device="cpu")
    assert {c.device.type for v in caches.values() for c in v.values()} == {"cpu"}


# -- chip_smoke.py phase 18 (d)'s recipe ---------------------------------------------
# phase 9's recipe (lr 0.01, T 12, T0 4, j0 6, m 2, the guard; 128 documents, B
# 32, 4 rows deleted) on one unit of xlstm-350m's layout (an mLSTM and an sLSTM
# block) cut in width to d_model d, 4 heads, vocab 4096.  Run as a script, this
# prints both packages' d_ui/d_us over draws:
#   PYTHONPATH=src python tests/test_torch_xlstm_slice.py 128,128,bf16,8
RECIPE = dict(docs=128, batch=32, steps=12, lr=0.01, removed=[3, 42, 81, 120],
              dg=dict(period=4, burn_in=6, history_size=2, guard=True,
                      curvature_eps=1e-8))


def _recipe_run(d, S, dtype="f32", seed=0):
    """Train -> BaseL -> replay in both packages on the same JAX init, at
    the compute `dtype`, the init and the documents drawn from `seed`:
    {package: (d_ui, d_us, counters)}, the port's ||Bv||/||v|| per B v,
    and the two replays' max |gap|."""
    kw = dict(d_model=d, n_heads=4, n_kv_heads=4, vocab=4096)
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(seed)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    removed = np.asarray(RECIPE["removed"], np.int64)
    meta = dict(n=RECIPE["docs"], batch_size=RECIPE["batch"], seed=5,
                steps=RECIPE["steps"], lr_schedule=((0, RECIPE["lr"]),))
    chunk = min(128, S)
    jd, td = DTYPES[dtype]
    jo = _jax_objective(jm, jd, chunk)
    jdocs = j_token_stream(RECIPE["docs"], S, 4096, seed=seed)
    jw, jh = jdg.sgd_train_with_cache(jo, jp, jdocs, JMeta(**meta))
    jw_u, _ = jdg.baseline_retrain(jo, jdocs, JMeta(**meta), jp, removed)
    jw_i, jst = jdg.deltagrad_retrain(jo, jh, jdocs, removed,
                                      jdg.DeltaGradConfig(**RECIPE["dg"]))
    flat = [np.asarray(ravel_pytree(t)[0], np.float64) for t in (jw, jw_u, jw_i)]

    to = tm.objective(loss_chunk=chunk, dtype=td)
    docs = token_stream(RECIPE["docs"], S, 4096, seed=seed)
    ratios, hvp = [], t_engine.lbfgs_hvp_fused

    def recording(dW, dG, v, valid=None):
        out = hvp(dW, dG, v, valid)
        ratios.append(float(out.norm() / v.norm()))
        return out

    w, hist = tdg.sgd_train_with_cache(to, tp, docs, TMeta(**meta), device="cpu")
    w_u, _ = tdg.baseline_retrain(to, docs, TMeta(**meta), tp, removed, device="cpu")
    t_engine.lbfgs_hvp_fused = recording
    try:
        w_i, st = tdg.deltagrad_retrain(to, hist, docs, removed,
                                        tdg.DeltaGradConfig(**RECIPE["dg"]),
                                        device="cpu")
    finally:
        t_engine.lbfgs_hvp_fused = hvp
    port = [t.flat.double().numpy() for t in (w, w_u, w_i)]
    out = {}
    for name, (ws, wu, wi), counters in (
            ("jax", flat, {k: getattr(jst, k) for k in st.counters()}),
            ("port", port, st.counters())):
        out[name] = (float(np.linalg.norm(wu - wi)), float(np.linalg.norm(wu - ws)),
                     counters)
    return out, ratios, float(np.abs(port[2] - flat[2]).max())


def _prefill_gaps(layers, full=False, prompt=128, batch=4):
    """Both packages' `prefill_fn` against their own stepped decode of the
    same prompt, at `layers` layers of the reduced xLSTM (of the published
    widths if `full`), in bf16 and f32 compute: {dtype: ((jax max, mean),
    (port max, mean))}."""
    jcfg, tcfg = j_get_config(ARCH), get_config(ARCH)
    if not full:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jcfg = dataclasses.replace(jcfg, n_layers=layers)
    tcfg = dataclasses.replace(tcfg, n_layers=layers)
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(0)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, size=(batch, prompt),
                                             dtype=np.int32)
    out = {}
    for name, (jd, td) in DTYPES.items():
        jc, tc = jm.cache_init(batch, prompt), tm.cache_init(batch, prompt, device="cpu")
        jdec = jax.jit(lambda p, b, c: jm.decode_fn(p, b, c, dtype=jd))
        for t in range(prompt):
            jlog, jc = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
            tlog, tc = tm.decode_fn(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                    tc, dtype=td)
        jpre = jax.jit(lambda p, b: jm.prefill_fn(p, b, dtype=jd))(
            jp, {"tokens": jnp.asarray(toks)})
        tpre = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, dtype=td)
        gaps = [np.abs(_np(a) - _np(b)) for a, b in ((jpre, jlog), (tpre, tlog))]
        out[name] = tuple((float(g.max()), float(g.mean())) for g in gaps)
    return out


if __name__ == "__main__":
    # "prefill,L[,full][,Bn]": both packages' prefill-to-stepped-decode gaps
    # at L layers of the reduced xLSTM (of the published widths with "full"),
    # a batch of n rows (4 by default);
    # each other argument d,S[,dtype[,seeds]]: the
    # recipe at d_model d and S tokens a document, over seeds 0 .. seeds -
    # 1, then how many replays of each package missed d_ui < d_us and in how
    # many draws the counters agreed
    torch.set_num_threads(1)
    for spec in sys.argv[1:]:
        if spec.startswith("prefill,"):
            n, full = int(spec.split(",")[1]), ",full" in spec
            B = int(spec.split(",B")[1]) if ",B" in spec else 4
            for name, ((jm_, jmean), (tm_, tmean)) in _prefill_gaps(n, full, batch=B).items():
                print(f"{ARCH} {'full width' if full else 'reduced'}, {n} layers, B {B}, "
                      f"a 128 prompt, {name}: prefill "
                      f"against the stepped decode: jax max {jm_:.5e} mean {jmean:.5e}; "
                      f"port max {tm_:.5e} mean {tmean:.5e}", flush=True)
            continue
        d, S, *rest = spec.split(",")
        dtype, seeds = (rest + ["f32"])[0], int((rest + ["f32", "1"])[1])
        misses, agree = {"jax": 0, "port": 0}, 0
        for seed in range(seeds):
            out, ratios, gap = _recipe_run(int(d), int(S), dtype, seed)
            agree += out["jax"][2] == out["port"][2]
            for k, v in out.items():
                misses[k] += not v[0] < v[1]
            print(f"{ARCH} 1 unit d_model {d} S {S} {dtype} seed {seed}: " + "; ".join(
                f"{k} d_ui {v[0]:.6e} d_us {v[1]:.6e} d_ui/d_us {v[0] / v[1]:.4e}"
                for k, v in out.items())
                + f"; counters equal: {out['jax'][2] == out['port'][2]} port "
                f"{out['port'][2]} jax {out['jax'][2]}; port ||Bv||/||v|| "
                + " ".join(f"{r:.4e}" for r in ratios)
                + f"; max |w_I gap| {gap:.3e}", flush=True)
        print(f"{ARCH} d_model {d} S {S} {dtype}, {seeds} seeds: d_ui/d_us >= 1 in "
              f"{misses['jax']} (jax) and {misses['port']} (port); counters equal "
              f"in {agree}", flush=True)
