"""The port's encoder-decoder family (Whisper) against the JAX package on
the CPU, end to end: its losses and the DeltaGrad objective, train ->
BaseL -> replay, and the entry points.

The same numpy frames and documents, made from a seed, go through the JAX
package and the port at the reference's reduced whisper-large-v3 (2
encoder + 2 decoder layers, d_model 64, 4 heads of 16, vocab 256), with
the JAX weights carried across (`params_from_jax`).  Tolerances:

  * `lm_loss`, the per-row loss against the reference's vmap of `lm_loss`
    over batch-1 slices, and the objective's gradient in f32: 1e-5, with
    remat on and off; in bf16 the reference's model bars, 5e-3 on the
    losses and 5e-2 relative on the gradient;
  * train -> BaseL -> replay in f32: the counters and every L-BFGS pair's
    admission exactly equal, the parameters within 1e-5 relative, and
    d_ui/d_us within 1e-4 of the reference's, relative;
  * ``decode_main``: greedy tokens equal (the reference's CLI decodes
    against 64 cross K/V slots of zeros, and so does the port's);
  * the train CLI: a resumed run bitwise the uninterrupted one.

The modules are in ``tests/test_torch_encdec.py``.
"""

import ast
import contextlib
import dataclasses
import functools
import io
import shutil
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
from repro.data.dataset import Dataset as JDataset
from repro.launch import serve as j_serve
from repro.models import encdec as je
from repro.models import transformer as jt
from repro.models.registry import build as j_build

from repro_torch.configs.registry import get_config
from repro_torch.core import deltagrad as tdg
from repro_torch.core import lbfgs as t_lbfgs
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.data.dataset import Dataset
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import encdec as te
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build, params_from_jax
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.utils.tree import nested

ARCH = "whisper-large-v3"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
N_DOCS, S_ENC, SEQ, STEPS, BATCH = 32, 24, 16, 10, 8
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
    several worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model():
    jm = j_build(j_get_config(ARCH).reduced())
    return jm, jm.init(1)


@pytest.fixture(scope="module")
def whisper():
    jm, jp = _jax_model()
    return jm, build(get_config(ARCH).reduced()), jp, params_from_jax(
        jax.device_get(jp), "cpu")


def _columns(n_docs, s_enc, seq, d, vocab, seed=0):
    """Each row: frames (s_enc, d) N(0, 1) and a document of `seq` tokens
    (`token_stream`), made from `seed` with numpy."""
    frames = np.random.default_rng(seed + 100).normal(
        size=(n_docs, s_enc, d)).astype(np.float32)
    return {"frames": frames,
            "tokens": token_stream(n_docs, seq, vocab, seed=seed).columns["tokens"]}


def _jax_objective(model, dtype, chunk, remat=False):
    """`Objective.from_model`'s vmap over batch-1 slices at a compute
    dtype."""

    def per_example_loss(params, batch):
        return jax.vmap(lambda row: model.loss_fn(
            params, jax.tree.map(lambda c: c[None], row), remat=remat,
            loss_chunk=chunk, dtype=dtype))(batch)

    return jdg.Objective(per_example_loss=per_example_loss)


@functools.lru_cache(maxsize=None)
def _jax_values(dtype):
    """JAX's per-row losses, weighted loss, flat gradient and batch loss on
    the first 4 rows."""
    jm, jp = _jax_model()
    cols = _columns(4, S_ENC, SEQ, 64, 256)
    jb = {k: jnp.asarray(v) for k, v in cols.items()}
    jd = DTYPES[dtype][0]
    jo = _jax_objective(jm, jd, 8)
    w = jnp.asarray(np.linspace(0.0, 1.0, 4).astype(np.float32))
    loss, grad = jo.make_value_grad_fn()(jp, jb, w)
    rows, batch = jax.jit(lambda p, b: (jo.per_example_loss(p, b), jm.loss_fn(
        p, b, dtype=jd, remat=False, loss_chunk=8)))(jp, jb)
    return rows, loss, ravel_pytree(grad)[0], batch


# -- the losses and the objective -------------------------------------------------------


@pytest.mark.parametrize("dtype,remat,attn", [("f32", False, None), ("f32", True, None),
                                              ("f32", True, "flash"),
                                              ("bf16", False, None)])
def test_losses_and_objective_match(whisper, dtype, remat, attn):
    _, tm, _, tp = whisper
    td = DTYPES[dtype][1]
    cols = _columns(4, S_ENC, SEQ, 64, 256)
    tb = {k: torch.from_numpy(v) for k, v in cols.items()}
    to = tm.objective(loss_chunk=8, remat=remat, dtype=td, attn_impl=attn)
    w = torch.from_numpy(np.linspace(0.0, 1.0, 4).astype(np.float32))
    j_rows, j_loss, j_grad, j_batch = _jax_values(dtype)
    t_rows = to.per_example_loss(tp, tb)
    t_loss = to.weighted_mean_loss(tp, tb, w)
    t_grad = to.make_grad_fn()(tp, tb, w)
    t_batch = tm.loss_fn(tp, tb, remat=remat, loss_chunk=8, dtype=td)
    assert t_rows.shape == (4,) and torch.isfinite(t_grad).all()
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
    g = tp.with_flat(t_grad)
    assert all(bool(g[k].abs().sum() > 0) for k in g)
    assert abs(float(t_rows.mean()) - float(t_batch)) < 1e-5


def test_row_loss_is_the_row_alone(whisper):
    """Row i's loss does not depend on the other rows of its batch: the
    rows' losses in a batch of 4 equal each row's batch of one."""
    _, tm, _, tp = whisper
    cols = _columns(4, S_ENC, SEQ, 64, 256)
    tb = {k: torch.from_numpy(v) for k, v in cols.items()}
    rows = tm.per_row_loss_fn(tp, tb, dtype=torch.float32, remat=False, loss_chunk=8)
    for i in range(4):
        one = tm.loss_fn(tp, {k: v[i:i + 1] for k, v in tb.items()},
                         dtype=torch.float32, remat=False, loss_chunk=8)
        assert abs(float(rows[i]) - float(one)) < 1e-6


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


def test_slice_matches_jax_in_f32(whisper, monkeypatch):
    """Train -> BaseL -> replay on rows of frames and tokens: the same
    steps, pairs and parameters, and the same d_ui/d_us."""
    jm, tm, jp, tp = whisper
    j_pairs, t_pairs = [], []
    _recording_pairs(monkeypatch, j_lbfgs.LbfgsBuffer, j_pairs)
    _recording_pairs(monkeypatch, t_lbfgs.LbfgsBuffer, t_pairs)
    cols = _columns(N_DOCS, S_ENC, SEQ, 64, 256)
    kw = dict(n=N_DOCS, batch_size=BATCH, seed=5, steps=STEPS, lr_schedule=((0, 0.05),))
    jmeta, tmeta = JMeta(**kw), TMeta(**kw)
    jo = _jax_objective(jm, jnp.float32, SEQ)
    jdocs = JDataset(cols)
    jw_star, jh = jdg.sgd_train_with_cache(jo, jp, jdocs, jmeta)
    jw_u, _ = jdg.baseline_retrain(jo, jdocs, jmeta, jp, REMOVED)
    jw_i, jst = jdg.deltagrad_retrain(jo, jh, jdocs, REMOVED, jdg.DeltaGradConfig(**DG))

    to = tm.objective(loss_chunk=SEQ, dtype=torch.float32)
    docs = Dataset(cols)
    w_star, hist = tdg.sgd_train_with_cache(to, tp, docs, tmeta, device="cpu")
    w_u, _ = tdg.baseline_retrain(to, docs, tmeta, tp, REMOVED, device="cpu")
    w_i, st = tdg.deltagrad_retrain(to, hist, docs, REMOVED,
                                    tdg.DeltaGradConfig(**DG), device="cpu")
    assert len(t_pairs) == len(j_pairs) == st.explicit_steps
    assert [t[2] for t in t_pairs] == [j[2] for j in j_pairs]
    assert st.counters() == {k: getattr(jst, k) for k in st.counters()}
    assert st.approx_steps > 0 and st.explicit_steps > 0
    for t, j in ((w_star, jw_star), (w_u, jw_u), (w_i, jw_i)):
        assert _rel(t.flat, ravel_pytree(j)[0]) <= 1e-5
    flat = [np.asarray(ravel_pytree(t)[0], np.float64) for t in (jw_star, jw_u, jw_i)]
    j_ui, j_us = np.linalg.norm(flat[1] - flat[2]), np.linalg.norm(flat[1] - flat[0])
    t_ui = float((w_u.flat - w_i.flat).double().norm())
    t_us = float((w_u.flat - w_star.flat).double().norm())
    assert abs(t_ui / t_us - j_ui / j_us) <= 1e-4 * j_ui / j_us
    assert t_ui < t_us


# -- the entry points -----------------------------------------------------------------


def _jax_init_for(monkeypatch):
    """The port's `Model.init` drawing the JAX package's weights, so the two
    CLIs run the same model."""

    def init(self, seed=0, device=None):
        jp = j_build(j_get_config(self.cfg.name).reduced()).init(seed)
        return params_from_jax(jax.device_get(jp), device)

    monkeypatch.setattr(t_registry.EncDecModel, "init", init)


def test_decode_main_greedy_tokens_match_the_reference(monkeypatch):
    """The reference's CLI run with its jit's buffer donation off: its
    `init_caches` gives cross_k and cross_v as one zeros array, which
    ``donate_argnums`` then donates twice, and XLA refuses that (a
    reference fact, ROADMAP.md queue 3)."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "4", "--prompt-len", "12",
            "--gen", "10"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jit = jax.jit
    monkeypatch.setattr(jax, "jit", lambda f, donate_argnums=(): jit(f))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_serve.decode_main()
    monkeypatch.setattr(jax, "jit", jit)
    j_row0 = ast.literal_eval(out.getvalue().splitlines()[-1].split(":", 1)[1].strip())
    _jax_init_for(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = t_serve.decode_main(argv + ["--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("prefill 12 tok x 4 in ")
    assert lines[1] == "sample row 0: " + str(res["tokens"][0].tolist())
    assert res["tokens"].shape == res["margins"].shape == (4, 10)
    assert res["tokens"][0].tolist() == j_row0


def test_generate_decodes_against_filled_cross_caches(whisper):
    """`generate` on caches the caller filled from a real encoder memory
    (`encode` -> `fill_cross_caches`): its logits after the prompt are the
    stepped `decode_step`'s on the same caches, and its greedy tokens
    differ from a decode against zero cross caches."""
    _, tm, _, tp = whisper
    params = tt.cast_params(nested(tp), torch.bfloat16)
    frames, prompt = _columns(2, S_ENC, 6, 64, 256)["frames"], \
        np.random.default_rng(1).integers(0, 256, size=(2, 6), dtype=np.int32)

    def filled():
        c = tm.cache_init(2, 6 + 5, enc_len=S_ENC, device="cpu")
        mem = te.encode(params, torch.from_numpy(frames).to(torch.bfloat16), tm.cfg)
        c["cross_k"], c["cross_v"] = te.fill_cross_caches(params, mem, tm.cfg)
        return c

    res = t_serve.generate(tm, params, prompt, 5, device="cpu", caches=filled())
    c = filled()
    for t in range(6):
        logits, c = tm.decode_fn(params, {"tokens": torch.from_numpy(prompt[:, t:t + 1])}, c)
    assert torch.equal(res["prompt_logits"], logits)
    zero = t_serve.generate(tm, params, prompt, 5, device="cpu",
                            caches=tm.cache_init(2, 11, enc_len=S_ENC, device="cpu"))
    assert not torch.equal(zero["prompt_logits"], res["prompt_logits"])


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = t_train.main(argv)
    return buf.getvalue(), res


def test_train_cli_audio_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """The audio branch draws its frames from a generator seeded by the
    step, so a run resumed after step 2's checkpoint sees the same frames
    and ends bitwise where the uninterrupted run ends."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1", "--lr", "0.003"]
    _, whole = _run(argv)
    assert t_ckpt.complete_steps(str(tmp_path)) == [2, 4]
    shutil.rmtree(tmp_path / "step_00000004")
    text, resumed = _run(argv)
    assert "resumed from step 2" in text and resumed["start"] == 2
    for s in (2, 3):
        assert resumed["losses"][s] == whole["losses"][s]
    a, b = whole["state"], resumed["state"]
    assert a.step == b.step == 4
    assert torch.equal(a.params.flat, b.params.flat)
    for k in ("m", "v"):
        assert torch.equal(a.opt_state[k], b.opt_state[k])
    assert np.isfinite(list(whole["losses"].values())).all()


def test_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(get_config(ARCH).reduced())
    for call in (lambda: model.init(0), lambda: model.cache_init(2, 4),
                 lambda: t_serve.decode_main(["--arch", ARCH, "--reduced"]),
                 lambda: t_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    caches = model.cache_init(2, 4, enc_len=3, device="cpu")
    assert {c.device.type for c in (caches["cross_k"], caches["self"]["k"])} == {"cpu"}


# -- chip_smoke.py phase 19's bars ---------------------------------------------------
# Run as a script, this prints both packages' numbers that phase 19 is held to:
#   PYTHONPATH=src python tests/test_torch_encdec_slice.py prefill,2,B16
# prints each package's `prefill` against its stepped decode (encode ->
# fill_cross_caches -> decode_step) at the published widths and 2 + 2
# layers (of L + L with "prefill,L"), B rows of 1500 frames and a 128
# prompt, in bf16 and f32 compute; and
#   PYTHONPATH=src python tests/test_torch_encdec_slice.py 128,64,32,bf16,8
# runs phase 19 (d)'s recipe (phase 9's: lr 0.01, T 12, T0 4, j0 6, m 2,
# the guard; 128 rows, B 32, 4 rows deleted) at d_model 128 with 64 frames
# and 32 tokens a row, over 8 draws, and prints both packages' d_ui/d_us.
RECIPE = dict(docs=128, batch=32, steps=12, lr=0.01, removed=[3, 42, 81, 120],
              dg=dict(period=4, burn_in=6, history_size=2, guard=True,
                      curvature_eps=1e-8))


def _recipe_run(d, s_enc, seq, dtype="f32", seed=0):
    """Train -> BaseL -> replay in both packages on the same JAX init at
    d_model d: {package: (d_ui, d_us, counters)}."""
    kw = dict(d_model=d, n_heads=4, n_kv_heads=4, d_head=d // 4, d_ff=2 * d, vocab=4096)
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(seed)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    removed = np.asarray(RECIPE["removed"], np.int64)
    meta = dict(n=RECIPE["docs"], batch_size=RECIPE["batch"], seed=5,
                steps=RECIPE["steps"], lr_schedule=((0, RECIPE["lr"]),))
    cols = _columns(RECIPE["docs"], s_enc, seq, d, 4096, seed=seed)
    jd, td = DTYPES[dtype]
    jo = _jax_objective(jm, jd, seq, remat=True)
    jdocs = JDataset(cols)
    jw, jh = jdg.sgd_train_with_cache(jo, jp, jdocs, JMeta(**meta))
    jw_u, _ = jdg.baseline_retrain(jo, jdocs, JMeta(**meta), jp, removed)
    jw_i, jst = jdg.deltagrad_retrain(jo, jh, jdocs, removed,
                                      jdg.DeltaGradConfig(**RECIPE["dg"]))
    flat = [np.asarray(ravel_pytree(t)[0], np.float64) for t in (jw, jw_u, jw_i)]
    to = tm.objective(loss_chunk=seq, dtype=td, remat=True)
    docs = Dataset(cols)
    w, hist = tdg.sgd_train_with_cache(to, tp, docs, TMeta(**meta), device="cpu")
    w_u, _ = tdg.baseline_retrain(to, docs, TMeta(**meta), tp, removed, device="cpu")
    w_i, st = tdg.deltagrad_retrain(to, hist, docs, removed,
                                    tdg.DeltaGradConfig(**RECIPE["dg"]), device="cpu")
    port = [t.flat.double().numpy() for t in (w, w_u, w_i)]
    out = {}
    for name, (ws, wu, wi), counters in (
            ("jax", flat, {k: getattr(jst, k) for k in st.counters()}),
            ("port", port, st.counters())):
        out[name] = (float(np.linalg.norm(wu - wi)), float(np.linalg.norm(wu - ws)),
                     counters)
    return out


def _prefill_gaps(layers, batch=16, prompt=128, s_enc=1500):
    """Both packages' `prefill_fn` against their own stepped decode (the
    cross caches filled from the same memory) at the published widths and
    `layers` + `layers` layers: {dtype: ((jax max, mean), (port max,
    mean))}."""
    jcfg = dataclasses.replace(j_get_config(ARCH), n_layers=layers, n_encoder_layers=layers)
    tcfg = dataclasses.replace(get_config(ARCH), n_layers=layers, n_encoder_layers=layers)
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(0)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(batch, s_enc, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab, size=(batch, prompt), dtype=np.int32)
    out = {}
    for name, (jd, td) in DTYPES.items():
        jcast, tcast = jt.cast_params(jp, jd), tt.cast_params(nested(tp), td)
        jmem = jax.jit(lambda p, f: je.encode(p, f, jcfg))(jcast, jnp.asarray(frames, jd))
        tmem = te.encode(tcast, torch.from_numpy(frames).to(td), tcfg)
        jk, jv = jax.jit(lambda p, m: je.fill_cross_caches(p, m, jcfg))(jcast, jmem)
        jc = {**jm.cache_init(batch, prompt, enc_len=s_enc), "cross_k": jk, "cross_v": jv}
        tc = tm.cache_init(batch, prompt, enc_len=s_enc, device="cpu")
        tc["cross_k"], tc["cross_v"] = te.fill_cross_caches(tcast, tmem, tcfg)
        jdec = jax.jit(lambda p, b, c: jm.decode_fn(p, b, c, dtype=jd))
        for t in range(prompt):
            jlog, jc = jdec(jcast, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
            tlog, tc = tm.decode_fn(tcast, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                    tc, dtype=td)
        batch_in = {"frames": frames, "tokens": toks}
        jpre = jax.jit(lambda p, b: jm.prefill_fn(p, b, dtype=jd))(
            jp, {k: jnp.asarray(v) for k, v in batch_in.items()})
        tpre = tm.prefill_fn(tp, {k: torch.from_numpy(v) for k, v in batch_in.items()},
                             dtype=td)
        gaps = [np.abs(_np(a) - _np(b)) for a, b in ((jpre, jlog), (tpre, tlog))]
        out[name] = tuple((float(g.max()), float(g.mean())) for g in gaps)
    return out


if __name__ == "__main__":
    torch.set_num_threads(4)
    for spec in sys.argv[1:]:
        if spec.startswith("prefill,"):
            n = int(spec.split(",")[1])
            B = int(spec.split(",B")[1]) if ",B" in spec else 16
            for name, ((jm_, jmean), (tm_, tmean)) in _prefill_gaps(n, batch=B).items():
                print(f"{ARCH} published widths, {n} + {n} layers, B {B}, 1500 frames, "
                      f"a 128 prompt, {name}: prefill against the stepped decode: "
                      f"jax max {jm_:.5e} mean {jmean:.5e}; port max {tm_:.5e} "
                      f"mean {tmean:.5e}", flush=True)
            continue
        d, s_enc, seq, *rest = spec.split(",")
        dtype, seeds = (rest + ["f32"])[0], int((rest + ["f32", "1"])[1])
        misses, agree = {"jax": 0, "port": 0}, 0
        for seed in range(seeds):
            out = _recipe_run(int(d), int(s_enc), int(seq), dtype, seed)
            agree += out["jax"][2] == out["port"][2]
            for k, v in out.items():
                misses[k] += not v[0] < v[1]
            print(f"{ARCH} 2 + 2 layers d_model {d}, {s_enc} frames, {seq} tokens, "
                  f"{dtype} seed {seed}: " + "; ".join(
                      f"{k} d_ui {v[0]:.6e} d_us {v[1]:.6e} d_ui/d_us {v[0] / v[1]:.4e}"
                      for k, v in out.items())
                  + f"; counters equal: {out['jax'][2] == out['port'][2]} port "
                  f"{out['port'][2]}", flush=True)
        print(f"{ARCH} d_model {d} {dtype}, {seeds} seeds: d_ui/d_us >= 1 in "
              f"{misses['jax']} (jax) and {misses['port']} (port); counters equal "
              f"in {agree}", flush=True)
