"""The port's LM training loop and `train` CLI against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart on the CPU, at ``cfg.reduced()`` widths, with the JAX
weights carried across.  Tolerances:

  * schedules: bitwise, every step 0..T+2, against the reference under
    ``jax.jit`` (as its train step computes them);
  * `adamw`: 1e-6 relative to each tensor's scale after three steps, with
    and without the clip (the global norm's sum runs in another order:
    ~1e-7 relative);
  * `make_train_step` on f32 compute (``lm_loss(..., dtype=float32)``),
    two steps, ``grad_accum`` 1 and 2: the loss within 1e-5 relative; the
    parameters' gap within 1e-3 of the distance the reference moved them
    (L2) and every weight's within 5e-2 of the summed step sizes Σlr; m
    and v within 5e-4 (L2, relative).  The packages' f32 gradients agree
    to ~1e-6 relative (sums in another order), but AdamW moves a weight
    by ~lr·m/(sqrt(v) + eps), which turns that gap into up to ~2e-2·lr
    where |g| is small against the largest (measured: 1.3e-5 to 8.8e-5
    of the distance, and 2e-3·Σlr to 2.0e-2·Σlr, over the four configs).
    In bf16, the loss within 5e-3, the reference's model bar;
  * checkpoints across the packages and resume against an uninterrupted
    run: bitwise;
  * `StepTimer` and `StragglerPolicy`: equal outputs on equal inputs;
  * the CLI: LM mode's printed losses within 5e-3 of the reference's and
    its lr column equal; paper mode's printed accuracy, row count and
    grad-eval speedup equal, its ||w_U - w_I|| within the 4 significant
    digits the reference prints (1e-3 relative).
"""

import contextlib
import functools
import io
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.registry import get_config as j_get_config
from repro.launch import train as j_train
from repro.models.registry import build as j_build
from repro.models.simple import logreg_init as j_logreg_init
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsch
from repro.train import checkpoint as j_ckpt
from repro.train import straggler as j_strag
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.state import init_state as j_init_state

from repro_torch.configs.registry import get_config
from repro_torch.launch import train as t_train
from repro_torch.models import registry as t_registry
from repro_torch.models import simple as t_simple
from repro_torch.models.registry import build, params_from_jax
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsch
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import straggler as t_strag
from repro_torch.train.loop import make_train_step
from repro_torch.train.state import TrainState, init_state

ARCHS = ["internlm2-1.8b", "qwen3-32b", "nemotron-4-15b", "chameleon-34b"]


def _flat_np(tree):
    return np.asarray(ravel_pytree(tree)[0])


def _rel(a, b) -> float:
    a, b = np.ravel(a), np.ravel(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- schedules -------------------------------------------------------------------


SCHEDULES = {
    "constant": lambda m: m.constant(0.05),
    "piecewise": lambda m: m.piecewise_constant(((0, 0.2), (10, 0.1), (15, 0.02))),
    "cosine_decay": lambda m: m.cosine_decay(0.1, 100),
    "cosine_decay_ff": lambda m: m.cosine_decay(3e-4, 37, final_frac=0.05),
    "warmup_cosine_cli200": lambda m: m.warmup_cosine(3e-4, 10, 200),
    "warmup_cosine_cli8": lambda m: m.warmup_cosine(3e-4, 1, 8),
    "warmup_cosine_997": lambda m: m.warmup_cosine(0.01, 49, 997),
    "warmup_cosine_lr01": lambda m: m.warmup_cosine(0.1, 13, 40),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_is_bitwise_the_reference_under_jit(name):
    ref = jax.jit(jax.vmap(SCHEDULES[name](jsch)))
    port = SCHEDULES[name](tsch)
    steps = np.arange(1000, dtype=np.int32)
    want = np.asarray(ref(jnp.asarray(steps)))
    got = np.array([port(int(s)) for s in steps], np.float32)
    assert all(isinstance(port(int(s)), float) for s in steps[:3])
    np.testing.assert_array_equal(got, want)


# -- AdamW --------------------------------------------------------------------------


@pytest.mark.parametrize("grad_clip", [1.0, 0.0], ids=["clip", "no_clip"])
def test_adamw_matches(grad_clip):
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jo, to = (m.adamw(weight_decay=0.01, grad_clip=grad_clip) for m in (jopt, topt))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = params_from_jax(params, "cpu")
    js, ts = jo.init(jp), to.init(tp.flat)
    lr = tsch.warmup_cosine(3e-3, 1, 3)
    for step in range(3):
        g = {k: (rng.normal(size=s) * 0.7).astype(np.float32) for k, s in shapes.items()}
        jp, js = jo.update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
                           jnp.float32(lr(step)))
        new, ts = to.update(tp.flat, params_from_jax(g, "cpu").flat, ts, lr(step))
        tp = tp.with_flat(new)
    assert ts["step"] == int(js["step"]) == 3
    assert ts["m"].dtype == ts["v"].dtype == torch.float32
    assert _rel(tp.flat.numpy(), _flat_np(jp)) < 1e-6
    assert _rel(ts["m"].numpy(), _flat_np(js["m"])) < 1e-6
    assert _rel(ts["v"].numpy(), _flat_np(js["v"])) < 1e-6


# -- the train step ---------------------------------------------------------------------


def _lm(arch="internlm2-1.8b", seed=0):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(seed)
    return jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


def _batches(vocab, n=2, b=4, s=16):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=(b, s), dtype=np.int32) for _ in range(n)]


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_matches_on_f32_compute(arch, grad_accum):
    jm, tm, jp, tp = _lm(arch)
    lr = (jsch.warmup_cosine(1e-2, 1, 4), tsch.warmup_cosine(1e-2, 1, 4))
    jstep = jax.jit(j_make_train_step(
        lambda p, b: jm.loss_fn(p, b, remat=False, loss_chunk=8, dtype=jnp.float32),
        jopt.adamw(weight_decay=0.01), lr[0], grad_accum=grad_accum))
    tstep = make_train_step(
        lambda p, b: tm.loss_fn(p, b, remat=False, loss_chunk=8, dtype=torch.float32),
        topt.adamw(weight_decay=0.01), lr[1], grad_accum=grad_accum)
    js = j_init_state(jp, jopt.adamw(weight_decay=0.01))
    ts = init_state(tp, topt.adamw(weight_decay=0.01))
    for toks in _batches(jm.cfg.vocab):
        js, jmet = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tmet = tstep(ts, {"tokens": torch.from_numpy(toks)})
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * float(jmet["loss"])
        assert np.float32(tmet["lr"]) == np.asarray(jmet["lr"])
    assert ts.step == int(js.step) == 2 and ts.opt_state["step"] == 2
    ref = _flat_np(js.params)
    gap = ts.params.flat.numpy() - ref
    assert np.linalg.norm(gap) <= 1e-3 * np.linalg.norm(ref - _flat_np(jp))
    assert np.abs(gap).max() <= 5e-2 * (lr[1](0) + lr[1](1))
    for k in ("m", "v"):
        want = _flat_np(js.opt_state[k])
        assert (np.linalg.norm(ts.opt_state[k].numpy() - want)
                <= 5e-4 * np.linalg.norm(want))


def test_make_train_step_bf16_loss_matches():
    jm, tm, jp, tp = _lm()
    lr = (jsch.constant(1e-2), tsch.constant(1e-2))
    jstep = jax.jit(j_make_train_step(
        lambda p, b: jm.loss_fn(p, b, remat=False, loss_chunk=8), jopt.adamw(), lr[0]))
    tstep = make_train_step(lambda p, b: tm.loss_fn(p, b, remat=False, loss_chunk=8),
                            topt.adamw(), lr[1])
    js, ts = j_init_state(jp, jopt.adamw()), init_state(tp, topt.adamw())
    for toks in _batches(jm.cfg.vocab, n=3):
        js, jmet = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tmet = tstep(ts, {"tokens": torch.from_numpy(toks)})
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) < 5e-3


@pytest.mark.parametrize("arg", ["microbatch_sharding", "compute_sharding",
                                 "compute_dtype", "storage_sharding"])
def test_make_train_step_refuses_the_sharding_arguments(arg):
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        make_train_step(lambda p, b: 0, topt.adamw(), tsch.constant(1.0),
                        **{arg: object()})


# -- checkpoints ----------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _trained_states():
    """One AdamW step of the reduced LM in each package, from the same
    weights and batch (f32 compute)."""
    jm, tm, jp, tp = _lm()
    toks = _batches(jm.cfg.vocab, n=1)[0]
    jstep = jax.jit(j_make_train_step(
        lambda p, b: jm.loss_fn(p, b, remat=False, loss_chunk=8, dtype=jnp.float32),
        jopt.adamw(), jsch.constant(1e-2)))
    tstep = make_train_step(
        lambda p, b: tm.loss_fn(p, b, remat=False, loss_chunk=8, dtype=torch.float32),
        topt.adamw(), tsch.constant(1e-2))
    js, _ = jstep(j_init_state(jp, jopt.adamw()), {"tokens": jnp.asarray(toks)})
    ts, _ = tstep(init_state(tp, topt.adamw()), {"tokens": torch.from_numpy(toks)})
    return js, ts


def _same_state(t: TrainState, j):
    assert t.step == int(j.step) and t.opt_state["step"] == int(j.opt_state["step"])
    np.testing.assert_array_equal(t.params.flat.numpy(), _flat_np(j.params))
    for k in ("m", "v"):
        np.testing.assert_array_equal(t.opt_state[k].numpy(), _flat_np(j.opt_state[k]))


def test_jax_written_train_state_restores_in_the_port(tmp_path):
    js, ts = _trained_states()
    j_ckpt.save(str(tmp_path), 1, js)
    like = init_state(ts.params.with_flat(torch.zeros_like(ts.params.flat)),
                      topt.adamw())
    assert t_ckpt.latest_step(str(tmp_path)) == 1
    _same_state(t_ckpt.restore(str(tmp_path), 1, like), js)


def test_port_written_train_state_restores_in_jax(tmp_path):
    js, ts = _trained_states()
    t_ckpt.save(str(tmp_path), 1, ts)
    with np.load(tmp_path / "step_00000001" / "shard_00000.npz") as data:
        t_keys = sorted(data.files)
    assert t_keys == sorted(j_ckpt._flatten_with_names(js))
    back = j_ckpt.restore(str(tmp_path), 1, jax.tree.map(jnp.zeros_like, js))
    _same_state(ts, back)
    assert back.step.dtype == jnp.int32


# -- the straggler hooks ------------------------------------------------------------------


def test_step_timer_matches(monkeypatch):
    """Both timers on one fake clock, in turn."""
    seq = list(np.random.default_rng(1).uniform(0.01, 0.2, 24))
    jt, tt = j_strag.StepTimer(window=5), t_strag.StepTimer(window=5)
    for timer in (jt, tt):
        t = [0.0]

        def fake():
            return t[0]
        monkeypatch.setattr(j_strag.time, "perf_counter", fake)
        monkeypatch.setattr(t_strag.time, "perf_counter", fake)
        for dt in seq:
            timer.start()
            t[0] += dt
            timer.stop()
    assert list(tt.times) == list(jt.times) and len(tt.times) == 5
    for q in (0.0, 0.5, 0.95, 1.0):
        assert tt.percentile(q) == jt.percentile(q)
    assert t_strag.StepTimer().percentile(0.5) == 0.0
    with pytest.raises(RuntimeError):
        t_strag.StepTimer().stop()


def test_straggler_policy_matches():
    rng = np.random.default_rng(2)
    jp, tp = j_strag.StragglerPolicy(tolerance=1.4, patience=2), t_strag.StragglerPolicy(
        tolerance=1.4, patience=2)
    for _ in range(30):
        obs = {h: float(rng.uniform(0.9, 1.1) * (2.0 if h == 3 and rng.random() < 0.7 else 1.0))
               for h in range(6)}
        assert tp.observe(obs) == jp.observe(obs)
    assert tp.observe({}) == jp.observe({}) == []
    assert tp.reweight(3, 4) == jp.reweight(3, 4)
    with pytest.raises(ValueError):
        tp.reweight(0, 4)


# -- the CLI ----------------------------------------------------------------------------


def _run(main, argv, monkeypatch=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if monkeypatch is not None:  # the reference parses sys.argv
            monkeypatch.setattr(sys, "argv", ["train"] + argv)
            res = main()
        else:
            res = main(argv)
    return out.getvalue(), res


def _losses(text):
    return {int(m.group(1)): (float(m.group(2)), m.group(3)) for m in re.finditer(
        r"step\s+(\d+) loss\s+(\S+) lr (\S+)", text)}


@pytest.fixture
def jax_lm_weights(monkeypatch):
    """The port's `Model.init` drawing the JAX package's weights."""

    def init(self, seed=0, device=None):
        jp = j_build(j_get_config(self.cfg.name).reduced()).init(seed)
        return params_from_jax(jax.device_get(jp), device)

    monkeypatch.setattr(t_registry.Model, "init", init)


def test_train_cli_lm_mode_matches_the_reference(monkeypatch, jax_lm_weights, tmp_path):
    argv = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "6", "--batch", "4",
            "--seq", "32", "--log-every", "1"]
    j_text, _ = _run(j_train.main, argv, monkeypatch)
    t_text, res = _run(t_train.main, argv + ["--device", "cpu", "--ckpt",
                                             str(tmp_path)])
    jl, tl = _losses(j_text), _losses(t_text)
    assert sorted(tl) == sorted(jl) == list(range(6))
    for s in jl:
        assert abs(tl[s][0] - jl[s][0]) < 5e-3, (s, tl[s], jl[s])
        assert tl[s][1] == jl[s][1]
    assert t_text.rstrip().endswith("done.")
    assert t_ckpt.complete_steps(str(tmp_path)) == [6]
    assert res["state"].step == 6


def test_train_cli_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """A crash after step 4's checkpoint: the step-8 checkpoint is removed
    and the same command re-run resumes from step 4."""
    argv = ["--arch", "nemotron-4-15b", "--reduced", "--device", "cpu", "--steps", "8",
            "--batch", "4", "--seq", "16", "--ckpt", str(tmp_path), "--ckpt-every", "4"]
    _, whole = _run(t_train.main, argv)
    assert t_ckpt.complete_steps(str(tmp_path)) == [4, 8]
    shutil.rmtree(tmp_path / "step_00000008")
    text, resumed = _run(t_train.main, argv)
    assert "resumed from step 4" in text and resumed["start"] == 4
    assert sorted(resumed["losses"]) == [4, 5, 6, 7]
    for s in range(4, 8):
        assert resumed["losses"][s] == whole["losses"][s]
    a, b = whole["state"], resumed["state"]
    assert a.step == b.step == 8
    assert torch.equal(a.params.flat, b.params.flat)
    for k in ("m", "v"):
        assert torch.equal(a.opt_state[k], b.opt_state[k])


def test_train_cli_paper_mode_matches_the_reference(monkeypatch):
    monkeypatch.setattr(t_simple, "logreg_init", lambda d, generator=None, device=None:
                        t_simple.params_from_jax(
                            jax.device_get(j_logreg_init(d, seed=0)), device))
    j_text, _ = _run(j_train.main, ["--arch", "paper-logreg"], monkeypatch)
    t_text, res = _run(t_train.main, ["--arch", "paper-logreg", "--device", "cpu"])
    pat = (r"acc=(\S+)\n.*deleted (\d+) rows: .*grad-eval speedup x(\S+)\) "
           r"\|\|w_U - w_I\|\| = (\S+)")
    jm, tm = (re.search(pat, t, re.S) for t in (j_text, t_text))
    assert jm.group(1) == tm.group(1) and jm.group(2) == tm.group(2) == "50"
    assert jm.group(3) == tm.group(3)
    # the reference prints 4 significant digits
    assert res["dist"] == pytest.approx(float(jm.group(4)), rel=1e-3)


@pytest.mark.parametrize("argv", [["--arch", "internlm2-1.8b", "--reduced"],
                                  ["--arch", "paper-logreg"]], ids=["lm", "paper"])
def test_train_cli_needs_a_card_unless_cpu_is_asked_for(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(argv + ["--steps", "1"])
