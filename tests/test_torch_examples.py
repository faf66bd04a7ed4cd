"""The port's examples (``examples/torch/*.py``) against the reference's
(``examples/*.py``), on the CPU.

Each port example runs with ``--device cpu`` from the same initial weights
as its reference, carried across (`params_from_jax`: the reference draws
them with ``jax.random``), and both run in this test.  Every line they
print must read the same once the times are left out, and each number in
it within the tolerance the port's tests state for that path, beyond the
rounding of its printed digits:

  * quickstart, online_deletion (the session surface, logreg in f32):
    1e-6, tests/test_torch_session.py's bar on the parameters; the
    counters and accuracies exactly (no prediction moves at that gap).
    The published model's noise is drawn from torch's generator, not
    ``jax.random``, so its accuracy is held to the un-noised model's
    printed two lines up, within 1 row in 4000 (2.5e-4): Laplace noise of
    scale sqrt(p) delta0 / eps = 2.2e-3 moves no more;
  * jackknife (Algorithm 1's delete replay, logreg in f32): 1e-6 relative
    on the influence values and the raw estimate (the replay's 1e-5
    relative bar of tests/test_torch_models.py holds them tighter), and
    the bias, (n - 1) = 399 times a mean of leave-one-out differences,
    within 399 x that;
  * unlearn_lm (the LM session in bf16 compute): the distances within 5e-2
    relative and the losses within 5e-3, the reference's bf16 model bars
    (tests/test_torch_lm.py), the counters exactly;
  * serve_decode (the greedy decode in bf16): the tokens equal.
"""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models.registry import build as j_build
from repro.models.simple import logreg_init as j_logreg_init

from repro_torch.models import registry as t_registry
from repro_torch.models import simple as t_simple

ROOT = Path(__file__).resolve().parents[1]
# times in the printed lines: "in 0.91s", "dispatched in 2335 ms",
# "(423 ms/request)", "retrain): 0.35s"
TIMES = re.compile(r"in\s+[\d.]+\s*s\b|in [\d.]+ ms|\([\d.]+ ms/request\)|: [\d.]+s$")
NUMBER = re.compile(r"[-+]?\d[\d,]*(?:\.\d+)?(?:e[-+]?\d+)?")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread per test: the suite runs its files in
    several worker processes on the same cores, and every worker's thread
    pool spinning for them slows the port's small CPU ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"_example_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue().splitlines()


def _lines(name: str, **port_kw):
    """Both examples' printed lines, the port's run on the CPU, and the
    port's result."""
    _, ref = _run(_load(ROOT / "examples" / f"{name}.py").main)
    got, port = _run(_load(ROOT / "examples" / "torch" / f"{name}.py").main,
                     ["--device", "cpu"], **port_kw)
    print("\n".join(f"ref:  {a}\nport: {b}" for a, b in zip(ref, port)))
    assert len(port) == len(ref), (port, ref)
    return ref, port, got


def _numbers(line: str):
    """(the line with its times cut and numbers blanked, [(value, unit of
    its last printed digit)])."""
    line = TIMES.sub("<time>", line)
    nums = []
    for m in NUMBER.finditer(line):
        s = m.group().replace(",", "")
        mant, _, exp = s.lower().partition("e")
        decimals = len(mant.partition(".")[2])
        nums.append((float(s), 10.0 ** (-decimals + (int(exp) if exp else 0))))
    return NUMBER.sub("#", line), nums


def _hold(ref, port, tol):
    """Each line reads the same; number k of line i within tol(i, k, value)
    of the reference's, beyond half a printed digit on each side."""
    for i, (a, b) in enumerate(zip(ref, port)):
        text_a, nums_a = _numbers(a)
        text_b, nums_b = _numbers(b)
        assert text_a == text_b, (a, b)
        for k, ((x, ux), (y, uy)) in enumerate(zip(nums_a, nums_b)):
            bar = tol(i, k, x) + (ux + uy) / 2
            assert abs(x - y) <= bar, (a, b, k, x, y, bar)


def _logreg(d: int, seed: int):
    return t_simple.params_from_jax(
        {k: np.asarray(v) for k, v in j_logreg_init(d, seed=seed).items()}, "cpu")


def _exact(i, k, x):
    return 0.0


def test_quickstart():
    ref, port, got = _lines("quickstart", params0=_logreg(200, 1))
    _hold(ref, port, lambda i, k, x: 1e-6 if "||w_exact" in ref[i] else 0.0)
    assert got["params"].flat.device.type == "cpu"
    assert bool(torch.isfinite(got["params"].flat).all())


def test_online_deletion():
    ref, port, got = _lines("online_deletion", params0=_logreg(500, 1))
    last = len(ref) - 1
    _hold(ref[:last], port[:last], _exact)
    acc = len(_numbers(ref[last])[1]) - 1  # the published accuracy's index
    _hold(ref[last:], port[last:], lambda i, k, x: 2.5e-4 if k == acc else 0.0)
    # the published accuracy against the un-noised model's
    noisy = _numbers(port[last])[1][acc][0]
    plain = _numbers(port[last - 2])[1][-1][0]
    assert abs(noisy - plain) <= 2.5e-4 + 1e-4, (noisy, plain)
    assert bool(torch.isfinite(got["published"].flat).all())


def test_jackknife():
    ref, port, got = _lines("jackknife", params0=_logreg(60, 2))

    def tol(i, k, x):
        return abs(x) * (399e-6 if "bias" in ref[i] or "corrected" in ref[i] else 1e-6)

    _hold(ref, port, tol)
    assert np.isfinite(got["values"]).all()


def test_unlearn_lm():
    cfg = j_get_config("internlm2-1.8b").reduced(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        d_head=16)
    init = t_registry.params_from_jax(jax.device_get(j_build(cfg).init(1)), "cpu")
    ref, port, got = _lines("unlearn_lm", params0=init)

    def tol(i, k, x):
        if "loss on removed" in ref[i]:
            return 5e-3
        if "||w_exact" in ref[i]:
            return 5e-2 * abs(x)
        return 0.0

    _hold(ref, port, tol)
    assert bool(torch.isfinite(got["params"].flat).all())


def test_serve_decode():
    mod = _load(ROOT / "examples" / "torch" / "serve_decode.py")
    params = {arch: t_registry.params_from_jax(jax.device_get(
        j_build(j_get_config(arch).reduced()).init(0)), "cpu") for arch in mod.ARCHS}
    ref, port, got = _lines("serve_decode", params=params)
    _hold(ref, port, _exact)
    for arch in mod.ARCHS:
        assert bool(torch.isfinite(got[arch]["logits"]).all())
