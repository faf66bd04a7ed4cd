"""The port's xLSTM cells (mLSTM, sLSTM) against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart at the reference's reduced widths (d_model 64, 4
heads: the mLSTM's d_inner 128 in heads of 32, the sLSTM's heads of 16),
with the JAX weights carried across and the gate biases and norm scales
moved off their init.  Tolerances:

  * copies (configs, parameter counts, the flat order, the init's
    constants): exact;
  * f32: outputs and states 1e-5 elementwise, and each gradient (with
    respect to x and to each weight) 1e-5 in norm (measured: 3.4e-6 at
    most); the port's parallel, chunked and recurrent forms against each
    other, the reference's own bar, 2e-5 (``tests/test_models_smoke.py``).
    One exception: `mlstm_chunked` over two chunks of 256 (L 512) is held
    at 3e-5.  There h = num / den with |den| small against its terms (|h|
    up to 160 on these inputs), so the order of the f32 sums over 256 keys
    shows: the two packages part by 1.0e-5 to 2.5e-5 (|gap| / (1 + |ref|),
    four draws) while each is as far from a float64 evaluation of the same
    algebra (JAX 5.4e-5, the port 3.7e-5, in the cell's output);
  * bf16 on the same bf16 inputs, against the reference run op by op
    (each op rounds, as the port's ops do; jitted, XLA fuses bf16 chains
    and drops the roundings inside them): outputs at the reference's
    kernel bar, 3e-2 elementwise, and a mean |gap| below 3e-3; each
    gradient no farther from the f32 gradient of the same inputs than the
    reference's own op-by-op bf16 gradient (+ 5e-3).  Over two chunks of
    256 the reference's own bf16 gradients part from the f32 ones by up
    to 0.14 (the gate bias), so no bar is set on that distance itself.

The model (losses, decode, the entry points, the DeltaGrad slice) is in
``tests/test_torch_xlstm_slice.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.base import XLSTMConfig as JXLSTMConfig
from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as jt
from repro.models import xlstm as jxl
from repro.models.registry import build as j_build
from repro.models.registry import count_params as j_count_params

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tt
from repro_torch.models import xlstm as txl
from repro_torch.models.registry import (build, count_params, params_from_jax,
                                         params_to_numpy)
from repro_torch.utils.tree import flatten_nested, nested

ARCH = "xlstm-350m"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = 3e-2  # the reference's bf16 kernel bar
B, D, H = 2, 64, 4
CFG = XLSTMConfig(proj_factor_mlstm=2.0, proj_factor_slstm=4.0 / 3.0)
JCFG = JXLSTMConfig(proj_factor_mlstm=2.0, proj_factor_slstm=4.0 / 3.0)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


def _rel(a, b) -> float:
    a, b = np.ravel(_np(a)), np.ravel(_np(b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bf16_close(t, j):
    _close(t, j, BF16_TOL)
    assert float(np.abs(_np(t) - _np(j)).mean()) < BF16_TOL / 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread per test: the suite runs its files in
    several worker processes on the same cores, and every worker's thread
    pool spinning for them slows the port's small CPU ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- copies -------------------------------------------------------------------------


def test_config_matches_the_reference_field_by_field():
    ref, port = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(port, f.name) == getattr(ref, f.name) or f.name == "xlstm", f.name
        assert (getattr(port.reduced(), f.name) == getattr(ref.reduced(), f.name)
                or f.name == "xlstm"), f.name
    assert [f.name for f in dataclasses.fields(XLSTMConfig)] == \
        [f.name for f in dataclasses.fields(JXLSTMConfig)]
    for f in dataclasses.fields(XLSTMConfig):
        assert getattr(XLSTMConfig(), f.name) == getattr(JXLSTMConfig(), f.name), f.name
        assert getattr(port.xlstm, f.name) == getattr(ref.xlstm, f.name), f.name
    assert XLSTMConfig().proj_factor_slstm == 1.3333
    assert port.xlstm.proj_factor_slstm == 4.0 / 3.0
    assert port.reduced().n_layers == 2 and port.reduced().xlstm == port.xlstm
    assert (port.family, port.mlp, port.layout_unit) == ("ssm", "none", ("mlstm", "slstm"))


@pytest.mark.parametrize("layers,n_params", [(24, 443_057_248), (2, 131_359_752),
                                             (4, 159_695_888)])
def test_parameter_counts_match_without_allocating(layers, n_params):
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers)
    assert count_params(cfg) == n_params == j_count_params(
        dataclasses.replace(j_get_config(ARCH), n_layers=layers))
    shapes = txl.xlstm_param_shapes(1024, 4, cfg.xlstm)
    mlstm = 1024 + sum(int(np.prod(s)) for s in shapes["mlstm"].values())
    slstm = 1024 + sum(int(np.prod(s)) for s in shapes["slstm"].values())
    assert (mlstm, slstm) == (18_893_832, 9_442_304)  # each with its ln1
    assert shapes["slstm"]["mlp_down"] == (1365, 1024)
    embed = 50304 * 1024
    assert n_params == 2 * embed + 1024 + layers // 2 * (mlstm + slstm)


@pytest.fixture(scope="module")
def xlstm():
    jm, tm = j_build(j_get_config(ARCH).reduced()), build(get_config(ARCH).reduced())
    jp = jm.init(1)
    return jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


def test_flat_order_is_ravel_pytree(xlstm):
    jm, tm, jp, tp = xlstm
    assert np.array_equal(tp.flat.numpy(), np.asarray(ravel_pytree(jp)[0]))
    paths = ["/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(tp) == paths
    assert [k for k in tp if k.startswith("u")] == [
        "u0/ln1/scale", *(f"u0/mixer/{k}" for k in (
            "cell_norm/scale", "gate_bias", "w_down", "w_gates", "w_k", "w_q", "w_up",
            "w_v", "w_z")),
        "u1/ln1/scale", *(f"u1/mixer/{k}" for k in (
            "bias", "cell_norm/scale", "mlp_down", "mlp_up", "r", "w_in"))]
    assert tp.numel == count_params(tm.cfg)
    assert {k: tuple(v) for k, v in tt.param_shapes(tm.cfg).items()} == \
        {k: tuple(v) for k, v in tp.shapes.items()}
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jax.device_get(jp))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(x, np.asarray(y))


def test_init_keeps_the_reference_constants(xlstm):
    """The port's own init: the same layout, the forget biases of 3.0 (the
    mLSTM's per head, the sLSTM's f block of z, i, f, o), norm scales of
    1, r drawn as 0.1 N(0, 1), dense weights N(0, 1/d_in)."""
    _, tm, _, tp = xlstm
    own = tm.init(0, device="cpu")
    assert list(own) == list(tp) and own.shapes == tp.shapes
    assert own["u0/mixer/gate_bias"][0].tolist() == [0.0] * H + [3.0] * H
    bias = own["u1/mixer/bias"][0].reshape(4, D)
    assert torch.equal(bias, torch.tensor([0.0, 0.0, 3.0, 0.0])[:, None].expand(4, D))
    for k in ("u0/ln1/scale", "u0/mixer/cell_norm/scale", "u1/mixer/cell_norm/scale"):
        assert torch.equal(own[k], torch.ones_like(own[k]))
    assert abs(float(own["u1/mixer/r"].std()) - 0.1) < 0.01
    assert abs(float(own["u0/mixer/w_q"].std()) * np.sqrt(2 * D) - 1.0) < 0.05


def test_layout_takes_xlstm_and_checks_its_config():
    cfg = get_config(ARCH)
    assert tt.layout_of(cfg) == jt.layout_of(j_get_config(ARCH)) == (("mlstm", "slstm"), 12)
    assert tt.layout_of(cfg.reduced()) == (("mlstm", "slstm"), 1)
    with pytest.raises(ValueError, match="XLSTMConfig"):
        tt.layout_of(dataclasses.replace(cfg, xlstm=None))
    with pytest.raises(ValueError, match="whole units"):
        tt.layout_of(dataclasses.replace(cfg, n_layers=25))


# -- the cells ------------------------------------------------------------------------


def _mlstm_case(dtype, seed=0):
    """The reference's mLSTM weights at d_model D, the gate bias and the
    norm scale moved off their init, in the compute dtype in both
    packages."""
    jp = jxl.mlstm_init(jax.random.PRNGKey(seed), D, H, JCFG)
    rng = np.random.default_rng(seed + 1)
    jp["gate_bias"] = jp["gate_bias"] + jnp.asarray(rng.normal(size=2 * H), jnp.float32)
    jp["cell_norm"]["scale"] = jnp.asarray(
        1.0 + 0.3 * rng.normal(size=2 * D), jnp.float32)
    return _cast(jp, dtype), rng


def _slstm_case(dtype, seed=0):
    jp = jxl.slstm_init(jax.random.PRNGKey(seed), D, H, JCFG)
    rng = np.random.default_rng(seed + 1)
    jp["bias"] = jp["bias"] + jnp.asarray(0.5 * rng.normal(size=4 * D), jnp.float32)
    jp["cell_norm"]["scale"] = jnp.asarray(1.0 + 0.3 * rng.normal(size=D), jnp.float32)
    return _cast(jp, dtype), rng


def _cast(jp, dtype):
    jd, td = DTYPES[dtype]
    return (jax.tree.map(lambda a: a.astype(jd), jp),
            nested({k: torch.tensor(np.asarray(v)).to(td)
                    for k, v in flatten_nested(jax.device_get(jp)).items()}))


CELLS = {  # name: (case, reference apply, port apply, sequence length, f32 bar)
    "mlstm_parallel": (_mlstm_case, jxl.mlstm_parallel, txl.mlstm_parallel, 16, 1e-5),
    "mlstm_chunked_4": (_mlstm_case, lambda p, x, h: jxl.mlstm_chunked(p, x, h, chunk=4),
                        lambda p, x, h: txl.mlstm_chunked(p, x, h, chunk=4), 16, 1e-5),
    # two chunks of 256: see the module docstring for the bar of 3e-5
    "mlstm_chunked_256": (_mlstm_case, jxl.mlstm_chunked, txl.mlstm_chunked, 512, 3e-5),
    "slstm_apply": (_slstm_case, jxl.slstm_apply, txl.slstm_apply, 16, 1e-5),
}


@pytest.mark.parametrize("dtype,cell", [(d, c) for d in sorted(DTYPES) for c in sorted(CELLS)
                                        if (d, c) != ("bf16", "mlstm_chunked_4")])
def test_cell_forward_and_gradient_match(dtype, cell):
    """Forward and gradient; in bf16 the parallel form at L 16 and the
    chunked form over two chunks stand for the chunked form at chunk 4."""
    case, j_apply, t_apply, L, bar = CELLS[cell]
    (jp, tp), rng = case(dtype)
    jd, td = DTYPES[dtype]
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    cot = rng.normal(size=(B, L, D)).astype(np.float32)

    def j_fn(p, xx):
        out = j_apply(p, xx, H)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    vg = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)
    # in f32 the reference's jitted gradient; in bf16 the reference run op
    # by op (jitted, XLA fuses bf16 chains and drops the roundings between
    # their ops, which the port's ops and the reference's own ops keep)
    (_, j_out), j_grads = (jax.jit(vg) if dtype == "f32" else vg)(
        jp, jnp.asarray(x, jd))
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten_nested(tp).items()}
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    t_out = t_apply(nested(leaves), tx, H)
    grads = torch.autograd.grad((t_out.float() * torch.from_numpy(cot)).sum(),
                                [tx] + list(leaves.values()))
    assert t_out.dtype == td and t_out.shape == (B, L, D)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    j_flat = flatten_nested(j_grads[0])
    if dtype == "f32":
        _close(t_out, j_out, bar)
        for name, g, j in [("x", grads[0], j_grads[1])] + [
                (name, g, j_flat[name]) for (name, _), g in zip(leaves.items(), grads[1:])]:
            assert _rel(g, j) < 1e-5, (name, _rel(g, j))
        return
    _bf16_close(t_out, j_out)
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    _, j32 = jax.jit(vg)(f32, jnp.asarray(x, jd).astype(jnp.float32))
    j32_flat = flatten_nested(j32[0])
    pairs = [("x", grads[0], j_grads[1], j32[1])] + [
        (name, g, j_flat[name], j32_flat[name])
        for (name, _), g in zip(leaves.items(), grads[1:])]
    for name, g, jb, jf in pairs:
        assert g.dtype == td, name
        assert _rel(g, jf) <= _rel(jb, jf) + 5e-3, (name, _rel(g, jf), _rel(jb, jf))


def test_mlstm_chunked_checks_the_chunk():
    """Q = min(chunk, L): a sequence of one chunk or less runs, and one over
    a chunk that is not whole chunks raises, in both packages (no
    padding)."""
    (jp, tp), _ = _mlstm_case("f32")
    for L, chunk in ((6, 4), (3, 4), (12, 8)):
        x = np.zeros((1, L, D), np.float32)
        if L <= chunk:
            assert txl.mlstm_chunked(tp, torch.from_numpy(x), H, chunk=chunk).shape == (1, L, D)
            continue
        with pytest.raises(ValueError, match="must divide by chunk"):
            txl.mlstm_chunked(tp, torch.from_numpy(x), H, chunk=chunk)
        with pytest.raises(AssertionError):
            jxl.mlstm_chunked(jp, jnp.asarray(x), H, chunk=chunk)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlstm_step_matches_step_by_step(dtype):
    (jp, tp), rng = _mlstm_case(dtype, seed=3)
    jd, td = DTYPES[dtype]
    jc = jxl.mlstm_cache_init(B, D, H, JCFG)
    tc = txl.mlstm_cache_init(B, D, H, CFG, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    assert torch.equal(tc["m"], torch.full((B, H), float("-inf")))
    states = dict(tc)
    tol = 1e-5 if dtype == "f32" else BF16_TOL
    for _ in range(8):
        x = rng.normal(size=(B, 1, D)).astype(np.float32)
        jo, jc = jxl.mlstm_step(jp, jnp.asarray(x, jd), jc, H)
        to, tc = txl.mlstm_step(tp, torch.from_numpy(x).to(td), tc, H)
        assert to.dtype == td and to.shape == (B, 1, D)
        assert all(tc[k] is states[k] for k in states)  # written in place
        _close(to, jo, tol)
        for k in ("C", "n", "m"):
            assert tc[k].dtype == torch.float32
            _close(tc[k], jc[k], tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_slstm_step_matches_step_by_step(dtype):
    (jp, tp), rng = _slstm_case(dtype, seed=3)
    jd, td = DTYPES[dtype]
    jc = jxl.slstm_cache_init(B, D, H)
    tc = txl.slstm_cache_init(B, D, H, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    states = dict(tc)
    tol = 1e-5 if dtype == "f32" else BF16_TOL
    for _ in range(8):
        x = rng.normal(size=(B, 1, D)).astype(np.float32)
        jo, jc = jxl.slstm_step(jp, jnp.asarray(x, jd), jc, H)
        to, tc = txl.slstm_step(tp, torch.from_numpy(x).to(td), tc, H)
        assert to.dtype == td and to.shape == (B, 1, D)
        assert all(tc[k] is states[k] for k in states)
        _close(to, jo, tol)
        for k in "cnhm":
            _close(tc[k], jc[k], tol)


def test_parallel_chunked_and_recurrent_agree():
    """Inside the port, as the reference's own test holds its three
    mLSTM forms (``tests/test_models_smoke.py``): 2e-5 in f32; and the
    sLSTM's loop against its stepped decode."""
    (_, mp), rng = _mlstm_case("f32", seed=5)
    x = torch.from_numpy(0.5 * rng.normal(size=(B, 16, D)).astype(np.float32))
    full = txl.mlstm_parallel(mp, x, H)
    _close(txl.mlstm_chunked(mp, x, H, chunk=4), full, 2e-5)
    _close(txl.mlstm_chunked(mp, x, H), full, 2e-5)
    cache = txl.mlstm_cache_init(B, D, H, CFG, device="cpu")
    steps = [txl.mlstm_step(mp, x[:, t:t + 1], cache, H)[0][:, 0] for t in range(16)]
    _close(torch.stack(steps, 1), full, 2e-5)
    (_, sp), _ = _slstm_case("f32", seed=5)
    full = txl.slstm_apply(sp, x, H)
    cache = txl.slstm_cache_init(B, D, H, device="cpu")
    steps = [txl.slstm_step(sp, x[:, t:t + 1], cache, H)[0][:, 0] for t in range(16)]
    _close(torch.stack(steps, 1), full, 2e-5)


@pytest.mark.parametrize("cell", ["mlstm_parallel", "slstm_apply"])
def test_overflowing_stabiliser_gives_the_reference_gradient(cell):
    """An input gate's pre-activation of -100 makes exp(-m) overflow f32 in
    the denominator max(|den|, exp(-m)): the loss stays finite, and both
    packages' gradients turn non-finite on the same leaves, as many entries
    each (0 x inf in exp's backward, the reference's formula), and agree
    elsewhere.  SGD that drives a gate this far (the card's 24-layer
    bf16 training at lr 0.01, PERF.md section 6) meets it in both."""
    case, j_apply, t_apply, L, _ = CELLS[cell]
    (jp, tp), rng = case("f32")
    key, lo = ("bias", D) if cell == "slstm_apply" else ("gate_bias", 0)
    gates = np.asarray(jp[key]).copy()
    gates[lo:lo + (D if cell == "slstm_apply" else H)] = -100.0  # the i block
    jp[key], tp[key] = jnp.asarray(gates), torch.from_numpy(gates.copy())
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    j_loss, j_grad = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(j_apply(p, jnp.asarray(x), H))))(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten_nested(tp).items()}
    t_out = t_apply(nested(leaves), torch.from_numpy(x), H)
    grads = torch.autograd.grad(t_out.sum(), list(leaves.values()))
    assert np.isfinite(float(j_loss)) and bool(torch.isfinite(t_out).all())
    j_flat = flatten_nested(j_grad)
    bad = set()
    for (name, _), g in zip(leaves.items(), grads):
        j = np.asarray(j_flat[name])
        j_ok = np.isfinite(j)
        assert np.array_equal(torch.isfinite(g).numpy(), j_ok), name
        if j_ok.all():
            assert _rel(g, j) < 1e-5, name
        else:
            bad.add(name)
    assert bad == ({"bias", "r", "w_in"} if cell == "slstm_apply"
                   else {"gate_bias", "w_gates", "w_up"})
