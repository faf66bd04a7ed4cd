"""The port's Mamba2 (SSD) and the Zamba2 hybrid stack against the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart, at the reference's reduced hybrid
(``ModelConfig.reduced()`` of zamba2-7b: one unit of five Mamba2 blocks
and the shared attention block, d_model 64, 4 heads of 16, vocab 256;
d_state 16, head_dim 16, chunk 16), with the JAX weights carried across
(`params_from_jax`).  Tolerances:

  * copies (configs, parameter counts, the flat order, the port's own
    init against its earlier draws): exact;
  * `ssd_chunked`, `mamba2_apply`, `mamba2_decode` in f32: 1e-5 (outputs
    and states elementwise, `mamba2_apply`'s gradient with respect to x
    elementwise and to each weight in norm: the per-head weights' gradients
    are sums of many terms); in bf16 on the same bf16 inputs: the
    reference's kernel bar, 3e-2 elementwise, and a mean |gap| below 3e-3
    on the outputs (two bf16 programs part by an ulp here and there, not
    everywhere), and each gradient within the reference's 5e-2 of the f32
    gradient, no farther from it than the reference's own bf16 gradient;
    each at n_groups 1 and 2 (head h of group h // hg: only G > 1 tells
    ``repeat_interleave`` from ``repeat``);
  * the stepped decode against the full apply: the reference's own bar,
    2e-5 in f32 (``tests/test_models_smoke.py``);
  * `prefill` against the stepped decode, and each against the other
    package's: with the model's bf16 KV caches, the f32 logits at 1e-3 (a
    k or v value near a bf16 tie rounds the other way in the other
    package) and the caches within one bf16 ulp; with f32 KV caches in
    both packages, 1e-5; in bf16 compute, the logits at 6e-2 (the bar of
    two programs' bf16 logits, tests/test_torch_decode.py), and the prefill
    gap within the reference's own + 6e-2;
  * ``decode_main``: greedy tokens equal; the train CLI's printed loss:
    5e-3 (bf16 compute).

The shared attention block attends in a window (``attn_window`` 4096), so
`layers.full_attention` sends it to blockwise attention whatever the flash
switch, as the reference's does: no call reaches `FlashAttention`.  The
losses, the objective and the slice as a whole are in
``tests/test_torch_mamba2_slice.py``.
"""

import ast
import contextlib
import dataclasses
import io
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.base import SSMConfig as JSSMConfig
from repro.configs.registry import get_config as j_get_config
from repro.core import deltagrad as jdg
from repro.core.history import HistoryMeta as JMeta
from repro.data.synthetic import token_stream as j_token_stream
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.models import mamba2 as jm2
from repro.models import transformer as jt
from repro.models.registry import build as j_build
from repro.models.registry import count_params as j_count_params

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import deltagrad as tdg
from repro_torch.core import engine as t_engine
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import layers as tl
from repro_torch.models import mamba2 as tm2
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as tt
from repro_torch.models.attention_config import use_attention_impl
from repro_torch.models.registry import (build, count_params, params_from_jax,
                                         params_to_numpy)
from repro_torch.utils.tree import FlatParams, flatten_nested, nested

ARCH = "zamba2-7b"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = 3e-2  # the reference's bf16 kernel bar
N_DOCS, SEQ = 32, 32  # the documents of the flash switch and slice tests
# the module tests' inputs: B, d_model, chunk
B, D, Q = 2, 64, 16


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


def _rel(a, b) -> float:
    a, b = np.ravel(_np(a)), np.ravel(_np(b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _torch_tree(tree, dtype=torch.float32):
    return {k: _torch_tree(v, dtype) if isinstance(v, dict)
            else torch.tensor(np.asarray(v)).to(dtype) for k, v in tree.items()}


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
        if f.name != "ssm":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
            assert getattr(port.reduced(), f.name) == getattr(ref.reduced(), f.name)
    assert [f.name for f in dataclasses.fields(SSMConfig)] == \
        [f.name for f in dataclasses.fields(JSSMConfig)]
    for f in dataclasses.fields(SSMConfig):
        assert getattr(SSMConfig(), f.name) == getattr(JSSMConfig(), f.name), f.name
        assert getattr(port.ssm, f.name) == getattr(ref.ssm, f.name), f.name
        assert getattr(port.reduced().ssm, f.name) == getattr(ref.reduced().ssm, f.name)
    assert port.reduced().ssm == SSMConfig(d_state=16, d_conv=4, expand=2,
                                           head_dim=16, n_groups=1, chunk=16)
    assert port.reduced().n_layers == 6 and port.family == "hybrid"
    # a dense config keeps the reference's two layers; overrides win
    assert get_config("internlm2-1.8b").reduced().n_layers == 2
    assert port.reduced(n_layers=12).n_layers == 12


@pytest.mark.parametrize("layers,n_params", [(78, 5_503_481_808), (6, 824_797_968),
                                             (12, 1_214_688_288)])
def test_parameter_counts_match_without_allocating(layers, n_params):
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers)
    assert count_params(cfg) == n_params == j_count_params(
        dataclasses.replace(j_get_config(ARCH), n_layers=layers))
    # per unit: five Mamba2 blocks; once: the shared block, embed and head
    d, s = cfg.d_model, cfg.ssm
    d_inner, H = 2 * d, 2 * d // 64
    mamba = (d + d * (2 * d_inner + 2 * s.d_state + H) + 4 * (d_inner + 2 * s.d_state)
             + (d_inner + 2 * s.d_state) + 3 * H + d_inner + d_inner * d)
    shared = 2 * d + 4 * d * d + 3 * d * cfg.d_ff
    assert mamba == 77_978_064 and shared == 205_528_064
    assert n_params == 2 * cfg.vocab * d + d + shared + 5 * (layers // 6) * mamba


@pytest.fixture(scope="module")
def hybrid():
    jcfg, tcfg = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(1)
    return jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


def test_flat_order_is_ravel_pytree(hybrid):
    jm, tm, jp, tp = hybrid
    assert np.array_equal(tp.flat.numpy(), np.asarray(ravel_pytree(jp)[0]))
    paths = ["/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(tp) == paths
    assert [k.split("/")[0] for k in tp][:4] == ["embed", "final_norm", "lm_head", "shared"]
    assert [k for k in tp if k.startswith("u0/")] == [
        "u0/ln1/scale", "u0/mixer/a_log", "u0/mixer/conv_b", "u0/mixer/conv_w",
        "u0/mixer/d_skip", "u0/mixer/dt_bias", "u0/mixer/out_norm/scale",
        "u0/mixer/w_in", "u0/mixer/w_out"]
    assert not any(k.startswith("u5/") for k in tp)
    assert tp.numel == count_params(tm.cfg)
    assert {k: tuple(v) for k, v in tt.param_shapes(tm.cfg).items()} == \
        {k: tuple(v) for k, v in tp.shapes.items()}
    own = tm.init(0, device="cpu")  # the port's own init: the same layout
    assert list(own) == paths and own.shapes == tp.shapes
    for k in ("u0/mixer/d_skip", "u3/mixer/out_norm/scale", "shared/ln2/scale"):
        assert torch.equal(own[k], torch.ones_like(own[k]))
    assert not own["u4/mixer/conv_b"].any() and not own["u1/mixer/dt_bias"].any()
    # the reference's tree comes back, the shared block included
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jax.device_get(jp))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(x, np.asarray(y))


def _init_as_before(cfg, generator):
    """`transformer.init_params` as it drew before it wrote into one flat
    buffer: every layer's tensors drawn, stacked, then concatenated."""
    _, n_units = tt.layout_of(cfg)
    dev = generator.device
    params = {"embed": torch.randn(cfg.vocab, cfg.d_model, generator=generator,
                                   device=dev) * 0.02,
              "final_norm": {"scale": torch.ones(cfg.d_model)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(cfg.d_model, cfg.vocab, generator=generator,
                                        device=dev) / math.sqrt(cfg.d_model)
    layers = [flatten_nested(tt._block_init("attn", generator, cfg))
              for _ in range(n_units)]
    params["u0"] = nested({k: torch.stack([x[k] for x in layers]) for k in layers[0]})
    return FlatParams.from_tensors(flatten_nested(params))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b", "minicpm3-4b",
                                  "qwen3-32b"])
def test_init_draws_into_one_buffer_as_before(arch):
    """The one-buffer init draws the same numbers, in the same order, as
    the stacked init it replaced, bitwise."""
    cfg = get_config(arch).reduced()
    new = tt.init_params(cfg, torch.Generator().manual_seed(7))
    old = _init_as_before(cfg, torch.Generator().manual_seed(7))
    assert list(new) == list(old) and torch.equal(new.flat, old.flat)


def test_layout_takes_the_hybrid_and_checks_its_config():
    cfg = get_config(ARCH)
    unit = ("mamba2",) * 5 + ("attn_shared",)
    assert tt.layout_of(cfg) == jt.layout_of(j_get_config(ARCH)) == (unit, 13)
    assert tt.layout_of(cfg.reduced()) == (unit, 1)
    with pytest.raises(ValueError, match="SSMConfig"):
        tt.layout_of(dataclasses.replace(cfg, ssm=None))
    with pytest.raises(ValueError, match="whole units"):
        tt.layout_of(dataclasses.replace(cfg, n_layers=80))
    # an xLSTM unit takes its XLSTMConfig (tests/test_torch_xlstm.py)
    with pytest.raises(ValueError, match="XLSTMConfig"):
        tt.layout_of(dataclasses.replace(cfg, layout_unit=("mlstm", "slstm")))


# -- ssd_chunked, mamba2_apply, mamba2_decode --------------------------------------


def _ssm(groups):
    return SSMConfig(d_state=16, head_dim=16, chunk=Q, n_groups=groups)


def _mamba_case(dtype, groups, seed=0):
    """The reference's Mamba2 weights at d_model D, with a_log, dt_bias,
    d_skip, conv_b and the norm scale moved off their init, in the
    compute dtype in both packages."""
    tcfg = _ssm(groups)
    jcfg = JSSMConfig(**dataclasses.asdict(tcfg))
    jp = jm2.mamba2_init(jax.random.PRNGKey(seed), D, jcfg)
    rng = np.random.default_rng(seed + 1)
    for k in ("dt_bias", "d_skip", "conv_b"):
        jp[k] = jnp.asarray(0.3 * rng.normal(size=jp[k].shape), jnp.float32)
    jp["out_norm"]["scale"] = jnp.asarray(
        1.0 + 0.3 * rng.normal(size=jp["out_norm"]["scale"].shape), jnp.float32)
    jd, td = DTYPES[dtype]
    return (jcfg, tcfg, jax.tree.map(lambda a: a.astype(jd), jp),
            _torch_tree(jp, td), rng)


@pytest.mark.parametrize("L", [Q, 4 * Q], ids=["L=Q", "L=4Q"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_chunked_matches(dtype, groups, L):
    jcfg, tcfg = JSSMConfig(**dataclasses.asdict(_ssm(groups))), _ssm(groups)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(groups * 100 + L)
    H, P, N = 8, 16, 16
    xh = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    b_in, c_in = (rng.normal(size=(B, L, groups, N)).astype(np.float32) for _ in range(2))
    init = rng.normal(size=(B, H, N, P)).astype(np.float32)
    j_ssd = jax.jit(lambda *a, init_state: jm2.ssd_chunked(*a, jcfg, init_state=init_state))
    for s0 in (None, init):
        jy, js = j_ssd(jnp.asarray(xh, jd), jnp.asarray(dt), jnp.asarray(a_log, jd),
                       jnp.asarray(b_in, jd), jnp.asarray(c_in, jd),
                       init_state=None if s0 is None else jnp.asarray(s0))
        ty, ts = tm2.ssd_chunked(
            torch.from_numpy(xh).to(td), torch.from_numpy(dt),
            torch.from_numpy(a_log).to(td), torch.from_numpy(b_in).to(td),
            torch.from_numpy(c_in).to(td), tcfg,
            init_state=None if s0 is None else torch.from_numpy(s0))
        assert ty.dtype == td and ty.shape == (B, L, H, P)
        assert ts.dtype == torch.float32 and ts.shape == (B, H, P, N)
        if dtype == "f32":
            _close(ty, jy, 1e-5)
            _close(ts, js, 1e-5)
        else:
            _bf16_close(ty, jy)
            _close(ts, js, BF16_TOL)


def test_ssd_chunked_checks_the_chunk():
    """Q = min(chunk, L): a short sequence is one chunk, and a length that
    is not whole chunks raises, in both packages."""
    cfg = _ssm(1)
    for L in (Q // 2, Q + Q // 2):
        args = [np.zeros((1, L, 8, 16), np.float32), np.ones((1, L, 8), np.float32),
                np.zeros(8, np.float32), np.zeros((1, L, 1, 16), np.float32),
                np.zeros((1, L, 1, 16), np.float32)]
        if L < Q:
            y, _ = tm2.ssd_chunked(*map(torch.from_numpy, args), cfg)
            assert y.shape[1] == L
            continue
        with pytest.raises(ValueError, match="must divide by chunk"):
            tm2.ssd_chunked(*map(torch.from_numpy, args), cfg)
        with pytest.raises(AssertionError):
            jm2.ssd_chunked(*map(jnp.asarray, args),
                            JSSMConfig(**dataclasses.asdict(cfg)))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba2_apply_matches(dtype, groups):
    jcfg, tcfg, jp, tp, rng = _mamba_case(dtype, groups)
    jd, td = DTYPES[dtype]
    x = rng.normal(size=(B, 4 * Q, D)).astype(np.float32)
    cot = rng.normal(size=(B, 4 * Q, D)).astype(np.float32)

    def j_fn(p, xx):
        out = jm2.mamba2_apply(p, xx, D, jcfg)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    # jitted, XLA rounds fused bf16 chains once; the output is held to the
    # reference run op by op (each op rounds), the gradients to f32 below
    (_, j_out), j_grads = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x, jd))
    if dtype == "bf16":
        j_out = jm2.mamba2_apply(jp, jnp.asarray(x, jd), D, jcfg)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten_nested(tp).items()}
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    t_out = tm2.mamba2_apply(nested(leaves), tx, D, tcfg)
    loss = (t_out.float() * torch.from_numpy(cot)).sum()
    grads = torch.autograd.grad(loss, [tx] + list(leaves.values()))
    assert t_out.dtype == td and t_out.shape == (B, 4 * Q, D)
    j_flat = flatten_nested(j_grads[0])
    if dtype == "f32":
        _close(t_out, j_out, 1e-5)
        _close(grads[0], j_grads[1], 1e-5)
        for (name, _), g in zip(leaves.items(), grads[1:]):
            assert _rel(g, j_flat[name]) < 1e-5, name
    else:
        # the reference's bf16 backward sums some gradients (d_skip's over
        # B x L x P products) in bf16, 4.5 % off the f32 gradient; so each
        # bf16 gradient is held to the reference's 5e-2 against the f32
        # gradient of the same bf16 inputs, and no farther from it than
        # the reference's own bf16 gradient (+ 5e-3)
        _bf16_close(t_out, j_out)
        f32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        _, j32 = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True))(
            f32, jnp.asarray(x, jd).astype(jnp.float32))
        j32_flat = flatten_nested(j32[0])
        pairs = [("x", grads[0], j_grads[1], j32[1])] + [
            (name, g, j_flat[name], j32_flat[name])
            for (name, _), g in zip(leaves.items(), grads[1:])]
        for name, g, jb, jf in pairs:
            assert g.dtype == td, name
            assert _rel(g, jf) < 5e-2 and _rel(g, jf) <= _rel(jb, jf) + 5e-3, (
                name, _rel(g, jf), _rel(jb, jf))


def test_loss_gradient_through_ssd_is_finite_where_the_decay_overflows():
    """dt of 0.5 to 1 makes the masked (future) entries of the fastest
    heads' decay matrix exp(cum_i - cum_j) overflow f32: masked before the
    exp, the gradient stays finite in both packages and equal to
    jax.grad's."""
    jcfg, tcfg = JSSMConfig(**dataclasses.asdict(_ssm(2))), _ssm(2)
    rng = np.random.default_rng(5)
    H, P, N, L = 8, 16, 16, 2 * Q
    xh = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = (0.5 + 0.5 * rng.random(size=(B, L, H))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    b_in, c_in = (rng.normal(size=(B, L, 2, N)).astype(np.float32) for _ in range(2))
    # a masked entry reaches exp(120): past f32's exp(88.7)
    assert np.exp(a_log).max() * dt.min() * (Q - 1) > 89.0

    def j_fn(*a):
        y, s = jm2.ssd_chunked(*a, jcfg)
        return jnp.sum(y ** 2) + jnp.sum(s)

    j_g = jax.jit(jax.grad(j_fn, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, (xh, dt, a_log, b_in, c_in)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (xh, dt, a_log, b_in, c_in)]
    y, s = tm2.ssd_chunked(*ins, tcfg)
    t_g = torch.autograd.grad((y ** 2).sum() + s.sum(), ins)
    for t, j in zip(t_g, j_g):
        assert torch.isfinite(t).all() and np.isfinite(np.asarray(j)).all()
        assert _rel(t, j) < 1e-5


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba2_decode_matches_step_by_step(dtype, groups):
    jcfg, tcfg, jp, tp, rng = _mamba_case(dtype, groups, seed=3)
    jd, td = DTYPES[dtype]
    jc = jm2.mamba2_cache_init(B, D, jcfg)
    tc = tm2.mamba2_cache_init(B, D, tcfg, device="cpu")
    conv, ssm = tc["conv"], tc["ssm"]
    assert conv.dtype == ssm.dtype == torch.float32
    tol = 1e-5 if dtype == "f32" else BF16_TOL
    for _ in range(6):
        x = rng.normal(size=(B, 1, D)).astype(np.float32)
        jo, jc = jm2.mamba2_decode(jp, jnp.asarray(x, jd), jc, D, jcfg)
        to, tc = tm2.mamba2_decode(tp, torch.from_numpy(x).to(td), tc, D, tcfg)
        assert to.dtype == td and to.shape == (B, 1, D)
        assert tc["conv"] is conv and tc["ssm"] is ssm  # written in place
        _close(to, jo, tol)
        _close(tc["conv"], jc["conv"], tol)
        _close(tc["ssm"], jc["ssm"], tol)


@pytest.mark.parametrize("groups", [1, 2])
def test_stepped_decode_equals_the_full_apply(groups):
    """The recurrent form against the chunked form (the reference's own
    bar, 2e-5 in f32), over 4 chunks."""
    _, cfg, _, p, rng = _mamba_case("f32", groups, seed=4)
    x = torch.from_numpy(0.5 * rng.normal(size=(B, 4 * Q, D)).astype(np.float32))
    full = tm2.mamba2_apply(p, x, D, cfg)
    cache = tm2.mamba2_cache_init(B, D, cfg, device="cpu")
    outs = []
    for t in range(4 * Q):
        o, cache = tm2.mamba2_decode(p, x[:, t:t + 1], cache, D, cfg)
        outs.append(o[:, 0])
    _close(torch.stack(outs, 1), full, 2e-5)


# -- the hybrid stack: caches, prefill, the ring, the flash switch ----------------


def test_decode_cache_structure_matches(hybrid):
    jm, tm, _, _ = hybrid
    jc, tc = jm.cache_init(3, 10), tm.cache_init(3, 10, device="cpu")
    assert list(tc) == list(jc) == [f"u{i}" for i in range(6)]
    for pos in range(6):
        keys = ["k", "len", "v"] if pos == 5 else ["conv", "ssm"]
        assert sorted(tc[f"u{pos}"]) == sorted(jc[f"u{pos}"]) == keys
        for k in keys:
            t, j = tc[f"u{pos}"][k], jc[f"u{pos}"][k]
            assert tuple(t.shape) == j.shape and t.shape[0] == 1
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
            assert not t.any()
    # a Mamba2 block's state: B x H x head_dim x d_state f32, and the window
    # of d_conv - 1 columns of x, B and C
    assert tuple(tc["u0"]["ssm"].shape) == (1, 3, 8, 16, 16)
    assert tuple(tc["u0"]["conv"].shape) == (1, 3, 3, 128 + 2 * 16)


def _f32_kv_caches(monkeypatch):
    """Both packages' KV caches in f32 (the model's are bf16 in both, so an
    f32 decode rounds k and v where it writes them, and a value near a tie
    rounds the other way in the other package)."""
    j_init, t_init = jt.gqa_cache_init, tt.gqa_cache_init
    monkeypatch.setattr(jt, "gqa_cache_init", lambda b, s, n, d, dtype=None:
                        j_init(b, s, n, d, dtype=jnp.float32))
    monkeypatch.setattr(tt, "gqa_cache_init", lambda b, s, n, d, dtype=None, device=None:
                        t_init(b, s, n, d, dtype=torch.float32, device=device))


@pytest.mark.parametrize("dtype,kv", [("f32", "bf16"), ("bf16", "bf16"), ("f32", "f32")])
def test_prefill_and_stepped_decode_match(hybrid, monkeypatch, dtype, kv):
    """The full-sequence prefill (chunked SSD, blockwise attention) against
    the stepped decode of the same tokens, in each package, and each
    against the other package's; every unit position's caches come back.
    With the model's bf16 KV caches, an f32 decode's k and v part by a
    bf16 ulp where a value sits near a tie, which moves the logits by up to
    ~3e-4: the logits are held at 1e-3 and the caches at one bf16 ulp, the
    port's prefill-to-decode gap within the reference's own + 1e-5; with
    f32 KV caches in both packages, everything at 1e-5.  In bf16 the
    logits are held at the bar of two programs' bf16 logits, 6e-2
    (tests/test_torch_decode.py): jitted, XLA fuses chains of bf16 ops and
    rounds each once, which parts the reference's logits from its own
    op-by-op decode by 0.0115 on average, as far as from the port's (whose
    ops round one by one, as `test_mamba2_apply_matches` holds)."""
    jm, tm, jp, tp = hybrid
    if kv == "f32":
        _f32_kv_caches(monkeypatch)
    jd, td = DTYPES[dtype]
    T = Q if dtype == "bf16" else 2 * Q
    toks = np.random.default_rng(0).integers(0, 256, size=(B, T), dtype=np.int32)
    jc, tc = jm.cache_init(B, T), tm.cache_init(B, T, device="cpu")
    assert tc["u5"]["k"].dtype == (torch.float32 if kv == "f32" else torch.bfloat16)
    jdec = jax.jit(lambda p, b, c: jm.decode_fn(p, b, c, dtype=jd))
    tol = {"f32": 1e-5, "bf16": 1e-3}[kv] if dtype == "f32" else 2 * BF16_TOL
    for t in range(T):
        jlog, jc = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
        tlog, tc = tm.decode_fn(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                tc, dtype=td)
        assert tlog.dtype == torch.float32 and tlog.shape == (B, 256)
        _close(tlog, jlog, tol)
    assert list(tc) == [f"u{i}" for i in range(6)]
    assert tc["u5"]["len"].tolist() == [T]
    for pos in range(5):
        _close(tc[f"u{pos}"]["ssm"], jc[f"u{pos}"]["ssm"], tol)
        _close(tc[f"u{pos}"]["conv"], jc[f"u{pos}"]["conv"], tol)
    if dtype == "f32" and kv == "bf16":
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tc["u5"][k]), _np(jc["u5"][k]),
                                       rtol=2.0 ** -7, atol=0)
    tpre = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, dtype=td)
    jpre = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, dtype=jd)
    _close(tpre, jpre, 1e-5 if dtype == "f32" else 2 * BF16_TOL)
    t_gap = float(np.abs(_np(tpre) - _np(tlog)).max())
    j_gap = float(np.abs(_np(jpre) - _np(jlog)).max())
    if kv == "f32":
        assert t_gap <= 1e-5 and j_gap <= 1e-5, (t_gap, j_gap)
    else:
        assert t_gap <= j_gap + (1e-5 if dtype == "f32" else 2 * BF16_TOL), (t_gap, j_gap)


def test_ring_buffer_wraps(hybrid, monkeypatch):
    """attn_window 8 over 20 tokens: the shared block's caches hold 8
    slots, written at len % 8; the port's stepped decode equals the
    reference's at every step, and the last step equals the windowed
    prefill's last logits (f32 compute and KV caches, so 1e-5)."""
    _, _, jp, tp = hybrid
    _f32_kv_caches(monkeypatch)
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), attn_window=8)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), attn_window=8)
    jm, tm = j_build(jcfg), build(tcfg)
    toks = np.random.default_rng(2).integers(0, 256, size=(B, 32), dtype=np.int32)
    jc, tc = jm.cache_init(B, 20), tm.cache_init(B, 20, device="cpu")
    assert tuple(tc["u5"]["k"].shape) == (1, B, 8, 4, 16)
    jdec = jax.jit(lambda p, b, c: jm.decode_fn(p, b, c, dtype=jnp.float32))
    for t in range(20):
        jlog, jc = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
        tlog, tc = tm.decode_fn(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                tc, dtype=torch.float32)
        _close(tlog, jlog, 1e-5)
    assert tc["u5"]["len"].tolist() == [20]
    _close(tc["u5"]["k"], jc["u5"]["k"], 1e-5)
    # a cache of 8 slots asked for is the same ring
    one = tm.cache_init(B, 8, device="cpu")
    for t in range(20):
        _, one = tm.decode_fn(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                              one, dtype=torch.float32)
    assert torch.equal(one["u5"]["k"], tc["u5"]["k"])
    # the windowed prefill attends to the same 8 positions as the ring
    cache = tm.cache_init(B, 32, device="cpu")
    for t in range(32):
        slog, cache = tm.decode_fn(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                   cache, dtype=torch.float32)
    pre = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, dtype=torch.float32)
    _close(pre, slog, 1e-5)


def test_flash_switch_never_reaches_flash_attention(hybrid, monkeypatch):
    """The shared block attends in a window, so under ``attn_impl="flash"``
    the objective, its gradient and `prefill_fn` make no call to
    `FlashAttention` or to the flash wrapper, and equal the blockwise ones
    bitwise."""
    _, tm, _, tp = hybrid

    def refuse(*a, **k):
        raise AssertionError("flash reached")

    monkeypatch.setattr(tl.FlashAttention, "apply", refuse)
    monkeypatch.setattr(tl.flash_ops, "attention", refuse)
    tb = {"tokens": torch.from_numpy(_docs().columns["tokens"][:4])}
    w = torch.ones(4)
    got = {}
    for impl in ("flash", "blockwise"):
        obj = tm.objective(loss_chunk=SEQ, attn_impl=impl, remat=True,
                           dtype=torch.float32)
        with use_attention_impl(impl):
            pre = tm.prefill_fn(tp, tb, dtype=torch.float32)
        got[impl] = (obj.per_example_loss(tp, tb), obj.make_grad_fn()(tp, tb, w), pre)
    for a, b in zip(got["flash"], got["blockwise"]):
        assert torch.equal(a, b)


def _docs():
    return token_stream(N_DOCS, SEQ, 256, seed=0)


# -- phase 17 (d)'s recipe --------------------------------------------------------------
# chip_smoke.py's DeltaGrad recipe on zamba2-7b (phase 9's, cut by host memory
# to T 10, j0 4: lr 0.01, T0 4, m 2, the guard; 128 documents, B 32, 4 rows
# deleted) at one unit (5 Mamba2 blocks and the shared block) of the
# published layout cut in width: d_model d, d_ff 4 d, attention heads of 112
# (d // 112 of them, at least one head of d), the published SSM (d_state 64,
# head_dim 64, chunk 128, expand 2), vocab 4096.  Run as a script, this
# prints both packages' d_ui/d_us over draws:
#   PYTHONPATH=src python tests/test_torch_mamba2.py 64,64 128,128,bf16,8
RECIPE = dict(docs=128, batch=32, steps=10, lr=0.01, removed=[3, 42, 81, 120],
              dg=dict(period=4, burn_in=4, history_size=2, guard=True,
                      curvature_eps=1e-8))


def _recipe_cfgs(d):
    heads = max(1, d // 112)
    kw = dict(n_layers=6, d_model=d, n_heads=heads, n_kv_heads=heads,
              d_head=min(d, 112), d_ff=4 * d, vocab=4096)
    return (dataclasses.replace(j_get_config(ARCH), **kw),
            dataclasses.replace(get_config(ARCH), **kw))


def _recipe_run(d, S, dtype="f32", seed=0):
    """Train -> BaseL -> replay in both packages on the same JAX init, at
    the compute `dtype` (bf16: the card's phase 17 (d)), the init and the
    documents drawn from `seed`: {package: (d_ui, d_us, counters)}, the
    port's ||Bv||/||v|| per B v, and the two replays' max |gap|."""
    jcfg, tcfg = _recipe_cfgs(d)
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(seed)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    removed = np.asarray(RECIPE["removed"], np.int64)
    meta = dict(n=RECIPE["docs"], batch_size=RECIPE["batch"], seed=5,
                steps=RECIPE["steps"], lr_schedule=((0, RECIPE["lr"]),))
    chunk = min(128, S)
    jd, td = DTYPES[dtype]

    def per_row(params, batch):
        return jax.vmap(lambda row: jm.loss_fn(
            params, jax.tree.map(lambda c: c[None], row), remat=False,
            loss_chunk=chunk, dtype=jd))(batch)

    jo, jdocs = jdg.Objective(per_example_loss=per_row), j_token_stream(
        RECIPE["docs"], S, 4096, seed=seed)
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
    p0 = model.init(0, device="cpu")
    docs = token_stream(8, 16, 256, seed=0)
    meta = TMeta(n=8, batch_size=4, seed=0, steps=2, lr_schedule=((0, 0.05),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdg.sgd_train_with_cache(model.objective(), p0, docs, meta)
    caches = model.cache_init(2, 4, device="cpu")
    assert {c.device.type for v in caches.values() for c in v.values()} == {"cpu"}


def _prefill_gaps(layers, prompt=128, batch=4):
    """Both packages' `prefill_fn` against their own stepped decode of the
    same prompt, at `layers` layers of the reduced hybrid, in bf16 and f32
    compute: {dtype: ((jax max, mean), (port max, mean))}."""
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), n_layers=layers)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=layers)
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(0)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    toks = np.random.default_rng(0).integers(0, 256, size=(batch, prompt), dtype=np.int32)
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
    # "prefill,L": both packages' prefill-to-stepped-decode gaps at L layers
    # of the reduced hybrid; each other argument d,S[,dtype[,seeds]]: the
    # recipe at d_model d and S tokens a document, over seeds 0 .. seeds -
    # 1, then how many replays of each package missed d_ui < d_us and in how
    # many draws the counters agreed
    for spec in sys.argv[1:]:
        if spec.startswith("prefill,"):
            n = int(spec.split(",")[1])
            for name, ((jm_, jmean), (tm_, tmean)) in _prefill_gaps(n).items():
                print(f"{ARCH} reduced, {n} layers, B 4, a 128 prompt, {name}: prefill "
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
