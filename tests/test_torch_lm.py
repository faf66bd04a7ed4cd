"""The port's LM path (InternLM2's dense GQA stack) against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart on the CPU, at the reduced widths of
``tests/test_lm.py`` (2 layers, d_model 32, 4 heads / 2 KV, d_head 8,
vocab 64) and S = 16.  Tolerances:

  * copies (config, token corpus, flat parameter order): exact;
  * modules in f32: 1e-5 (sums taken in another order); in bf16, the
    reference's kernel bar 3e-2 elementwise (both round to bf16 at the
    same places, but a product's sum order can flip a last bit);
  * the flash kernel's plain version: 2e-5 (f32) and 3e-2 (bf16), the
    reference's own sweep tolerances, against JAX's ``attention_ref`` and
    the Pallas kernel run by its interpreter;
  * the objective in bf16: the reference's model bar (tests/test_lm.py),
    loss within 5e-3 and gradient within 5e-2 relative; in f32 1e-5;
  * the slice (train -> BaseL -> replay) in f32: parameters within 1e-5
    relative (norm of the difference over the norm), all seven counters
    exactly equal.
"""

import dataclasses
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
from repro.kernels.flash_attention.ops import attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import layers as jl
from repro.models.registry import build as j_build

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import deltagrad as tdg
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.core.history import TrainingHistory as THistory
from repro_torch.data.synthetic import token_stream
from repro_torch.kernels.flash_attention.ops import attention as t_flash
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as tl
from repro_torch.models.attention_config import (attention_impl,
                                                 set_attention_impl,
                                                 use_attention_impl)
from repro_torch.models.registry import (build, count_params, params_from_jax,
                                         params_to_numpy)
from repro_torch.models.transformer import layout_of

REDUCED = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
               vocab=64, d_head=8)
N_DOCS, SEQ, STEPS, BATCH = 48, 16, 12, 16
REMOVED = np.asarray([3, 11, 25, 40], np.int64)
LR = ((0, 0.05),)
DG = dict(period=2, burn_in=4, history_size=2, guard=True, curvature_eps=1e-8)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# tests/test_kernels.py's flash sweep: (B, S, H, Hkv, D, causal), then the
# edges of the card kernel's 64-row tiles (S = 1, 65, 127; causal S = 512
# at G = 1 and 8; non-causal S = 256)
FLASH_SHAPES = [(2, 128, 4, 2, 64, True), (1, 256, 8, 8, 32, True),
                (2, 100, 4, 1, 64, True), (1, 128, 2, 2, 128, False),
                (1, 64, 4, 4, 16, True), (3, 1, 4, 2, 64, True),
                (2, 65, 8, 2, 128, True), (1, 127, 4, 4, 32, False),
                (1, 512, 4, 4, 64, True), (2, 512, 8, 1, 128, True),
                (2, 256, 4, 2, 64, False)]
# the Pallas kernel's block_q by S: the sweep's, then a block that pads the
# ragged causal shapes, or one block where non-causal needs S aligned
FLASH_BLOCKS = {128: 64, 256: 128, 100: 32, 64: 16, 1: 1, 65: 32, 127: 128,
                512: 128}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread for this file's tests and its module
    fixtures alike (a fixture computed on more threads sums in another
    order): the suite runs its files in several worker processes on the
    same cores, and every worker's thread pool spinning for them slows the
    port's small CPU ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (j_get_config("internlm2-1.8b").reduced(**REDUCED),
            get_config("internlm2-1.8b").reduced(**REDUCED))


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _pair(x, dtype):
    """One numpy array as a JAX array and a torch tensor of `dtype` (both
    round f32 to bf16 to nearest even, so the bits agree)."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


def _rel(a, b) -> float:
    a, b = np.ravel(_np(a)), np.ravel(_np(b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -- copies -------------------------------------------------------------------


def test_config_matches_the_reference_field_by_field():
    ref = j_get_config("internlm2-1.8b")
    port = get_config("internlm2-1.8b")
    for f in dataclasses.fields(ModelConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.head_dim == ref.head_dim == 128
    small = port.reduced(**REDUCED)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(small, f.name) == getattr(ref.reduced(**REDUCED), f.name)


@pytest.mark.parametrize("n,s,vocab,seed", [(48, 16, 64, 0), (7, 33, 92544, 3)])
def test_token_stream_is_bitwise_the_reference(n, s, vocab, seed):
    a = token_stream(n, s, vocab, seed=seed).columns["tokens"]
    b = j_token_stream(n, s, vocab, seed=seed).columns["tokens"]
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_flat_order_is_ravel_pytree():
    jcfg, tcfg = _cfgs()
    jp = j_build(jcfg).init(1)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    assert np.array_equal(tp.flat.numpy(), np.asarray(ravel_pytree(jp)[0]))
    paths = ["/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(tp) == paths and len(paths) == 12
    assert tp.numel == count_params(tcfg)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(x, np.asarray(y))


def test_count_params_at_full_width():
    cfg = get_config("internlm2-1.8b")
    assert count_params(cfg) == 1_889_110_016
    assert count_params(dataclasses.replace(cfg, n_layers=2)) == 504_899_584


def test_layout_rejects_families_not_ported():
    """The encoder-decoder family (item 9e), the last this test refused, is
    taken: `build` gives the enc-dec model with the reference's parameter
    count, and `layout_of` points to `models.encdec` (its layers are not
    a unit of blocks)."""
    from repro.models.registry import count_params as j_count_params
    from repro_torch.models.registry import EncDecModel

    change = dict(family="audio", frontend="frames", mlp="gelu", n_encoder_layers=2)
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), **change)
    assert isinstance(build(cfg), EncDecModel)
    assert count_params(cfg) == j_count_params(
        dataclasses.replace(j_get_config("internlm2-1.8b"), **change))
    with pytest.raises(ValueError, match=r"models\.encdec"):
        layout_of(cfg)


# -- modules --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(_rand(rng, 2, 5, 32), dtype)
    scale = _rand(rng, 32) + 1.0
    js, ts = _pair(scale, dtype)
    _close(tl.rmsnorm({"scale": ts}, tx, 1e-5),
           jl.rmsnorm({"scale": js}, jx, 1e-5), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_rope_matches(dtype):
    rng = np.random.default_rng(2)
    jx, tx = _pair(_rand(rng, 2, 16, 4, 8), dtype)
    pos = np.arange(16)
    _close(tl.apply_rope(tx, torch.from_numpy(pos), 1e6),
           jl.apply_rope(jx, jnp.asarray(pos), 1e6), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal,window,block_k", [(True, 0, 512), (True, 0, 5),
                                                   (False, 0, 7), (True, 4, 6)])
def test_blockwise_attention_forward_and_vjp_match(dtype, causal, window,
                                                   block_k):
    rng = np.random.default_rng(3)
    xs = [_rand(rng, 2, 16, 4, 8), _rand(rng, 2, 16, 2, 8), _rand(rng, 2, 16, 2, 8)]
    gout = _rand(rng, 2, 16, 4, 8)
    jq, tq = zip(*(_pair(x, dtype) for x in xs))
    jg, tg = _pair(gout, dtype)
    kw = dict(causal=causal, window=window, block_k=block_k)
    j_out, vjp = jax.vjp(lambda a, b, c: jl.blockwise_attention(a, b, c, **kw), *jq)
    tq = [x.requires_grad_(True) for x in tq]
    t_out = tl.blockwise_attention(*tq, **kw)
    t_grads = torch.autograd.grad(t_out, tq, tg)
    tol = DTYPES[dtype][2]
    _close(t_out.detach(), j_out, tol)
    for a, b in zip(t_grads, vjp(jg)):
        if dtype == "f32":
            _close(a, b, tol)
        else:
            assert _rel(a, b) < 5e-2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gqa_apply_matches(dtype):
    rng = np.random.default_rng(4)
    w = {"wq": _rand(rng, 32, 32, scale=0.18), "wk": _rand(rng, 32, 16, scale=0.18),
         "wv": _rand(rng, 32, 16, scale=0.18), "wo": _rand(rng, 32, 32, scale=0.18)}
    jw = {k: _pair(v, dtype)[0] for k, v in w.items()}
    tw = {k: _pair(v, dtype)[1] for k, v in w.items()}
    jx, tx = _pair(_rand(rng, 2, 16, 32), dtype)
    kw = dict(n_heads=4, n_kv=2, d_head=8, rope_theta=1e6)
    _close(tl.gqa_apply(tw, tx, **kw), jl.gqa_apply(jw, jx, **kw),
           DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_apply_matches(dtype):
    rng = np.random.default_rng(5)
    w = {"w_gate": _rand(rng, 32, 64, scale=0.18), "w_up": _rand(rng, 32, 64, scale=0.18),
         "w_down": _rand(rng, 64, 32, scale=0.125)}
    jw = {k: _pair(v, dtype)[0] for k, v in w.items()}
    tw = {k: _pair(v, dtype)[1] for k, v in w.items()}
    jx, tx = _pair(_rand(rng, 2, 16, 32), dtype)
    _close(tl.mlp_apply(tw, tx, "swiglu"), jl.mlp_apply(jw, jx, "swiglu"),
           DTYPES[dtype][2])


def _all_finite_bf16() -> np.ndarray:
    """Every finite bf16 value, as f32 (each bit pattern but inf and NaN)."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    vals = bits.view(np.float32)
    return vals[np.isfinite(vals)]


@pytest.mark.parametrize("name", ["sigmoid", "silu", "gelu_tanh"])
def test_activations_round_as_the_reference_on_every_bf16_value(name):
    """`layers.sigmoid`, `silu` and `gelu_tanh` round each op to bf16, as
    XLA computes ``jax.nn.sigmoid``, ``jax.nn.silu`` and
    ``jax.nn.gelu(approximate=True)``: bitwise on every finite bf16 input
    from -87 up but the 766 of magnitude below 2^-124 (0 kept).  Below
    -87 the logistic, and below 2^-124 the product, is subnormal, which
    XLA's CPU code flushes to zero and torch's keeps.  In f32 within 1e-6
    on |x| <= 30."""
    j_fn = {"sigmoid": jax.nn.sigmoid, "silu": jax.nn.silu,
            "gelu_tanh": functools.partial(jax.nn.gelu, approximate=True)}[name]
    t_fn = getattr(tl, name)
    x = _all_finite_bf16()
    x = x[(x >= -87) & ((np.abs(x) >= 2.0 ** -124) | (x == 0))]
    got = t_fn(torch.from_numpy(x).to(torch.bfloat16))
    want = j_fn(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    x = x[np.abs(x) <= 30]
    _close(t_fn(torch.from_numpy(x)), j_fn(jnp.asarray(x)), 1e-6)


def test_fan_out_sums_the_uses_gradients_in_f32():
    """`layers.fan_out`: n views of x (no copy); under autograd x's
    gradient is its uses' gradients summed in f32 in their order and
    rounded once to bf16, without autograd x itself n times."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_rand(rng, 8, 16)).to(torch.bfloat16).requires_grad_(True)
    ws = [torch.from_numpy(_rand(rng, 16, 4)).to(torch.bfloat16) for _ in range(4)]
    uses = tl.fan_out(x, 4)
    assert all(u.data_ptr() == x.data_ptr() and u.dtype == x.dtype for u in uses)
    outs = [u @ w for u, w in zip(uses, ws)]
    cts = [torch.from_numpy(_rand(rng, 8, 4)).to(torch.bfloat16) for _ in ws]
    (g,) = torch.autograd.grad(outs, [x], cts)
    parts = [ct @ w.t() for ct, w in zip(cts, ws)]
    want = (((parts[0].float() + parts[1].float()) + parts[2].float())
            + parts[3].float()).to(torch.bfloat16)
    assert g.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(g), _np(want))
    with torch.no_grad():
        assert all(u is x for u in tl.fan_out(x, 3))


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "relu_sq"])
def test_mlp_apply_in_bf16_is_bitwise_the_references(kind):
    """The same weights carried across (`params_from_jax`) and rounded to
    bf16 in both packages: the FFN's output is the JAX package's bit for
    bit (the activations round op by op, and these products sum alike);
    in f32 within 1e-5."""
    rng = np.random.default_rng(5)
    w = {"w_gate": _rand(rng, 32, 64, scale=0.18), "w_up": _rand(rng, 32, 64, scale=0.18),
         "w_down": _rand(rng, 64, 32, scale=0.125)}
    if kind != "swiglu":
        del w["w_gate"]
    x = _rand(rng, 2, 16, 32, scale=2.0)
    tp = params_from_jax(w, "cpu")
    for dtype in ("bf16", "f32"):
        jd, td, _ = DTYPES[dtype]
        got = tl.mlp_apply({k: tp[k].to(td) for k in w}, torch.from_numpy(x).to(td), kind)
        want = jl.mlp_apply({k: jnp.asarray(v, jd) for k, v in w.items()},
                            jnp.asarray(x, jd), kind)
        assert got.dtype == td
        if dtype == "bf16":
            np.testing.assert_array_equal(_np(got), _np(want))
        else:
            _close(got, want, 1e-5)


def test_block_gradient_in_bf16_follows_the_references_cotangent_sums():
    """One dense block (InternLM2's reduced widths) in bf16, the same
    weights and input: its forward is the jitted reference's bit for bit,
    and its backward sums the cotangents where XLA's fused backward sums
    them (the norms read the unrounded residual sum; a norm's output
    reaches its matmuls one cast at a time, their input gradients summed
    in f32; the norm's own input gradient rounded before it joins the
    residual's).  Every gradient within 1e-4 relative of the reference's
    (the matmuls' sums differ in order only); autograd's default sums
    leave the input's and the norms' gradients ~5e-3 apart."""
    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt
    from repro_torch.utils.tree import flatten_nested, nested

    jc, tc = _cfgs()
    jp = j_build(jc).init(0)
    tp = nested(params_from_jax(jax.device_get(jp), "cpu"))
    jb = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16), jp["u0"])
    tb = {k: v.to(torch.bfloat16)
          for k, v in flatten_nested(tt._slice(tp["u0"], 0)).items()}
    rng = np.random.default_rng(7)
    x, ct = (_rand(rng, 4, 16, jc.d_model) for _ in range(2))
    j_out, vjp = jax.vjp(jax.jit(lambda p, y: jt._block_apply("attn", p, y, jc)[0]),
                         jb, jnp.asarray(x, jnp.bfloat16))
    j_gp, j_gx = vjp(jnp.asarray(ct, jnp.bfloat16))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tb.items()}
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    t_out = tt._block_apply("attn", nested(leaves), tx, tc, False)[0]
    grads = torch.autograd.grad(t_out, [tx] + list(leaves.values()),
                                torch.from_numpy(ct).to(torch.bfloat16))
    np.testing.assert_array_equal(_np(t_out.detach()), _np(j_out))
    assert _rel(grads[0], j_gx) < 1e-4
    j_flat = flatten_nested(j_gp)
    for (name, _), g in zip(leaves.items(), grads[1:]):
        assert g.dtype == torch.bfloat16 and _rel(g, j_flat[name]) < 1e-4, name


# -- the flash kernel's plain version --------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,Hkv,D,causal", FLASH_SHAPES)
def test_flash_plain_version_matches_jax_ref_and_pallas(B, S, H, Hkv, D,
                                                        causal, dtype):
    rng = np.random.default_rng(B * 100 + S)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_rand(rng, B, S, h, D), dtype) for h in (H, Hkv, Hkv))
    tol = {"f32": 2e-5, "bf16": 3e-2}[dtype]
    got = t_flash(tq, tk, tv, causal=causal)  # CPU tensors: the plain version
    assert got.shape == (B, S, H, D) and got.dtype == tq.dtype
    ref = j_attention_ref(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                          jv.transpose(0, 2, 1, 3),
                          causal=causal).transpose(0, 2, 1, 3)
    _close(got, ref, tol)
    blk = FLASH_BLOCKS[S]
    pallas = j_flash(jq, jk, jv, causal=causal, block_q=blk, block_k=blk,
                     interpret=True)
    _close(got, pallas, tol)
    _close(attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                         tv.transpose(1, 2), causal=causal).transpose(1, 2),
           got, 0.0)


def test_flash_wrapper_checks_its_operands():
    q = torch.zeros(1, 64, 4, 16)
    kv = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="contiguous"):
        t_flash(torch.zeros(1, 4, 64, 16).transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="block-aligned"):
        t_flash(torch.zeros(1, 200, 4, 16), torch.zeros(1, 200, 2, 16),
                torch.zeros(1, 200, 2, 16), causal=False)
    with pytest.raises(ValueError, match="multiple"):
        t_flash(torch.zeros(1, 64, 3, 16), kv, kv)


# -- the model and its objective --------------------------------------------------


def _jax_objective(model, dtype):
    """The JAX objective at a compute dtype: `Objective.from_model`'s vmap
    over batch-1 slices, with ``dtype`` passed to the loss (None: the
    model's default, which is what `from_model` itself uses)."""
    if dtype is None:
        return jdg.Objective.from_model(model, loss_chunk=SEQ)

    def per_example_loss(params, batch):
        return jax.vmap(lambda row: model.loss_fn(
            params, {"tokens": row[None]}, remat=False, loss_chunk=SEQ,
            dtype=dtype))(batch["tokens"])

    return jdg.Objective(per_example_loss=per_example_loss)


@pytest.fixture(scope="module")
def lm():
    jcfg, tcfg = _cfgs()
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(1)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    docs = token_stream(N_DOCS, SEQ, REDUCED["vocab"], seed=0)
    return jm, tm, jp, tp, docs


@functools.lru_cache(maxsize=None)
def _jax_values(dtype):
    """JAX's per-row losses, weighted loss and flat gradient on the first 8
    documents (computed once per dtype; the port's remat does not change
    the function)."""
    jcfg, _ = _cfgs()
    jm = j_build(jcfg)
    jp = jm.init(1)
    toks = token_stream(N_DOCS, SEQ, REDUCED["vocab"], seed=0).columns["tokens"][:8]
    jb = {"tokens": jnp.asarray(toks)}
    jo = _jax_objective(jm, jnp.float32 if dtype == "f32" else None)
    w = jnp.asarray(np.linspace(0.0, 1.0, 8).astype(np.float32))
    loss, grad = jo.make_value_grad_fn()(jp, jb, w)
    return jo.per_example_loss(jp, jb), loss, ravel_pytree(grad)[0]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_rows_and_objective_match(lm, dtype, remat):
    _, tm, _, tp, docs = lm
    tb = {"tokens": torch.from_numpy(docs.columns["tokens"][:8])}
    to = tm.objective(loss_chunk=SEQ, remat=remat,
                      dtype=torch.float32 if dtype == "f32" else None)
    w = np.linspace(0.0, 1.0, 8).astype(np.float32)
    j_rows, j_loss, j_grad = _jax_values(dtype)
    t_rows = to.per_example_loss(tp, tb)
    t_loss = to.weighted_mean_loss(tp, tb, torch.from_numpy(w))
    t_grad = to.make_grad_fn()(tp, tb, torch.from_numpy(w))
    if dtype == "f32":
        _close(t_rows, j_rows, 1e-5)
        assert abs(float(t_loss) - float(j_loss)) < 1e-5
        _close(t_grad, j_grad, 1e-5)
    else:
        assert abs(float(t_loss) - float(j_loss)) < 5e-3
        assert _rel(t_grad, j_grad) < 5e-2
    # the batch mean is the mean of the rows (each has S - 1 targets)
    mean = tm.loss_fn(tp, tb, remat=remat, loss_chunk=SEQ,
                      dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    assert abs(float(mean) - float(t_rows.mean())) < 1e-6


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_autograd_gradient_matches_blockwise(dtype):
    rng = np.random.default_rng(8)
    xs = [_rand(rng, 2, 16, 4, 16), _rand(rng, 2, 16, 2, 16), _rand(rng, 2, 16, 2, 16)]
    g = _pair(_rand(rng, 2, 16, 4, 16), dtype)[1]
    outs = {}
    for impl in ("flash", "blockwise"):
        qkv = [_pair(x, dtype)[1].requires_grad_(True) for x in xs]
        with use_attention_impl(impl):
            out = tl.full_attention(*qkv)
        outs[impl] = (out.detach(), torch.autograd.grad(out, qkv, g))
    (fo, fg), (bo, bg) = outs["flash"], outs["blockwise"]
    _close(fo, bo, DTYPES[dtype][2])
    for a, b in zip(fg, bg):  # the same backward program on the same inputs
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_model_flash_matches_blockwise_at_the_reference_bar(lm, dtype):
    _, tm, _, tp, docs = lm
    toks = torch.from_numpy(docs.columns["tokens"][:8])
    td = DTYPES[dtype][1]
    ref = tm.objective(loss_chunk=SEQ, dtype=td)
    fl = tm.objective(loss_chunk=SEQ, dtype=td, attn_impl="flash")
    ones = torch.ones(8)
    l_ref = ref.weighted_mean_loss(tp, {"tokens": toks}, ones)
    l_fl = fl.weighted_mean_loss(tp, {"tokens": toks}, ones)
    g_ref = ref.make_grad_fn()(tp, {"tokens": toks}, ones)
    g_fl = fl.make_grad_fn()(tp, {"tokens": toks}, ones)
    assert abs(float(l_ref) - float(l_fl)) < 5e-3
    assert _rel(g_fl, g_ref) < 5e-2
    assert attention_impl() == "blockwise"  # the pin is scoped to each call


def test_flash_with_remat_recomputes_with_flash(lm):
    """remat recomputes each layer in the backward pass, after the
    objective's attention pin has ended: the recompute must run the same
    attention as the forward pass (a different one changes the saved
    tensors, which torch's checkpoint refuses)."""
    _, tm, _, tp, docs = lm
    batch = {"tokens": torch.from_numpy(docs.columns["tokens"][:4])}
    grads = [tm.objective(loss_chunk=SEQ, remat=remat, attn_impl="flash",
                          dtype=torch.float32).make_grad_fn()(tp, batch, torch.ones(4))
             for remat in (False, True)]
    assert torch.equal(grads[0], grads[1])


def test_attention_impl_switch_validates():
    assert attention_impl() == "blockwise"
    for bad in ("nope", "flash_interpret"):  # Pallas's interpreter: no port
        with pytest.raises(ValueError, match="attention impl must be one of"):
            set_attention_impl(bad)
        with pytest.raises(ValueError, match="attention impl must be one of"):
            build(_cfgs()[1]).objective(attn_impl=bad)
    with use_attention_impl("flash"):
        assert attention_impl() == "flash"
    with use_attention_impl(None):
        assert attention_impl() == "blockwise"


# -- the slice as a whole, f32 ------------------------------------------------------


def _metas():
    kw = dict(n=N_DOCS, batch_size=BATCH, seed=5, steps=STEPS, lr_schedule=LR)
    return JMeta(**kw), TMeta(**kw)


@pytest.fixture(scope="module")
def jax_slice(lm):
    """train -> BaseL -> replay in the JAX package at f32: resident, and
    from a host-tier delta_int8 history (whose codes the port replays)."""
    jm, _, jp, _, _ = lm
    obj = _jax_objective(jm, jnp.float32)
    docs = j_token_stream(N_DOCS, SEQ, REDUCED["vocab"], seed=0)
    jmeta, _ = _metas()
    w_star, hist = jdg.sgd_train_with_cache(obj, jp, docs, jmeta)
    w_u, _ = jdg.baseline_retrain(obj, docs, jmeta, jp, REMOVED)
    w_i, st = jdg.deltagrad_retrain(obj, hist, docs, REMOVED,
                                    jdg.DeltaGradConfig(**DG))
    _, hd = jdg.sgd_train_with_cache(obj, jp, docs, jmeta, tier="host",
                                     codec="delta_int8", window=4)
    w_d, st_d = jdg.deltagrad_retrain(obj, hd, docs, REMOVED,
                                      jdg.DeltaGradConfig(**DG, stream_window=4))
    flat = lambda t: np.asarray(ravel_pytree(t)[0])  # noqa: E731
    return dict(w_star=flat(w_star), w_u=flat(w_u), w_i=flat(w_i), st=st,
                delta_state=jax.device_get(hd.state_dict()), w_d=flat(w_d),
                st_d=st_d)


@pytest.fixture(scope="module")
def port_slice(lm):
    _, tm, _, tp, docs = lm
    obj = tm.objective(loss_chunk=SEQ, dtype=torch.float32)
    _, tmeta = _metas()
    w_star, hist = tdg.sgd_train_with_cache(obj, tp, docs, tmeta, device="cpu")
    w_u, _ = tdg.baseline_retrain(obj, docs, tmeta, tp, REMOVED, device="cpu")
    w_i, st = tdg.deltagrad_retrain(obj, hist, docs, REMOVED,
                                    tdg.DeltaGradConfig(**DG), device="cpu")
    return dict(obj=obj, w_star=w_star, w_u=w_u, w_i=w_i, st=st)


def _counters_equal(port, ref):
    for k, v in port.counters().items():
        assert v == getattr(ref, k), (k, port.counters(), ref)


def test_slice_resident_matches_jax(jax_slice, port_slice):
    j, t = jax_slice, port_slice
    for key in ("w_star", "w_u", "w_i"):
        assert _rel(t[key].flat, j[key]) <= 1e-5, key
    _counters_equal(t["st"], j["st"])
    assert t["st"].approx_steps > 0 and t["st"].explicit_steps > 0


def test_slice_host_f32_streamed_is_bitwise_the_resident_one(lm, port_slice):
    _, _, _, tp, docs = lm
    _, tmeta = _metas()
    obj = port_slice["obj"]
    w_star, hist = tdg.sgd_train_with_cache(obj, tp, docs, tmeta, tier="host",
                                            window=4, device="cpu")
    assert torch.equal(w_star.flat, port_slice["w_star"].flat)
    w, st = tdg.deltagrad_retrain(obj, hist, docs, REMOVED,
                                  tdg.DeltaGradConfig(**DG, stream_window=4),
                                  device="cpu")
    assert st.extra["store"] == "streamed" and st.extra["windows"] == 3
    assert torch.equal(w.flat, port_slice["w_i"].flat)
    assert st.counters() == port_slice["st"].counters()


@pytest.mark.parametrize("mode", ["kernel", "fetch"])
def test_slice_host_delta_int8_codes_replay_like_jax(lm, jax_slice, port_slice,
                                                     mode):
    _, _, _, _, docs = lm
    _, tmeta = _metas()
    hist = THistory.from_state_dict(jax_slice["delta_state"], tmeta,
                                    device="cpu")
    assert list(hist.shapes) == list(port_slice["w_i"].shapes)
    assert len(hist.bounds) == 13  # 12 leaves, one int8 scale each
    w, st = tdg.deltagrad_retrain(
        port_slice["obj"], hist, docs, REMOVED,
        tdg.DeltaGradConfig(**DG, stream_window=4, stream_decode=mode),
        device="cpu")
    assert st.extra["stream_decode"] == mode
    assert _rel(w.flat, jax_slice["w_d"]) <= 1e-5
    _counters_equal(st, jax_slice["st_d"])
    assert st.approx_steps > 0

