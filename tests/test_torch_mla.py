"""The port's multi-head latent attention (MiniCPM3) against the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart, at the reference's reduced MLA sizes
(``ModelConfig.reduced()`` of minicpm3-4b: 2 layers, d_model 64, 4 heads,
vocab 256; q_lora 32, kv_lora 16, qk_nope 8, qk_rope 8, v_head 8), with
the JAX weights carried across (`params_from_jax`).  Tolerances:

  * copies (configs, parameter counts, the flat order): exact;
  * `mla_apply` in f32: the output and the gradient with respect to x and
    every weight within 1e-5; in bf16 on the same bf16 inputs: the
    reference's kernel bar, 3e-2 elementwise on the output, and a mean
    |gap| below 3e-3 (a tenth of it: two bf16 programs part by an ulp
    here and there, not everywhere);
  * `mla_decode` step by step, f32 compute: the outputs within 1e-5, and
    the latent caches, bf16 in both packages whatever the compute dtype,
    within one bf16 ulp (2^-7 relative: a value near a tie may round the
    other way); bf16 compute: 3e-2 on both;
  * `prefill` against the stepped absorbed decode of the same tokens: the
    port's gap within the JAX package's own gap for the same pair plus
    1e-5 (the f32 bar; the gap is the bf16 cache's rounding), and each
    package's prefill and stepped logits against the other's at 1e-5 /
    1e-4;
  * the losses and the objective's gradient in f32: 1e-5; in bf16, the
    reference's model bars, 5e-3 on the loss and 5e-2 relative on the
    gradient;
  * train -> BaseL -> replay in f32: the seven counters exactly equal,
    the parameters within 1e-5 relative where the replay converges (lr
    0.01); at lr 0.05 both packages' replays diverge (d_ui/d_us 124), and
    are held to the counters and to d_ui alike, 1e-2 relative;
  * ``decode_main``: greedy tokens equal;
  * the train CLI's printed loss: 5e-3 (bf16 compute).

MLA's expanded form calls blockwise attention directly, as the
reference's does (`src/repro/models/mla.py:79`), so ``attn_impl="flash"``
changes nothing on this model: no call reaches `FlashAttention`.
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

from repro.configs.base import MLAConfig as JMLAConfig
from repro.configs.registry import get_config as j_get_config
from repro.core import deltagrad as jdg
from repro.core.history import HistoryMeta as JMeta
from repro.data.synthetic import token_stream as j_token_stream
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.models import mla as jmla
from repro.models import transformer as jt
from repro.models.registry import build as j_build
from repro.models.registry import count_params as j_count_params

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import deltagrad as tdg
from repro_torch.core import engine as t_engine
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import layers as tl
from repro_torch.models import mla as tmla
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as tt
from repro_torch.models.attention_config import use_attention_impl
from repro_torch.models.registry import build, count_params, params_from_jax
from repro_torch.utils.tree import flatten_nested, nested

ARCH = "minicpm3-4b"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = 3e-2  # the reference's bf16 kernel bar
BF16_ULP = 2.0 ** -7
N_DOCS, SEQ, STEPS, BATCH = 48, 16, 12, 16
REMOVED = np.asarray([3, 11, 25, 40], np.int64)
LR = ((0, 0.05),)  # the entry-point test's schedule
DG = dict(period=2, burn_in=4, history_size=2, guard=True, curvature_eps=1e-8)
# mla_apply's and mla_decode's inputs: B, S, d_model, heads
B, S, D, H = 2, 12, 64, 4


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


# -- copies -------------------------------------------------------------------------


def test_config_matches_the_reference_field_by_field():
    ref, port = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(ModelConfig):
        if f.name != "mla":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
            assert getattr(port.reduced(), f.name) == getattr(ref.reduced(), f.name)
    for f in dataclasses.fields(MLAConfig):
        assert getattr(port.mla, f.name) == getattr(ref.mla, f.name), f.name
        assert getattr(port.reduced().mla, f.name) == getattr(ref.reduced().mla, f.name)
        assert getattr(MLAConfig(), f.name) == getattr(JMLAConfig(), f.name), f.name
    assert [f.name for f in dataclasses.fields(MLAConfig)] == \
        [f.name for f in dataclasses.fields(JMLAConfig)]
    assert port.attention == "mla" and port.reduced().mla == MLAConfig(
        q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
        v_head_dim=8)


@pytest.mark.parametrize("layers,n_params", [(62, 4_261_902_848), (2, 501_406_208)])
def test_parameter_counts_match_without_allocating(layers, n_params):
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers)
    assert count_params(cfg) == n_params == j_count_params(
        dataclasses.replace(j_get_config(ARCH), n_layers=layers))
    # per layer: the two norms of the block, the MLA mixer, the SwiGLU FFN
    m, d = cfg.mla, cfg.d_model
    mixer = (d * m.q_lora_rank + m.q_lora_rank + m.q_lora_rank * 40 * 96
             + d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
             + m.kv_lora_rank * 40 * (64 + 64) + 40 * 64 * d)
    outer = 2 * cfg.vocab * d + d
    assert n_params == outer + layers * (2 * d + mixer + 3 * d * cfg.d_ff)


@pytest.fixture(scope="module")
def mla_models():
    jcfg, tcfg = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(1)
    return jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


def test_flat_order_is_ravel_pytree(mla_models):
    jm, tm, jp, tp = mla_models
    assert np.array_equal(tp.flat.numpy(), np.asarray(ravel_pytree(jp)[0]))
    paths = ["/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(tp) == paths
    assert [k for k in tp if k.startswith("u0/mixer/")] == [
        "u0/mixer/kv_norm/scale", "u0/mixer/q_norm/scale", "u0/mixer/w_dkv",
        "u0/mixer/w_dq", "u0/mixer/w_uk", "u0/mixer/w_uq", "u0/mixer/w_uv",
        "u0/mixer/wo"]
    assert tp.numel == count_params(tm.cfg)
    own = tm.init(0, device="cpu")  # the port's own init: the same layout
    assert list(own) == paths and own.shapes == tp.shapes
    assert {k: tuple(v) for k, v in tt.param_shapes(tm.cfg).items()} == \
        {k: tuple(v) for k, v in tp.shapes.items()}
    for k in ("u0/mixer/q_norm/scale", "u0/mixer/kv_norm/scale"):
        assert torch.equal(own[k], torch.ones_like(own[k]))


def test_layout_takes_mla_and_checks_its_config():
    cfg = get_config(ARCH)
    assert tt.layout_of(cfg) == jt.layout_of(j_get_config(ARCH)) == (("attn",), 62)
    for bad in (dataclasses.replace(cfg, mla=None),
                dataclasses.replace(cfg, attention="gqa")):
        with pytest.raises(ValueError, match="MLAConfig"):
            tt.layout_of(bad)
    # the reference's MLA block has no QK-norm, whatever the flag says
    qk = dataclasses.replace(cfg.reduced(), qk_norm=True)
    assert set(tt.param_shapes(qk)) == set(tt.param_shapes(cfg.reduced()))


# -- mla_apply and mla_decode -------------------------------------------------------


def _mla_case(dtype, seed=0):
    jcfg = j_get_config(ARCH).reduced().mla
    tcfg = MLAConfig(**dataclasses.asdict(jcfg))
    jp = jmla.mla_init(jax.random.PRNGKey(seed), D, H, jcfg)
    # norm scales away from 1, so a wrong eps or a dropped scale shows
    rng = np.random.default_rng(seed + 1)
    for k in ("q_norm", "kv_norm"):
        jp[k]["scale"] = jnp.asarray(
            1.0 + 0.3 * rng.normal(size=jp[k]["scale"].shape), jnp.float32)
    jd, td = DTYPES[dtype]
    return (jcfg, tcfg, jax.tree.map(lambda a: a.astype(jd), jp),
            _torch_tree(jp, td), rng)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_apply_matches(dtype):
    jcfg, tcfg, jp, tp, rng = _mla_case(dtype)
    jd, td = DTYPES[dtype]
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    cot = rng.normal(size=(B, S, D)).astype(np.float32)
    kw = dict(n_heads=H, rope_theta=10000.0)

    def j_fn(p, xx):
        out = jmla.mla_apply(p, xx, cfg=jcfg, **kw)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, j_out), j_grads = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x, jd))
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten_nested(tp).items()}
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    t_out = tmla.mla_apply(nested(leaves), tx, cfg=tcfg, **kw)
    loss = (t_out.float() * torch.from_numpy(cot)).sum()
    grads = torch.autograd.grad(loss, [tx] + list(leaves.values()))
    assert t_out.dtype == td and t_out.shape == (B, S, D)
    j_flat = flatten_nested(j_grads[0])
    if dtype == "f32":
        _close(t_out, j_out, 1e-5)
        _close(grads[0], j_grads[1], 1e-5)
        for (name, _), g in zip(leaves.items(), grads[1:]):
            _close(g, j_flat[name], 1e-5)
    else:
        _close(t_out, j_out, BF16_TOL)
        assert float(np.abs(_np(t_out) - _np(j_out)).mean()) < BF16_TOL / 10
        assert _rel(grads[0], j_grads[1]) < 5e-2
        for (name, _), g in zip(leaves.items(), grads[1:]):
            assert g.dtype == td and _rel(g, j_flat[name]) < 5e-2, name


def test_mla_apply_is_causal_and_scaled_by_the_qk_head():
    """A later token changes no earlier output; and the expanded form is
    the plain softmax attention over the padded v at 1/sqrt(nope + rope)."""
    _, cfg, _, p, rng = _mla_case("f32")
    x = torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32))
    y = x.clone()
    y[:, -1] += 1.0
    kw = dict(n_heads=H, cfg=cfg, rope_theta=10000.0)
    a, b = tmla.mla_apply(p, x, **kw), tmla.mla_apply(p, y, **kw)
    assert torch.equal(a[:, :-1], b[:, :-1]) and not torch.equal(a[:, -1], b[:, -1])
    pos = torch.arange(S)
    qn, qr = tmla._project_q(p, x, H, cfg, pos, 10000.0)
    c, kr = tmla._project_kv_latent(p, x, cfg, pos, 10000.0)
    q = torch.cat([qn, qr], -1)
    k = torch.cat([(c @ p["w_uk"]).reshape(B, S, H, -1),
                   kr[:, :, None].expand(B, S, H, -1)], -1)
    v = (c @ p["w_uv"]).reshape(B, S, H, -1)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(16.0)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    _close(a, o.reshape(B, S, -1) @ p["wo"], 1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_decode_matches_step_by_step(dtype):
    jcfg, tcfg, jp, tp, rng = _mla_case(dtype, seed=3)
    jd, td = DTYPES[dtype]
    kw = dict(n_heads=H, rope_theta=10000.0)
    jc = jmla.mla_cache_init(B, 8, jcfg)
    tc = tmla.mla_cache_init(B, 8, tcfg, device="cpu")
    tol = 1e-5 if dtype == "f32" else BF16_TOL
    for t in range(6):
        x = rng.normal(size=(B, 1, D)).astype(np.float32)
        jo, jc = jmla.mla_decode(jp, jnp.asarray(x, jd), jc, cfg=jcfg, **kw)
        c_kv, k_rope = tc["c_kv"], tc["k_rope"]
        to, tc = tmla.mla_decode(tp, torch.from_numpy(x).to(td), tc, cfg=tcfg, **kw)
        assert to.dtype == td and to.shape == (B, 1, D)
        _close(to, jo, tol)
        assert int(tc["len"]) == int(jc["len"]) == t + 1
        assert tc["len"].dtype == torch.int32 and tc["len"].dim() == 0
        # written in place, and only slot t
        assert tc["c_kv"] is c_kv and tc["k_rope"] is k_rope
        assert not tc["c_kv"][:, t + 1:].any() and tc["c_kv"][:, t].any()
    for k in ("c_kv", "k_rope"):
        assert tc[k].dtype == torch.bfloat16 and jc[k].dtype == jnp.bfloat16
        if dtype == "f32":
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), rtol=BF16_ULP, atol=0)
        else:
            _close(tc[k], jc[k], BF16_TOL)


def test_decode_cache_structure_matches(mla_models):
    jm, tm, _, _ = mla_models
    jc, tc = jm.cache_init(3, 10), tm.cache_init(3, 10, device="cpu")
    assert list(tc) == list(jc) == ["u0"]
    assert sorted(tc["u0"]) == sorted(jc["u0"]) == ["c_kv", "k_rope", "len"]
    for k in ("c_kv", "k_rope", "len"):
        assert tuple(tc["u0"][k].shape) == jc["u0"][k].shape
        assert str(tc["u0"][k].dtype).split(".")[-1] == str(jc["u0"][k].dtype)
        assert not tc["u0"][k].any()
    # the latent cache: kv_lora + rope values a position a layer
    assert tc["u0"]["c_kv"].shape[-1] + tc["u0"]["k_rope"].shape[-1] == 24


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_and_stepped_decode_match(mla_models, dtype):
    """The expanded prefill against the stepped absorbed decode of the same
    tokens, in each package, and each against the other package's."""
    jm, tm, jp, tp = mla_models
    jd, td = DTYPES[dtype]
    toks = np.random.default_rng(0).integers(0, 256, size=(B, 10), dtype=np.int32)
    jc, tc = jm.cache_init(B, 10), tm.cache_init(B, 10, device="cpu")
    jdec = jax.jit(lambda p, b, c: jm.decode_fn(p, b, c, dtype=jd))
    for t in range(10):
        jlog, jc = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
        tlog, tc = tm.decode_fn(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                tc, dtype=td)
        assert tlog.dtype == torch.float32 and tlog.shape == (B, 256)
        _close(tlog, jlog, 1e-4 if dtype == "f32" else 2 * BF16_TOL)
    assert tc["u0"]["len"].tolist() == [10] * tm.cfg.n_layers
    tpre = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, dtype=td)
    jpre = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, dtype=jd)
    _close(tpre, jpre, 1e-5 if dtype == "f32" else BF16_TOL)
    t_gap = float(np.abs(_np(tpre) - _np(tlog)).max())
    j_gap = float(np.abs(_np(jpre) - _np(jlog)).max())
    if dtype == "f32":
        assert j_gap > 0  # the bf16 latent cache parts the pair in both
        assert t_gap <= j_gap + 1e-5, (t_gap, j_gap)
    else:
        assert t_gap <= j_gap + 2 * BF16_TOL, (t_gap, j_gap)


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
    jm = j_build(j_get_config(ARCH).reduced())
    jp = jm.init(1)
    jb = {"tokens": jnp.asarray(_docs().columns["tokens"][:8])}
    jd = DTYPES[dtype][0]
    jo = _jax_objective(jm, jd if dtype == "f32" else None)
    w = jnp.asarray(np.linspace(0.0, 1.0, 8).astype(np.float32))
    loss, grad = jo.make_value_grad_fn()(jp, jb, w)
    batch = jm.loss_fn(jp, jb, dtype=jd, remat=False, loss_chunk=SEQ)
    return jo.per_example_loss(jp, jb), loss, ravel_pytree(grad)[0], batch


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("remat", [False, True])
def test_losses_and_objective_match(mla_models, dtype, remat):
    _, tm, _, tp = mla_models
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
    # a dense FFN: the batch loss is the mean of the rows, and no aux term
    ce, aux = tt.lm_loss_terms(tp, tb, tm.cfg, remat=remat, loss_chunk=SEQ, dtype=td)
    assert float(aux) == 0.0 and torch.equal(ce, t_batch)
    assert abs(float(t_rows.mean()) - float(t_batch)) < 1e-5


def test_flash_switch_never_reaches_flash_attention(mla_models, monkeypatch):
    """MLA calls blockwise attention directly (the reference's
    mla.py:79): under ``attn_impl="flash"`` the objective, its gradient
    and `prefill_fn` make no call to `FlashAttention` or to the flash
    wrapper, and equal the blockwise ones bitwise."""
    _, tm, _, tp = mla_models
    calls = []
    apply = tl.FlashAttention.apply
    attention = tl.flash_ops.attention
    monkeypatch.setattr(tl.FlashAttention, "apply",
                        lambda *a: calls.append("apply") or apply(*a))
    monkeypatch.setattr(tl.flash_ops, "attention",
                        lambda *a, **k: calls.append("kernel") or attention(*a, **k))
    tb = {"tokens": torch.from_numpy(_docs().columns["tokens"][:4])}
    w = torch.ones(4)
    got = {}
    for impl in ("flash", "blockwise"):
        obj = tm.objective(loss_chunk=SEQ, attn_impl=impl)
        with use_attention_impl(impl):
            pre = tm.prefill_fn(tp, tb)
        got[impl] = (obj.per_example_loss(tp, tb), obj.make_grad_fn()(tp, tb, w), pre)
    assert calls == []
    for a, b in zip(got["flash"], got["blockwise"]):
        assert torch.equal(a, b)
    # the switch does reach flash on a GQA model (the count above can see it)
    gqa = build(get_config("internlm2-1.8b").reduced())
    with use_attention_impl("flash"):
        gqa.prefill_fn(gqa.init(0, device="cpu"), tb)
    assert calls.count("apply") == calls.count("kernel") == gqa.cfg.n_layers


# -- the slice as a whole, f32 --------------------------------------------------------


# lr 0.05 is tests/test_torch_moe.py's recipe: on this model both packages'
# approx steps grow w^I - w there (d_ui/d_us 124 in each), and a replay that
# diverges multiplies the packages' ~4e-7 training gap (the reference's own
# scan and python replays part by 5.3e-6); so that replay is held to the
# counters and to d_ui alike, 1e-2 relative, and the parameters at 1e-5 where
# the replay converges (lr 0.01: d_ui/d_us 0.60 in both)
@pytest.mark.parametrize("lr,converges", [(0.01, True), (0.05, False)],
                         ids=["lr0.01", "lr0.05"])
def test_slice_matches_jax_in_f32(mla_models, lr, converges):
    jm, tm, jp, tp = mla_models
    kw = dict(n=N_DOCS, batch_size=BATCH, seed=5, steps=STEPS, lr_schedule=((0, lr),))
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
    for k, v in st.counters().items():
        assert v == getattr(jst, k), (k, st.counters(), jst)
    assert st.approx_steps > 0 and st.explicit_steps > 0
    for t, j in ((w_star, jw_star), (w_u, jw_u)) + (((w_i, jw_i),) if converges else ()):
        assert _rel(t.flat, ravel_pytree(j)[0]) <= 1e-5
    flat = [np.asarray(ravel_pytree(t)[0], np.float64) for t in (jw_star, jw_u, jw_i)]
    j_ui, j_us = np.linalg.norm(flat[1] - flat[2]), np.linalg.norm(flat[1] - flat[0])
    t_ui = float((w_u.flat - w_i.flat).double().norm())
    t_us = float((w_u.flat - w_star.flat).double().norm())
    assert abs(t_us - j_us) <= 1e-5 * j_us and abs(t_ui - j_ui) <= 1e-2 * j_ui
    assert (t_ui < t_us) == (j_ui < j_us) == converges


# -- phase 16 (d)'s recipe --------------------------------------------------------------
# chip_smoke.py's DeltaGrad recipe on minicpm3-4b (phase 9's: lr 0.01, T 12, T0
# 4, j0 6, m 2, the guard; 128 documents, B 32, 4 rows deleted), f32 compute,
# at 2 layers of the published layout cut in width: d_model d, d / 64 heads
# of the published head dims (qk 64 + 32, v 64), the ranks and d_ff scaled
# by d / 2560, vocab 4096.  Run as a script, this prints both packages'
# d_ui/d_us at larger widths: PYTHONPATH=src python tests/test_torch_mla.py 64,32 256,128
RECIPE = dict(docs=128, batch=32, steps=12, lr=0.01, removed=[3, 42, 81, 120],
              dg=dict(period=4, burn_in=6, history_size=2, guard=True,
                      curvature_eps=1e-8))


def _recipe_run(d, S, dtype="f32", seed=0):
    """Train -> BaseL -> replay in both packages on the same JAX init, at
    the compute `dtype` (bf16: the card's phase 16 (d)), the init and the
    documents drawn from `seed`: {package: (d_ui, d_us, counters)}, the
    port's ||Bv||/||v|| per B v, and the two replays' max |gap|."""
    jfull = j_get_config(ARCH)
    jm_cfg = dataclasses.replace(jfull.mla, q_lora_rank=768 * d // 2560,
                                 kv_lora_rank=256 * d // 2560)
    kw = dict(n_layers=2, d_model=d, n_heads=d // 64, n_kv_heads=d // 64,
              d_ff=6400 * d // 2560, vocab=4096)
    jcfg = dataclasses.replace(jfull, **kw, mla=jm_cfg)
    tcfg = dataclasses.replace(get_config(ARCH), **kw,
                               mla=MLAConfig(**dataclasses.asdict(jm_cfg)))
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


def test_phase16_recipe_replays_alike():
    """Both packages take the same steps and land alike, below d_us (on
    the CPU: d_ui/d_us 0.305, 0.0832, 0.0236 at d_model 64, 128, 256)."""
    out, _, gap = _recipe_run(64, 32)
    (j_ui, j_us, jc), (t_ui, t_us, tc) = out["jax"], out["port"]
    assert tc == jc and tc["approx_steps"] == 4
    assert abs(t_us - j_us) <= 1e-5 * j_us and abs(t_ui - j_ui) <= 1e-2 * j_ui
    assert t_ui < t_us and j_ui < j_us and gap <= 1e-5


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
            "--seq", "16", "--log-every", "1"]
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
    docs = token_stream(8, 8, 256, seed=0)
    meta = TMeta(n=8, batch_size=4, seed=0, steps=2, lr_schedule=LR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdg.sgd_train_with_cache(model.objective(), p0, docs, meta)
    assert model.cache_init(2, 4, device="cpu")["u0"]["c_kv"].device.type == "cpu"


if __name__ == "__main__":
    # each argument d,S[,dtype[,seeds]]: the recipe at d_model d and S tokens
    # a document, over seeds 0 .. seeds - 1, then how many replays of each
    # package missed d_ui < d_us and in how many draws the counters agreed
    for spec in sys.argv[1:]:
        d, S, *rest = spec.split(",")
        dtype, seeds = (rest + ["f32"])[0], int((rest + ["f32", "1"])[1])
        misses, agree = {"jax": 0, "port": 0}, 0
        for seed in range(seeds):
            out, ratios, gap = _recipe_run(int(d), int(S), dtype, seed)
            agree += out["jax"][2] == out["port"][2]
            for k, v in out.items():
                misses[k] += not v[0] < v[1]
            print(f"{ARCH} 2 layers d_model {d} S {S} {dtype} seed {seed}: " + "; ".join(
                f"{k} d_ui {v[0]:.6e} d_us {v[1]:.6e} d_ui/d_us {v[0] / v[1]:.4e}"
                for k, v in out.items())
                + f"; counters equal: {out['jax'][2] == out['port'][2]} port "
                f"{out['port'][2]} jax {out['jax'][2]}; port ||Bv||/||v|| "
                + " ".join(f"{r:.4e}" for r in ratios)
                + f"; max |w_I gap| {gap:.3e}", flush=True)
        print(f"{ARCH} d_model {d} S {S} {dtype}, {seeds} seeds: d_ui/d_us >= 1 in "
              f"{misses['jax']} (jax) and {misses['port']} (port); counters equal "
              f"in {agree}", flush=True)
