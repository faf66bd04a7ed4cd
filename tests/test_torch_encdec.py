"""The port's encoder-decoder family (Whisper) against the JAX package on
the CPU, module by module.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart at the reference's reduced whisper-large-v3
(``ModelConfig.reduced()``: 2 encoder + 2 decoder layers, d_model 64, 4
heads of 16, d_ff 128, vocab 256), with the JAX weights carried across
(`params_from_jax`).  Tolerances:

  * copies (the config, `ShapeConfig`, parameter counts and key order,
    cache structure, `input_specs`): exact;
  * f32 compute: 1e-5 (sums taken in another order); bf16 compute: the
    reference's kernel bar, 3e-2 elementwise, on the modules' outputs;
  * the bf16 cross K/V of `fill_cross_caches` in f32 compute: one bf16 ulp
    (2^-7 relative), since an f32 value near a bf16 tie may round the
    other way;
  * the stepped decode's logits and its self-attention caches: f32 1e-3
    (the bf16 caches' flips move a logit by up to ~1e-3), bf16 6e-2,
    twice the kernel bar;
  * `prefill` against the stepped decode of the same prompt, in each
    package: the port's gap within the reference's own plus the bar;
  * the flash route: the port's plain flash against the reference's flash
    in interpret mode, 1e-5 (f32) and 3e-2 (bf16), and each against its
    own blockwise attention at the same bars.

The objective, the replay and the entry points are in
``tests/test_torch_encdec_slice.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.registry import get_config as j_get_config
from repro.models import attention_config as j_attn
from repro.models import encdec as je
from repro.models import transformer as jt
from repro.models.registry import build as j_build
from repro.models.registry import count_params as j_count_params

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import encdec as te
from repro_torch.models import transformer as tt
from repro_torch.models.attention_config import use_attention_impl
from repro_torch.models.registry import (EncDecModel, build, count_params,
                                         params_from_jax, params_to_numpy)
from repro_torch.utils.tree import key_order, nested

ARCH = "whisper-large-v3"
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
BF16_ULP = 2.0 ** -7
B, S_ENC, S = 2, 48, 16


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread per test: the suite runs its files in
    several worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models():
    jm = j_build(j_get_config(ARCH).reduced())
    jp = jm.init(1)
    return jm, build(get_config(ARCH).reduced()), jp, params_from_jax(
        jax.device_get(jp), "cpu")


@functools.lru_cache(maxsize=None)
def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, S_ENC, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, size=(B, S), dtype=np.int32)
    return frames, tokens


def _cast(tree, dtype):
    return jax.tree.map(lambda x: x.astype(dtype) if x.dtype == jnp.float32 else x,
                        tree)


def _layer(tree, u):
    return jax.tree.map(lambda x: x[u], tree)


# -- copies ---------------------------------------------------------------------------


def test_config_matches_the_reference_field_by_field():
    ref, port = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert getattr(port.reduced(), f.name) == getattr(ref.reduced(), f.name), f.name
    assert port.head_dim == ref.head_dim == 64
    assert port.reduced().n_encoder_layers == 2
    assert get_config("internlm2-1.8b").reduced().n_encoder_layers == 0


def test_shape_config_matches_the_reference():
    assert [f.name for f in dataclasses.fields(ShapeConfig)] == \
        [f.name for f in dataclasses.fields(JShapeConfig)]
    for kind in ("train", "prefill", "decode", "long_decode"):
        args = ("c", 128, 4, kind)
        assert ShapeConfig(*args).is_decode == JShapeConfig(*args).is_decode


@pytest.mark.parametrize("layers,n_params", [(None, 1_600_990_720), (2, 224_542_720)])
def test_parameter_counts_match_without_allocating(layers, n_params):
    cfg, ref = get_config(ARCH), j_get_config(ARCH)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers, n_encoder_layers=layers)
        ref = dataclasses.replace(ref, n_layers=layers, n_encoder_layers=layers)
    assert count_params(cfg) == n_params == j_count_params(ref)


def test_flat_order_and_init_match_the_reference_layout():
    jm, tm, jp, tp = _models()
    assert isinstance(tm, EncDecModel)
    j_flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    j_keys = ["/".join(k.key for k in path) for path, _ in j_flat]
    assert list(tp) == j_keys == key_order(te.param_shapes(tm.cfg))
    for (_, x), k in zip(j_flat, j_keys):
        assert tuple(tp[k].shape) == x.shape == te.param_shapes(tm.cfg)[k]
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    # the port's own init: same layout, the reference's constants
    mine = tm.init(0, device="cpu")
    assert list(mine) == list(tp) and mine.numel == tp.numel
    for k in ("enc_norm/scale", "final_norm/scale", "enc/ln1/scale", "dec/ln_x/scale"):
        assert torch.equal(mine[k], torch.ones_like(mine[k]))
    assert abs(float(mine["embed"].std()) - 0.02) < 2e-3
    assert abs(float(mine["dec/cross/wk"].std()) - 64 ** -0.5) < 1e-2
    assert torch.equal(mine.flat, tm.init(0, device="cpu").flat)


def test_cache_structure_matches():
    jm, tm, _, _ = _models()
    jc = jm.cache_init(3, 10, enc_len=7)
    tc = tm.cache_init(3, 10, enc_len=7, device="cpu")
    assert sorted(tc) == sorted(jc) == ["cross_k", "cross_v", "self"]
    assert sorted(tc["self"]) == sorted(jc["self"]) == ["k", "len", "v"]
    for t, j in [(tc["self"][k], jc["self"][k]) for k in ("k", "v", "len")] + [
            (tc[k], jc[k]) for k in ("cross_k", "cross_v")]:
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
        assert not t.any()
    assert tuple(tc["cross_k"].shape) == (2, 3, 7, 4, 16)
    assert tm.cache_init(3, 10, device="cpu")["cross_v"].shape[2] == 1500


@pytest.mark.parametrize("kind,seq", [("train", 24), ("decode", 24)])
@pytest.mark.parametrize("arch,frontend", [(ARCH, None), ("internlm2-1.8b", None),
                                           ("internlm2-1.8b", "frames")])
def test_input_specs_and_sample_batch_match(arch, frontend, kind, seq):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    if frontend:
        jcfg = dataclasses.replace(jcfg, frontend=frontend)
        tcfg = dataclasses.replace(tcfg, frontend=frontend)
    jm, tm = j_build(jcfg), build(tcfg)
    shape, jshape = ShapeConfig("c", seq, 3, kind), JShapeConfig("c", seq, 3, kind)
    js, ts = jm.input_specs(jshape), tm.input_specs(shape)
    assert list(ts) == list(js)
    for k, (s, dtype) in ts.items():
        assert s == js[k].shape and str(dtype)[6:] == str(js[k].dtype)
    jb, tb = jm.sample_batch(jshape, seed=3), tm.sample_batch(shape, seed=3, device="cpu")
    for k, t in tb.items():
        j = np.asarray(jnp.asarray(jb[k], jnp.float32))
        assert tuple(t.shape) == j.shape and t.dtype == ts[k][1]
        if t.dtype == torch.int32:
            assert np.array_equal(t.numpy(), j)
        else:  # N(0, 1) from the same numpy draws, rounded to bf16
            np.testing.assert_allclose(t.float().numpy(), j, rtol=BF16_ULP, atol=0)


# -- the modules ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cross_apply_matches(dtype):
    """Sq 16 against Sk 600: the keys pad to two blocks of 512, and the 424
    padded keys stay masked."""
    jm, tm, jp, tp = _models()
    jd, td, tol = DTYPES[dtype]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    mem = rng.normal(size=(B, 600, 64)).astype(np.float32)
    jc = _cast(_layer(jp["dec"]["cross"], 1), jd)
    tc = tt.cast_params(tt._slice(nested(tp)["dec"]["cross"], 1), td)
    j_out = je._cross_apply(jc, jnp.asarray(x, jd), jnp.asarray(mem, jd), jm.cfg)
    t_out = te._cross_apply(tc, torch.from_numpy(x).to(td),
                            torch.from_numpy(mem).to(td), tm.cfg)
    assert t_out.dtype == td and t_out.shape == (B, S, 64)
    _close(t_out, j_out, tol)
    # the padding is masked: a dense softmax over the 600 keys alone
    xq, xm = torch.from_numpy(x).double(), torch.from_numpy(mem).double()
    w = {k: v.double() for k, v in tc.items()}
    q = (xq @ w["wq"]).reshape(B, S, 4, 16).transpose(1, 2)
    k = (xm @ w["wk"]).reshape(B, 600, 4, 16).transpose(1, 2)
    v = (xm @ w["wv"]).reshape(B, 600, 4, 16).transpose(1, 2)
    o = torch.softmax(q @ k.transpose(-1, -2) / 4.0, dim=-1) @ v
    dense = o.transpose(1, 2).reshape(B, S, 64) @ w["wo"]
    _close(t_out, dense, tol)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_and_decode_train_match(dtype, remat):
    jm, tm, jp, tp = _models()
    jd, td, tol = DTYPES[dtype]
    frames, tokens = _inputs()
    jc, tc = jt.cast_params(jp, jd), tt.cast_params(nested(tp), td)
    j_mem = je.encode(jc, jnp.asarray(frames, jd), jm.cfg, remat=remat)
    t_mem = te.encode(tc, torch.from_numpy(frames).to(td), tm.cfg, remat=remat)
    _close(t_mem, j_mem, tol)
    j_x = jc["embed"][jnp.asarray(tokens)].astype(jd)
    t_x = tc["embed"][torch.from_numpy(tokens).long()].to(td)
    j_h = je.decode_train(jc, j_x, j_mem, jm.cfg, remat=remat)
    t_h = te.decode_train(tc, t_x, t_mem, tm.cfg, remat=remat)
    assert t_h.dtype == td and t_h.shape == (B, S, 64)
    _close(t_h, j_h, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decoder_self_attention_takes_flash(dtype):
    """Under the flash switch the decoder's causal self-attention is the
    flash kernel (the port's plain version here on the CPU, the reference's
    Pallas kernel in interpret mode); the encoder and the cross-attention
    stay blockwise."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    jm, tm, jp, tp = _models()
    jd, td, tol = DTYPES[dtype]
    frames, tokens = _inputs()
    jc, tc = jt.cast_params(jp, jd), tt.cast_params(nested(tp), td)
    j_mem = je.encode(jc, jnp.asarray(frames, jd), jm.cfg)
    t_mem = te.encode(tc, torch.from_numpy(frames).to(td), tm.cfg)
    j_x = jc["embed"][jnp.asarray(tokens)].astype(jd)
    t_x = tc["embed"][torch.from_numpy(tokens).long()].to(td)
    calls = []
    attention = flash_ops.attention

    def counting(*a, **k):
        calls.append(a[0].shape)
        return attention(*a, **k)

    flash_ops.attention = counting
    try:
        with use_attention_impl("flash"):
            t_h = te.decode_train(tc, t_x, t_mem, tm.cfg)
            te.encode(tc, torch.from_numpy(frames).to(td), tm.cfg)
    finally:
        flash_ops.attention = attention
    assert calls == [(B, S, 4, 16)] * tm.cfg.n_layers
    prev = j_attn.set_attention_impl("flash")
    try:
        j_h = je.decode_train(jc, j_x, j_mem, jm.cfg)
    finally:
        j_attn.set_attention_impl(prev)
    _close(t_h, j_h, tol)
    _close(t_h, te.decode_train(tc, t_x, t_mem, tm.cfg), tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_fill_and_stepped_decode_match(dtype):
    """`prefill` against the reference's; `encode` -> `fill_cross_caches`
    -> `decode_step` over the prompt against the reference's, step by
    step; and each package's prefill-to-stepped gap (the cross and self
    caches hold bf16, so the gap is the reference's design in f32 too)."""
    jm, tm, jp, tp = _models()
    jd, td, tol = DTYPES[dtype]
    frames, tokens = _inputs()
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}
    j_pre = jm.prefill_fn(jp, jb, dtype=jd)
    t_pre = tm.prefill_fn(tp, tb, dtype=td)
    assert t_pre.dtype == torch.float32 and t_pre.shape == (B, 256)
    _close(t_pre, j_pre, tol)

    j_mem = je.encode(jt.cast_params(jp, jd), jb["frames"].astype(jd), jm.cfg)
    t_mem = te.encode(tt.cast_params(nested(tp), td), tb["frames"].to(td), tm.cfg)
    # the uncast f32 weights times the memory, then bf16
    jk, jv = je.fill_cross_caches(jp, j_mem, jm.cfg)
    tk, tv = te.fill_cross_caches(tp, t_mem, tm.cfg)
    for t, j in ((tk, jk), (tv, jv)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape == (2, B, S_ENC, 4, 16)
        if dtype == "f32":
            np.testing.assert_allclose(_np(t), _np(j), rtol=BF16_ULP, atol=0)
        else:
            _close(t, j, tol)
    jc = {**jm.cache_init(B, S, enc_len=S_ENC), "cross_k": jk, "cross_v": jv}
    tc = tm.cache_init(B, S, enc_len=S_ENC, device="cpu")
    tc["cross_k"], tc["cross_v"] = tk, tv
    jdec = jax.jit(lambda p, b, c: jm.decode_fn(p, b, c, dtype=jd))
    step_tol = 1e-3 if dtype == "f32" else 2 * tol
    for t in range(S):
        j_log, jc = jdec(jp, {"tokens": jb["tokens"][:, t:t + 1]}, jc)
        t_log, tc = tm.decode_fn(tp, {"tokens": tb["tokens"][:, t:t + 1]}, tc, dtype=td)
        assert t_log.dtype == torch.float32 and t_log.shape == (B, 256)
        _close(t_log, j_log, step_tol)
    assert tc["self"]["len"].tolist() == [S, S] and tc["cross_k"] is tk
    for k in ("k", "v"):
        if dtype == "f32":
            # the k, v of later steps carry the cross caches' flips too
            np.testing.assert_allclose(_np(tc["self"][k]), _np(jc["self"][k]),
                                       rtol=BF16_ULP, atol=step_tol)
        else:
            _close(tc["self"][k], jc["self"][k], tol)
    j_gap = float(np.abs(_np(j_pre) - _np(j_log)).max())
    t_gap = float(np.abs(_np(t_pre) - _np(t_log)).max())
    assert 0 < j_gap and t_gap <= j_gap + step_tol, (t_gap, j_gap)


def test_decode_step_keeps_the_rows_apart():
    """Row i's logits do not depend on the other rows (the decode
    attention and the cross-attention read row i's caches only)."""
    _, tm, _, tp = _models()
    frames, tokens = _inputs()
    logits = []
    for rows in (slice(0, 2), slice(1, 2)):
        mem = te.encode(tt.cast_params(nested(tp), torch.float32),
                        torch.from_numpy(frames[rows]), tm.cfg)
        c = tm.cache_init(frames[rows].shape[0], 4, enc_len=S_ENC, device="cpu")
        c["cross_k"], c["cross_v"] = te.fill_cross_caches(tp, mem, tm.cfg)
        for t in range(4):
            out, c = tm.decode_fn(tp, {"tokens": torch.from_numpy(tokens[rows, t:t + 1])},
                                  c, dtype=torch.float32)
        logits.append(out[-1])
    _close(logits[0], logits[1], 1e-5)


# -- the decoder-only frames frontend -------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_frames_frontend_lm_loss_matches(dtype):
    """A decoder-only stack fed frame embeddings (``frontend="frames"``):
    `_embed` takes the frames, the loss the batch's targets (the last
    position masked), in `lm_loss` and per row."""
    jd, td, tol = DTYPES[dtype]
    jcfg = dataclasses.replace(j_get_config("internlm2-1.8b").reduced(), frontend="frames")
    tcfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), frontend="frames")
    jm, tm = j_build(jcfg), build(tcfg)
    assert tt.layout_of(tcfg) == jt.layout_of(jcfg)
    jp = jm.init(2)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(5)
    frames = rng.normal(size=(3, 20, 64)).astype(np.float32)
    targets = rng.integers(0, 256, size=(3, 20), dtype=np.int32)
    j_loss = jm.loss_fn(jp, {"frames": jnp.asarray(frames), "targets": jnp.asarray(targets)},
                        dtype=jd, remat=False, loss_chunk=8)
    tb = {"frames": torch.from_numpy(frames), "targets": torch.from_numpy(targets)}
    t_loss = tm.loss_fn(tp, tb, dtype=td, remat=False, loss_chunk=8)
    assert abs(float(t_loss) - float(j_loss)) <= (1e-5 if dtype == "f32" else 5e-3)
    rows = tm.per_row_loss_fn(tp, tb, dtype=td, remat=False, loss_chunk=8)
    for i in range(3):
        one = jm.loss_fn(jp, {"frames": jnp.asarray(frames[i:i + 1]),
                              "targets": jnp.asarray(targets[i:i + 1])},
                         dtype=jd, remat=False, loss_chunk=8)
        assert abs(float(rows[i]) - float(one)) <= (1e-5 if dtype == "f32" else 5e-3)
    # the last position's target is masked, as in the reference
    moved = targets.copy()
    moved[:, -1] = (moved[:, -1] + 1) % 256
    again = tm.loss_fn(tp, {**tb, "targets": torch.from_numpy(moved)}, dtype=td,
                       remat=False, loss_chunk=8)
    assert float(again) == float(t_loss)
