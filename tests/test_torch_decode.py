"""The port's LM decode path against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart, at each dense config's ``reduced()`` widths (2
layers, d_model 64, 4 heads, d_head 16, vocab 256), with the JAX weights
carried across (`params_from_jax`).  Tolerances:

  * copies (configs, full-size parameter counts, cache structure): exact;
  * f32 compute: 1e-5 (sums taken in another order).  The KV caches are
    bf16 in both packages, so an f32 decode stores k and v rounded to
    bf16: a value near a bf16 tie may round the other way, so the caches
    are held to one bf16 ulp (2^-7 relative) and the logits at 1e-4;
  * bf16 compute: the reference's kernel bar, 3e-2 elementwise (relative
    and absolute), on prefill's logits and the caches; the logits of ten
    decode steps in turn at twice it, 6e-2, and 1e-2 on their mean |gap|
    (a bf16 rounding of the hidden state that goes the other way moves a
    logit by up to ~3.5e-2, as far as the reference's own prefill and
    stepped decode part);
  * flash's plain version against blockwise under `prefill`: 3e-2;
  * `prefill` against the last stepped `decode_step` of the same prompt
    (two bf16 programs that round at different places): 6e-2
    elementwise, twice the bar, and 1e-2 on the mean |gap|; the JAX
    package's own prefill and stepped decode are held to the same bar;
  * greedy tokens: equal, or the first token that differs comes at a
    step whose top-2 logit margin is below 6e-2 (a bf16 near-tie, where
    logits each within the bar may order the other way).
"""

import ast
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig as JMLAConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.configs.base import XLSTMConfig as JXLSTMConfig
from repro.configs.registry import get_config as j_get_config
from repro.launch import serve as j_serve
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.models.registry import build as j_build
from repro.models.registry import count_params as j_count_params

from repro_torch.configs.base import MLAConfig, ModelConfig, SSMConfig, XLSTMConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as tl
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as tt
from repro_torch.models.attention_config import use_attention_impl
from repro_torch.models.registry import build, count_params, params_from_jax

ARCHS = ["internlm2-1.8b", "qwen3-32b", "nemotron-4-15b", "chameleon-34b"]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
BF16_TOL = 3e-2
NEAR_TIE = 6e-2  # two bf16 programs' logits, each within BF16_TOL
F32_CACHE_TOL = 1e-4
BF16_ULP = 2.0 ** -7


def _close_cache(t, j, dtype):
    if dtype == "bf16":
        _close(t, j, BF16_TOL)
    else:
        np.testing.assert_allclose(_np(t), _np(j), rtol=BF16_ULP, atol=0)
PROMPT, GEN, BATCH = 6, 4, 2


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _pair(x, dtype):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _models(arch):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(0)
    return jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


# -- copies -------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_the_reference_field_by_field(arch):
    ref, port = j_get_config(arch), get_config(arch)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert getattr(port.reduced(), f.name) == getattr(ref.reduced(), f.name)
    assert port.head_dim == ref.head_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_parameter_counts_match(arch):
    """`param_shapes` allocates nothing; the reference counts by
    ``eval_shape``."""
    cfg = get_config(arch)
    assert count_params(cfg) == j_count_params(j_get_config(arch))
    shapes = tt.param_shapes(cfg)
    assert ("u0/mixer/q_norm/scale" in shapes) == cfg.qk_norm
    assert ("u0/mlp/w_gate" in shapes) == (cfg.mlp == "swiglu")


@pytest.mark.parametrize("change,ported,layout", [  # the letters of item 9 ported since
    pytest.param(dict(attention="mla"), (dict(mla=MLAConfig()), dict(mla=JMLAConfig())),
                 (("attn",), 6), id="change1-9b"),
    pytest.param(dict(family="hybrid", layout_unit=("mamba2",) * 5 + ("attn_shared",)),
                 (dict(ssm=SSMConfig()), dict(ssm=JSSMConfig())),
                 (("mamba2",) * 5 + ("attn_shared",), 1), id="change2-9c"),
    pytest.param(dict(family="ssm", layout_unit=("mlstm", "slstm"), mlp="none"),
                 (dict(xlstm=XLSTMConfig()), dict(xlstm=JXLSTMConfig())),
                 (("mlstm", "slstm"), 3), id="change3-9d"),
    pytest.param(dict(family="audio", frontend="frames", mlp="gelu",
                      n_encoder_layers=2), ({}, {}), None, id="change4-9e"),
])
def test_layout_takes_the_ported_families(change, ported, layout):
    """A family once refused by `layout_of` is taken now, and agrees with
    the reference: the layout, the built model's config, the count.  An
    xLSTM unit (9d) raises only without its XLSTMConfig; the
    encoder-decoder family (9e) is what `build` gives as the enc-dec model
    (`models.encdec`, with the reference's parameter count), and
    `layout_of` sends it there."""
    bare = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=6, **change)
    cfg = dataclasses.replace(bare, **ported[0])
    ref = dataclasses.replace(j_get_config("internlm2-1.8b"), n_layers=6, **change,
                              **ported[1])
    if "xlstm" in ported[0]:
        with pytest.raises(ValueError, match="XLSTMConfig"):
            tt.layout_of(bare)
        with pytest.raises(ValueError, match="XLSTMConfig"):
            build(bare)
    if layout is None:
        model = build(cfg)
        assert isinstance(model, t_registry.EncDecModel) and model.cfg == cfg
        assert count_params(cfg) == j_count_params(ref)
        with pytest.raises(ValueError, match=r"models\.encdec"):
            tt.layout_of(cfg)
        return
    assert tt.layout_of(cfg) == jt.layout_of(ref) == layout
    assert build(cfg).cfg == cfg
    assert count_params(cfg) == j_count_params(ref)


@pytest.mark.parametrize("arch", ARCHS + ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b",
                                          "minicpm3-4b"])
def test_layout_takes_every_gqa_token_decoder(arch):
    cfg = get_config(arch)
    assert tt.layout_of(cfg) == jt.layout_of(j_get_config(arch)) == (("attn",), cfg.n_layers)


# -- layers -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cache_len,window", [(1, 0), (5, 0), (8, 0), (7, 3)])
def test_decode_attention_matches(dtype, cache_len, window):
    rng = np.random.default_rng(cache_len * 10 + window)
    q = _rand(rng, 2, 4, 16)
    k, v = _rand(rng, 2, 8, 2, 16), _rand(rng, 2, 8, 2, 16)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    got = tl.decode_attention(tq, tk, tv, torch.tensor(cache_len, dtype=torch.int32),
                              window=window)
    want = jl.decode_attention(jq, jk, jv, jnp.int32(cache_len), window=window)
    assert got.dtype == tq.dtype and got.shape == (2, 4, 16)
    _close(got, want, DTYPES[dtype][2])


def _gqa_weights(rng, qk_norm):
    w = {"wq": _rand(rng, 32, 32, scale=0.18), "wk": _rand(rng, 32, 16, scale=0.18),
         "wv": _rand(rng, 32, 16, scale=0.18), "wo": _rand(rng, 32, 32, scale=0.18)}
    if qk_norm:
        w["q_norm"] = {"scale": _rand(rng, 8) + 1.0}
        w["k_norm"] = {"scale": _rand(rng, 8) + 1.0}
    return w


def _tree(w, f):
    return {k: _tree(v, f) if isinstance(v, dict) else f(v) for k, v in w.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("size,window", [(8, 0), (8, 3), (4, 4)],
                         ids=["full", "full_windowed", "ring"])
def test_gqa_decode_matches(dtype, qk_norm, size, window):
    """Six tokens in turn: a full cache, a full cache under a window mask,
    and a ring buffer of `window` slots that wraps around."""
    rng = np.random.default_rng(size + window + qk_norm)
    w = _gqa_weights(rng, qk_norm)
    jw = _tree(w, lambda x: _pair(x, dtype)[0])
    tw = _tree(w, lambda x: _pair(x, dtype)[1])
    kw = dict(n_heads=4, n_kv=2, d_head=8, rope_theta=1e6, window=window,
              qk_norm=qk_norm)
    jc = jl.gqa_cache_init(2, size, 2, 8)
    tc = tl.gqa_cache_init(2, size, 2, 8, device="cpu")
    tol = DTYPES[dtype][2] if dtype == "bf16" else F32_CACHE_TOL
    for t in range(6):
        jx, tx = _pair(_rand(rng, 2, 1, 32), dtype)
        jo, jc = jl.gqa_decode(jw, jx, jc, **kw)
        to, tc = tl.gqa_decode(tw, tx, tc, **kw)
        _close(to, jo, tol)
        assert int(tc["len"]) == int(jc["len"]) == t + 1
        assert tc["len"].dtype == torch.int32 and tc["len"].dim() == 0
    _close_cache(tc["k"], jc["k"], dtype)
    _close_cache(tc["v"], jc["v"], dtype)


# -- the model ------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_structure_matches(arch, window):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), attn_window=window)
    tcfg = dataclasses.replace(get_config(arch).reduced(), attn_window=window)
    jc, tc = jt.init_caches(jcfg, 3, 10), tt.init_caches(tcfg, 3, 10, device="cpu")
    assert list(tc) == list(jc) == ["u0"]
    for k in ("k", "v", "len"):
        assert tuple(tc["u0"][k].shape) == jc["u0"][k].shape
        assert str(tc["u0"][k].dtype).split(".")[-1] == str(jc["u0"][k].dtype)
        assert not tc["u0"][k].any()


def _prompt(vocab, n=PROMPT + GEN, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(BATCH, n),
                                                dtype=np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_and_prefill_match(arch, dtype):
    jm, tm, jp, tp = _models(arch)
    jd, td, tol = DTYPES[dtype]
    if dtype == "f32":
        tol = F32_CACHE_TOL
    toks = _prompt(jm.cfg.vocab)
    jc, tc = jm.cache_init(BATCH, PROMPT + GEN), tm.cache_init(BATCH, PROMPT + GEN,
                                                               device="cpu")
    jdec = jax.jit(lambda p, b, c: jm.decode_fn(p, b, c, dtype=jd))
    for t in range(PROMPT + GEN):
        jlog, jc = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
        tlog, tc = tm.decode_fn(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                tc, dtype=td)
        assert tlog.dtype == torch.float32 and tlog.shape == (BATCH, jm.cfg.vocab)
        if dtype == "bf16":
            _close(tlog, jlog, NEAR_TIE)
            assert float(np.abs(_np(tlog) - _np(jlog)).mean()) < 1e-2
        else:
            _close(tlog, jlog, tol)
    assert tc["u0"]["len"].tolist() == [PROMPT + GEN] * jm.cfg.n_layers
    _close_cache(tc["u0"]["k"], jc["u0"]["k"], dtype)
    _close_cache(tc["u0"]["v"], jc["u0"]["v"], dtype)
    tpre = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, dtype=td)
    jpre = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, dtype=jd)
    _close(tpre, jpre, DTYPES[dtype][2])
    # the full-sequence pass agrees with the stepped decode of the same
    # tokens, as the reference's own pair does
    for pre, step in ((tpre, tlog), (jpre, jlog)):
        _close(pre, step, NEAR_TIE)
        assert float(np.abs(_np(pre) - _np(step)).mean()) < 1e-2


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-32b"])
def test_prefill_under_flash_matches_blockwise(arch):
    """On CPU tensors the flash wrapper computes its plain version."""
    _, tm, _, tp = _models(arch)
    toks = torch.from_numpy(_prompt(tm.cfg.vocab))
    with use_attention_impl("flash"):
        flash = tm.prefill_fn(tp, {"tokens": toks})
    with use_attention_impl("blockwise"):
        block = tm.prefill_fn(tp, {"tokens": toks})
    _close(flash, block, BF16_TOL)


def _jax_init_for(monkeypatch):
    """The port's `Model.init` drawing the JAX package's weights, so the two
    CLIs decode the same model."""

    def init(self, seed=0, device=None):
        jp = j_build(j_get_config(self.cfg.name).reduced()).init(seed)
        return params_from_jax(jax.device_get(jp), device)

    monkeypatch.setattr(t_registry.Model, "init", init)


def test_decode_main_greedy_tokens_match_the_reference(monkeypatch):
    argv = ["--arch", "internlm2-1.8b", "--reduced", "--batch", "4",
            "--prompt-len", "32", "--gen", "16"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_serve.decode_main()
    j_lines = out.getvalue().splitlines()
    j_row0 = ast.literal_eval(j_lines[-1].split(":", 1)[1].strip())
    _jax_init_for(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = t_serve.decode_main(argv + ["--device", "cpu"])
    t_lines = out.getvalue().splitlines()
    assert t_lines[0].startswith("prefill 32 tok x 4 in ")
    assert "generated 16 tok x 4 in" in t_lines[0]
    assert t_lines[1] == "sample row 0: " + str(res["tokens"][0].tolist())
    assert res["tokens"].shape == (4, 16) and res["margins"].shape == (4, 16)
    differ = [t for t in range(16) if res["tokens"][0, t] != j_row0[t]]
    if differ:
        assert res["margins"][0, differ[0]] < NEAR_TIE, (differ, res["margins"][0])


def test_decode_main_samples_from_its_seeded_generator():
    argv = ["--arch", "nemotron-4-15b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "4", "--gen", "6",
            "--temperature", "0.7"]
    with contextlib.redirect_stdout(io.StringIO()):
        a, b = t_serve.decode_main(argv), t_serve.decode_main(argv)
        c = t_serve.decode_main(argv[:-4] + ["--seed", "1"] + argv[-4:])
    assert np.array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == c["tokens"].shape == (2, 6)
    assert ((0 <= a["tokens"]) & (a["tokens"] < 256)).all()


def test_decode_cli_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.decode_main(["--arch", "internlm2-1.8b", "--reduced"])
