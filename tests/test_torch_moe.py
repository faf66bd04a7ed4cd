"""The port's MoE family against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart, at the reference's reduced MoE sizes
(``ModelConfig.reduced()`` of qwen2-moe-a2.7b: 2 layers, d_model 64, 4
heads of 16, vocab 256; 8 experts, top-2, d_expert 32, 2 shared of width
64), with the JAX weights carried across (`params_from_jax`).
Tolerances:

  * copies (configs, parameter counts, the flat order): exact;
  * `moe_apply` in f32 at capacity factors 2.0, 1.25 and 0.5 and both of
    the reference's ``dispatch`` routes: the top-k indices and the slot
    ranks equal, the output within 1e-5, aux within 1e-6, the gradient
    with respect to x and every weight within 1e-5;
  * `moe_apply` in bf16 on the same bf16 inputs (the routing then
    equal): the reference's kernel bar, 3e-2 elementwise, and its model
    bar on the gradient, 5e-2 relative;
  * the losses in f32: 1e-5; in bf16, the reference's model bars, 5e-3
    on the loss and 5e-2 relative on the gradient, on the rows whose
    top-k routing is the same in both packages in every layer.  Two bf16
    programs of an MoE model route differently wherever a token's k-th
    and (k+1)-th router probabilities are closer than a bf16 rounding of
    the hidden state moves them, and one such flip changes that token's
    whole FFN output.  Each row is its own token group in the objective,
    so a flip reaches only its own row: the test counts the rows with
    one and holds the others, at least half of them (on these 8 rows 4
    flip; the 4 others part by 2.9e-3 in the loss and 0.012 in their
    weighted gradient, where a flipped row's own gradient parts by up to
    0.28);
  * prefill and the stepped decode in f32: logits within 1e-4 (the KV
    caches are bf16 in both packages; tests/test_torch_decode.py);
  * train -> BaseL -> replay in f32: the seven counters exactly equal,
    the parameters within 1e-5 relative;
  * the train CLI's printed loss: 5e-3 (bf16 compute).

Under capacity the tokens of a group mix, so the grouping is part of the
function: the reference's per-row loss (a vmap over batch-1 slices) routes
each row alone, its batch loss routes the batch's B*S tokens together, and
its decode step routes the step's B tokens together.
"""

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

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.registry import get_config as j_get_config
from repro.core import deltagrad as jdg
from repro.core.history import HistoryMeta as JMeta
from repro.data.synthetic import token_stream as j_token_stream
from repro.launch import train as j_train
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.models.registry import active_param_count as j_active_param_count
from repro.models.registry import build as j_build
from repro.models.registry import count_params as j_count_params

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import deltagrad as tdg
from repro_torch.core import engine as t_engine
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import train as t_train
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as tt
from repro_torch.models.registry import (active_param_count, build,
                                         count_params, params_from_jax)
from repro_torch.utils.tree import flatten_nested, nested

ARCHS = ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"]
ARCH = "qwen2-moe-a2.7b"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = 3e-2  # the reference's bf16 kernel bar
MAX_FLIPPED_ROWS = 4  # of 8 in bf16: routing near-ties (module note)
N_DOCS, SEQ, STEPS, BATCH = 48, 16, 12, 16
REMOVED = np.asarray([3, 11, 25, 40], np.int64)
LR = ((0, 0.05),)
DG = dict(period=2, burn_in=4, history_size=2, guard=True, curvature_eps=1e-8)
# moe_apply's token group: 4 rows of 16 tokens routed as one group of 64
# (128 choices over 8 experts, 16 an expert on average); capacity 32, 20 and
# 8 slots, and the drops each factor must show
GROUP = (4, 16)
DROPS = {2.0: "none", 1.25: "some", 0.5: "many"}


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


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


def _jax_ranks(e_flat, E, dispatch):
    """The reference's slot ranks (src/repro/models/moe.py:66-78), both
    routes, on one group's flattened (token, choice) experts."""
    N = e_flat.shape[0]
    if dispatch == "sort":
        order = jnp.argsort(e_flat)
        e_sorted = e_flat[order]
        starts = jnp.searchsorted(e_sorted, jnp.arange(E))
        pos_sorted = jnp.arange(N) - starts[e_sorted]
        return jnp.zeros((N,), jnp.int32).at[order].set(pos_sorted.astype(jnp.int32))
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    return jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)


# -- copies -------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_the_reference_field_by_field(arch):
    ref, port = j_get_config(arch), get_config(arch)
    for f in dataclasses.fields(ModelConfig):
        if f.name != "moe":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
            assert getattr(port.reduced(), f.name) == getattr(ref.reduced(), f.name)
    for f in dataclasses.fields(MoEConfig):
        assert getattr(port.moe, f.name) == getattr(ref.moe, f.name), f.name
        assert getattr(port.reduced().moe, f.name) == getattr(ref.reduced().moe, f.name)
    assert [f.name for f in dataclasses.fields(MoEConfig)] == \
        [f.name for f in dataclasses.fields(JMoEConfig)]
    assert MoEConfig().dispatch == JMoEConfig().dispatch == "onehot"
    assert port.head_dim == ref.head_dim == 128


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_counts_match_without_allocating(arch):
    cfg = get_config(arch)
    assert count_params(cfg) == j_count_params(j_get_config(arch))
    assert active_param_count(cfg) == j_active_param_count(j_get_config(arch))
    per_layer = {"qwen2-moe-a2.7b": 570_554_368, "moonshot-v1-16b-a3b": 587_864_064}[arch]
    outer = {"qwen2-moe-a2.7b": 622_331_904, "moonshot-v1-16b-a3b": 671_090_688}[arch]
    for layers in (1, 2, 4):
        assert count_params(dataclasses.replace(cfg, n_layers=layers)) == \
            outer + layers * per_layer


@pytest.fixture(scope="module")
def moe_models():
    jcfg, tcfg = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(1)
    return jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


def test_flat_order_is_ravel_pytree(moe_models):
    jm, tm, jp, tp = moe_models
    assert np.array_equal(tp.flat.numpy(), np.asarray(ravel_pytree(jp)[0]))
    paths = ["/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(tp) == paths
    assert [k for k in tp if k.startswith("u0/mlp/")] == [
        "u0/mlp/router", "u0/mlp/shared/w_down", "u0/mlp/shared/w_gate",
        "u0/mlp/shared/w_up", "u0/mlp/shared_gate", "u0/mlp/w_down",
        "u0/mlp/w_gate", "u0/mlp/w_up"]
    assert tp.numel == count_params(tm.cfg)
    own = tm.init(0, device="cpu")  # the port's own init: the same layout
    assert list(own) == paths and own.shapes == tp.shapes
    assert {k: tuple(v) for k, v in tt.param_shapes(tm.cfg).items()} == \
        {k: tuple(v) for k, v in tp.shapes.items()}


def test_layout_takes_the_moe_family_and_checks_its_ffn():
    for arch in ARCHS:
        cfg = get_config(arch)
        assert tt.layout_of(cfg) == jt.layout_of(j_get_config(arch)) == \
            (("attn",), cfg.n_layers)
    cfg = get_config(ARCH)
    for bad in (dataclasses.replace(cfg, moe=None),
                dataclasses.replace(cfg, mlp="swiglu")):
        with pytest.raises(ValueError, match="MoEConfig"):
            tt.layout_of(bad)


# -- moe_apply ------------------------------------------------------------------------


def _moe_case(capacity_factor, dispatch, seed=0):
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced().moe,
                               capacity_factor=capacity_factor, dispatch=dispatch)
    tcfg = MoEConfig(**dataclasses.asdict(jcfg))
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), 64, jcfg)
    x = np.random.default_rng(seed + 1).normal(size=GROUP + (64,)).astype(np.float32)
    return jcfg, tcfg, jp, _torch_tree(jp), x


@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
@pytest.mark.parametrize("capacity_factor", sorted(DROPS))
def test_moe_apply_matches_in_f32(capacity_factor, dispatch):
    jcfg, tcfg, jp, tp, x = _moe_case(capacity_factor, dispatch)
    B, S = GROUP
    T, k, E = B * S, tcfg.top_k, tcfg.num_experts
    # routing: top-k indices, slot ranks, capacity and the drops it makes
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(T, 64) @ jp["router"], axis=-1)
    _, j_idx = jax.lax.top_k(jprobs, k)
    _, _, t_idx = tmoe.route(tp, torch.from_numpy(x).reshape(1, T, 64), k)
    assert np.array_equal(t_idx[0].numpy(), np.asarray(j_idx))
    t_pos = tmoe.slot_ranks(t_idx.reshape(1, T * k), E)[0].numpy()
    assert np.array_equal(t_pos, np.asarray(_jax_ranks(j_idx.reshape(-1), E, dispatch)))
    C = tmoe.capacity_of(tcfg, T)
    assert C == int(np.ceil(capacity_factor * k * T / E))
    drops = int((t_pos >= C).sum())
    assert {"none": drops == 0, "some": 0 < drops < T * k // 8,
            "many": drops > T * k // 4}[DROPS[capacity_factor]], drops

    # forward and gradient: a scalar of the output and the aux loss
    cot = np.random.default_rng(9).normal(size=(B, S, 64)).astype(np.float32)

    def j_fn(p, xx):
        out, aux = jmoe.moe_apply(p, xx, jcfg)
        return jnp.sum(out * cot) + 3.0 * aux, (out, aux)

    (_, (j_out, j_aux)), j_grads = jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in
              flatten_nested(tp).items()}
    tx = torch.from_numpy(x).reshape(1, T, 64).requires_grad_(True)
    t_out, t_aux = tmoe.moe_apply(nested(leaves), tx, tcfg)
    loss = (t_out.reshape(B, S, 64) * torch.from_numpy(cot)).sum() + 3.0 * t_aux[0]
    grads = torch.autograd.grad(loss, [tx] + list(leaves.values()))
    assert t_out.shape == (1, T, 64) and t_aux.shape == (1,)
    _close(t_out.reshape(B, S, 64), j_out, 1e-5)
    assert abs(float(t_aux[0].detach()) - float(j_aux)) < 1e-6
    _close(grads[0].reshape(B, S, 64), j_grads[1], 1e-5)
    j_flat = flatten_nested(j_grads[0])
    for (name, _), g in zip(leaves.items(), grads[1:]):
        _close(g, j_flat[name], 1e-5)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_apply_matches_in_bf16(capacity_factor):
    """The model's compute dtype: weights and input rounded to bf16 in
    both packages, so the router sees the same values and routes alike."""
    jcfg, tcfg, jp, tp, x = _moe_case(capacity_factor, "onehot")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    leaves = {k: v.to(torch.bfloat16).requires_grad_(True)
              for k, v in flatten_nested(tp).items()}
    cot = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def j_fn(p, xx):
        out, aux = jmoe.moe_apply(p, xx, jcfg)
        return jnp.sum(out.astype(jnp.float32) * cot) + 3.0 * aux, (out, aux)

    (_, (j_out, j_aux)), j_grads = jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x, jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16).reshape(1, -1, 64).requires_grad_(True)
    t_out, t_aux = tmoe.moe_apply(nested(leaves), tx, tcfg)
    loss = (t_out.float().reshape(x.shape) * torch.from_numpy(cot)).sum() + 3.0 * t_aux[0]
    grads = torch.autograd.grad(loss, [tx] + list(leaves.values()))
    assert t_out.dtype == torch.bfloat16
    _close(t_out.reshape(x.shape), j_out, BF16_TOL)
    assert abs(float(t_aux[0].detach()) - float(j_aux)) < 1e-6
    assert _rel(grads[0].reshape(x.shape), j_grads[1]) < 5e-2
    j_flat = flatten_nested(j_grads[0])
    for (name, _), g in zip(leaves.items(), grads[1:]):
        assert g.dtype == torch.bfloat16 and _rel(g, j_flat[name]) < 5e-2, name


@pytest.mark.parametrize("path", ["moe_apply", "moe_ref"])
@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_expert_ffn_in_bf16_is_bitwise_the_references(capacity_factor, path):
    """The routed experts' FFN on both of its paths (the capacity buffer of
    `moe_apply`, the dense oracle `moe_ref`), weights and input rounded to
    bf16 in both packages: the output is the JAX package's bit for bit
    (SiLU rounds op by op, as ``jax.nn.silu`` under XLA); in f32 within
    1e-5.  The shared experts are `mlp_apply` and their gate
    `layers.sigmoid`, each held bitwise in tests/test_torch_lm.py; here
    they are off, since their (T, d) x (d, d) down-projection sums in
    another order under torch's bf16 GEMM than under XLA's in 0.07 % of
    the outputs (one bf16 ulp)."""
    jcfg, tcfg, jp, tp, x = _moe_case(capacity_factor, "onehot")
    jcfg = dataclasses.replace(jcfg, num_shared=0)
    tcfg = dataclasses.replace(tcfg, num_shared=0)
    for dtype in ("bf16", "f32"):
        jd, td = DTYPES[dtype]
        jw = jax.tree.map(lambda a: a.astype(jd), jp)
        tw = nested({k: v.to(td) for k, v in flatten_nested(tp).items()})
        if path == "moe_apply":
            got = tmoe.moe_apply(tw, torch.from_numpy(x).to(td).reshape(1, -1, 64),
                                 tcfg)[0].reshape(x.shape)
            want = jmoe.moe_apply(jw, jnp.asarray(x, jd), jcfg)[0]
        else:
            got = tmoe.moe_ref(tw, torch.from_numpy(x).to(td), tcfg)
            want = jmoe.moe_ref(jw, jnp.asarray(x, jd), jcfg)
        assert got.dtype == td
        if dtype == "bf16":
            np.testing.assert_array_equal(_np(got), _np(want))
        else:
            _close(got, want, 1e-5)


def test_moe_apply_matches_the_dense_oracle_below_capacity():
    """tests/test_models_smoke.py's check: at capacity 2.0 nothing drops
    here, so the dispatch equals every token through its top-k experts."""
    _, tcfg, jp, tp, x = _moe_case(2.0, "onehot")
    xt = torch.from_numpy(x)
    out, aux = tmoe.moe_apply(tp, xt.reshape(1, -1, 64), tcfg)
    ref = tmoe.moe_ref(tp, xt, tcfg)
    _close(out.reshape(ref.shape), ref, 2e-5)
    _close(ref, jmoe.moe_ref(jp, jnp.asarray(x), dataclasses.replace(
        j_get_config(ARCH).reduced().moe, capacity_factor=2.0)), 1e-5)
    assert float(aux[0]) >= 1.0  # Switch aux loss is >= 1 at balance


def test_moe_apply_groups_route_alone():
    """Each leading index is its own token group: the groups' results are
    the results of each group alone."""
    _, tcfg, _, tp, x = _moe_case(0.5, "sort")
    xt = torch.from_numpy(x)  # (4, 16, 64): 4 groups of 16 tokens
    out, aux = tmoe.moe_apply(tp, xt, tcfg)
    for g in range(x.shape[0]):
        o, a = tmoe.moe_apply(tp, xt[g:g + 1], tcfg)
        _close(out[g:g + 1], o, 1e-6)
        _close(aux[g:g + 1], a, 1e-6)
    whole, _ = tmoe.moe_apply(tp, xt.reshape(1, -1, 64), tcfg)
    assert not torch.allclose(whole.reshape(out.shape), out, atol=1e-3)


# -- the model's losses and its objective -------------------------------------------


def _docs():
    return token_stream(N_DOCS, SEQ, 256, seed=0)


def _jax_objective(model, dtype):
    """`Objective.from_model`'s vmap over batch-1 slices, at a compute
    dtype (None: the model's default, which `from_model` itself uses)."""
    if dtype is None:
        return jdg.Objective.from_model(model, loss_chunk=SEQ)

    def per_example_loss(params, batch):  # over every column, as from_model
        return jax.vmap(lambda row: model.loss_fn(
            params, jax.tree.map(lambda c: c[None], row), remat=False,
            loss_chunk=SEQ, dtype=dtype))(batch)

    return jdg.Objective(per_example_loss=per_example_loss)


@functools.lru_cache(maxsize=None)
def _jax_values(dtype):
    """JAX's per-row losses, weighted loss, flat gradient, batch loss and
    routing on the first 8 documents (once per dtype), and its gradient
    function.  The routing is each layer's top-k indices (B, S, k), read
    out of the same compiled program that gives the gradient: the batch
    carries each row's index as a column, which the loss sets aside for
    the router's callback (its calls come in no fixed order across rows;
    a row's layers run in order)."""
    jm = j_build(j_get_config(ARCH).reduced())
    jp = jm.init(1)
    jb = {"tokens": jnp.asarray(_docs().columns["tokens"][:8]),
          "row": jnp.arange(8)}
    jd = DTYPES[dtype][0]
    row, seen, apply = [None], {}, jmoe.moe_apply

    def loss_fn(params, batch, **kw):
        row[0] = batch["row"][0]
        return jm.loss_fn(params, {"tokens": batch["tokens"]}, **kw)

    def recording(params, x, cfg):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                               @ params["router"].astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda i, r: seen.setdefault(int(r), []).append(
            np.asarray(i)), jax.lax.top_k(probs, cfg.top_k)[1], row[0])
        return apply(params, x, cfg)

    jo = _jax_objective(dataclasses.replace(jm, loss_fn=loss_fn),
                        jd if dtype == "f32" else None)
    w = jnp.asarray(np.linspace(0.0, 1.0, 8).astype(np.float32))
    jmoe.moe_apply = recording
    try:
        loss, grad = jo.make_value_grad_fn()(jp, jb, w)
        jax.effects_barrier()
    finally:
        jmoe.moe_apply = apply
    routing = np.stack([np.stack(seen[r]) for r in range(8)], axis=1)
    batch = jm.loss_fn(jp, jb, dtype=jd, remat=False, loss_chunk=SEQ)
    return (jo.per_example_loss(jp, jb), loss, ravel_pytree(grad)[0], batch,
            routing, lambda ww: ravel_pytree(jo.make_grad_fn()(jp, jb, ww))[0])


def _port_routing(monkeypatch, fn):
    """fn()'s result and each `moe.route` call's top-k indices in it."""
    seen, route = [], tmoe.route

    def recording(params, x, k):
        out = route(params, x, k)
        seen.append(out[2].detach().clone())
        return out

    monkeypatch.setattr(tmoe, "route", recording)
    res = fn()
    monkeypatch.setattr(tmoe, "route", route)
    return res, torch.stack(seen).numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("remat", [False, True])
def test_losses_and_objective_match(moe_models, monkeypatch, dtype, remat):
    _, tm, _, tp = moe_models
    td = DTYPES[dtype][1]
    tb = {"tokens": torch.from_numpy(_docs().columns["tokens"][:8])}
    to = tm.objective(loss_chunk=SEQ, remat=remat,
                      dtype=torch.float32 if dtype == "f32" else None)
    w = torch.from_numpy(np.linspace(0.0, 1.0, 8).astype(np.float32))
    j_rows, j_loss, j_grad, j_batch, j_routing, j_grad_fn = _jax_values(dtype)
    t_rows, t_routing = _port_routing(monkeypatch,
                                      lambda: to.per_example_loss(tp, tb))
    t_loss = to.weighted_mean_loss(tp, tb, w)
    t_grad = to.make_grad_fn()(tp, tb, w)
    t_batch = tm.loss_fn(tp, tb, remat=remat, loss_chunk=SEQ, dtype=td)
    assert t_routing.shape == j_routing.shape == (tm.cfg.n_layers, 8, SEQ, 2)
    same = (t_routing == j_routing).all(axis=(0, 2, 3))  # (8,) rows
    if dtype == "f32":
        assert same.all()
        _close(t_rows, j_rows, 1e-5)
        assert abs(float(t_loss) - float(j_loss)) < 1e-5
        _close(t_grad, j_grad, 1e-5)
        assert abs(float(t_batch) - float(j_batch)) < 1e-5
    else:
        # a routing flip reaches only its own row (module note): hold the
        # rows routed alike, and count the others
        assert (~same).sum() <= MAX_FLIPPED_ROWS, same
        _close(t_rows[torch.from_numpy(same)], _np(j_rows)[same], 5e-3)
        w_same = w * torch.from_numpy(same.astype(np.float32))
        assert _rel(to.make_grad_fn()(tp, tb, w_same),
                    j_grad_fn(jnp.asarray(w_same.numpy()))) < 5e-2
        assert abs(float(t_loss) - float(j_loss)) < 5e-3
        assert abs(float(t_batch) - float(j_batch)) < 5e-3
    ce, aux = tt.lm_loss_terms(tp, tb, tm.cfg, remat=remat, loss_chunk=SEQ, dtype=td)
    assert float(aux) > 0 and torch.equal(ce + aux, t_batch)


def test_a_rows_loss_ignores_the_rest_of_its_batch(moe_models):
    """Row i's per-row loss is bitwise the same whatever the other rows of
    its batch are (DeltaGrad subtracts the changed rows' gradients from
    the batch's); the batch loss routes the rows together, so it is not
    the mean of the rows."""
    _, tm, _, tp = moe_models
    toks = _docs().columns["tokens"]
    obj = tm.objective(loss_chunk=SEQ, dtype=torch.float32)
    a = torch.from_numpy(toks[:8].copy())
    b = torch.from_numpy(np.concatenate([toks[8:11], toks[3:4], toks[12:16]]))
    la, lb = obj.per_example_loss(tp, {"tokens": a}), obj.per_example_loss(tp, {"tokens": b})
    assert torch.equal(la[3], lb[3])
    assert not torch.equal(la[:3], lb[:3])
    for i in range(8):  # the loss of each row on its own
        alone = tm.loss_fn(tp, {"tokens": a[i:i + 1]}, loss_chunk=SEQ,
                           dtype=torch.float32)
        assert abs(float(alone) - float(la[i])) < 1e-6
    batch = tm.loss_fn(tp, {"tokens": a}, loss_chunk=SEQ, dtype=torch.float32)
    assert abs(float(batch) - float(la.mean())) > 1e-4


def test_prefill_and_stepped_decode_match_in_f32(moe_models):
    jm, tm, jp, tp = moe_models
    toks = np.random.default_rng(0).integers(0, 256, size=(2, 10), dtype=np.int32)
    jc, tc = jm.cache_init(2, 10), tm.cache_init(2, 10, device="cpu")
    jdec = jax.jit(lambda p, b, c: jm.decode_fn(p, b, c, dtype=jnp.float32))
    for t in range(10):
        jlog, jc = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
        tlog, tc = tm.decode_fn(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                tc, dtype=torch.float32)
        _close(tlog, jlog, 1e-4)
    tpre = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, dtype=torch.float32)
    jpre = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, dtype=jnp.float32)
    _close(tpre, jpre, 1e-4)


# -- the slice as a whole, f32 --------------------------------------------------------


def _metas():
    kw = dict(n=N_DOCS, batch_size=BATCH, seed=5, steps=STEPS, lr_schedule=LR)
    return JMeta(**kw), TMeta(**kw)


def test_slice_matches_jax_in_f32(moe_models):
    jm, tm, jp, tp = moe_models
    jmeta, tmeta = _metas()
    jo = _jax_objective(jm, jnp.float32)
    jdocs = j_token_stream(N_DOCS, SEQ, 256, seed=0)
    jw_star, jh = jdg.sgd_train_with_cache(jo, jp, jdocs, jmeta)
    jw_u, _ = jdg.baseline_retrain(jo, jdocs, jmeta, jp, REMOVED)
    jw_i, jst = jdg.deltagrad_retrain(jo, jh, jdocs, REMOVED, jdg.DeltaGradConfig(**DG))

    to = tm.objective(loss_chunk=SEQ, dtype=torch.float32)
    docs = _docs()
    w_star, hist = tdg.sgd_train_with_cache(to, tp, docs, tmeta, device="cpu")
    w_u, _ = tdg.baseline_retrain(to, docs, tmeta, tp, REMOVED, device="cpu")
    w_i, st = tdg.deltagrad_retrain(to, hist, docs, REMOVED,
                                    tdg.DeltaGradConfig(**DG), device="cpu")
    for t, j in ((w_star, jw_star), (w_u, jw_u), (w_i, jw_i)):
        assert _rel(t.flat, ravel_pytree(j)[0]) <= 1e-5
    for k, v in st.counters().items():
        assert v == getattr(jst, k), (k, st.counters(), jst)
    assert st.approx_steps > 0 and st.explicit_steps > 0


# -- phase 9's LM recipe on an MoE ------------------------------------------------------
# The recipe of the card's MoE replay (lr 0.01, T 6, T0 4, j0 2, m 2, the
# guard; 128 documents, B 32, 4 rows deleted), f32 compute, at one layer of
# the published layout cut in width: d_model d, 4 heads, vocab 4096, and
# for qwen2-moe its 60 experts top-4 with the expert widths scaled by
# d / 2048 (for InternLM2 its d_ff).  Each row is its own token group of S
# tokens.  Run as a script, this prints both packages' d_ui/d_us at larger
# widths: PYTHONPATH=src python tests/test_torch_moe.py 64,32 256,128 512,512
RECIPE = dict(docs=128, batch=32, steps=6, lr=0.01, removed=[3, 42, 81, 120],
              dg=dict(period=4, burn_in=2, history_size=2, guard=True,
                      curvature_eps=1e-8))


def _recipe_run(arch, d, S):
    """Train -> BaseL -> replay in both packages on the same JAX init:
    {package: (d_ui, d_us, counters)}, the port's ||Bv||/||v|| per B v,
    and the two replays' max |gap|."""
    jfull, tfull = j_get_config(arch), get_config(arch)
    kw = dict(n_layers=1, d_model=d, n_heads=4, n_kv_heads=4, d_head=d // 4,
              vocab=4096)
    if jfull.moe is not None:
        m = jfull.moe
        jmoe_cfg = dataclasses.replace(m, d_expert=m.d_expert * d // jfull.d_model,
                                       d_shared=m.d_shared * d // jfull.d_model)
        jcfg = dataclasses.replace(jfull, **kw, moe=jmoe_cfg)
        tcfg = dataclasses.replace(tfull, **kw,
                                   moe=MoEConfig(**dataclasses.asdict(jmoe_cfg)))
    else:
        kw["d_ff"] = jfull.d_ff * d // jfull.d_model
        jcfg, tcfg = dataclasses.replace(jfull, **kw), dataclasses.replace(tfull, **kw)
    jm, tm = j_build(jcfg), build(tcfg)
    jp = jm.init(0)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    removed = np.asarray(RECIPE["removed"], np.int64)
    meta = dict(n=RECIPE["docs"], batch_size=RECIPE["batch"], seed=5,
                steps=RECIPE["steps"], lr_schedule=((0, RECIPE["lr"]),))
    chunk = min(128, S)

    def per_row(params, batch):
        return jax.vmap(lambda row: jm.loss_fn(
            params, jax.tree.map(lambda c: c[None], row), remat=False,
            loss_chunk=chunk, dtype=jnp.float32))(batch)

    jo, jdocs = jdg.Objective(per_example_loss=per_row), j_token_stream(
        RECIPE["docs"], S, 4096, seed=0)
    jw, jh = jdg.sgd_train_with_cache(jo, jp, jdocs, JMeta(**meta))
    jw_u, _ = jdg.baseline_retrain(jo, jdocs, JMeta(**meta), jp, removed)
    jw_i, jst = jdg.deltagrad_retrain(jo, jh, jdocs, removed,
                                      jdg.DeltaGradConfig(**RECIPE["dg"]))
    flat = [np.asarray(ravel_pytree(t)[0], np.float64) for t in (jw, jw_u, jw_i)]

    to, docs = tm.objective(loss_chunk=chunk, dtype=torch.float32), token_stream(
        RECIPE["docs"], S, 4096, seed=0)
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


@pytest.mark.parametrize("arch", [ARCH, "internlm2-1.8b"])
def test_lm_recipe_replays_alike_on_moe_and_dense(arch):
    """Both packages take the same steps and land alike.  On the MoE the
    approx steps diverge in both: the L-BFGS pairs read a curvature
    (||Bv||/||v||) past 2 / lr, so each approx step grows w^I - w, and
    d_ui > d_us; on its dense counterpart they read below 1 and d_ui <
    d_us."""
    out, ratios, gap = _recipe_run(arch, 64, 32)
    (j_ui, j_us, jc), (t_ui, t_us, tc) = out["jax"], out["port"]
    assert tc == jc and tc["approx_steps"] == 3
    assert abs(t_us - j_us) <= 1e-3 * j_us and abs(t_ui - j_ui) <= 1e-2 * j_ui
    moe = arch == ARCH
    assert (t_ui > t_us and j_ui > j_us) if moe else (t_ui < t_us and j_ui < j_us)
    assert (max(ratios) > 2 / RECIPE["lr"]) == moe, ratios


def test_train_cli_step_matches_the_reference(monkeypatch):
    def init(self, seed=0, device=None):
        return params_from_jax(jax.device_get(
            j_build(j_get_config(self.cfg.name).reduced()).init(seed)), device)

    monkeypatch.setattr(t_registry.Model, "init", init)
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


if __name__ == "__main__":
    for spec in sys.argv[1:]:
        d, S = map(int, spec.split(","))
        for arch in (ARCH, "internlm2-1.8b"):
            out, ratios, gap = _recipe_run(arch, d, S)
            print(f"{arch} 1 layer d_model {d} S {S}: " + "; ".join(
                f"{k} d_ui {v[0]:.6e} d_us {v[1]:.6e} d_ui/d_us {v[0] / v[1]:.4e}"
                for k, v in out.items())
                + f"; counters equal: {out['jax'][2] == out['port'][2]} "
                f"{out['port'][2]}; port ||Bv||/||v|| "
                + " ".join(f"{r:.4e}" for r in ratios)
                + f"; max |w_I gap| {gap:.3e}", flush=True)
