"""The port's shape registry and analytic roofline model (``configs/
{registry,shapes}.py``, ``roofline/model.py``) against the JAX package.

  * the registries: every arch and shape cell the reference registers, name
    for name and field by field (``paper-mlp`` included);
  * `analytic_cost(cfg, shape, n_params=count_params(cfg))`: FLOPs, bytes
    and every breakdown entry equal (``==``) to the reference's, for every
    registered LM arch (family other than ``simple``) under each of the
    four cells, at grad_accum 1 and 8, at full size and at ``reduced()``:
    the same float arithmetic in the same order on the same integers;
  * the analytic FLOPs against a count of one forward-and-backward step of
    the port's model by ``torch.utils.flop_counter.FlopCounterMode``,
    within the reference's own tolerances for its check against XLA's
    ``cost_analysis`` (tests/test_roofline.py: the same reduced configs,
    seq 256, B 2; 0.20 dense, 0.25 hybrid and MLA, 0.35 MoE).  The counter
    takes the matmuls (the model's FLOPs are matmul-exact); each ratio is
    printed.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as j_registry
from repro.models.registry import count_params as j_count_params
from repro.roofline.model import analytic_cost as j_analytic_cost

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.registry import build, count_params
from repro_torch.roofline import AnalyticCost, analytic_cost

CELLS = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
LM_ARCHS = sorted(name for name, cfg in j_registry.all_archs().items()
                  if cfg.family != "simple")
SHAPE = ShapeConfig(name="v", seq_len=256, global_batch=2, kind="train")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread per test: the suite runs its files in
    several worker processes on the same cores, and every worker's thread
    pool spinning for them slows the port's small CPU ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registries_match_the_reference_name_for_name_and_field_by_field():
    archs, j_archs = registry.all_archs(), j_registry.all_archs()
    assert sorted(archs) == sorted(j_archs) and len(archs) == 12
    assert "paper-mlp" in archs
    for name, cfg in archs.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j_archs[name]), name
        assert registry.get_config(name) is cfg
    shapes, j_shapes = registry.all_shapes(), j_registry.all_shapes()
    assert list(shapes) == list(j_shapes) == CELLS
    for name, shape in shapes.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(j_shapes[name])
        assert shape.is_decode == j_shapes[name].is_decode
        assert registry.get_shape(name) is shape


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_analytic_cost_equals_the_references(arch, size):
    cfg, j_cfg = registry.get_config(arch), j_registry.get_config(arch)
    if size == "reduced":
        cfg, j_cfg = cfg.reduced(), j_cfg.reduced()
    n, j_n = count_params(cfg), j_count_params(j_cfg)
    assert n == j_n
    for cell in CELLS:
        shape, j_shape = registry.get_shape(cell), j_registry.get_shape(cell)
        for accum in (1, 8):
            got = analytic_cost(cfg, shape, grad_accum=accum, n_params=n)
            want = j_analytic_cost(j_cfg, j_shape, grad_accum=accum, n_params=j_n)
            assert isinstance(got, AnalyticCost)
            assert got.flops_global == want.flops_global, (cell, accum)
            assert got.bytes_global == want.bytes_global, (cell, accum)
            assert got.breakdown == want.breakdown, (cell, accum)
            assert list(got.breakdown) == list(want.breakdown)
            assert got.flops_global > 0 and got.bytes_global > 0


@pytest.mark.parametrize("arch,rtol", [
    ("internlm2-1.8b", 0.20),
    ("zamba2-7b", 0.25),
    ("qwen2-moe-a2.7b", 0.35),
    ("minicpm3-4b", 0.25),
])
def test_analytic_flops_against_a_flop_counter(arch, rtol):
    """tests/test_roofline.py's configs, counted on the port's model: the
    loss at f32 compute, no remat, loss chunks of 128, and its gradient
    with respect to every weight."""
    base = registry.get_config(arch)
    cfg = base.reduced(d_model=512, n_heads=8,
                       n_kv_heads=4 if base.n_kv_heads < base.n_heads else 8,
                       d_ff=1024, d_head=64, vocab=1024)
    if base.ssm:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, d_state=32, head_dim=32, chunk=64))
    if base.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_expert=256, d_shared=512))
    if base.mla:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, q_lora_rank=128, kv_lora_rank=64, qk_nope_head_dim=32,
            qk_rope_head_dim=32, v_head_dim=32))
    model = build(cfg)
    params = model.init(0, device="cpu")
    batch = model.sample_batch(SHAPE, device="cpu")
    leaves = {k: params[k].detach().clone().requires_grad_(True) for k in params}
    counter = FlopCounterMode(display=False)
    with counter:
        loss = model.loss_fn(leaves, batch, dtype=torch.float32, remat=False,
                             loss_chunk=128)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    assert np.isfinite(float(loss.detach())) and len(grads) == len(leaves)
    counted = float(counter.get_total_flops())
    ac = analytic_cost(cfg, SHAPE, n_params=count_params(cfg))
    ratio = ac.flops_global / counted
    print(f"{arch}: analytic {ac.flops_global:.6e} / counted {counted:.6e} "
          f"= {ratio:.4f} (tolerance {rtol})")
    assert 1 - rtol <= ratio <= 1 + rtol, (counted, ac.flops_global, ratio)
