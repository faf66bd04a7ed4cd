"""The port's placement rules, mesh descriptors, packed shards and elastic
re-mesh against the JAX package, with no process group.

The JAX package's plan reads only a mesh's axis names and shape, so it
takes a fake mesh (as tests/test_sharding_dryrun.py does); the port's takes
a `dist.sharding.Mesh`.  Leaves come from the port's `param_shapes` (the
paper models from their inits), nothing allocated for the LM archs.
Everything is held exactly.
"""

import math
import pickle

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.dist import sharding as jsh
from repro.train.elastic import plan_remesh as j_plan_remesh

from repro_torch.configs.paper_mlp import CONFIG as MLP_RECIPE
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.core.deltagrad import sgd_train_with_cache
from repro_torch.core.history import HistoryMeta
from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
from repro_torch.core.store import HistoryStore, PlacementPolicy
from repro_torch.data.synthetic import binary_classification
from repro_torch.dist import sharding as tsh
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     make_replay_mesh)
from repro_torch.models.registry import param_shapes
from repro_torch.models.simple import (logreg_init, logreg_objective,
                                       mlp_init)
from repro_torch.train.elastic import (build_mesh, plan_remesh,
                                       reshard_state)
from repro_torch.utils.tree import key_order

MESHES = {"2": ((2,), ("data",)), "8": ((8,), ("data",)),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = sorted(all_archs())
RCV1_D = 47_236  # the paper's rcv1.binary width, for paper-logreg


def _fake_mesh(shape, axes):
    class FakeMesh:
        axis_names = axes

        class devices:  # noqa: D106
            pass

    FakeMesh.devices.shape = shape
    return FakeMesh()


def _leaf_shapes(name, cfg):
    if name == "paper-mlp":
        return mlp_init(MLP_RECIPE.d_in, cfg.d_model, cfg.vocab).shapes
    if name == "paper-logreg":
        return logreg_init(RCV1_D).shapes
    return param_shapes(cfg)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_the_references(arch, mesh):
    shape, axes = MESHES[mesh]
    leaves = _leaf_shapes(arch, get_config(arch))
    for with_cfg in (False, True):
        j_plan = jsh.make_plan(_fake_mesh(shape, axes),
                               j_get_config(arch) if with_cfg else None)
        t_plan = tsh.make_plan(tsh.Mesh(shape, axes),
                               get_config(arch) if with_cfg else None)
        specs = tsh.params_specs(t_plan, leaves)
        stacked = tsh.history_specs(t_plan, leaves)
        assert list(specs) == key_order(leaves) == list(stacked)
        for path, s in leaves.items():
            want = tuple(jsh.spec_for_leaf(j_plan, path, s))
            assert tsh.spec_for_leaf(t_plan, path, s) == want, (path, s)
            assert specs[path] == want
            want_t = tuple(jsh.stacked_spec_for_leaf(j_plan, path, (7,) + s))
            assert tsh.stacked_spec_for_leaf(t_plan, path, (7,) + s) == want_t
            assert stacked[path] == want_t
        batches = {"x": (256, 4096), "y": (1, 1), "z": (6, 3, 2), "s": ()}
        want_b = {k: tuple(jsh.batch_pspec(j_plan, b)) for k, b in batches.items()}
        assert tsh.inputs_specs(t_plan, batches) == want_b
        assert {k: tsh.batch_pspec(t_plan, b)
                for k, b in batches.items()} == want_b


def test_moe_rules_follow_the_config():
    """Expert-parallel where the experts divide the model axis, the
    tensor-parallel fallback where they do not, and neither without a
    config (tests/test_sharding_dryrun.py's cases)."""
    mesh = tsh.Mesh((16, 16), ("data", "model"))
    moon = tsh.make_plan(mesh, get_config("moonshot-v1-16b-a3b"))
    qwen = tsh.make_plan(mesh, get_config("qwen2-moe-a2.7b"))
    assert tsh.spec_for_leaf(moon, "u0/mlp/w_gate", (48, 64, 2048, 1408)) == (
        None, "model", None, "data")
    assert tsh.spec_for_leaf(qwen, "u0/mlp/w_gate", (24, 60, 2048, 1408)) == (
        None, None, "data", "model")
    assert tsh.spec_for_leaf(tsh.make_plan(mesh), "u0/mlp/w_gate",
                             (48, 64, 2048, 1408)) == (None, None, "data", "model")


PACK_MESHES = {"2": ((2,), ("data",)), "4": ((4,), ("data",)),
               "2x2": ((2, 2), ("data", "model")),
               "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", sorted(PACK_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_packed_shards_cover_every_position(arch, mesh):
    """Across the ranks, each flat position of a leaf is held once per rank
    that its placement does not tell apart: once in all for a leaf cut on
    every axis, once per rank for a replicated leaf.  Every rank's shard
    is its slices in leaf order, and the gather map puts them back."""
    shape, axes = PACK_MESHES[mesh]
    cfg = get_config(arch)
    leaves = _leaf_shapes(arch, cfg if cfg.family == "simple" else cfg.reduced())
    m = tsh.Mesh(shape, axes)
    plan = tsh.make_plan(m, cfg)
    p = sum(math.prod(s) for s in leaves.values())
    count = np.zeros(p, np.int64)
    shards = []
    for r in range(m.size):
        sh = tsh.shard_index(plan, leaves, m.coords_of(r))
        assert sh.bounds[-1] == sh.index.size
        np.add.at(count, sh.index, 1)
        shards.append(sh)
    assert len({s.index.size for s in shards}) == 1
    off = 0
    for path in key_order(leaves):  # the flat layout's order
        s = leaves[path]
        spec = tsh.spec_for_leaf(plan, path, s)
        cut = math.prod(m.axis_size(a) for a in spec if a is not None)
        n = math.prod(s)
        assert (count[off:off + n] == m.size // cut).all(), (path, spec)
        off += n
    flat = torch.arange(p, dtype=torch.float64)
    packed = [flat[torch.from_numpy(sh.index)] for sh in shards]
    assert torch.equal(tsh.unshard(packed, plan, leaves), flat)


def test_mesh_constructors_and_descriptors():
    assert make_production_mesh() == tsh.Mesh((16, 16), ("data", "model"))
    prod = make_production_mesh(multi_pod=True)
    assert (prod.shape, prod.axis_names) == ((2, 16, 16), ("pod", "data", "model"))
    assert prod.coords is None  # no process group: bound to no rank
    assert make_debug_mesh() == tsh.Mesh((2, 2), ("data", "model"))
    assert make_replay_mesh(4) == tsh.Mesh((4,), ("data",))
    assert make_replay_mesh(4, 2) == tsh.Mesh((4, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_replay_mesh()
    m = tsh.Mesh((2, 3, 4), ("pod", "data", "model"))
    for r in range(m.size):
        c = m.at(r).coords
        assert int(np.ravel_multi_index(c, m.shape)) == r
    assert pickle.loads(pickle.dumps(m.at(5))) == m.at(5)
    with pytest.raises(ValueError, match="outside"):
        tsh.Mesh((2,), ("data",), coords=(2,))


def _decision(fn, *args, **kw):
    """The decision as a tuple, or the type of what it raised (a pod smaller
    than the model axis divides by zero in both packages)."""
    try:
        d = fn(*args, **kw)
    except ZeroDivisionError as e:
        return type(e)
    return (d.ok, tuple(d.mesh_shape), tuple(d.axis_names), d.dropped_batch,
            d.reason)


def test_plan_remesh_equals_the_references():
    seen_refusal = seen_ok = 0
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 255, 256, 512):
        for model in (1, 2, 3, 4, 8, 16):
            for batch in (1, 7, 64, 96, 256, 1000):
                assert _decision(plan_remesh, n, model, batch) == _decision(
                    j_plan_remesh, n, model, batch)
                for pod in (4, 8, 16, 256):
                    got = _decision(plan_remesh, n, model, batch,
                                    multi_pod=True, pod_size=pod)
                    assert got == _decision(j_plan_remesh, n, model, batch,
                                            multi_pod=True, pod_size=pod)
                    seen_refusal += isinstance(got, tuple) and not got[0]
                    seen_ok += isinstance(got, tuple) and got[0]
    assert seen_refusal and seen_ok
    with pytest.raises(ValueError, match="pod_size"):
        plan_remesh(8, 2, 8, multi_pod=True)
    mesh = build_mesh(plan_remesh(32, 4, 256))
    assert mesh == tsh.Mesh((8, 4), ("data", "model"))
    with pytest.raises(ValueError, match="divisible"):
        build_mesh(plan_remesh(6, 4, 8))


def test_reshard_state_repacks_across_meshes_bitwise():
    """Shards of the paper MLP's flat state on a 2-rank mesh, re-packed
    onto a (2, 2) mesh: each new shard is the one cut from the unsharded
    state, and the new shards put back together are that state."""
    shapes = mlp_init(MLP_RECIPE.d_in, MLP_RECIPE.d_model, MLP_RECIPE.vocab).shapes
    state = torch.from_numpy(np.random.default_rng(0).normal(
        size=sum(math.prod(s) for s in shapes.values())).astype(np.float32))
    old = tsh.Mesh((2,), ("data",))
    new = tsh.Mesh((2, 2), ("data", "model"))
    old_shards = [reshard_state(state, shapes, old.at(r)) for r in range(old.size)]
    assert old_shards[0].numel() == 119_410
    new_shards = [reshard_state(old_shards, shapes, new.at(r), old_mesh=old)
                  for r in range(new.size)]
    for r, sh in enumerate(new_shards):
        assert torch.equal(sh, reshard_state(state, shapes, new.at(r)))
    assert torch.equal(tsh.unshard(new_shards, tsh.make_plan(new), shapes), state)


def test_placement_policy_pickles_without_its_group():
    pol = PlacementPolicy((4, 2), ("data", "model"),
                          model_cfg=get_config("qwen2-moe-a2.7b"))
    pol._data_group = (object(),)  # a live group stands here after first use
    back = pickle.loads(pickle.dumps(pol))
    assert (back.mesh_shape, back.axis_names, back.data_axis) == (
        (4, 2), ("data", "model"), "data")
    assert back.model_cfg == pol.model_cfg and back._data_group is None
    assert (back.size, back.data_size) == (8, 4)
    assert back.describe() == {"mesh_shape": [4, 2],
                               "axis_names": ["data", "model"],
                               "data_axis": "data"}
    assert PlacementPolicy.local(3).mesh_shape == (3,)
    assert PlacementPolicy.from_mesh(make_debug_mesh(4, 2)).describe() == \
        back.describe()
    assert back.plan().mesh == tsh.Mesh((4, 2), ("data", "model"))


def _logreg_history(tier="host"):
    ds = binary_classification(n=64, d=4, seed=0)
    meta = HistoryMeta(n=64, batch_size=16, seed=0, steps=6,
                       lr_schedule=((0, 0.2),))
    return sgd_train_with_cache(logreg_objective(1e-3), logreg_init(4), ds,
                                meta, tier=tier, device="cpu")[1]


@pytest.mark.parametrize("tier", ["host", "stacked"])
def test_store_on_a_mesh_without_its_ranks_raises(tier):
    """A placement the process group cannot hold fails with an actionable
    ValueError (tests/test_store.py's case), on either tier."""
    h = _logreg_history(tier)
    with pytest.raises(ValueError, match="mesh"):
        HistoryStore.create(h, placement=PlacementPolicy(
            mesh_shape=(8,), axis_names=("data",)))
    assert HistoryStore.create(h).sharded_replay() is None


def test_sharded_disk_tier_without_spill_dir():
    cfg = UnlearnerConfig(steps=6, batch_size=16, lr=0.2, seed=0,
                          history_tier="disk",
                          placement=PlacementPolicy(mesh_shape=(8,),
                                                    axis_names=("data",)))
    sess = UnlearnerSession(logreg_objective(1e-3), logreg_init(4),
                            binary_classification(n=64, d=4, seed=0), cfg,
                            device="cpu")
    with pytest.raises(ValueError, match="spill_dir"):
        sess.fit()
