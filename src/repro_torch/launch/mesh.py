"""The meshes of the port: picklable `dist.sharding.Mesh` descriptors.

Building a descriptor never starts a process group.  When the caller has
initialized the default group (``torch.distributed.init_process_group``,
with the backend it names: "nccl" or "gloo"), the descriptor is bound to
this process's rank (``coords``); otherwise it is unbound, which is all a
`dist.sharding.ShardingPlan` reads.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.dist.sharding import Mesh


def bound_mesh(shape, axes) -> Mesh:
    """A mesh of `shape` and `axes`, bound to this process's rank in the
    default process group when one is initialized (and holds the rank)."""
    mesh = Mesh(shape, axes)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_rank() < mesh.size:
        return mesh.at(dist.get_rank())
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 (data, model) single pod; 2x16x16 (pod, data, model) multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return bound_mesh(shape, axes)


def make_debug_mesh(data: int = 2, model: int = 2) -> Mesh:
    """Small mesh for tests."""
    return bound_mesh((data, model), ("data", "model"))


def make_replay_mesh(data: int = 0, model: int = 1) -> Mesh:
    """Mesh for the sharded DeltaGrad replay (`core.store.PlacementPolicy`):
    batch-sharded gradients over ``data``, an optional ``model`` axis for
    the history leaves' placements.  ``data=0``: the world size of the
    initialized default process group, over ``model``."""
    if not data:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "make_replay_mesh(data=0) takes the world size of the default "
                "process group: call torch.distributed.init_process_group "
                "first, or pass data=")
        data = dist.get_world_size() // max(1, model)
    if model > 1:
        return bound_mesh((data, model), ("data", "model"))
    return bound_mesh((data,), ("data",))
