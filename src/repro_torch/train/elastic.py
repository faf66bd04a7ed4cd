"""Elastic scaling: rebuild the mesh when the healthy device count changes.

Policy (the JAX package's): the `model` axis is architecture-determined and
fixed; elasticity happens on the data axis (and the pod axis across pods).
A world-size change therefore maps to ``new_data = n_devices // model``,
and a checkpoint written at any data size restores onto any other:
checkpoints are stored unsharded (`train.checkpoint`), and resharding is
cutting each rank's packed shard (`dist.sharding.shard_index`) out of the
flat state again.

The data pipeline stays deterministic across re-meshes because the sampler
is a pure function of (seed, step): ranks slice `batch_indices(...)` by
their new data-axis coordinate (see data/sampler.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.dist.sharding import Mesh, make_plan, shard_index, unshard
from repro_torch.launch.mesh import bound_mesh


@dataclass
class ElasticDecision:
    ok: bool
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_batch: int  # global batch rows dropped to stay divisible
    reason: str = ""


def plan_remesh(
    n_devices: int,
    model_parallel: int,
    global_batch: int,
    multi_pod: bool = False,
    pod_size: Optional[int] = None,
) -> ElasticDecision:
    """Compute the new mesh shape after a world-size change."""
    if n_devices % model_parallel != 0:
        return ElasticDecision(False, (), (), 0,
                               f"{n_devices} devices not divisible by "
                               f"model={model_parallel}")
    data = n_devices // model_parallel
    if multi_pod:
        if not pod_size:
            raise ValueError("pod_size required for multi-pod re-mesh")
        if n_devices % pod_size != 0:
            return ElasticDecision(False, (), (), 0,
                                   "device count not divisible by pod size")
        pods = n_devices // pod_size
        data = pod_size // model_parallel
        shape = (pods, data, model_parallel)
        names = ("pod", "data", "model")
        dp = pods * data
    else:
        shape = (data, model_parallel)
        names = ("data", "model")
        dp = data
    dropped = global_batch % dp
    return ElasticDecision(True, shape, names, dropped)


def build_mesh(decision: ElasticDecision) -> Mesh:
    """The decision's mesh descriptor (bound to this process's rank when the
    default process group is initialized)."""
    if not decision.ok:
        raise ValueError(decision.reason)
    return bound_mesh(decision.mesh_shape, decision.axis_names)


def reshard_state(state: Union[torch.Tensor, Sequence[torch.Tensor]],
                  shapes: Mapping[str, Tuple[int, ...]], new_mesh: Mesh,
                  old_mesh: Optional[Mesh] = None, cfg=None) -> torch.Tensor:
    """This rank's packed shard of a flat state on `new_mesh` (bound to the
    rank).  `state` is the unsharded flat vector (a checkpoint's), or, with
    `old_mesh`, every rank's packed shard on that mesh in rank order, which
    are put back together first (bitwise the unsharded vector)."""
    if old_mesh is not None:
        state = unshard(state, make_plan(old_mesh, cfg), shapes)
    index = shard_index(make_plan(new_mesh, cfg), shapes).index
    return state.index_select(0, torch.from_numpy(index).to(state.device))
