"""Parameter / input sharding resolver for the (data, model) mesh.

Megatron-style rules driven by leaf PATH + SHAPE only (no per-model tables),
the JAX package's rules (`dist/sharding.py` there) rule for rule:

  * column-parallel projections (wq/wk/wv, w_up/w_gate, ...): model
    parallelism on the OUTPUT dim, data-axis FSDP on the input dim;
  * row-parallel projections (wo, w_down, out_proj): the transpose, model
    on the input dim, so the pair (column @ row) needs one all-reduce;
  * the stacked layer axis (every block parameter of a scan-over-layers
    model stacks along a leading ``n_units`` axis, paths ``u<i>/...``) is
    NEVER sharded;
  * any dim not divisible by its mesh axis replicates;
  * norms / 1-D leaves replicate on model and FSDP-shard on data when
    divisible;
  * embeddings: vocab-sharded on data only (the lm_head matmul wants d_model
    contiguous);
  * MoE routed experts (leaves shaped (E, d_in, d_out) under ``mlp``):
    expert-parallel on the model axis when E divides it, else
    tensor-parallel on (d_in, d_out) with the expert axis replicated.

A placement is a tuple with one entry per dim of the leaf: an axis name
(the dim is cut into that axis's size of equal parts) or None (the dim is
whole on every rank), which is what a jax ``PartitionSpec`` holds.  Every
function here is pure over a `ShardingPlan` (a `Mesh` descriptor and an
optional model config), so tests drive them with no process group.

On ``torch.distributed`` rank r sits at the row-major coordinates of r in
the mesh's shape.  Parameters are one flat buffer (`utils.tree.FlatParams`),
so a rank's share of a parameter-shaped vector is its PACKED SHARD: the
flat positions of its slice of every leaf, leaf by leaf in `key_order`,
each slice in row-major order (`shard_index`).  `gather_map` is the fixed
map that puts every rank's packed shard back into the flat vector, each
replicated position taken from the lowest rank that holds it.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import key_order

Spec = Tuple[Any, ...]  # per dim: an axis name, a tuple of names, or None

_ROW_PARALLEL = ("wo", "w_down", "out_proj")
_NORM_PARENTS = re.compile(r"(^|/)(ln\d*|.*norm)(/|$)")
_STACKED_PREFIX = re.compile(r"^u\d+(/|$)")


@dataclass(frozen=True)
class Mesh:
    """A picklable mesh descriptor: its shape, its axis names and, when it
    is bound to a rank, that rank's coordinates (None otherwise)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coords: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")
        if self.coords is not None:
            object.__setattr__(self, "coords",
                               tuple(int(c) for c in self.coords))
            if not all(0 <= c < s for c, s in zip(self.coords, self.shape)) \
                    or len(self.coords) != len(self.shape):
                raise ValueError(f"coordinates {self.coords} outside the "
                                 f"mesh {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]

    def coords_of(self, rank: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(rank, self.shape))

    def at(self, rank: int) -> "Mesh":
        """The same mesh bound to `rank`."""
        return Mesh(self.shape, self.axis_names, self.coords_of(rank))


@dataclass
class ShardingPlan:
    mesh: Mesh
    cfg: Optional[Any] = None  # ModelConfig; enables the MoE rules

    def axis_size(self, name: str) -> int:
        return self.mesh.axis_size(name)


def make_plan(mesh: Mesh, cfg=None) -> ShardingPlan:
    return ShardingPlan(mesh=mesh, cfg=cfg)


def _fit(plan: ShardingPlan, axis: Optional[str], dim: int) -> Optional[str]:
    """axis if dim divides its mesh size, else replicate."""
    if axis is None:
        return None
    size = plan.axis_size(axis)
    return axis if (size > 1 and dim % size == 0) else None


def _matrix_spec(plan: ShardingPlan, dims: Tuple[int, ...],
                 row_parallel: bool) -> Spec:
    """Spec for the trailing (..., d_in, d_out) dims of a projection."""
    lead = (None,) * (len(dims) - 2)
    d_in, d_out = dims[-2], dims[-1]
    if row_parallel:
        return lead + (_fit(plan, "model", d_in), _fit(plan, "data", d_out))
    return lead + (_fit(plan, "data", d_in), _fit(plan, "model", d_out))


def spec_for_leaf(plan: ShardingPlan, path: str, shape: Tuple[int, ...]) -> Spec:
    """The placement of one parameter leaf, keyed by its path and shape."""
    parts = path.split("/")
    name = parts[-1]
    stacked = bool(_STACKED_PREFIX.match(path))
    dims = tuple(shape[1:]) if stacked else tuple(shape)
    prefix: Spec = (None,) if stacked else ()

    def done(spec_dims) -> Spec:
        return prefix + tuple(spec_dims)

    # embeddings: vocab rows FSDP-sharded on data, d_model contiguous
    if name == "embed":
        return done((_fit(plan, "data", dims[0]),) + (None,) * (len(dims) - 1))

    # norms and other vectors: data-FSDP the feature dim when divisible
    if name in ("scale", "bias") or (len(parts) > 1
                                     and _NORM_PARENTS.search("/".join(parts[:-1]))):
        spec = [None] * len(dims)
        if dims:
            spec[-1] = _fit(plan, "data", dims[-1])
        return done(spec)

    # MoE routed experts: (E, d_in, d_out) under an mlp block
    moe = plan.cfg.moe if (plan.cfg is not None
                           and getattr(plan.cfg, "moe", None)) else None
    if (moe is not None and len(dims) == 3 and "mlp" in parts
            and name in ("w_gate", "w_up", "w_down")):
        E = dims[0]
        if plan.axis_size("model") > 1 and E % plan.axis_size("model") == 0:
            # expert-parallel: experts on model, FSDP the widest matmul dim
            return done(("model", None, _fit(plan, "data", dims[-1])))
        # TP fallback: expert axis replicated, usual column/row split
        return done((None,) + _matrix_spec(
            plan, dims[1:], row_parallel=(name in _ROW_PARALLEL)))

    # projections (>= 2 trailing dims): column- or row-parallel
    if len(dims) >= 2:
        return done(_matrix_spec(plan, dims,
                                 row_parallel=(name in _ROW_PARALLEL)))

    # unknown vectors/scalars: replicate
    return done((None,) * len(dims))


def stacked_spec_for_leaf(plan: ShardingPlan, path: str,
                          shape: Tuple[int, ...]) -> Spec:
    """The placement of a HISTORY leaf: a per-step parameter leaf stacked
    along a leading time axis ``(T, ...)``.  The time axis is never sharded
    (the replay walks it step by step); the per-step dims take the live
    parameter's placement, so the cached path shards like the model."""
    return (None,) + spec_for_leaf(plan, path, tuple(shape[1:]))


def batch_pspec(plan: ShardingPlan, shape: Tuple[int, ...]) -> Spec:
    """Inputs: batch-dim data parallelism when the global batch divides the
    data axis (batch-1 decode shapes replicate)."""
    if not shape:
        return ()
    return (_fit(plan, "data", shape[0]),) + (None,) * (len(shape) - 1)


# --------------------------------------------------------------------------
# Every leaf at once, over FlatParams shapes ({path: shape}, in key_order)
# --------------------------------------------------------------------------


def params_specs(plan: ShardingPlan,
                 shapes: Mapping[str, Tuple[int, ...]]) -> Dict[str, Spec]:
    """{path: placement} of every parameter leaf."""
    return {k: spec_for_leaf(plan, k, tuple(shapes[k])) for k in key_order(shapes)}


def history_specs(plan: ShardingPlan,
                  shapes: Mapping[str, Tuple[int, ...]]) -> Dict[str, Spec]:
    """{path: placement} of every history leaf, the per-step `shapes`
    stacked along a leading time axis (of any length)."""
    return {k: stacked_spec_for_leaf(plan, k, (1,) + tuple(shapes[k]))
            for k in key_order(shapes)}


def inputs_specs(plan: ShardingPlan,
                 shapes: Mapping[str, Tuple[int, ...]]) -> Dict[str, Spec]:
    """{name: placement} of batch-leading model inputs."""
    return {k: batch_pspec(plan, tuple(s)) for k, s in shapes.items()}


# --------------------------------------------------------------------------
# Packed shards of a flat vector
# --------------------------------------------------------------------------


class Shard(NamedTuple):
    """A rank's packed shard of a flat parameter-shaped vector: ``index``
    the flat positions it holds (int64), ``bounds`` its leaves' offsets in
    the packed vector (the packed counterpart of `core.history.leaf_bounds`)."""

    index: np.ndarray
    bounds: Tuple[int, ...]


def _part(mesh: Mesh, entry, coords: Tuple[int, ...]) -> Tuple[int, int]:
    """(parts, this rank's part) of a dim placed by `entry`."""
    if entry is None:
        return 1, 0
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    n, c = 1, 0
    for name in names:
        size = mesh.axis_size(name)
        pos = coords[mesh.axis_names.index(name)] if size > 1 else 0
        n, c = n * size, c * size + pos
    return n, c


def shard_index(plan: ShardingPlan, shapes: Mapping[str, Tuple[int, ...]],
                coords: Optional[Tuple[int, ...]] = None) -> Shard:
    """The packed shard of the rank at `coords` (default: the plan's mesh's
    own) under the leaves' `spec_for_leaf` placements."""
    mesh = plan.mesh
    coords = mesh.coords if coords is None else tuple(coords)
    if coords is None:
        raise ValueError("the mesh is bound to no rank: pass coords")
    parts, bounds, off = [], [0], 0
    for k in key_order(shapes):
        shape = tuple(shapes[k])
        spec = spec_for_leaf(plan, k, shape)
        ranges = []
        for dim, entry in zip(shape, spec):
            n, c = _part(mesh, entry, coords)
            step = dim // n
            ranges.append(np.arange(c * step, (c + 1) * step, dtype=np.int64))
        if ranges:
            idx = np.ravel_multi_index(np.ix_(*ranges), shape).reshape(-1)
        else:  # a 0-d leaf
            idx = np.zeros(1, np.int64)
        parts.append(idx.astype(np.int64) + off)
        off += math.prod(shape)
        bounds.append(bounds[-1] + idx.size)
    index = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return Shard(index, tuple(bounds))


def gather_map(plan: ShardingPlan,
               shapes: Mapping[str, Tuple[int, ...]]) -> np.ndarray:
    """(p,) int64: for each flat position, where it sits in the rank-order
    concatenation of every rank's packed shard, taken from the lowest rank
    that holds it.  Every rank's shard has the same length."""
    mesh = plan.mesh
    shards = [shard_index(plan, shapes, mesh.coords_of(r)).index
              for r in range(mesh.size)]
    n = shards[0].size
    if any(s.size != n for s in shards):
        raise ValueError(f"packed shards differ in length: "
                         f"{sorted({s.size for s in shards})}")
    p = sum(math.prod(tuple(s)) for s in shapes.values())
    src = np.full(p, -1, np.int64)
    for r in reversed(range(mesh.size)):  # the lowest rank writes last
        src[shards[r]] = r * n + np.arange(n, dtype=np.int64)
    if (src < 0).any():
        raise ValueError("the shards leave flat positions uncovered")
    return src


def unshard(shards: Sequence[torch.Tensor], plan: ShardingPlan,
            shapes: Mapping[str, Tuple[int, ...]]) -> torch.Tensor:
    """The flat vector from every rank's packed shard (rank order)."""
    src = torch.from_numpy(gather_map(plan, shapes)).to(shards[0].device)
    return torch.cat(list(shards)).index_select(0, src)
