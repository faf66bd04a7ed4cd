"""Parameters as a dict of tensors, and the vector-space helpers over them.

DeltaGrad's L-BFGS machinery needs only inner products and linear
combinations of parameter-shaped objects.  The port keeps every parameter
set as ONE flat buffer whose leaves are views into it (`FlatParams`).  A
nested parameter dict (the LM's ``{"u0": {"mixer": {"wq": ...}}}``) is
kept flat under its ``/``-joined key paths (``"u0/mixer/wq"``), and the
leaves are laid out in `key_order`: sorted by key path, which is the order
jax's ``ravel_pytree`` gives the nested dict.  So a flat vector of the port
compares directly with one of the JAX package, and each kernel runs once
per step over all of p instead of once per leaf.  `nested` gives the nested
view back.

The ``tree_*`` helpers take a dict of tensors or a single tensor (its own
one leaf), and walk dict leaves in `key_order` like ``jax.tree``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Mapping, Tuple, Union

import torch

Tree = Union[torch.Tensor, Mapping[str, torch.Tensor]]
SEP = "/"


def key_order(keys: Iterable[str]) -> List[str]:
    """Keys sorted by their path (``"a/b"`` as ``("a", "b")``): jax's
    tree-flatten order for the nested dict the paths spell out."""
    return sorted(keys, key=lambda k: tuple(k.split(SEP)))


def flatten_nested(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict of leaves as ``{"a/b": leaf}`` (a leaf is anything
    that is not a dict), in `key_order`."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.update(flatten_nested(v, f"{prefix}{k}{SEP}"))
        else:
            out[f"{prefix}{k}"] = v
    return {k: out[k] for k in key_order(out)}


def nested(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of `flatten_nested`: ``{"a/b": x}`` -> ``{"a": {"b": x}}``
    (the leaves themselves, e.g. views of a `FlatParams`, not copies)."""
    out: Dict[str, Any] = {}
    for k in key_order(flat):
        *path, last = k.split(SEP)
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = flat[k]
    return out


def _leaves(a: Tree):
    if isinstance(a, torch.Tensor):
        return [a]
    return [a[k] for k in key_order(a)]


def tree_sub(a: Tree, b: Tree) -> Tree:
    if isinstance(a, torch.Tensor):
        return a - b
    return {k: a[k] - b[k] for k in key_order(a)}


def tree_vdot(a: Tree, b: Tree) -> torch.Tensor:
    """Full-precision (f32) inner product <a, b> over every leaf."""
    parts = [torch.dot(x.float().reshape(-1), y.float().reshape(-1))
             for x, y in zip(_leaves(a), _leaves(b))]
    return parts[0] if len(parts) == 1 else torch.stack(parts).sum()


def tree_norm(a: Tree) -> torch.Tensor:
    return torch.sqrt(tree_vdot(a, a))


def tree_all_finite(a: Tree) -> torch.Tensor:
    """0-d bool tensor on a's device; reading it is the caller's sync."""
    oks = [torch.isfinite(x).all() for x in _leaves(a)]
    ok = oks[0]
    for x in oks[1:]:
        ok = ok & x
    return ok


class FlatParams(dict):
    """A dict of parameter tensors that are views into one flat buffer.

    Leaves are laid out in `key_order`, each raveled row-major: the layout
    of ``jax.flatten_util.ravel_pytree`` on the same (nested) dict.  ``flat``
    is the buffer; ``with_flat`` gives another buffer the same layout.
    """

    def __init__(self, flat: torch.Tensor, shapes: Mapping[str, Tuple[int, ...]]):
        if flat.dim() != 1:
            raise ValueError(f"flat buffer must be 1-D, got {tuple(flat.shape)}")
        views = {}
        off = 0
        for k in key_order(shapes):
            n = math.prod(shapes[k])
            views[k] = flat[off:off + n].view(tuple(shapes[k]))
            off += n
        if off != flat.numel():
            raise ValueError(f"layout holds {off} values, buffer {flat.numel()}")
        super().__init__(views)
        self.flat = flat
        self.shapes: Dict[str, Tuple[int, ...]] = {
            k: tuple(shapes[k]) for k in key_order(shapes)}

    @classmethod
    def from_tensors(cls, tensors: Mapping[str, object], device=None,
                     dtype: torch.dtype = torch.float32) -> "FlatParams":
        """Copy a dict of arrays (numpy or torch) into one new flat buffer."""
        names = key_order(tensors)
        parts = [torch.as_tensor(tensors[k]) for k in names]
        flat = torch.cat([x.to(device=device, dtype=dtype).reshape(-1)
                          for x in parts])
        return cls(flat, {k: tuple(x.shape) for k, x in zip(names, parts)})

    def with_flat(self, flat: torch.Tensor) -> "FlatParams":
        return FlatParams(flat, self.shapes)

    def to(self, device) -> "FlatParams":
        return self.with_flat(self.flat.to(device))

    @property
    def numel(self) -> int:
        return self.flat.numel()
