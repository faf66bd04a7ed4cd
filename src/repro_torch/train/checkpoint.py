"""Fault-tolerant checkpointing: sharded .npz chunks + atomic manifest.

The JAX package's layout, so a params shard written by either package
restores in the other:

    <dir>/step_<N>/shard_<host>.npz     one file per host, one member per
                                        parameter leaf, keyed by its
                                        "/"-joined key path
    <dir>/step_<N>/extra.pkl            optional pickled payload
    <dir>/step_<N>/MANIFEST.json        written LAST (atomic rename): a step
                                        directory without it is incomplete
                                        and ignored on resume.

`latest_step` + `restore` give crash-safe resume; `save` prunes old steps
(keep_last).  The extra payload holds numpy arrays and plain dataclasses,
never device tensors, so reading it needs no card.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.utils.tree import FlatParams, key_order


def _leaves_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: params[k].detach().cpu().numpy() for k in key_order(params)}


def save(
    directory: str,
    step: int,
    params: Mapping[str, torch.Tensor],
    extra: Optional[Dict[str, Any]] = None,
    host_id: int = 0,
    n_hosts: int = 1,
    keep_last: int = 3,
) -> str:
    """Write a checkpoint; returns the step directory path."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    flat = _leaves_numpy(params)
    shard_path = os.path.join(step_dir, f"shard_{host_id:05d}.npz")
    tmp = shard_path + ".tmp"
    with open(tmp, "wb") as f:  # np.savez would append .npz to a bare path
        np.savez(f, **flat)
    os.replace(tmp, shard_path)
    if extra is not None:
        etmp = os.path.join(step_dir, "extra.pkl.tmp")
        with open(etmp, "wb") as f:
            pickle.dump(extra, f)
        os.replace(etmp, os.path.join(step_dir, "extra.pkl"))
    if host_id == 0:
        manifest = {
            "step": step,
            "n_hosts": n_hosts,
            "keys": sorted(flat.keys()),
            "time": time.time(),
        }
        mtmp = os.path.join(step_dir, "MANIFEST.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(step_dir, "MANIFEST.json"))
        _prune(directory, keep_last)
    return step_dir


def _prune(directory: str, keep_last: int) -> None:
    for s in complete_steps(directory)[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def complete_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "MANIFEST.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = complete_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like: FlatParams,
            host_id: int = 0) -> FlatParams:
    """The step's params in the layout of `like`, on its device and in its
    dtype (a leaf the shard lacks, or of another shape, raises)."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(step_dir, "MANIFEST.json")):
        raise FileNotFoundError(f"incomplete checkpoint: {step_dir}")
    with np.load(os.path.join(step_dir, f"shard_{host_id:05d}.npz")) as data:
        leaves = {k: data[k] for k in like.shapes}
    for k, shape in like.shapes.items():
        if leaves[k].shape != tuple(shape):
            raise ValueError(f"leaf {k!r}: checkpoint shape "
                             f"{leaves[k].shape}, expected {tuple(shape)}")
    return FlatParams.from_tensors(leaves, device=like.flat.device,
                                   dtype=like.flat.dtype)


def restore_extra(directory: str, step: int) -> Optional[Dict[str, Any]]:
    path = os.path.join(directory, f"step_{step:08d}", "extra.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)
