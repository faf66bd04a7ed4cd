"""Fault-tolerant checkpointing: sharded .npz chunks + atomic manifest.

The JAX package's layout, so a checkpoint written by either package
restores in the other:

    <dir>/step_<N>/shard_<host>.npz     one file per host, one member per
                                        leaf, keyed by its "/"-joined key
                                        path: a parameter set's leaves by
                                        theirs; a whole `TrainState` under
                                        the names the reference's
                                        ``_flatten_with_names`` gives its
                                        NamedTuple (``.params/<path>``,
                                        ``.opt_state/m/<path>``,
                                        ``.opt_state/v/<path>``,
                                        ``.opt_state/step``, ``.step``)
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

from repro_torch.train.state import TrainState
from repro_torch.utils.tree import FlatParams, key_order


def _leaves_numpy(params: Mapping[str, torch.Tensor],
                  prefix: str = "") -> Dict[str, np.ndarray]:
    return {prefix + k: params[k].detach().cpu().numpy()
            for k in key_order(params)}


def _flatten_state(state: TrainState) -> Dict[str, np.ndarray]:
    """A TrainState's members under the reference's names: a flat tensor of
    the optimizer state is laid out as the parameters are, a count is a
    0-d int32."""
    flat = _leaves_numpy(state.params, ".params/")
    for name, val in state.opt_state.items():
        if isinstance(val, torch.Tensor):
            flat.update(_leaves_numpy(state.params.with_flat(val),
                                      f".opt_state/{name}/"))
        else:
            flat[f".opt_state/{name}"] = np.asarray(val, np.int32)
    flat[".step"] = np.asarray(state.step, np.int32)
    return flat


def save(
    directory: str,
    step: int,
    state: Any,
    extra: Optional[Dict[str, Any]] = None,
    host_id: int = 0,
    n_hosts: int = 1,
    keep_last: int = 3,
) -> str:
    """Write a checkpoint of `state` (a parameter set, or a whole
    `TrainState`); returns the step directory path."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    flat = (_flatten_state(state) if isinstance(state, TrainState)
            else _leaves_numpy(state))
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


def _read_flat(data, like: FlatParams, prefix: str = "") -> FlatParams:
    """The leaves ``prefix + path`` of an open shard in the layout of
    `like`, on its device and in its dtype (a leaf the shard lacks, or of
    another shape, raises)."""
    leaves = {k: data[prefix + k] for k in like.shapes}
    for k, shape in like.shapes.items():
        if leaves[k].shape != tuple(shape):
            raise ValueError(f"leaf {prefix + k!r}: checkpoint shape "
                             f"{leaves[k].shape}, expected {tuple(shape)}")
    return FlatParams.from_tensors(leaves, device=like.flat.device,
                                   dtype=like.flat.dtype)


def restore(directory: str, step: int, like: Any, host_id: int = 0) -> Any:
    """The step's checkpoint in the structure of `like`: a `FlatParams`
    gives the params, a `TrainState` the whole state (its tensors on the
    devices and in the dtypes of `like`'s)."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(step_dir, "MANIFEST.json")):
        raise FileNotFoundError(f"incomplete checkpoint: {step_dir}")
    with np.load(os.path.join(step_dir, f"shard_{host_id:05d}.npz")) as data:
        if not isinstance(like, TrainState):
            return _read_flat(data, like)
        opt = {}
        for name, val in like.opt_state.items():
            if isinstance(val, torch.Tensor):
                opt[name] = _read_flat(
                    data, like.params.with_flat(val), f".opt_state/{name}/").flat
            else:
                opt[name] = int(data[f".opt_state/{name}"])
        return TrainState(_read_flat(data, like.params, ".params/"), opt,
                          int(data[".step"]))


def restore_extra(directory: str, step: int) -> Optional[Dict[str, Any]]:
    path = os.path.join(directory, f"step_{step:08d}", "extra.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)
