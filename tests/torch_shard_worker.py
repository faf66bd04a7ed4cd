"""The rank program of tests/test_torch_shard.py.

Each rank of a gloo process group on the CPU (one process per rank,
started by `torch.multiprocessing`) runs the same cases: the port's
sharded replay, online stream and session on a `PlacementPolicy`, and the
same calls on one rank without a placement.  Every rank pickles what it
got to ``<out>/rank<r>.pkl``; the test compares.  The problems are the
JAX package's mesh tests' (tests/test_shard.py): logreg at d 16, and the
MLP 32 -> 24 -> 2.  Imports torch and numpy only (no JAX in a rank).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.deltagrad import (DeltaGradConfig, deltagrad_retrain,
                                        sgd_train_with_cache)
from repro_torch.core.history import HistoryMeta
from repro_torch.core.online import online_deltagrad
from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
from repro_torch.core.store import PlacementPolicy
from repro_torch.data.synthetic import binary_classification
from repro_torch.models.simple import (logreg_objective, mlp_objective,
                                       params_from_jax)

CHANGED = np.arange(5)
STREAM = [("delete", 3), ("add", None), ("delete", 17)]  # None: the added row


def cfg(**kw) -> DeltaGradConfig:
    return DeltaGradConfig(period=5, burn_in=10, history_size=2, **kw)


MLP_CFG = dict(guard=True, curvature_eps=1e-8)


def logreg_init(d: int = 16) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(1)
    return {"w": (0.01 * rng.normal(size=d)).astype(np.float32),
            "b": np.zeros((), np.float32)}


def mlp_init(d: int = 32, hidden: int = 24, classes: int = 2) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(1)
    return {"w1": (rng.normal(size=(d, hidden)) / np.sqrt(d)).astype(np.float32),
            "b1": np.zeros(hidden, np.float32),
            "w2": (rng.normal(size=(hidden, classes)) / np.sqrt(hidden)).astype(np.float32),
            "b2": np.zeros(classes, np.float32)}


def logreg_data():
    return binary_classification(n=200, d=16, seed=0)


def mlp_data():
    ds = binary_classification(n=240, d=32, seed=0)
    ds.columns["y"] = ds.columns["y"].astype(np.int32)
    return ds


LOGREG_META = dict(n=200, batch_size=64, seed=0, steps=30, lr_schedule=((0, 0.2),))
MLP_META = dict(n=240, batch_size=80, seed=0, steps=24, lr_schedule=((0, 0.1),))


def _result(params, stats) -> Dict[str, Any]:
    return {"w": params.flat.detach().numpy().copy(),
            "counters": stats.counters(), "extra": {
                k: v for k, v in stats.extra.items()
                if isinstance(v, (int, float, str, dict))}}


def replay_case(pol: PlacementPolicy, single: bool,
                streamed: bool = True) -> Dict[str, Any]:
    """The MLP's delete and add replays resident on `pol`, and with
    `streamed` the f32 host tier streamed in windows of 8 and delta_int8
    in kernel and fetch mode; with `single`, each also on one rank (the
    rank-0 process computes those)."""
    obj = mlp_objective(l2=1e-3)
    p0 = params_from_jax(mlp_init(), "cpu")
    meta = HistoryMeta(**MLP_META)
    c = cfg(**MLP_CFG)
    out: Dict[str, Any] = {}
    ds = mlp_data()
    _, h = sgd_train_with_cache(obj, p0, ds, meta, device="cpu")
    runs = [("sharded", {"placement": pol})] + ([("single", {})] if single else [])
    for name, kw in runs:
        out[f"delete/{name}"] = _result(*deltagrad_retrain(
            obj, h, ds, CHANGED, c, device="cpu", **kw))
    ds_add = mlp_data()
    new = ds_add.append({k: v[:3] for k, v in ds_add.columns.items()})
    for name, kw in runs:
        out[f"add/{name}"] = _result(*deltagrad_retrain(
            obj, h, ds_add, new, c, mode="add", device="cpu", **kw))
    if not streamed:
        return out
    _, hh = sgd_train_with_cache(obj, p0, ds, meta, tier="host", device="cpu")
    out["host_f32/sharded"] = _result(*deltagrad_retrain(
        obj, hh, ds, CHANGED, dataclasses.replace(c, stream_window=8),
        device="cpu", placement=pol))
    _, hd = sgd_train_with_cache(obj, p0, ds, meta, tier="host",
                                 codec="delta_int8", device="cpu")
    for mode in ("kernel", "fetch"):
        cm = dataclasses.replace(c, stream_window=8, stream_decode=mode)
        out[f"delta_int8_{mode}/sharded"] = _result(*deltagrad_retrain(
            obj, hd, ds, CHANGED, cm, device="cpu", placement=pol))
    if single:
        out["delta_int8_kernel/single"] = _result(*deltagrad_retrain(
            obj, hd, ds, CHANGED, dataclasses.replace(
                c, stream_window=8, stream_decode="kernel"), device="cpu"))
    return out


def online_case(pol: PlacementPolicy, single: bool) -> Dict[str, Any]:
    """A delete, add, delete stream on logreg on `pol` (and with `single`
    on one rank)."""
    out = {}
    runs = [("sharded", {"placement": pol})] + ([("single", {})] if single else [])
    for name, kw in runs:
        ds = logreg_data()
        _, h = sgd_train_with_cache(logreg_objective(l2=1e-3),
                                    params_from_jax(logreg_init(), "cpu"), ds,
                                    HistoryMeta(**LOGREG_META), device="cpu")
        add = ds.append({k: v[:1] for k, v in ds.columns.items()})
        reqs = [(op, int(add[0]) if row is None else row) for op, row in STREAM]
        w, st = online_deltagrad(logreg_objective(l2=1e-3), h, ds, reqs, cfg(),
                                 device="cpu", **kw)
        out[name] = {"w": w.flat.numpy().copy(),
                     "counters": [s.counters() for s in st.per_request],
                     "mesh": [s.extra.get("mesh") for s in st.per_request]}
    return out


def session_case(pol: PlacementPolicy, directory: str) -> Dict[str, Any]:
    """A logreg session on `pol` (stacked, and host f32 in windows of 8):
    fit, a burst, save, restore on every rank, then the next request on
    both; and the restored policy's mesh shape."""
    out = {}
    for tier, kw in (("stacked", {}), ("host", dict(history_tier="host"))):
        config = UnlearnerConfig(
            steps=30, batch_size=64, lr=0.2, seed=0, placement=pol,
            deltagrad=dataclasses.replace(cfg(), stream_window=8), **kw)
        obj = logreg_objective(l2=1e-3)
        sess = UnlearnerSession(obj, params_from_jax(logreg_init(), "cpu"),
                                logreg_data(), config, device="cpu")
        sess.fit()
        sess.delete([3, 17]).result()
        path = os.path.join(directory, tier)
        sess.save(path)
        restored = UnlearnerSession.restore(path, obj, device="cpu")
        kind = restored.engine().store.kind
        a = sess.delete([40]).params.flat.numpy().copy()
        b = restored.delete([40]).params.flat.numpy().copy()
        out[tier] = {"uninterrupted": a, "restored": b, "store": kind,
                     "mesh_shape": restored.config.placement.mesh_shape}
    return out


def run(rank: int, world: int, init_file: str, out_dir: str,
        meshes: Dict[str, tuple]) -> None:
    """Rank `rank` of `world`: every case on the 1-D data mesh, and the
    resident replays on each extra mesh of `meshes` ({name: (shape, axis
    names)}); rank 0 also runs the single-rank replays and stream, once."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        pol = PlacementPolicy.local()
        single = rank == 0
        res = {"replay": replay_case(pol, single),
               "online": online_case(pol, single),
               "session": session_case(pol, os.path.join(out_dir, "session"))}
        for name, (shape, axes) in meshes.items():
            res[f"replay@{name}"] = replay_case(PlacementPolicy(shape, axes),
                                                False, streamed=False)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
