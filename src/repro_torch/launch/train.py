"""End-to-end training driver.

Trains an LM-family arch (reduced or full config) with AdamW under a
warmup-cosine schedule, checkpoint/restart, a deterministic data order and
a step timer; or runs the paper's own train -> delete -> DeltaGrad-retrain
flow for the `simple` family.  The JAX package's ``launch/train.py``, flag
for flag, plus ``--device`` (the card unless ``cpu`` is asked for):

    python -m repro_torch.launch.train --arch internlm2-1.8b --reduced \\
        --device cpu --steps 200 --batch 8 --seq 128 --ckpt /tmp/ckpt
    python -m repro_torch.launch.train --arch paper-logreg --device cpu \\
        --steps 150 --delete-frac 0.01

An encoder-decoder (``--arch whisper-large-v3``) trains on stub frames
(B, seq, d_model) N(0, 1) in bf16, drawn each step from a generator
seeded by the step, as the reference draws them from ``PRNGKey(step)``
(the numbers differ), so a resumed run sees the same frames.

Resume: re-run the same command; the driver picks up the last complete
step (a checkpoint holds the whole `TrainState`: params, AdamW's m and v
and the step, under the reference's names, so a checkpoint either
package wrote resumes in the other).  The last step's checkpoint is
written once: where ``--ckpt-every`` divides ``--steps`` the reference
writes the same state there a second time.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.engine import _sync, resolve_device
from repro_torch.data.sampler import batch_indices
from repro_torch.data.synthetic import binary_classification, token_stream
from repro_torch.models.registry import build
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import make_train_step
from repro_torch.train.state import init_state
from repro_torch.train.straggler import StepTimer


def train_lm(args) -> dict:
    """Train and checkpoint; returns ``{"state", "losses" (step -> loss),
    "lrs", "start", "timer"}`` for the steps this call ran."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)  # raises for a family the port lacks
    params = model.init(args.seed, device=dev)
    opt = adamw(weight_decay=0.01)
    lr = warmup_cosine(args.lr, warmup=max(args.steps // 20, 1),
                       total_steps=args.steps)
    loss_fn = lambda p, b: model.loss_fn(  # noqa: E731
        p, b, remat=False, loss_chunk=min(128, args.seq))
    step_fn = make_train_step(loss_fn, opt, lr)
    state = init_state(params, opt)

    corpus = token_stream(n_docs=max(args.batch * 8, 64), seq_len=args.seq,
                          vocab=cfg.vocab, seed=args.seed)

    start = 0
    if args.ckpt:
        last = ckpt.latest_step(args.ckpt)
        if last is not None:
            state = ckpt.restore(args.ckpt, last, state)
            start = last
            print(f"resumed from step {last}")

    timer = StepTimer()
    losses, lrs = {}, {}
    for step in range(start, args.steps):
        idx = batch_indices(args.seed, step, corpus.n, args.batch)
        batch = {"tokens": torch.from_numpy(corpus.take(idx)["tokens"]).to(dev)}
        if cfg.family == "audio":  # stub frames, drawn anew from the step
            batch["frames"] = torch.randn(
                args.batch, args.seq, cfg.d_model, dtype=torch.bfloat16,
                device=dev,
                generator=torch.Generator(device=dev).manual_seed(step))
        timer.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # the step's one host sync
        dt = timer.stop()
        losses[step], lrs[step] = loss, metrics["lr"]
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms "
                  f"p50 {timer.percentile(0.5)*1e3:6.1f} ms")
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt, step + 1, state)
    if args.ckpt and ckpt.latest_step(args.ckpt) != args.steps:
        ckpt.save(args.ckpt, args.steps, state)  # unless the loop just wrote it
    _sync(dev)
    print("done.")
    return {"state": state, "losses": losses, "lrs": lrs, "start": start,
            "timer": timer}


def train_paper(args) -> dict:
    """Train logistic regression with path caching, delete a fraction of
    the rows, and hold DeltaGrad's retrain against BaseL; returns the
    printed numbers."""
    from repro_torch.core.api import Unlearner, UnlearnerConfig
    from repro_torch.core.deltagrad import DeltaGradConfig
    from repro_torch.models.simple import (logreg_accuracy, logreg_init,
                                           logreg_objective)
    from repro_torch.utils.tree import tree_norm, tree_sub

    dev = resolve_device(args.device)
    ds = binary_classification(n=args.n, d=args.dim, seed=args.seed)
    unl = Unlearner(
        logreg_objective(l2=5e-3),
        logreg_init(args.dim, torch.Generator().manual_seed(args.seed),
                    device=dev),
        ds,
        UnlearnerConfig(steps=args.steps, batch_size=args.batch, lr=args.lr,
                        seed=args.seed,
                        deltagrad=DeltaGradConfig(period=5, burn_in=10)),
        device=dev,
    )
    t0 = time.perf_counter()
    unl.fit()
    _sync(dev)
    acc = logreg_accuracy(unl.params, ds)
    print(f"trained {args.steps} steps in {time.perf_counter()-t0:.2f}s, "
          f"acc={acc:.4f}")
    r = max(1, int(args.delete_frac * ds.n))
    removed = np.random.default_rng(args.seed).choice(ds.n, r, replace=False)
    w_u, base_stats = unl.baseline(removed)
    stats = unl.delete(removed)
    dist = float(tree_norm(tree_sub(w_u, unl.params)))
    print(f"deleted {r} rows: DeltaGrad {stats.wall_time_s:.2f}s "
          f"(BaseL {base_stats.wall_time_s:.2f}s, "
          f"speedup x{base_stats.wall_time_s/max(stats.wall_time_s,1e-9):.2f}; "
          f"grad-eval speedup x{stats.theoretical_speedup:.2f}) "
          f"||w_U - w_I|| = {dist:.3e}")
    return {"acc": acc, "r": r, "dist": dist, "stats": stats,
            "base_stats": base_stats}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    # paper-model options
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--delete-frac", type=float, default=0.01)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if cfg.family == "simple":
        if args.lr == 3e-4:
            args.lr = 0.1  # paper default
        return train_paper(args)
    return train_lm(args)


if __name__ == "__main__":
    main()
