"""Quickstart on the PyTorch port: train with path caching, then delete 1%
of the data with ONE coalesced DeltaGrad replay through the session API,
comparing against exact retraining (`examples/quickstart.py`'s data, seeds,
sizes and steps; the same lines).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Runs on the card unless given ``--device cpu``.  `main` returns the
session's numbers and tensors for in-process callers; ``params0`` replaces
the initial weights (e.g. the JAX package's, carried across).
"""

import argparse

import numpy as np
import torch

from repro_torch.core.deltagrad import DeltaGradConfig
from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
from repro_torch.data.synthetic import binary_classification
from repro_torch.models.simple import (logreg_accuracy, logreg_init,
                                       logreg_objective)
from repro_torch.utils.tree import tree_norm, tree_sub


def main(argv=None, params0=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    ds = binary_classification(n=5000, d=200, seed=0)
    if params0 is None:
        params0 = logreg_init(200, torch.Generator().manual_seed(1))
    sess = UnlearnerSession(
        objective=logreg_objective(l2=5e-3),
        params0=params0,
        dataset=ds,
        config=UnlearnerConfig(
            steps=100, batch_size=1024, lr=0.3, seed=0,
            deltagrad=DeltaGradConfig(period=5, burn_in=10, history_size=2),
        ),
        device=args.device,
    )

    print("== phase 1: train once, caching the optimization path ==")
    sess.fit()
    print(f"accuracy: {logreg_accuracy(sess.params, ds):.4f}, "
          f"cached {len(sess.history)} steps "
          f"({sess.history.nbytes() / 1e6:.1f} MB)")

    print("\n== phase 2: a user asks for 50 rows to be deleted ==")
    to_delete = np.random.default_rng(3).choice(ds.n, 50, replace=False)
    w_exact, base_stats = sess.baseline(to_delete)  # ground truth

    # delete() is lazy: nothing executes until the handle is forced; the
    # planner then coalesces the whole batch into ONE group replay that
    # also rewrites the cached path, so later requests build on it
    handle = sess.delete(to_delete.tolist())
    resp = handle.result()  # flush + block
    stats = resp.stats[0]

    dist = float(tree_norm(tree_sub(w_exact, sess.params)))
    print(f"DeltaGrad: one coalesced replay for {resp.group_size} rows "
          f"({stats.explicit_steps} explicit + {stats.approx_steps} approx "
          f"steps, dispatched in {resp.dispatch_s * 1e3:.0f} ms)")
    print(f"BaseL (exact retrain): {base_stats.wall_time_s:.2f}s")
    print(f"gradient evaluations: {stats.grad_examples:,} vs "
          f"{stats.grad_examples_baseline:,} "
          f"(x{stats.theoretical_speedup:.2f} fewer)")
    print(f"||w_exact - w_deltagrad|| = {dist:.2e}")
    print(f"accuracy after deletion: {logreg_accuracy(sess.params, ds):.4f}")
    return {"params": sess.params, "w_exact": w_exact, "dist": dist,
            "stats": stats}


if __name__ == "__main__":
    main()
