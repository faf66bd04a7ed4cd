"""GDPR-style online request service with eps-approximate-deletion noise,
on the PyTorch port (`examples/online_deletion.py`'s data, seeds, sizes and
steps; the same lines).

Requests go to an `UnlearnerSession`: deletes arriving as a burst coalesce
into ONE group replay, a serial stream keeps the paper's
one-replay-per-request Algorithm-3 semantics, additions join through their
deterministic mask columns, and the whole mid-stream session snapshots to
disk and restores without changing what it serves next.  The published
model gets Laplace noise per §5.1, drawn from a torch generator seeded 0
(the reference draws from ``jax.random.PRNGKey(0)``).

    PYTHONPATH=src python examples/torch/online_deletion.py [--device cpu]

Runs on the card unless given ``--device cpu``.  `main` returns the
session's numbers and tensors for in-process callers; ``params0`` replaces
the initial weights (e.g. the JAX package's, carried across).
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.deltagrad import DeltaGradConfig
from repro_torch.core.privacy import laplace_publish, num_params
from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
from repro_torch.data.synthetic import binary_classification
from repro_torch.models.simple import (logreg_accuracy, logreg_init,
                                       logreg_objective)


def main(argv=None, params0=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    objective = logreg_objective(l2=5e-3)
    ds = binary_classification(n=4000, d=500, seed=0)
    if params0 is None:
        params0 = logreg_init(500, torch.Generator().manual_seed(1))
    sess = UnlearnerSession(
        objective, params0, ds,
        UnlearnerConfig(steps=80, batch_size=1024, lr=0.3, seed=0,
                        deltagrad=DeltaGradConfig(period=5, burn_in=10)),
        device=args.device,
    )
    sess.fit()
    print(f"initial accuracy {logreg_accuracy(sess.params, ds):.4f}")

    # a burst of 12 deletion requests: the planner coalesces them into
    # ONE replay (group-deletion semantics) instead of 12
    requests = np.random.default_rng(9).choice(ds.n, 12, replace=False)
    t0 = time.time()
    resp = sess.delete(requests.tolist()).result()
    dt = time.time() - t0
    st = resp.stats[0]
    print(f"{resp.group_size} deletes coalesced into 1 replay in {dt:.2f}s "
          f"({dt / len(requests) * 1e3:.0f} ms/request), "
          f"grad-eval speedup x{st.theoretical_speedup:.2f}")
    print(f"accuracy after burst: {logreg_accuracy(sess.params, ds):.4f}")

    # additions stream on the same engine (serial Algorithm-3 add-mode:
    # fresh rows join the replayed batches via deterministic join masks)
    rng = np.random.default_rng(10)
    src = rng.choice(4000, 6)  # one draw so features and labels stay paired
    rows = {k: v[src] for k, v in ds.columns.items()}
    t0 = time.time()
    added = sess.stream_add(rows)
    dt = time.time() - t0
    print(f"\n6 addition requests in {dt:.2f}s "
          f"({dt / 6 * 1e3:.0f} ms/request); "
          f"accuracy {logreg_accuracy(sess.params, ds):.4f}")

    # snapshot the mid-stream session and restore it: params, history,
    # liveness, added rows and the L-BFGS ring round-trip through
    # train/checkpoint, so the restored service picks up where it left off
    with tempfile.TemporaryDirectory() as ckpt_dir:
        sess.save(ckpt_dir)
        sess = UnlearnerSession.restore(ckpt_dir, objective, device=args.device)
    stats = sess.stream_delete([100, 200])
    print(f"\nrestored session served {len(stats.per_request)} more "
          f"requests; accuracy {logreg_accuracy(sess.params, ds):.4f}")

    # publish with epsilon-approximate-deletion noise (Laplace mechanism)
    eps, delta0 = 1.0, 1e-4  # delta0: certified ||w_I - w_U|| bound
    gen = torch.Generator(device=sess.device).manual_seed(0)
    published = laplace_publish(gen, sess.params, eps, delta0)
    print(f"\npublished eps={eps} noisy model "
          f"(p={num_params(sess.params)}, delta0={delta0}): "
          f"accuracy {logreg_accuracy(published, ds):.4f}")
    return {"params": sess.params, "published": published, "burst": st,
            "adds": added, "restored": stats}


if __name__ == "__main__":
    main()
