"""§5.5 application on the PyTorch port: jackknife bias correction via
DeltaGrad leave-one-out (`examples/jackknife.py`'s data, seeds, sizes and
steps; the same lines).

Recomputing an estimator on all n leave-one-out datasets is the jackknife's
cost problem; DeltaGrad makes each refit ~T0x cheaper.

    PYTHONPATH=src python examples/torch/jackknife.py [--device cpu]

Runs on the card unless given ``--device cpu``.  `main` returns the
numbers and the trained weights for in-process callers; ``params0``
replaces the initial weights (e.g. the JAX package's, carried across).
"""

import argparse

import numpy as np
import torch

from repro_torch.core.applications import data_values, jackknife_bias_correct
from repro_torch.core.deltagrad import DeltaGradConfig, sgd_train_with_cache
from repro_torch.core.history import HistoryMeta
from repro_torch.data.synthetic import binary_classification
from repro_torch.models.simple import logreg_init, logreg_objective


def main(argv=None, params0=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    # logistic regression with n not >> p: the regime the paper names
    # (Sur & Candes) where MLE bias is real and jackknife correction helps
    n, d = 400, 60
    ds = binary_classification(n=n, d=d, seed=0, margin=2.0)
    obj = logreg_objective(l2=1e-3)
    meta = HistoryMeta(n=n, batch_size=n, seed=1, steps=80,
                       lr_schedule=((0, 0.5),))
    if params0 is None:
        params0 = logreg_init(d, torch.Generator().manual_seed(2))
    w_star, hist = sgd_train_with_cache(obj, params0, ds, meta,
                                        device=args.device)

    cfg = DeltaGradConfig(period=10, burn_in=10)

    print("== jackknife bias correction of ||w||^2 (30 leave-one-out fits) ==")
    est = lambda p: np.array([float(np.sum(p["w"].detach().cpu().numpy() ** 2))])  # noqa
    out = jackknife_bias_correct(est, obj, hist, ds, cfg, indices=range(30),
                                 device=args.device)
    print(f"raw estimate: {out['estimate'][0]:.4f}")
    print(f"jackknife bias: {out['bias'][0]:+.4f}")
    print(f"corrected: {out['corrected'][0]:.4f}")

    print("\n== deletion diagnostics (Cook, §5.4): most influential rows ==")
    idx = list(range(20))
    vals = data_values(obj, hist, ds, idx, cfg, device=args.device)
    order = np.argsort(-vals)
    for i in order[:5]:
        print(f"row {idx[i]:3d}: ||w_-i - w*|| = {vals[i]:.3e}")
    return {"params": w_star, "jackknife": out, "values": vals}


if __name__ == "__main__":
    main()
