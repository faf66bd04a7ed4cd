"""LM unlearning quickstart on the PyTorch port: DeltaGrad on a transformer
language model (`examples/unlearn_lm.py`'s data, seeds, sizes and steps;
the same lines).

Three lines connect the model zoo to the unlearning engine:

    sess = UnlearnerSession.from_config("internlm2-1.8b", docs,
                                        reduced=..., config=...)
    sess.fit()                      # SGD with path caching (Algorithm 1)
    sess.delete(doc_ids).result()   # cached-path correction (Algorithm 4)

`from_config` resolves the registry name, builds the model, and wraps its
masked token cross-entropy into the engine's per-document `Objective`
through `Objective.from_model`.  The session then exposes the whole request
surface on the LM: delete/add with coalescing, the Algorithm-4 curvature
guard (non-convex models need it), snapshot/restore, and `baseline()` for
the exact-retrain reference.

This script uses a reduction of the internlm2-1.8b architecture (the same
blocks, GQA + RoPE + SwiGLU, at toy width), in bf16 compute.  Drop
``reduced=`` to run the real config; at that scale set ``remat=True`` and
pick a host-tier delta codec (`UnlearnerConfig(history_codec=
"delta_int8")`) so the cached path fits.

    PYTHONPATH=src python examples/torch/unlearn_lm.py [--device cpu]

Runs on the card unless given ``--device cpu``.  `main` returns the
numbers and tensors for in-process callers; ``params0`` replaces the
initial weights (e.g. the JAX package's, carried across with
`models.registry.params_from_jax`).
"""

import argparse

import torch

from repro_torch.core.deltagrad import DeltaGradConfig
from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
from repro_torch.data.synthetic import token_stream
from repro_torch.utils.tree import tree_norm, tree_sub


def main(argv=None, params0=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    docs = token_stream(n_docs=256, seq_len=32, vocab=128, seed=0)
    sess = UnlearnerSession.from_config(
        "internlm2-1.8b", docs,
        reduced=dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=128, d_head=16),
        # the paper's DNN recipe (§4.1): small T0, long burn-in, guard on
        config=UnlearnerConfig(steps=40, batch_size=64, lr=0.02, seed=5,
                               deltagrad=DeltaGradConfig(
                                   period=2, burn_in=10, history_size=2,
                                   guard=True, curvature_eps=1e-8)),
        loss_chunk=32, params0=params0, device=args.device)

    print("== training LM with path caching ==")
    w_star = sess.fit()
    print(f"cached {len(sess.history)} steps, "
          f"{sess.history.nbytes() / 1e6:.1f} MB")

    print("\n== deleting 4 documents with DeltaGrad (Algorithm-4 guard) ==")
    removed = [7, 42, 99, 120]
    w_u, _ = sess.baseline(removed)        # exact retrain, for reference
    resp = sess.delete(removed).result()
    w_i, stats = resp.params, resp.stats[0]

    d_ui = float(tree_norm(tree_sub(w_u, w_i)))
    d_us = float(tree_norm(tree_sub(w_u, w_star)))
    print(f"||w_exact - w_deltagrad|| = {d_ui:.3e}")
    print(f"||w_exact - w_original|| = {d_us:.3e}  "
          f"(DeltaGrad is {d_us / max(d_ui, 1e-12):.1f}x closer)")
    print(f"guard fallbacks: {stats.guard_fallbacks}, "
          f"grad-eval speedup x{stats.theoretical_speedup:.2f}")

    # behavioural check: loss on the removed docs should move toward w_u's
    toks = torch.from_numpy(docs.columns["tokens"][removed]).to(sess.device)
    losses = {}
    with torch.no_grad():
        for name, w in [("original", w_star), ("deltagrad", w_i), ("exact", w_u)]:
            losses[name] = float(sess.model.loss_fn(w, {"tokens": toks},
                                                    remat=False, loss_chunk=32))
            print(f"loss on removed docs [{name}]: {losses[name]:.4f}")
    return {"params": w_i, "w_exact": w_u, "w_star": w_star, "d_ui": d_ui,
            "d_us": d_us, "losses": losses, "stats": stats}


if __name__ == "__main__":
    main()
