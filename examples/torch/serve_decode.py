"""Serving example on the PyTorch port: batched greedy decode with
per-block KV/recurrent caches, across four architecture families (GQA, MLA,
hybrid-SSM, xLSTM); `examples/serve_decode.py`'s configs, seeds, sizes and
steps, and the same lines.

The reference jits its step; here `decode_fn` is stepped eagerly (each
call launches its ops one by one), and the time of a demo ends after the
device's last step has finished.

    PYTHONPATH=src python examples/torch/serve_decode.py [--device cpu]

Runs on the card unless given ``--device cpu``.  `main` returns each
arch's tokens and last logits for in-process callers; ``params`` maps an
arch to the weights to decode with (e.g. the JAX package's, carried across
with `models.registry.params_from_jax`), else ``model.init(0)``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models.registry import build

ARCHS = ("internlm2-1.8b", "minicpm3-4b", "zamba2-7b", "xlstm-350m")


def decode_demo(arch: str, batch=2, prompt_len=8, gen=8, device=None,
                params=None):
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = build(cfg)
    if params is None:
        params = model.init(0, device=dev)
    params = params.to(dev)
    max_len = prompt_len + gen
    if cfg.family == "audio":
        caches = model.cache_init(batch, max_len, enc_len=16, device=dev)
    else:
        caches = model.cache_init(batch, max_len, device=dev)

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len), dtype=np.int32)
    logits = None
    with torch.no_grad():
        t0 = time.time()
        for t in range(prompt_len):
            logits, caches = model.decode_fn(params, {"tokens": torch.from_numpy(
                prompt[:, t:t + 1]).to(dev)}, caches)
        toks = []
        for _ in range(gen):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            toks.append(nxt.cpu().numpy())
            logits, caches = model.decode_fn(params, {"tokens": nxt}, caches)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
    out = np.concatenate(toks, 1)
    print(f"{arch:22s} [{cfg.family:6s}] {batch}x{gen} tokens in {dt:5.2f}s "
          f"-> {out[0].tolist()}")
    return {"tokens": out, "logits": logits}


def main(argv=None, params=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    params = params or {}
    return {arch: decode_demo(arch, device=args.device, params=params.get(arch))
            for arch in ARCHS}


if __name__ == "__main__":
    main()
