"""Serve a small LM with batched requests: prefill + KV-cached greedy
decode through the serving path (the JAX package's
``examples/serve_lm.py``; the primary end-to-end driver of this repo is
``distributed_tc``, this one exercises the LM family's serving scenario).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.steps import build_lm_decode_step
from repro_torch.models.transformer import init_kv_cache, lm_init


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("qwen2-0.5b-smoke")  # reduced dims, same architecture
    params = lm_init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    decode, _ = build_lm_decode_step(cfg, device=dev)

    batch, max_len, gen = 8, 64, 24
    cache = init_kv_cache(cfg, batch, max_len, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(batch, 8)).astype(np.int32)
    prompts = torch.from_numpy(prompts).to(dev)

    # prefill via repeated decode (teacher-forcing the prompt tokens)
    cache_len = torch.zeros((batch,), dtype=torch.int32, device=dev)
    tok = prompts[:, 0]
    for i in range(1, prompts.shape[1]):
        _, cache = decode(params, cache, tok, cache_len)
        cache_len = cache_len + 1
        tok = prompts[:, i]

    # timed batched greedy decode
    outs = []
    t0 = time.perf_counter()
    for _ in range(gen):
        tok, cache = decode(params, cache, tok, cache_len)
        cache_len = cache_len + 1
        outs.append(tok)
    toks = torch.stack(outs, 1).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"generated {batch}x{gen} tokens in {dt:.2f}s "
          f"({batch*gen/dt:.0f} tok/s on {dev.type})")
    print("sample:", toks[0][:12])
    assert np.all(toks < cfg.vocab) and np.all(toks >= 0)
    print("ok ✓")
    return toks


if __name__ == "__main__":
    main()
