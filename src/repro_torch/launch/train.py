"""Training front end for the LM family (the JAX package's
``launch/train.py``, its LM branch).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b-smoke \
        --steps 20 --batch 4 --seq 64 --ckpt-dir /tmp/lm_ckpt [--device cpu]

Random parameters from a seeded ``torch.Generator`` (seed 0), the
synthetic deterministic ``TokenPipeline``, ``build_lm_train_step``, and
checkpoint rotation with restart: a run in a ``--ckpt-dir`` that holds a
checkpoint resumes its parameters, optimiser state, step and data cursor
(``resumed at step N``).  The checkpoints are the reference's format, so
either package resumes the other's.  It prints ``step N  loss L`` every
five steps and at the last one, as the reference does.  On a CPU use the
``-smoke`` configs.

The recsys and GNN families are not ported yet: their names are refused
with ``SystemExit``, as is a triangle-count config (the reference points
those to ``tc_run``).
"""
from __future__ import annotations

import argparse

__all__ = ["build_parser", "main"]

# the reference's configs that its train trains and this one refuses
NOT_PORTED = ("dlrm-mlperf", "nequip", "graphcast", "gat-cora",
              "equiformer-v2")


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true",
                    help="accepted and unused, as in the reference")
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without one)")
    return ap


def _config(name: str):
    from ..configs import get_config

    try:
        cfg = get_config(name)
    except KeyError:
        raise SystemExit(
            f"--arch {name}: not an LM config of the port; the recsys and "
            f"GNN families ({', '.join(NOT_PORTED)}) are not ported yet, "
            "and the LM configs are repro_torch.configs.LM_ARCHS and their "
            "-smoke variants") from None
    if cfg.family != "lm":
        raise SystemExit(f"family {cfg.family}: use tc_run")
    return cfg


def main(argv=None):
    """Train; returns ``{step: loss}`` of the steps this run took (floats),
    for callers in the same process."""
    args = build_parser().parse_args(argv)
    cfg = _config(args.arch)

    import torch

    from ..ckpt import CheckpointManager
    from ..data.pipeline import TokenPipeline
    from ..device import resolve_device
    from ..models.steps import build_lm_train_step
    from ..models.transformer import lm_init

    dev = resolve_device(args.device)
    mgr = (CheckpointManager(args.ckpt_dir, keep=2, async_save=False)
           if args.ckpt_dir else None)
    params = lm_init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    fn, info = build_lm_train_step(cfg, compress_grads=args.compress_grads,
                                   device=dev)
    opt = info["opt_init"](params)
    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq)
    start = 0
    if mgr:
        _, restored, extra = mgr.restore_latest({"params": params,
                                                 "opt": opt})
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = int(extra["next_step"])
            pipe.load_state(extra["pipe"])
            print(f"resumed at step {start}")
    losses = {}
    for step in range(start, args.steps):
        params, opt, m = fn(params, opt, pipe.next_batch(), step)
        losses[step] = m["loss"]
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(m['loss']):.4f}")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt},
                     extra={"next_step": step + 1,
                            "pipe": pipe.state_dict()})
    return {k: float(v) for k, v in losses.items()}


if __name__ == "__main__":
    main()
