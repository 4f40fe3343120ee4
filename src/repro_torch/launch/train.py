"""Training front end: ``--arch <id>`` across the families (the JAX
package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b-smoke \
        --steps 20 --batch 4 --seq 64 --ckpt-dir /tmp/lm_ckpt [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch dlrm-mlperf-smoke --steps 20 --batch 4 [--device cpu]

Random parameters from a seeded ``torch.Generator`` (seed 0), the
synthetic deterministic pipelines, and the family's step builder.  An LM
trains with checkpoint rotation and restart: a run in a ``--ckpt-dir``
that holds a checkpoint resumes its parameters, optimiser state, step and
data cursor (``resumed at step N``), in the reference's format, so either
package resumes the other's.  DLRM (the recsys family) trains on
``RecsysPipeline`` batches; like the reference's, its branch builds the
``--ckpt-dir`` manager and never saves or resumes.  Both print ``step N
loss L`` every five steps and at the last one, as the reference does.  A
GNN or triangle-count config exits with the reference's message (the GNNs
train through ``repro_torch.examples.train_gnn``).  On a CPU use the
``-smoke`` configs.

``--mesh [N]`` trains an LM on a ``(1, N)`` ``("data", "model")`` mesh,
the reference's rule for a host with N devices: the first N CUDA cards
(by default every card; fewer raise), or with ``--device cpu`` N
positions on the CPU (N required).  Parameters are drawn as without a
mesh and sharded (``models.steps``' mesh step); checkpoints hold the
global arrays, so a run resumes across meshes and from or into a
one-device run's directory.  DLRM's sharded step is not ported yet, so a
recsys ``--arch`` with ``--mesh`` raises.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b-smoke \
        --mesh 4 --device cpu --steps 10 --ckpt-dir /tmp/lm_mesh
"""
from __future__ import annotations

import argparse

__all__ = ["build_parser", "main", "lm_mesh"]


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
    ap.add_argument("--mesh", type=int, nargs="?", const=0, default=None,
                    metavar="N",
                    help="train on a (1, N) (data, model) mesh: the first "
                         "N CUDA cards (default: every card), or N CPU "
                         "positions with --device cpu")
    return ap


def lm_mesh(n, device):
    """The ``(1, N)`` ``("data", "model")`` mesh of ``--mesh N``."""
    import torch

    from .mesh import make_mesh_for

    if device is not None and torch.device(device).type != "cpu":
        raise SystemExit("--mesh takes the first N CUDA cards: give no "
                         "--device, or --device cpu")
    if device is not None:
        if not n:
            raise SystemExit("--mesh with --device cpu needs N")
        devices = ["cpu"] * n
    else:
        have = torch.cuda.device_count()
        n = n or have
        if not n or have < n:
            raise SystemExit(f"--mesh {n} needs {n} CUDA cards, this host "
                             f"has {have}")
        devices = [f"cuda:{i}" for i in range(n)]
    return make_mesh_for((1, n), ("data", "model"), devices=devices)


def main(argv=None):
    """Train; returns ``{step: loss}`` of the steps this run took (floats),
    for callers in the same process."""
    args = build_parser().parse_args(argv)

    from ..configs import get_config

    cfg = get_config(args.arch)
    if cfg.family not in ("lm", "recsys"):
        raise SystemExit(
            f"family {cfg.family}: use examples/train_gnn.py or tc_run")

    import torch

    from ..ckpt import CheckpointManager
    from ..device import resolve_device

    mesh = None
    if args.mesh is not None:
        if cfg.family != "lm":
            raise SystemExit(
                f"--mesh: the {cfg.family} family's sharded step is not "
                "ported yet (ROADMAP: the GNN and DLRM sharded steps come "
                "next); train it without --mesh")
        mesh = lm_mesh(args.mesh, args.device)
    dev = mesh.first if mesh is not None else resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    mgr = (CheckpointManager(args.ckpt_dir, keep=2, async_save=False)
           if args.ckpt_dir else None)
    if cfg.family == "recsys":
        return _train_recsys(cfg, args, dev, gen)

    from ..data.pipeline import TokenPipeline
    from ..models.steps import build_lm_train_step
    from ..models.transformer import lm_init

    params = lm_init(gen, cfg, device=dev)
    if mesh is None:
        fn, info = build_lm_train_step(cfg, compress_grads=args.compress_grads,
                                       device=dev)
    else:
        fn, info = build_lm_train_step(cfg, mesh,
                                       compress_grads=args.compress_grads)
        params = info["shard"](params)
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
        _report(step, args.steps, m)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt},
                     extra={"next_step": step + 1,
                            "pipe": pipe.state_dict()})
    return {k: float(v) for k, v in losses.items()}


def _report(step, steps, metrics):
    if step % 5 == 0 or step == steps - 1:
        print(f"step {step:4d}  loss {float(metrics['loss']):.4f}")


def _train_recsys(cfg, args, dev, gen):
    """The reference's recsys branch: DLRM from step 0 on
    ``RecsysPipeline`` batches; no checkpoint is saved or restored."""
    from ..data.pipeline import RecsysPipeline
    from ..models.dlrm import dlrm_init
    from ..models.gnn_steps import build_dlrm_train_step

    params = dlrm_init(gen, cfg, device=dev)
    fn, info = build_dlrm_train_step(cfg, device=dev)
    opt = info["opt_init"](params)
    pipe = RecsysPipeline(cfg, args.batch)
    losses = {}
    for step in range(args.steps):
        params, opt, m = fn(params, opt, pipe.next_batch(), step)
        losses[step] = m["loss"]
        _report(step, args.steps, m)
    return {k: float(v) for k, v in losses.items()}


if __name__ == "__main__":
    main()
