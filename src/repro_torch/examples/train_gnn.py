"""Train a GAT on a synthetic Cora-like citation graph to convergence,
with checkpoints.

    PYTHONPATH=src python -m repro_torch.examples.train_gnn [--device cpu]

The full ``gat-cora`` config (2 layers, 8 heads of 8), 200 AdamW steps on
a seeded stochastic block model of 600 nodes with class-correlated
features and self loops, a checkpoint every 50 steps (into ``--ckpt-dir``,
or a temporary directory removed afterwards); then the held-out accuracy,
which must exceed 0.7.  Parameters come from a ``torch.Generator`` seeded
0, the graph from numpy's seeded 0, as in the JAX package's
``examples/train_gnn.py``.  Runs on the GPU unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.gnn.gat import gat_apply
from repro_torch.models.gnn_steps import (build_gnn_train_step, gnn_init,
                                          gnn_loss)

__all__ = ["synthetic_cora", "main"]

STEPS = 200
MIN_ACCURACY = 0.7


def synthetic_cora(rng, n=600, classes=7, d=64, intra=0.02, inter=0.002):
    """Stochastic block model + class-correlated features (numpy)."""
    labels = rng.integers(0, classes, n)
    same = labels[:, None] == labels[None, :]
    p = np.where(same, intra, inter)
    adj = rng.random((n, n)) < p
    adj = np.triu(adj, 1)
    src, dst = np.nonzero(adj | adj.T)
    # self loops
    src = np.concatenate([src, np.arange(n)])
    dst = np.concatenate([dst, np.arange(n)])
    feats = 0.5 * rng.normal(size=(n, d))
    feats[:, :classes] += 2.5 * np.eye(classes)[labels]
    return feats, labels, src, dst


def _train(dev, ckpt_dir):
    rng = np.random.default_rng(0)
    cfg = get_config("gat-cora")  # the real 2-layer 8-head config
    feats, labels, src, dst = synthetic_cora(rng)
    n, d = feats.shape
    train_mask = (rng.random(n) < 0.6).astype(np.float32)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in dict(
        feats=feats.astype(np.float32), edge_src=src.astype(np.int32),
        edge_dst=dst.astype(np.int32), labels=labels.astype(np.int32),
        label_mask=train_mask).items()}
    params = gnn_init(torch.Generator(device=dev).manual_seed(0), cfg, d,
                      device=dev)
    build, info = build_gnn_train_step(cfg, None, d, device=dev)
    fn = build(batch)
    opt = info["opt_init"](params)
    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=False)

    with torch.no_grad():
        loss0 = float(gnn_loss(params, cfg, batch)[0])
    for step in range(STEPS):
        params, opt, m = fn(params, opt, batch, step)
        if step % 50 == 0:
            print(f"step {step:4d}  loss {float(m['loss']):.4f}")
            mgr.save(step, {"params": params}, extra={"next_step": step + 1})

    with torch.no_grad():
        logits = gat_apply(params, cfg, batch["feats"], batch["edge_src"],
                           batch["edge_dst"])
    pred = torch.argmax(logits, -1).cpu().numpy()
    test = train_mask < 0.5
    acc = float((pred[test] == labels[test]).mean())
    loss1 = float(m["loss"])
    print(f"held-out accuracy: {acc:.3f} (loss {loss0:.3f} -> {loss1:.3f})")
    return dict(accuracy=acc, loss0=loss0, loss=loss1, steps=STEPS)


def main(argv=None):
    """Train; returns ``{"accuracy", "loss0", "loss", "steps"}`` and raises
    ``SystemExit`` when the held-out accuracy is not over 0.7."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without one)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where the checkpoints go; default: a temporary "
                         "directory, removed at the end")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.ckpt_dir is None:
        with tempfile.TemporaryDirectory(prefix="repro_torch_gat_") as d:
            res = _train(dev, d)
    else:
        res = _train(dev, args.ckpt_dir)
    if res["accuracy"] <= MIN_ACCURACY:
        raise SystemExit("GAT failed to learn the SBM task")
    print("ok ✓")
    return res


if __name__ == "__main__":
    main()
