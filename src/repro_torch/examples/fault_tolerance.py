"""Fault-tolerance demo: kill the Cannon loop mid-run, resume from the
shift-level checkpoint, and still produce the exact count.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance [--device cpu]

Drives ``python -m repro_torch.launch.tc_run --ckpt-dir ... --verify``
(Cannon 2 x 2, one checkpoint a shift) in this process: once with a
failure injected at shift 1 (restored mid-loop), then a fresh run, then
the same run again, which resumes from the final checkpoint.  The
checkpoints go to a temporary directory.  Runs on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import shutil
import tempfile

from repro_torch.launch import tc_run


def run(ckpt, extra, device):
    """One ``tc_run`` in this process; returns what it printed (a
    ``--verify`` mismatch raises ``SystemExit``)."""
    argv = ["--graph", "rmat:11,8", "--grid", "2", "--ckpt-dir", ckpt,
            "--verify", *extra]
    if device is not None:
        argv += ["--device", device]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tc_run.main(argv)
    return out.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without one)")
    args = ap.parse_args(argv)

    ckpt = tempfile.mkdtemp(prefix="repro_torch_tc_ft_demo_")
    try:
        print("run 1: failure injected at shift 1 (restores mid-loop) ...")
        out = run(ckpt, ["--fail-at-shift", "1"], args.device)
        print(out)
        assert "injected failure at shift 1" in out and "correct: True" in out

        print("run 2: fresh run, then resume-from-checkpoint replay ...")
        shutil.rmtree(ckpt)
        assert "correct: True" in run(ckpt, [], args.device)
        # resume again: the checkpoint holds the final state; re-running
        # verifies the restore path end to end (it resumes at shift q)
        out = run(ckpt, [], args.device)
        print(out)
        assert "resumed at shift" in out and "correct: True" in out
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print("fault-tolerance demo passed ✓")


if __name__ == "__main__":
    main()
