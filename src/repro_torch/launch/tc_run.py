"""Distributed triangle counting CLI — the paper's application.

    python -m repro_torch.launch.tc_run --graph rmat:18 --grid 4 \\
        --method fused --verify --json

Counts the triangles of one graph on a logical ``grid x grid`` processor
grid held on one device and reports the paper's split: ``ppt_seconds``
(host planning + staging) and ``tct_seconds`` (the count).  Runs on the
GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat:14",
                    help="rmat:<scale>[,<ef>[,<seed>]] | er:<n>,<deg> | "
                         "cliques:<k>,<size> | star:<n> | named:<id>")
    ap.add_argument("--grid", type=int, default=1, help="sqrt(p): grid is q x q")
    ap.add_argument("--method", default="search",
                    help="count kernel: search | global | fused")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--no-probe-shorter", action="store_true")
    ap.add_argument("--no-skip-mask", action="store_true",
                    help="run every (device, step) pair, ignoring step_keep")
    ap.add_argument("--no-compact", action="store_true",
                    help="plan and run without schedule compaction")
    ap.add_argument("--repeat", type=int, default=1,
                    help="count N times; tct_seconds is the best warm run")
    ap.add_argument("--verify", action="store_true",
                    help="check against the exact host oracle")
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without one)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from ..core import (
        available_schedules,
        count_triangles,
        graph_from_spec,
        triangle_count_oracle,
    )
    from ..pipeline import default_cache

    g = graph_from_spec(args.graph)
    report = {"graph": args.graph, "n": g.n, "m": g.m}

    t0 = time.perf_counter()
    times = []
    for _ in range(max(1, args.repeat)):
        res = count_triangles(
            g,
            q=args.grid,
            method=args.method,
            chunk=args.chunk,
            probe_shorter=not args.no_probe_shorter,
            use_step_mask=False if args.no_skip_mask else None,
            compact=False if args.no_compact else None,
            device=args.device,
        )
        times.append(res.count_seconds)
    report.update(
        triangles=res.triangles,
        ppt_seconds=round(res.preprocess_seconds, 4),
        tct_seconds=round(min(times[1:]) if len(times) > 1 else times[0], 4),
        total_seconds=round(time.perf_counter() - t0, 4),
        grid=res.grid,
        method=res.method,
        device=res.device,
    )
    report.update(_skip_fields(res.plan, args.no_skip_mask))
    report.update(_compact_fields(res.plan))
    report.update(_autotune_fields(res.plan))
    if res.autotune_mode is not None:
        report["autotune_mode"] = res.autotune_mode
    report["schedules"] = available_schedules()
    report["plan_cache"] = default_cache().stats()

    if args.verify:
        expected = triangle_count_oracle(g)
        report["expected"] = expected
        report["correct"] = bool(res.triangles == expected)

    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k}: {v}")
    if args.verify and not report["correct"]:
        raise SystemExit(
            f"count mismatch: got {res.triangles}, expected {expected}"
        )


def _skip_fields(plan, no_skip_mask: bool) -> dict:
    """Per-(device, step) skip-mask accounting."""
    sk = getattr(plan, "step_keep", None)
    if sk is None:
        return {}
    return dict(
        schedule_steps=int(sk.size),
        skipped_steps=0 if no_skip_mask else int(sk.size - sk.sum()),
    )


def _compact_fields(plan) -> dict:
    """Schedule-compaction accounting: live schedule steps and the
    device-step slots the compacted engine no longer executes
    (``(n_total - n_live) * ndev``, commensurable with
    ``schedule_steps``/``skipped_steps``).  Plans made under
    ``--no-compact`` carry no compacted schedule, so such runs simply
    omit the fields."""
    cs = getattr(plan, "compact", None)
    sk = getattr(plan, "step_keep", None)
    if cs is None or sk is None:
        return {}
    ndev = sk.size // max(1, cs.n_total)
    return dict(live_steps=cs.n_live, elided_steps=cs.n_elided * ndev)


def _autotune_fields(plan) -> dict:
    at = getattr(plan, "autotune", None)
    if not at:
        return {}
    return dict(
        autotuned_chunk=at["chunk"],
        autotuned_d_small=at["d_small"],
        autotuned_tail_heavy=at["tail_heavy"],
    )


if __name__ == "__main__":
    main()
