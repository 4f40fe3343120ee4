"""Distributed triangle counting CLI — the paper's application.

    python -m repro_torch.launch.tc_run --graph rmat:18 --grid 4 \\
        --method fused --verify --json
    python -m repro_torch.launch.tc_run --graph rmat:18 --grid 4 \\
        --schedule summa --broadcast chain --method auto --verify
    python -m repro_torch.launch.tc_run --graph powerlaw:20000,2.2 \\
        --grid 4 --schedule oned --method fused --hub-split --rebalance 3
    python -m repro_torch.launch.tc_run --graphs named:karate,rmat:12 \\
        --grid 2 --verify --json
    python -m repro_torch.launch.tc_run --graph rmat:14 --grid 2 \\
        --method fused --stream deltas.jsonl --rebase-every 8 --verify --json
    python -m repro_torch.launch.tc_run --graph rmat:18 --grid 4 --pods 2 \\
        --method fused --reduce-strategy tree --verify
    python -m repro_torch.launch.tc_run --graph rmat:18 --grid 4 \\
        --method auto --autotune measured --measured-dir /tmp/tc_table

Counts the triangles of one graph on a logical ``grid x grid`` processor
grid held on one device (``--schedule summa``: the same ``q x q`` grid by
broadcast rounds; ``--schedule oned``: the 1D ring over ``q²`` devices)
and reports the paper's split: ``ppt_seconds`` (host planning + staging)
and ``tct_seconds`` (the count).  ``--rebalance N`` and ``--hub-split
[C]`` add the planner's skip-aware rebalance and hub-split stages;
``--graphs a,b,c`` counts a whole *batch* of graphs in one engine call
(``count_triangles_many``); ``--stream DELTA_FILE`` counts ``--graph``
once, then re-counts it after each line's edge delta through the delta
ladder (``count_triangles_delta``).  ``--pods N`` adds the 2.5D pod
dimension (Cannon: blocks replicated over N pods, each running every
N-th shift; the ring: N * grid² devices) and ``--reduce-strategy`` its
final sum; ``--autotune measured`` resolves ``--method auto`` from the
measured timing table (in ``--measured-dir``).  Runs on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import math
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat:14",
                    help="rmat:<scale>[,<ef>[,<seed>]] | er:<n>,<deg> | "
                         "cliques:<k>,<size> | star:<n> | named:<id>")
    ap.add_argument("--graphs", default=None,
                    help="a list of specs (';'- or ','-separated): batched "
                         "count via count_triangles_many (one engine call)")
    ap.add_argument("--rebalance", type=int, default=0,
                    help="skip-aware rebalance trials: search this many "
                         "relabeling seeds for the lowest masked critical "
                         "path (any schedule)")
    ap.add_argument("--hub-split", nargs="?", const=True, default=None,
                    type=float, metavar="C", dest="hub_split",
                    help="hub-split planning: count rows with degree > C x "
                         "the average degree (bare flag = the default C) "
                         "as column-strided fragments outside the "
                         "schedule; the residual takes the normal path")
    ap.add_argument("--stream", default=None, metavar="DELTA_FILE",
                    help="streaming mode: count --graph once, then apply "
                         "each JSONL line ({\"add\": [[u,v],...], "
                         "\"remove\": [...]}, original vertex ids) as an "
                         "edge delta via the incremental re-plan path and "
                         "re-count; the report carries per-round "
                         "dirty-block / replanned-stage accounting")
    ap.add_argument("--rebase-every", type=int, default=8,
                    help="streaming: cold re-plan (rebase the delta "
                         "lineage) after this many chained deltas")
    ap.add_argument("--grid", type=int, default=1, help="sqrt(p): grid is q x q")
    ap.add_argument("--pods", type=int, default=1,
                    help="2.5D pods: Cannon's blocks replicated over this "
                         "many pods, pod t starting at skew offset t and "
                         "running every pods-th shift (must divide --grid)")
    ap.add_argument("--reduce-strategy", default="auto",
                    choices=["auto", "flat", "tree"],
                    help="the final sum: 'flat' over every grid dimension; "
                         "'tree' a joint grid sum per pod, then the "
                         "binomial tree over the pods (needs a power-of-two "
                         "--pods > 1); 'auto' picks tree when it applies")
    ap.add_argument("--schedule", default="cannon",
                    help="cannon | summa | oned (resolved by the schedule "
                         "registry; a bad name lists the registered ones)")
    ap.add_argument("--method", default="search",
                    choices=["auto", "search", "search2", "global",
                             "dense", "tile", "fused"],
                    help="count kernel; 'auto' runs the deterministic "
                         "autotune stage and picks search2 on "
                         "heavy-tailed graphs; 'fused' is the CUDA "
                         "intersection kernel (two-sided maxfrag split)")
    ap.add_argument("--autotune", default="percentile",
                    choices=["percentile", "measured"],
                    help="'percentile' derives kernel shapes analytically "
                         "from the probe-length distribution; 'measured' "
                         "times fused vs the baseline candidates once per "
                         "shape bucket, persists the verdict to the "
                         "measured table, and lets --method auto resolve "
                         "to 'fused' where the table says it wins")
    ap.add_argument("--measured-dir", default=None,
                    help="measured-autotune table directory (default "
                         "$REPRO_TORCH_TC_MEASURED_DIR or "
                         "~/.cache/repro_torch/tc_measured)")
    ap.add_argument("--broadcast", default=None,
                    choices=["auto", "onehot", "chain"],
                    help="summa's panel-broadcast strategy (the same "
                         "count on one device)")
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

    if args.stream and (args.graphs or args.autotune == "measured"):
        raise SystemExit(
            "--stream composes with single-graph pipeline runs only: "
            "drop --graphs/--autotune measured"
        )
    if args.rebalance and args.graphs:
        raise SystemExit(
            "--rebalance is not supported with --graphs; rebalance "
            "single full-engine runs"
        )
    if args.hub_split is not None:
        if args.graphs:
            raise SystemExit(
                "--hub-split is a single-graph pipeline stage; the "
                "batched engine shares one set of statics across graphs "
                "and takes no hub side — drop --graphs"
            )
        if args.method in ("dense", "tile"):
            raise SystemExit(
                f"--hub-split is not supported with --method "
                f"{args.method}: the {args.method} operand store stages "
                "its own blocks and would drop the hub-split partial"
            )
    if args.graphs:
        return _run_batched(args)

    g = graph_from_spec(args.graph)
    if args.stream:
        return _run_stream(g, args)
    report = {"graph": args.graph, "n": g.n, "m": g.m}

    t0 = time.perf_counter()
    times = []
    for _ in range(max(1, args.repeat)):
        res = count_triangles(
            g,
            q=args.grid,
            npods=args.pods,
            schedule=args.schedule,
            method=args.method,
            broadcast=args.broadcast,
            reduce_strategy=args.reduce_strategy,
            chunk=args.chunk,
            probe_shorter=not args.no_probe_shorter,
            use_step_mask=False if args.no_skip_mask else None,
            compact=False if args.no_compact else None,
            rebalance_trials=args.rebalance,
            hub_split=(
                args.hub_split if args.hub_split is not None else False
            ),
            autotune=args.autotune,
            measured_dir=args.measured_dir,
            device=args.device,
        )
        times.append(res.count_seconds)
    report.update(
        triangles=res.triangles,
        ppt_seconds=round(res.preprocess_seconds, 4),
        tct_seconds=round(min(times[1:]) if len(times) > 1 else times[0], 4),
        total_seconds=round(time.perf_counter() - t0, 4),
        grid=res.grid,
        schedule=res.schedule,
        method=res.method,
        device=res.device,
    )
    report.update(_skip_fields(res.plan, args.no_skip_mask))
    report.update(_compact_fields(res.plan))
    report.update(_autotune_fields(res.plan))
    if res.rebalance is not None:
        report.update(_rebalance_fields(res.rebalance))
    if args.hub_split is not None:
        report.update(_hub_fields(res.hub))
    if res.autotune_mode is not None:
        report["autotune_mode"] = res.autotune_mode
    if res.measured_table_hit is not None:
        report["measured_table_hit"] = res.measured_table_hit
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


def _run_stream(g, args):
    """Streaming mode: one base count, then one incremental re-count per
    delta line.

    Each JSONL line of ``--stream`` is an
    :class:`repro_torch.pipeline.EdgeDelta` in **original** vertex ids
    (the lineage's composed relabeling is applied internally).  The
    derived artifact is threaded round to round, so unchanged device
    tensors and engine fns carry over; after ``--rebase-every`` chained
    deltas the lineage rebases onto a cold re-plan.  ``--verify`` checks
    every round against the host oracle of the mutated graph.
    """
    from ..core import count_triangles, count_triangles_delta
    from ..core.graph import triangle_count_oracle
    from ..pipeline import EdgeDelta, default_cache

    kwargs = dict(
        q=args.grid,
        npods=args.pods,
        schedule=args.schedule,
        method=args.method,
        broadcast=args.broadcast,
        reduce_strategy=args.reduce_strategy,
        chunk=args.chunk,
        probe_shorter=not args.no_probe_shorter,
        use_step_mask=False if args.no_skip_mask else None,
        compact=False if args.no_compact else None,
        device=args.device,
    )
    t0 = time.perf_counter()
    base = count_triangles(
        g, rebalance_trials=args.rebalance,
        hub_split=args.hub_split if args.hub_split is not None else False,
        **kwargs,
    )
    report = {
        "graph": args.graph, "n": g.n, "m": g.m, "stream": args.stream,
        "triangles_base": base.triangles,
        "base_seconds": round(time.perf_counter() - t0, 4),
        "grid": base.grid, "schedule": base.schedule, "method": base.method,
        "device": base.device,
    }
    if args.hub_split is not None:
        report.update(_hub_fields(base.hub))
    if args.verify:
        exp = triangle_count_oracle(g)
        report["expected_base"] = exp
        if base.triangles != exp:
            raise SystemExit(
                f"base count mismatch: got {base.triangles}, expected {exp}"
            )

    art, g_cur, rounds = base.artifact, g, []
    with open(args.stream) as fh:
        lines = [ln for ln in (s.strip() for s in fh) if ln]
    for i, line in enumerate(lines):
        spec = json.loads(line)
        delta = EdgeDelta(
            add=spec.get("add") or None, remove=spec.get("remove") or None
        )
        t1 = time.perf_counter()
        res = count_triangles_delta(
            g_cur, delta, artifact=art,
            rebase_every=args.rebase_every, **kwargs,
        )
        dt = time.perf_counter() - t1
        art, rep = res.artifact, res.delta
        g_cur = delta.apply_to(g_cur)
        entry = dict(
            round=i,
            triangles=res.triangles,
            edges_added=rep["edges_added"],
            edges_removed=rep["edges_removed"],
            level=rep["level"],
            dirty_blocks=rep["dirty_blocks"],
            replanned_stages=rep["replanned_stages"],
            rebased=rep["rebased"],
            fn_inherited=rep["fn_inherited"],
            round_seconds=round(dt, 4),
        )
        if args.verify:
            exp = triangle_count_oracle(g_cur)
            entry["expected"] = exp
            entry["correct"] = bool(res.triangles == exp)
        rounds.append(entry)

    last = rounds[-1] if rounds else {}
    report.update(
        rounds=rounds,
        deltas_applied=len(rounds),
        triangles=last.get("triangles", base.triangles),
        dirty_blocks=last.get("dirty_blocks", 0),
        replanned_stages=last.get("replanned_stages", []),
        rebased=last.get("rebased", False),
        plan_cache=default_cache().stats(),
    )
    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k}: {v}")
    wrong = [r["round"] for r in rounds if not r.get("correct", True)]
    if wrong:
        raise SystemExit(f"count mismatch in stream rounds {wrong}")


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


def _hub_fields(hub: "dict | None") -> dict:
    """Flatten a TCResult.hub report into report fields.

    ``hub is None`` with the flag on means no row crossed the threshold
    (the stage no-opped) — reported as ``hub_rows=0`` rather than
    omitted, so scripted consumers can tell "off" from "found nothing".
    """
    if hub is None:
        return dict(hub_rows=0, hub_nnz_frac=0.0)
    out = dict(
        hub_rows=int(hub["hub_rows"]),
        hub_nnz_frac=round(float(hub["hub_nnz_frac"]), 4),
    )
    if hub.get("residual_mcp") is not None:
        out["residual_mcp"] = hub["residual_mcp"]
    return out


def _rebalance_fields(rb: dict) -> dict:
    """Flatten a pipeline rebalance report into report fields:
    masked-critical-path improvement and the skipped-step delta vs the
    seed-0 baseline."""
    impr = rb["improvement"]
    return dict(
        rebalance_trials=len(rb["trials"]),
        rebalance_best_seed=rb["best_seed"],
        rebalance_baseline_critical_path=rb["baseline_masked_critical_path"],
        rebalance_masked_critical_path=rb["best_masked_critical_path"],
        # inf (best path hit literal zero) is not valid JSON: emit null
        rebalance_improvement=round(impr, 4) if math.isfinite(impr) else None,
        rebalance_skipped_delta=(
            rb["skipped_steps"] - rb["baseline_skipped_steps"]
        ),
    )


def _run_batched(args):
    """Batched mode: count every spec in --graphs with one engine call."""
    from ..core import count_triangles_many, triangle_count_oracle
    from ..core.generators import graph_from_spec, split_specs

    if args.no_skip_mask:
        raise SystemExit(
            "--no-skip-mask is not supported with --graphs (the batched "
            "engine always follows the plans' staged masks); use "
            "single-graph runs to A/B the lever"
        )
    if args.method == "fused":
        raise SystemExit(
            "--method fused is not supported with --graphs (the batched "
            "engine plans without the two-sided maxfrag split the fused "
            "kernel needs); use single-graph runs"
        )
    if args.autotune == "measured":
        raise SystemExit(
            "--autotune measured is not supported with --graphs: the "
            "measured table is keyed per shape bucket, so a mixed batch "
            "would hit a cold table (and pay a timing run) per graph "
            "inside the one engine call; warm the table with "
            "single-graph runs first, then batch with --autotune "
            "percentile"
        )
    if args.broadcast == "chain":
        raise SystemExit(
            "--broadcast chain is not supported with --graphs (a batched "
            "engine resolves broadcast='auto' to 'onehot' and refuses "
            "'chain', as the JAX package does); use single-graph runs"
        )
    if args.reduce_strategy != "auto":
        raise SystemExit(
            "--reduce-strategy is not supported with --graphs (the "
            "batched engine counts every graph on one pod and sums flat); "
            "use single-graph runs"
        )
    specs = split_specs(args.graphs)
    graphs = [graph_from_spec(s) for s in specs]
    # the batched engine keeps the full loop (per-graph masks differ, so
    # there is no shared live-step list to compact) and takes only CSR
    # kernels: resolve 'auto' to the flat search path
    method = "search" if args.method == "auto" else args.method
    t0 = time.perf_counter()
    for _ in range(max(1, args.repeat)):  # later rounds hit the program cache
        res = count_triangles_many(
            graphs,
            q=args.grid,
            schedule=args.schedule,
            method=method,
            chunk=args.chunk,
            probe_shorter=not args.no_probe_shorter,
            device=args.device,
        )
    report = {
        "graphs": specs,
        "batch": res.batch,
        "triangles": res.triangles,
        "ppt_seconds": round(res.plan_seconds, 4),
        "tct_seconds": round(res.count_seconds, 4),
        "total_seconds": round(time.perf_counter() - t0, 4),
        "padding_overhead": round(res.padding_overhead, 4),
        "grid": res.grid,
        "schedule": res.schedule,
        "method": res.method,
        "device": res.device,
        "cache_hit": res.cache_hit,
    }
    if args.verify:
        expected = [triangle_count_oracle(g) for g in graphs]
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
