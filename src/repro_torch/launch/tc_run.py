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
    python -m repro_torch.launch.tc_run --graph rmat:18 --grid 4 \\
        --ckpt-dir /tmp/tc_ckpt --inject-faults "step@1;ckpt_save" --verify
    python -m repro_torch.launch.tc_run --graph rmat:18 --grid 4 \\
        --method fused --supervise --inject-faults "step@0=devicelost:7"
    python -m repro_torch.launch.tc_run --graph rmat:18 --grid 4 \\
        --chunk 8192 --opt --repeat 2 --verify --json
    python -m repro_torch.launch.tc_run --graph rmat:16 --grid 4 \\
        --schedule oned --chunk 8192 --time-split --json
    python -m repro_torch.launch.tc_run --graph rmat:16 --grid 2 --mesh \\
        --ckpt-dir /tmp/tc_ckpt --inject-faults "step@1;ckpt_save" --verify

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
measured timing table (in ``--measured-dir``).  ``--ckpt-dir`` runs
Cannon one shift at a time with a checkpoint after each (resumable
mid-loop, ``--fail-at-shift`` injects one failure); ``--inject-faults
SPEC`` and ``--supervise`` run the count (or the checkpointed loop) under
the restart supervisor of :mod:`repro_torch.runtime`.  ``--opt`` counts
a Cannon run with the bucketized ``search2`` kernel over blob shifts that
carry uint16 row lengths; ``--time-split`` adds a shift-only (or
broadcast-only) and a count-only timing of the same schedule and the
bytes each engine phase moves (``coll_*_bytes``).  Runs on the GPU unless
``--device cpu`` is given.  ``--mesh`` spreads the grid (and its pods)
over a device mesh, one CUDA card a position (``q² · pods`` cards, failing
with fewer; with ``--device cpu`` every position on the CPU), for every
mode: the plain count, ``--graphs``, ``--stream``, ``--opt``,
``--time-split``, ``--ckpt-dir`` (the stepper's state on the mesh) and
the supervised runs (a ``DeviceLost`` regrids onto a mesh over the first
surviving positions' devices).
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
    ap.add_argument("--opt", action="store_true",
                    help="Cannon only: bucketed probes (search2 over the "
                         "bucketized plan) + blobs with uint16 row lengths")
    ap.add_argument("--time-split", action="store_true",
                    help="also time a shift-only run (the masked engine "
                         "fed an all-False mask: every roll, no count; "
                         "broadcast-only on summa) and a count-only run "
                         "(shifts/broadcasts elided), and report the bytes "
                         "each engine phase moves in the production "
                         "configuration (coll_{shift,broadcast,reduce,"
                         "other}_bytes); any schedule")
    ap.add_argument("--no-probe-shorter", action="store_true")
    ap.add_argument("--no-skip-mask", action="store_true",
                    help="run every (device, step) pair, ignoring step_keep")
    ap.add_argument("--no-compact", action="store_true",
                    help="plan and run without schedule compaction")
    ap.add_argument("--no-double-buffer", action="store_true",
                    help="one payload generation in the checkpointed "
                         "stepper's carry (the count is the same)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="run Cannon shift at a time, checkpointing the "
                         "stepper's carry and per-device partial counts "
                         "after each shift into this directory (a rerun "
                         "resumes from it)")
    ap.add_argument("--fail-at-shift", type=int, default=None,
                    help="with --ckpt-dir: inject one failure at this "
                         "shift, then restore the latest checkpoint")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="deterministic typed fault injection: "
                         "';'-separated sites "
                         "point[@STEP][=FAULT[:LOST]][*TIMES] over points "
                         "plan_stage|device_stage|step|fused|delta_splice|"
                         "ckpt_save, e.g. 'step@1' or "
                         "'step@0=devicelost:5;ckpt_save=ckptcorrupt'; "
                         "implies supervised execution — the run must "
                         "still produce the exact count")
    ap.add_argument("--supervise", action="store_true",
                    help="run under the restart supervisor (backoff + "
                         "jitter, restart budget, degradation ladder, "
                         "DeviceLost regrid) even without injected "
                         "faults; the report gains supervision_* fields")
    ap.add_argument("--restart-budget", type=int, default=5,
                    help="supervised runs: max restarts before giving up")
    ap.add_argument("--attempt-deadline", type=float, default=None,
                    help="supervised runs: cooperative per-attempt "
                         "deadline in seconds (checked at step/attempt "
                         "boundaries)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="count N times; tct_seconds is the best warm run")
    ap.add_argument("--verify", action="store_true",
                    help="check against the exact host oracle")
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without one)")
    ap.add_argument("--mesh", action="store_true",
                    help="spread the --grid (x --pods) grid over a device "
                         "mesh: one CUDA card a position, failing with "
                         "fewer; with --device cpu every position on the "
                         "CPU.  Every mode runs on it: --ckpt-dir keeps "
                         "the stepper's state on the mesh, and a "
                         "DeviceLost regrids onto the first surviving "
                         "positions")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from ..core import available_schedules, count_triangles, graph_from_spec
    from ..pipeline import default_cache

    if args.stream and (args.graphs or args.ckpt_dir or args.opt
                        or args.time_split or args.autotune == "measured"):
        raise SystemExit(
            "--stream composes with single-graph pipeline runs only: "
            "drop --graphs/--ckpt-dir/--opt/--time-split/"
            "--autotune measured"
        )
    if args.rebalance and (args.graphs or args.ckpt_dir):
        raise SystemExit(
            "--rebalance is not supported with --graphs or --ckpt-dir; "
            "rebalance single full-engine runs"
        )
    if args.hub_split is not None:
        if args.graphs:
            raise SystemExit(
                "--hub-split is a single-graph pipeline stage; the "
                "batched engine shares one set of statics across graphs "
                "and takes no hub side — drop --graphs"
            )
        if args.ckpt_dir:
            raise SystemExit(
                "--hub-split is not supported with --ckpt-dir: the "
                "checkpointed stepper counts one shift at a time and "
                "has no slot for the hub-split partial"
            )
        if args.opt:
            raise SystemExit(
                "--hub-split is not wired through the --opt bucketized "
                "path; use the default path (the hub side composes with "
                "--rebalance, --no-compact and every schedule there)"
            )
        if args.method in ("dense", "tile"):
            raise SystemExit(
                f"--hub-split is not supported with --method "
                f"{args.method}: the {args.method} operand store stages "
                "its own blocks and would drop the hub-split partial"
            )
    supervised = bool(args.inject_faults or args.supervise)
    if supervised and (args.graphs or args.opt or args.time_split
                       or args.stream):
        raise SystemExit(
            "--inject-faults/--supervise cover single-graph engine runs "
            "and --ckpt-dir stepper runs; drop --graphs/--opt/"
            "--time-split/--stream (the serve front-end has its own "
            "per-request supervision)"
        )
    fault_plan = None
    if args.inject_faults:
        from ..runtime import FaultPlan

        fault_plan = FaultPlan.parse(args.inject_faults)

    if args.graphs:
        return _run_batched(args)

    g = graph_from_spec(args.graph)
    if args.stream:
        return _run_stream(g, args)
    report = {"graph": args.graph, "n": g.n, "m": g.m}
    if args.ckpt_dir:
        total, fields = _run_checkpointed(g, args, fault_plan=fault_plan)
        report.update(fields)
        report["plan_cache"] = default_cache().stats()
        return _finish(g, args, report, total)

    if args.opt and args.schedule == "cannon":
        total, fields = _run_opt(g, args)
        report.update(fields)
        return _finish(g, args, report, total)

    t0 = time.perf_counter()
    count_kwargs = dict(
        schedule=args.schedule,
        method=args.method,
        broadcast=args.broadcast,
        reduce_strategy=args.reduce_strategy,
        chunk=args.chunk,
        probe_shorter=not args.no_probe_shorter,
        use_step_mask=False if args.no_skip_mask else None,
        double_buffer=not args.no_double_buffer,
        compact=False if args.no_compact else None,
        rebalance_trials=args.rebalance,
        hub_split=(
            args.hub_split if args.hub_split is not None else False
        ),
        autotune=args.autotune,
        measured_dir=args.measured_dir,
        **_placement(args),
    )
    times = []
    if supervised:
        from ..runtime import BackoffPolicy, Supervisor, supervised_count

        sup = Supervisor(
            max_restarts=args.restart_budget,
            attempt_deadline=args.attempt_deadline,
            backoff=BackoffPolicy(base=0.02, max_delay=0.5),
        )
        res = supervised_count(
            g, supervisor=sup, fault_plan=fault_plan, **count_kwargs
        )
        times.append(res.count_seconds)
        report.update(_supervision_fields(res.supervision))
    else:
        for _ in range(max(1, args.repeat)):
            res = count_triangles(g, **count_kwargs)
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
    if args.time_split:
        report.update(_time_split(g, args))
    report["schedules"] = available_schedules()
    report["plan_cache"] = default_cache().stats()
    return _finish(g, args, report, res.triangles)


def _placement(args, pods: bool = True) -> dict:
    """The count's placement keywords: ``q``, ``npods`` and ``device``, or
    with ``--mesh`` the mesh (:func:`_grid_mesh`)."""
    if not args.mesh:
        return dict(q=args.grid, device=args.device,
                    **(dict(npods=args.pods) if pods else {}))
    return dict(mesh=_grid_mesh(args, args.grid, args.pods if pods else 1))


def _grid_mesh(args, q: int, npods: int = 1, devices=None):
    """``--mesh``'s ``q x q`` (``npods x q x q``) mesh: over the first
    ``q² · npods`` of ``devices`` where given (a regrid's survivors), else
    over the first that many CUDA cards
    (:func:`~repro_torch.core.api.make_grid_mesh`), or all on the CPU with
    ``--device cpu``."""
    from ..core.api import make_grid_mesh

    if args.device not in (None, "cpu"):
        raise SystemExit(
            "--mesh puts every grid position on its own card; drop "
            "--device (or pass --device cpu for a CPU mesh)")
    if devices is None and args.device == "cpu":
        devices = ["cpu"] * (q * q * npods)
    return make_grid_mesh(q, npods=npods, devices=devices)


def _device_field(where) -> str:
    """A report's ``device``: the device, or a mesh's distinct devices in
    position order, as ``count_triangles`` writes them."""
    from .mesh import DeviceMesh

    if isinstance(where, DeviceMesh):
        return ",".join(dict.fromkeys(str(d) for d in where.devices))
    return str(where)


def _finish(g, args, report, total):
    """``--verify`` against the host oracle, then print the report; a
    mismatch exits non-zero after the report is out."""
    from ..core import triangle_count_oracle

    if args.verify:
        expected = triangle_count_oracle(g)
        report["expected"] = expected
        report["correct"] = bool(total == expected)

    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k}: {v}")
    if args.verify and not report["correct"]:
        raise SystemExit(
            f"count mismatch: got {total}, expected {report['expected']}"
        )


def _run_opt(g, args):
    """``--opt`` (Cannon): plan with the canonical blocks and the B
    intersection keys, bucketize the tasks at ``d_small = 32``, and count
    with ``search2`` over blob shifts whose indptr travels as uint16
    length pairs.  Host planning is ``ppt_seconds``; ``tct_seconds`` is
    the count (the best warm one under ``--repeat``).  With ``--mesh`` the
    bucketized plan is staged on the ``grid x grid`` mesh (no pods, as the
    JAX package's function takes none).  Returns ``(total, report
    fields)``."""
    from ..core.cannon import build_cannon_fn
    from ..core.plan import bucketize_plan
    from ..device import resolve_device
    from ..pipeline import plan_cannon
    from ..pipeline.artifact import stage_arrays

    mesh = _grid_mesh(args, args.grid) if args.mesh else None
    where = mesh or resolve_device(args.device)
    t0 = time.perf_counter()
    art = plan_cannon(
        g, args.grid, chunk=args.chunk, keep_blocks=True,
        rebalance_trials=args.rebalance, aug_keys=True,
        compact=not args.no_compact,
    )
    out = _rebalance_fields(art.rebalance) if args.rebalance else {}
    bplan = bucketize_plan(art.plan)
    t1 = time.perf_counter()
    fn = build_cannon_fn(
        bplan, method="search2", compress_lengths=True,
        use_step_mask=False if args.no_skip_mask else None,
        double_buffer=not args.no_double_buffer,
        compact=False if args.no_compact else None, mesh=mesh,
    )
    # on a mesh each position's blocks on its device (its uint16 blob
    # packed there at every count)
    staged = stage_arrays(bplan.device_arrays(), where)
    times = []
    for _ in range(max(1, args.repeat)):
        t_run = time.perf_counter()
        total = int(fn(**staged))
        times.append(time.perf_counter() - t_run)
    out.update(
        triangles=total,
        ppt_seconds=round(t1 - t0, 4),
        tct_seconds=round(min(times[1:]) if len(times) > 1 else times[0], 4),
        optimized=True,
        bucket_reduction=round(bplan.bucket_stats["reduction"], 3),
        device=_device_field(where),
    )
    out.update(_skip_fields(bplan, args.no_skip_mask))
    out.update(_compact_fields(bplan))
    return total, out


def _time_split(g, args) -> dict:
    """Shift/count attribution probes (any schedule):

    * shift-only (``tct_shift_only``; ``tct_broadcast_only`` on SUMMA) —
      the masked engine fed an all-False skip mask: every roll runs, no
      count kernel does;
    * count-only (``tct_count_only``) — the same engine with its shifts
      or broadcasts elided (``elide_shifts`` / ``elide_broadcast``): every
      count kernel runs against the blocks each device holds (a timing
      proxy — counts are wrong past one device, so the result is
      discarded).

    Both run the *uncompacted* loop with the caller's flags, the best of
    3 calls after 1 warm one.  The ``coll_*_bytes`` fields are the bytes
    one call of the *production* configuration moves by engine phase
    (:func:`repro_torch.launch.roofline.collective_phases`): the whole
    grid's, on the one card that holds it.

    With ``--mesh`` every function is built for a mesh and its plan staged
    there, as the JAX package's probe does: Cannon on the ``grid x grid``
    (with pods ``pods x grid x grid``) mesh, SUMMA on the ``grid x grid``
    one, the ring on a ``("flat",)`` mesh over the pod mesh's devices; the
    ``coll_*_bytes`` are then the bytes that crossed positions (a SUMMA
    round's panel copies under ``broadcast``).
    """
    import numpy as np

    from ..device import resolve_device
    from ..pipeline.artifact import stage_arrays
    from .roofline import collective_phases

    out = {}
    mesh = _grid_mesh(args, args.grid, args.pods) if args.mesh else None
    # the grid without pods (SUMMA's) and the ring over every position
    grid_mesh = None if mesh is None else (
        mesh.pod(0) if args.pods > 1 else mesh)
    ring = None if mesh is None else mesh.reshaped((mesh.size,), ("flat",))
    device = None if mesh is not None else resolve_device(args.device)

    def timed_min(fn, arrays, warm=1, iters=3):
        for _ in range(warm):
            int(fn(**arrays))
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            int(fn(**arrays))  # synchronises
            best = min(best, time.perf_counter() - t0)
        return round(best, 4)

    def all_false(fn):
        return fn.rebind(m_cnt=fn.m_cnt,
                         step_keep=np.zeros_like(fn.step_keep))

    mask = dict(use_step_mask=False if args.no_skip_mask else None,
                compact=False if args.no_compact else None)
    if args.schedule == "cannon":
        from ..core.cannon import build_cannon_fn, pod_stack_arrays
        from ..pipeline import plan_cannon

        art = plan_cannon(g, args.grid, chunk=args.chunk)
        plan = art.plan
        if plan.step_keep is None:
            return {}
        if mesh is not None:  # a pod mesh stacks A and B over the pods
            staged = art.staged(mesh)
        elif args.pods > 1:
            staged = stage_arrays(
                pod_stack_arrays(plan.device_arrays(), args.pods, plan.q),
                device)
        else:
            staged = art.staged(device)
        common = dict(npods=args.pods,
                      double_buffer=not args.no_double_buffer,
                      reduce_strategy=args.reduce_strategy, mesh=mesh)
        fcomm = build_cannon_fn(plan, use_step_mask=True, compact=False,
                                **common)
        out["tct_shift_only"] = timed_min(all_false(fcomm), staged)
        fcount = build_cannon_fn(plan, use_step_mask=False, compact=False,
                                 elide_shifts=True, **common)
        out["tct_count_only"] = timed_min(fcount, staged)
        fprod = build_cannon_fn(plan, **mask, **common)
    elif args.schedule == "summa":
        from ..core.summa import build_summa_fn
        from ..pipeline import plan_summa

        art = plan_summa(g, args.grid, args.grid, chunk=args.chunk,
                         broadcast=args.broadcast or "auto")
        plan = art.plan
        if plan.step_keep is None:
            return {}
        staged = art.staged(grid_mesh or device)
        common = dict(broadcast=args.broadcast, mesh=grid_mesh)
        fcomm = build_summa_fn(plan, use_step_mask=True, compact=False,
                               **common)
        out["tct_broadcast_only"] = timed_min(all_false(fcomm), staged)
        fcount = build_summa_fn(plan, use_step_mask=False, compact=False,
                                elide_broadcast=True, **common)
        out["tct_count_only"] = timed_min(fcount, staged)
        fprod = build_summa_fn(plan, **mask, **common)
    elif args.schedule == "oned":
        from ..core.onedim import build_oned_fn
        from ..pipeline import plan_oned

        p = args.grid * args.grid * args.pods
        art = plan_oned(g, p, chunk=args.chunk)
        plan = art.plan
        if plan.step_keep is None:
            return {}
        staged = art.staged(ring or device)
        fcomm = build_oned_fn(plan, use_step_mask=True, compact=False,
                              mesh=ring)
        out["tct_shift_only"] = timed_min(all_false(fcomm), staged)
        fcount = build_oned_fn(plan, use_step_mask=False, compact=False,
                               elide_shifts=True, mesh=ring)
        out["tct_count_only"] = timed_min(fcount, staged)
        fprod = build_oned_fn(plan, reduce_strategy=args.reduce_strategy,
                              mesh=ring, **mask)
    else:  # a registered schedule this probe does not know how to split
        return {}

    phases = collective_phases(fprod, staged)
    out.update(
        coll_shift_bytes=phases["shift"],
        coll_broadcast_bytes=phases["broadcast"],
        coll_reduce_bytes=phases["reduce"],
        coll_other_bytes=phases["other"],
    )
    return out


def _run_checkpointed(g, args, fault_plan=None):
    """Shift-at-a-time Cannon with mid-loop checkpoint/restart.

    The checkpointed state is the stepper's carry (with the
    double-buffered body: two payload generations, built once by
    ``stepper.prime``) plus the ``(q, q)`` int64 per-device partial
    counts; the host loop owns the shift index and passes it to each step
    so the skip mask stays aligned after a resume.  Under a compacted
    plan the loop iterates ``stepper.live_steps`` only (one generation,
    one fused hop a call).  A checkpoint stores the *original* next-shift
    index plus the step-list signature, the collective strategy and the
    grid: a same-mode resume filters the step list to ``>= saved``, while
    a *cross-mode* restore (compacted checkpoint under ``--no-compact``,
    double- vs single-buffered carry, another ``--reduce-strategy``) is
    refused loudly — a silent resume would count misaligned blocks.

    Supervised runs (``--inject-faults``/``--supervise``) drive the same
    loop under :class:`repro_torch.runtime.Supervisor`: each restart
    restores the latest intact checkpoint (the manager quarantines corrupt
    steps) and a ``DeviceLost`` re-factorizes the surviving logical
    devices (``--grid``² less the event's ``lost``) to the largest square
    via :func:`repro_torch.runtime.best_grid`, re-plans through the
    pipeline and restarts the count on the smaller grid — mid-schedule
    per-device partials are **refused** across grids, so the regrid
    counts from shift 0 into a fresh ``regrid_{q}x{q}`` subdirectory.
    The plan's tensors are staged once per grid (the artifact's memoised
    staging), however many attempts run.

    With ``--mesh`` the stepper runs on a ``q x q`` device mesh, as the
    JAX package's runs on ``make_grid_mesh(q)``: the carry and the
    partial counts are mesh arrays, each position's blocks on its device,
    and a checkpoint holds their global arrays (the bytes one device's
    run writes).  A ``DeviceLost`` then counts the starting mesh's
    positions less the event's ``lost``, and the new grid's mesh stands on
    the first surviving positions' devices.
    """
    import os

    import numpy as np
    import torch

    from ..ckpt import CheckpointManager
    from ..core.cannon import build_cannon_stepper
    from ..core.engine import Reduction
    from ..device import resolve_device
    from ..pipeline import plan_cannon
    from ..pipeline.artifact import stage_on_mesh
    from ..runtime import faultinject
    from ..runtime.supervisor import check_partials_portable

    # the starting mesh, whose positions a regrid counts and whose first
    # devices the smaller grid's mesh takes
    start = _grid_mesh(args, args.grid) if args.mesh else None
    device = None if start is not None else resolve_device(args.device)
    t0 = time.perf_counter()
    cross_mode = (
        "checkpoint in {d} was written by a run with a different "
        "schedule shape ({why}) — the saved carry's position and arity "
        "do not transfer across step sequences (compacted vs "
        "--no-compact, double- vs single-buffered), and partial counts "
        "accumulated under one collective strategy must not be summed "
        "under another: resume with the original flags or start from a "
        "fresh --ckpt-dir"
    )
    coll_sig = (
        f"reduce={args.reduce_strategy},broadcast={args.broadcast or 'auto'}"
    )

    def setup(q, ckpt_dir):
        """Plan + stepper + checkpoint manager for one grid size.  Runs
        once up front and again per DeviceLost regrid."""
        # no blocks kept (the stepper reads none): the plan is the one
        # count_triangles(method="search") makes, and shares its cache entry
        art = plan_cannon(g, q, chunk=args.chunk, keep_blocks=False,
                          compact=not args.no_compact)
        mesh = (None if start is None
                else _grid_mesh(args, q, devices=start.devices))
        stepper = build_cannon_stepper(
            art.plan, mesh,
            use_step_mask=False if args.no_skip_mask else None,
            double_buffer=not args.no_double_buffer,
            compact=False if args.no_compact else None,
        )
        arrays = art.staged(mesh or device)
        steps = (list(stepper.live_steps) if stepper.live_steps is not None
                 else list(range(q)))
        n_carry = stepper.n_carry
        # shape/dtype/device template for restore: carry leaves are
        # operand-shaped (two payload generations when double-buffered)
        ops = [arrays[k] for k in ("a_indptr", "a_indices", "b_indptr",
                                   "b_indices")]
        state_like = {f"carry{i}": ops[i % len(ops)] for i in range(n_carry)}
        state_like["acc"] = (
            torch.zeros((q, q), dtype=torch.int64, device=device)
            if mesh is None
            else stage_on_mesh(np.zeros((q, q), dtype=np.int64), mesh))
        return dict(
            q=q, mesh=mesh, ckpt_dir=ckpt_dir, stepper=stepper, arrays=arrays,
            steps=steps, n_carry=n_carry, state_like=state_like,
            mgr=CheckpointManager(ckpt_dir, keep=2, async_save=False),
            step_sig=",".join(map(str, steps)), grid_sig=f"{q}x{q}",
        )

    env = setup(args.grid, args.ckpt_dir)
    t1 = time.perf_counter()

    def restore_or_prime(env):
        try:
            _, restored, extra = env["mgr"].restore_latest(env["state_like"])
        except KeyError as e:  # carry arity mismatch: fewer/more leaves
            raise SystemExit(
                cross_mode.format(d=env["ckpt_dir"], why=f"missing {e}")
            ) from e
        if restored is None:
            carry0 = env["stepper"].prime(env["arrays"])
            st = {f"carry{i}": c for i, c in enumerate(carry0)}
            st["acc"] = env["state_like"]["acc"]
            return st, 0
        check_partials_portable(extra, env["grid_sig"])
        for key, mine in (("steps", env["step_sig"]),
                          ("collectives", coll_sig)):
            if extra.get(key, mine) != mine:
                raise SystemExit(cross_mode.format(
                    d=env["ckpt_dir"],
                    why=f"{key} [{extra[key]}] vs [{mine}]",
                ))
        start = int(extra["shift"])
        print(f"resumed at shift {start}")
        return restored, start

    failed = {"done": False}

    def attempt(attempt_index, guard):
        st, start = restore_or_prime(env)
        stepper, arrays = env["stepper"], env["arrays"]
        n_carry, mgr, steps = env["n_carry"], env["mgr"], env["steps"]
        todo = [s for s in steps if s >= start]
        while todo:
            guard()
            s = todo.pop(0)
            if (args.fail_at_shift is not None and s == args.fail_at_shift
                    and not failed["done"]):
                failed["done"] = True
                print(f"(injected failure at shift {s}; restarting from "
                      "ckpt)")
                _, restored, extra = mgr.restore_latest(env["state_like"])
                if restored is not None:
                    st = restored
                    saved = int(extra["shift"])  # next shift to execute
                    todo = [t for t in steps if t >= saved]
                    s = todo.pop(0)
            faultinject.fire("step", step=s)
            out = stepper(
                tuple(st[f"carry{i}"] for i in range(n_carry)) + (st["acc"],),
                arrays, step=s,
            )
            st = {f"carry{i}": out[i] for i in range(n_carry)}
            st["acc"] = out[n_carry]
            mgr.save(
                s + 1, st,
                extra={"shift": s + 1, "steps": env["step_sig"],
                       "collectives": coll_sig, "grid": env["grid_sig"]},
            )
        return st

    sup_dict = None
    if fault_plan is not None or args.supervise:
        from ..runtime import BackoffPolicy, DeviceLost, Supervisor, best_grid
        from ..runtime.supervisor import GridTransferRefused

        sup = Supervisor(
            max_restarts=args.restart_budget,
            attempt_deadline=args.attempt_deadline,
            backoff=BackoffPolicy(base=0.02, max_delay=0.5),
        )

        def on_fault(e, rec):
            if fault_plan is not None and fault_plan.log:
                last = fault_plan.log[-1]
                rec.point, rec.step = last.get("point"), last.get("step")
            if not isinstance(e, DeviceLost):
                return None
            # the grid the run started on (on a mesh, its positions), less
            # this event's loss
            remaining = args.grid ** 2 - e.lost
            if remaining < 1:
                raise RuntimeError(
                    f"cannot regrid: {e.lost} devices lost, "
                    f"{remaining} remaining"
                )
            # the stepper is Cannon-only: square survivors
            r, _ = best_grid(remaining, require_square=True)
            # surface the refusal loudly: probe the old grid's latest
            # checkpoint against the new signature, then drop it
            try:
                _, restored, extra = env["mgr"].restore_latest(
                    env["state_like"])
                if restored is not None:
                    check_partials_portable(extra, f"{r}x{r}")
            except GridTransferRefused as refuse:
                print(f"(device lost: {refuse})")
            except KeyError:  # another mode's carry: nothing to move
                pass
            env["mgr"].close()
            new_dir = os.path.join(args.ckpt_dir, f"regrid_{r}x{r}")
            env.clear()
            env.update(setup(r, new_dir))
            sup.report.regrids.append(
                dict(lost=e.lost, grid=[r, r], ckpt_dir=new_dir))
            return f"regrid to {r}x{r}"

        with faultinject.armed(fault_plan):
            st = sup.run(attempt, on_fault=on_fault)
        sup_dict = sup.report.to_dict()
        if fault_plan is not None:
            sup_dict["fault_log"] = list(fault_plan.log)
    else:
        st = attempt(0, lambda: None)

    # the one device→host crossing (on a mesh after a sum on its first
    # device)
    total = int(Reduction().resolve().apply(st["acc"])
                if env["mesh"] is not None
                else st["acc"].sum())
    t2 = time.perf_counter()
    env["mgr"].close()
    out = dict(
        triangles=total,
        ppt_seconds=round(t1 - t0, 4),
        tct_seconds=round(t2 - t1, 4),
        checkpointed=True,
        live_steps=len(env["steps"]),
        schedule_shifts=env["q"],
        device=_device_field(env["mesh"] or device),
    )
    if sup_dict is not None:
        if sup_dict.get("regrids"):
            out["final_grid"] = [env["q"], env["q"]]
        out.update(_supervision_fields(sup_dict))
    return total, out


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
        schedule=args.schedule,
        method=args.method,
        broadcast=args.broadcast,
        reduce_strategy=args.reduce_strategy,
        chunk=args.chunk,
        probe_shorter=not args.no_probe_shorter,
        use_step_mask=False if args.no_skip_mask else None,
        compact=False if args.no_compact else None,
        **_placement(args),
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


def _supervision_fields(sup: "dict | None") -> dict:
    """Flatten a TCResult.supervision record (or a SupervisionReport
    dict) into report fields.  Attempt-by-attempt detail stays nested
    under ``supervision_attempts``; demotions/regrids are emitted only
    when non-empty so fault-free supervised runs stay compact."""
    if not sup:
        return {}
    out = dict(
        supervision_attempts=sup.get("attempts", []),
        supervision_restarts=sup.get("restarts", 0),
        supervision_backoff_seconds=sup.get("total_backoff_seconds", 0.0),
    )
    if sup.get("demotions"):
        out["supervision_demotions"] = sup["demotions"]
    if sup.get("regrids"):
        out["supervision_regrids"] = sup["regrids"]
    if sup.get("fault_log"):
        out["supervision_fault_log"] = sup["fault_log"]
    if sup.get("gave_up"):
        out["supervision_gave_up"] = True
    return out


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
    if args.time_split:
        raise SystemExit(
            "--time-split is not supported with --graphs (one engine "
            "call spans every plan, so there is no per-graph shift/count "
            "attribution); use single-graph runs"
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
    placement = _placement(args, pods=False)  # a batch counts on one pod
    t0 = time.perf_counter()
    for _ in range(max(1, args.repeat)):  # later rounds hit the program cache
        res = count_triangles_many(
            graphs,
            schedule=args.schedule,
            method=method,
            chunk=args.chunk,
            probe_shorter=not args.no_probe_shorter,
            **placement,
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
