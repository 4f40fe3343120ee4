"""Serving front ends.

LM mode — batched KV-cached greedy decode for the LM archs:

    python -m repro_torch.launch.serve --arch qwen2-0.5b-smoke \\
        --batch 4 --gen 16

Triangle-count batch mode — repeated batched counts over a working set of
graphs, the heavy-traffic shape the planning pipeline is built for
(content-addressed plan cache + one engine call per batch; round 0 is the
cold plan, later rounds hit the program cache):

    python -m repro_torch.launch.serve \\
        --tc-graphs "rmat:10;rmat:10,8,1;karate" --grid 1 --rounds 5

Streaming mode — one live graph mutated by a random edge delta per round,
served through the incremental re-plan path (round 0 is the cold plan,
later rounds splice dirty blocks and reuse the engine):

    python -m repro_torch.launch.serve \\
        --tc-stream er:500,8,3 --grid 1 --rounds 5 --delta-edges 4

In the triangle-count modes every round is one request under its own
supervision: bounded retries with backoff, an optional cooperative
deadline, and a failure budget for the session (``--inject-faults``
exercises them).  Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time


def _serve_fault_plan(args):
    if not getattr(args, "inject_faults", None):
        return None
    from ..runtime import FaultPlan

    return FaultPlan.parse(args.inject_faults)


def _new_request_stats():
    return {"ok": 0, "failed": 0, "restarts": 0}


def _serve_request(args, stats, label, fn):
    """One serving request under per-request supervision: bounded
    retries with backoff and an optional cooperative deadline.

    Returns the result, or ``None`` when the request exhausted its retry
    budget — the failure is recorded and the serving loop moves on,
    until the session-wide ``--failure-budget`` trips (``SystemExit``).
    A ``--verify`` mismatch is a ``SystemExit``, never retried: a wrong
    count is a correctness bug, not a transient fault.
    """
    from ..runtime import BackoffPolicy, Supervisor

    sup = Supervisor(
        max_restarts=args.request_retries,
        attempt_deadline=args.request_deadline,
        backoff=BackoffPolicy(base=0.05, max_delay=0.5),
        retry_on=(Exception,),
    )

    def attempt(i, guard):
        guard()
        out = fn()
        guard()  # cooperative: a slow dispatch is recorded post hoc
        return out

    try:
        res = sup.run(attempt)
    except Exception as e:  # the request's retries are spent: record it
        stats["failed"] += 1
        stats["restarts"] += sup.report.restarts
        print(
            f"{label} FAILED after {sup.report.restarts - 1} retries: "
            f"{type(e).__name__}: {e}"
        )
        if stats["failed"] > args.failure_budget:
            raise SystemExit(
                f"failure budget exhausted: {stats['failed']} failed "
                f"requests > budget {args.failure_budget}"
            ) from e
        return None
    stats["ok"] += 1
    stats["restarts"] += sup.report.restarts
    return res


def _print_request_stats(args, stats):
    print(
        f"supervision: {stats['ok']} ok, {stats['failed']} failed, "
        f"{stats['restarts']} restarts "
        f"(retries/request {args.request_retries}, "
        f"failure budget {args.failure_budget})"
    )


def _serve_tc(args):
    from ..core import count_triangles_many
    from ..core.generators import graphs_from_specs
    from ..pipeline import default_cache
    from ..runtime import faultinject

    graphs = graphs_from_specs(args.tc_graphs)
    expected = None
    res = None
    req = _new_request_stats()
    with faultinject.armed(_serve_fault_plan(args)):
        for rnd in range(args.rounds):
            t0 = time.perf_counter()
            got = _serve_request(
                args, req, f"round {rnd}",
                lambda: count_triangles_many(
                    graphs,
                    q=args.grid,
                    schedule=args.schedule,
                    method=args.method,
                    device=args.device,
                ),
            )
            if got is None:
                continue
            res = got
            dt = time.perf_counter() - t0
            print(
                f"round {rnd}: triangles={res.triangles} in {dt*1e3:.1f}ms "
                f"({len(graphs)/dt:.1f} graphs/s, "
                f"{'warm' if res.cache_hit else 'cold'})"
            )
            if args.verify:
                # exact host oracle — O(m·d) sequential, small graphs only
                if expected is None:
                    from ..core import triangle_count_oracle

                    expected = [triangle_count_oracle(g) for g in graphs]
                if res.triangles != expected:
                    raise SystemExit(
                        f"count mismatch: {res.triangles} != {expected}"
                    )
    stats = default_cache().stats()
    print(
        f"plan cache: {stats['hits']} hits / {stats['misses']} misses"
        + (
            f", batched padding overhead {res.padding_overhead:.2f}"
            if res is not None
            else ""
        )
    )
    _print_request_stats(args, req)


def _serve_tc_stream(args, graph=None):
    """Streaming TC serving: a live graph takes one edge delta per round.

    Round 0 plans cold; every later round draws a deterministic random
    flip delta (``EdgeDelta.random_flips(g, --delta-edges, seed=round)``),
    applies it through :func:`repro_torch.pipeline.apply_delta` (splice /
    repack / rebase ladder) and re-counts from the derived artifact — the
    serving analogue of ``tc_run --stream``.

    Each round runs as a supervised request: a failed round (retry budget
    exhausted) does **not** advance the live graph or the derived artifact
    — completed rounds are the only portable boundary for the delta
    lineage, so the next round re-derives its delta from the last good
    state.

    ``graph`` is the live graph's start when the caller already holds it
    (else ``--tc-stream`` is generated).  Returns the live graph and the
    last completed round's result.
    """
    from ..core import count_triangles, count_triangles_delta
    from ..pipeline import EdgeDelta, default_cache
    from ..runtime import faultinject

    g = _spec_graph(args.tc_stream) if graph is None else graph
    kwargs = dict(q=args.grid, schedule=args.schedule, method=args.method,
                  device=args.device)
    req = _new_request_stats()
    with faultinject.armed(_serve_fault_plan(args)):
        t0 = time.perf_counter()
        res = _serve_request(
            args, req, "round 0", lambda: count_triangles(g, **kwargs)
        )
        if res is None:
            raise SystemExit(
                "round 0 (the cold base count) failed: no artifact to "
                "stream deltas against"
            )
        print(
            f"round 0: triangles={res.triangles} in "
            f"{(time.perf_counter() - t0) * 1e3:.1f}ms (cold plan)"
        )
        _maybe_verify(args, g, res.triangles)
        art = res.artifact
        for rnd in range(1, args.rounds):
            delta = EdgeDelta.random_flips(g, args.delta_edges, seed=rnd)
            t0 = time.perf_counter()
            got = _serve_request(
                args, req, f"round {rnd}",
                lambda: count_triangles_delta(
                    g, delta, artifact=art, **kwargs
                ),
            )
            if got is None:
                continue  # failed round: g/art unchanged (last good state)
            res = got
            dt = time.perf_counter() - t0
            art, rep = res.artifact, res.delta
            g = delta.apply_to(g)
            print(
                f"round {rnd}: triangles={res.triangles} in {dt*1e3:.1f}ms "
                f"({rep['level']}, {rep['dirty_blocks']} dirty blocks, "
                f"+{rep['edges_added']}/-{rep['edges_removed']} edges"
                f"{', rebased' if rep['rebased'] else ''})"
            )
            _maybe_verify(args, g, res.triangles)
    stats = default_cache().stats()
    print(f"plan cache: {stats['hits']} hits / {stats['misses']} misses")
    _print_request_stats(args, req)
    return g, res


def _spec_graph(spec):
    from ..core.generators import graph_from_spec

    return graph_from_spec(spec)


def _maybe_verify(args, g, got):
    if not args.verify:
        return
    from ..core import triangle_count_oracle

    exp = triangle_count_oracle(g)
    if got != exp:
        raise SystemExit(f"count mismatch: {got} != {exp}")


def serve_lm(cfg, params, *, batch, gen, max_len, device=None):
    """The LM mode's decode loop: ``gen`` greedy steps for ``batch``
    sequences from token 1 on a cache of ``max_len`` slots, through the
    decode step.  ``params`` is the reference's tree of tensors on
    ``device`` (a test hands it the JAX package's weights).  Returns the
    tokens ``(batch, gen)`` as numpy and the seconds the loop took, the
    device synchronised."""
    import torch

    from ..device import resolve_device
    from ..models.steps import build_lm_decode_step
    from ..models.transformer import init_kv_cache

    dev = resolve_device(device)
    decode, _ = build_lm_decode_step(cfg, device=dev)
    cache = init_kv_cache(cfg, batch, max_len, device=dev)
    tok = torch.ones((batch,), dtype=torch.int32, device=dev)
    cache_len = torch.zeros((batch,), dtype=torch.int32, device=dev)
    outs = []
    t0 = time.perf_counter()
    for _ in range(gen):
        tok, cache = decode(params, cache, tok, cache_len)
        cache_len = cache_len + 1
        outs.append(tok)
    toks = torch.stack(outs, 1).cpu().numpy()  # waits for the device
    return toks, time.perf_counter() - t0


def _serve_lm(args):
    import torch

    from ..configs import get_config
    from ..device import resolve_device
    from ..models.transformer import lm_init

    cfg = get_config(args.arch)
    if cfg.family != "lm":
        raise SystemExit(
            f"--arch {args.arch}: a {cfg.family!r} config; LM serving takes "
            "an LM arch (see repro_torch.configs.LM_ARCHS, or a -smoke "
            "variant)")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm_init(gen, cfg, device=dev)
    toks, dt = serve_lm(cfg, params, batch=args.batch, gen=args.gen,
                        max_len=args.max_len, device=dev)
    print(
        f"decoded {args.batch}x{args.gen} tokens in {dt:.2f}s "
        f"({args.batch*args.gen/dt:.1f} tok/s)"
    )
    print("first sequence:", toks[0])
    return toks


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM serving: batched KV-cached greedy decode of "
                         "this LM config, random weights from seed 0")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--tc-graphs", default=None,
                    help="';'-separated graph specs: serve repeated "
                         "batched triangle counts")
    ap.add_argument("--tc-stream", default=None,
                    help="single graph spec: serve streaming counts — "
                         "one random edge delta per round through the "
                         "incremental re-plan path")
    ap.add_argument("--delta-edges", type=int, default=4,
                    help="streaming: edge flips per round")
    ap.add_argument("--grid", type=int, default=1)
    ap.add_argument("--schedule", default="cannon")
    ap.add_argument("--method", default="search")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--verify", action="store_true",
                    help="check every round against the exact host "
                         "oracle (small graphs only)")
    ap.add_argument("--request-retries", type=int, default=2,
                    help="TC serving: max retries per round before the "
                         "round is recorded as failed")
    ap.add_argument("--request-deadline", type=float, default=None,
                    help="TC serving: cooperative per-round deadline in "
                         "seconds (a round past it is retried, then "
                         "failed)")
    ap.add_argument("--failure-budget", type=int, default=3,
                    help="TC serving: failed rounds tolerated per "
                         "session before the server exits")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="deterministic typed fault injection across "
                         "the serving session (same grammar as tc_run) — "
                         "exercises the per-request retry/failure-budget "
                         "path")
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without one)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.tc_graphs:
        return _serve_tc(args)
    if args.tc_stream:
        _serve_tc_stream(args)
        return
    if not args.arch:
        raise SystemExit(
            "pass --arch (LM serving), --tc-graphs, or --tc-stream"
        )
    return _serve_lm(args)


if __name__ == "__main__":
    main()
