#!/usr/bin/env python3
"""Smoke-run the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: rmat(20, 16), q = 4
    python3 chip_smoke.py --scale 16 # a quicker main path

What it does, in order, printing one JSON object per line:

1. ``env``        — torch / CUDA versions, the card's name and power limit;
2. ``build``      — builds every CUDA kernel of the package from
                    ``src/repro_torch/kernels/csrc`` with ``nvcc``;
3. ``traps``      — holds each kernel against its plain PyTorch version on
                    small inputs built to hit the edge cases (exact equality);
4. ``main_path``  — ``repro_torch.count_triangles(rmat(scale, 16), q=4,
                    method="fused")`` on the GPU, checked against the same
                    call with ``method="search"`` and against a scipy oracle
                    that shares no code with the package; then the same
                    graph again, which must hit the plan cache;
5. ``kernels``    — for each kernel: equality with the plain version on
                    every device-step the main path gave it, its time,
                    the plain version's time, the least time the card
                    could take (``bound_ms``: every input byte once) and
                    its launches during phase 4;
6. ``small_graphs`` — a grid of small fixtures, q in {1, 2, 3}, every
                    method, against the exact per-edge oracle.

Any mismatch, failed build or failed launch ends the run with a non-zero
exit.  Nothing here runs on the CPU in place of the GPU: without a CUDA
device the script exits non-zero before printing any result.  The last
line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
EDGE_FACTOR = 16  # Graph500's
GRID = 4  # q: 16 logical devices, 4 Cannon steps
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/tc_fused.cu"
KERNEL_REPLACES = "src/repro/kernels/tc_fused/tc_fused.py:146"


def emit(tag, **fields):
    print(json.dumps({tag: fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ----------------------------------------------------------------------
# oracle independent of the package
# ----------------------------------------------------------------------
def scipy_triangle_oracle(n, edges, rows_per_block=1 << 16):
    """``sum((U @ U) ∘ U)`` over the degree-ordered upper-triangular
    adjacency ``U``, with scipy.sparse, in row blocks to bound memory."""
    import scipy.sparse as sp

    deg = np.bincount(edges[:, 0], minlength=n) + np.bincount(
        edges[:, 1], minlength=n
    )
    rank = np.empty(n, dtype=np.int64)
    rank[np.argsort(deg, kind="stable")] = np.arange(n, dtype=np.int64)
    a, b = rank[edges[:, 0]], rank[edges[:, 1]]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    u = sp.csr_matrix(
        (np.ones(lo.shape[0], dtype=np.int64), (lo, hi)), shape=(n, n)
    )
    total = 0
    for r0 in range(0, n, rows_per_block):
        ub = u[r0 : r0 + rows_per_block]
        total += int((ub @ u).multiply(ub).sum())
    return total


# ----------------------------------------------------------------------
# kernel vs plain version
# ----------------------------------------------------------------------
def _random_csr(rng, nrows, maxd, ncols, pad, last_len=None):
    lens = rng.integers(0, maxd + 1, size=nrows)
    if last_len is not None:
        lens[-1] = last_len
    rows = [np.sort(rng.choice(ncols, size=int(k), replace=False)) for k in lens]
    indptr = np.zeros(nrows + 1, np.int32)
    indptr[1:] = np.cumsum(lens)
    idx = np.concatenate(rows + [np.full(pad, ncols)]).astype(np.int32)
    return indptr, idx


def trap_cases(seed=0):
    """(name, arrays, tcounts, tile, d): small inputs for the edge cases —
    rows longer than ``d`` (both versions truncate at ``d``), a non-empty
    last row closer than ``d`` to the array end, ``d`` beyond the whole
    array, empty rows, padding tasks masked by ``tcount``."""
    rng = np.random.default_rng(seed)
    out = []
    nrows, ncols = 40, 500
    for name, maxd, pad, last_len, d, tile, ntask in (
        ("fits", 12, 7, None, 12, 32, 300),
        ("truncates", 40, 7, None, 16, 8, 300),
        ("array_end", 12, 0, 9, 12, 32, 257),
        ("d_beyond_array", 3, 0, 3, 256, 16, 100),
        ("tile_256", 20, 3, None, 24, 256, 1000),
    ):
        ap, ai = _random_csr(rng, nrows, maxd, ncols, pad, last_len)
        bp, bi = _random_csr(rng, nrows, maxd, ncols, pad, last_len)
        ti = rng.integers(0, nrows, ntask).astype(np.int32)
        tj = rng.integers(0, nrows, ntask).astype(np.int32)
        ti[-1] = tj[-1] = nrows - 1  # the last row is a task
        ti[0] = tj[0] = 0
        tcounts = (0, 1, ntask // 2 + 3, ntask)
        out.append((name, (ap, ai, bp, bi, ti, tj), tcounts, tile, d))
    return out


def run_traps(dev):
    from repro_torch.kernels.tc_fused import (
        fused_short_counts,
        fused_short_counts_plain,
        fused_short_ref,
    )

    checked = 0
    for name, arrays, tcounts, tile, d in trap_cases():
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        for tc in tcounts:
            got = fused_short_counts(*t, tc, tile=tile, d=d)
            want = fused_short_counts_plain(*t, tc, tile=tile, d=d)
            ref = int(fused_short_ref(*t, tc, d=d, tile=tile))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"trap {name} tcount={tc}: kernel != plain per tile")
            if int(got.sum()) != ref:
                fail(f"trap {name} tcount={tc}: kernel total != reference")
            checked += 1
    return checked


def step_inputs(art, dev, x=0, y=0, step=0):
    """The tensors logical device ``(x, y)`` hands the fused kernel at
    Cannon step ``step`` of the planned main path, exactly as
    ``count_pair_fused`` slices them: after ``step`` shifts the device
    holds block ``(x, y + step)`` of A and block ``(x + step, y)`` of B."""
    from repro_torch.kernels.tc_fused import fused_split_sizes, fused_tile_for

    plan = art.plan
    st = art.staged(dev)
    q = plan.q
    ax, ay = x, (y + step) % q
    bx, by = (x + step) % q, y
    a_ptr, a_idx = st["a_indptr"][ax, ay], st["a_indices"][ax, ay]
    b_ptr, b_idx = st["b_indptr"][bx, by], st["b_indices"][bx, by]
    n_long_c, _ = fused_split_sizes(plan.tmax, plan.n_long, plan.chunk)
    d = int(max(1, min(plan.d_small, a_idx.shape[0], b_idx.shape[0])))
    tile = fused_tile_for(d)
    ti, tj = st["m_ti"][x, y][n_long_c:], st["m_tj"][x, y][n_long_c:]
    tcount = max(int(plan.m_cnt[x, y]) - n_long_c, 0)
    return (a_ptr, a_idx, b_ptr, b_idx, ti, tj), tcount, tile, d


def kernel_bound(args, tcount, tile, d):
    """Least time the card could take for this call's data.

    Bytes, each counted ONCE however many tasks name it: the two ids of
    every live task, the row pointers and the column ids (cut at ``d``)
    of every distinct row a live task names, and the per-tile output,
    over the memory rate; against one compare per binary-search step
    (shorter fragment probed into the longer) over the 32-bit rate.

    ``task_traffic_bytes`` is another quantity and no bound: what the
    tasks read when every task's fragments are counted per task (24 B of
    ids and pointers and 4 B per column id).  Rows are shared between
    tasks, so most of it can be served from cache."""
    a_ptr, _, b_ptr, _, ti, tj = args
    live = min(tcount, ti.shape[0])
    len_a = (a_ptr[1:] - a_ptr[:-1]).clamp(max=d).long()
    len_b = (b_ptr[1:] - b_ptr[:-1]).clamp(max=d).long()
    rows_a = torch.unique(ti[:live].long())
    rows_b = torch.unique(tj[:live].long())
    ntile = max(1, -(-ti.shape[0] // tile))
    nbytes = int(
        8 * live
        + 4 * (rows_a.numel() + 1) + 4 * int(len_a[rows_a].sum())
        + 4 * (rows_b.numel() + 1) + 4 * int(len_b[rows_b].sum())
        + 4 * ntile
    )
    la, lb = len_a[ti[:live].long()], len_b[tj[:live].long()]
    short, long_ = torch.minimum(la, lb), torch.maximum(la, lb)
    ops = int((short * torch.ceil(torch.log2(long_.double() + 1)).long()).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes,
        operations=ops,
        task_traffic_bytes=int(24 * live + 4 * int((la + lb).sum()) + 4 * ntile),
    )


def time_cold(fn, reps, flush):
    """Median ms of ``fn`` over ``reps`` launches, each after the L2 cache
    has been overwritten (a real count finds the step's rows cold)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def kernel_report(art, dev, launches):
    """Holds the kernel against its plain version on every device-step
    of the main path (all ``q * q`` logical devices at all ``q`` steps,
    exact equality per tile); times device (0, 0) at step 0."""
    from repro_torch.kernels.tc_fused import (
        fused_short_counts,
        fused_short_counts_plain,
    )

    q = art.plan.q
    compared, max_abs_err, unequal = 0, 0, []
    for step in range(q):
        for x in range(q):
            for y in range(q):
                args, tcount, tile, d = step_inputs(art, dev, x, y, step)
                got = fused_short_counts(*args, tcount, tile=tile, d=d)
                want = fused_short_counts_plain(*args, tcount, tile=tile, d=d)
                err = int((got.long() - want.long()).abs().max())
                max_abs_err = max(max_abs_err, err)
                if err or got.shape != want.shape:
                    unequal.append((x, y, step))
                compared += 1
                del want
    equal = not unequal

    args, tcount, tile, d = step_inputs(art, dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = time_cold(
        lambda: fused_short_counts(*args, tcount, tile=tile, d=d), 10, flush
    )
    plain_ms = time_cold(
        lambda: fused_short_counts_plain(*args, tcount, tile=tile, d=d), 2, flush
    )
    ntile = max(1, -(-int(args[4].shape[0]) // tile))
    rec = dict(
        name="tc_fused.fused_short_counts",
        route="cuda",
        source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES,
        launches=launches,
        max_abs_err=max_abs_err,
        equal=equal,
        compared_device_steps=compared,
        tolerance="exact (integer counts, per tile)",
        ms=ms,
        plain_ms=plain_ms,
        library_ms=None,
        library_note="no single PyTorch call computes a batched "
                     "sorted-set intersection over CSR rows",
        timed="logical device (0, 0), step 0",
        shape=dict(tasks=int(tcount), tmax=int(args[4].shape[0]), tile=tile,
                   d=d, ntile=ntile, nb=int(args[0].shape[0] - 1),
                   npad=int(args[1].shape[0])),
    )
    rec.update(kernel_bound(args, tcount, tile, d))
    rec["bound_share"] = rec["bound_ms"] / ms if ms > 0 else None
    if not equal:
        print(json.dumps({"kernels": [rec]}), flush=True)
        fail(f"fused kernel != plain version at the main path's shapes, "
             f"device-steps (x, y, step) {unequal}")
    return rec


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def profile_count(count):
    """Where a warm count's device time goes: one run of ``count`` under
    ``torch.profiler``; device time summed by kernel name.  Tracing slows
    the host down, so the busy share is taken against the run's own wall
    time and says so.  ``device_seconds`` of 0 means the profiler saw no
    device activity here, and nothing was measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        count()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [
        (ev.key, ev.self_device_time_total * 1e-6, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA
    ]
    kernels.sort(key=lambda kv: -kv[1])
    total = sum(t for _, t, _ in kernels)
    fused = sum(t for k, t, _ in kernels if "fused_short_counts_kernel" in k)
    return dict(
        profiled_wall_seconds=wall,
        device_seconds=total,
        device_launches=int(sum(n for _, _, n in kernels)),
        fused_kernel_seconds=fused,
        device_busy_share_of_profiled_wall=(total / wall) if wall > 0 else None,
        top=[dict(kernel=k[:80], seconds=t, launches=int(n))
             for k, t, n in kernels[:6]],
    )


def main_path(scale, edge_factor, seed, q, dev):
    import repro_torch as rt
    from repro_torch.kernels.tc_fused import tc_fused as kmod
    from repro_torch.pipeline import default_cache

    t0 = time.perf_counter()
    g = rt.rmat(scale, edge_factor, seed=seed)
    gen_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    kmod.reset_launch_count()
    r = rt.count_triangles(g, q=q, method="fused")
    launches = kmod.launch_count()
    peak = torch.cuda.max_memory_allocated()
    if launches <= 0:
        fail("the main path launched the fused kernel no time")

    hits0 = default_cache().hits
    r2 = rt.count_triangles(g, q=q, method="fused")
    cache_hit = bool(r2.artifact.cache_hit) and default_cache().hits > hits0
    if not cache_hit:
        fail("second count of the same graph missed the plan cache")

    prof = profile_count(lambda: rt.count_triangles(g, q=q, method="fused"))

    rs = rt.count_triangles(g, q=q, method="search", chunk=8192)
    rs2 = rt.count_triangles(g, q=q, method="search", chunk=8192)

    t0 = time.perf_counter()
    oracle = scipy_triangle_oracle(g.n, g.edges)
    oracle_s = time.perf_counter() - t0

    plan = r.plan
    sk = plan.step_keep
    cs = plan.compact
    info = dict(
        graph=f"rmat:{scale},{edge_factor},{seed}", n=g.n, m=g.m, q=q,
        logical_devices=q * q, device=r.device,
        triangles=r.triangles, triangles_repeat=r2.triangles,
        triangles_search=rs.triangles, triangles_scipy_oracle=oracle,
        generate_seconds=gen_s, oracle_seconds=oracle_s,
        preprocess_seconds=r.preprocess_seconds,
        count_seconds=r.count_seconds,
        warm_preprocess_seconds=r2.preprocess_seconds,
        warm_count_seconds=r2.count_seconds,
        search_preprocess_seconds=rs.preprocess_seconds,
        search_count_seconds=rs.count_seconds,
        search_warm_count_seconds=rs2.count_seconds,
        stage_seconds={k: float(v) for k, v in r.artifact.stage_seconds.items()},
        nb=plan.nb, tmax=plan.tmax, dmax=plan.dmax,
        d_small=plan.d_small, n_long=plan.n_long, chunk=plan.chunk,
        autotune=plan.autotune,
        schedule_steps=int(sk.size), skipped_steps=int(sk.size - sk.sum()),
        live_steps=None if cs is None else cs.n_live,
        kernel_launches=launches, cache_hit=cache_hit,
        peak_device_bytes=int(peak),
        warm_count_profile=prof,
    )
    ok = r.triangles == r2.triangles == rs.triangles == rs2.triangles == oracle
    emit("main_path", ok=ok, **info)
    if not ok:
        fail("main path counts disagree (fused / search / scipy oracle)")
    return r.artifact, launches


def small_graphs():
    import repro_torch as rt
    from repro_torch.core import erdos_renyi, graph_from_spec, triangle_count_oracle

    fixtures = {
        "karate": graph_from_spec("named:karate"),
        "cliques:3,60": graph_from_spec("cliques:3,60"),
        "star:64": graph_from_spec("star:64"),
        "edgeless": erdos_renyi(24, 0.0, seed=0),
        "rmat:9,8,42": graph_from_spec("rmat:9,8,42"),
    }
    rows, bad = [], []
    for name, g in fixtures.items():
        exp = triangle_count_oracle(g)
        for q in (1, 2, 3):
            for method in ("search", "global", "fused"):
                got = rt.count_triangles(g, q=q, method=method).triangles
                if got != exp:
                    bad.append((name, q, method, got, exp))
        rows.append(dict(graph=name, triangles=exp))
    emit("small_graphs", ok=not bad, checked=len(fixtures) * 9, graphs=rows,
         mismatches=bad)
    if bad:
        fail(f"small graphs disagree with the oracle: {bad}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="log2 of the main path's vertex count")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script only runs on a GPU", file=sys.stderr)
        sys.exit(2)

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, gpu=smi,
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())

    build_s = _build.build_all()
    emit("build", seconds=build_s, kernels=_build.kernel_names(),
         flags=" ".join(_build.NVCC_FLAGS), build_dir=str(_build.build_dir()))

    emit("traps", ok=True, checked=run_traps(dev))

    art, launches = main_path(args.scale, EDGE_FACTOR, args.seed, GRID, dev)
    kernels = [kernel_report(art, dev, launches)]
    small_graphs()

    emit("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
