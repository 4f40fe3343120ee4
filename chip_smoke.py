#!/usr/bin/env python3
"""Smoke-run the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # full size: rmat(20, 16) on Cannon q = 4,
                                       # SUMMA 2 x 8 and the ring p = 16; rmat(18, 16) tiles
    python3 chip_smoke.py --scale 16   # a quicker run (tile path at scale 14)

What it does, in order, printing one JSON object per line:

1. ``env``        — torch / CUDA versions, the card's name and power limit;
2. ``build``      — builds every CUDA kernel of the package from
                    ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one
                    process per source, started together) and reports each
                    kernel's registers, shared memory and spills as
                    ``nvcc -Xptxas -v`` gives them;
   ``hw``         — the card's memory and bf16 rates as measured
                    (``repro_torch.launch.roofline.measure_hw``: a 1 GiB
                    device-to-device copy, a bf16 8192³ matmul) beside
                    the data-sheet ``HW`` every bound here divides by;
3. ``traps``      — holds the fused kernel on the short bucket
                    (``fused_short_counts``) against its plain PyTorch
                    version on small inputs built to hit the edge cases
                    (exact equality, per tile);
   ``fused_traps`` — the fused kernel over both buckets
                    (``count_pair_fused``, one launch) against
                    ``count_pair_fused_plain`` and brute force on
                    ``fused_trap_cases`` (runs of equal ti across tile and
                    warp boundaries, rows past the staging limit, B rows
                    past ``dpad_long``, odd long buckets), both long-bucket
                    functions; the tests take the same cases;
4. ``main_path``  — ``repro_torch.count_triangles(rmat(scale, 16), q=4,
                    method="fused")`` on the GPU — one plan, one kernel
                    launch a device-step, no ``searchsorted`` in the warm
                    count's profile — checked against one count with
                    ``method="search"`` and against a scipy oracle that
                    shares no code with the package; then the same graph
                    again, which must hit the plan cache;
5. ``kernels``    — for each kernel: equality with the plain version on
                    every device-step the main path gave it, its time,
                    the plain version's time, the least time the card
                    could take (``bound_ms``: every input byte once) and
                    its launches during phase 4;
   ``dryrun_path`` — ``repro_torch.launch.dryrun``'s 18 triangle-count
                    cells (the paper's six graphs x Cannon, 2.5D, ring at
                    q = 16), Twitter's ``cannonopt`` / ``cannon2l`` and
                    four of its 70 model cells (qwen2-0.5b train_4k,
                    deepseek-v3 decode_32k, Equiformer-v2 molecule, DLRM
                    train_batch), each walked on meta tensors in this
                    process (a ``dryrun_cell`` line each, ``fits``
                    against this card's memory); the walk
                    of ``rmat(16, 16)``'s real plan (q = 4, ``search``,
                    chunk 8192) against the count on the card: its staged
                    bytes equal to the CUDA tensors', its peak within 10 %
                    below ``max_memory_allocated``; and the main graph's
                    analytic plan (``nnz_pad``, ``tmax``, ``dmax``) beside
                    its real one;
   ``substrate_path`` — 20 AdamW and 20 Adafactor steps, the int8
                    ``compressed_psum`` over 4 replicas, the segment ops,
                    ``spmm_edges`` and ``embedding_bag`` on the card, each
                    against the same call on the CPU;
   ``lm_path``    — the LM family's serving path (no hand-written kernel:
                    the JAX package has none there): the five ``-smoke``
                    configs in float32 and bfloat16, card against CPU
                    (hidden states, logits, the loss and its metrics,
                    eight decode steps' logits and caches, greedy tokens,
                    the router teacher-forced by the CPU's choices and its
                    own held to them but for ties); qwen2-0.5b at its
                    published widths in bfloat16 on the card (a 2,048-token
                    prefill, 8 prompts of 64 tokens prefilled and decoded
                    — every decode step against the forward pass at its
                    position, the first 16 against the same steps on the
                    CPU, and again with a planted mask fault that the CPU
                    check must catch —, 64 greedy
                    steps of ``serve``'s LM loop, a decode step's launches
                    from the profiler, prefill and decode times beside
                    their bounds, ``max_memory_allocated``) and in float32
                    card against CPU;
   ``lm_train_path`` — the LM family's training path (a phase of its own,
                    after ``lm_path``; no hand-written kernel either):
                    every ``-smoke`` config's ``build_lm_train_step`` in
                    float32 and bfloat16 (and with Adafactor where its full
                    config trains with it), 4 x 32 tokens in two
                    microbatches at step 2000, card against CPU (the loss,
                    ``grad_norm``, every optimiser state and parameter,
                    the router teacher-forced, remat's recompute included);
                    20 float32 steps of qwen2-0.5b-smoke card against CPU,
                    both curves falling; qwen2-0.5b at its published
                    widths and depth in bfloat16 (8 steps of 32 x 512 in
                    two microbatches of 16: losses that fall, step seconds,
                    tokens/s, one step's launches and busy share,
                    ``max_memory_allocated`` with remat and without, 6 N
                    tokens over the step against the bf16 rate; the dry
                    run's walk of that very step on meta, its peak at
                    most 10 % under the card's and its product FLOPs
                    equal to ``FlopCounterMode``'s count of a real step);
                    one
                    float32 full-width step card against CPU, and again
                    with a planted fault (the second microbatch's gradient
                    dropped) that the check must catch; ``train
                    --ckpt-dir`` on the card run to step 10, then resumed
                    to 20, against an uninterrupted run;
   ``lm_mesh_path`` — the LM family's steps on a device mesh (after
                    ``lm_train_path``; no hand-written kernel): a (2, 2)
                    ``("data", "model")`` mesh of four positions on
                    ``cuda:0``, every ``-smoke`` config's train step (8 x
                    24 tokens, two microbatches), prefill and 8 decode
                    steps in float32 and bfloat16 against the same steps
                    on one device (the router teacher-forced), each train
                    step's parameter and gradient bytes equal to their
                    closed form; two planted faults the check must catch
                    (the gradients' reduce-scatter over ``data`` skipped,
                    the decode combine without its rescale); qwen2-0.5b
                    at its published widths in bfloat16: two train steps
                    of 8 x 512 against one device, a 1 x 2,048 prefill's
                    token, 8 prompts x 16 decode steps (seconds, peaks,
                    collective bytes, prefill and decode launches); at
                    most 60 s;
   ``recsys_path`` — DLRM (no hand-written kernel either): the smoke
                    config card against CPU (one train step's loss,
                    ``grad_norm``, moments and parameters, the serve
                    step's probabilities, the retrieval step's top
                    values and indices), and the serve step again with
                    the interaction's pairs planted in another order,
                    which that check must catch; the published widths
                    with every table capped at 2^20 rows (7,206,400
                    rows, 3.69 GB): 8 train steps at 65,536 from
                    ``RecsysPipeline`` (step seconds, samples/s, one
                    step's launches and busy share, the peak, the loss
                    falling, the dry run's walk of the step at most 10 %
                    under the peak), serve latency at 512 (median and p99 of 50
                    calls) and throughput at 262,144, and one query's
                    retrieval over 1,000,000 rows of table 0, its top 100
                    against a float64 rescoring on the CPU;
   ``gnn_path``   — the GNNs (no hand-written kernel): every ``-smoke``
                    config's train step card against CPU, and NequIP's
                    again with its force term planted out of the loss,
                    which the check must catch; the reference's
                    equivariance tests on the card (scipy rotations);
                    Equiformer-v2 and NequIP at their published widths on
                    128 molecules of 30 atoms and 64 edges (padded to
                    4,096 atoms and 8,192 edges), GraphCast (16 x 512,
                    227 variables) and GAT-Cora (1,433 features) on
                    3,072 nodes and 10,752 edges: 4 train steps each
                    (seconds, launches, busy share, peak; Equiformer-v2's
                    peak against the dry run's walk, at most 10 % under);
                    and
                    ``repro_torch.examples.train_gnn`` on the card
                    (held-out accuracy over 0.7);
   ``pod_path``   — the main graph's cached plan counted with 2.5D pods
                    (``npods`` 2 with ``flat`` and ``tree``, 4 with
                    ``tree`` and ``auto``): pod-staging seconds, cold and
                    warm counts, one kernel launch a counted pod
                    device-step, staged and peak device bytes against the
                    single pod, each equal to the oracle; then the fused
                    kernel's ``"cannon_pods"`` row, held to its plain
                    route on device-steps of pods t >= 1 (the rolled
                    copies);
   ``search2``    — the main graph with ``method="search2"`` (cold and
                    warm, the bucketizer's ``bucket_stats``), and
                    ``method="auto"`` on ``rmat(scale - 4, 16)`` (what the
                    percentile report resolved it to), each equal to its
                    graph's oracle;
   ``runtime_path`` — the runtime on the main graph: ``tc_run --ckpt-dir``
                    in this process (Cannon q = 4, chunk 8192, the
                    checkpointed stepper) with a step fault and a
                    corrupted checkpoint, then resumed from its last
                    checkpoint (each save's
                    bytes and seconds); ``supervised_count`` with
                    transient faults at ``plan_stage``, ``device_stage``
                    and ``step@1`` (three restarts, one kernel launch a
                    counted device-step, the count's own peak device bytes
                    within 5 % of an unsupervised count's, both staging
                    the plan from nothing), with a persistent fault of the
                    fused factory (the ladder demotes to ``search2``) and
                    with 7 of the 16 logical devices lost (re-planned and
                    counted on Cannon 3 x 3); every count equal to the
                    oracle; then the fused kernel's ``"cannon_regrid"``
                    row, held to its plain route on every counted
                    device-step of the 3 x 3 plan;
   ``measured_path`` — ``method="auto"`` under ``autotune="measured"`` on
                    Cannon q = 4 (right after ``runtime_path``), SUMMA 2 x 8
                    and the ring p = 16 (each right after its
                    ``*_path``), the plans from the cache and the table in
                    a temporary directory: a table miss then a hit, the
                    entry (baseline and candidate seconds, winner,
                    roofline prediction), what ``auto`` resolved to, the
                    counts against the oracle, and the kernel against its
                    plain route at every candidate shape on the busiest
                    block (one JSON line after the ring);
   ``delta_path`` — a 4-round edge-delta stream on the main graph through
                    ``count_triangles_delta`` (Cannon q = 4, ``method=
                    "fused"``, ``rebase_every=3``; the base a plan-cache
                    hit): a 4-edit splice, a 4,096-edit repack, a 4-edit
                    splice, a rebase at depth 4; each round's level,
                    dirty blocks, replanned stages, inherited engine,
                    times and reused buffers, its kernel launches (one a
                    counted device-step) and its count against an
                    incremental scipy oracle sharing no code with the
                    package; then the replay of round 1 (a lineage-cache
                    hit), a profiled warm count of round 1's spliced plan
                    (no ``searchsorted``), and ``tc_run --stream
                    --verify`` on ``rmat:14`` in this process; then the
                    fused kernel's ``"cannon_delta"`` row, held to its
                    plain route on every device-step of round 1's spliced
                    plan that reads a dirty block;
   ``serve_path`` — the front ends: the main plan's warm fused count with
                    the shifted payload as separate arrays and as blobs
                    (the default), in turns, each profiled (rolls,
                    packing, kernel) with its peak and moved bytes;
                    ``serve --tc-stream`` on the main graph in memory
                    (Cannon q = 4, fused, 4 rounds of 4 flips, a step
                    fault at round 0 retried), each round against the
                    incremental oracle; ``serve --tc-graphs`` over
                    karate, rmat 12 and rmat 14 at 8 on a 2 x 2 grid with
                    ``--verify`` (rounds 1 and later warm); ``tc_run
                    --opt`` on ``rmat(18, 16)`` and ``tc_run --time-split``
                    on the three schedules at ``rmat(16, 16)`` (chunk 8192),
                    each against the scipy oracle (each result a line of
                    its own: ``serve_blob``, ``serve_stream``,
                    ``serve_batch``, ``tc_run_opt``, ``tc_run_time_split``);
                    then the fused kernel's ``"serve_stream"`` row, held
                    to its plain route on the last round's first counted
                    device-step;
   ``rebalance_path`` — the main graph with ``rebalance_trials=2``: the
                    rebalance report, one kernel launch a counted
                    device-step, warm counts of the plain and the
                    rebalanced plan in turns, each equal to the oracle;
   ``summa_path`` / ``oned_path`` — the main graph on the SUMMA schedule
                    (``grid=(2, 8)``) and on the 1D ring (p = 16) with
                    ``method="fused"``: cold (one kernel launch a counted
                    device-step), warm (a plan-cache hit, no
                    ``searchsorted`` in its profile) and on SUMMA each
                    broadcast strategy, all equal to the oracle; then each path's row of the fused kernel
                    (``"path"``), held to ``count_pair_fused_plain`` on
                    every device-step the path counted;
   ``hub_path``   — the main graph with ``hub_split=True`` on the ring
                    (p = 16) and on Cannon (q = 4), ``method="fused"``:
                    cold; on the ring also warm, ``method="search"``, the
                    hub partial and the residual schedule alone; all
                    equal to the oracle; then the fused
                    kernel's ``"oned_hub"`` row, held to its plain route
                    on every residual device-step;
   ``mesh_path``  — the main graph's cached fused plan on a device mesh
                    of 16 positions, position i on card i mod the cards
                    present (``count_triangles(g, mesh=make_grid_mesh(4,
                    devices=...))``): the count against the oracle, one
                    kernel launch a counted device-step, the per-position
                    partials against one device's, one device-step's
                    launch against its plain version on each card used,
                    warm counts on the mesh and on one device in turns,
                    the bytes each engine phase moved on both; then SUMMA
                    2 x 8, the ring p = 16 and 2 pods under ``tree`` on
                    meshes of their own, each against the oracle;
   ``mesh_runtime_path`` — the runtime on that mesh, the main fused plan
                    reused: ``supervised_count(g, mesh)`` with transient
                    faults (3 restarts) and with 7 positions lost at step
                    0 (Cannon 3 x 3 on the first 9 positions' cards; one
                    kernel launch a counted device-step, one device-step
                    a card against its plain version), ``tc_run --mesh
                    --ckpt-dir`` with faults and a resume (each save's
                    bytes and seconds), ``tc_run --mesh --time-split``
                    (Cannon and the ring at ``rmat(16, 16)``) and
                    ``--opt`` (``rmat(18, 16)``), and
                    ``distributed_degree_rank`` over the 16 positions
                    against ``degree_order``; every count against its
                    oracle;
6. ``small_graphs`` — a grid of small fixtures, q in {1, 2, 3}: Cannon
                    with every method (``search``, ``global``, ``fused``,
                    ``tile``, ``dense``, ``search2``, ``auto``), SUMMA and
                    the ring with ``search``, ``global``, ``fused``,
                    ``auto``, against the exact per-edge oracle;
   ``many_path``  — ``count_triangles_many`` over ``rmat(16..17, 16)`` and
                    two named graphs, ``method="search"``, Cannon q = 4 and
                    the ring p = 16 at chunk 8192:
                    cold, warm (a program-cache hit), equal to
                    ``count_triangles`` graph by graph and to the oracle;
7. ``tile_traps`` — both tile kernels (``popcount``, ``mxu``) against
                    their plain versions and the reference on small inputs
                    built to hit the edge cases (exact equality; the tests
                    take the same cases from ``tile_trap_cases``);
8. ``tile_path``  — ``count_triangles(rmat(min(TILE_SCALE, scale - 2), 16),
                    q=4, method="tile")`` cold, then warm (must hit the plan
                    cache), then the same artifact counted by
                    ``build_cannon_tile_fn(mode="mxu")``, then
                    ``method="search"`` and the scipy oracle: all equal;
                    then the two tile kernels' rows of the ``kernels`` line
                    (equality with the plain version on every device-step
                    the tile path ran, times, bounds, launches);
9. ``tile_density`` — both tile kernels on a synthetic device-step of the
                    tile path's size at mask densities 0.0003 to 0.5: each
                    equal to the plain version and timed, and where the
                    two kernels' times cross.

The ``total`` line gives the whole run's seconds and each phase's.
``--mesh-only`` runs the main path and then only ``mesh_path``,
``mesh_runtime_path`` and ``lm_mesh_path`` (a probe of the mesh phases on
the cards present; it prints neither the kernels line nor the final
line); with four cards ``lm_mesh_path`` puts one position on each, and
``lm_mesh_big`` trains chatglm3-6b at its published widths and depth on
them (the batch sized by the dry run's walk and ``shard_bytes``; three
steps' seconds and losses, each card's peak against the sizing).
Any mismatch, failed build or failed launch ends the run with a non-zero
exit.  Nothing here runs on the CPU in place of the GPU: without a CUDA
device the script exits non-zero before printing any result.  The last
line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.launch.roofline import HW  # noqa: E402

# the card's data-sheet rates (H100 SXM), one yardstick for every bound
HBM_BYTES_PER_S = HW["hbm_bw"]
FP32_OPS_PER_S = HW["fp32_ops"]
BF16_FLOPS_PER_S = HW["peak_flops"]
# H100 SXM: 132 SMs at up to 1,980 MHz; population count (__popc) runs at
# 16 results a clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, throughput table of the arithmetic instructions)
POPC_OPS_PER_S = 132 * 16 * 1.98e9
EDGE_FACTOR = 16  # Graph500's
GRID = 4  # q: 16 logical devices, 4 Cannon steps
# largest scale of the tile path: its host plan (pack + join) grows faster
# than the graph; PERF.md section 4 has the measured sizes
TILE_SCALE = 18
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/tc_fused.cu"
KERNEL_REPLACES = "src/repro/kernels/tc_fused/tc_fused.py:146"
TILE_SOURCE = "src/repro_torch/kernels/csrc/tc_tile.cu"
TILE_REPLACES = {  # the Pallas bodies behind tc_tile.py:114's pallas_call
    "popcount": "src/repro/kernels/tc_tile/tc_tile.py:53",
    "mxu": "src/repro/kernels/tc_tile/tc_tile.py:69",
}
TILE_BYTES = 128 * 4 * 4  # one packed 128x128-bit tile


def emit(tag, **fields):
    print(json.dumps({tag: fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ----------------------------------------------------------------------
# oracle independent of the package
# ----------------------------------------------------------------------
def scipy_triangle_oracle(n, edges, rows_per_block=1 << 12):
    """``sum((U @ U) ∘ U)`` over the degree-ordered upper-triangular
    adjacency ``U``, with scipy.sparse, in row blocks to bound memory.
    The blocks run on a thread each (scipy's product leaves the
    interpreter lock for much of its work); small blocks keep the threads
    busy, as the high-degree rows gather in the last ones."""
    from concurrent.futures import ThreadPoolExecutor

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
    def block(r0):
        ub = u[r0 : r0 + rows_per_block]
        return int((ub @ u).multiply(ub).sum())

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return sum(pool.map(block, range(0, n, rows_per_block)))


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


# ----------------------------------------------------------------------
# the fused kernel over both buckets: trap cases
# ----------------------------------------------------------------------
# run lengths of equal ti in the traps' task lists: one task, a warp's 32
# and a tile's 32 either side, and a run over many tiles
FUSED_RUNS = (1, 31, 32, 33, 1000, 1, 2, 3, 64, 5)


def _csr(rng, lens, window, hub_window):
    """CSR of rows with ``lens`` ids: short rows draw from ``[0, window)``,
    rows longer than ``window`` from ``[0, hub_window)``.  The ids are
    block-local (below the row count) as the row-encoded keys need; the
    array ends in 5 padding ids."""
    rows = [np.sort(rng.choice(window if k <= window else hub_window,
                               size=int(k), replace=False)) for k in lens]
    indptr = np.zeros(len(lens) + 1, np.int32)
    indptr[1:] = np.cumsum(lens)
    idx = np.concatenate(rows + [np.full(5, len(lens))]).astype(np.int32)
    return indptr, idx


# the ring-shaped trap's id space: global vertex ids below RING_N, padded
# with RING_N + 1 as the 1D planner pads them
RING_N = 1 << 20


def _ring_csr(rng, lens, pool, pad):
    """CSR of rows with ``lens`` global ids drawn from ``pool`` (sorted),
    ending in ``pad`` padding ids ``RING_N + 1``."""
    rows = [np.sort(rng.choice(pool, size=int(k), replace=False))
            for k in lens]
    indptr = np.zeros(len(lens) + 1, np.int32)
    indptr[1:] = np.cumsum(lens)
    idx = np.concatenate(rows + [np.full(pad, RING_N + 1)]).astype(np.int32)
    return indptr, idx


def fused_trap_cases(seed=0):
    """name -> dict(arrays=(ap, ai, bp, bi, ti, tj), n_long, d_small,
    dpad_long, chunk, tile, tcounts, sentinel, fallbacks) for
    ``count_pair_fused``: task lists in runs of equal ti of ``FUSED_RUNS``
    lengths, ordered by (ti, tj) and shuffled, at tiles 8, 32 and 256;
    rows of A and of B longer than the kernel's staging limit in both
    buckets; a B row longer than ``dpad_long`` in the long bucket, where
    the two long-bucket functions differ; a long bucket that is no
    multiple of the tile, and one that takes every task; and a step shaped
    as the 1D ring gives it (``ring_global_ids``: global ids up to 2**20
    padded with ``n + 1``, A and B with different row counts and pads,
    long rows of 511 / 512 / 513 / 700 ids, the padded search's function
    only — row-encoded keys do not hold global ids).  ``tcounts`` include
    one inside the long bucket; ``fallbacks`` are the long-bucket
    functions a case is checked under, ``sentinel`` the plain search's
    padding id.  ``tests/test_torch_fused.py`` takes its cases from
    here."""
    from repro_torch.kernels.tc_fused import STAGE_LIMIT, fused_split_sizes

    rng = np.random.default_rng(seed)
    out = {}

    def add(name, arrays, n_long, d_small, dpad_long, tile, chunk=4096,
            sentinel=None, fallbacks=("global", "search")):
        tmax = len(arrays[4])
        n_long_c, _ = fused_split_sizes(tmax, n_long, chunk)
        tcounts = sorted({0, 1, n_long_c // 2 + 1, n_long_c + 3, tmax}
                         & set(range(tmax + 1)))
        out[name] = dict(arrays=arrays, n_long=n_long, d_small=d_small,
                         dpad_long=dpad_long, chunk=chunk, tile=tile,
                         tcounts=tuple(tcounts), sentinel=sentinel,
                         fallbacks=fallbacks)

    nb = 1024
    ap, ai = _csr(rng, rng.integers(0, 49, nb), 256, nb)
    bp, bi = _csr(rng, rng.integers(0, 49, nb), 256, nb)
    rows = rng.choice(nb, len(FUSED_RUNS), replace=False)
    rows[3] = int(np.flatnonzero(np.diff(ap) == 0)[0])  # a run of an empty row
    ti = np.repeat(rows, FUSED_RUNS).astype(np.int32)
    tj = rng.integers(0, nb, ti.shape[0]).astype(np.int32)
    order = np.lexsort((tj, np.repeat(np.arange(len(FUSED_RUNS)), FUSED_RUNS)))
    ti, tj = ti[order], tj[order]
    runs = (ap, ai, bp, bi, ti, tj)
    add("runs_by_row", runs, 100, 24, 48, 32)
    perm = rng.permutation(ti.shape[0])
    add("runs_shuffled", (ap, ai, bp, bi, ti[perm], tj[perm]), 100, 24, 48, 32)
    add("runs_tile_256", runs, 300, 24, 48, 256)
    add("runs_tile_8_no_long", runs, 0, 24, 48, 8)

    lens_a, lens_b = rng.integers(0, 41, nb), rng.integers(0, 41, nb)
    lens_a[[3, 500]] = 700  # past the staging limit
    lens_b[4], lens_b[9] = 700, 900  # 900: past dpad_long too
    edge = (STAGE_LIMIT - 1, STAGE_LIMIT, STAGE_LIMIT + 1)
    lens_a[[40, 41, 42]] = edge  # either side of the limit
    lens_b[[50, 51, 52]] = edge
    ap, ai = _csr(rng, lens_a, 256, nb)
    bp, bi = _csr(rng, lens_b, 256, nb)
    pairs = [(3, 4), (3, 9), (500, 4), (500, 9), (3, 17), (21, 9), (21, 4),
             (40, 50), (41, 51), (42, 52), (42, 9), (41, 4), (40, 17)]
    ti = rng.integers(0, nb, 600).astype(np.int32)
    tj = rng.integers(0, nb, 600).astype(np.int32)
    for k, (i, j) in enumerate(pairs):  # in the long bucket and the short
        ti[k], tj[k] = i, j
        ti[300 + k], tj[300 + k] = i, j
    for lo, hi in ((0, 192), (192, 600)):  # ordered by ti within a bucket
        o = np.lexsort((tj[lo:hi], ti[lo:hi])) + lo
        ti[lo:hi], tj[lo:hi] = ti[o], tj[o]
    add("rows_past_stage_limit", (ap, ai, bp, bi, ti, tj), 150, 640, 800, 32)

    nb = 256
    ap, ai = _csr(rng, rng.integers(0, 61, nb), nb, nb)
    bp, bi = _csr(rng, rng.integers(0, 61, nb), nb, nb)
    ti = rng.integers(0, nb, 400).astype(np.int32)
    tj = rng.integers(0, nb, 400).astype(np.int32)
    # chunk 50: the long bucket is 150 tasks, no multiple of the tile
    add("b_past_dpad_long", (ap, ai, bp, bi, ti, tj), 120, 10, 20, 32,
        chunk=50)
    add("long_takes_all", (ap, ai, bp, bi, ti[:300], tj[:300]), 400, 10, 20,
        32)

    # the 1D ring: A is the device's own row block, B the block that
    # arrived, each with its own row count and pad; ids are global and
    # shared through a pool, so long rows overlap
    pool = np.sort(rng.choice(RING_N, 3000, replace=False))
    pool[-1] = RING_N - 1  # the largest global id
    hubs = (STAGE_LIMIT - 1, STAGE_LIMIT, STAGE_LIMIT + 1, 700)
    nb_a, nb_b = 640, 900
    lens_a, lens_b = rng.integers(0, 33, nb_a), rng.integers(0, 33, nb_b)
    lens_a[[5, 6, 7, 8]] = hubs
    lens_b[[10, 11, 12, 13]] = hubs
    ap, ai = _ring_csr(rng, lens_a, pool, 7)
    bp, bi = _ring_csr(rng, lens_b, pool, 19)
    # long bucket [0, 160): any rows; short bucket: rows of at most
    # d_small = 32 ids, as the maxfrag split leaves it
    ti = np.concatenate([rng.integers(0, nb_a, 160), rng.choice(
        np.flatnonzero(lens_a <= 32), 540)]).astype(np.int32)
    tj = np.concatenate([rng.integers(0, nb_b, 160), rng.choice(
        np.flatnonzero(lens_b <= 32), 540)]).astype(np.int32)
    k = 0
    for i in (5, 6, 7, 8):  # every hub pairing, in the long bucket
        for j in (10, 11, 12, 13, 20):
            ti[k], tj[k] = i, j
            k += 1
    for lo, hi in ((0, 160), (160, 700)):  # ordered by ti within a bucket
        o = np.lexsort((tj[lo:hi], ti[lo:hi])) + lo
        ti[lo:hi], tj[lo:hi] = ti[o], tj[o]
    add("ring_global_ids", (ap, ai, bp, bi, ti, tj), 160, 32, 700, 32,
        chunk=64, sentinel=RING_N + 1, fallbacks=("search",))
    return out


def fused_brute(case, long_fallback):
    """Per-task counts of ``count_pair_fused``'s function, from Python
    sets: long tasks A cut at ``dpad_long`` and B whole (``global``) or cut
    there (``search``), short tasks both cut at ``d``; ``(tmax,)``."""
    from repro_torch.kernels.tc_fused import fused_split_sizes

    ap, ai, bp, bi, ti, tj = case["arrays"]
    n_long_c, _ = fused_split_sizes(len(ti), case["n_long"], case["chunk"])
    d = max(1, min(case["d_small"], len(ai), len(bi)))
    dl = case["dpad_long"]
    per = np.zeros(len(ti), np.int64)
    for t, (i, j) in enumerate(zip(ti, tj)):
        if t < n_long_c:
            ca, cb = dl, (None if long_fallback == "global" else dl)
        else:
            ca, cb = d, d
        a = set(ai[ap[i]:ap[i + 1]][:ca].tolist())
        per[t] = len(a.intersection(bi[bp[j]:bp[j + 1]][:cb].tolist()))
    return per


def fused_case_kwargs(case, long_fallback):
    return dict(n_long=case["n_long"], d_small=case["d_small"],
                dpad_long=case["dpad_long"], chunk=case["chunk"],
                tile=case["tile"], long_fallback=long_fallback,
                sentinel=case["sentinel"])


def run_fused_traps(dev):
    """``count_pair_fused`` (the kernel, one launch) against
    ``count_pair_fused_plain`` and brute force on ``fused_trap_cases``, both
    long-bucket functions, every ``tcount``; and the launch's per-tile
    counts against ``fused_step_counts_plain``, and its short tiles against
    ``fused_short_counts_plain``."""
    from repro_torch.kernels.tc_fused import (
        count_pair_fused,
        count_pair_fused_plain,
        fused_short_counts_plain,
        fused_split_sizes,
        fused_step_counts,
        fused_step_counts_plain,
        fused_tile_for,
    )
    from repro_torch.kernels.tc_fused import tc_fused as kmod

    if kmod.stage_limit() != kmod.STAGE_LIMIT:
        fail(f"the kernel stages {kmod.stage_limit()} ids, the traps "
             f"assume {kmod.STAGE_LIMIT}")
    checked = 0
    for name, case in fused_trap_cases().items():
        t = [torch.from_numpy(a).to(dev) for a in case["arrays"]]
        tmax = t[4].shape[0]
        n_long_c, _ = fused_split_sizes(tmax, case["n_long"], case["chunk"])
        d = max(1, min(case["d_small"], t[1].shape[0], t[3].shape[0]))
        tile = case["tile"] or fused_tile_for(d)
        counts = {}
        for fb in case["fallbacks"]:
            per = fused_brute(case, fb)
            kw = fused_case_kwargs(case, fb)
            for tc in case["tcounts"]:
                before = kmod.launch_count()
                got = int(count_pair_fused(*t, tc, **kw))
                if kmod.launch_count() != before + 1:
                    fail(f"fused trap {name}: count_pair_fused made "
                         f"{kmod.launch_count() - before} launches, not 1")
                want = int(count_pair_fused_plain(*t, tc, **kw))
                brute = int(per[:tc].sum())
                if not got == want == brute:
                    fail(f"fused trap {name} {fb} tcount={tc}: kernel {got}, "
                         f"plain {want}, brute force {brute}")
                step_kw = dict(n_long=n_long_c, tile=tile,
                               d_long=case["dpad_long"],
                               long_b_whole=fb == "global", d_short=d)
                tiles = fused_step_counts(*t, tc, **step_kw)
                if not torch.equal(tiles, fused_step_counts_plain(
                        *t, tc, **step_kw)):
                    fail(f"fused trap {name} {fb} tcount={tc}: per-tile "
                         f"counts != fused_step_counts_plain")
                ntile_long = -(-n_long_c // tile)
                if n_long_c < tmax and not torch.equal(
                        tiles[ntile_long:], fused_short_counts_plain(
                            *t[:4], t[4][n_long_c:], t[5][n_long_c:],
                            max(tc - n_long_c, 0), tile=tile, d=d)):
                    fail(f"fused trap {name} {fb} tcount={tc}: short tiles "
                         f"!= fused_short_counts_plain")
                checked += 1
            counts[fb] = int(per.sum())
        if name == "b_past_dpad_long" and counts["global"] == counts["search"]:
            fail("fused trap b_past_dpad_long: the two long-bucket "
                 "functions agree, so the trap does not bite")
    return checked


def step_inputs(art, dev, x=0, y=0, step=0):
    """What logical device ``(x, y)`` hands ``count_pair_fused`` at Cannon
    step ``step`` of the planned main path: after ``step`` shifts the
    device holds block ``(x, y + step)`` of A and block ``(x + step, y)``
    of B.  Returns ``(args, tcount, kw, split)``: the tensors, the task
    count, ``count_pair_fused``'s keywords as the engine binds them, and
    the keywords of ``fused_step_counts`` (the one launch) with the short
    bucket's tile and cap."""
    from repro_torch.kernels.tc_fused import fused_split_sizes, fused_tile_for

    plan = art.plan
    st = art.staged(dev)
    q = plan.q
    ax, ay = x, (y + step) % q
    bx, by = (x + step) % q, y
    a_idx, b_idx = st["a_indices"][ax, ay], st["b_indices"][bx, by]
    args = (st["a_indptr"][ax, ay], a_idx, st["b_indptr"][bx, by], b_idx,
            st["m_ti"][x, y], st["m_tj"][x, y])
    kw = dict(n_long=plan.n_long, d_small=plan.d_small, dpad_long=plan.dmax,
              chunk=plan.chunk, long_fallback="global")
    n_long_c, _ = fused_split_sizes(plan.tmax, plan.n_long, plan.chunk)
    d = int(max(1, min(plan.d_small, a_idx.shape[0], b_idx.shape[0])))
    split = dict(n_long=n_long_c, tile=fused_tile_for(d), d_long=plan.dmax,
                 long_b_whole=True, d_short=d)
    return args, int(plan.m_cnt[x, y]), kw, split


def kernel_bound(args, tcount, split):
    """Least time the card could take for this call's data, both buckets.

    Bytes, each counted ONCE however many tasks name it: the two ids of
    every live task, the row pointers and the column ids of every distinct
    row a live task names (cut at the largest cap a task reads it at:
    ``d_long`` for A in the long bucket, nothing for B there when
    ``long_b_whole``, ``d_short`` in the short bucket), and the per-tile
    output, over the memory rate; against one compare per binary-search
    step (shorter fragment probed into the longer) over the 32-bit rate.

    ``task_traffic_bytes`` is another quantity and no bound: what the
    tasks read when every task's fragments are counted per task (24 B of
    ids and pointers and 4 B per column id).  Rows are shared between
    tasks, so most of it can be served from cache."""
    from repro_torch.kernels.tc_fused.tc_fused import fused_tiles

    a_ptr, _, b_ptr, _, ti, tj = args
    tmax = ti.shape[0]
    live = min(tcount, tmax)
    n_long = split["n_long"]
    big = 2**31 - 1
    pos = torch.arange(live, device=ti.device)
    is_long = pos < n_long
    cap_a = torch.where(is_long, split["d_long"], split["d_short"])
    cap_b = torch.where(is_long, big if split["long_b_whole"]
                        else split["d_long"], split["d_short"])
    rows_a, rows_b = ti[:live].long(), tj[:live].long()
    full_a = (a_ptr[1:] - a_ptr[:-1]).long()
    full_b = (b_ptr[1:] - b_ptr[:-1]).long()
    la = torch.minimum(full_a[rows_a], cap_a)
    lb = torch.minimum(full_b[rows_b], cap_b)

    def distinct(rows, lens, n):
        longest = torch.zeros(n, dtype=torch.int64, device=rows.device)
        longest.scatter_reduce_(0, rows, lens, reduce="amax")
        used = torch.zeros(n, dtype=torch.bool, device=rows.device)
        used[rows] = True
        return int(used.sum()), int(longest.sum())

    na, ids_a = distinct(rows_a, la, full_a.shape[0])
    nb_, ids_b = distinct(rows_b, lb, full_b.shape[0])
    ntile = fused_tiles(tmax, n_long, split["tile"])[1]
    nbytes = int(8 * live + 4 * (na + 1) + 4 * ids_a + 4 * (nb_ + 1)
                 + 4 * ids_b + 4 * ntile)
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
    """Holds the kernel against its plain route on every device-step of
    the main path (all ``q * q`` logical devices at all ``q`` steps): the
    whole step's count equal to ``count_pair_fused_plain``'s, and the one
    launch's short-bucket tiles equal to ``fused_short_counts_plain``'s.
    Times device (0, 0) at step 0, both buckets."""
    from repro_torch.kernels.tc_fused import (
        count_pair_fused,
        count_pair_fused_plain,
        fused_short_counts,
        fused_short_counts_plain,
        fused_step_counts,
    )

    q = art.plan.q
    compared, max_abs_err, unequal = 0, 0, []
    t0 = time.perf_counter()
    for step in range(q):
        for x in range(q):
            for y in range(q):
                args, tcount, kw, split = step_inputs(art, dev, x, y, step)
                got = int(count_pair_fused(*args, tcount, **kw))
                want = int(count_pair_fused_plain(*args, tcount, **kw))
                n_long = split["n_long"]
                tiles = fused_step_counts(*args, tcount, **split)
                short_want = fused_short_counts_plain(
                    *args[:4], args[4][n_long:], args[5][n_long:],
                    max(tcount - n_long, 0), tile=split["tile"],
                    d=split["d_short"])
                short_got = tiles[-short_want.shape[0]:]
                err = max(abs(got - want), int(
                    (short_got.long() - short_want.long()).abs().max()))
                max_abs_err = max(max_abs_err, err)
                if err:
                    unequal.append((x, y, step))
                compared += 1
                del short_want, tiles
    compare_s = time.perf_counter() - t0
    equal = not unequal

    args, tcount, kw, split = step_inputs(art, dev)
    n_long = split["n_long"]
    short_args = (*args[:4], args[4][n_long:], args[5][n_long:])
    short_tasks = max(tcount - n_long, 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = time_cold(lambda: fused_step_counts(*args, tcount, **split), 10, flush)
    short_ms = time_cold(
        lambda: fused_short_counts(*short_args, short_tasks,
                                   tile=split["tile"], d=split["d_short"]),
        10, flush)
    plain_ms = time_cold(
        lambda: count_pair_fused_plain(*args, tcount, **kw), 2, flush)
    rec = dict(
        name="tc_fused.fused_step_counts",
        route="cuda",
        source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES,
        also_replaces="src/repro/kernels/tc_fused/ops.py:126 (the lax long "
                      "bucket)",
        launches=launches,
        max_abs_err=max_abs_err,
        equal=equal,
        compared_device_steps=compared,
        compare_seconds=compare_s,
        tolerance="exact (integer counts: the whole step, and per tile "
                  "on the short bucket)",
        ms=ms,
        short_bucket_ms=short_ms,
        short_bucket_note="the same kernel on the short bucket alone "
                          "(fused_short_counts): the work of the TPU "
                          "kernel it replaces",
        plain_ms=plain_ms,
        plain_note="count_pair_fused_plain: count_pair_search_global on "
                   "the long bucket, fused_short_counts_plain on the short",
        library_ms=None,
        library_note="no single PyTorch call computes a batched "
                     "sorted-set intersection over CSR rows",
        timed="logical device (0, 0), step 0, both buckets, cold L2, "
              "median of 10 (plain: of 2)",
        shape=dict(tasks=int(tcount), long_tasks=min(int(tcount), n_long),
                   short_tasks=short_tasks, tmax=int(args[4].shape[0]),
                   n_long_c=n_long, tile=split["tile"], d_short=split["d_short"],
                   d_long=split["d_long"], nb=int(args[0].shape[0] - 1),
                   npad=int(args[1].shape[0])),
    )
    rec.update(kernel_bound(args, tcount, split))
    rec["bound_share"] = rec["bound_ms"] / ms if ms > 0 else None
    if not equal:
        print(json.dumps({"kernels": [rec]}), flush=True)
        fail(f"fused kernel != plain route at the main path's shapes, "
             f"device-steps (x, y, step) {unequal}")
    return rec


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def profile_count(count, expect, kernel="fused_counts_kernel",
                  label="fused", spans=(), cpu=True):
    """Where a warm count's device time goes: ``count`` under
    ``torch.profiler``, once as the profiler's warm-up cycle and once
    recorded; device time summed by kernel name, and that of the kernels
    whose name holds ``kernel`` as ``<label>_kernel_seconds``.  ``complete``
    says whether the profiler saw all ``expect`` launches of that kernel
    the count made.  Tracing slows the host down, so the busy share is
    taken against the recorded run's own wall time and says so.
    ``device_seconds`` of 0 means the profiler saw no device activity
    here, and nothing was measured.  ``spans`` names more kernels (by a
    substring of their names) whose device seconds and launches are
    summed under ``spans``.  ``cpu=False`` records the device activity
    only (a train step's host ops are many, and tracing them costs
    seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            count()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    events = prof.key_averages()
    kernels = [  # the step's own annotation spans the whole step: no kernel
        (ev.key, ev.self_device_time_total * 1e-6, ev.count)
        for ev in events
        if ev.device_type == DeviceType.CUDA
        and not ev.key.startswith("ProfilerStep")
    ]
    kernels.sort(key=lambda kv: -kv[1])
    total = sum(t for _, t, _ in kernels)
    searchsorted = int(sum(n for k, _, n in kernels
                           if "searchsorted" in k.lower()))
    mine = sum(t for k, t, _ in kernels if kernel in k)
    seen = int(sum(n for k, _, n in kernels if kernel in k))
    return {
        "profiled_wall_seconds": wall,
        "device_seconds": total,
        "device_launches": int(sum(n for _, _, n in kernels)),
        "searchsorted_launches": searchsorted,
        f"{label}_kernel_seconds": mine,
        f"{label}_kernel_launches_seen": seen,
        f"{label}_kernel_launches_expected": int(expect),
        "complete": seen == expect,
        "device_busy_share_of_profiled_wall": (total / wall) if wall > 0 else None,
        "top": [dict(kernel=k[:80], seconds=t, launches=int(n))
                for k, t, n in kernels[:6]],
        "spans": {
            name: dict(seconds=sum(t for k, t, _ in kernels if name in k),
                       launches=int(sum(n for k, _, n in kernels
                                        if name in k)))
            for name in spans},
    }


def main_path(scale, edge_factor, seed, q, dev):
    import repro_torch as rt
    from repro_torch.kernels.tc_fused import tc_fused as kmod
    from repro_torch.pipeline import default_cache

    t0 = time.perf_counter()
    g = rt.rmat(scale, edge_factor, seed=seed)
    gen_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    entries0 = len(default_cache())
    kmod.reset_launch_count()
    r = rt.count_triangles(g, q=q, method="fused")
    launches = kmod.launch_count()
    peak = torch.cuda.max_memory_allocated()
    entries_added = len(default_cache()) - entries0
    plan = r.plan
    keep = plan.step_keep
    expect = sum(1 for s in range(q) for x in range(q) for y in range(q)
                 if plan.m_cnt[x, y] > 0 and (keep is None or keep[x, y, s]))
    if launches <= 0:
        fail("the main path launched the fused kernel no time")
    if launches != expect:
        fail(f"the fused count launched its kernel {launches} times, not "
             f"once for each of the {expect} device-steps that count")
    if getattr(plan, "b_aug", None) is not None:
        fail("method='fused' planned with row-encoded keys it does not read")

    hits0 = default_cache().hits
    r2 = rt.count_triangles(g, q=q, method="fused")
    cache_hit = bool(r2.artifact.cache_hit) and default_cache().hits > hits0
    if not cache_hit:
        fail("second count of the same graph missed the plan cache")

    prof = profile_count(lambda: rt.count_triangles(g, q=q, method="fused"),
                         launches)
    if prof["searchsorted_launches"]:
        fail(f"the warm fused count ran {prof['searchsorted_launches']} "
             "searchsorted launches: the long bucket left the kernel")

    rs = rt.count_triangles(g, q=q, method="search", chunk=8192)

    t0 = time.perf_counter()
    oracle = scipy_triangle_oracle(g.n, g.edges)
    oracle_s = time.perf_counter() - t0

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
        stage_seconds={k: float(v) for k, v in r.artifact.stage_seconds.items()},
        nb=plan.nb, tmax=plan.tmax, dmax=plan.dmax,
        d_small=plan.d_small, n_long=plan.n_long, chunk=plan.chunk,
        autotune=plan.autotune,
        schedule_steps=int(sk.size), skipped_steps=int(sk.size - sk.sum()),
        live_steps=None if cs is None else cs.n_live,
        kernel_launches=launches, device_steps_counted=expect,
        plan_cache_entries_added=entries_added,
        warm_device_launches=prof["device_launches"], cache_hit=cache_hit,
        peak_device_bytes=int(peak),
        warm_count_profile=prof,
    )
    ok = r.triangles == r2.triangles == rs.triangles == oracle
    emit("main_path", ok=ok, **info)
    if not ok:
        fail("main path counts disagree (fused / search / scipy oracle)")
    return r.artifact, launches, g, oracle


# ----------------------------------------------------------------------
# search2 / auto, and the SUMMA and 1D-ring schedules on the main graph
# ----------------------------------------------------------------------
SUMMA_GRID = (2, 8)  # 16 logical devices, 8 broadcast rounds


AUTO_SCALE_CUT = 4  # the percentile auto count runs four scales down


def search2_phase(g, oracle, q, scale, seed):
    """``method="search2"`` (bucketized plan, staged keys; cold, then
    warm) on the main path's graph, and ``method="auto"`` (resolved from
    the percentile autotune report; cold only) on ``rmat(scale - 4, 16)``:
    there, as on the main graph, it resolves to ``search`` at the
    autotuned chunk, which takes tens of seconds a count at the main
    scale (the measured mode's ``auto`` runs at full width in
    ``measured_path``).  Each equal to its graph's oracle."""
    import repro_torch as rt

    small = rt.rmat(scale - AUTO_SCALE_CUT, EDGE_FACTOR, seed=seed)
    t0 = time.perf_counter()
    small_oracle = scipy_triangle_oracle(small.n, small.edges)
    small_oracle_s = time.perf_counter() - t0
    rows, bad = {}, []
    for method, graph, want in (("search2", g, oracle),
                                ("auto", small, small_oracle)):
        r = rt.count_triangles(graph, q=q, method=method, chunk=8192)
        r2 = (rt.count_triangles(g, q=q, method=method, chunk=8192)
              if method == "search2" else r)
        plan = r.plan
        rows[method] = dict(
            graph=f"rmat:{scale - (method == 'auto') * AUTO_SCALE_CUT},"
                  f"{EDGE_FACTOR},{seed}",
            resolved=r.method, triangles=r.triangles,
            triangles_scipy_oracle=want,
            triangles_repeat=r2.triangles, cache_hit=bool(
                r2 is not r and r2.artifact.cache_hit),
            preprocess_seconds=r.preprocess_seconds,
            count_seconds=r.count_seconds,
            warm_count_seconds=r2.count_seconds if r2 is not r else None,
            stage_seconds={k: float(v)
                           for k, v in r.artifact.stage_seconds.items()},
            n_long=plan.n_long, d_small=plan.d_small, dmax=plan.dmax,
            chunk=plan.chunk, bucket_stats=plan.bucket_stats,
            autotune=plan.autotune,
        )
        if not r.triangles == r2.triangles == want:
            bad.append((method, r.triangles, r2.triangles))
    rows["auto"]["oracle_seconds"] = small_oracle_s
    emit("search2", ok=not bad, q=q, mismatches=bad, **rows)
    if bad:
        fail(f"search2 / auto disagree with the oracle: {bad}")


def schedule_device_steps(plan, kind):
    """``(device index, step)`` of every device-step the engine counts on
    a Cannon (``(x, y)``, step), SUMMA (``(x, y)``, round) or ring
    (``(d,)``, step) plan: the mask keeps it and the device has tasks that
    step."""
    if kind in ("cannon", "summa"):
        grid = (plan.q, plan.q) if kind == "cannon" else (plan.r, plan.c)
        nsteps = grid[1]

        def tasks(idx, s):
            return int(plan.m_cnt[idx])
    else:
        grid, nsteps = (plan.p,), plan.p

        def tasks(idx, s):
            return int(plan.t_cnt[idx[0], (idx[0] + s) % plan.p])
    keep = plan.step_keep
    return [(idx, s) for s in range(nsteps) for idx in np.ndindex(*grid)
            if tasks(idx, s) > 0 and (keep is None or keep[idx + (s,)])]


def schedule_step_inputs(art, dev, kind, idx, step):
    """What a device hands ``count_pair_fused`` at a step of a SUMMA or
    ring plan, as the engine binds it: SUMMA device ``(x, y)`` in round
    ``z`` counts A panel ``(x, z % c)`` and B panel ``b[z % r, y, z // r]``
    (block-local ids, the row-encoded keys' long bucket); ring device
    ``d`` at step ``t`` counts its own block against owner ``(d + t) % p``'s
    with that owner's task group (global ids, the padded search's long
    bucket).  A Cannon device ``(x, y)`` is ``step_inputs``'.  Returns
    ``(args, tcount, kw, split)`` as ``step_inputs``."""
    from repro_torch.kernels.tc_fused import fused_split_sizes, fused_tile_for

    if kind == "cannon":
        return step_inputs(art, dev, *idx, step)
    plan = art.plan
    st = art.staged(dev)
    if kind == "summa":
        x, y = idx
        ac, br, slot = step % plan.c, step % plan.r, step // plan.r
        args = (st["a_indptr"][x, ac], st["a_indices"][x, ac],
                st["b_indptr"][br, y, slot], st["b_indices"][br, y, slot],
                st["m_ti"][x, y], st["m_tj"][x, y])
        tcount, fb, sentinel = int(plan.m_cnt[x, y]), "global", plan.nb_c + 1
    else:
        (d,) = idx
        o = (d + step) % plan.p
        args = (st["indptr"][d], st["indices"][d], st["indptr"][o],
                st["indices"][o], st["t_i"][d, o], st["t_j"][d, o])
        tcount, fb, sentinel = int(plan.t_cnt[d, o]), "search", plan.n + 1
    kw = dict(n_long=plan.n_long, d_small=plan.d_small, dpad_long=plan.dmax,
              chunk=plan.chunk, long_fallback=fb, sentinel=sentinel)
    n_long_c, _ = fused_split_sizes(args[4].shape[0], plan.n_long, plan.chunk)
    d = int(max(1, min(plan.d_small, args[1].shape[0], args[3].shape[0])))
    split = dict(n_long=n_long_c, tile=fused_tile_for(d), d_long=plan.dmax,
                 long_b_whole=fb == "global", d_short=d)
    return args, tcount, kw, split


def tasks_past_stage_limit(plan, kind):
    """Tasks of the counted device-steps whose A or B row is longer than
    the kernel's staging limit (searched in global memory), and the
    longest row a task names."""
    from repro_torch.kernels.tc_fused import STAGE_LIMIT

    past, longest = 0, 0
    if kind in ("cannon", "summa"):
        la_all = np.diff(plan.a_indptr.astype(np.int64), axis=-1)
        lb_all = np.diff(plan.b_indptr.astype(np.int64), axis=-1)
    else:
        lens = np.diff(plan.indptr.astype(np.int64), axis=-1)
    for idx, s in schedule_device_steps(plan, kind):
        if kind == "cannon":  # after s shifts: A block (x, y+s), B (x+s, y)
            x, y = idx
            q = plan.q
            cnt = int(plan.m_cnt[x, y])
            la = la_all[x, (y + s) % q][plan.m_ti[x, y, :cnt]]
            lb = lb_all[(x + s) % q, y][plan.m_tj[x, y, :cnt]]
        elif kind == "summa":
            x, y = idx
            cnt = int(plan.m_cnt[x, y])
            la = la_all[x, s % plan.c][plan.m_ti[x, y, :cnt]]
            lb = lb_all[s % plan.r, y, s // plan.r][plan.m_tj[x, y, :cnt]]
        else:
            (d,) = idx
            o = (d + s) % plan.p
            cnt = int(plan.t_cnt[d, o])
            la = lens[d][plan.t_i[d, o, :cnt]]
            lb = lens[o][plan.t_j[d, o, :cnt]]
        big = np.maximum(la, lb)
        past += int((big > STAGE_LIMIT).sum())
        longest = max(longest, int(big.max(initial=0)))
    return past, longest


def schedule_path(kind, g, oracle, dev, grid, graph):
    """``count_triangles(g, grid=grid, schedule=kind, method="fused")``
    cold (one kernel launch a counted device-step), warm (a plan-cache
    hit, profiled: no ``searchsorted``), then — on SUMMA — each broadcast
    strategy by name: all equal to the main path's oracle.  (The plain
    search on these schedules is checked by ``small_graphs``; at the main
    scale it took 24–25 s on SUMMA and 10 s on the ring, a cold plan each,
    and was cut for the runtime phase.)"""
    import repro_torch as rt
    from repro_torch.kernels.tc_fused import tc_fused as kmod
    from repro_torch.pipeline import default_cache

    def count(**kw):
        return rt.count_triangles(g, grid=grid, schedule=kind, **kw)

    torch.cuda.reset_peak_memory_stats()
    kmod.reset_launch_count()
    r = count(method="fused")
    launches = kmod.launch_count()
    peak = torch.cuda.max_memory_allocated()
    plan = r.plan
    steps = schedule_device_steps(plan, kind)
    if launches <= 0:
        fail(f"the {kind} path launched the fused kernel no time")
    if launches != len(steps):
        fail(f"the {kind} fused count launched its kernel {launches} times, "
             f"not once for each of the {len(steps)} device-steps that count")

    hits0 = default_cache().hits
    r2 = count(method="fused")
    cache_hit = (r2.artifact is r.artifact and bool(r2.artifact.cache_hit)
                 and default_cache().hits > hits0)
    if not cache_hit:
        fail(f"second {kind} count of the same graph missed the plan cache")
    prof = profile_count(lambda: count(method="fused"), launches)
    if prof["searchsorted_launches"]:
        fail(f"the warm {kind} fused count ran "
             f"{prof['searchsorted_launches']} searchsorted launches")

    others = {}
    if kind == "summa":
        for b in ("onehot", "chain"):
            others[f"fused_broadcast_{b}"] = count(method="fused",
                                                   broadcast=b).triangles
    past, longest = tasks_past_stage_limit(plan, kind)
    sk = plan.step_keep
    cs = plan.compact
    info = dict(
        graph=graph, schedule=kind, grid=list(r.grid), device=r.device,
        logical_devices=int(np.prod(r.grid)),
        triangles=r.triangles, triangles_repeat=r2.triangles,
        triangles_other=others, triangles_scipy_oracle=oracle,
        preprocess_seconds=r.preprocess_seconds,
        stage_seconds={k: float(v) for k, v in r.artifact.stage_seconds.items()},
        count_seconds=r.count_seconds,
        warm_preprocess_seconds=r2.preprocess_seconds,
        warm_count_seconds=r2.count_seconds,
        dmax=plan.dmax, d_small=plan.d_small, n_long=plan.n_long,
        chunk=plan.chunk, autotune=plan.autotune,
        schedule_steps=int(sk.size), skipped_steps=int(sk.size - sk.sum()),
        live_steps=None if cs is None else cs.n_live,
        kernel_launches=launches, device_steps_counted=len(steps),
        tasks_past_stage_limit=past, longest_task_row=longest,
        warm_device_launches=prof["device_launches"], cache_hit=cache_hit,
        peak_device_bytes=int(peak), warm_count_profile=prof,
    )
    if kind == "summa":
        info.update(nb_r=plan.nb_r, nb_c=plan.nb_c, npan=plan.npan,
                    tmax=plan.tmax, broadcast=plan.broadcast)
    else:
        info.update(nb=plan.nb, gmax=plan.gmax, nnz_pad=plan.nnz_pad)
    ok = (r.triangles == r2.triangles == oracle
          and all(v == oracle for v in others.values()))
    emit(f"{kind}_path", ok=ok, **info)
    if not ok:
        fail(f"{kind} path counts disagree (fused / broadcasts / scipy "
             "oracle)")
    return r.artifact, launches, steps


def schedule_kernel_report(kind, art, dev, launches, steps, path=None):
    """The fused kernel's row for a schedule: the whole step's count equal
    to ``count_pair_fused_plain``'s on every device-step the path counted;
    timed cold-L2 at the first device's first counted step.  ``path``
    names the row (default: the schedule)."""
    from repro_torch.kernels.tc_fused import (
        count_pair_fused,
        count_pair_fused_plain,
        fused_step_counts,
    )

    compared, max_abs_err, unequal = 0, 0, []
    t0 = time.perf_counter()
    for idx, s in steps:
        args, tcount, kw, _ = schedule_step_inputs(art, dev, kind, idx, s)
        got = int(count_pair_fused(*args, tcount, **kw))
        want = int(count_pair_fused_plain(*args, tcount, **kw))
        max_abs_err = max(max_abs_err, abs(got - want))
        if got != want:
            unequal.append((idx, s))
        compared += 1
    compare_s = time.perf_counter() - t0

    idx, s = steps[0]  # steps run step by step: the first device's first
    args, tcount, kw, split = schedule_step_inputs(art, dev, kind, idx, s)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = time_cold(lambda: fused_step_counts(*args, tcount, **split), 10,
                   flush)
    plain_ms = time_cold(lambda: count_pair_fused_plain(*args, tcount, **kw),
                         2, flush)
    rec = dict(
        name="tc_fused.fused_step_counts",
        path=path or kind,
        route="cuda",
        source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES,
        also_replaces="src/repro/kernels/tc_fused/ops.py:126 (the lax long "
                      "bucket)",
        launches=launches,
        max_abs_err=max_abs_err,
        equal=not unequal,
        compared_device_steps=compared,
        compare_seconds=compare_s,
        tolerance="exact (integer counts, the whole step)",
        ms=ms,
        plain_ms=plain_ms,
        plain_note="count_pair_fused_plain: count_pair_search_global "
                   "(cannon, summa) / count_pair_search (oned) on the long "
                   "bucket, fused_short_counts_plain on the short",
        library_ms=None,
        library_note="no single PyTorch call computes a batched "
                     "sorted-set intersection over CSR rows",
        timed=f"logical device {tuple(idx)}, step {s}, both buckets, cold "
              "L2, median of 10 (plain: of 2)",
        shape=dict(tasks=int(tcount), tmax=int(args[4].shape[0]),
                   n_long_c=split["n_long"], tile=split["tile"],
                   d_short=split["d_short"], d_long=split["d_long"],
                   long_b_whole=split["long_b_whole"],
                   nb_a=int(args[0].shape[0] - 1),
                   nb_b=int(args[2].shape[0] - 1),
                   npad_a=int(args[1].shape[0]),
                   npad_b=int(args[3].shape[0])),
    )
    rec.update(kernel_bound(args, tcount, split))
    rec["bound_share"] = rec["bound_ms"] / ms if ms > 0 else None
    if unequal:
        print(json.dumps({"kernels": [rec]}), flush=True)
        fail(f"fused kernel != plain route on the {path or kind} path at "
             f"device-steps {unequal[:20]}")
    return rec


# ----------------------------------------------------------------------
# 2.5D pods and the measured autotune table on the card
# ----------------------------------------------------------------------
# (npods, reduce_strategy) of each pod count on the main graph
POD_RUNS = ((2, "flat"), (2, "tree"), (4, "tree"), (4, "auto"))
POD_COMPARE = 8  # device-steps of pods t >= 1 held to the plain route a count


def pod_device_steps(plan, npods):
    """``(t, x, y, s)`` of every device-step a pod count launches: pod
    ``t``'s loop step ``s`` is global step ``t + s * npods``, where the
    mask is read, and its tasks are ``(x, y)``'s."""
    q, keep = plan.q, plan.step_keep
    return [(t, x, y, s) for s in range(q // npods) for t in range(npods)
            for x in range(q) for y in range(q)
            if plan.m_cnt[x, y] > 0
            and (keep is None or keep[x, y, t + s * npods])]


def pod_step_inputs(art, staged, dev, npods, t, x, y, s):
    """What device ``(x, y)`` of pod ``t`` hands ``count_pair_fused`` at
    its loop step ``s``: the pod's rolled copies after ``s * npods``
    shifts (A block ``(x, y + s * npods)`` and B block ``(x + s * npods,
    y)`` of pod ``t``'s stack) and the task list of ``(x, y)``.  Returns
    ``step_inputs``' tuple and whether the operands equal the single-pod
    blocks at global step ``t + s * npods``."""
    plan = art.plan
    q = plan.q
    k = s * npods
    a_ptr = staged["a_indptr"][t, x, (y + k) % q]
    a_idx = staged["a_indices"][t, x, (y + k) % q]
    b_ptr = staged["b_indptr"][t, (x + k) % q, y]
    b_idx = staged["b_indices"][t, (x + k) % q, y]
    args, tcount, kw, split = step_inputs(art, dev, x, y, t + k)
    rolled_equal = all(torch.equal(u, v) for u, v in
                       zip((a_ptr, a_idx, b_ptr, b_idx), args[:4]))
    return ((a_ptr, a_idx, b_ptr, b_idx, staged["m_ti"][x, y],
             staged["m_tj"][x, y]), tcount, kw, split), rolled_equal


def staged_bytes(staged, shared=None):
    """Device bytes of staged tensors by group: the A/B operands, the task
    lists and the rest; tensors that are ``shared``'s own are not
    counted (a pod count reuses the single-pod task lists)."""
    groups = {"ab": 0, "tasks": 0, "other": 0}
    for k, v in staged.items():
        if shared is not None and shared.get(k) is v:
            continue
        g = ("ab" if k.startswith(("a_", "b_")) else
             "tasks" if k in ("m_ti", "m_tj") else "other")
        groups[g] += v.numel() * v.element_size()
    return groups


def peak_of(fn):
    """``fn()``, its own peak device bytes above what was allocated
    before it, and the bytes it left allocated (what it staged)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return (out, int(torch.cuda.max_memory_allocated() - base),
            int(torch.cuda.memory_allocated() - base))


def pod_path(g, oracle, dev, q):
    """``count_triangles(g, q=q, npods=..., method="fused",
    reduce_strategy=...)`` on the main path's cached plan for each of
    ``POD_RUNS``: pod-staging seconds, cold and warm ``count_seconds``,
    one kernel launch a counted pod device-step (q³ less the skipped),
    the staged bytes by group, the count's own peak device bytes and the
    bytes it left allocated, against the single-pod count; and the whole
    device footprint of one count of the raw plan (nothing memoised) at
    one pod and at each pod count.  Every count equals the oracle.
    Returns the
    fused kernel's ``"cannon_pods"`` row, held to its plain route on
    ``POD_COMPARE`` device-steps of pods t >= 1 per pod count, whose
    operands are the rolled copies."""
    import repro_torch as rt
    from repro_torch.kernels.tc_fused import (
        count_pair_fused,
        count_pair_fused_plain,
        fused_step_counts,
    )
    from repro_torch.kernels.tc_fused import tc_fused as kmod

    one, one_peak, _ = peak_of(lambda: rt.count_triangles(g, q=q,
                                                          method="fused"))
    art = one.artifact
    if not art.cache_hit:
        fail("the pod path missed the main path's cached plan")
    single = art.staged(dev)
    # the whole device footprint of one count at each pod count, on the
    # raw plan (nothing memoised: all it stages is freed after it)
    footprint = {}
    for npods in sorted({1} | {n for n, _ in POD_RUNS}):
        r, peak, kept = peak_of(lambda: rt.count_triangles(
            g, q=q, npods=npods, method="fused", plan=art.plan))
        if r.triangles != oracle:
            fail(f"the {npods}-pod count of the raw plan gave {r.triangles}, "
                 f"not {oracle}")
        footprint[str(npods)] = dict(peak_device_bytes=peak,
                                     left_allocated_bytes=kept)
    rows, bad, launches_all, seen = [], [], 0, set()
    compared, max_abs_err, unequal, not_rolled, timed = 0, 0, [], [], None
    t_cmp = 0.0
    for npods, strategy in POD_RUNS:
        def count():
            return rt.count_triangles(g, q=q, npods=npods, method="fused",
                                      reduce_strategy=strategy)

        kmod.reset_launch_count()
        r, peak, kept = peak_of(count)
        launches = kmod.launch_count()
        steps = pod_device_steps(r.plan, npods)
        if launches <= 0 or launches != len(steps):
            fail(f"the {npods}-pod fused count launched its kernel "
                 f"{launches} times, not once for each of the {len(steps)} "
                 "pod device-steps that count")
        launches_all += launches
        r2 = count()
        staged = art._memo[("pod_staged", npods, str(dev))]
        rows.append(dict(
            npods=npods, reduce_strategy=strategy, grid=list(r.grid),
            triangles=r.triangles, triangles_warm=r2.triangles,
            pod_stage_seconds=art.stage_seconds.get(f"pod_stage_{npods}"),
            preprocess_seconds=r.preprocess_seconds,
            count_seconds=r.count_seconds, warm_count_seconds=r2.count_seconds,
            kernel_launches=launches, device_steps_counted=len(steps),
            device_steps_skipped=q ** 3 - len(steps),
            staged_bytes=staged_bytes(staged, shared=single),
            peak_device_bytes_of_count=peak,
            bytes_left_allocated_by_count=kept,
        ))
        if not r.triangles == r2.triangles == oracle:
            bad.append((npods, strategy, r.triangles, r2.triangles))
        if npods in seen:
            continue  # the steps of a pod count are compared once
        seen.add(npods)
        t0 = time.perf_counter()
        for t, x, y, s in [st for st in steps if st[0] >= 1][:POD_COMPARE]:
            (args, tcount, kw, split), rolled = pod_step_inputs(
                art, staged, dev, npods, t, x, y, s)
            got = int(count_pair_fused(*args, tcount, **kw))
            want = int(count_pair_fused_plain(*args, tcount, **kw))
            max_abs_err = max(max_abs_err, abs(got - want))
            if got != want:
                unequal.append((npods, t, x, y, s))
            if not rolled:
                not_rolled.append((npods, t, x, y, s))
            compared += 1
            if timed is None:
                timed = (npods, t, x, y, s, args, tcount, kw, split)
        t_cmp += time.perf_counter() - t0
    emit("pod_path", ok=not bad and not unequal and not not_rolled,
         q=q, device=one.device, mismatches=bad,
         single_pod=dict(count_seconds=one.count_seconds,
                         staged_bytes=staged_bytes(single),
                         peak_device_bytes_of_count=one_peak),
         pods=rows, footprint_by_npods=footprint,
         triangles_scipy_oracle=oracle)
    if bad:
        fail(f"pod counts disagree with the oracle: {bad}")
    if not_rolled:
        fail(f"a pod's rolled operands are not the single-pod blocks at "
             f"its global step: {not_rolled}")

    npods, t, x, y, s, args, tcount, kw, split = timed
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = time_cold(lambda: fused_step_counts(*args, tcount, **split), 10,
                   flush)
    plain_ms = time_cold(lambda: count_pair_fused_plain(*args, tcount, **kw),
                         2, flush)
    rec = dict(
        name="tc_fused.fused_step_counts",
        path="cannon_pods",
        route="cuda",
        source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES,
        also_replaces="src/repro/kernels/tc_fused/ops.py:126 (the lax long "
                      "bucket)",
        launches=launches_all,
        launches_note="kernel launches of the cold pod counts of POD_RUNS "
                      "together, one a counted pod device-step",
        max_abs_err=max_abs_err,
        equal=not unequal,
        compared_device_steps=compared,
        compare_seconds=t_cmp,
        tolerance="exact (integer counts, the whole step)",
        ms=ms,
        plain_ms=plain_ms,
        plain_note="count_pair_fused_plain: count_pair_search_global on "
                   "the long bucket, fused_short_counts_plain on the short",
        library_ms=None,
        library_note="no single PyTorch call computes a batched "
                     "sorted-set intersection over CSR rows",
        timed=f"{npods} pods: pod {t}, device ({x}, {y}), loop step {s} "
              f"(global step {t + s * npods}), both buckets, cold L2, "
              "median of 10 (plain: of 2)",
        shape=dict(tasks=int(tcount), tmax=int(args[4].shape[0]),
                   n_long_c=split["n_long"], tile=split["tile"],
                   d_short=split["d_short"], d_long=split["d_long"]),
    )
    rec.update(kernel_bound(args, tcount, split))
    rec["bound_share"] = rec["bound_ms"] / ms if ms > 0 else None
    if unequal:
        print(json.dumps({"kernels": [rec]}), flush=True)
        fail(f"fused kernel != plain route on pod device-steps {unequal}")
    return rec


# ----------------------------------------------------------------------
# the runtime: supervision, the ladder, the regrid, the checkpointed loop
# ----------------------------------------------------------------------
RUNTIME_TRANSIENT = "plan_stage;device_stage;step@1"
RUNTIME_PERSISTENT = "fused=stepfault*-1"
RUNTIME_LOST = 7  # of 16 logical devices: 9 survive, Cannon 3 x 3
CLI_FAULTS = "step@1;ckpt_save=ckptcorrupt"
# the checkpointed stepper runs the plain search: at the default chunk 512
# it takes 10-15x its time at 8192 (PERF.md section 5)
CKPT_CHUNK = 8192
PEAK_SLACK = 1.05  # a supervised count's peak over an unsupervised one's


@contextlib.contextmanager
def cli_hooks(g, spec):
    """While ``tc_run`` runs in this process: its ``--graph spec``
    resolves to the graph in hand (generating rmat 20 again takes as long
    as the main path's generation), and each checkpoint save is timed and
    sized into the yielded list."""
    import repro_torch.ckpt.manager as manager
    import repro_torch.core as core

    saves = []
    gen, save = core.graph_from_spec, manager.save_checkpoint

    def from_spec(text):
        return g if text == spec else gen(text)

    def timed_save(directory, step, tree, **kw):
        t0 = time.perf_counter()
        out = save(directory, step, tree, **kw)
        saves.append(dict(step=step, seconds=time.perf_counter() - t0,
                          bytes=os.path.getsize(os.path.join(
                              directory, f"step_{step:010d}.npz"))))
        return out

    core.graph_from_spec, manager.save_checkpoint = from_spec, timed_save
    try:
        yield saves
    finally:
        core.graph_from_spec, manager.save_checkpoint = gen, save


def capture(fn, *args):
    """``fn(*args)`` with its standard output captured: ``(result, lines,
    seconds)``."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines(), time.perf_counter() - t0


def run_cli(argv):
    """``tc_run.main(argv)`` in this process: its standard output, its
    JSON report (the last line that is one) and its seconds."""
    from repro_torch.launch import tc_run

    _, lines, seconds = capture(tc_run.main, argv)
    report = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    return "\n".join(lines), report, seconds


def checkpointed_cli(g, oracle, dev, q, graph):
    """``tc_run --ckpt-dir`` twice: with ``CLI_FAULTS`` (a step fault and
    a corrupted checkpoint, under the supervisor), then again in that
    directory, which resumes from its last checkpoint.  (A third run with
    ``--fail-at-shift 2``, ≈ 12 s, was cut for the LM training path: the
    faults run restarts from a checkpoint too, and the CPU tests drive
    ``--fail-at-shift``.)  Returns the phase's record and the names of
    its failed checks."""
    bad = []
    with tempfile.TemporaryDirectory(prefix="tc_ckpt_") as tmp:
        faults = os.path.join(tmp, "faults")
        base = ["--graph", graph, "--grid", str(q), "--chunk", str(CKPT_CHUNK),
                "--device", str(dev), "--json"]
        runs = {}
        with cli_hooks(g, graph) as saves:
            for name, extra in (
                    ("faults", ["--ckpt-dir", faults,
                                "--inject-faults", CLI_FAULTS]),
                    ("resume", ["--ckpt-dir", faults])):
                text, rep, sec = run_cli(base + extra)
                runs[name] = dict(
                    seconds=sec, triangles=rep["triangles"],
                    checkpointed=rep.get("checkpointed"),
                    ppt_seconds=rep["ppt_seconds"],
                    tct_seconds=rep["tct_seconds"],
                    live_steps=rep.get("live_steps"),
                    schedule_shifts=rep.get("schedule_shifts"),
                    printed=[ln for ln in text.splitlines()
                             if not ln.startswith("{")],
                    saves=list(saves),
                    restarts=rep.get("supervision_restarts"),
                    fault_log=rep.get("supervision_fault_log"))
                saves.clear()
                if rep["triangles"] != oracle or not rep.get("checkpointed"):
                    bad.append(f"cli_{name}_count")
        corrupt = sorted(f for f in os.listdir(faults)
                         if f.endswith(".corrupt"))
    runs["faults"]["corrupt_files"] = corrupt
    if not ((runs["faults"]["restarts"] or 0) >= 1 and corrupt and any(
            e["fault"] == "CkptCorrupt" for e in runs["faults"]["fault_log"]
            or ())):
        bad.append("cli_faults_recovery")
    if f"resumed at shift {q}" not in runs["resume"]["printed"] or runs[
            "resume"]["saves"]:
        bad.append("cli_resume")
    return runs, bad


def runtime_path(g, oracle, dev, q, graph):
    """The runtime on the main graph (Cannon ``q x q``, ``method=
    "fused"``), each count against the oracle: the checkpointed stepper
    through ``tc_run`` (:func:`checkpointed_cli`; first, while the main
    path's plain-search plan at chunk 8192 is cached), then
    ``supervised_count`` with the transient faults of
    ``RUNTIME_TRANSIENT`` (one restart each, one attempt record each,
    one kernel launch a counted device-step in the attempt that counts,
    and the count's own peak device bytes within ``PEAK_SLACK`` of an
    unsupervised count's, both staging the plan from nothing), with a
    persistent fault of the fused factory (demoted to ``search2`` after
    two) and with the loss of ``RUNTIME_LOST`` logical devices at step 0
    (re-planned on 3 x 3).  Returns the fused kernel's
    ``"cannon_regrid"`` row, held to its plain route on every counted
    device-step of the 3 x 3 plan."""
    import repro_torch as rt
    from repro_torch.kernels.tc_fused import tc_fused as kmod
    from repro_torch.runtime import FaultPlan, Supervisor, supervised_count

    t0 = time.perf_counter()
    cli, bad = checkpointed_cli(g, oracle, dev, q, graph)
    cli_s = time.perf_counter() - t0

    def supervised(spec, **kw):
        plan = FaultPlan.parse(spec)
        t1 = time.perf_counter()
        r = supervised_count(g, q=q, method="fused", fault_plan=plan,
                             supervisor=Supervisor(max_restarts=5), **kw)
        return r, time.perf_counter() - t1

    # 1. transient faults, both counts staging the plan from nothing
    art = rt.count_triangles(g, q=q, method="fused").artifact
    if not art.cache_hit:
        fail("the runtime path missed the main path's cached plan")
    art.release()
    cold, cold_peak, _ = peak_of(
        lambda: rt.count_triangles(g, q=q, method="fused"))
    art.release()
    kmod.reset_launch_count()
    (r1, s1), peak1, _ = peak_of(lambda: supervised(RUNTIME_TRANSIENT))
    launches1 = kmod.launch_count()
    steps1 = schedule_device_steps(r1.plan, "cannon")
    sup1 = r1.supervision
    faulted = [a for a in sup1["attempts"] if a["outcome"] == "fault"]
    transient = dict(
        spec=RUNTIME_TRANSIENT, seconds=s1, triangles=r1.triangles,
        restarts=sup1["restarts"], attempts=sup1["attempts"],
        fault_log=sup1["fault_log"], kernel_launches=launches1,
        device_steps_counted=len(steps1), peak_device_bytes_of_count=peak1,
        unsupervised_peak_device_bytes=cold_peak,
        unsupervised_count_seconds=cold.count_seconds,
        count_seconds=r1.count_seconds)
    if not (r1.triangles == cold.triangles == oracle
            and sup1["restarts"] == 3 and len(faulted) == 3
            and [a.get("point") for a in faulted] == [
                "plan_stage", "device_stage", "step"]):
        bad.append("transient")
    if launches1 <= 0 or launches1 != len(steps1):
        bad.append("transient_launches")
    if peak1 > PEAK_SLACK * cold_peak:
        bad.append("transient_peak")

    # 2. a persistent fault of the fused factory: the ladder demotes
    r2, s2 = supervised(RUNTIME_PERSISTENT, chunk=CKPT_CHUNK, demote_after=2)
    demos = r2.supervision["demotions"]
    persistent = dict(
        spec=RUNTIME_PERSISTENT, seconds=s2, triangles=r2.triangles,
        method=r2.method, chunk=CKPT_CHUNK, demotions=demos,
        restarts=r2.supervision["restarts"],
        attempts=r2.supervision["attempts"], count_seconds=r2.count_seconds)
    if not (r2.triangles == oracle and r2.method == "search2" and demos
            and (demos[0]["frm"], demos[0]["to"]) == ("fused", "search2")):
        bad.append("persistent")

    # 3. device loss: re-planned and counted on the survivors
    lost_spec = f"step@0=devicelost:{RUNTIME_LOST}"
    kmod.reset_launch_count()
    r3, s3 = supervised(lost_spec)
    launches3 = kmod.launch_count()
    steps3 = schedule_device_steps(r3.plan, "cannon")
    r = math.isqrt(q * q - RUNTIME_LOST)
    regrids = r3.supervision["regrids"]
    lost = dict(
        spec=lost_spec, seconds=s3, triangles=r3.triangles,
        grid=list(r3.grid), regrids=regrids,
        restarts=r3.supervision["restarts"],
        preprocess_seconds=r3.preprocess_seconds,
        count_seconds=r3.count_seconds, kernel_launches=launches3,
        device_steps_counted=len(steps3))
    if not (r3.triangles == oracle and regrids == [
            dict(lost=RUNTIME_LOST, grid=[r, r], schedule="cannon")]
            and tuple(r3.grid) == (r, r)):
        bad.append("device_lost")
    if launches3 <= 0 or launches3 != len(steps3):
        bad.append("device_lost_launches")

    emit("runtime_path", ok=not bad, failed=bad, graph=graph, q=q,
         device=r1.device, triangles_scipy_oracle=oracle,
         checkpointed_cli=cli, checkpointed_cli_seconds=cli_s,
         transient=transient, persistent=persistent, device_lost=lost)
    if bad:
        fail(f"the runtime path failed its checks: {bad}")
    return schedule_kernel_report("cannon", r3.artifact, dev, launches3,
                                  steps3, path="cannon_regrid")


def candidate_checks(plan, dev, entry):
    """The fused kernel at every candidate shape of a measured-table entry
    (the analytic tile, the half tile, the widened panel ``d2``) against
    its plain route on the plan's busiest block, the block the table
    timed."""
    from repro_torch.kernels.tc_fused import (
        count_pair_fused,
        count_pair_fused_plain,
    )
    from repro_torch.kernels.tc_fused.autotune import _busiest_arrays

    *host, cnt, sentinel, kind = _busiest_arrays(plan)
    arrs = [torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in host]
    out = []
    for c in entry["candidates"]:
        kw = dict(n_long=plan.n_long, d_small=c["d_small"],
                  dpad_long=plan.dmax, chunk=c["chunk"], tile=c["tile"],
                  long_fallback="search" if kind == "oned" else "global",
                  sentinel=sentinel)
        got = int(count_pair_fused(*arrs, cnt, **kw))
        want = int(count_pair_fused_plain(*arrs, cnt, **kw))
        out.append(dict(tile=c["tile"], d_small=c["d_small"], tasks=cnt,
                        kernel=got, plain=want, equal=got == want))
    return out


def measured_count(kind, g, oracle, dev, grid, table_dir):
    """``count_triangles(g, grid=grid, schedule=kind, method="auto",
    autotune="measured")`` twice, the plan from the cache of the phase
    before: a table miss (the entry timed on the card and written), then
    a hit.  Returns the row: the entry (the baseline's and each
    candidate's seconds, the winner, the roofline prediction from the
    data-sheet rates), what ``auto`` resolved to, the counts (each equal
    to the oracle), the warm count's kernel launches (one a counted
    device-step when it resolved to ``fused``), and the kernel held to
    its plain route at every candidate shape on the busiest block."""
    import repro_torch as rt
    from repro_torch.kernels.tc_fused import measured_entry
    from repro_torch.kernels.tc_fused import tc_fused as kmod

    def count():
        return rt.count_triangles(g, grid=grid, schedule=kind, method="auto",
                                  autotune="measured",
                                  measured_dir=table_dir)

    r1 = count()
    kmod.reset_launch_count()
    r2 = count()
    launches = kmod.launch_count()
    entry, hit = measured_entry(r1.plan, device=dev, table_dir=table_dir)
    if not hit:
        fail(f"the {kind} measured entry is not on disk after a count")
    steps = schedule_device_steps(r2.plan, kind)
    if r2.method == "fused" and launches != len(steps):
        fail(f"the measured {kind} count resolved to fused but launched its "
             f"kernel {launches} times, not {len(steps)}")
    checks = candidate_checks(r1.plan, dev, entry)
    row = dict(
        schedule=kind, grid=list(r1.grid),
        plan_cache_hit=bool(r1.artifact.cache_hit),
        measured_table_hit=[r1.measured_table_hit, r2.measured_table_hit],
        resolved=[r1.method, r2.method],
        triangles=[r1.triangles, r2.triangles],
        preprocess_seconds=[r1.preprocess_seconds, r2.preprocess_seconds],
        count_seconds=[r1.count_seconds, r2.count_seconds],
        warm_kernel_launches=launches, device_steps_counted=len(steps),
        entry={k: entry[k] for k in ("key", "kind", "backend", "impl",
                                      "baseline", "t_baseline", "t_fused",
                                      "best", "candidates", "winner",
                                      "roofline")},
        candidate_checks=checks,
    )
    ok = (r1.triangles == r2.triangles == oracle
          and r1.measured_table_hit is False and r2.measured_table_hit
          and all(c["equal"] for c in checks))
    return row, ok


# ----------------------------------------------------------------------
# the planner stages on the card: hub split, rebalance, batched counts
# ----------------------------------------------------------------------
HUB_GRIDS = (("oned", (GRID, GRID)), ("cannon", (GRID, GRID)))
# the schedule that also runs the warm count, the search recount and the
# halves; on Cannon (about 20 s a run) they were cut for the LM training
# path, whose kernel row is the ring's
HUB_DEEP = "oned"
HUB_CHUNK = 8192
DEFAULT_CHUNK = 512  # count_triangles' and tc_run's default chunk
REBALANCE_TRIALS = 2  # 3 until the LM training path needed the seconds
MANY_SCALES = (16, 17)  # rmat 18 cut in favour of the LM path
MANY_NAMED = ("named:karate", "named:k10")
# (schedule, grid, chunk) of each batch: Cannon's chunk-512 batch (about
# 98 s a run, PERF.md section 5) was left out to make room for the delta
# path, the ring's (about 14 s) for the LM training path
MANY_CELLS = (("cannon", (GRID, GRID), 8192), ("oned", (GRID, GRID), 8192))


def synced(fn):
    """``fn()`` and its host seconds, between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def hub_partial(art, dev):
    """The hub side's partial alone, as ``HubCount`` runs it inside a
    count (the plain search over every logical device's fragments), at the
    plan's chunk: ``(triangles, seconds)``."""
    from repro_torch.core.engine import HubCount

    h = art.plan.hub
    hub = HubCount(dpad=h.dpad, chunk=h.chunk, sentinel=h.sentinel,
                   hub_cnt=h.hub_cnt)
    st = art.staged(dev)
    out = torch.zeros(h.hub_cnt.shape, dtype=torch.int64, device=dev)
    return synced(lambda: int(hub.count(st, out).sum()))


def residual_count(art, kind, dev):
    """The residual schedule alone (the hub side dropped from the plan),
    fused, warm: ``(triangles, seconds)``."""
    import dataclasses

    from repro_torch.core.cannon import build_cannon_fn
    from repro_torch.core.onedim import build_oned_fn
    from repro_torch.core.summa import build_summa_fn

    build = {"cannon": build_cannon_fn, "summa": build_summa_fn,
             "oned": build_oned_fn}[kind]
    fn = build(dataclasses.replace(art.plan, hub=None), method="fused")
    st = art.staged(dev)
    int(fn(**st))
    return synced(lambda: int(fn(**st)))


def hub_path(g, oracle, dev, graph):
    """``count_triangles(g, hub_split=True, method="fused", chunk=8192)``
    on the ring p = 16 and on Cannon q = 4: cold (one kernel launch a
    counted residual device-step), equal to the oracle; on the ring
    (``HUB_DEEP``) also warm (a plan-cache hit), ``method="search"`` on the
    same artifact, and the two halves alone — the hub partial and the
    residual schedule — all equal to the oracle.  (Cut to make room: the
    ring's profiled warm count, about a minute a run, as the halves alone
    give the same split; for the LM training path, the ring's hub partial
    at the default chunk 512 and Cannon's warm, search and halves.)
    Returns the ring's ``oned_hub`` row of the fused kernel, held to its
    plain route on every residual device-step."""
    import repro_torch as rt
    from repro_torch.kernels.tc_fused import tc_fused as kmod
    from repro_torch.pipeline import default_cache

    rows, bad, kernel_rows = {}, [], []
    for kind, grid in HUB_GRIDS:
        def count(**kw):
            return rt.count_triangles(g, grid=grid, schedule=kind,
                                      hub_split=True, chunk=HUB_CHUNK, **kw)

        torch.cuda.reset_peak_memory_stats()
        kmod.reset_launch_count()
        r = count(method="fused")
        launches = kmod.launch_count()
        peak = torch.cuda.max_memory_allocated()
        art, plan = r.artifact, r.plan
        if plan.hub is None:
            fail(f"the {kind} hub split found no hub row")
        steps = schedule_device_steps(plan, kind)
        if launches <= 0:
            fail(f"the {kind} hub path launched the fused kernel no time")
        if launches != len(steps):
            fail(f"the {kind} hub-split fused count launched its kernel "
                 f"{launches} times, not once for each of the {len(steps)} "
                 "residual device-steps that count")
        h = plan.hub
        row = dict(
            graph=graph, schedule=kind, grid=list(r.grid), device=r.device,
            triangles=r.triangles, triangles_scipy_oracle=oracle,
            hub=r.hub, hub_chunk=h.chunk, hub_tmax=int(h.hub_ti.shape[-1]),
            hub_indices_pad=int(h.hub_indices.shape[-1]),
            hubsplit_seconds=art.stage_seconds.get("hubsplit"),
            preprocess_seconds=r.preprocess_seconds,
            stage_seconds={k: float(v)
                           for k, v in art.stage_seconds.items()},
            count_seconds=r.count_seconds,
            kernel_launches=launches, device_steps_counted=len(steps),
            peak_device_bytes=int(peak),
        )
        row["tasks_past_stage_limit"], row["longest_task_row"] = (
            tasks_past_stage_limit(plan, kind))
        want = [r.triangles]
        if kind == HUB_DEEP:
            hits0 = default_cache().hits
            r2 = count(method="fused")
            cache_hit = (r2.artifact is art and bool(r2.artifact.cache_hit)
                         and default_cache().hits > hits0)
            if not cache_hit:
                fail(f"second {kind} hub-split count missed the plan cache")
            rs = rt.count_triangles(g, plan=art, schedule=kind,
                                    method="search")
            hub_t, hub_s = hub_partial(art, dev)
            res_t, res_s = residual_count(art, kind, dev)
            row.update(
                triangles_repeat=r2.triangles,
                triangles_search=rs.triangles,
                warm_preprocess_seconds=r2.preprocess_seconds,
                warm_count_seconds=r2.count_seconds,
                search_count_seconds=rs.count_seconds,
                hub_partial=dict(triangles=hub_t, seconds=hub_s,
                                 chunk=h.chunk),
                residual=dict(triangles=res_t, seconds=res_s, m=plan.m,
                              dmax=plan.dmax, d_small=plan.d_small,
                              n_long=plan.n_long, chunk=plan.chunk),
                hub_share_of_halves=hub_s / (hub_s + res_s)
                if hub_s + res_s > 0 else None,
                cache_hit=cache_hit)
            want += [r2.triangles, rs.triangles, hub_t + res_t]
            kernel_rows.append(schedule_kernel_report(
                kind, art, dev, launches, steps, path="oned_hub"))
            del r2, rs
        if any(v != oracle for v in want):
            bad.append((kind, want))
        rows[kind] = row
        del art, r
    emit("hub_path", ok=not bad, mismatches=bad, **rows)
    if bad:
        fail(f"hub-split counts disagree with the oracle: {bad}")
    return kernel_rows


def rebalance_path(g, oracle, dev, q):
    """``count_triangles(g, q=q, method="fused", rebalance_trials=2)``:
    the rebalance report and stage seconds, one kernel launch a counted
    device-step, then warm counts of the plain and the rebalanced plan in
    turns (plain, rebalanced, rebalanced, plain): all equal to the
    oracle.  Runs while the main path's plan is still in the cache."""
    import repro_torch as rt
    from repro_torch.kernels.tc_fused import tc_fused as kmod

    def count(trials):
        return rt.count_triangles(g, q=q, method="fused",
                                  rebalance_trials=trials)

    kmod.reset_launch_count()
    r = count(REBALANCE_TRIALS)
    launches = kmod.launch_count()
    rb = r.rebalance
    if rb is None:
        fail("rebalance_trials > 0 gave no rebalance report")
    steps = schedule_device_steps(r.plan, "cannon")
    if launches <= 0 or launches != len(steps):
        fail(f"the rebalanced fused count launched its kernel {launches} "
             f"times, not once for each of the {len(steps)} device-steps")
    warm = {"plain": [], "rebalanced": []}
    counts = [r.triangles]
    for name in ("plain", "rebalanced", "rebalanced", "plain"):
        rw = count(REBALANCE_TRIALS if name == "rebalanced" else 0)
        if not rw.artifact.cache_hit:
            fail(f"the warm {name} count missed the plan cache")
        warm[name].append(rw.count_seconds)
        counts.append(rw.triangles)
    impr = rb["improvement"]
    sk = r.plan.step_keep
    ok = all(c == oracle for c in counts)
    emit("rebalance_path", ok=ok, q=q, device=r.device, trials=rb["trials"],
         best_seed=rb["best_seed"],
         improvement=impr if np.isfinite(impr) else None,
         baseline_masked_critical_path=rb["baseline_masked_critical_path"],
         best_masked_critical_path=rb["best_masked_critical_path"],
         skipped_steps=rb["skipped_steps"],
         baseline_skipped_steps=rb["baseline_skipped_steps"],
         rebalance_seconds=r.artifact.stage_seconds.get("rebalance"),
         preprocess_seconds=r.preprocess_seconds,
         stage_seconds={k: float(v)
                        for k, v in r.artifact.stage_seconds.items()},
         count_seconds=r.count_seconds, warm_count_seconds=warm,
         schedule_steps=int(sk.size), kernel_launches=launches,
         device_steps_counted=len(steps), triangles=counts,
         triangles_scipy_oracle=oracle)
    if not ok:
        fail(f"rebalanced counts disagree with the oracle: {counts}")


def many_path(dev, seed, scales=MANY_SCALES):
    """``count_triangles_many`` over rmat graphs of ``scales`` and two
    small named graphs, ``method="search"``, on each of ``MANY_CELLS``
    (Cannon q = 4 at chunk 8192, the ring p = 16 at chunks 512 and
    8192): cold (planning, padding, staging),
    warm (a program-cache hit), against ``count_triangles`` graph by graph
    and the scipy oracle.  No hand-written kernel runs here: the batch is
    the plain search's."""
    import repro_torch as rt
    from repro_torch.core import graph_from_spec
    from repro_torch.pipeline import PlanCache

    specs = [f"rmat:{s},{EDGE_FACTOR},{seed}" for s in scales]
    graphs = [rt.rmat(s, EDGE_FACTOR, seed=seed) for s in scales]
    specs += list(MANY_NAMED)
    graphs += [graph_from_spec(s) for s in MANY_NAMED]
    t0 = time.perf_counter()
    oracles = [scipy_triangle_oracle(x.n, x.edges) for x in graphs]
    oracle_s = time.perf_counter() - t0
    rows, bad = {}, []
    for kind, grid, chunk in MANY_CELLS:
        cache = PlanCache()
        kw = dict(grid=grid, schedule=kind, method="search", chunk=chunk,
                  cache=cache)
        res = rt.count_triangles_many(graphs, **kw)
        res2 = rt.count_triangles_many(graphs, **kw)
        if res.cache_hit or not res2.cache_hit:
            fail(f"the {kind} batch at chunk {chunk}: cold hit "
                 f"{res.cache_hit}, warm hit {res2.cache_hit}")
        per = [rt.count_triangles(x, **kw) for x in graphs]
        rows[f"{kind}/chunk{chunk}"] = dict(
            grid=list(res.grid), batch=res.batch,
            triangles=res.triangles, triangles_repeat=res2.triangles,
            triangles_per_graph=[p.triangles for p in per],
            padding_overhead=res.padding_overhead,
            plan_seconds=res.plan_seconds,
            warm_plan_seconds=res2.plan_seconds,
            count_seconds=res.count_seconds,
            warm_count_seconds=res2.count_seconds,
            per_graph_count_seconds=[p.count_seconds for p in per],
            per_graph_count_seconds_sum=sum(p.count_seconds for p in per),
            per_graph_preprocess_seconds_sum=sum(
                p.preprocess_seconds for p in per),
        )
        if not (res.triangles == res2.triangles
                == [p.triangles for p in per] == oracles):
            bad.append((kind, chunk, res.triangles,
                        [p.triangles for p in per]))
    emit("many_path", ok=not bad, graphs=specs, device=str(dev),
         triangles_scipy_oracle=oracles, oracle_seconds=oracle_s,
         mismatches=bad, **rows)
    if bad:
        fail(f"batched counts disagree with count_triangles / the oracle: "
             f"{bad}")


# ----------------------------------------------------------------------
# the delta ladder on the card: a stream of edge edits on the main graph
# ----------------------------------------------------------------------
# edits a round: 4 (2 removals of existing edges, 2 additions of absent
# pairs) dirty at most 4 of Cannon's 16 blocks, so they splice; 4,096
# dirty every block, so round 7 repacks; round 9 is depth 9 > 8: rebase
DELTA_ROUNDS = (4, 4096, 4, 4)
DELTA_PLANNED = ("splice", "repack", "splice", "rebase")
DELTA_REBASE_EVERY = 3
STREAM_GRAPH = "rmat:14"  # tc_run --stream, end to end
STREAM_ROUNDS = (4, 512)  # (4, 4, 512, 4) until the LM training path


class EdgeKeys:
    """The script's own host copy of a mutating graph: its canonical edge
    keys ``lo * n + hi``, sorted, and its symmetric scipy CSR adjacency
    (sorted rows).  Shares no code with the package."""

    def __init__(self, n, edges):
        import scipy.sparse as sp

        self.n = int(n)
        lo = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64)
        hi = np.maximum(edges[:, 0], edges[:, 1]).astype(np.int64)
        keys = np.sort(lo * self.n + hi)  # np.unique is far slower here
        self.keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
        self.adj = self._sym(self.keys, 1, sp)
        self.adj.sort_indices()

    def _sym(self, keys, sign, sp):
        lo, hi = keys // self.n, keys % self.n
        return sp.csr_matrix(
            (np.full(2 * keys.size, sign, dtype=np.int8),
             (np.concatenate([lo, hi]), np.concatenate([hi, lo]))),
            shape=(self.n, self.n))

    def pairs(self, keys):
        return np.stack([keys // self.n, keys % self.n], axis=1)

    def has(self, u, v):
        ip, ix = self.adj.indptr, self.adj.indices
        row = ix[ip[u]:ip[u + 1]]
        i = np.searchsorted(row, v)
        return bool(i < row.size and row[i] == v)

    def draw(self, rng, k):
        """``k // 2`` existing edges to remove and ``k - k // 2`` absent
        pairs to add, uniformly at random, as key arrays."""
        rem = self.keys[rng.choice(self.keys.size, size=k // 2,
                                   replace=False)]
        add = np.zeros(0, dtype=np.int64)
        while add.size < k - k // 2:
            u = rng.integers(0, self.n, size=2 * k + 8)
            v = rng.integers(0, self.n, size=2 * k + 8)
            cand = np.minimum(u, v) * self.n + np.maximum(u, v)
            cand = cand[u != v]
            pos = np.minimum(np.searchsorted(self.keys, cand),
                             self.keys.size - 1)
            cand = np.concatenate([add, cand[self.keys[pos] != cand]])
            _, first = np.unique(cand, return_index=True)
            add = cand[np.sort(first)]
        return rem, add[:k - k // 2]

    def apply(self, rem, add):
        """Remove then add; returns the change of the triangle count,
        ``tri(G, R)`` lost and ``tri(G - R + A, A)`` gained."""
        import scipy.sparse as sp

        lost = self.through(self.pairs(rem))
        self.keys = np.delete(self.keys, np.searchsorted(self.keys, rem))
        self.adj = self.adj + self._sym(rem, -1, sp)
        self.adj.eliminate_zeros()
        add = np.sort(add)
        self.keys = np.insert(self.keys, np.searchsorted(self.keys, add),
                              add)
        self.adj = (self.adj + self._sym(add, 1, sp)).tocsr()
        self.adj.sort_indices()
        return self.through(self.pairs(add)) - lost

    def through(self, pairs):
        """Triangles of the current graph holding at least one edge of
        ``pairs`` (all present): ``sum |N(u) ∩ N(v)|`` over the pairs
        counts a triangle once for each of its edges among them, so those
        with two such edges are taken off once and those with three
        twice."""
        ip, ix = self.adj.indptr, self.adj.indices
        total = 0
        nbr = {}
        for u, v in pairs.tolist():
            total += np.intersect1d(ix[ip[u]:ip[u + 1]], ix[ip[v]:ip[v + 1]],
                                    assume_unique=True).size
            nbr.setdefault(u, []).append(v)
            nbr.setdefault(v, []).append(u)
        inside = {tuple(p) for p in pairs.tolist()}
        two = three = 0
        for ys in nbr.values():
            for i in range(len(ys)):
                for j in range(i + 1, len(ys)):
                    a, b = min(ys[i], ys[j]), max(ys[i], ys[j])
                    if (a, b) in inside:
                        three += 1  # seen once at each of its 3 apexes
                    elif self.has(a, b):
                        two += 1
        return total - two - 2 * (three // 3)


def delta_stream(edges_n, rounds, seed):
    """The rounds' deltas, each ``(remove, add)`` as ``(k, 2)`` int64
    arrays in original ids, drawn from ``seed``, and the oracle's change
    of the triangle count each round: ``(deltas, changes, final_keys)``."""
    n, edges = edges_n
    rng = np.random.default_rng(seed)
    cur = EdgeKeys(n, edges)
    deltas, changes = [], []
    for k in rounds:
        rem, add = cur.draw(rng, k)
        deltas.append((cur.pairs(rem), cur.pairs(add)))
        changes.append(cur.apply(rem, add))
    return deltas, changes, cur


def dirty_device_steps(plan, steps, pairs):
    """The counted Cannon device-steps whose A block, B block or task
    block holds an edited edge (``pairs`` in the plan's ids): after ``s``
    shifts device ``(x, y)`` reads canonical blocks ``(x, z)`` and
    ``(y, z)`` with ``z = σ[(x + y + s) % q]`` and its own ``(x, y)``."""
    q = plan.q
    sp = (list(plan.skew_perm) if plan.skew_perm is not None
          else list(range(q)))
    lo, hi = np.minimum(pairs[:, 0], pairs[:, 1]), np.maximum(
        pairs[:, 0], pairs[:, 1])
    dirty = set(zip((lo % q).tolist(), (hi % q).tolist()))
    out = []
    for (x, y), s in steps:
        z = sp[(x + y + s) % q]
        if {(x, z), (y, z), (x, y)} & dirty:
            out.append(((x, y), s))
    return out


@contextlib.contextmanager
def fresh_plan_cache():
    """A fresh default plan cache while the block runs: a front end driven
    in this process plans from nothing and evicts nothing of the phases'
    cached plans."""
    from repro_torch.pipeline import PlanCache, set_default_cache

    prev = set_default_cache(PlanCache())
    try:
        yield
    finally:
        set_default_cache(prev)


def stream_cli(dev, seed):
    """``tc_run --stream`` end to end, in this process, on
    ``STREAM_GRAPH`` at q = 2, ``method="fused"``, ``--verify``: every
    round correct.  The delta file goes to the build directory."""
    import repro_torch as rt
    from repro_torch.kernels import _build

    g = rt.graph_from_spec(STREAM_GRAPH)
    deltas, _, _ = delta_stream((g.n, g.edges), STREAM_ROUNDS, seed)
    path = _build.build_dir() / "chip_smoke_stream.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(
        json.dumps({"add": a.tolist(), "remove": r.tolist()}) + "\n"
        for r, a in deltas))
    with fresh_plan_cache():
        _, report, seconds = run_cli(
            ["--graph", STREAM_GRAPH, "--grid", "2", "--method", "fused",
             "--stream", str(path), "--verify", "--json", "--device",
             str(dev)])
    rounds = report["rounds"]
    return dict(graph=STREAM_GRAPH, seconds=seconds,
                rounds=len(rounds),
                levels=[r["level"] for r in rounds],
                correct=all(r["correct"] for r in rounds)
                and len(rounds) == len(STREAM_ROUNDS))


def delta_path(g, oracle, dev, q, seed):
    """``count_triangles_delta`` over a 4-round stream on the main graph
    (Cannon q = 4, ``method="fused"``, ``rebase_every=3``: splice,
    repack, splice, rebase), each round against the incremental oracle;
    then the replay of round 1, a profiled warm count of round 1's
    spliced plan, and ``tc_run --stream``.  Returns the fused kernel's
    ``"cannon_delta"`` row."""
    import repro_torch as rt
    from repro_torch.kernels.tc_fused import tc_fused as kmod
    from repro_torch.pipeline import (
        EdgeDelta,
        PlanCache,
        apply_delta,
        default_cache,
    )

    t_phase = time.perf_counter()
    deltas, changes, _ = delta_stream((g.n, g.edges), DELTA_ROUNDS, seed)
    oracle_s = time.perf_counter() - t_phase

    hits0 = default_cache().hits
    base = rt.count_triangles(g, q=q, method="fused")  # the main path's
    if not (base.artifact.cache_hit and default_cache().hits > hits0):
        fail("the delta path's base count missed the main path's plan")
    stream_cache = PlanCache(maxsize=16)
    art, want, rows, bad, firsts = base.artifact, oracle, [], [], None
    kmod.reset_launch_count()
    for i, ((rem, add), change) in enumerate(zip(deltas, changes)):
        delta = EdgeDelta(add=add, remove=rem)
        before = kmod.launch_count()
        t1 = time.perf_counter()
        res = rt.count_triangles_delta(
            g, delta, artifact=art, cache=stream_cache, q=q, method="fused",
            rebase_every=DELTA_REBASE_EVERY)
        round_s = time.perf_counter() - t1
        launches = kmod.launch_count() - before
        art, rep, want = res.artifact, res.delta, want + change
        steps = schedule_device_steps(art.plan, "cannon")
        if i == 0:
            firsts = (delta, art, steps)
        st = art.stage_seconds
        rows.append(dict(
            round=i + 1, edits=delta.k, level=rep["level"],
            planned_level=DELTA_PLANNED[i], reason=rep.get("reason"),
            depth=rep["depth"], dirty_blocks=rep["dirty_blocks"],
            dirty_block_fraction=rep["dirty_block_fraction"],
            dirty_cell_fraction=rep["dirty_cell_fraction"],
            replanned_stages=rep["replanned_stages"],
            fn_inherited=rep["fn_inherited"],
            apply_delta_seconds=st.get("apply_delta"),
            stage_seconds=st.get("stage"),
            stage_reused_buffers=st.get("stage_reused_buffers"),
            preprocess_seconds=res.preprocess_seconds,
            count_seconds=res.count_seconds, round_seconds=round_s,
            nnz_pad=art.plan.nnz_pad, dmax=art.plan.dmax,
            n_long=art.plan.n_long, d_small=art.plan.d_small,
            kernel_launches=launches, device_steps_counted=len(steps),
            triangles=res.triangles, expected=want))
        if res.triangles != want:
            bad.append((i + 1, res.triangles, want))
        if launches != len(steps):
            fail(f"delta round {i + 1} launched the fused kernel "
                 f"{launches} times, not once for each of the {len(steps)} "
                 "device-steps that count")
    launches = kmod.launch_count()
    if launches <= 0:
        fail("the delta path launched the fused kernel no time")

    delta1, art1, steps1 = firsts
    replay = apply_delta(base.artifact, delta1, cache=stream_cache)
    replay_hit = replay is art1 and bool(replay.cache_hit)
    if not replay_hit:
        fail("replaying round 1 on the base artifact missed the lineage "
             "cache")
    prof = profile_count(
        lambda: rt.count_triangles(art1.graph, plan=art1, q=q,
                                   method="fused"), len(steps1))
    if prof.get("searchsorted_launches"):
        fail(f"the warm count of a spliced plan ran "
             f"{prof['searchsorted_launches']} searchsorted launches")
    if prof.get("device_seconds", 0) > 0 and not prof["complete"]:
        fail("the warm count of a spliced plan did not launch the kernel "
             "once a counted device-step: the profile saw "
             f"{prof['fused_kernel_launches_seen']} of {len(steps1)}: "
             f"{json.dumps(prof)}")

    cli = stream_cli(dev, seed)
    if not cli["correct"]:
        bad.append(("tc_run --stream", cli))

    levels = [r["level"] for r in rows]
    emit("delta_path", ok=not bad, q=q, device=base.device,
         rebase_every=DELTA_REBASE_EVERY, triangles_base=base.triangles,
         base_cache_hit=True, levels=levels,
         levels_as_planned=levels == list(DELTA_PLANNED),
         rounds=rows, mismatches=bad, incremental_oracle_seconds=oracle_s,
         kernel_launches=launches, replay_cache_hit=replay_hit,
         spliced_warm_count_profile=prof,
         tc_run_stream=cli, seconds=time.perf_counter() - t_phase)
    if bad:
        fail(f"delta-path counts disagree with the incremental oracle: "
             f"{bad}")
    pairs = np.concatenate([delta1.add, delta1.remove])
    perm = art1.perm
    steps = dirty_device_steps(
        art1.plan, steps1, pairs if perm is None else perm[pairs])
    if not steps:
        fail("round 1 dirtied no counted device-step")
    rec = schedule_kernel_report("cannon", art1, dev, launches, steps,
                                 path="cannon_delta")
    rec["compared_note"] = ("every counted device-step of round 1's "
                            "spliced plan that reads a dirty block")
    stream_cache.clear()
    return rec


# ----------------------------------------------------------------------
# the front ends: serve (stream and batch), tc_run --opt / --time-split,
# and what the blob shifts cost the main path
# ----------------------------------------------------------------------
SERVE_ROUNDS = 4
SERVE_DELTA_EDGES = 4
SERVE_FAULTS = "step@1"  # round 0's first attempt fails at step 1
SERVE_BATCH = "named:karate;rmat:12;rmat:14,8,1"
SERVE_BATCH_GRID = 2
SERVE_BATCH_ROUNDS = 3
OPT_GRAPH = "rmat:18,16,1"
SPLIT_GRAPH = "rmat:16,16,1"
# the front ends' graphs and oracles, kept for the mesh runtime's runs
FRONTEND_GRAPHS = {}


def frontend_graph(spec):
    """``(graph, scipy oracle)`` of a front end's graph, made once a run."""
    import repro_torch as rt

    if spec not in FRONTEND_GRAPHS:
        g = rt.graph_from_spec(spec)
        FRONTEND_GRAPHS[spec] = (g, scipy_triangle_oracle(g.n, g.edges))
    return FRONTEND_GRAPHS[spec]
FRONTEND_CHUNK = 8192
BLOB_TURNS = ("arrays", "blob", "blob", "arrays") * 2


def round_counts(lines):
    """``{round: triangles}`` and ``{round: ms}`` of serve's round lines."""
    import re

    counts, ms = {}, {}
    for ln in lines:
        m = re.match(r"round (\d+): triangles=(.+?) in ([0-9.]+)ms", ln)
        if m:
            counts[int(m.group(1))] = json.loads(m.group(2))
            ms[int(m.group(1))] = float(m.group(3))
    return counts, ms


def blob_cost(g, oracle, dev, q):
    """The main plan's warm fused count with the shifted CSR payload as
    separate arrays and as blobs (the default), in turns: seconds, fused
    kernel launches, a profile of each (the rolls', the packing's and the
    kernel's device time), a count's own peak device bytes and the bytes
    each phase moves."""
    import repro_torch as rt
    from repro_torch.core.cannon import build_cannon_fn
    from repro_torch.kernels.tc_fused import tc_fused as kmod
    from repro_torch.launch.roofline import collective_phases

    art = rt.count_triangles(g, q=q, method="fused").artifact
    staged = art.staged(dev)
    fns = {"arrays": build_cannon_fn(art.plan, method="fused",
                                     use_blob=False),
           "blob": build_cannon_fn(art.plan, method="fused")}
    rows = {name: dict(warm_count_seconds=[]) for name in fns}
    bad = []
    for name, fn in fns.items():  # warm-up, launches and peak of each
        int(fn(**staged))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kmod.reset_launch_count()
        got = int(fn(**staged))
        rows[name].update(kernel_launches=kmod.launch_count(),
                          count_peak_bytes=int(
                              torch.cuda.max_memory_allocated() - base),
                          moved_bytes=collective_phases(fn, staged))
        if got != oracle:
            bad.append((name, got))
    for name in BLOB_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = int(fns[name](**staged))
        rows[name]["warm_count_seconds"].append(time.perf_counter() - t0)
        if got != oracle:
            bad.append((name, got))
    for name, fn in fns.items():
        rows[name]["profile"] = profile_count(
            lambda: int(fn(**staged)), rows[name]["kernel_launches"],
            spans=("roll_cuda_kernel", "CatArray"))
        rows[name]["warm_count_seconds_min"] = min(
            rows[name]["warm_count_seconds"])
    return dict(rows, turns=list(BLOB_TURNS), mismatches=bad)


def serve_stream(g, oracle, dev, q, graph):
    """``serve --tc-stream`` on the main graph (already in memory):
    Cannon q = 4, ``method="fused"``, ``SERVE_ROUNDS`` rounds of
    ``SERVE_DELTA_EDGES`` flips, ``SERVE_FAULTS`` injected.  Each round's
    count against the oracle updated by the round's flips
    (``EdgeDelta.random_flips(g, k, seed=round)`` makes them
    deterministic).  Returns the record and the last round's artifact."""
    from repro_torch.kernels.tc_fused import tc_fused as kmod
    from repro_torch.launch import serve
    from repro_torch.pipeline import EdgeDelta

    args = serve.build_parser().parse_args([
        "--tc-stream", graph, "--grid", str(q), "--method", "fused",
        "--rounds", str(SERVE_ROUNDS),
        "--delta-edges", str(SERVE_DELTA_EDGES),
        "--inject-faults", SERVE_FAULTS, "--device", str(dev)])
    kmod.reset_launch_count()
    (live, res), lines, seconds = capture(serve._serve_tc_stream, args, g)
    launches = kmod.launch_count()
    counts, ms = round_counts(lines)

    t0 = time.perf_counter()

    def keys(pairs):
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        return (np.minimum(pairs[:, 0], pairs[:, 1]) * g.n
                + np.maximum(pairs[:, 0], pairs[:, 1]))

    cur, want, mine = EdgeKeys(g.n, g.edges), oracle, g
    expected = {0: oracle}
    for rnd in range(1, SERVE_ROUNDS):
        if rnd not in counts:  # a failed round leaves the graph as it was
            continue
        delta = EdgeDelta.random_flips(mine, SERVE_DELTA_EDGES, seed=rnd)
        mine = delta.apply_to(mine)
        want += cur.apply(keys(delta.remove), keys(delta.add))
        expected[rnd] = want
    oracle_s = time.perf_counter() - t0
    steps = schedule_device_steps(res.artifact.plan, "cannon")
    rec = dict(
        graph=graph, q=q, method="fused", rounds=SERVE_ROUNDS,
        delta_edges=SERVE_DELTA_EDGES, faults=SERVE_FAULTS,
        triangles=counts, expected=expected, round_ms=ms,
        supervision=lines[-1], lines=lines, seconds=seconds,
        incremental_oracle_seconds=oracle_s, kernel_launches=launches,
        device_steps_counted_last_round=len(steps),
        last_level=res.delta["level"] if res.delta else None,
        live_edges=int(live.m), oracle_edges=int(mine.m),
    )
    ok = (counts == expected and len(counts) == SERVE_ROUNDS
          and "1 restarts" in lines[-1] and live.m == mine.m
          and launches > 0)
    return ok, rec, res.artifact, steps


def serve_batch(dev):
    """``serve --tc-graphs SERVE_BATCH --grid 2 --rounds 3 --verify`` from
    a fresh plan cache: every round verified, rounds 1 and later warm."""
    from repro_torch.launch import serve

    with fresh_plan_cache():
        _, lines, seconds = capture(serve.main, [
            "--tc-graphs", SERVE_BATCH, "--grid", str(SERVE_BATCH_GRID),
            "--rounds", str(SERVE_BATCH_ROUNDS), "--verify", "--device",
            str(dev)])
    counts, ms = round_counts(lines)
    rounds = [ln for ln in lines if ln.startswith("round ")]
    warm = [("warm" in ln) for ln in rounds]
    # --verify held every round to the package's host oracle
    ok = (len(counts) == len(rounds) == SERVE_BATCH_ROUNDS and not warm[0]
          and all(warm[1:]) and len({str(c) for c in counts.values()}) == 1)
    return ok, dict(graphs=SERVE_BATCH, grid=SERVE_BATCH_GRID,
                    triangles=counts, round_ms=ms, warm=warm, lines=lines,
                    seconds=seconds)


def frontend_cli(dev, q):
    """``tc_run --opt`` on ``OPT_GRAPH`` (q = 4, chunk 8192, ``--repeat
    2``) and ``tc_run --time-split`` on the three schedules at
    ``SPLIT_GRAPH`` (chunk 8192), each from a fresh plan cache, against
    the scipy oracle."""
    out, ok = {}, True
    og, want = frontend_graph(OPT_GRAPH)
    with fresh_plan_cache(), cli_hooks(og, OPT_GRAPH):
        _, rep, seconds = run_cli([
            "--graph", OPT_GRAPH, "--grid", str(q), "--chunk",
            str(FRONTEND_CHUNK), "--opt", "--repeat", "2", "--json",
            "--device", str(dev)])
    out["opt"] = dict(rep, triangles_scipy_oracle=want, seconds=seconds)
    ok = ok and rep["triangles"] == want and rep.get("optimized") is True
    sg, want = frontend_graph(SPLIT_GRAPH)
    for kind in ("cannon", "summa", "oned"):
        with fresh_plan_cache(), cli_hooks(sg, SPLIT_GRAPH):
            _, rep, seconds = run_cli([
                "--graph", SPLIT_GRAPH, "--grid", str(q), "--schedule",
                kind, "--chunk", str(FRONTEND_CHUNK), "--time-split",
                "--json", "--device", str(dev)])
        only = "tct_broadcast_only" if kind == "summa" else "tct_shift_only"
        keys = (only, "tct_count_only", "coll_shift_bytes",
                "coll_broadcast_bytes", "coll_reduce_bytes",
                "coll_other_bytes")
        row = {k: rep.get(k) for k in keys}
        row.update(triangles=rep["triangles"], triangles_scipy_oracle=want,
                   tct_seconds=rep["tct_seconds"], seconds=seconds)
        out[f"time_split_{kind}"] = row
        ok = (ok and rep["triangles"] == want
              and all(rep.get(k) is not None for k in keys)
              and (rep["coll_shift_bytes"] > 0) == (kind != "summa"))
    return ok, out


def serve_path(g, oracle, dev, q, graph):
    """The front ends on the card: the blob cost on the main plan,
    ``serve --tc-stream`` on the main graph, ``serve --tc-graphs``,
    ``tc_run --opt`` and ``--time-split``, each result on a JSON line of
    its own (``serve_blob``, ``serve_stream``, ``serve_batch``,
    ``tc_run_opt``, ``tc_run_time_split``), then the ``serve_path`` line.
    Returns the fused kernel's ``"serve_stream"`` row, held to its plain
    route on one device-step of the last round's plan."""
    t_phase = time.perf_counter()
    blob = blob_cost(g, oracle, dev, q)
    emit("serve_blob", ok=not blob["mismatches"], **blob)
    stream_ok, stream, art, steps = serve_stream(g, oracle, dev, q, graph)
    emit("serve_stream", ok=stream_ok, **stream)
    batch_ok, batch = serve_batch(dev)
    emit("serve_batch", ok=batch_ok, **batch)
    cli_ok, cli = frontend_cli(dev, q)
    emit("tc_run_opt", **cli.pop("opt"))
    emit("tc_run_time_split", **cli)
    ok = (stream_ok and batch_ok and cli_ok and not blob["mismatches"])
    emit("serve_path", ok=ok, blob=not blob["mismatches"], stream=stream_ok,
         batch=batch_ok, tc_run=cli_ok,
         seconds=time.perf_counter() - t_phase)
    if not ok:
        fail("the front ends miscounted, missed a retry or a warm round, "
             "or left a field out (serve_path line)")
    rec = schedule_kernel_report("cannon", art, dev,
                                 stream["kernel_launches"], steps[:1],
                                 path="serve_stream")
    rec["compared_note"] = ("the first counted device-step of the last "
                            "stream round's plan")
    return rec


# ----------------------------------------------------------------------
# the grid on a device mesh
# ----------------------------------------------------------------------
MESH_SUMMA = SUMMA_GRID  # SUMMA 2 x 8 and the ring p = 16 on the mesh too
MESH_PODS = 2  # Cannon q = 4 with 2 pods under "tree": 32 positions
MESH_WARM = 3  # warm counts on the mesh and on one device, in turns


def mesh_cards(n):
    """Position ``i`` of an ``n``-position mesh on card ``i`` mod the
    cards present."""
    return [torch.device("cuda", i % torch.cuda.device_count())
            for i in range(n)]


def mesh_path(g, oracle, dev, q):
    """The main graph's cached fused plan counted on a device mesh of
    ``q * q`` positions, position ``i`` on card ``i`` mod the cards
    present (``make_grid_mesh(q, devices=...)``): every shift a copy
    between positions, the sum on the first card.  The count equals the
    oracle, the per-position partials equal the one-device engine's, the
    fused kernel launches once a counted device-step (the counts set to 0
    just before the mesh count), and on each card used one device-step's
    launch equals its plain version.  Then SUMMA 2 x 8, the ring p = 16 and
    2 pods under ``tree`` on meshes of their own, each equal to the
    oracle.  Reports the cards, the warm count's seconds on the mesh and
    on one device, and the bytes each engine phase moved on the mesh."""
    import repro_torch as rt
    from repro_torch.core.cannon import build_cannon_fn
    from repro_torch.core.engine import tally_moved_bytes
    from repro_torch.kernels.tc_fused import (
        count_pair_fused,
        count_pair_fused_plain,
    )
    from repro_torch.kernels.tc_fused import tc_fused as kmod
    from repro_torch.launch.mesh import make_mesh_for

    mesh = rt.make_grid_mesh(q, devices=mesh_cards(q * q))
    cards = sorted({str(d) for d in mesh.devices})
    kmod.reset_launch_count()
    cold = rt.count_triangles(g, mesh, method="fused")
    launches = kmod.launch_count()
    art = cold.artifact
    plan = art.plan
    keep = plan.step_keep
    expect = sum(1 for s in range(q) for x in range(q) for y in range(q)
                 if plan.m_cnt[x, y] > 0 and (keep is None or keep[x, y, s]))
    if not art.cache_hit:
        fail("the mesh path missed the main path's cached plan")
    if launches != expect:
        fail(f"the mesh count launched the fused kernel {launches} times, "
             f"not once for each of the {expect} device-steps that count")
    if cold.triangles != oracle:
        fail(f"the mesh count gave {cold.triangles}, not {oracle}")

    warm_mesh, warm_one = [], []
    for _ in range(MESH_WARM):
        warm_mesh.append(rt.count_triangles(g, mesh, method="fused"))
        warm_one.append(rt.count_triangles(g, q=q, method="fused"))
    if {r.triangles for r in warm_mesh + warm_one} != {oracle}:
        fail("a warm count on the mesh or on one device missed the oracle")
    with tally_moved_bytes() as tally:
        rt.count_triangles(g, mesh, method="fused")
    with tally_moved_bytes() as tally_one:
        rt.count_triangles(g, q=q, method="fused")

    on_mesh = build_cannon_fn(plan, method="fused", reduce_global=False,
                              mesh=mesh)(**art.staged(mesh))
    one = build_cannon_fn(plan, method="fused", reduce_global=False)(
        **art.staged(dev))
    if on_mesh.device != mesh.first or on_mesh.tolist() != one.tolist():
        fail("the mesh's per-position partials differ from one device's")

    staged = art.staged(mesh)
    kw = dict(n_long=plan.n_long, d_small=plan.d_small, dpad_long=plan.dmax,
              chunk=plan.chunk, long_fallback="global")
    per_card = {}
    for pos in np.ndindex(q, q):
        card = str(mesh.device_at(pos))
        if card in per_card or plan.m_cnt[pos] <= 0:
            continue
        args = [staged[k][pos] for k in ("a_indptr", "a_indices", "b_indptr",
                                         "b_indices", "m_ti", "m_tj")]
        got = count_pair_fused(*args, int(plan.m_cnt[pos]), **kw)
        want = count_pair_fused_plain(*args, int(plan.m_cnt[pos]), **kw)
        if str(got.device) != card or int(got) != int(want):
            fail(f"the fused kernel at position {pos} on {card} gave "
                 f"{int(got)} on {got.device}, its plain version {int(want)}")
        per_card[card] = dict(position=list(pos), triangles=int(got))

    others = {}
    for name, m, kw2 in (
            ("summa", make_mesh_for(MESH_SUMMA, ("data", "model"),
                                    devices=mesh_cards(q * q)),
             dict(schedule="summa")),
            ("oned", mesh, dict(schedule="oned")),
            ("pods_tree", rt.make_grid_mesh(
                q, npods=MESH_PODS, devices=mesh_cards(MESH_PODS * q * q)),
             dict(reduce_strategy="tree"))):
        t0 = time.perf_counter()
        r = rt.count_triangles(g, m, method="fused", **kw2)
        warm = rt.count_triangles(g, m, method="fused", **kw2)
        others[name] = dict(grid=list(r.grid), triangles=r.triangles,
                            seconds=time.perf_counter() - t0,
                            warm_count_seconds=warm.count_seconds)
        if r.triangles != oracle or warm.triangles != oracle:
            fail(f"{name} on the mesh gave {r.triangles}, not {oracle}")
    emit("mesh_path", ok=True, cards=cards, positions=q * q,
         device_count=torch.cuda.device_count(), triangles=cold.triangles,
         triangles_scipy_oracle=oracle, kernel_launches=launches,
         device_steps_counted=expect, cold_count_seconds=cold.count_seconds,
         cold_preprocess_seconds=cold.preprocess_seconds,
         warm_count_seconds_mesh=[r.count_seconds for r in warm_mesh],
         warm_count_seconds_one_device=[r.count_seconds for r in warm_one],
         moved_bytes_mesh=tally, moved_bytes_one_device=tally_one,
         partials_equal=True, kernel_per_card=per_card, **others)


# ----------------------------------------------------------------------
# the runtime on a device mesh
# ----------------------------------------------------------------------
MESH_SPLIT_KINDS = ("cannon", "oned")  # --time-split on the mesh


@contextlib.contextmanager
def mesh_cli_cards():
    """While the block runs, ``make_grid_mesh(devices=None)`` puts position
    ``i`` on card ``i`` mod the cards present (:func:`mesh_cards`), so
    ``tc_run --mesh`` runs 16 positions on fewer cards."""
    import repro_torch.core.api as api

    own = api.make_grid_mesh

    def on_cards(q, *a, npods=1, devices=None, **kw):
        if devices is None:
            devices = mesh_cards(q * q * npods)
        return own(q, *a, npods=npods, devices=devices, **kw)

    api.make_grid_mesh = on_cards
    try:
        yield
    finally:
        api.make_grid_mesh = own


def mesh_checkpointed_cli(g, oracle, dev, q, graph, cards):
    """``tc_run --mesh --ckpt-dir`` on the ``q x q`` mesh of
    :func:`mesh_cli_cards` at chunk ``CKPT_CHUNK``: with ``CLI_FAULTS``,
    then again in that directory, which resumes at shift ``q``.  Each
    save's bytes and seconds.  Returns the record and its failed checks."""
    bad, runs = [], {}
    with tempfile.TemporaryDirectory(prefix="tc_mesh_ckpt_") as tmp:
        faults = os.path.join(tmp, "faults")
        base = ["--graph", graph, "--grid", str(q), "--chunk", str(CKPT_CHUNK),
                "--mesh", "--json"]
        if dev.type == "cpu":
            base += ["--device", "cpu"]
        with cli_hooks(g, graph) as saves, mesh_cli_cards():
            for name, extra in (
                    ("faults", ["--ckpt-dir", faults,
                                "--inject-faults", CLI_FAULTS]),
                    ("resume", ["--ckpt-dir", faults])):
                text, rep, sec = run_cli(base + extra)
                runs[name] = dict(
                    seconds=sec, triangles=rep["triangles"],
                    device=rep.get("device"), ppt_seconds=rep["ppt_seconds"],
                    tct_seconds=rep["tct_seconds"],
                    printed=[ln for ln in text.splitlines()
                             if not ln.startswith("{")],
                    saves=list(saves),
                    restarts=rep.get("supervision_restarts"),
                    fault_log=rep.get("supervision_fault_log"))
                saves.clear()
                if (rep["triangles"] != oracle or not rep.get("checkpointed")
                        or rep.get("device") != ",".join(cards)):
                    bad.append(f"mesh_cli_{name}")
        corrupt = sorted(f for f in os.listdir(faults)
                         if f.endswith(".corrupt"))
    runs["faults"]["corrupt_files"] = corrupt
    if not ((runs["faults"]["restarts"] or 0) >= 1 and corrupt):
        bad.append("mesh_cli_recovery")
    if (f"resumed at shift {q}" not in runs["resume"]["printed"]
            or runs["resume"]["saves"]):
        bad.append("mesh_cli_resume")
    return runs, bad


def mesh_frontends(dev, q, side):
    """``tc_run --mesh --time-split`` (``MESH_SPLIT_KINDS``) on ``side
    ["split"]`` and ``tc_run --mesh --opt`` on ``side["opt"]`` (each a
    ``(spec, graph, oracle)``; chunk ``FRONTEND_CHUNK``), each from a fresh
    plan cache on the mesh of :func:`mesh_cli_cards`.  Returns the
    time splits by schedule, the ``--opt`` record and the failed checks."""
    bad, splits = [], {}
    cpu = ["--device", "cpu"] if dev.type == "cpu" else []
    spec, sg, want = side["split"]
    for kind in MESH_SPLIT_KINDS:
        with fresh_plan_cache(), cli_hooks(sg, spec), mesh_cli_cards():
            _, rep, seconds = run_cli([
                "--graph", spec, "--grid", str(q), "--schedule", kind,
                "--chunk", str(FRONTEND_CHUNK), "--time-split", "--mesh",
                "--json", *cpu])
        keys = ("tct_shift_only", "tct_count_only", "tct_seconds",
                "coll_shift_bytes", "coll_reduce_bytes", "coll_other_bytes")
        splits[kind] = dict({k: rep.get(k) for k in keys}, graph=spec,
                         triangles=rep["triangles"], device=rep["device"],
                         triangles_scipy_oracle=want, seconds=seconds)
        if (rep["triangles"] != want or any(rep.get(k) is None for k in keys)
                or rep["coll_shift_bytes"] <= 0):
            bad.append(f"time_split_{kind}")
    spec, og, want = side["opt"]
    with fresh_plan_cache(), cli_hooks(og, spec), mesh_cli_cards():
        _, rep, seconds = run_cli([
            "--graph", spec, "--grid", str(q), "--chunk", str(FRONTEND_CHUNK),
            "--opt", "--repeat", "2", "--mesh", "--json", *cpu])
    opt = dict(graph=spec, triangles=rep["triangles"],
               triangles_scipy_oracle=want, ppt_seconds=rep["ppt_seconds"],
               tct_seconds=rep["tct_seconds"], device=rep["device"],
               seconds=seconds)
    if rep["triangles"] != want or rep.get("optimized") is not True:
        bad.append("opt")
    return splits, opt, bad


def mesh_degree_rank(g, mesh):
    """``distributed_degree_rank`` over ``mesh``'s positions as a ring,
    shard ``s`` of the degrees on position ``s``'s card, against
    ``degree_order``."""
    from repro_torch.core import degree_order
    from repro_torch.core.engine import MeshArray
    from repro_torch.core.preprocess import distributed_degree_rank

    ring = mesh.reshaped((mesh.size,), ("flat",))
    parts = np.array_split(g.degrees().astype(np.int64), ring.size)
    deg = MeshArray(ring, {(s,): torch.from_numpy(part).to(ring.devices[s])
                           for s, part in enumerate(parts)})
    t0 = time.perf_counter()
    ranks = distributed_degree_rank(deg)
    got = np.concatenate([ranks.blocks[(s,)].cpu().numpy()
                          for s in range(ring.size)])
    seconds = time.perf_counter() - t0
    placed = all(ranks.blocks[(s,)].device == torch.device(ring.devices[s])
                 for s in range(ring.size))
    equal = bool(np.array_equal(got, degree_order(g)))
    return dict(positions=ring.size, n=g.n, seconds=seconds, placed=placed,
                equal=equal, histogram_buckets=g.n + 1)


def mesh_runtime_path(g, oracle, dev, q, graph, side=None):
    """The triangle count's runtime on the ``q x q`` mesh of ``mesh_path``
    (position i on card i mod the cards present), the main graph's fused
    plan reused: ``supervised_count(g, mesh)`` with ``RUNTIME_TRANSIENT``
    (3 restarts, one fused launch a counted device-step) and with the loss
    of ``RUNTIME_LOST`` positions at step 0 (re-planned on 3 x 3 over the
    first 9 positions' cards, one launch a counted device-step of the 3 x 3
    plan, and on each card used one device-step's launch equal to its
    plain version); ``tc_run --mesh --ckpt-dir`` with ``CLI_FAULTS`` and a
    resume (:func:`mesh_checkpointed_cli`); ``tc_run --mesh --time-split``
    and ``--opt`` on the front ends' graphs (:func:`mesh_frontends`; the
    ones ``serve_path`` generated, with their oracles); and
    ``distributed_degree_rank`` over the 16 positions against
    ``degree_order``.  Every count equals its oracle; the phase prints
    its line, then fails on any failed check."""
    import repro_torch as rt
    from repro_torch.kernels.tc_fused import (
        count_pair_fused,
        count_pair_fused_plain,
    )
    from repro_torch.kernels.tc_fused import tc_fused as kmod
    from repro_torch.runtime import FaultPlan, Supervisor, supervised_count

    t_phase = time.perf_counter()
    mesh = rt.make_grid_mesh(q, devices=mesh_cards(q * q))
    cards = list(dict.fromkeys(str(d) for d in mesh.devices))
    bad = []

    def supervised(spec):
        plan = FaultPlan.parse(spec)
        t0 = time.perf_counter()
        kmod.reset_launch_count()
        r = supervised_count(g, mesh, method="fused", fault_plan=plan,
                             supervisor=Supervisor(max_restarts=5))
        return r, kmod.launch_count(), time.perf_counter() - t0

    # 1. transient faults: retried in place on the mesh
    r1, launches1, s1 = supervised(RUNTIME_TRANSIENT)
    steps1 = schedule_device_steps(r1.plan, "cannon")
    faulted = [a for a in r1.supervision["attempts"]
               if a["outcome"] == "fault"]
    transient = dict(spec=RUNTIME_TRANSIENT, seconds=s1,
                     triangles=r1.triangles,
                     restarts=r1.supervision["restarts"],
                     attempts=r1.supervision["attempts"],
                     cache_hit=r1.artifact.cache_hit,
                     kernel_launches=launches1,
                     device_steps_counted=len(steps1),
                     count_seconds=r1.count_seconds, device=r1.device)
    if not (r1.triangles == oracle and r1.supervision["restarts"] == 3
            and [a.get("point") for a in faulted] == [
                "plan_stage", "device_stage", "step"]):
        bad.append("transient")
    if launches1 <= 0 or launches1 != len(steps1):
        bad.append("transient_launches")

    # 2. device loss: re-planned on the first surviving positions
    lost_spec = f"step@0=devicelost:{RUNTIME_LOST}"
    r3, launches3, s3 = supervised(lost_spec)
    steps3 = schedule_device_steps(r3.plan, "cannon")
    r = math.isqrt(q * q - RUNTIME_LOST)
    survivors = mesh.devices[:r * r]
    regrids = r3.supervision["regrids"]
    lost = dict(spec=lost_spec, seconds=s3, triangles=r3.triangles,
                grid=list(r3.grid), regrids=regrids, device=r3.device,
                restarts=r3.supervision["restarts"],
                preprocess_seconds=r3.preprocess_seconds,
                count_seconds=r3.count_seconds, kernel_launches=launches3,
                device_steps_counted=len(steps3))
    if not (r3.triangles == oracle and regrids == [
            dict(lost=RUNTIME_LOST, grid=[r, r], schedule="cannon")]
            and tuple(r3.grid) == (r, r) and r3.device == ",".join(
                dict.fromkeys(str(d) for d in survivors))):
        bad.append("device_lost")
    if launches3 <= 0 or launches3 != len(steps3):
        bad.append("device_lost_launches")
    small = rt.make_grid_mesh(r, devices=survivors)
    plan3 = r3.plan
    staged = r3.artifact.staged(small)
    kw = dict(n_long=plan3.n_long, d_small=plan3.d_small,
              dpad_long=plan3.dmax, chunk=plan3.chunk,
              long_fallback="global")
    per_card = {}
    for pos in np.ndindex(r, r):
        card = str(small.device_at(pos))
        if card in per_card or plan3.m_cnt[pos] <= 0:
            continue
        args = [staged[k][pos] for k in ("a_indptr", "a_indices", "b_indptr",
                                         "b_indices", "m_ti", "m_tj")]
        got = count_pair_fused(*args, int(plan3.m_cnt[pos]), **kw)
        want = count_pair_fused_plain(*args, int(plan3.m_cnt[pos]), **kw)
        per_card[card] = dict(position=list(pos), triangles=int(got),
                              plain=int(want), on=str(got.device))
        if str(got.device) != card or int(got) != int(want):
            bad.append(f"kernel_at_{card}")
    lost["kernel_per_card"] = per_card

    # 3. the checkpointed stepper on the mesh, through tc_run
    t0 = time.perf_counter()
    cli, cli_bad = mesh_checkpointed_cli(g, oracle, dev, q, graph, cards)
    bad += cli_bad
    cli_s = time.perf_counter() - t0

    # 4. the front ends on the mesh, on serve_path's graphs
    if side is None:
        side = {k: (spec,) + frontend_graph(spec)
                for k, spec in (("split", SPLIT_GRAPH), ("opt", OPT_GRAPH))}
    splits, opt, front_bad = mesh_frontends(dev, q, side)
    bad += front_bad

    # 5. the distributed degree rank over the 16 positions
    rank = mesh_degree_rank(g, mesh)
    if not (rank["equal"] and rank["placed"]):
        bad.append("degree_rank")

    emit("mesh_runtime_path", ok=not bad, failed=bad, graph=graph,
         cards=sorted(cards), positions=q * q,
         device_count=torch.cuda.device_count() if dev.type == "cuda" else 0,
         triangles_scipy_oracle=oracle, transient=transient,
         device_lost=lost, checkpointed_cli=cli,
         checkpointed_cli_seconds=cli_s, time_split=splits, opt=opt,
         degree_rank=rank, seconds=time.perf_counter() - t_phase)
    if bad:
        fail(f"the mesh runtime path failed its checks: {bad}")


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
    runs = [("cannon", m) for m in ("search", "global", "fused", "tile",
                                     "dense", "search2", "auto")]
    runs += [(sch, m) for sch in ("summa", "oned")
             for m in ("search", "global", "fused", "auto")]
    rows, bad = [], []
    for name, g in fixtures.items():
        exp = triangle_count_oracle(g)
        for q in (1, 2, 3):
            for schedule, method in runs:
                got = rt.count_triangles(g, q=q, schedule=schedule,
                                         method=method).triangles
                if got != exp:
                    bad.append((name, q, schedule, method, got, exp))
        rows.append(dict(graph=name, triangles=exp))
    emit("small_graphs", ok=not bad, checked=len(fixtures) * 3 * len(runs),
         runs=[f"{sch}/{m}" for sch, m in runs], graphs=rows,
         mismatches=bad)
    if bad:
        fail(f"small graphs disagree with the oracle: {bad}")


# ----------------------------------------------------------------------
# tile path: kernels vs plain versions, the path, the kernels' rows
# ----------------------------------------------------------------------
def _random_tiles(rng, n, density):
    """``n`` random 128x128-bit tiles as int32 bit patterns."""
    bits = (rng.random((n, 128, 4, 32)) < density).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(axis=-1)
    return words.astype(np.uint32).view(np.int32)


# one set mask bit at each of these (i, j): the corners of the 16x8 output
# blocks of the tensor-core kernel, the word and strip boundaries, and
# (0, 127), bit 31 of word 3
SINGLE_BITS = ((0, 0), (15, 7), (16, 8), (127, 127), (31, 32), (32, 31),
               (0, 127))
# mask densities whose set-bit counts (about 16 to 16,000 a tile) straddle
# the popcount kernel's dense-route threshold
ROUTE_DENSITIES = (0.001, 0.05, 0.2, 0.45, 0.7, 0.98)
# triples of the ragged trap: prime and above twice the most warps a grid
# of this card can hold (132 SMs x 64), so every warp loops and none of the
# grid's warp counts divides it
RAGGED = 20011


def _one_bit_tiles(cells):
    """One mask tile per ``(i, j)`` of ``cells``, that bit alone set."""
    m = np.zeros((len(cells), 128, 4), np.uint32)
    for k, (i, j) in enumerate(cells):
        m[k, i, j // 32] = np.uint32(1) << np.uint32(j % 32)
    return m.view(np.int32)


def tile_trap_cases(seed=0, ragged=RAGGED):
    """name -> (triples, a, b, m), numpy int32, tiles as bit patterns:
    densities 0.02 / 0.3 / 0.9 with every third triple invalid;
    ``valid == 0`` on real slots; every bit set, and bit 31 alone, each
    with a padding triple on the full slot 0; ``G = 1``; many triples
    naming one slot, padded as the planner pads; ``G = 0``; one set mask
    bit at each of ``SINGLE_BITS``; one set bit in every 16x8 block; an
    empty mask on a valid triple; ``ragged`` triples on a few slots;
    set-bit counts on both sides of the popcount kernel's dense-route
    threshold in one launch.  ``tests/test_torch_tile.py`` takes its edge
    cases from here."""
    rng = np.random.default_rng(seed)
    out = {}
    for density in (0.02, 0.3, 0.9):
        a, b = _random_tiles(rng, 8, density), _random_tiles(rng, 8, density)
        m = _random_tiles(rng, 8, min(0.5, 2 * density))
        trips = rng.integers(0, 8, size=(200, 4)).astype(np.int32)
        trips[:, 3] = (np.arange(200) % 3 != 2)
        out[f"density_{density}"] = (trips, a, b, m)
    a, b, m = (_random_tiles(rng, 4, 0.5) for _ in range(3))
    out["invalid_real_slots"] = (
        np.array([[3, 3, 3, 0], [1, 2, 0, 0], [0, 0, 0, 0], [2, 1, 3, 1]],
                 np.int32), a, b, m)
    full = np.full((2, 128, 4), -1, np.int32)  # every bit, bit 31 included
    top = np.full((2, 128, 4), np.int32(-2**31), np.int32)  # bit 31 alone
    for name, t in (("all_bits", full), ("bit31_only", top)):
        out[name] = (np.array([[0, 1, 0, 1], [1, 0, 1, 1], [0, 0, 0, 0]],
                              np.int32), t, t, t)
    out["one_triple"] = (np.array([[1, 2, 3, 1]], np.int32), a, b, m)
    same = np.zeros((513, 4), np.int32)
    same[:500] = (2, 2, 2, 1)  # 500 triples on one slot, 13 padding ones
    out["one_slot"] = (same, a, b, m)
    out["no_triples"] = (np.zeros((0, 4), np.int32), a, b, m)
    out["single_bits"] = (
        np.array([(k % 4, (k + 1) % 4, k, 1) for k in range(len(SINGLE_BITS))],
                 np.int32), a, b, _one_bit_tiles(SINGLE_BITS))
    per_block = _one_bit_tiles([(16 * s + (3 * s + c) % 16, 8 * c + (s + 5 * c) % 8)
                                for s in range(8) for c in range(16)])
    out["one_bit_per_block"] = (
        np.array([[0, 1, 0, 1], [3, 2, 0, 1]], np.int32), a, b,
        np.bitwise_or.reduce(per_block, axis=0)[None])
    out["empty_mask_valid"] = (np.array([[1, 2, 0, 1], [0, 0, 0, 0]], np.int32),
                               a, b, np.zeros((1, 128, 4), np.int32))
    pattern = np.array([[2, 2, 2, 1], [1, 3, 0, 1], [0, 0, 0, 0],
                        [3, 1, 1, 1], [2, 2, 2, 0]], np.int32)
    out["ragged_one_slot"] = (np.resize(pattern, (ragged, 4)), a, b, m)
    routes = np.concatenate([_random_tiles(rng, 1, d) for d in ROUTE_DENSITIES])
    trips = np.array([(k % 3, (k + 1) % 3, k, 1)
                      for k in range(len(ROUTE_DENSITIES))] * 2, np.int32)
    trips[-1, 3] = 0
    out["both_routes"] = (trips, _random_tiles(rng, 3, 0.3),
                          _random_tiles(rng, 3, 0.3), routes)
    return out


def _set_bits(tiles):
    """Set bits of each int32 bit-pattern tile, numpy ``(N,)``."""
    return np.unpackbits(np.ascontiguousarray(tiles).view(np.uint8)
                         .reshape(tiles.shape[0], -1), axis=1).sum(
                             axis=1, dtype=np.int64)


def run_tile_traps(dev):
    from repro_torch.kernels.tc_tile import (
        MODES,
        tile_triple_counts,
        tile_triple_counts_plain,
        tile_triple_counts_ref,
    )
    from repro_torch.kernels.tc_tile.tc_tile import dense_threshold

    checked = 0
    for name, (trips, a, b, m) in tile_trap_cases().items():
        if name == "both_routes":
            bits = _set_bits(m)[trips[trips[:, 3] > 0, 2]]
            if not bits.min() <= dense_threshold() < bits.max():
                fail(f"tile trap {name}: set bits {bits.tolist()} do not "
                     f"straddle the dense threshold {dense_threshold()}")
        host = [torch.from_numpy(np.ascontiguousarray(v))
                for v in (trips, a, b, m)]
        # the int64 einsum reference runs on the CPU, once per distinct triple
        if trips.shape[0]:
            uniq, inv = torch.unique(host[0], dim=0, return_inverse=True)
            ref = tile_triple_counts_ref(uniq, *host[1:])[inv].to(dev)
        else:
            ref = torch.zeros(0, dtype=torch.int64, device=dev)
        t = [v.to(dev) for v in host]
        for mode in MODES:
            got = tile_triple_counts(*t, mode=mode)
            want = tile_triple_counts_plain(*t, mode=mode)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"tile trap {name} mode={mode}: kernel != plain version")
            if not torch.equal(got.long(), ref):
                fail(f"tile trap {name} mode={mode}: kernel != reference")
            checked += 1
    emit("tile_traps", ok=True, checked=checked,
         dense_threshold=dense_threshold())


def tile_step_inputs(staged, x, y, step, q):
    """What logical device ``(x, y)`` hands the tile kernels at Cannon step
    ``step``: after ``step`` shifts it holds A of ``(x, y + step)`` and B
    of ``(x + step, y)``; the mask and the triples stay put."""
    return (
        staged["triples"][x, y, step],
        staged["a_tiles"][x, (y + step) % q],
        staged["b_tiles"][(x + step) % q, y],
        staged["m_tiles"][x, y],
    )


def live_blocks_per_tile(m, chunk=4096):
    """``(N,)`` int64: the 16x8 output blocks of each mask tile that hold a
    set bit (the blocks the mxu kernel issues an MMA for)."""
    from repro_torch.kernels.tc_tile import unpack_bits_tile

    parts = []
    for k0 in range(0, m.shape[0], chunk):
        bits = unpack_bits_tile(m[k0:k0 + chunk], torch.uint8)
        live = bits.reshape(-1, 8, 16, 16, 8).amax(dim=(2, 4))
        parts.append(live.sum(dim=(1, 2), dtype=torch.int64))
    return torch.cat(parts)


def tile_kernel_bound(args, mode):
    """Least time the card could take for the function one call computes.

    Bytes, each counted once: every distinct tile the valid triples name
    (2 KiB each), 16 B a triple and 4 B an output, over the memory rate.
    Operations, what this call's data needs: the function sums
    ``popcount(A[i] & B[j])`` only where mask bit ``(i, j)`` is set, so 4
    AND+popc (one a word) per set mask bit of a valid triple, over the SM
    population-count rate.  Both modes compute the same function and
    share this bound.

    ``formulation_bound_ms`` is another quantity and no bound: the time of
    the kernel's own formulation.  Both read each valid triple's whole
    mask tile to find its set bits (2 KiB a triple, counted per triple, on
    top of the bytes above); popcount then does the 4 AND+popc of each set
    bit over the popc rate.  mxu issues one b1 MMA (16·8·128 AND+popc) for
    each of the ``live_blocks`` 16x8 blocks that hold a set bit; no b1
    tensor-core rate is published for the H100, so its formulation counts
    the bytes alone and ``formulation_operations`` is None."""
    from repro_torch.kernels.tc_tile.tc_tile import popcount32

    trips, a, b, m = args
    v = trips[:, 3] > 0
    n_valid = int(v.sum())
    slots = trips[v, 2].long()
    tiles = sum(int(torch.unique(trips[v, k]).numel()) for k in range(3))
    nbytes = tiles * TILE_BYTES + 16 * trips.shape[0] + 4 * trips.shape[0]
    mask_bits = int(popcount32(m).sum(dim=(1, 2))[slots].sum())
    live_blocks = int(live_blocks_per_tile(m)[slots].sum())
    ops = 4 * mask_bits
    f_ops = ops if mode == "popcount" else None
    f_bytes = nbytes + n_valid * TILE_BYTES
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / POPC_OPS_PER_S * 1e3
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=int(nbytes), operations=int(ops), valid_triples=n_valid,
        distinct_tiles=tiles, set_mask_bits=mask_bits,
        live_blocks=live_blocks,
        formulation_bytes=int(f_bytes),
        formulation_operations=f_ops,
        formulation_bound_ms=max(f_bytes / HBM_BYTES_PER_S * 1e3,
                                 (f_ops or 0) / POPC_OPS_PER_S * 1e3),
    )


def bmm_library_ms(args, chunk=8192):
    """``torch.bmm`` over the step's valid triples, both tiles pre-unpacked
    to 0/1 bf16 outside the timing, one chunk at a time; the event times
    of the chunks' products summed."""
    from repro_torch.kernels.tc_tile import unpack_bits_tile

    trips, a, b, _ = args
    trips = trips[trips[:, 3] > 0].long()
    total = 0.0
    for g0 in range(0, trips.shape[0], chunk):
        t = trips[g0:g0 + chunk]
        ua = unpack_bits_tile(a[t[:, 0]], torch.bfloat16)
        ub = unpack_bits_tile(b[t[:, 1]], torch.bfloat16).transpose(1, 2)
        torch.bmm(ua, ub)  # warm-up of this shape
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.bmm(ua, ub)
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
        del ua, ub
    return total


def tile_kernel_report(art, staged, dev, mode, launches):
    """Holds the ``mode`` kernel against its plain version on every
    device-step the tile path ran (exact equality per triple) and times
    the first of them, logical device (0, 0) at step 0 where it ran."""
    from repro_torch.kernels.tc_tile import (
        tile_triple_counts,
        tile_triple_counts_plain,
    )
    plan = art.plan
    q = plan.q
    keep = plan.step_keep
    ran = [(x, y, s) for s in range(q) for x in range(q) for y in range(q)
           if int(plan.m_cnt[x, y]) > 0 and (keep is None or keep[x, y, s])]
    max_abs_err, unequal, step_ms = 0, [], []
    t0 = time.perf_counter()
    for x, y, s in ran:
        args = tile_step_inputs(staged, x, y, s, q)
        got = tile_triple_counts(*args, mode=mode)
        want = tile_triple_counts_plain(*args, mode=mode)
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_abs_err = max(max_abs_err, err)
        if err or got.shape != want.shape:
            unequal.append((x, y, s))
        del want
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        tile_triple_counts(*args, mode=mode)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    compare_s = time.perf_counter() - t0
    equal = not unequal

    x, y, s = ran[0]
    args = tile_step_inputs(staged, x, y, s, q)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = time_cold(lambda: tile_triple_counts(*args, mode=mode), 10, flush)
    plain_ms = time_cold(
        lambda: tile_triple_counts_plain(*args, mode=mode), 2, flush
    )
    rec = dict(
        name=f"tc_tile.tile_triple_counts[{mode}]",
        route="cuda",
        source=TILE_SOURCE,
        replaces=TILE_REPLACES[mode],
        launches=launches,
        max_abs_err=max_abs_err,
        equal=equal,
        compared_device_steps=len(ran),
        compare_seconds=compare_s,
        tolerance="exact (integer counts, per triple)",
        ms=ms,
        plain_ms=plain_ms,
        timed=f"logical device ({x}, {y}), step {s}",
        all_steps_ms=float(sum(step_ms)),
        all_steps_note="one warm launch on each device-step the path ran, "
                       "event-timed and summed: the kernel's time in a count",
        shape=dict(triples=int(args[0].shape[0]), nt_pad=int(args[1].shape[0])),
    )
    if mode == "popcount":
        rec.update(library_ms=None,
                   library_note="no PyTorch call computes a masked popcount "
                                "of ANDed bit rows")
    else:
        rec.update(library_ms=bmm_library_ms(args),
                   library_note="torch.bmm of the step's valid tile pairs, "
                                "pre-unpacked to bf16: the product only, "
                                "no unpack, no mask")
    rec.update(tile_kernel_bound(args, mode))
    rec["bound_share"] = rec["bound_ms"] / ms if ms > 0 else None
    if not equal:
        print(json.dumps({"kernels": [rec]}), flush=True)
        fail(f"tile kernel {mode} != plain version at the tile path's "
             f"shapes, device-steps (x, y, step) {unequal}")
    return rec


def tile_path(scale, seed, q, dev):
    """The tile path end to end, then both tile kernels' rows."""
    import repro_torch as rt
    from repro_torch.core.cannon import build_cannon_tile_fn
    from repro_torch.kernels.tc_tile import tc_tile as tmod
    from repro_torch.pipeline import default_cache

    def no_build():
        fail("the tile plan was not memoised on the artifact")

    t0 = time.perf_counter()
    g = rt.rmat(scale, EDGE_FACTOR, seed=seed)
    gen_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    tmod.reset_launch_count()
    r = rt.count_triangles(g, q=q, method="tile")
    launches = {"popcount": tmod.launch_count("popcount")}
    peak = torch.cuda.max_memory_allocated()
    if launches["popcount"] <= 0 or tmod.launch_count("mxu"):
        fail(f"method='tile' launched {tmod.LAUNCHES}: popcount only expected")

    hits0 = default_cache().hits
    r2 = rt.count_triangles(g, q=q, method="tile")
    cache_hit = (bool(r2.artifact.cache_hit) and r2.artifact is r.artifact
                 and default_cache().hits > hits0)
    if not cache_hit:
        fail("second tile count of the same graph missed the plan cache")
    prof = profile_count(lambda: rt.count_triangles(g, q=q, method="tile"),
                         launches["popcount"], kernel="tile_popcount_kernel",
                         label="popcount")

    art = r.artifact
    tp = art.memo("tile_plan", no_build)
    staged = art.memo(("tile_staged", str(dev)), no_build)
    fn_mxu = build_cannon_tile_fn(art, mode="mxu")
    tmod.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mxu = int(fn_mxu(**staged))
    mxu_s = time.perf_counter() - t0
    launches["mxu"] = tmod.launch_count("mxu")
    if launches["mxu"] <= 0 or tmod.launch_count("popcount"):
        fail(f"the mxu tile fn launched {tmod.LAUNCHES}: mxu only expected")
    t0 = time.perf_counter()
    mxu_warm = int(fn_mxu(**staged))
    mxu_warm_s = time.perf_counter() - t0

    rs = rt.count_triangles(g, q=q, method="search", chunk=8192)
    t0 = time.perf_counter()
    oracle = scipy_triangle_oracle(g.n, g.edges)
    oracle_s = time.perf_counter() - t0

    plan = r.plan
    sk = plan.step_keep
    info = dict(
        graph=f"rmat:{scale},{EDGE_FACTOR},{seed}", n=g.n, m=g.m, q=q,
        logical_devices=q * q, device=r.device,
        triangles=r.triangles, triangles_repeat=r2.triangles,
        triangles_mxu=mxu, triangles_mxu_repeat=mxu_warm,
        triangles_search=rs.triangles, triangles_scipy_oracle=oracle,
        generate_seconds=gen_s, oracle_seconds=oracle_s,
        preprocess_seconds=r.preprocess_seconds,
        stage_seconds={k: float(v) for k, v in art.stage_seconds.items()},
        count_seconds=r.count_seconds,
        warm_preprocess_seconds=r2.preprocess_seconds,
        warm_count_seconds=r2.count_seconds,
        mxu_count_seconds=mxu_s, mxu_warm_count_seconds=mxu_warm_s,
        search_count_seconds=rs.count_seconds,
        tile_stats=tp.stats, nt_pad=tp.nt_pad, trip_pad=tp.trip_pad,
        skew_perm=plan.skew_perm,
        schedule_steps=int(sk.size), skipped_steps=int(sk.size - sk.sum()),
        launches_per_count=launches, cache_hit=cache_hit,
        peak_device_bytes=int(peak),
        warm_popcount_count_profile=prof,
    )
    ok = (r.triangles == r2.triangles == mxu == mxu_warm == rs.triangles
          == oracle)
    emit("tile_path", ok=ok, **info)
    if not ok:
        fail("tile path counts disagree (popcount / mxu / search / scipy)")
    return [tile_kernel_report(art, staged, dev, mode, launches[mode])
            for mode in ("popcount", "mxu")]




# ----------------------------------------------------------------------
# tile kernels across mask densities (a synthetic device-step)
# ----------------------------------------------------------------------
DENSITY_TRIPLES = 349_932  # trip_pad of the tile path at rmat(18, 16), q = 4
DENSITY_TILES = 4_096
DENSITY_AB = 0.3
DENSITIES = (0.0003, 0.01, 0.1, 0.5)


def _crossing(xs, u, v):
    """Where ``u - v`` changes sign along ``xs``, interpolated linearly
    between the two measured points around it; None if it never does."""
    for k in range(len(xs) - 1):
        d0, d1 = u[k] - v[k], u[k + 1] - v[k + 1]
        if (d0 <= 0 < d1) or (d1 <= 0 < d0):
            return xs[k] + (xs[k + 1] - xs[k]) * d0 / (d0 - d1)
    return None


def tile_density(dev, seed):
    """Both tile kernels on one synthetic device-step of the tile path's
    size: ``DENSITY_TRIPLES`` valid triples on random slots (ordered by A
    slot, as the planner orders them) of ``DENSITY_TILES``-tile stores, A
    and B at bit density 0.3, the mask at each of ``DENSITIES``.  Each
    kernel equals the plain popcount version on every triple, and the mxu
    kernel the plain mxu version on the first 8,192; each is timed
    cold-L2, median of 10.  ``mxu_crossing_set_bits`` is the set-bit count
    per triple where popcount's time crosses mxu's."""
    from repro_torch.kernels.tc_tile import (
        MODES,
        tile_triple_counts,
        tile_triple_counts_plain,
    )
    from repro_torch.kernels.tc_tile.tc_tile import dense_threshold

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(_random_tiles(rng, DENSITY_TILES, DENSITY_AB))
            .to(dev) for _ in range(2))
    trips = rng.integers(0, DENSITY_TILES, size=(DENSITY_TRIPLES, 4))
    trips[:, 3] = 1
    trips = torch.from_numpy(
        trips[np.argsort(trips[:, 0], kind="stable")].astype(np.int32)
    ).to(dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows, bad = [], []
    for density in DENSITIES:
        m_host = _random_tiles(rng, DENSITY_TILES, density)
        m = torch.from_numpy(m_host).to(dev)
        args = (trips, a, b, m)
        want = tile_triple_counts_plain(*args, mode="popcount")
        head = [t[:8192] if k == 0 else t for k, t in enumerate(args)]
        if not torch.equal(tile_triple_counts(*head, mode="mxu"),
                           tile_triple_counts_plain(*head, mode="mxu")):
            bad.append((density, "mxu vs plain mxu"))
        bits = torch.from_numpy(_set_bits(m_host)).to(dev)[trips[:, 2].long()]
        live = live_blocks_per_tile(m)[trips[:, 2].long()]
        row = dict(mask_density=density,
                   set_bits_per_triple=float(bits.double().mean()),
                   dense_route_triples=int((bits > dense_threshold()).sum()),
                   live_blocks_per_triple=float(live.double().mean()))
        for mode in MODES:
            def fn(mode=mode):
                return tile_triple_counts(*args, mode=mode)
            if not torch.equal(fn(), want):
                bad.append((density, mode))
            row[f"{mode}_ms"] = time_cold(fn, 10, flush)
        row.update({k: v for k, v in tile_kernel_bound(args, "mxu").items()
                    if k in ("bound_ms", "bound_by", "live_blocks",
                             "set_mask_bits")})
        rows.append(row)
        del m, want
    xs = [r["set_bits_per_triple"] for r in rows]
    emit("tile_density", ok=not bad, triples=DENSITY_TRIPLES,
         tiles=DENSITY_TILES, ab_density=DENSITY_AB,
         dense_threshold=dense_threshold(),
         mxu_crossing_set_bits=_crossing(
             xs, [r["mxu_ms"] for r in rows], [r["popcount_ms"] for r in rows]),
         timed="cold L2, median of 10", rows=rows, mismatches=bad,
         seconds=time.perf_counter() - t0)
    if bad:
        fail(f"tile_density: kernels != plain versions at {bad}")


# ----------------------------------------------------------------------
# the dry run of the paper's graphs, and the substrate
# ----------------------------------------------------------------------
DRYRUN_EXTRA = (("tc-twitter", "cannonopt", "pod"),
                ("tc-twitter", "cannon2l", "pod"))
# four model cells of the dry run's 70, walked on meta beside the graphs
DRYRUN_MODEL = (("qwen2-0.5b", "train_4k", "pod"),
                ("deepseek-v3-671b", "decode_32k", "pod"),
                ("equiformer-v2", "molecule", "pod"),
                ("dlrm-mlperf", "train_batch", "pod"))
DRYRUN_REAL_SCALE = 16  # the walk against a real count: rmat(16, 16, 1)
DRYRUN_UNDER = 0.10  # the walk may under-predict the measured peak by this


def walk_sizing(cfg, shape, measured, excluded=0):
    """The dry run's walk of a model step that a phase has just run on the
    card (:func:`repro_torch.launch.dryrun.walk_cell`, on meta tensors: an
    LM step combined from small depths and microbatch counts, any other
    walked whole) against that step's measured peak: ``measured`` is
    ``max_memory_allocated`` over the bytes live before it, and
    ``excluded`` the bytes of the walk's arguments that were live already
    (a batch staged before the measurement).  ``under``: the walk more
    than ``DRYRUN_UNDER`` below the measured peak; where the walk is over
    it, by how much.  Returns ``(row, walk)``."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    walk, _ = dryrun.walk_cell(cfg, shape)
    seconds = time.perf_counter() - t0
    peak = walk.peak_bytes - excluded
    row = dict(shape=shape, walks=walk.walks, walk_seconds=seconds,
               walk_peak=peak, measured_peak=measured,
               walk_over_measured=peak / measured if measured else None,
               segment_peaks=walk.segment_peaks, walk_flops=walk.flops,
               under=bool(measured and peak < (1 - DRYRUN_UNDER) * measured))
    if measured and peak > measured:
        row.update(over_by_bytes=peak - measured,
                   over_by_share=peak / measured - 1)
    return row, walk


def sizing_fail(what, row):
    """Fail where :func:`walk_sizing`'s walk is more than
    ``DRYRUN_UNDER`` below the card's peak."""
    if row["under"]:
        fail(f"{what}: the dry run's walk under-predicts the card's peak: "
             f"{row['walk_peak']} bytes against {row['measured_peak']} "
             f"({row['walk_over_measured']:.4f} of it)")


def dryrun_real_plan(dev, scale, q):
    """The walk of a real plan's count (``method="search"``, chunk 8,192)
    against the count on the card: the walk's staged bytes against the
    staged CUDA tensors (``==``), and its peak against
    ``torch.cuda.max_memory_allocated()`` over one count after
    ``reset_peak_memory_stats`` (the staged tensors plus the count's own
    peak)."""
    import repro_torch as rt
    from repro_torch.core.cannon import build_cannon_fn
    from repro_torch.launch.roofline import walk_engine

    g = rt.rmat(scale, EDGE_FACTOR, seed=1)
    r = rt.count_triangles(g, q=q, method="search", chunk=8192)
    art = r.artifact
    staged = art.staged(dev)
    fn = build_cannon_fn(art, method="search")
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in staged.items()}
    t0 = time.perf_counter()
    walk = walk_engine(fn, meta)
    walk_s = time.perf_counter() - t0
    staged_bytes = sum(v.numel() * v.element_size() for v in staged.values())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    total = int(fn(**staged))
    torch.cuda.synchronize()
    own = int(torch.cuda.max_memory_allocated() - before)
    measured = staged_bytes + own
    oracle = scipy_triangle_oracle(g.n, g.edges)
    ndev = q * q
    return dict(
        graph=f"rmat:{scale},{EDGE_FACTOR},1", q=q, method="search",
        chunk=art.plan.chunk, triangles=total, triangles_scipy_oracle=oracle,
        walk_seconds=walk_s, device_steps_walked=walk.device_steps,
        staged_bytes_cuda=staged_bytes, walk_staged_bytes=walk.staged_bytes,
        walk_args_per_device=walk.args_per_device,
        args_equal=(walk.staged_bytes == staged_bytes
                    == walk.args_per_device * ndev),
        walk_temps=walk.step_temps, walk_grid_bytes=walk.peak_bytes,
        count_own_peak_cuda=own, measured_peak=measured,
        walk_over_measured=walk.peak_bytes / measured,
    )


def dryrun_path(dev, main_plan, scale, real_scale=DRYRUN_REAL_SCALE,
                q=GRID):
    """``repro_torch.launch.dryrun``'s 18 triangle-count cells, Twitter's
    ``cannonopt`` and ``cannon2l`` and four model cells
    (``DRYRUN_MODEL``) in this process, each walked on meta tensors (no
    card memory), one ``dryrun_cell`` line each; the walk of a real plan
    against the card (:func:`dryrun_real_plan`); and the analytic plan of
    the main graph beside its real plan (the paper's balance assumption,
    1.25 slack).  The model walks are held to the card where their steps
    run: :func:`walk_sizing` in ``lm_train_path``, ``recsys_path`` and
    ``gnn_path``."""
    from repro_torch.configs import TC_GRAPHS
    from repro_torch.core.plan import analytic_plan
    from repro_torch.launch import dryrun

    bad = []
    t0 = time.perf_counter()
    cells = [c for c in dryrun.all_cells() if c[0] in TC_GRAPHS]
    cells += list(DRYRUN_EXTRA) + list(DRYRUN_MODEL)
    seconds = {}
    for cell in cells:
        t = time.perf_counter()
        try:
            row = dryrun.run_cell(*cell)
            row["status"] = "ok"
        except Exception as e:  # noqa: BLE001 — report every cell, then fail
            row = {"name": ":".join(cell), "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            bad.append(row["name"])
        seconds[":".join(cell)] = time.perf_counter() - t
        emit("dryrun_cell", **row)
    cells_s = time.perf_counter() - t0
    real = dryrun_real_plan(dev, real_scale, q)
    n, m = main_plan.n, main_plan.m
    dmax_est = max(64, int(4 * math.sqrt(m) / q))  # tc_graphs' budget at q
    ana = analytic_plan(n, m, q, dmax_block=dmax_est)
    balance = {f: dict(analytic=getattr(ana, f), real=getattr(main_plan, f),
                       real_over_analytic=getattr(main_plan, f)
                       / getattr(ana, f))
               for f in ("nnz_pad", "tmax", "dmax")}
    under = real["walk_over_measured"] < 1 - DRYRUN_UNDER
    right = real["triangles"] == real["triangles_scipy_oracle"]
    ok = not bad and real["args_equal"] and not under and right
    emit("dryrun_path", ok=ok, cells=len(cells), failed_cells=bad,
         cells_seconds=cells_s,
         model_cell_seconds={k: v for k, v in seconds.items()
                             if k in {":".join(c) for c in DRYRUN_MODEL}},
         real_plan=real,
         main_graph=dict(graph=f"rmat:{scale},{EDGE_FACTOR},1", n=n, m=m,
                         q=q, dmax_block_est=dmax_est, **balance))
    if bad:
        fail(f"dry-run cells failed: {bad}")
    if not real["args_equal"]:
        fail("the walk's staged bytes differ from the staged CUDA tensors'")
    if under:
        fail(f"the walk under-predicts the measured peak: "
             f"{real['walk_over_measured']:.4f} of it")
    if not right:
        fail("the real plan's count differs from the scipy oracle")


SUBSTRATE_STEPS = 20
# float32 on two devices: reduction order and the last bit of a division
# or an rsqrt differ; the tests' tolerances.  A sparse op's sums are added
# in another order on the card (atomics), so its error is held to
# SPARSE_TOL of the sum of the absolute terms (the op on |inputs|), not
# of a result that cancels
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
SPARSE_TOL = 1e-6


def _substrate_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(256, 128)).astype(np.float32),
              "b": rng.normal(size=(128,)).astype(np.float32),
              "t": rng.normal(size=(4, 16, 32)).astype(np.float32)}
    grads = [{k: (np.random.default_rng(100 + i).normal(size=v.shape)
                  * (1 + i % 5)).astype(np.float32)
              for k, v in params.items()} for i in range(SUBSTRATE_STEPS)]
    return params, grads


def _tree_err(a, b):
    """Largest |a - b| / (atol + rtol |b|) over two trees of tensors (1.0
    is the tolerance's edge)."""
    if isinstance(a, dict):
        return max(_tree_err(a[k], b[k]) for k in a)
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).abs() / (OPT_ATOL + OPT_RTOL * b.abs())).max())


def substrate_path(dev):
    """The optimisers, the compressed sum, the segment ops and
    ``embedding_bag`` on the card, each against the same call on the CPU:
    20 AdamW and 20 Adafactor steps (params and states within the tests'
    ``rtol=1e-6, atol=1e-7``), ``compressed_psum`` over 4 replicas
    (``==``), ``segment_sum`` / ``segment_softmax`` / ``degree`` /
    ``spmm_edges`` and ``embedding_bag`` within ``1e-6`` of one plus the
    sum of the absolute terms (``err_over_tol``; ``rel_err_over_tol``
    holds the error to one plus the result's own magnitude)."""
    import repro_torch.optim as to
    import repro_torch.sparse as tsp
    from repro_torch.sparse.embedding_bag import flatten_ids, table_offsets

    cpu = torch.device("cpu")
    params0, grads = _substrate_inputs()
    rows, bad = {}, []
    for name in ("adamw", "adafactor"):
        out = []
        for d in (dev, cpu):
            init, update = to.make_optimizer(
                name, to.cosine_schedule(0.01, 5, SUBSTRATE_STEPS))
            p = {k: torch.from_numpy(v).to(d) for k, v in params0.items()}
            s = init(p)
            for i, g in enumerate(grads):
                p, s, _ = update({k: torch.from_numpy(v).to(d)
                                  for k, v in g.items()}, s, p, i)
            out.append((p, s))
        err = max(_tree_err(out[0][0], out[1][0]),
                  _tree_err(out[0][1], out[1][1]))
        rows[name] = dict(steps=SUBSTRATE_STEPS, err_over_tol=err)
        if not err <= 1.0:
            bad.append(name)

    x = np.random.default_rng(1).normal(size=(4, 3000)).astype(np.float32)
    sums = [to.compressed_psum({"w": torch.from_numpy(x).to(d)})["w"].cpu()
            for d in (dev, cpu)]
    equal = torch.equal(sums[0], sums[1])
    rows["compressed_psum"] = dict(replicas=4, numel=3000, equal=equal,
                                   rel_err_to_plain_sum=float(
                                       (sums[0] - torch.from_numpy(x).sum(0))
                                       .norm() / torch.from_numpy(x).sum(0)
                                       .norm()))
    if not equal:
        bad.append("compressed_psum")

    rng = np.random.default_rng(2)
    n, e = 1000, 20000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    w = rng.normal(size=(e,)).astype(np.float32)
    sizes = (700, 13, 5000)
    table = rng.normal(size=(sum(sizes), 32)).astype(np.float32)
    ids = np.stack([rng.integers(0, s, size=(64, 4)) for s in sizes],
                   axis=1).astype(np.int32)

    def sparse_ops(d, absolute=False):
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.abs(a) if absolute and a.dtype == np.float32 else a).to(d)
        out = {
            "segment_sum": tsp.segment_sum(t(feats[src]), t(dst), n),
            "segment_softmax": tsp.segment_softmax(t(w), t(dst), n),
            "degree": tsp.degree(t(dst), n),
        }
        for red in ("sum", "mean", "max"):
            out[f"spmm_{red}"] = tsp.spmm_edges(
                t(feats), t(src), t(dst), n, edge_weight=t(w), reduce=red)
        flat = flatten_ids(t(ids), table_offsets(sizes))
        for comb in ("sum", "mean", "max"):
            out[f"embedding_bag_{comb}"] = tsp.embedding_bag(
                t(table), flat, combiner=comb)
        return {k: v.cpu() for k, v in out.items()}

    on_card, on_cpu = sparse_ops(dev), sparse_ops(cpu)
    magnitude = sparse_ops(cpu, absolute=True)
    for k in on_card:
        a, b = on_card[k], on_cpu[k]
        fin = torch.isfinite(b)
        same_inf = torch.equal(torch.isfinite(a), fin) and torch.equal(
            a[~fin], b[~fin])
        diff, mag = (a - b)[fin].abs(), b[fin].abs()
        terms = torch.maximum(mag, magnitude[k][fin].abs())
        err = float((diff / (SPARSE_TOL * (1 + terms))).max())
        rel = float((diff / (SPARSE_TOL * (1 + mag))).max())
        rows[k] = dict(shape=list(a.shape), err_over_tol=err,
                       rel_err_over_tol=rel)
        if not (same_inf and err <= 1.0):
            bad.append(k)
    ok = not bad
    emit("substrate_path", ok=ok, device=str(dev), failed=bad,
         rtol=OPT_RTOL, atol=OPT_ATOL, sparse_tol=SPARSE_TOL, **rows)
    if not ok:
        fail(f"substrate ops on the card differ from the CPU: {bad}")


# ----------------------------------------------------------------------
# the LM family's serving path
# ----------------------------------------------------------------------
LM_B, LM_S, LM_MAX_LEN, LM_STEPS = 2, 16, 6, 8  # the model tests' sizes
# the model tests' tolerances, elementwise |card - cpu| <= tol (1 + |cpu|):
# (hidden states and caches, logits / loss / metrics); and the router's tie
LM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2 ** -4, 2 ** -5)}
LM_TIE = {"float32": 1e-5, "bfloat16": 2 ** -7}
LM_FULL = "qwen2-0.5b"
LM_PREFILL_LEN = 2048  # 4 q-chunks x 2 kv-chunks at qwen2's 512 / 1024
LM_PREFILL_REPS = 3
LM_PROMPTS, LM_PROMPT_LEN = 8, 64
LM_GREEDY, LM_SERVE_LEN = 64, 128
# bfloat16 decode against bfloat16 prefill over 24 layers: two schedules
# (one-token decode attention, the chunked causal one) and other product
# shapes round differently at every layer
LM_FULL_TOL = 2 ** -3
# the first decode steps of those prompts, the card held to the CPU (the
# same schedule on both), and again with a planted fault that this check
# must catch.  The tolerance is the tests' bfloat16 one for hidden states
# and caches, for the logits too: 24 layers against the smoke configs'
# two or three add up more rounding differences in the residual stream
LM_CPU_STEPS = 8
LM_FULL_CPU_TOL = 2 ** -4
LM_F32_TOKENS = (2, 16)


def _lm_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _lm_leaves(tree[k])]
    return [tree]


def _lm_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _lm_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# The parity helpers below are shared with the port's model tests, which
# hold the port to the JAX package's outputs (numpy arrays, bfloat16 ones
# too) the way this phase holds the card to the CPU.
def _lm_host(x):
    """``x`` (a tensor, or an array of any float dtype) in float64 on the
    host."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu()
    return torch.from_numpy(np.asarray(x, np.float64))


def lm_err(a, b):
    """Largest ``|a - b| / (1 + |b|)``, on the host in float64."""
    a, b = _lm_host(a), _lm_host(b)
    if a.shape != b.shape:
        fail(f"lm_path: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    return float(((a - b).abs() / (1 + b.abs())).max())


def lm_decided(logits, tol):
    """Rows whose top-two margin exceeds twice the logits' tolerance: no
    rounding within it can swap their argmax."""
    top2 = torch.topk(_lm_host(logits), 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) > 2 * tol * (1 + top2[:, 0].abs())


def _lm_route_key(x):
    """The router input's shape, dtype and bits: a layer's recompute under
    remat hands ``route`` the same bits as its forward did."""
    import hashlib

    bits = x.detach().contiguous().view(torch.uint8).cpu().numpy()
    return (tuple(x.shape), str(x.dtype), hashlib.blake2b(bits).digest())


@contextlib.contextmanager
def lm_routes(records, seen=None):
    """Every ``moe.route`` call of the block, in order: recorded into
    ``records`` (``seen`` None) or handed the recorded choices (the card
    teacher-forced by the CPU, as the tests force the port by the
    reference: a near-tie flip cannot cascade through the experts'
    shared capacity), the port's own choices appended to ``seen``.  A
    record is ``(top_i, probs)``, tensors or arrays.

    While grad is enabled, a call whose router input is bit for bit an
    earlier call's in the block is that layer's recompute under remat (the
    backward re-runs each checkpointed layer): it takes that call's
    record, and adds none — so a train step's records are its forward
    calls only, in order.  A recorded recompute that routes otherwise
    than its forward fails."""
    from repro_torch.models import moe

    own = moe.route
    calls = {}  # router input's key -> index of its record
    count = [0]

    def route(p, x, top_k):
        probs, top_p, top_i = own(p, x, top_k)
        key = _lm_route_key(x) if torch.is_grad_enabled() else None
        k = calls.get(key) if key is not None else None
        fresh = k is None
        if fresh:
            k = count[0]
            count[0] += 1
            if key is not None:
                calls[key] = k
        if seen is None:
            if fresh:
                records.append((top_i.detach().cpu(),
                                probs.detach().cpu()))
            elif not torch.equal(torch.as_tensor(records[k][0]).long(),
                                 top_i.cpu().long()):
                fail("lm_path: a recompute under remat routed otherwise "
                     "than its forward")
            return probs, top_p, top_i
        if k >= len(records):
            fail("lm_path: more router calls than were recorded")
        ref_i = torch.as_tensor(records[k][0]).to(top_i.device, torch.long)
        if ref_i.shape != top_i.shape:
            fail(f"lm_path: router choices of shape {tuple(ref_i.shape)} "
                 f"handed to a call of shape {tuple(top_i.shape)}")
        if fresh:
            seen.append(top_i.cpu())
        chosen = torch.gather(probs, -1, ref_i)
        return probs, chosen / chosen.sum(dim=-1, keepdim=True), ref_i

    moe.route = route
    try:
        yield
    finally:
        moe.route = own
    if seen is not None and count[0] < len(records):
        fail("lm_path: fewer router calls than were recorded")


def lm_flips(records, seen, tie):
    """Router choices in ``seen`` that differ from the recorded ones;
    ``None`` where one is not a tie within ``tie`` of the recorded
    probabilities."""
    flips = 0
    for (ref_i, probs), got in zip(records, seen):
        ref_i, probs = torch.as_tensor(ref_i).long(), torch.as_tensor(probs)
        got = torch.as_tensor(got).long()
        for t in torch.nonzero((ref_i != got).any(dim=-1)).flatten():
            j = int(torch.nonzero(ref_i[t] != got[t])[0])
            a = float(probs[t, ref_i[t, j]])
            b = float(probs[t, got[t, j]])
            if abs(a - b) > tie * max(a, b):
                return None
            flips += 1
    return flips


def _lm_f64(x, device=None):
    """``x`` in float64: on the host (``device`` None), else on ``device``
    (a full-width tree is compared on the card)."""
    if device is None:
        return _lm_host(x)
    return torch.as_tensor(x).detach().to(device, torch.float64)


def step_errs(got, ref, tol, *, lr_t=None, step=0, device=None):
    """One train step's ``(params, opt_state, metrics)`` held to ``ref``'s
    (tensors or numpy arrays, in the same trees): the metrics (``loss``,
    AdamW's ``grad_norm``) as ``|a - b| / (1 + |b|)``; every optimiser
    state leaf (m, v, or Adafactor's vr / vc / v) as ``‖a - b‖ / ‖b‖``;
    the parameters elementwise as ``|a - b| / (1 + |b|)``.  With AdamW
    (``lr_t``, the step's rate, given) the first step from a fresh state
    is sign-like (``m̂ / √v̂`` is ±1 at step 0, ±0.447 at step 2000), so an
    element whose first moment's sign differs between the two — a
    near-zero gradient that rounded the other way — may move the other way
    by up to ``2 · lr_t · |m̂ / √v̂|`` (from ``ref``'s moments); such
    elements over ``tol`` are counted as ``flips``.  ``tol`` maps
    ``loss``, ``grad_norm``, ``states`` and ``params`` to their bounds;
    the comparison runs in float64 on the host or on ``device``.  Returns
    ``(errs, ok)``."""
    gp, go, gm = got
    rp, ro, rm = ref
    f64 = lambda x: _lm_f64(x, device)  # noqa: E731
    errs = {k: lm_err(gm[k], rm[k]) for k in sorted(rm) if k in gm}
    states = 0.0
    for a, b in zip(_lm_leaves(go), _lm_leaves(ro)):
        a, b = f64(a), f64(b)
        if a.shape != b.shape:
            fail(f"train step: state shapes {tuple(a.shape)} and "
                 f"{tuple(b.shape)}")
        states = max(states, float((a - b).norm() / b.norm().clamp_min(1e-30)))
    errs["states"] = states
    adamw = lr_t is not None
    if adamw:
        b1, b2, eps = 0.9, 0.95, 1e-8  # adamw_update's defaults
        bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        moments = zip(_lm_leaves(go["m"]), _lm_leaves(ro["m"]),
                      _lm_leaves(ro["v"]))
    worst, flips = 0.0, 0
    for a, b in zip(_lm_leaves(gp), _lm_leaves(rp)):
        a, b = f64(a), f64(b)
        if a.shape != b.shape:
            fail(f"train step: parameter shapes {tuple(a.shape)} and "
                 f"{tuple(b.shape)}")
        d = (a - b).abs()
        if adamw:
            m_got, m_ref, v_ref = (f64(x) for x in next(moments))
            flipped = torch.sign(m_got) != torch.sign(m_ref)
            slack = 2 * lr_t * (m_ref / bc1).abs() / ((v_ref / bc2).sqrt()
                                                      + eps)
            flips += int((flipped & (d > tol["params"] * (1 + b.abs())))
                         .sum())
            d = torch.where(flipped, (d - slack).clamp_min(0), d)
        worst = max(worst, float((d / (1 + b.abs())).max()))
    errs["params"] = worst
    errs["flips"] = flips
    ok = (set(gm) == set(rm)
          and all(errs[k] <= tol[k] for k in (*rm, "states", "params")))
    return errs, ok


def lm_step_errs(got, ref, cfg, step, tol, device=None):
    """:func:`step_errs` of an LM train step: AdamW's rate is the LM
    step's cosine at ``step`` (Adafactor takes no sign-flip slack)."""
    from repro_torch.optim import cosine_schedule

    lr_t = (float(cosine_schedule(3e-4, 2000, 100_000)(step))
            if cfg.optimizer == "adamw" else None)
    return step_errs(got, ref, tol, lr_t=lr_t, step=step, device=device)


def _lm_smoke_run(cfg, params, dev, tokens, labels, feed):
    """Forward, loss and ``LM_STEPS`` decode steps on ``dev``; the decode
    feeds ``feed`` (the CPU's greedy tokens) where given, else its own."""
    from repro_torch.models import transformer as tr

    t = torch.from_numpy(tokens).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    out = dict(feed=[], step_logits=[], caches=[], greedy=[])
    with torch.no_grad():
        h, aux = tr.lm_forward(params, cfg, t)
        out["hidden"], out["aux"] = h.cpu(), aux.cpu()
        out["logits"] = tr.lm_logits(params, h).cpu()
        loss, metrics = tr.lm_loss(params, cfg, t, lab)
        out["loss"] = loss.cpu()
        out["metrics"] = {k: v.cpu() for k, v in metrics.items()}
        cache = tr.init_kv_cache(cfg, LM_B, LM_MAX_LEN, device=dev)
        tok = t[:, 0]
        for i in range(LM_STEPS):
            if feed is not None:
                tok = feed[i].to(dev)
            out["feed"].append(tok.cpu())
            n = torch.full((LM_B,), i, dtype=torch.int32, device=dev)
            tok, lg, cache = tr.lm_decode_step(params, cfg, tok, cache, n)
            out["step_logits"].append(lg.cpu())
            # a copy: on the CPU ``.cpu()`` is the cache itself, which the
            # next step writes into
            out["caches"].append({k: v.to("cpu", copy=True)
                                  for k, v in cache.items()})
            out["greedy"].append(tok.cpu())
    return out


def lm_smoke_configs(dev, names=None, dtypes=("float32", "bfloat16")):
    """Each LM ``-smoke`` config in float32 and bfloat16: one parameter
    set drawn on the CPU from a seed and copied to ``dev``, the same
    tokens; the card held to the CPU (hidden states, every position's
    logits, the loss and its metrics, ``LM_STEPS`` decode steps' logits
    and caches, on a cache of ``LM_MAX_LEN`` slots so the last steps write
    past its end) within the tests' tolerances; greedy tokens equal where
    the CPU's margin decides them; the card's own router choices equal to
    the CPU's or ties.  Returns ``(rows, failed)``."""
    import dataclasses

    from repro_torch.configs import LM_ARCHS, get_config
    from repro_torch.models import transformer as tr

    cpu = torch.device("cpu")
    rows, bad = {}, []
    for name in names or [a + "-smoke" for a in LM_ARCHS]:
        for dtype in dtypes:
            cfg = dataclasses.replace(get_config(name), dtype=dtype)
            params = tr.lm_init(torch.Generator().manual_seed(0), cfg,
                                device=cpu)
            rng = np.random.default_rng(0)
            tokens = rng.integers(0, cfg.vocab, (LM_B, LM_S)).astype(np.int32)
            labels = rng.integers(0, cfg.vocab, (LM_B, LM_S)).astype(np.int32)
            records, seen = [], []
            with lm_routes(records):
                ref = _lm_smoke_run(cfg, params, cpu, tokens, labels, None)
            with lm_routes(records, seen):
                got = _lm_smoke_run(cfg, _lm_to(params, dev), dev, tokens,
                                    labels, ref["feed"])
            tol_h, tol_l = LM_TOL[dtype]
            errs = dict(
                hidden=lm_err(got["hidden"], ref["hidden"]),
                caches=max(lm_err(g[k], r[k]) for g, r in
                           zip(got["caches"], ref["caches"]) for k in r),
                logits=lm_err(got["logits"], ref["logits"]),
                step_logits=max(lm_err(g, r) for g, r in
                                zip(got["step_logits"], ref["step_logits"])),
                loss=max([lm_err(got["loss"], ref["loss"]),
                          lm_err(got["aux"], ref["aux"])]
                         + [lm_err(got["metrics"][k], v)
                            for k, v in ref["metrics"].items()]))
            decided = same = 0
            for g, r, lg in zip(got["greedy"], ref["greedy"],
                                ref["step_logits"]):
                d = lm_decided(lg, tol_l)
                decided += int(d.sum())
                same += int((g[d] == r[d]).sum())
            flips = lm_flips(records, seen, LM_TIE[dtype])
            ok = (errs["hidden"] <= tol_h and errs["caches"] <= tol_h
                  and max(errs["logits"], errs["step_logits"],
                          errs["loss"]) <= tol_l
                  and same == decided and flips is not None
                  and set(got["metrics"]) == set(ref["metrics"]))
            rows[f"{name}/{dtype}"] = dict(
                ok=ok, tol=[tol_h, tol_l], router_calls=len(records),
                router_flips=flips, tokens_decided=decided,
                tokens_equal=same, loss_cpu=float(ref["loss"]),
                **{f"err_{k}": v for k, v in errs.items()})
            if not ok:
                bad.append(f"{name}/{dtype}")
    return rows, bad


def _lm_prefill_flops(cfg, params, b, s):
    """The operations a prefill of ``b x s`` tokens needs: every layer
    weight matrix once a token, the LM head at the last position, and
    causal attention's lower triangle (scores and values)."""
    mats = sum(t.numel() for t in _lm_leaves(params["layers"])
               if t.dim() == 3)  # (L, d_in, d_out): a dense stack's
    att = 2 * s * s * cfg.n_heads * cfg.d_head * cfg.n_layers
    return 2 * b * s * mats + 2 * b * cfg.d_model * cfg.vocab + b * att


def _lm_teacher_forced(params, cfg, prompts, dev, steps=None):
    """The first ``steps`` (all) positions of ``prompts`` fed through
    decode steps from an empty cache of the prompts' length: each step's
    logits (float32) and greedy tokens, and the cache after the last."""
    from repro_torch.models import transformer as tr

    b, s = prompts.shape
    out = dict(logits=[], tokens=[])
    with torch.no_grad():
        cache = tr.init_kv_cache(cfg, b, s, device=dev)
        for i in range(steps or s):
            n = torch.full((b,), i, dtype=torch.int32, device=dev)
            nt, lg, cache = tr.lm_decode_step(params, cfg, prompts[:, i],
                                              cache, n)
            out["logits"].append(lg)
            out["tokens"].append(nt)
    out["cache"] = cache
    return out


def _lm_margin_decided(logits, other):
    """Rows of ``logits`` whose top-two margin exceeds twice the row's
    largest difference from ``other``: no difference that small can swap
    their argmax."""
    top2 = torch.topk(logits, 2, dim=-1).values
    diff = (logits - other.to(logits.device)).abs().amax(dim=-1)
    return ((top2[:, 0] - top2[:, 1]) > 2 * diff).cpu()


def _lm_vs_prefill(logits, tokens, full, first):
    """Teacher-forced decode against the prefill's forward pass at every
    position: the logits within ``LM_FULL_TOL`` and the argmax equal (the
    last one to the prefill step's token) wherever the margin decides."""
    err, decided, equal = 0.0, 0, 0
    for i, (lg, nt) in enumerate(zip(logits, tokens)):
        err = max(err, lm_err(lg, full[:, i]))
        want = (first if i == full.shape[1] - 1
                else full[:, i].argmax(-1)).cpu()
        d = _lm_margin_decided(full[:, i], lg)
        decided += int(d.sum())
        equal += int((nt.cpu()[d] == want[d]).sum())
    return dict(steps=len(logits), tol=LM_FULL_TOL, err=err,
                decided=decided, argmax_equal=equal,
                ok=err <= LM_FULL_TOL and equal == decided > 0)


def _lm_vs_cpu(card, cpu, tol=(LM_FULL_CPU_TOL, LM_FULL_CPU_TOL)):
    """The card's first decode steps held to the CPU's: the cache and the
    logits within ``tol``, greedy tokens equal wherever the margin
    decides."""
    tol_c, tol_l = tol
    n = len(cpu["logits"])
    err_l, decided, equal = 0.0, 0, 0
    for lg, nt, ref, ref_t in zip(card["logits"], card["tokens"],
                                  cpu["logits"], cpu["tokens"]):
        err_l = max(err_l, lm_err(lg, ref))
        d = _lm_margin_decided(ref, lg)
        decided += int(d.sum())
        equal += int((nt.cpu()[d] == ref_t[d]).sum())
    # the slots those steps wrote (the card may have gone on)
    err_c = max(lm_err(card["cache"][k][:, :, :n], v[:, :, :n])
                for k, v in cpu["cache"].items())
    return dict(steps=n, tol=[tol_c, tol_l], err_logits=err_l,
                err_cache=err_c, decided=decided, tokens_equal=equal,
                ok=err_l <= tol_l and err_c <= tol_c and equal == decided > 0)


@contextlib.contextmanager
def _lm_planted_mask_fault():
    """A decode fault planted for the block: ``decode_attention`` is handed
    one key fewer than the step has written (its own key left out, at
    every position but the first)."""
    from repro_torch.models import transformer as tr

    own = tr.decode_attention
    tr.decode_attention = lambda q, k, v, n: own(
        q, k, v, torch.clamp(n - 1, min=1))
    try:
        yield
    finally:
        tr.decode_attention = own


def lm_full_width(dev, name=LM_FULL, seed=0):
    """qwen2-0.5b at its published widths in bfloat16 on the card:
    parameters drawn there from a seeded ``torch.Generator``; a prefill
    of 1 x ``LM_PREFILL_LEN`` tokens through ``build_lm_prefill_step``
    (timed); ``LM_PROMPTS`` prompts of ``LM_PROMPT_LEN`` tokens through
    the prefill step and the forward pass, then teacher-forced through as
    many decode steps: every step's logits held to the forward's at its
    position (:func:`_lm_vs_prefill`); the first ``LM_CPU_STEPS`` steps
    held to the same steps on the CPU (:func:`_lm_vs_cpu`), and run again
    on the card with a planted mask fault that the CPU check must catch;
    ``LM_GREEDY`` greedy steps through ``serve``'s LM loop (timed, every
    token in the vocabulary); one decode step's device launches from a
    profiler window."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tr
    from repro_torch.models.attention import chunk_sizes
    from repro_torch.models.steps import (build_lm_decode_step,
                                          build_lm_prefill_step)

    cfg = get_config(name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tr.lm_init(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = _lm_leaves(params)
    numel = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    rng = np.random.default_rng(seed)

    prefill, _ = build_lm_prefill_step(cfg, device=dev)
    long = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, LM_PREFILL_LEN)).astype(np.int32)).to(dev)
    prefill_s = []
    for _ in range(1 + LM_PREFILL_REPS):  # the first call pays cuBLAS set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = prefill(params, long)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    prefill_tok_ok = tok.shape == (1,) and 0 <= int(tok) < cfg.vocab
    flops = _lm_prefill_flops(cfg, params, 1, LM_PREFILL_LEN)
    prefill_bound_ms = 1e3 * max(flops / BF16_FLOPS_PER_S,
                                 param_bytes / HBM_BYTES_PER_S)

    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_PROMPTS, LM_PROMPT_LEN)).astype(np.int32)).to(dev)
    first = prefill(params, prompts)
    with torch.no_grad():
        h, _ = tr.lm_forward(params, cfg, prompts)
        full = tr.lm_logits(params, h)  # every position's logits
    del h
    card = _lm_teacher_forced(params, cfg, prompts, dev)
    vs_prefill = _lm_vs_prefill(card["logits"], card["tokens"], full, first)
    cpu = torch.device("cpu")
    on_cpu = _lm_teacher_forced(_lm_to(params, cpu), cfg, prompts.cpu(), cpu,
                                LM_CPU_STEPS)
    vs_cpu = _lm_vs_cpu(card, on_cpu)
    with _lm_planted_mask_fault():
        planted = _lm_teacher_forced(params, cfg, prompts, dev, LM_CPU_STEPS)
    fault = dict(
        fault="decode mask off by one: the newest key left out",
        steps=LM_CPU_STEPS,
        err_vs_cpu=_lm_vs_cpu(planted, on_cpu)["err_logits"],
        err_vs_prefill=_lm_vs_prefill(planted["logits"], planted["tokens"],
                                      full, first)["err"])
    # the CPU check must catch the fault; the looser prefill check is read
    fault["caught_vs_cpu"] = fault["err_vs_cpu"] > LM_FULL_CPU_TOL
    fault["caught_vs_prefill"] = fault["err_vs_prefill"] > LM_FULL_TOL
    del full, card, on_cpu, planted

    serve_runs = []
    for _ in range(2):  # the first run warms the allocator up
        toks, secs = serve.serve_lm(cfg, params, batch=LM_PROMPTS,
                                    gen=LM_GREEDY, max_len=LM_SERVE_LEN,
                                    device=dev)
        serve_runs.append((toks, secs))
    toks, secs = serve_runs[-1]
    in_vocab = bool((toks >= 0).all() and (toks < cfg.vocab).all())

    decode, _ = build_lm_decode_step(cfg, device=dev)
    cache = tr.init_kv_cache(cfg, LM_PROMPTS, LM_SERVE_LEN, device=dev)
    one = torch.ones((LM_PROMPTS,), dtype=torch.int32, device=dev)
    zero = torch.zeros((LM_PROMPTS,), dtype=torch.int32, device=dev)
    prof = profile_count(lambda: decode(params, cache, one, zero), 0,
                         kernel="\0", label="lm")
    del cache
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    embed = params["embed"]["table"]
    decode_bytes = (param_bytes - embed.numel() * embed.element_size()
                    + LM_PROMPTS * cfg.d_model * embed.element_size())
    row = dict(
        config=name, dtype=cfg.dtype, param_numel=numel,
        param_bytes=param_bytes, init_seconds=init_s,
        prefill_tokens=LM_PREFILL_LEN,
        prefill_chunks=list(chunk_sizes(LM_PREFILL_LEN, cfg.attn_q_chunk,
                                        cfg.attn_kv_chunk)),
        prefill_first_ms=prefill_s[0] * 1e3,
        prefill_ms=[x * 1e3 for x in prefill_s[1:]],
        prefill_flops=flops, prefill_bound_ms=prefill_bound_ms,
        prefill_token_in_vocab=prefill_tok_ok,
        decode_vs_prefill=vs_prefill, decode_vs_cpu=vs_cpu,
        planted_fault=fault,
        serve=dict(batch=LM_PROMPTS, gen=LM_GREEDY, max_len=LM_SERVE_LEN,
                   seconds=[x[1] for x in serve_runs],
                   decode_ms_per_step=secs / LM_GREEDY * 1e3,
                   tokens_per_s=LM_PROMPTS * LM_GREEDY / secs,
                   tokens_in_vocab=in_vocab,
                   repeat_equal=bool(np.array_equal(serve_runs[0][0], toks)),
                   first_sequence=toks[0][:16].tolist()),
        decode_bytes=decode_bytes,
        decode_bound_ms=decode_bytes / HBM_BYTES_PER_S * 1e3,
        decode_step_profile=dict(
            device_launches=prof["device_launches"],
            device_seconds=prof["device_seconds"],
            profiled_wall_seconds=prof["profiled_wall_seconds"],
            device_busy_share=prof["device_busy_share_of_profiled_wall"],
            top=prof["top"]),
        max_memory_allocated=peak)
    ok = (prefill_tok_ok and in_vocab and vs_prefill["ok"] and vs_cpu["ok"]
          and fault["caught_vs_cpu"])
    del params
    torch.cuda.empty_cache()
    return row, ok


def lm_full_f32(dev, name=LM_FULL, seed=1):
    """qwen2-0.5b at its published widths in float32, card against CPU:
    one parameter set drawn on the card (2.5 GB; the CPU's one-thread
    draw took seconds), copied to the CPU, one
    forward of ``LM_F32_TOKENS`` tokens on each, then those tokens
    teacher-forced through as many decode steps; hidden states, every
    position's logits, every decode step's logits and the cache within
    the float32 tolerance (TF32 off, torch's default, which nothing in
    the package flips)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr

    cfg = dataclasses.replace(get_config(name), dtype="float32")
    params = _lm_to(tr.lm_init(torch.Generator(device=dev).manual_seed(seed),
                               cfg, device=dev), torch.device("cpu"))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, LM_F32_TOKENS).astype(np.int32))
    out = {}
    for key, d in (("cpu", torch.device("cpu")), ("card", dev)):
        p = params if key == "cpu" else _lm_to(params, d)
        t0 = time.perf_counter()
        with torch.no_grad():
            h, _ = tr.lm_forward(p, cfg, tokens.to(d))
            logits = tr.lm_logits(p, h)
        secs = time.perf_counter() - t0
        out[key] = (h.cpu(), logits.cpu(), secs,
                    _lm_teacher_forced(p, cfg, tokens.to(d), d))
        del p
    tol = LM_TOL["float32"]
    errs = dict(hidden=lm_err(out["card"][0], out["cpu"][0]),
                logits=lm_err(out["card"][1], out["cpu"][1]))
    decode = _lm_vs_cpu(out["card"][3], out["cpu"][3], tol)
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    ok = (errs["hidden"] <= tol[0] and errs["logits"] <= tol[1]
          and decode["ok"] and not tf32)
    secs = {k: v[2] for k, v in out.items()}
    del out
    torch.cuda.empty_cache()
    return dict(tokens=list(LM_F32_TOKENS), tol=list(tol),
                matmul_allow_tf32=tf32, cpu_seconds=secs["cpu"],
                card_seconds=secs["card"], decode_vs_cpu=decode,
                **{f"err_{k}": v for k, v in errs.items()}), ok


def lm_path(dev, smi, full=LM_FULL):
    """The LM family's serving path: the five ``-smoke`` configs card
    against CPU (:func:`lm_smoke_configs`), ``full`` (qwen2-0.5b) at its
    published widths in bfloat16 (:func:`lm_full_width`) and in float32
    card against CPU (:func:`lm_full_f32`).  No hand-written kernel runs
    here: the JAX package has no Pallas kernel on this path."""
    t0 = time.perf_counter()
    smoke, bad = lm_smoke_configs(dev)
    smoke_s = time.perf_counter() - t0
    full_row, full_ok = lm_full_width(dev, full)
    f32, f32_ok = lm_full_f32(dev, full)
    ok = not bad and full_ok and f32_ok
    emit("lm_path", ok=ok, gpu=smi, failed=bad, smoke=smoke,
         smoke_seconds=smoke_s, full_bf16=full_row, full_f32=f32,
         seconds=time.perf_counter() - t0)
    if bad:
        fail(f"LM smoke configs on the card differ from the CPU: {bad}")
    if not full_ok:
        fail(f"{full} in bfloat16: a token out of the vocabulary, decode "
             "disagrees with the forward pass or with the CPU, or the "
             "planted decode fault went unseen")
    if not f32_ok:
        fail(f"{full} in float32: the card's forward or decode differs "
             "from the CPU's (or TF32 is on)")


# ----------------------------------------------------------------------
# the LM family's training path
# ----------------------------------------------------------------------
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEP = 4, 32, 2000  # two microbatches of 2
# the train-step tests' tolerances (tests/test_torch_lm_train_step.py says
# why), the card held to the CPU by them too: the loss and grad_norm as
# |a - b| / (1 + |b|), each state leaf as ||a - b|| / ||b||, parameters
# elementwise as |a - b| / (1 + |b|) but for AdamW's sign flips
LM_TRAIN_TOL = {
    "float32": dict(loss=1e-5, grad_norm=1e-5, states=1e-4, params=1e-5),
    "bfloat16": dict(loss=2 ** -5, grad_norm=2 ** -5, states=2 ** -4,
                     params=2 ** -8),
}
LM_CURVE = ("qwen2-0.5b-smoke", 20)  # float32, steps 2000-2019
# card against CPU a step, after up to 19 updates on each: the tests'
# float32 bound for hidden states (the CPU against the reference: 1.4e-7)
LM_CURVE_TOL = 1e-4
LM_CURVE_FALL = 0.5  # nat: mean of the last five below the first five's
LM_FULL_TRAIN = (32, 512)  # qwen2-0.5b's microbatch_size 16: two of them
LM_FULL_TRAIN_STEPS = 8
LM_FULL_FALL = 1.0  # nat: mean of the last four below the first four's
LM_F32_TRAIN = (4, 16)  # with microbatch_size 2: two microbatches
LM_CLI = ("qwen2-0.5b-smoke", 10, 20)  # --steps 10, then 20 in one dir


def _lm_train_once(cfg, params, batch, step, dev, records=None, seen=None):
    """One ``build_lm_train_step`` call on ``dev`` from a fresh optimiser
    state: ``(params, opt_state, metrics)``; the router recorded into
    ``records`` (``seen`` None) or teacher-forced by them."""
    from repro_torch.models.steps import build_lm_train_step

    fn, info = build_lm_train_step(cfg, device=dev)
    params = _lm_to(params, dev)
    opt = info["opt_init"](params)
    ctx = (lm_routes(records, seen) if records is not None
           else contextlib.nullcontext())
    with ctx:
        return fn(params, opt, batch, step)


def lm_train_smoke(dev, names=None, dtypes=("float32", "bfloat16")):
    """Each LM ``-smoke`` config in float32 and bfloat16, with AdamW (every
    smoke config's) and, where its full config trains with Adafactor, with
    that too: one train step of ``LM_TRAIN_B x LM_TRAIN_S`` tokens (two
    microbatches) at step ``LM_TRAIN_STEP`` from one parameter set drawn
    on the CPU, on the CPU and on ``dev``; the card held to the CPU by
    :func:`lm_step_errs` (the loss, AdamW's ``grad_norm``, every state,
    every parameter), the router teacher-forced by the CPU's forward
    choices and the card's own held to them but for ties.  Returns
    ``(rows, failed)``, rows keyed ``config/dtype/optimizer``."""
    import dataclasses

    from repro_torch.configs import LM_ARCHS, get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer as tr

    cpu = torch.device("cpu")
    rows, bad = {}, []
    for name in names or [a + "-smoke" for a in LM_ARCHS]:
        opts = dict.fromkeys([get_config(name).optimizer,
                              get_config(name.removesuffix("-smoke"))
                              .optimizer])
        for dtype in dtypes:
            for opt in opts:
                cfg = dataclasses.replace(get_config(name), dtype=dtype,
                                          optimizer=opt)
                params = tr.lm_init(torch.Generator().manual_seed(0), cfg,
                                    device=cpu)
                batch = TokenPipeline(cfg.vocab, LM_TRAIN_B,
                                      LM_TRAIN_S).next_batch()
                records, seen = [], []
                ref = _lm_train_once(cfg, params, batch, LM_TRAIN_STEP, cpu,
                                     records)
                got = _lm_train_once(cfg, params, batch, LM_TRAIN_STEP, dev,
                                     records, seen)
                errs, ok = lm_step_errs(got, ref, cfg, LM_TRAIN_STEP,
                                        LM_TRAIN_TOL[dtype])
                flips = lm_flips(records, seen, LM_TIE[dtype])
                ok = ok and flips is not None and len(seen) == len(records)
                key = f"{name}/{dtype}/{opt}"
                rows[key] = dict(
                    ok=ok, tol=LM_TRAIN_TOL[dtype],
                    router_calls=len(records), router_flips=flips,
                    loss_cpu=float(ref[2]["loss"]),
                    **{f"err_{k}": v for k, v in errs.items()})
                if not ok:
                    bad.append(key)
    return rows, bad


def lm_train_curve(dev, name=LM_CURVE[0], steps=LM_CURVE[1]):
    """``name`` in float32: ``steps`` train steps from step 2000 of
    ``TokenPipeline(vocab, 4, 32)`` on the CPU and on ``dev`` from one
    parameter set; the card's loss held to the CPU's at every step, and
    both curves falling by ``LM_CURVE_FALL``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer as tr
    from repro_torch.models.steps import build_lm_train_step

    cfg = dataclasses.replace(get_config(name), dtype="float32")
    params = tr.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    runs = {}
    for key, d in (("cpu", torch.device("cpu")), ("card", dev)):
        fn, info = build_lm_train_step(cfg, device=d)
        p = _lm_to(params, d)
        opt = info["opt_init"](p)
        pipe = TokenPipeline(cfg.vocab, LM_TRAIN_B, LM_TRAIN_S)
        losses = []
        for step in range(LM_TRAIN_STEP, LM_TRAIN_STEP + steps):
            p, opt, m = fn(p, opt, pipe.next_batch(), step)
            losses.append(float(m["loss"]))
        runs[key] = losses
    err = max(lm_err(a, b) for a, b in zip(runs["card"], runs["cpu"]))
    fall = {k: float(np.mean(v[:5]) - np.mean(v[-5:])) for k, v in runs.items()}
    ok = err <= LM_CURVE_TOL and min(fall.values()) >= LM_CURVE_FALL
    return dict(config=name, dtype="float32", steps=[LM_TRAIN_STEP,
                LM_TRAIN_STEP + steps - 1], tol=LM_CURVE_TOL, err=err,
                fall=fall, min_fall=LM_CURVE_FALL, losses=runs, ok=ok), ok


def lm_train_full(dev, name=LM_FULL, seed=0, batch=LM_FULL_TRAIN,
                  steps=LM_FULL_TRAIN_STEPS, min_fall=LM_FULL_FALL):
    """``name`` at its published widths and depth in bfloat16 on the card:
    parameters from a seeded ``torch.Generator`` there, ``steps`` train
    steps from step 2000 of ``batch`` tokens from ``TokenPipeline``
    (microbatches of the config's ``microbatch_size``, remat on): every
    loss (finite, and the last four's mean ``min_fall`` nat below the
    first four's), each step's seconds, tokens/s on the median of steps 2
    on, one step's device launches and busy share from the profiler,
    ``max_memory_allocated``; then one step with remat off and one with
    the layers indexed out of their stacks instead of unbound, their
    seconds and peaks beside remat's (an out-of-memory there is reported,
    not raised); and ``6 · N · tokens`` over the median step against the data-sheet
    bfloat16 rate, N every parameter but the gathered embedding table."""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer as tr
    from repro_torch.models.steps import build_lm_train_step

    cfg = get_config(name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params = tr.lm_init(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    numel = sum(t.numel() for t in _lm_leaves(params))
    n_mult = numel - params["embed"]["table"].numel()
    fn, info = build_lm_train_step(cfg, device=dev)
    opt = info["opt_init"](params)
    pipe = TokenPipeline(cfg.vocab, *batch)
    first = LM_TRAIN_STEP
    losses, secs = [], []
    for step in range(first, first + steps):
        b = pipe.next_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = fn(params, opt, b, step)
        losses.append(float(m["loss"]))  # waits for the step
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    held = torch.cuda.memory_allocated() - before
    median = float(np.median(secs[1:]))
    tokens = batch[0] * batch[1]
    b = pipe.next_batch()
    prof = profile_count(lambda: fn(params, opt, b, first + steps), 0,
                         kernel="\0", label="lm", cpu=False)
    # the dry run's walk of this very step: its peak against the card's,
    # its product FLOPs against FlopCounterMode's count of a real step
    sizing, walk = walk_sizing(
        cfg, dict(kind="train", seq_len=batch[1], global_batch=batch[0]),
        peak)
    with FlopCounterMode(display=False) as counter:
        out = fn(params, opt, b, first + steps)
    del out
    sizing.update(card_flops=counter.get_total_flops(),
                  flops_equal=counter.get_total_flops()
                  == sum(walk.flops.values()))
    # remat off: one step on the same state, its own peak
    fn_off, _ = build_lm_train_step(dataclasses.replace(cfg, remat=False),
                                    device=dev)
    off = _lm_timed_step(fn_off, params, opt, b, first + steps, before)
    indexed = _lm_timed_step(fn, params, opt, b, first + steps, before,
                             _lm_indexed_layers())
    finite = bool(np.isfinite(losses).all())
    k = len(losses) // 2
    fall = float(np.mean(losses[:k]) - np.mean(losses[-k:]))
    flops = 6 * n_mult * tokens
    row = dict(
        config=name, dtype=cfg.dtype, param_numel=numel,
        n_multiplied=n_mult, batch=list(batch),
        microbatch=cfg.microbatch_size, remat=cfg.remat,
        steps=[first, first + steps - 1], losses=losses, fall=fall,
        min_fall=min_fall, step_seconds=secs,
        first_step_seconds=secs[0], median_step_seconds=median,
        tokens_per_step=tokens, tokens_per_s=tokens / median,
        step_profile=dict(
            device_launches=prof["device_launches"],
            device_seconds=prof["device_seconds"],
            profiled_wall_seconds=prof["profiled_wall_seconds"],
            device_busy_share=prof["device_busy_share_of_profiled_wall"],
            top=prof["top"]),
        max_memory_allocated=peak, held_after_steps=held,
        remat_off=off, indexed_layers=indexed, six_n_tokens_flops=flops,
        six_n_share_of_bf16_peak=flops / median / BF16_FLOPS_PER_S,
        walk=sizing)
    ok = finite and fall >= min_fall
    del params, opt, fn, fn_off
    torch.cuda.empty_cache()
    return row, ok


def _lm_timed_step(fn, params, opt, batch, step, before,
                   ctx=contextlib.nullcontext()):
    """One train step on the card under ``ctx``, from a reset peak: its
    loss, seconds and peak bytes over ``before``; an out-of-memory is
    reported, not raised."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    row = dict(oom=False)
    t0 = time.perf_counter()
    try:
        with ctx:
            out = fn(params, opt, batch, step)
        row["loss"] = float(out[2]["loss"])
        row["seconds"] = time.perf_counter() - t0
        del out
    except torch.cuda.OutOfMemoryError as e:
        row.update(oom=True, error=str(e).splitlines()[0])
    torch.cuda.synchronize()
    row["peak_bytes"] = torch.cuda.max_memory_allocated() - before
    return row


@contextlib.contextmanager
def _lm_indexed_layers():
    """The forward takes each layer by indexing its stacks (one
    ``SelectBackward`` a leaf a layer, each a zero ``(L, ...)`` gradient in
    the backward) instead of unbinding each stack once: what the unbind
    saves."""
    from repro_torch.models import transformer as tr

    own = tr._unbound
    tr._unbound = lambda stack, n: [tr._layer(stack, i) for i in range(n)]
    try:
        yield
    finally:
        tr._unbound = own


@contextlib.contextmanager
def _lm_planted_dropped_microbatch():
    """A train-step fault planted for the block: the second microbatch's
    loss keeps its value and loses its gradient, so only the first
    microbatch's gradient reaches the accumulators."""
    from repro_torch.models import steps

    own = steps.lm_loss
    calls = [0]

    def lm_loss(*args, **kw):
        loss, metrics = own(*args, **kw)
        calls[0] += 1
        if calls[0] == 2:
            loss = loss.detach() + 0 * loss
        return loss, metrics

    steps.lm_loss = lm_loss
    try:
        yield calls
    finally:
        steps.lm_loss = own


def lm_train_f32(dev, name=LM_FULL, seed=1, batch=LM_F32_TRAIN):
    """``name`` at its published widths in float32, card against CPU: one
    parameter set drawn on the card, one train step of ``batch`` tokens in
    two microbatches (``microbatch_size=2``) at step 2000 on each, held
    by :func:`lm_step_errs` at the float32 tolerances (TF32 off, torch's
    default, which nothing in the package flips); then the card's step
    again with a planted fault (the second microbatch's gradient dropped)
    that the same check must catch, each error over its tolerance."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer as tr

    cfg = dataclasses.replace(get_config(name), dtype="float32",
                              microbatch_size=2)
    cpu = torch.device("cpu")
    # drawn on the card (the CPU's one-thread draw of 630 M values takes
    # seconds), the CPU's copy from it
    params = _lm_to(tr.lm_init(torch.Generator(device=dev).manual_seed(seed),
                               cfg, device=dev), cpu)
    b = TokenPipeline(cfg.vocab, *batch).next_batch()
    tol = LM_TRAIN_TOL["float32"]
    t0 = time.perf_counter()
    ref = _lm_train_once(cfg, params, b, LM_TRAIN_STEP, cpu)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = _lm_train_once(cfg, params, b, LM_TRAIN_STEP, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    # the CPU's step on the card once, for both comparisons
    ref = (_lm_to(ref[0], dev), _lm_to(ref[1], dev), ref[2])
    errs, ok = lm_step_errs(card, ref, cfg, LM_TRAIN_STEP, tol, device=dev)
    del card
    with _lm_planted_dropped_microbatch() as calls:
        planted = _lm_train_once(cfg, params, b, LM_TRAIN_STEP, dev)
    perrs, pok = lm_step_errs(planted, ref, cfg, LM_TRAIN_STEP, tol,
                              device=dev)
    del planted, ref
    torch.cuda.empty_cache()
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    fault = dict(fault="the second microbatch's gradient dropped",
                 loss_calls=calls[0], caught=not pok,
                 err_over_tol={k: perrs[k] / tol[k] for k in tol},
                 **{f"err_{k}": v for k, v in perrs.items()})
    row = dict(config=name, dtype="float32", batch=list(batch),
               microbatch=2, step=LM_TRAIN_STEP, tol=tol,
               matmul_allow_tf32=tf32, cpu_seconds=cpu_s,
               card_seconds=card_s, planted_fault=fault,
               **{f"err_{k}": v for k, v in errs.items()})
    return row, ok and not tf32 and fault["caught"] and calls[0] == 2


def _lm_cli(train, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train.main(argv)
    return losses, out.getvalue().splitlines()


def lm_train_cli(dev, name=LM_CLI[0], first=LM_CLI[1], last=LM_CLI[2]):
    """``repro_torch.launch.train`` in this process on ``dev``:
    ``--steps first --ckpt-dir D``, then ``--steps last`` in D, which must
    print ``resumed at step first`` and whose losses must match an
    uninterrupted ``--steps last`` run's within the bfloat16 loss
    tolerance (on the card the embedding's backward adds with atomics, so
    two runs need not be bit-equal)."""
    from repro_torch.launch import train

    base = ["--arch", name, "--device", str(dev)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lm_train_") as d:
        head, _ = _lm_cli(train, [*base, "--steps", str(first),
                                  "--ckpt-dir", d])
        tail, lines = _lm_cli(train, [*base, "--steps", str(last),
                                      "--ckpt-dir", d])
        saved = sorted(os.listdir(d))
    whole, whole_lines = _lm_cli(train, [*base, "--steps", str(last)])
    tol = LM_TRAIN_TOL["bfloat16"]["loss"]
    resumed = bool(lines) and lines[0] == f"resumed at step {first}"
    same_steps = (sorted(head) == list(range(first))
                  and sorted(tail) == list(range(first, last)))
    err = max((lm_err(tail[s], whole[s]) for s in tail), default=math.inf)
    head_err = max((lm_err(head[s], whole[s]) for s in head),
                   default=math.inf)
    finite = all(math.isfinite(v) for v in (*head.values(), *tail.values()))
    ok = resumed and same_steps and finite and max(err, head_err) <= tol
    return dict(config=name, steps=[first, last], tol=tol, resumed=resumed,
                err_resumed_vs_whole=err, err_first_vs_whole=head_err,
                checkpoints=saved, lines=lines, whole_lines=whole_lines,
                seconds=time.perf_counter() - t0, ok=ok), ok


def lm_train_path(dev, smi, full=LM_FULL, full_batch=LM_FULL_TRAIN,
                  f32_batch=LM_F32_TRAIN, full_fall=LM_FULL_FALL):
    """The LM family's training path: the five ``-smoke`` configs' train
    step card against CPU (:func:`lm_train_smoke`), the float32 loss curve
    card against CPU (:func:`lm_train_curve`), ``full`` (qwen2-0.5b) at
    its published widths and depth in bfloat16 (:func:`lm_train_full`)
    and in float32 card against CPU with a planted fault
    (:func:`lm_train_f32`), and the ``train`` CLI's resume on the card
    (:func:`lm_train_cli`).  No hand-written kernel runs here: the JAX
    package has no Pallas kernel on this path."""
    t0 = time.perf_counter()
    secs = {}

    def timed(key, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        secs[key] = time.perf_counter() - t
        return out

    smoke, bad = timed("smoke", lm_train_smoke, dev)
    curve, curve_ok = timed("curve", lm_train_curve, dev)
    full_row, full_ok = timed("full_bf16", lm_train_full, dev, full,
                              batch=full_batch, min_fall=full_fall)
    f32, f32_ok = timed("full_f32", lm_train_f32, dev, full, batch=f32_batch)
    cli, cli_ok = timed("cli", lm_train_cli, dev)
    ok = not bad and curve_ok and full_ok and f32_ok and cli_ok
    emit("lm_train_path", ok=ok, gpu=smi, failed=bad, smoke=smoke,
         curve=curve, full_bf16=full_row, full_f32=f32, cli=cli,
         part_seconds=secs, seconds=time.perf_counter() - t0)
    if bad:
        fail(f"LM train steps on the card differ from the CPU: {bad}")
    if not curve_ok:
        fail("the float32 loss curve on the card differs from the CPU's, "
             "or does not fall")
    if not full_ok:
        fail(f"{full} in bfloat16: a loss not finite, or the loss did not "
             f"fall by {full_fall} nat")
    sizing_fail(f"{full}'s train step", full_row["walk"])
    if not full_row["walk"]["flops_equal"]:
        fail(f"{full}'s train step: the walk's product FLOPs "
             f"{sum(full_row['walk']['walk_flops'].values())} differ from "
             f"FlopCounterMode's {full_row['walk']['card_flops']}")
    if not f32_ok:
        fail(f"{full} in float32: the card's train step differs from the "
             "CPU's, TF32 is on, or the planted dropped microbatch went "
             "unseen")
    if not cli_ok:
        fail("train --ckpt-dir on the card did not resume, or its losses "
             "differ from an uninterrupted run's")


# ----------------------------------------------------------------------
# the LM family on a device mesh
# ----------------------------------------------------------------------
LM_MESH = (2, 2)  # ("data", "model"): four positions on one card
# the smoke steps on the mesh: 8 x 24 tokens in two microbatches of 4
# (two rows a data position; 24 divides into the reference's q chunks
# for a model axis of 2, 3 or 4), a 12-slot cache decoded for 8
# teacher-forced steps (slots 6-11 lie on the second model position, so
# the last two steps' softmax spans both shards)
LM_MESH_B, LM_MESH_S, LM_MESH_MB = 8, 24, 4
LM_MESH_LEN, LM_MESH_STEPS = 12, 8
# qwen2-0.5b at its published widths in bfloat16: two train steps of
# 8 x 512 in microbatches of 4, a 1 x 2048 prefill (the batch's one row
# on the first data position), 8 prompts x 16 decode steps
LM_MESH_FULL_TRAIN = (8, 512)
LM_MESH_FULL_STEPS = 2
LM_MESH_PREFILL = (1, 2048)
LM_MESH_DECODE = (8, 16)
# the full-width bfloat16 step on the mesh against one device: the smoke
# configs' bounds, but the states' at 2**-3.  The embedding table's
# gradient sums each token's row gradients in bfloat16, and the Zipf
# tokens put about a quarter of the rows on one token; the mesh sums each
# data position's rows apart.  On one H100 its v differed from one
# device's by 0.0659 of its norm and its m by 0.0313, every other leaf by
# at most 0.018; one device in microbatches of half the rows (the mesh's
# split) differed from itself by 0.0663 and 0.0317, and the mesh with no
# tensor-parallel partial rounded to bfloat16 still by 0.0644
# (lm_mesh_full's "one_device_rows_split" and "f32_partials")
LM_MESH_FULL_TOL = dict(LM_TRAIN_TOL["bfloat16"], states=2 ** -3)
LM_MESH_BUDGET_S = 60.0
# a router flip on the mesh: the two experts' one-device probabilities
# within this fraction of each other.  With a model axis every
# tensor-parallel product splits its contraction, and each part rounds
# to bfloat16 before the psum, so the router's input on the mesh differs
# from one device's by more than the card's from the CPU's (LM_TIE):
# flips seen up to 0.0103 of the larger probability on the smoke meshes
# in bfloat16, none in float32 or without a model axis
LM_MESH_TIE = {"float32": LM_TIE["float32"], "bfloat16": 2 ** -5}
# the keys of the byte tally whose closed form lm_mesh_train_bytes gives
LM_MESH_PARAM_KEYS = ("all_gather:params", "reduce_scatter:params",
                      "psum:grads")


def lm_mesh_of(shape, devices):
    """A ``DeviceMesh`` of ``shape`` over ``devices`` (one a position):
    axes ``("data", "model")``, or ``("pod", "data", "model")``."""
    from repro_torch.launch.mesh import make_mesh_for

    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh_for(shape, axes, devices=list(devices))


@contextlib.contextmanager
def lm_mesh_routes(records, seen, mesh):
    """:func:`lm_routes` for a mesh step's ``moe.route_on_mesh``: every
    call handed the recorded choices of the same call on one device
    (``records``, in call order, each the global ``(T, k)`` choice), each
    position the rows of its tokens (the positions before it along the
    batch axes hold the tokens before its own); the mesh's own choices,
    gathered back into global rows, appended to ``seen``.  A call whose
    router inputs are bit for bit an earlier call's is that layer's
    recompute under remat (the mesh's forward runs a remat layer without
    grad, its backward with) and takes that call's record."""
    from repro_torch.models import moe, sharding

    own = moe.route_on_mesh
    lay = sharding.layout(mesh)
    dp = tuple(a for a in ("pod", "data") if a in lay.names)
    group = lay.groups(dp)[0]
    calls, count = {}, [0]

    def route_on_mesh(routers, xs, top_k):
        outs = own(routers, xs, top_k)
        key = tuple(_lm_route_key(x) for x in xs)
        k = calls.get(key)
        fresh = k is None
        if fresh:
            k = count[0]
            count[0] += 1
            calls[key] = k
        if k >= len(records):
            fail("lm_mesh_path: more router calls than were recorded")
        ref_i = torch.as_tensor(records[k][0]).long()
        starts = np.cumsum([0] + [xs[j].shape[0] for j in group])
        rows = {j: (int(starts[i]), int(starts[i + 1]))
                for i, j in enumerate(group)}
        if fresh:
            seen.append(torch.cat([outs[j][2].cpu() for j in group]))
        forced = []
        for p, (probs, _, _) in enumerate(outs):
            j = next(j for j in group if lay.index(j, dp)
                     == lay.index(p, dp))
            lo, hi = rows[j]
            mine = ref_i[lo:hi].to(probs.device)
            chosen = torch.gather(probs, -1, mine)
            forced.append((probs, chosen / chosen.sum(dim=-1, keepdim=True),
                           mine))
        return forced

    moe.route_on_mesh = route_on_mesh
    try:
        yield
    finally:
        moe.route_on_mesh = own
    if count[0] < len(records):
        fail("lm_mesh_path: fewer router calls than were recorded")


def _lm_cards(dev=None, mesh=None):
    """The distinct CUDA cards of ``mesh``'s positions, or ``dev``'s."""
    devs = mesh.devices if mesh is not None else [] if dev is None else [dev]
    return sorted({torch.device(d) for d in devs
                   if torch.device(d).type == "cuda"}, key=str)


def _lm_sync(cards):
    for d in cards:
        torch.cuda.synchronize(d)


def _lm_route_ctx(records, seen, mesh):
    if records is None:
        return contextlib.nullcontext()
    if mesh is None:
        return lm_routes(records, seen)
    return lm_mesh_routes(records, seen, mesh)


def lm_mesh_train(cfg, params, batch, step, *, mesh=None, dev=None,
                  records=None, seen=None):
    """One ``build_lm_train_step`` call from a fresh optimiser state on
    one device ``dev`` or sharded on ``mesh`` (``params`` global, on the
    host or any device); the router recorded into ``records`` (``seen``
    None, one device) or teacher-forced by them.  Returns ``((params,
    opt_state, metrics) global, collective bytes, seconds)``."""
    from repro_torch.models import sharding
    from repro_torch.models.steps import build_lm_train_step

    if mesh is None:
        fn, info = build_lm_train_step(cfg, device=dev)
        p = _lm_to(params, dev)
    else:
        fn, info = build_lm_train_step(cfg, mesh)
        p = info["shard"](params)
    opt = info["opt_init"](p)
    cards = _lm_cards(dev, mesh)
    _lm_sync(cards)
    t0 = time.perf_counter()
    with sharding.tally_collective_bytes() as tally, \
            _lm_route_ctx(records, seen, mesh):
        p2, o2, m = fn(p, opt, batch, step)
    _lm_sync(cards)
    secs = time.perf_counter() - t0
    if mesh is not None:
        p2, o2 = sharding.unshard_tree(p2), sharding.unshard_tree(o2)
    return (p2, o2, {k: float(v) for k, v in m.items()}), dict(tally), secs


def _lm_mesh_logits(plan, logits):
    """Per-position (B/|dp|, V/|tp|) logits gathered whole, for a check
    (the steps themselves never gather them): (B, V) on position
    ``(0, ...)``'s device."""
    from repro_torch.models import sharding
    from repro_torch.models import steps as st

    return st._gather_rows(plan, sharding.all_gather(
        logits, plan.mesh, plan.tp, -1, "out"))


@torch.no_grad()
def lm_mesh_prefill_logits(cfg, info, params, tokens):
    """The last position's logits of the mesh's prefill for ``tokens``
    (B, S), computed as ``build_lm_prefill_step(cfg, mesh)`` computes
    them before its argmax (``info`` that step's): the sharded forward,
    the vocabulary-sharded head in the parameters' dtype; (B, V) float32."""
    from repro_torch.models import steps as st
    from repro_torch.models import transformer as tr

    plan, specs, lists = info["plan"], info["params"], st._shards(params)
    toks = st._rows(plan, torch.as_tensor(tokens), tokens.shape[0])
    hs, _ = tr.lm_forward_mesh(plan, lists, specs, cfg, toks)
    heads = tr._head_mesh(plan, lists, specs)
    return _lm_mesh_logits(plan, [tr.nn.matmul(h[:, -1], w).float()
                                  for h, w in zip(hs, heads)])


@torch.no_grad()
def lm_mesh_decode(cfg, info, params, cache, token, cache_len):
    """One decode step on the mesh through
    ``transformer.lm_decode_step_mesh``, as the one-device side calls
    ``lm_decode_step`` (``info`` ``build_lm_decode_step(cfg, mesh)``'s):
    ``(next tokens, logits (B, V) float32 gathered whole, cache)``."""
    from repro_torch.models import steps as st
    from repro_torch.models import transformer as tr

    plan, b = info["plan"], token.shape[0]
    s_total = next(iter(cache.values())).shape[2]
    nt, lg, _ = tr.lm_decode_step_mesh(
        plan, st._shards(params), info["params"], cfg,
        st._rows(plan, token, b), st._shards(cache),
        st._rows(plan, cache_len, b), s_total)
    return st._gather_rows(plan, nt), _lm_mesh_logits(plan, lg), cache


def lm_mesh_serve(cfg, params, tokens, steps, max_len, *, mesh=None,
                  dev=None, records=None, seen=None):
    """The prefill step's greedy token for ``tokens`` (B, S) and its last
    position's logits (whose margins, on one device, decide the tokens
    compared), then ``steps`` decode steps teacher-forced by
    ``tokens[:, i]`` at cache length ``i``: each step's (B, V) float32
    logits and next tokens, the final cache, on the host.  The router as
    in :func:`lm_mesh_train` (prefill, its logits, then each step)."""
    from repro_torch.models import nn as tnn
    from repro_torch.models import sharding
    from repro_torch.models import steps as st
    from repro_torch.models import transformer as tr

    b = tokens.shape[0]
    out = dict(logits=[], next=[], seconds={})
    toks = torch.as_tensor(tokens)
    ctx = _lm_route_ctx(records, seen, mesh)
    cards = _lm_cards(dev, mesh)
    with ctx:
        if mesh is None:
            pf, _ = st.build_lm_prefill_step(cfg, device=dev)
            p = _lm_to(params, dev)
            cache = tr.init_kv_cache(cfg, b, max_len, device=dev)
        else:
            pf, info = st.build_lm_prefill_step(cfg, mesh)
            _, dinfo = st.build_lm_decode_step(cfg, mesh)
            p = info["shard"](params)
            cache = dinfo["init_cache"](b, max_len)
        _lm_sync(cards)
        t0 = time.perf_counter()
        out["prefill"] = pf(p, toks).cpu()
        _lm_sync(cards)
        out["seconds"]["prefill"] = time.perf_counter() - t0
        if mesh is not None:
            # the router inputs are the prefill's: its calls' routes again
            out["prefill_logits"] = lm_mesh_prefill_logits(
                cfg, info, p, toks).cpu()
        t0 = time.perf_counter()
        for i in range(steps):
            n = torch.full((b,), i, dtype=torch.int32)
            if mesh is None:
                d = torch.device(dev)
                nt, lg, cache = tr.lm_decode_step(p, cfg, toks[:, i].to(d),
                                                  cache, n.to(d))
            else:
                nt, lg, cache = lm_mesh_decode(cfg, dinfo, p, cache,
                                               toks[:, i], n)
            out["logits"].append(lg.cpu())
            out["next"].append(nt.cpu())
        _lm_sync(cards)
        out["seconds"]["decode_step"] = (time.perf_counter() - t0) / steps
    if mesh is None:
        with torch.no_grad():
            h, _ = tr.lm_forward(p, cfg, toks.to(dev))
            out["prefill_logits"] = tnn.dense(p["lm_head"], h[:, -1]).float(
            ).cpu()
        out["cache"] = {k: v.cpu() for k, v in cache.items()}
    else:
        out["cache"] = sharding.unshard_tree(cache)
    return out


def lm_mesh_serve_errs(got, one, tol):
    """A mesh's serving outputs against one device's: the prefill's
    last-position logits and every decode step's (``|a - b| / (1 +
    |b|)``, ``tol`` = (caches, logits)), their tokens where one device's
    margin decides them, the final cache.  Returns ``(errs, ok)``."""
    tol_c, tol_l = tol
    decided = lm_decided(one["prefill_logits"], tol_l)
    errs = dict(err_prefill_logits=lm_err(got["prefill_logits"],
                                          one["prefill_logits"]),
                prefill_decided=int(decided.sum()),
                prefill_equal=bool(torch.equal(got["prefill"][decided],
                                               one["prefill"][decided])))
    worst, diff, compared = 0.0, 0, 0
    for lg, nt, lg1, nt1 in zip(got["logits"], got["next"], one["logits"],
                                one["next"]):
        worst = max(worst, lm_err(lg, lg1))
        dec = lm_decided(lg1, tol_l)
        compared += int(dec.sum())
        diff += int((nt.long()[dec] != nt1.long()[dec]).sum())
    errs.update(err_logits=worst, tokens_compared=compared,
                tokens_differ=diff,
                err_cache=max(lm_err(got["cache"][k], one["cache"][k])
                              for k in one["cache"]))
    ok = (errs["prefill_equal"] and errs["err_prefill_logits"] <= tol_l
          and worst <= tol_l and diff == 0 and errs["err_cache"] <= tol_c)
    return errs, ok


def lm_mesh_compare(cfg, params, batch, mesh, dev, *, parts=("train",
                                                            "serve"),
                    step=LM_TRAIN_STEP, steps=LM_MESH_STEPS,
                    max_len=LM_MESH_LEN):
    """``cfg``'s train step and serving (:func:`lm_mesh_train`,
    :func:`lm_mesh_serve`) on ``mesh`` against the same on one device
    ``dev``, the router teacher-forced by one device's choices (held to
    them but for ties).  Returns ``(row, ok)``."""
    row, ok = {}, True
    tol_step = LM_TRAIN_TOL[cfg.dtype]
    if "train" in parts:
        records, seen = [], []
        one, _, one_s = lm_mesh_train(cfg, params, batch, step, dev=dev,
                                      records=records)
        got, tally, secs = lm_mesh_train(cfg, params, batch, step, mesh=mesh,
                                         records=records, seen=seen)
        errs, t_ok = lm_step_errs(got, one, cfg, step, tol_step)
        flips = lm_flips(records, seen, LM_MESH_TIE[cfg.dtype])
        t_ok = t_ok and flips is not None and len(seen) == len(records)
        row["train"] = dict(ok=t_ok, seconds=secs, one_device_seconds=one_s,
                            loss=got[2]["loss"], router_flips=flips,
                            collective_bytes=tally,
                            **{f"err_{k}": v for k, v in errs.items()})
        ok = ok and t_ok
    if "serve" in parts:
        records, seen = [], []
        toks = torch.as_tensor(batch["tokens"])
        one = lm_mesh_serve(cfg, params, toks, steps, max_len, dev=dev,
                            records=records)
        got = lm_mesh_serve(cfg, params, toks, steps, max_len, mesh=mesh,
                            records=records, seen=seen)
        errs, s_ok = lm_mesh_serve_errs(got, one, LM_TOL[cfg.dtype])
        flips = lm_flips(records, seen, LM_MESH_TIE[cfg.dtype])
        s_ok = s_ok and flips is not None and len(seen) == len(records)
        row["serve"] = dict(ok=s_ok, seconds=got["seconds"],
                            one_device_seconds=one["seconds"],
                            router_flips=flips, **errs)
        ok = ok and s_ok
    return row, ok


def lm_mesh_train_bytes(cfg, mesh, n_micro):
    """The closed form of one AdamW train step's parameter and gradient
    traffic on ``mesh`` (``LM_MESH_PARAM_KEYS``), from the specs alone.
    A leaf with an FSDP dimension is all-gathered over ``data`` once a
    microbatch, and a stacked layer's twice under remat: the recompute in
    the backward gathers again (each member receives the others' shards:
    ``(|data| - 1)`` times the leaf's bytes, per pod, per model position
    where ``model`` does not split it); its gradient is reduce-scattered
    once a microbatch (the same bytes).  The float32 gradients are
    psummed over ``pod`` and, for a leaf without an FSDP dimension, over
    ``data`` (a group of n: ``2 (n - 1)`` shards, to the group's first
    position and back), and the global norm's square over every axis
    (one float32)."""
    from repro_torch.models import sharding
    from repro_torch.models import steps as st
    from repro_torch.models import transformer as tr

    lay = sharding.layout(mesh)
    size = lambda a: lay.size(a) if a in lay.names else 1  # noqa: E731
    n_pod, n_d, n_m = size("pod"), size("data"), size("model")
    dummy = tr.lm_init(None, cfg, device="meta")
    specs = st.lm_param_specs(dummy, cfg, mesh=mesh)
    ag = rs = ps = 0

    def walk(node, spec, path):
        nonlocal ag, rs, ps
        if isinstance(node, dict):
            for k in node:
                walk(node[k], spec[k], f"{path}/{k}" if path else k)
            return
        named = {a for e in spec for a in sharding._axes(e)}
        b = node.numel() * node.element_size()
        if "data" in named:
            per_use = (n_d - 1) * n_pod * b * (1 if "model" in named
                                               else n_m)
            stacked = path.startswith(("layers/", "dense_layers/"))
            ag += per_use * n_micro * (2 if stacked and cfg.remat else 1)
            rs += per_use * n_micro
        axes = tuple(a for a in ("pod", "data")
                     if a in lay.names and (a == "pod" or a not in named))
        n_a = math.prod(size(a) for a in axes)
        if n_a > 1:
            shard = sum(math.prod(s.stop - s.start
                                  for s in lay.slices(p, spec, node.shape))
                        for p in range(lay.n)) * 4
            ps += 2 * (n_a - 1) * shard // n_a

    walk(dummy, specs, "")
    ps += 2 * (lay.n - 1) * 4
    return {"all_gather:params": ag, "reduce_scatter:params": rs,
            "psum:grads": ps}


@contextlib.contextmanager
def _lm_mesh_planted_no_reduce_scatter():
    """A train-step fault planted for the block: the reduce-scatter of the
    FSDP gradients over ``data`` is skipped — each data position keeps
    its own chunk of its own partial gradient."""
    from repro_torch.models import sharding

    own = sharding._reduce_scatter

    def local(lay, axes, dim, xs, key, sizes=None):
        if not key.startswith("reduce_scatter:params"):
            return own(lay, axes, dim, xs, key, sizes)
        out = [None] * lay.n
        for g in lay.groups(axes):
            lo = 0
            for m in g:
                out[m] = xs[m].narrow(dim, lo, sizes[m]).contiguous()
                lo += sizes[m]
        return out

    sharding._reduce_scatter = local
    try:
        yield
    finally:
        sharding._reduce_scatter = own


@contextlib.contextmanager
def _lm_mesh_planted_no_rescale():
    """A decode fault planted for the block: the sequence shards' partial
    softmaxes combined without ``exp(m_pos - m_global)``."""
    from repro_torch.models import attention

    own = attention._rescale
    attention._rescale = lambda m, g: torch.where(  # noqa: E731
        torch.isfinite(m), torch.ones_like(m), 0.0)
    try:
        yield
    finally:
        attention._rescale = own


def lm_mesh_smoke(dev, mesh, names=None, dtypes=("float32", "bfloat16")):
    """Each LM ``-smoke`` config in float32 and bfloat16 on ``mesh``
    against one device ``dev`` (:func:`lm_mesh_compare`; microbatches of
    ``LM_MESH_MB``), each train step's parameter traffic against its
    closed form (:func:`lm_mesh_train_bytes`); then the two planted
    faults on qwen2-0.5b-smoke in float32, each of which the same check
    must catch.  Returns ``(rows, failed, faults)``."""
    import dataclasses

    from repro_torch.configs import LM_ARCHS, get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer as tr

    rows, bad = {}, []

    def setup(name, dtype):
        cfg = dataclasses.replace(get_config(name), dtype=dtype,
                                  microbatch_size=LM_MESH_MB)
        params = tr.lm_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
        batch = TokenPipeline(cfg.vocab, LM_MESH_B, LM_MESH_S).next_batch()
        return cfg, params, batch

    nm = LM_MESH_B // LM_MESH_MB
    for name in names or [a + "-smoke" for a in LM_ARCHS]:
        for dtype in dtypes:
            cfg, params, batch = setup(name, dtype)
            row, ok = lm_mesh_compare(cfg, params, batch, mesh, dev)
            want = lm_mesh_train_bytes(cfg, mesh, nm)
            got = {k: row["train"]["collective_bytes"].get(k, 0)
                   for k in LM_MESH_PARAM_KEYS}
            row["train"]["param_bytes_closed_form"] = want
            row["train"]["param_bytes_equal"] = got == want
            ok = ok and got == want
            key = f"{name}/{dtype}"
            rows[key] = dict(ok=ok, **row)
            if not ok:
                bad.append(key)
    cfg, params, batch = setup(LM_ARCHS[0] + "-smoke", "float32")
    faults = {}
    with _lm_mesh_planted_no_reduce_scatter():
        row, ok = lm_mesh_compare(cfg, params, batch, mesh, dev,
                                  parts=("train",))
    faults["no_grad_reduce_scatter"] = dict(
        caught=not ok, err_params=row["train"]["err_params"],
        err_states=row["train"]["err_states"])
    with _lm_mesh_planted_no_rescale():
        row, ok = lm_mesh_compare(cfg, params, batch, mesh, dev,
                                  parts=("serve",))
    faults["no_decode_rescale"] = dict(
        caught=not ok, err_logits=row["serve"]["err_logits"],
        tokens_differ=row["serve"]["tokens_differ"])
    return rows, bad, faults


def _lm_mesh_peak(fn, cards):
    """``fn()``'s result, its seconds until every card in ``cards`` is
    done, and each card's peak bytes allocated over what it held before
    (``None`` with no card)."""
    _lm_sync(cards)
    before = {}
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
        before[d] = torch.cuda.memory_allocated(d)
    t0 = time.perf_counter()
    out = fn()
    _lm_sync(cards)
    secs = time.perf_counter() - t0
    peak = {str(d): torch.cuda.max_memory_allocated(d) - before[d]
            for d in cards} or None
    return out, secs, peak


def _lm_mesh_profiled(fn, cards):
    """``fn()``'s result and its device launches on ``cards``, from one
    pass under the profiler (device activity only; ``None`` with no
    card)."""
    if not cards:
        return fn(), None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        _lm_sync(cards)
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA)
    return out, int(launches)


def _lm_state_errs(got, ref, device, top=3):
    """The optimiser state leaves' ``‖a - b‖ / ‖b‖``, the largest
    ``top`` with their paths."""
    def walk(a, b, path):
        if isinstance(b, dict):
            return [e for k in sorted(b) for e in walk(a[k], b[k],
                                                       f"{path}/{k}")]
        a, b = _lm_f64(a, device), _lm_f64(b, device)
        return [(float((a - b).norm() / b.norm().clamp_min(1e-30)), path)]

    return sorted(walk(got, ref, ""), reverse=True)[:top]


@contextlib.contextmanager
def lm_mesh_f32_partials():
    """The mesh's tensor-parallel blocks in float32 for the block: a value
    replicated over ``model`` enters them in float32, and the row-parallel
    products' psum rounds to the weights' dtype only after the sum; so no
    partial sum, forward (the psums) or backward (the replicated inputs'
    psums, the all-gathers' reduce-scatters), is rounded to bfloat16 before
    it is added.  A diagnostic of a dense config's full-width step, beside
    the mesh as it runs."""
    from repro_torch.models import nn as tnn
    from repro_torch.models import sharding

    rep, row = sharding.replicate, tnn.dense_row

    def replicate(xs, mesh, axes, tag="act"):
        return rep([x.float() for x in xs], mesh, axes, tag)

    def dense_row(mesh, p, xs, *, tp="model", tag="act"):
        ys = row(mesh, p, [x.float() for x in xs], tp=tp, tag=tag)
        return [y.to(w.dtype) for y, w in zip(ys, p["w"])]

    sharding.replicate, tnn.dense_row = replicate, dense_row
    try:
        yield
    finally:
        sharding.replicate, tnn.dense_row = rep, row


def lm_mesh_full(dev, mesh, name=LM_FULL, seed=0, train=LM_MESH_FULL_TRAIN,
                 prefill=LM_MESH_PREFILL, decode=LM_MESH_DECODE):
    """``name`` at its published widths and depth in bfloat16: parameters
    drawn on ``dev``; ``LM_MESH_FULL_STEPS`` train steps of
    ``train`` tokens in two microbatches on one device and on ``mesh``
    from the same state (the first step's parameters, states and metrics
    held by :func:`lm_step_errs` at ``LM_MESH_FULL_TOL``, every loss by
    its bound; the first step again under :func:`lm_mesh_f32_partials`,
    and on one device in microbatches of half the rows);
    a ``prefill`` (batch, length) prefill and ``decode`` (prompts, steps)
    decode steps (last-position logits within ``LM_FULL_CPU_TOL``, tokens
    where decided).  For each mesh step: seconds until every card is
    done, each card's peak bytes, collective bytes (the train step's
    parameter traffic equal to its closed form) and, for prefill and
    decode, device launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import sharding
    from repro_torch.models import steps as st
    from repro_torch.models import transformer as tr

    b, s = train
    cfg = dataclasses.replace(get_config(name), microbatch_size=b // 2)
    params = tr.lm_init(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    pipe = TokenPipeline(cfg.vocab, b, s)
    batches = [pipe.next_batch() for _ in range(LM_MESH_FULL_STEPS)]
    tol = LM_MESH_FULL_TOL
    row = dict(config=name, dtype=cfg.dtype, mesh=list(mesh.shape),
               batch=[b, s], microbatch=b // 2, tol=tol)
    one_card, cards = _lm_cards(dev), _lm_cards(mesh=mesh)
    fn1, info1 = st.build_lm_train_step(cfg, device=dev)
    fnm, infom = st.build_lm_train_step(cfg, mesh)
    p1, o1 = params, info1["opt_init"](params)
    pm = infom["shard"](params)
    om = infom["opt_init"](pm)
    steps, ok = [], True
    for i, batch in enumerate(batches):
        step = LM_TRAIN_STEP + i
        (p1n, o1n, m1), s1, _ = _lm_mesh_peak(
            lambda: fn1(p1, o1, batch, step), one_card)
        with sharding.tally_collective_bytes() as tally:
            (pmn, omn, mm), sm, peak = _lm_mesh_peak(
                lambda: fnm(pm, om, batch, step), cards)
        srow = dict(step=step, seconds=sm, one_device_seconds=s1,
                    peak_bytes=peak, loss=float(mm["loss"]),
                    one_device_loss=float(m1["loss"]),
                    collective_bytes=dict(tally))
        srow["err_loss"] = lm_err(mm["loss"], m1["loss"])
        srow_ok = srow["err_loss"] <= tol["loss"]
        want = lm_mesh_train_bytes(cfg, mesh, 2)
        srow["param_bytes_equal"] = all(tally.get(k, 0) == want[k]
                                        for k in want)
        srow_ok = srow_ok and srow["param_bytes_equal"]
        if i == 0:
            got = (sharding.unshard_tree(pmn, dev),
                   sharding.unshard_tree(omn, dev),
                   {k: float(v) for k, v in mm.items()})
            errs, e_ok = lm_step_errs(got, (p1n, o1n, {
                k: float(v) for k, v in m1.items()}), cfg, step, tol,
                device=dev)
            srow["worst_states"] = _lm_state_errs(got[1], o1n, dev)
            del got
            srow.update({f"err_{k}": v for k, v in errs.items()})
            srow_ok = srow_ok and e_ok
            # the same step with no tensor-parallel partial rounded to
            # bfloat16 before its sum: LM_MESH_FULL_TOL's cause, tested
            with lm_mesh_f32_partials():
                pf_, of_, mf_ = fnm(pm, om, batch, step)
            got = (sharding.unshard_tree(pf_, dev),
                   sharding.unshard_tree(of_, dev),
                   {k: float(v) for k, v in mf_.items()})
            del pf_, of_
            errs, _ = lm_step_errs(got, (p1n, o1n, {
                k: float(v) for k, v in m1.items()}), cfg, step, tol,
                device=dev)
            srow["f32_partials"] = dict(
                worst_states=_lm_state_errs(got[1], o1n, dev),
                **{f"err_{k}": v for k, v in errs.items()})
            # one device against itself with its batch rows split as the
            # mesh's data axis splits them (microbatches of half the rows)
            half, _ = st.build_lm_train_step(dataclasses.replace(
                cfg, microbatch_size=b // 4), device=dev)
            got = half(p1, o1, batch, step)
            got = (got[0], got[1], {k: float(v) for k, v in got[2].items()})
            errs, _ = lm_step_errs(got, (p1n, o1n, {
                k: float(v) for k, v in m1.items()}), cfg, step, tol,
                device=dev)
            srow["one_device_rows_split"] = dict(
                worst_states=_lm_state_errs(got[1], o1n, dev),
                **{f"err_{k}": v for k, v in errs.items()})
            del got
        srow["ok"] = srow_ok
        ok = ok and srow_ok
        steps.append(srow)
        p1, o1, pm, om = p1n, o1n, pmn, omn
    # a train step's launches are not profiled here: the profiler's one
    # pass over its 94,817 launches took 25.6 s (measured on one H100)
    row["train"] = steps
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, prefill, generator=g,
                           dtype=torch.int32)
    pf1, _ = st.build_lm_prefill_step(cfg, device=dev)
    pfm, pinfo = st.build_lm_prefill_step(cfg, mesh)
    pm = pinfo["shard"](params)
    with torch.no_grad():
        h, _ = tr.lm_forward(params, cfg, prompt.to(dev))
        last = tr.nn.dense(params["lm_head"], h[:, -1]).float().cpu()
        del h
    one_tok = pf1(params, prompt).cpu()
    with sharding.tally_collective_bytes() as tally:
        mesh_tok, secs, peak = _lm_mesh_peak(lambda: pfm(pm, prompt), cards)
    _, launches = _lm_mesh_profiled(lambda: pfm(pm, prompt), cards)
    mesh_last = lm_mesh_prefill_logits(cfg, pinfo, pm, prompt).cpu()
    decided = lm_decided(last, LM_FULL_CPU_TOL)
    err_pre = lm_err(mesh_last, last)
    tok_ok = bool(torch.equal(mesh_tok.cpu()[decided], one_tok[decided]))
    pre_ok = tok_ok and err_pre <= LM_FULL_CPU_TOL
    row["prefill"] = dict(
        tokens=list(prefill), seconds=secs, peak_bytes=peak,
        launches=launches, collective_bytes=dict(tally),
        err_logits=err_pre, decided=int(decided.sum()),
        token_equal=tok_ok, ok=pre_ok)
    nb, nsteps = decode
    feed = torch.randint(0, cfg.vocab, (nb, nsteps), generator=g,
                         dtype=torch.int32)
    one = lm_mesh_serve(cfg, params, feed, nsteps, nsteps, dev=dev)
    with sharding.tally_collective_bytes() as tally:
        got, secs, peak = _lm_mesh_peak(lambda: lm_mesh_serve(
            cfg, params, feed, nsteps, nsteps, mesh=mesh), cards)
    errs, d_ok = lm_mesh_serve_errs(got, one, (LM_FULL_CPU_TOL,
                                               LM_FULL_CPU_TOL))
    dc, dinfo = st.build_lm_decode_step(cfg, mesh)
    cache = dinfo["init_cache"](nb, nsteps)
    _, launches = _lm_mesh_profiled(lambda: dc(
        pm, cache, feed[:, 0], torch.zeros(nb, dtype=torch.int32)), cards)
    row["decode"] = dict(
        prompts=nb, steps=nsteps, step_seconds=got["seconds"]["decode_step"],
        one_device_step_seconds=one["seconds"]["decode_step"],
        peak_bytes_prefill_and_decode=peak, collective_bytes=dict(tally),
        launches_step=launches,
        ok=d_ok, **errs)
    del pm, cache, params
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    ok = ok and pre_ok and d_ok
    row["ok"] = ok
    return row, ok


def lm_mesh_path(dev, smi, devices=None, full=LM_FULL, **sizes):
    """The LM family's steps on a device mesh: a ``LM_MESH`` mesh of four
    positions (on ``devices``, by default all on ``dev``); every
    ``-smoke`` config's train, prefill and decode steps against one
    device with both planted faults (:func:`lm_mesh_smoke`), and
    ``full`` at its published widths (:func:`lm_mesh_full`, ``sizes``
    its train / prefill / decode shapes where given).  No
    hand-written kernel runs here: the JAX package has no Pallas kernel
    on this path."""
    t0 = time.perf_counter()
    mesh = lm_mesh_of(LM_MESH, devices or [dev] * math.prod(LM_MESH))
    smoke, bad, faults = lm_mesh_smoke(dev, mesh)
    t_smoke = time.perf_counter() - t0
    full_row, full_ok = lm_mesh_full(dev, mesh, full, **sizes)
    secs = time.perf_counter() - t0
    caught = all(f["caught"] for f in faults.values())
    ok = not bad and full_ok and caught and secs <= LM_MESH_BUDGET_S
    emit("lm_mesh_path", ok=ok, gpu=smi, mesh=list(LM_MESH),
         devices=[str(d) for d in mesh.devices], failed=bad, smoke=smoke,
         planted_faults=faults, full=full_row, smoke_seconds=t_smoke,
         seconds=secs, budget_seconds=LM_MESH_BUDGET_S)
    if bad:
        fail(f"LM steps on the mesh differ from one device: {bad}")
    if not caught:
        fail(f"a planted mesh fault went unseen: {faults}")
    if not full_ok:
        fail(f"{full} on the mesh differs from one device")
    if secs > LM_MESH_BUDGET_S:
        fail(f"lm_mesh_path took {secs:.1f} s, over its "
             f"{LM_MESH_BUDGET_S} s budget")


LM_MESH_BIG = "chatglm3-6b"  # AdamW's states alone ~87 GB: four cards
LM_MESH_BIG_SEQ = 512
LM_MESH_BIG_BATCHES = (2, 4, 8)  # microbatches of its 2: 1 to 4 of them
LM_MESH_BIG_STEPS = 3


def lm_mesh_big_sizing(cfg, mesh, seq=LM_MESH_BIG_SEQ,
                       batches=LM_MESH_BIG_BATCHES):
    """Each candidate batch's per-card peak as the port's own tools put
    it: the dry run's walk of the one-device step
    (``dryrun.walk_cell``, meta tensors) scaled by the share of the
    parameters' and optimiser state's bytes that position ``(0, ...)``
    holds (``roofline.shard_bytes`` over the global bytes).  Returns
    ``(rows, the largest batch that fits the card)``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import shard_bytes
    from repro_torch.models import steps as st

    _, info = st.build_lm_train_step(cfg, mesh)
    full = sum(t.numel() * t.element_size()
               for t in _lm_leaves(info["dummy"]) + _lm_leaves(
                   info["opt_shape"]))
    mine = (shard_bytes(info["dummy"], info["params"], mesh)
            + shard_bytes(info["opt_shape"], info["opt"], mesh))
    card = torch.cuda.get_device_properties(mesh.first).total_memory
    rows, pick = [], None
    for b in batches:
        walk, _ = dryrun.walk_cell(cfg, dict(kind="train", seq_len=seq,
                                             global_batch=b))
        est = int(walk.peak_bytes * mine / full)
        fits = est <= card
        rows.append(dict(batch=[b, seq], walk_peak_one_device=walk.peak_bytes,
                         state_share=mine / full, per_card=est, fits=fits))
        if fits:
            pick = b
    return rows, pick


def lm_mesh_big(cards, smi, name=LM_MESH_BIG, seq=LM_MESH_BIG_SEQ,
                steps=LM_MESH_BIG_STEPS):
    """``name`` at its published widths and depth in bfloat16 on a
    ``LM_MESH`` mesh with one card a position (the four-card run): the
    batch sized by :func:`lm_mesh_big_sizing`, ``steps`` train steps
    from step 2000 of ``TokenPipeline`` batches, each step's seconds and
    loss, each card's peak against the sizing's."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer as tr
    from repro_torch.models.steps import build_lm_train_step

    t0 = time.perf_counter()
    cfg = get_config(name)
    mesh = lm_mesh_of(LM_MESH, cards)
    sizing, b = lm_mesh_big_sizing(cfg, mesh, seq)
    row = dict(config=name, dtype=cfg.dtype, mesh=list(LM_MESH),
               devices=[str(d) for d in mesh.devices], sizing=sizing,
               batch=None if b is None else [b, seq],
               microbatch=cfg.microbatch_size)
    ok = b is not None
    if ok:
        fn, info = build_lm_train_step(cfg, mesh)
        params = tr.lm_init(torch.Generator(device=mesh.first).manual_seed(0),
                            cfg, device=mesh.first)
        sp = info["shard"](params)
        del params
        torch.cuda.empty_cache()
        opt = info["opt_init"](sp)
        pipe = TokenPipeline(cfg.vocab, b, seq)
        cards_used = sorted(set(mesh.devices), key=str)
        losses, secs, peaks = [], [], []
        try:
            for i in range(steps):
                batch = pipe.next_batch()
                for d in cards_used:
                    torch.cuda.synchronize(d)
                    torch.cuda.reset_peak_memory_stats(d)
                t = time.perf_counter()
                sp, opt, m = fn(sp, opt, batch, LM_TRAIN_STEP + i)
                losses.append(float(m["loss"]))
                for d in cards_used:
                    torch.cuda.synchronize(d)
                secs.append(time.perf_counter() - t)
                peaks.append({str(d): torch.cuda.max_memory_allocated(d)
                              for d in cards_used})
            row.update(oom=False)
        except torch.cuda.OutOfMemoryError as e:
            row.update(oom=True, error=str(e).splitlines()[0])
            ok = False
        est = next(r["per_card"] for r in sizing if r["batch"][0] == b)
        worst = max((max(p.values()) for p in peaks), default=0)
        row.update(losses=losses, step_seconds=secs, card_peaks=peaks,
                   sizing_per_card=est,
                   peak_over_sizing=worst / est if est else None)
        ok = ok and len(losses) == steps and all(
            math.isfinite(x) for x in losses)
        del sp, opt
        torch.cuda.empty_cache()
    row.update(ok=ok, seconds=time.perf_counter() - t0)
    emit("lm_mesh_big", gpu=smi, **row)
    if not ok:
        fail(f"{name} on the four-card mesh: no batch fits by the sizing, "
             f"or a step ran out of memory or lost its loss")


# ----------------------------------------------------------------------
# the recsys and GNN families
# ----------------------------------------------------------------------
# float32, card against CPU: the LM train step's bounds (the tests hold
# the CPU to the reference well inside them); serve probabilities and
# retrieval scores elementwise as |a - b| / (1 + |b|)
MODEL_STEP_TOL = LM_TRAIN_TOL["float32"]
MODEL_OUT_TOL = 1e-5
RECSYS_SMOKE = ("dlrm-mlperf-smoke", 64, 40)  # config, batch, candidates
RECSYS_FULL = "dlrm-mlperf"
# each table capped at 2^20 rows: 7,206,400 rows after padding, a 3.69 GB
# float32 table (uncapped: 177,944,576 rows, 91.1 GB).  At 2^21 (6.64 GB)
# the first AdamW step ran out of the card's memory: the out-of-place
# update holds about a dozen table-sized tensors at its peak
RECSYS_ROWS_CAP = 1 << 20
RECSYS_TRAIN = (65_536, 8)  # RECSYS_SHAPES' train batch, steps
RECSYS_SERVE = (512, 50, 262_144, 5)  # p99 batch and calls, bulk batch and calls
RECSYS_CANDIDATES = 1_000_000
RECSYS_RETRIEVAL_CALLS = 20
GNN_ARCH_NAMES = ("gat-cora", "graphcast", "nequip", "equiformer-v2")
# the molecule cell: 128 molecules x 30 atoms, 64 edges each
MOLECULE = dict(kind="batched", n_nodes=30, n_edges=64, batch=128)
GNN_FULL_STEPS = 4
GNN_SIZED = ("equiformer_v2",)  # full steps whose peak the walk is held to
# the reference's equivariance tests' bounds (tests/test_arch_smoke.py):
# energy |e1 - e2| < atol + rtol |e1|, forces elementwise atol
EQUIV_NEQUIP = dict(atol=1e-4, rtol=1e-3, force_atol=2e-4)
EQUIV_EQUIFORMER = dict(atol=1e-3, rtol=5e-3)


def _tensors(batch, dev):
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in batch.items()}


def capped_recsys(name=RECSYS_FULL, cap=RECSYS_ROWS_CAP):
    """``name``'s config with every table capped at ``cap`` rows (the
    pipeline's Zipf ids are clipped to each table's size)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(name)
    return dataclasses.replace(
        cfg, table_sizes=tuple(min(s, cap) for s in cfg.table_sizes))


def retrieval_errs(vals, idx, scores):
    """A top k ``(vals, idx)`` held to the full ``scores`` it was taken
    from (float64 on the host): the score of the candidate at each rank
    against the k-th best score at that rank, and each value against its
    candidate's score, both as ``|a - b| / (1 + |b|)``.  A candidate that
    differs from a rescoring's only by a tie within that error passes;
    ``idx_equal`` counts the ranks whose index is the rescoring's own (a
    stable descending sort: ties to the lower index)."""
    scores = _lm_host(scores)
    idx = torch.as_tensor(idx).long().cpu()
    k = idx.shape[0]
    want, order = torch.sort(scores, descending=True, stable=True)
    rank = float(((scores[idx] - want[:k]).abs() / (1 + want[:k].abs()))
                 .max())
    val = lm_err(vals, scores[idx])
    return dict(k=k, err_rank=rank, err_values=val,
                idx_equal=int((idx == order[:k]).sum()),
                distinct=len(set(idx.tolist())) == k)


@contextlib.contextmanager
def _planted_pair_order():
    """A DLRM fault planted for the block: the interaction's pairs taken
    from the lower triangle (column-major order of the same pairs), so the
    top MLP reads every pair in another column."""
    from repro_torch.models import dlrm

    own = dlrm._interact_dot

    def lower(dense_v, sparse_v):
        b, f, d = sparse_v.shape
        all_v = torch.cat([dense_v[:, None, :], sparse_v], dim=1)
        z = torch.bmm(all_v, all_v.transpose(1, 2))
        il = torch.tril_indices(f + 1, f + 1, offset=-1, device=z.device)
        return torch.cat([dense_v, z[:, il[0], il[1]]], dim=1)

    dlrm._interact_dot = lower
    try:
        yield
    finally:
        dlrm._interact_dot = own


def recsys_smoke(dev, name=RECSYS_SMOKE[0], batch=RECSYS_SMOKE[1],
                 n_cand=RECSYS_SMOKE[2]):
    """``name`` card against CPU from one parameter set drawn on the CPU:
    one train step (:func:`step_errs`: the loss, ``grad_norm``, both
    moments, every parameter), the serve step's probabilities and the
    retrieval step's top values and indices (:func:`retrieval_errs` on the
    CPU's own scores); then the card's serve step again with the
    interaction's pairs planted in the lower triangle's order, which the
    same check must catch."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import RecsysPipeline
    from repro_torch.models import gnn_steps as gs
    from repro_torch.models.dlrm import dlrm_init
    from repro_torch.models.nn import mlp

    cfg = get_config(name)
    cpu = torch.device("cpu")
    params = dlrm_init(torch.Generator().manual_seed(0), cfg, device=cpu)
    b = RecsysPipeline(cfg, batch).next_batch()
    cand = np.arange(n_cand, dtype=np.int32)
    out = {}
    for key, d in (("cpu", cpu), ("card", dev)):
        p = _lm_to(params, d)
        fn, info = gs.build_dlrm_train_step(cfg, device=d)
        step = fn(p, info["opt_init"](p), b, 0)
        serve, _ = gs.build_dlrm_serve_step(cfg, device=d)
        retrieve, _ = gs.build_dlrm_retrieval_step(cfg, device=d)
        out[key] = dict(step=step, probs=serve(p, b["dense"], b["sparse_ids"]),
                        top=retrieve(p, b["dense"][:1], cand))
    errs, step_ok = step_errs(out["card"]["step"], out["cpu"]["step"],
                              MODEL_STEP_TOL, lr_t=1e-3, step=0)
    probs = lm_err(out["card"]["probs"], out["cpu"]["probs"])
    with torch.no_grad():
        q = mlp(params["bot"], torch.from_numpy(b["dense"][:1]),
                final_act=True)
        scores = params["emb"]["table"][torch.from_numpy(cand).long()] @ q[0]
    top = retrieval_errs(*out["card"]["top"], scores)
    top_ok = (top["distinct"] and top["err_rank"] <= MODEL_OUT_TOL
              and top["err_values"] <= MODEL_OUT_TOL)
    serve, _ = gs.build_dlrm_serve_step(cfg, device=dev)
    with _planted_pair_order():
        planted = lm_err(serve(_lm_to(params, dev), b["dense"],
                               b["sparse_ids"]), out["cpu"]["probs"])
    ok = step_ok and probs <= MODEL_OUT_TOL and top_ok
    return dict(config=name, batch=batch, candidates=n_cand,
                tol=dict(step=MODEL_STEP_TOL, out=MODEL_OUT_TOL),
                loss_cpu=float(out["cpu"]["step"][2]["loss"]),
                err_probs=probs, retrieval=top,
                planted_pair_order=dict(err_probs=planted,
                                        caught=planted > MODEL_OUT_TOL),
                **{f"err_{k}": v for k, v in errs.items()},
                ok=ok and planted > MODEL_OUT_TOL), \
        ok and planted > MODEL_OUT_TOL


def _timed_calls(fn, calls):
    """Each call's seconds, the card synchronised around it."""
    secs = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def _profile_row(prof):
    return dict(device_launches=prof["device_launches"],
                device_seconds=prof["device_seconds"],
                profiled_wall_seconds=prof["profiled_wall_seconds"],
                device_busy_share=prof["device_busy_share_of_profiled_wall"],
                top=prof["top"])


def recsys_full(dev, cfg=None, train=RECSYS_TRAIN, serve=RECSYS_SERVE,
                n_cand=RECSYS_CANDIDATES, seed=0):
    """DLRM at the published widths, tables capped (:func:`capped_recsys`),
    parameters drawn on the card: ``train`` steps of ``RecsysPipeline``
    batches (each step's seconds, samples/s on the median of steps 2 on,
    one step's launches and busy share from the profiler,
    ``max_memory_allocated``, the losses falling); the serve step's
    latency at the p99 batch (median and p99 of its calls) and its
    throughput at the bulk batch; one query's retrieval against
    ``n_cand`` rows of table 0, its top 100 against a float64 rescoring
    on the CPU (:func:`retrieval_errs`)."""
    from repro_torch.data.pipeline import RecsysPipeline
    from repro_torch.models import gnn_steps as gs
    from repro_torch.models.dlrm import dlrm_init, padded_rows
    from repro_torch.models.nn import mlp

    cfg = cfg or capped_recsys()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params = dlrm_init(torch.Generator(device=dev).manual_seed(seed), cfg,
                       device=dev)
    fn, info = gs.build_dlrm_train_step(cfg, device=dev)
    opt = info["opt_init"](params)
    batch, steps = train
    pipe = RecsysPipeline(cfg, batch)
    losses, secs = [], []
    for step in range(steps):
        b = _tensors(pipe.next_batch(), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = fn(params, opt, b, step)
        losses.append(float(m["loss"]))  # waits for the step
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    sizing, _ = walk_sizing(cfg, dict(kind="train", batch=batch), peak)
    b = _tensors(pipe.next_batch(), dev)
    prof = profile_count(lambda: fn(params, opt, b, steps), 0, kernel="\0",
                         label="dlrm", cpu=False)
    median = float(np.median(secs[1:]))
    k = len(losses) // 2
    fall = float(np.mean(losses[:k]) - np.mean(losses[-k:]))
    del opt, b
    torch.cuda.empty_cache()

    p99_batch, p99_calls, bulk_batch, bulk_calls = serve
    srv, _ = gs.build_dlrm_serve_step(cfg, device=dev)
    small = _tensors(RecsysPipeline(cfg, p99_batch, seed=1).next_batch(), dev)
    bulk = _tensors(RecsysPipeline(cfg, bulk_batch, seed=2).next_batch(), dev)
    run_small = lambda: srv(params, small["dense"], small["sparse_ids"])  # noqa: E731
    run_bulk = lambda: srv(params, bulk["dense"], bulk["sparse_ids"])  # noqa: E731
    run_small()
    lat = _timed_calls(run_small, p99_calls)
    run_bulk()
    bulk_s = _timed_calls(run_bulk, bulk_calls)
    probs = run_bulk()
    probs_ok = bool(torch.isfinite(probs).all() and (probs >= 0).all()
                    and (probs <= 1).all())
    del bulk, probs

    ret, _ = gs.build_dlrm_retrieval_step(cfg, device=dev)
    rng = np.random.default_rng(seed)
    cand = rng.choice(cfg.table_sizes[0], n_cand, replace=False).astype(
        np.int32)
    dense = small["dense"][:1]
    cand_t = torch.from_numpy(cand).to(dev)
    vals, idx = ret(params, dense, cand_t)
    ret_s = _timed_calls(lambda: ret(params, dense, cand_t),
                         RECSYS_RETRIEVAL_CALLS)
    with torch.no_grad():
        bot = {k: {n: t.double().cpu() for n, t in v.items()}
               for k, v in params["bot"].items()}
        q = mlp(bot, dense.double().cpu(), final_act=True)
        rows = params["emb"]["table"][cand_t.long()].double().cpu()
        scores = rows @ q[0]
    top = retrieval_errs(vals, idx, scores)
    top_ok = (top["distinct"] and top["err_rank"] <= MODEL_OUT_TOL
              and top["err_values"] <= MODEL_OUT_TOL)
    numel = sum(t.numel() for t in _lm_leaves(params))
    table_bytes = params["emb"]["table"].numel() * 4
    del params
    torch.cuda.empty_cache()
    ok = bool(np.isfinite(losses).all()) and fall > 0 and probs_ok and top_ok
    row = dict(
        config=cfg.name, rows_cap=max(cfg.table_sizes), rows=padded_rows(cfg),
        table_bytes=table_bytes, param_numel=numel,
        train=dict(batch=batch, steps=steps, losses=losses, fall=fall,
                   step_seconds=secs, median_step_seconds=median,
                   samples_per_s=batch / median,
                   max_memory_allocated=peak,
                   step_profile=_profile_row(prof), walk=sizing),
        serve=dict(batch=p99_batch, calls=p99_calls,
                   median_ms=float(np.median(lat)) * 1e3,
                   p99_ms=float(np.percentile(lat, 99)) * 1e3,
                   bulk_batch=bulk_batch, bulk_calls=bulk_calls,
                   bulk_median_s=float(np.median(bulk_s)),
                   bulk_samples_per_s=bulk_batch / float(np.median(bulk_s)),
                   probs_in_range=probs_ok),
        retrieval=dict(candidates=n_cand, calls=RECSYS_RETRIEVAL_CALLS,
                       median_ms=float(np.median(ret_s)) * 1e3, **top),
        ok=ok)
    return row, ok


def recsys_path(dev, smi, full_cfg=None, train=RECSYS_TRAIN,
                serve=RECSYS_SERVE, n_cand=RECSYS_CANDIDATES):
    """The recsys family: DLRM's smoke config card against CPU
    (:func:`recsys_smoke`), then the published widths on the card
    (:func:`recsys_full`).  No hand-written kernel runs here: the JAX
    package has no Pallas kernel on this path."""
    t0 = time.perf_counter()
    smoke, smoke_ok = recsys_smoke(dev)
    t1 = time.perf_counter()
    full, full_ok = recsys_full(dev, full_cfg, train, serve, n_cand)
    ok = smoke_ok and full_ok
    emit("recsys_path", ok=ok, gpu=smi, smoke=smoke, full=full,
         part_seconds=dict(smoke=t1 - t0, full=time.perf_counter() - t1),
         seconds=time.perf_counter() - t0)
    if not smoke_ok:
        fail("DLRM's smoke step, serve or retrieval on the card differs "
             "from the CPU, or the planted pair order went unseen")
    if not full_ok:
        fail("DLRM at full width: a loss not finite or not falling, a "
             "probability out of range, or a top 100 off the float64 "
             "rescoring")
    sizing_fail("DLRM's train step", full["train"]["walk"])


def gnn_smoke_batch(cfg, rng, n=24, e=72):
    """The reference's smoke batch of ``cfg.arch`` (tests/test_arch_smoke.py
    ``_gnn_batch``), as numpy: random edges over ``n`` nodes (self-loops
    included), and the arch's node inputs.  Returns ``(batch, d_feat)``."""
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if cfg.arch in ("nequip", "equiformer_v2"):
        b = dict(species=rng.integers(0, 4, n).astype(np.int32),
                 positions=rng.normal(size=(n, 3)).astype(np.float32),
                 edge_src=src, edge_dst=dst,
                 graph_id=np.zeros(n, np.int32),
                 energy=np.zeros(1, np.float32))
        if cfg.arch == "nequip":
            b["forces"] = np.zeros((n, 3), np.float32)
        return b, 0
    if cfg.arch == "gat":
        d = 16
        return dict(feats=rng.normal(size=(n, d)).astype(np.float32),
                    edge_src=src, edge_dst=dst,
                    labels=rng.integers(0, cfg.d_out, n).astype(np.int32),
                    label_mask=np.ones(n, np.float32)), d
    return dict(feats=rng.normal(size=(n, cfg.n_vars)).astype(np.float32),
                target=rng.normal(size=(n, cfg.n_vars)).astype(np.float32),
                edge_src=src, edge_dst=dst), cfg.n_vars


def gnn_cell_batch(cfg, shape, rng):
    """A synthetic batch of ``shape`` (a ``GNN_SHAPES`` entry) at
    ``gnn_input_specs``' padded sizes, as numpy.  Molecules: each of
    ``batch`` molecules has ``n_nodes`` atoms (positions normal, 1.5 Å)
    and ``n_edges`` edges between two distinct atoms of it; padding atoms
    sit at the origin with ``graph_id = batch`` (dropped by the energy's
    segment sum), padding edges are zero-length loops on the first padding
    atom.  Full graphs: random edges and inputs over every padded node,
    GAT's label mask on the unpadded ones.  Returns ``(batch, d_feat)``."""
    from repro_torch.models.gnn.nequip import N_SPECIES
    from repro_torch.models.gnn_steps import gnn_feat_dim, gnn_input_specs

    specs = gnn_input_specs(cfg, shape)
    e_pad = specs["edge_src"].shape[0]
    d_feat = gnn_feat_dim(cfg, shape)
    if shape["kind"] == "batched":
        mols, atoms, edges = shape["batch"], shape["n_nodes"], shape["n_edges"]
        n_pad = specs["species"].shape[0]
        n, e = mols * atoms, mols * edges
        off = np.repeat(np.arange(mols) * atoms, edges)
        a = rng.integers(0, atoms, e)
        bb = (a + rng.integers(1, atoms, e)) % atoms
        src = np.full(e_pad, n, np.int64)
        dst = np.full(e_pad, n, np.int64)
        src[:e], dst[:e] = a + off, bb + off
        pos = np.zeros((n_pad, 3), np.float32)
        pos[:n] = 1.5 * rng.normal(size=(n, 3))
        gid = np.full(n_pad, mols, np.int32)
        gid[:n] = np.repeat(np.arange(mols), atoms)
        species = np.zeros(n_pad, np.int32)
        species[:n] = rng.integers(0, N_SPECIES, n)
        b = dict(species=species, positions=pos, edge_src=src.astype(np.int32),
                 edge_dst=dst.astype(np.int32), graph_id=gid,
                 energy=rng.normal(size=mols).astype(np.float32))
        if cfg.arch == "nequip":
            forces = np.zeros((n_pad, 3), np.float32)
            forces[:n] = 0.1 * rng.normal(size=(n, 3))
            b["forces"] = forces
        return b, d_feat
    n_pad = specs["feats"].shape[0]
    src = rng.integers(0, n_pad, e_pad).astype(np.int32)
    dst = rng.integers(0, n_pad, e_pad).astype(np.int32)
    feats = rng.normal(size=specs["feats"].shape).astype(np.float32)
    if cfg.arch == "gat":
        mask = np.zeros(n_pad, np.float32)
        mask[:shape["n_nodes"]] = 1
        return dict(feats=feats, edge_src=src, edge_dst=dst,
                    labels=rng.integers(0, cfg.d_out, n_pad).astype(np.int32),
                    label_mask=mask), d_feat
    return dict(feats=feats, edge_src=src, edge_dst=dst,
                target=rng.normal(size=feats.shape).astype(np.float32)), d_feat


def gnn_train_once(cfg, params, batch, dev, d_feat):
    """One ``build_gnn_train_step`` call on ``dev`` from a fresh optimiser
    state: ``(params, opt_state, metrics)``."""
    from repro_torch.models.gnn_steps import build_gnn_train_step

    build, info = build_gnn_train_step(cfg, None, d_feat, device=dev)
    params = _lm_to(params, dev)
    return build(batch)(params, info["opt_init"](params), batch, 0)


@contextlib.contextmanager
def _planted_dropped_forces():
    """A NequIP fault planted for the block: the loss's force term reads
    zero forces (the energy term kept), so the second-order gradient
    through the forces is gone."""
    from repro_torch.models import gnn_steps

    own = gnn_steps.nequip_energy_forces

    def energy_only(*args):
        e, f = own(*args)
        return e, torch.zeros_like(f)

    gnn_steps.nequip_energy_forces = energy_only
    try:
        yield
    finally:
        gnn_steps.nequip_energy_forces = own


def gnn_smoke(dev, names=GNN_ARCH_NAMES, seed=3):
    """Every GNN ``-smoke`` config card against CPU: one train step of
    :func:`gnn_smoke_batch` from one parameter set drawn on the CPU, held
    by :func:`step_errs` (AdamW at 5e-3); then NequIP's card step again
    with the force term planted out of the loss, which the same check must
    catch."""
    from repro_torch.configs import get_config
    from repro_torch.models.gnn_steps import gnn_init

    cpu = torch.device("cpu")
    rows, bad = {}, []
    for name in names:
        cfg = get_config(name + "-smoke")
        b, d_feat = gnn_smoke_batch(cfg, np.random.default_rng(seed))
        params = gnn_init(torch.Generator().manual_seed(0), cfg, d_feat,
                          device=cpu)
        ref = gnn_train_once(cfg, params, _tensors(b, cpu), cpu, d_feat)
        got = gnn_train_once(cfg, params, _tensors(b, dev), dev, d_feat)
        errs, ok = step_errs(got, ref, MODEL_STEP_TOL, lr_t=5e-3, step=0)
        row = dict(ok=ok, loss_cpu=float(ref[2]["loss"]),
                   **{f"err_{k}": v for k, v in errs.items()})
        if cfg.arch == "nequip":
            with _planted_dropped_forces():
                planted = gnn_train_once(cfg, params, _tensors(b, dev), dev,
                                         d_feat)
            perrs, pok = step_errs(planted, ref, MODEL_STEP_TOL, lr_t=5e-3,
                                   step=0)
            row["planted_dropped_forces"] = dict(
                caught=not pok, **{f"err_{k}": v for k, v in perrs.items()})
            ok = ok and not pok
            row["ok"] = ok
        rows[name + "-smoke"] = row
        if not ok:
            bad.append(name + "-smoke")
    return rows, bad


def equivariance_checks(dev):
    """The reference's two equivariance tests (tests/test_arch_smoke.py)
    on ``dev`` with the smoke configs and a scipy rotation: NequIP's and
    Equiformer-v2's energy unchanged by rotating the positions, NequIP's
    forces rotating with them, within the reference's bounds
    (``EQUIV_NEQUIP``, ``EQUIV_EQUIFORMER``).  Returns ``(row, ok)``."""
    from scipy.spatial.transform import Rotation

    from repro_torch.configs import get_config
    from repro_torch.models.gnn.equiformer_v2 import equiformer_energy
    from repro_torch.models.gnn.nequip import (nequip_energy,
                                               nequip_energy_forces)
    from repro_torch.models.gnn_steps import gnn_init

    def inputs(seed, n, e, rot_seed):
        rng = np.random.default_rng(seed)
        t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
        src = t(rng.integers(0, n, e), torch.int32)
        dst = t(rng.integers(0, n, e), torch.int32)
        species = t(rng.integers(0, 4, n), torch.int32)
        pos = t(rng.normal(size=(n, 3)), torch.float32)
        rot = t(Rotation.random(random_state=rot_seed).as_matrix(),
                torch.float32)
        return (species, pos, src, dst, torch.zeros(n, dtype=torch.int32,
                                                     device=dev)), rot

    def init(name):
        cfg = get_config(name)
        return cfg, _lm_to(gnn_init(torch.Generator().manual_seed(0), cfg, 0,
                                    device="cpu"), dev)

    row = {}
    (species, pos, src, dst, gid), rot = inputs(7, 16, 48, 5)
    for key, name, energy, tol in (
            ("nequip_energy", "nequip-smoke", nequip_energy, EQUIV_NEQUIP),
            ("equiformer_energy", "equiformer-v2-smoke", equiformer_energy,
             EQUIV_EQUIFORMER)):
        cfg, p = init(name)
        with torch.no_grad():
            e1 = float(energy(p, cfg, species, pos, src, dst, gid, 1)[0])
            e2 = float(energy(p, cfg, species, pos @ rot.T, src, dst, gid,
                              1)[0])
        bound = tol["atol"] + tol["rtol"] * abs(e1)
        row[key] = dict(e=e1, e_rotated=e2, diff=abs(e1 - e2), bound=bound,
                        ok=abs(e1 - e2) < bound)
    (species, pos, src, dst, gid), rot = inputs(11, 12, 36, 2)
    cfg, p = init("nequip-smoke")
    with torch.no_grad():
        _, f1 = nequip_energy_forces(p, cfg, species, pos, src, dst, gid, 1)
        _, f2 = nequip_energy_forces(p, cfg, species, pos @ rot.T, src, dst,
                                     gid, 1)
    diff = float((f1 @ rot.T - f2).abs().max())
    row["nequip_forces"] = dict(diff=diff, bound=EQUIV_NEQUIP["force_atol"],
                                ok=diff <= EQUIV_NEQUIP["force_atol"])
    ok = all(r["ok"] for r in row.values())
    return row, ok


def gnn_full_step(dev, name, shape, steps=GNN_FULL_STEPS, seed=0):
    """``name`` at its published widths on the card: parameters drawn
    there, ``steps`` train steps on one :func:`gnn_cell_batch` of
    ``shape`` (each step's seconds, the median of steps 2 on, every loss
    finite), one step's launches and busy share from the profiler, and
    ``max_memory_allocated``."""
    from repro_torch.configs import GNN_SHAPES, get_config
    from repro_torch.models.gnn_steps import build_gnn_train_step, gnn_init

    cfg = get_config(name)
    shape = GNN_SHAPES[shape] if isinstance(shape, str) else shape
    b, d_feat = gnn_cell_batch(cfg, shape, np.random.default_rng(seed))
    b = _tensors(b, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params = gnn_init(torch.Generator(device=dev).manual_seed(seed), cfg,
                      d_feat, device=dev)
    build, info = build_gnn_train_step(cfg, None, d_feat, device=dev)
    fn = build(b)
    opt = info["opt_init"](params)
    losses, secs = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = fn(params, opt, b, step)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    sizing = None
    if cfg.arch in GNN_SIZED:  # the batch was staged before the peak
        sizing, _ = walk_sizing(cfg, shape, peak, excluded=sum(
            t.numel() * t.element_size() for t in b.values()))
    prof = profile_count(lambda: fn(params, opt, b, steps), 0, kernel="\0",
                         label="gnn", cpu=False)
    nodes = b["species" if "species" in b else "feats"].shape[0]
    row = dict(config=name, nodes=nodes, edges=int(b["edge_src"].shape[0]),
               param_numel=sum(t.numel() for t in _lm_leaves(params)),
               losses=losses, step_seconds=secs,
               median_step_seconds=float(np.median(secs[1:])),
               max_memory_allocated=peak, step_profile=_profile_row(prof))
    if sizing is not None:
        row["walk"] = sizing
    del params, opt, b
    torch.cuda.empty_cache()
    ok = bool(np.isfinite(losses).all())
    return row, ok


def gnn_example(dev):
    """``repro_torch.examples.train_gnn`` on ``dev`` in this process: the
    full ``gat-cora`` config, 200 steps on the seeded SBM graph, its
    checkpoints in a temporary directory; held-out accuracy over 0.7."""
    from repro_torch.examples import train_gnn

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_gnn_") as d:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = train_gnn.main(["--device", str(dev), "--ckpt-dir", d])
        saved = sorted(os.listdir(d))
    ok = res["accuracy"] > 0.7
    return dict(res, checkpoints=saved, lines=out.getvalue().splitlines(),
                seconds=time.perf_counter() - t0, ok=ok), ok


def gnn_path(dev, smi, full=(("equiformer-v2", MOLECULE),
                             ("nequip", MOLECULE),
                             ("graphcast", "full_graph_sm"),
                             ("gat-cora", "full_graph_sm")),
             steps=GNN_FULL_STEPS):
    """The GNN family: every ``-smoke`` config's train step card against
    CPU with a planted NequIP fault (:func:`gnn_smoke`), the equivariance
    checks on the card (:func:`equivariance_checks`), each of ``full`` at
    its published widths on its cell (:func:`gnn_full_step`), and the
    ``train_gnn`` example (:func:`gnn_example`).  No hand-written kernel
    runs here: the JAX package has no Pallas kernel on this path."""
    t0 = time.perf_counter()
    secs = {}

    def timed(key, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        secs[key] = time.perf_counter() - t
        return out

    smoke, bad = timed("smoke", gnn_smoke, dev)
    equiv, equiv_ok = timed("equivariance", equivariance_checks, dev)
    rows = {}
    for name, shape in full:
        rows[name], ok = timed(name, gnn_full_step, dev, name, shape, steps)
        if not ok:
            bad.append(name)
    example, example_ok = timed("train_gnn", gnn_example, dev)
    ok = not bad and equiv_ok and example_ok
    emit("gnn_path", ok=ok, gpu=smi, failed=bad, smoke=smoke,
         equivariance=equiv, full=rows, train_gnn=example,
         part_seconds=secs, seconds=time.perf_counter() - t0)
    if bad:
        fail(f"GNN steps on the card differ from the CPU, a planted fault "
             f"went unseen, or a full-width loss is not finite: {bad}")
    if not equiv_ok:
        fail("a GNN's energy or forces on the card are not equivariant "
             "within the reference's bounds")
    if not example_ok:
        fail("the train_gnn example on the card did not reach held-out "
             "accuracy 0.7")
    for name, row in rows.items():
        if "walk" in row:
            sizing_fail(f"{name}'s train step", row["walk"])


# ----------------------------------------------------------------------
# what ptxas says of each kernel
# ----------------------------------------------------------------------
def start_ptxas(_build):
    """``nvcc -Xptxas -v`` on every kernel source, with the build's flags
    but into a throwaway cubin under ``build/``, all started together;
    returns the processes."""
    procs = {}
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    for name in _build.kernel_names():
        cmd = [_build._find_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
               str(_build.build_dir() / f"{name}.ptxas.cubin"),
               str(_build.source_path(name))]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    return procs


def finish_ptxas(procs, _build):
    """Registers, shared memory and spills of every kernel, by function
    (named as ``cu++filt``, which ships with ``nvcc``, demangles it)."""
    import re

    out = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc -Xptxas -v failed for {name}:\n{text}")
        fn = None
        for line in text.splitlines():
            hit = re.search(r"Compiling entry function '(\w+)'", line)
            if hit:
                fn = hit.group(1)
                out[fn] = {}
            elif fn is not None:
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("smem_bytes", r"(\d+) bytes smem"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads")):
                    hit = re.search(pat, line)
                    if hit:
                        out[fn][key] = int(hit.group(1))
    filt = os.path.join(os.path.dirname(_build._find_nvcc()), "cu++filt")
    names = subprocess.run([filt, *out], capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return dict(zip(names, out.values()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="log2 of the main path's vertex count")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels, run the main path (its plan "
                         "and oracle), then only mesh_path, "
                         "mesh_runtime_path and lm_mesh_path (one card a "
                         "position where there are four cards, and then "
                         "lm_mesh_big), and stop (no kernels line and no "
                         "final line: this is not the smoke test)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script only runs on a GPU", file=sys.stderr)
        sys.exit(2)

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

    ptxas = start_ptxas(_build)
    build_s = _build.build_all()
    emit("build", seconds=build_s, kernels=_build.kernel_names(),
         flags=" ".join(_build.NVCC_FLAGS), build_dir=str(_build.build_dir()),
         ptxas=finish_ptxas(ptxas, _build))
    from repro_torch.launch.roofline import measure_hw

    emit("hw", gpu=smi, **measure_hw(dev))

    emit("traps", ok=True, checked=run_traps(dev))
    emit("fused_traps", ok=True, checked=run_fused_traps(dev),
         cases=list(fused_trap_cases()))

    phases = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
        return out

    art, launches, g, oracle = phase("main_path", main_path, args.scale,
                                     EDGE_FACTOR, args.seed, GRID, dev)
    graph = f"rmat:{args.scale},{EDGE_FACTOR},{args.seed}"
    if args.mesh_only:
        del art
        phase("mesh_path", mesh_path, g, oracle, dev, GRID)
        phase("mesh_runtime_path", mesh_runtime_path, g, oracle, dev, GRID,
              graph)
        del g
        cards = mesh_cards(math.prod(LM_MESH))
        phase("lm_mesh_path", lm_mesh_path, dev, smi, cards)
        if len(set(cards)) == len(cards):
            phase("lm_mesh_big", lm_mesh_big, cards, smi)
        emit("total", seconds=time.perf_counter() - t_start, phases=phases,
             mesh_only=True)
        return
    kernels = [phase("kernels", kernel_report, art, dev, launches)]
    phase("dryrun_path", dryrun_path, dev, art.plan, args.scale)
    del art
    phase("substrate_path", substrate_path, dev)
    phase("lm_path", lm_path, dev, smi)
    phase("lm_train_path", lm_train_path, dev, smi)
    phase("lm_mesh_path", lm_mesh_path, dev, smi)
    phase("recsys_path", recsys_path, dev, smi)
    phase("gnn_path", gnn_path, dev, smi)
    kernels.append(phase("pod_path", pod_path, g, oracle, dev, GRID))
    # search2 first: the runtime's persistent-fault count is demoted to
    # its cached plan
    phase("search2", search2_phase, g, oracle, GRID, args.scale, args.seed)
    kernels.append(phase("runtime_path", runtime_path, g, oracle, dev, GRID,
                         graph))
    measured, measured_ok = {}, True
    with tempfile.TemporaryDirectory(prefix="tc_measured_") as table_dir:
        # each schedule's measured counts run while the plan of the phase
        # before is still in the plan cache
        def measure(kind, grid):
            nonlocal measured_ok
            measured[kind], ok = phase("measured_path", measured_count, kind,
                                       g, oracle, dev, grid, table_dir)
            measured_ok = measured_ok and ok

        measure("cannon", (GRID, GRID))
        kernels.append(phase("delta_path", delta_path, g, oracle, dev, GRID,
                             args.seed))
        kernels.append(phase("serve_path", serve_path, g, oracle, dev, GRID,
                             graph))
        phase("rebalance_path", rebalance_path, g, oracle, dev, GRID)
        for kind, grid in (("summa", SUMMA_GRID), ("oned", (GRID, GRID))):
            sart, slaunches, steps = phase(f"{kind}_path", schedule_path,
                                           kind, g, oracle, dev, grid, graph)
            kernels.append(phase(f"{kind}_path", schedule_kernel_report,
                                 kind, sart, dev, slaunches, steps))
            del sart
            measure(kind, grid)
    emit("measured_path", ok=measured_ok, graph=graph,
         triangles_scipy_oracle=oracle,
         seconds=phases["measured_path"], **measured)
    if not measured_ok:
        fail("the measured autotune path miscounted, missed or hit its "
             "table wrongly, or a candidate shape disagreed with the plain "
             "route")
    kernels += phase("hub_path", hub_path, g, oracle, dev, graph)
    phase("mesh_path", mesh_path, g, oracle, dev, GRID)
    phase("mesh_runtime_path", mesh_runtime_path, g, oracle, dev, GRID, graph)
    del g
    phase("small_graphs", small_graphs)
    phase("many_path", many_path, dev, args.seed,
          tuple(s - (20 - args.scale) for s in MANY_SCALES))
    phase("tile_traps", run_tile_traps, dev)
    tile_scale = min(TILE_SCALE, args.scale - 2)
    kernels += phase("tile_path", tile_path, tile_scale, args.seed, GRID,
                     dev)
    phase("tile_density", tile_density, dev, args.seed)

    emit("total", seconds=time.perf_counter() - t_start, phases=phases)
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
