"""Re-measure the fused kernel's design choices on a GPU.

    PYTHONPATH=src python -m repro_torch.launch.fused_sweep --scale 20

Plans ``rmat(scale, 16, seed)`` on a 4 x 4 grid as ``count_triangles(
method="fused")`` does and times the fused kernel on logical device
(0, 0) at step 0 (cold L2, median of 10) and, summed, on all 64
device-steps — built from ``kernels/csrc/tc_fused.cu`` as it stands and
with one change at a time:

* ``kRatio`` at 1, 3, 4 and "B ids only" (how much longer B may be than A
  before A's ids are searched in B instead);
* the grid capped at 1, 2 and 4 blocks an SM (how far more warps in
  flight still help);
* the tile at 8, 16 and 64 tasks;
* two cuts that show where the time goes: ``no_search`` (each probe's
  search replaced by one compare: task loads, runs, staging and the probe
  loads only) and ``skeleton`` (no probes at all).

Every variant but the cuts must give the kernel's count on all 64
device-steps.  Prints the card's name and power limit, the task runs of
device (0, 0) at step 0 (consecutive tasks with the same A row, the unit
the kernel stages a row for), then one JSON line per variant.  Variants
are compiled from edited copies of the source into ``build/fused_sweep/``
(one ``nvcc`` each, started together); the package's own library is not
touched.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from ..kernels import _build
from ..kernels.tc_fused import fused_split_sizes, fused_tile_for
from ..kernels.tc_fused.tc_fused import fused_tiles

GRID = "(long long)sms * std::max(per_sm, 1)"
SEARCH_B = ("hits += contains(a_row, a_len, "
            "__ldg(b_indices + s.b_start[k] + e));")
SEARCH_A = ("hits += contains(b_indices + s.b_start[k], s.b_len[k], "
            "a_row[e]);")
PROBE_LOOP = "for (int pos = p0 + lane; pos < p1; pos += 32) {"


def _set(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f"tc_fused.cu no longer holds {old!r} {count}x")
    return src.replace(old, new)


def _ratio(src: str, r: int) -> str:
    out, n = re.subn(r"constexpr int kRatio = \d+;",
                     f"constexpr int kRatio = {r};", src)
    if n != 1:
        raise ValueError("tc_fused.cu no longer defines kRatio")
    return out


def variants(src: str):
    """name -> (source, tile or None, must_equal)."""
    out = {"kernel": (src, None, True)}
    for r, name in ((1, "ratio_1"), (3, "ratio_3"), (4, "ratio_4"),
                    (1 << 20, "b_ids_only")):
        out[name] = (_ratio(src, r), None, True)
    for k in (1, 2, 4):
        out[f"grid_{k}_blocks_per_sm"] = (_set(
            src, GRID, f"(long long)sms * std::min(std::max(per_sm, 1), {k})"),
            None, True)
    for tile in (8, 16, 64):
        out[f"tile_{tile}"] = (src, tile, True)
    no_search = _set(src, SEARCH_B,
                     "hits += __ldg(b_indices + s.b_start[k] + e) == -1;")
    out["no_search"] = (_set(no_search, SEARCH_A, "hits += a_row[e] == -1;"),
                        None, False)
    out["skeleton"] = (_set(src, PROBE_LOOP, PROBE_LOOP.replace(
        "pos < p1", "pos < p0"), 2), None, False)
    return out


def build(sources):
    """Compile each distinct source; name -> (library, ptxas registers)."""
    out_dir = _build.build_dir() / "fused_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        path = out_dir / f"{name}.cu"
        path.write_text(src)
        cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(out_dir / f"lib{name}.so"), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out_dir / f"lib{name}.so")
    libs = {}
    for name, (proc, lib_path) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        lib = ctypes.CDLL(str(lib_path))
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tc_fused_counts.argtypes = [p, p, p, p, p, p, ll, ll, ll, i, i, i,
                                        i, i, p, p, i]
        lib.tc_fused_counts.restype = ctypes.c_int
        regs = re.findall(r"Used (\d+) registers", text)
        libs[name] = (lib, int(regs[0]) if regs else None)
    return libs


def step_inputs(art, dev, x, y, step):
    """What logical device (x, y) hands the kernel at Cannon step ``step``
    (A of block (x, y + step), B of (x + step, y)), and the launch's
    keywords as ``count_pair_fused`` sets them."""
    plan, st, q = art.plan, art.staged(dev), art.plan.q
    ay, bx = (y + step) % q, (x + step) % q
    args = (st["a_indptr"][x, ay], st["a_indices"][x, ay],
            st["b_indptr"][bx, y], st["b_indices"][bx, y],
            st["m_ti"][x, y], st["m_tj"][x, y])
    n_long, _ = fused_split_sizes(plan.tmax, plan.n_long, plan.chunk)
    d = int(max(1, min(plan.d_small, args[1].shape[0], args[3].shape[0])))
    return args, int(plan.m_cnt[x, y]), dict(
        n_long=n_long, tile=fused_tile_for(d), d_long=plan.dmax, d_short=d)


def run_stats(args, tcount, kw):
    """Runs of equal ``ti`` in each bucket of one device-step's live tasks
    (tile and batch edges aside): how many, and their mean length."""
    ti = args[4][:tcount].cpu().numpy()
    out = {}
    n_long = kw["n_long"]
    for name, part in (("long", ti[:n_long]), ("short", ti[n_long:])):
        runs = (int(np.count_nonzero(part[1:] != part[:-1]) + 1)
                if part.size else 0)
        out[name] = dict(tasks=int(part.size), runs=runs,
                         mean_tasks_per_run=part.size / runs if runs else None)
    return out


def launch(lib, args, tcount, kw, tile=None):
    tile = tile or kw["tile"]
    tmax = args[4].shape[0]
    ntile = fused_tiles(tmax, kw["n_long"], tile)[1]
    out = torch.empty(ntile, dtype=torch.int32, device=args[0].device)
    rc = lib.tc_fused_counts(
        *[a.data_ptr() for a in args], tcount, tmax, kw["n_long"], tile,
        kw["d_long"], -1, kw["d_short"], ntile, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream, out.device.index)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out


def time_cold(fn, reps, flush):
    """Median event time (ms) of ``fn`` over ``reps`` runs, L2 overwritten
    before each."""
    fn()
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_sweep needs a CUDA device")
    import repro_torch as rt
    from repro_torch.pipeline import PlanCache, plan_cannon

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    src = _build.source_path("tc_fused").read_text()
    table = variants(src)
    libs = build({name: s for name, (s, _, _) in table.items()})
    dev = torch.device("cuda", 0)
    g = rt.rmat(args.scale, 16, seed=args.seed)
    art = plan_cannon(g, 4, autotune="fused", cache=PlanCache())
    steps = [step_inputs(art, dev, x, y, s)
             for s in range(4) for x in range(4) for y in range(4)]
    print(json.dumps({"runs": run_stats(*steps[0])}), flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    lib0 = libs["kernel"][0]
    want = [int(launch(lib0, a, t, kw).sum()) for a, t, kw in steps]
    for name, (_, tile, must_equal) in table.items():
        lib, regs = libs[name]
        got = [int(launch(lib, a, t, kw, tile).sum()) for a, t, kw in steps]
        if must_equal and got != want:
            raise SystemExit(f"variant {name} miscounts: {got} != {want}")
        a0, t0, kw0 = steps[0]
        ms = time_cold(lambda: launch(lib, a0, t0, kw0, tile), 10, flush)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for a, t, kw in steps:
            launch(lib, a, t, kw, tile)
        e1.record()
        torch.cuda.synchronize()
        print(json.dumps(dict(
            variant=name, registers=regs, tile=tile or kw0["tile"],
            ms_step_0_0=ms, ms_all_64_steps=e0.elapsed_time(e1),
            equal=got == want)), flush=True)


if __name__ == "__main__":
    main()
