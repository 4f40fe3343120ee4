"""Size the tile path: what the tile plan costs the host, and the device.

    python -m repro_torch.launch.tile_sizing --scales 18 19 20 \\
        --out tile_sizing.jsonl

For each ``rmat(scale, 16, seed=1)`` on the 4 x 4 grid of
``chip_smoke.py``'s tile path: plans the graph as
``count_triangles(method="tile")`` does, then times ``build_tile_plan``
(pack + join) alone and samples the process's resident memory while it
runs.  Reports ``nt_pad``, ``trip_pad``, the triples, the bytes of the
three tile stores and the triple array, and one cold and one warm
``method="tile"`` count on ``--device`` with its peak device bytes.  One
JSON line per scale; the scales run one after another in this process,
each with a fresh plan cache.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import threading
import time


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class _RssPeak:
    """Highest resident set size seen while the block runs (sampled)."""

    def __init__(self, every: float = 0.02):
        self.every, self.peak = every, 0
        self._stop = threading.Event()

    def _poll(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, _rss_bytes())
            self._stop.wait(self.every)

    def __enter__(self):
        self.before = self.peak = _rss_bytes()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())


EDGE_FACTOR, SEED, GRID = 16, 1, 4


def size_one(scale, device=None):
    import torch

    from ..core import count_triangles, rmat
    from ..core.tiles import build_tile_plan
    from ..device import resolve_device
    from ..pipeline import PlanCache, plan_cannon

    q = GRID
    t0 = time.perf_counter()
    g = rmat(scale, EDGE_FACTOR, seed=SEED)
    rec = dict(graph=f"rmat:{scale},{EDGE_FACTOR},{SEED}", n=g.n, m=g.m, q=q,
               generate_seconds=time.perf_counter() - t0)
    cache = PlanCache()
    t0 = time.perf_counter()
    # the knobs count_triangles(method="tile") plans with, so the count
    # below hits this artifact
    art = plan_cannon(g, q, chunk=512, reorder=True, keep_blocks=True,
                      compact=True, autotune=False, aug_keys=False,
                      cache=cache)
    rec["csr_plan_seconds"] = time.perf_counter() - t0
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        tp = build_tile_plan(art)
        rec["tile_plan_seconds"] = time.perf_counter() - t0
    stores = tp.a_tiles.nbytes + tp.b_tiles.nbytes + tp.m_tiles.nbytes
    rec.update(
        host_rss_before_bytes=rss.before, host_rss_peak_bytes=rss.peak,
        host_rss_peak_growth_bytes=rss.peak - rss.before,
        nt_pad=tp.nt_pad, trip_pad=tp.trip_pad, stats=tp.stats,
        store_bytes=int(stores), triple_array_bytes=int(tp.triples.nbytes),
    )
    dev = resolve_device(device)
    art.memo("tile_plan", lambda: tp)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    r = count_triangles(g, q=q, method="tile", device=dev, cache=cache)
    if r.artifact is not art:
        raise RuntimeError("the count re-planned the graph")
    r2 = count_triangles(g, q=q, method="tile", device=dev, cache=cache)
    rec.update(
        device=str(dev), triangles=r.triangles, triangles_repeat=r2.triangles,
        tile_stage_seconds=art.stage_seconds.get("tile_stage"),
        count_seconds=r.count_seconds, warm_count_seconds=r2.count_seconds,
        peak_device_bytes=(int(torch.cuda.max_memory_allocated(dev))
                           if cuda else None),
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scales", type=int, nargs="+", default=[18, 19, 20])
    ap.add_argument("--device", default=None,
                    help="torch device of the count; default: cuda")
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    rows = []
    for scale in args.scales:
        rec = size_one(scale, args.device)
        line = json.dumps({"tile_sizing": rec})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        rows.append(rec)
        gc.collect()
    return rows


if __name__ == "__main__":
    main()
