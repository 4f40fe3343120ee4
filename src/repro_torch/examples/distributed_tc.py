"""End-to-end distributed triangle counting (the paper's application).

    PYTHONPATH=src python -m repro_torch.examples.distributed_tc [--device cpu]

Runs the 4 x 4 Cannon grid, the 2.5D variant with two pods of 2 x 2, the
SUMMA rectangular schedule on 2 x 8 and the 1D baseline on a ring of 16
on the same graph — every logical grid held on one device — and all must
agree with the oracle.  Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from repro_torch.core import count_triangles, rmat, triangle_count_oracle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without one)")
    args = ap.parse_args(argv)
    dev = args.device

    g = rmat(12, 16, seed=3)
    exp = triangle_count_oracle(g)
    print(f"graph n={g.n} m={g.m} expected={exp}")

    r = count_triangles(g, q=4, schedule="cannon", device=dev)
    print(f"cannon 4x4      : {r.triangles}  tct={r.count_seconds:.3f}s")
    assert r.triangles == exp

    r = count_triangles(g, q=2, npods=2, schedule="cannon", device=dev)
    print(f"2.5D 2x(2x2)    : {r.triangles}  tct={r.count_seconds:.3f}s")
    assert r.triangles == exp

    r = count_triangles(g, grid=(2, 8), schedule="summa", device=dev)
    print(f"summa 2x8       : {r.triangles}  tct={r.count_seconds:.3f}s")
    assert r.triangles == exp

    r = count_triangles(g, q=4, schedule="oned", device=dev)
    print(f"1D baseline p=16: {r.triangles}  tct={r.count_seconds:.3f}s")
    assert r.triangles == exp
    print("all schedules agree ✓")


if __name__ == "__main__":
    main()
