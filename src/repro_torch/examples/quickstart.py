"""Quickstart: count triangles with the paper's 2D algorithm.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs the full pipeline (degree-order preprocess -> 2D-cyclic plan ->
Cannon schedule) on a generated Graph500 RMAT graph and verifies against
the exact host oracle.  On a 1 x 1 grid the code path is the one a
4 x 4 grid runs.  Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from repro_torch.core import count_triangles, rmat, triangle_count_oracle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without one)")
    args = ap.parse_args(argv)

    g = rmat(scale=12, edge_factor=16, seed=7)
    print(f"graph: {g.name}  n={g.n}  m={g.m}")

    res = count_triangles(g, q=1, schedule="cannon", method="search",
                          device=args.device)
    print(f"triangles           : {res.triangles}")
    print(f"preprocess seconds  : {res.preprocess_seconds:.3f}")
    print(f"count seconds       : {res.count_seconds:.3f}")

    expected = triangle_count_oracle(g)
    assert res.triangles == expected, (res.triangles, expected)
    print(f"verified against host oracle: {expected} ✓")

    # the ⟨i,j,k⟩ probe direction (paper §3) gives the same count
    res2 = count_triangles(g, q=1, probe_shorter=False, device=args.device)
    assert res2.triangles == expected
    print("⟨j,i,k⟩ and ⟨i,j,k⟩ enumeration agree ✓")


if __name__ == "__main__":
    main()
