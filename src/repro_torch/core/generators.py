"""Graph generators: Graph500 RMAT, Erdős–Rényi, and small named graphs.

The paper evaluates on twitter/friendster (real) and graph500 RMAT scales
26–29 (synthetic, generated in memory "prior to calling the triangle
counting routine" — we follow the same pattern).  The RMAT generator here is
fully vectorized numpy and deterministic given a seed, so benchmarks and
tests can regenerate identical graphs.

Graph500 RMAT parameters: (a, b, c, d) = (0.57, 0.19, 0.19, 0.05),
edge factor 16 (directed edge samples; after dedup/symmetrization the
undirected edge count is lower, as in the reference generator).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .graph import Graph

__all__ = [
    "rmat",
    "erdos_renyi",
    "powerlaw",
    "star",
    "residue_cliques",
    "random_edge_flips",
    "flip_edges",
    "named_graph",
    "graph_from_spec",
    "GRAPH500_PARAMS",
]

GRAPH500_PARAMS = (0.57, 0.19, 0.19, 0.05)


def rmat(
    scale: int,
    edge_factor: int = 16,
    params=GRAPH500_PARAMS,
    seed: int = 0,
    name: Optional[str] = None,
) -> Graph:
    """Graph500-style RMAT graph with ``n = 2**scale`` vertices.

    Each of ``edge_factor * n`` directed edge samples picks one quadrant
    per bit level; samples are then symmetrized/deduplicated into a simple
    undirected graph (exactly what the paper does with the graph500
    generator output).
    """
    n = 1 << scale
    m_samples = edge_factor * n
    a, b, c, d = params
    rng = np.random.default_rng(seed)

    src = np.zeros(m_samples, dtype=np.int64)
    dst = np.zeros(m_samples, dtype=np.int64)
    # Per level: choose quadrant with probs (a, b, c, d);
    # bit_i of src += quadrant in {2, 3}; bit_i of dst += quadrant in {1, 3}.
    # Graph500 also perturbs probabilities per level by +-10%; we keep the
    # canonical fixed probabilities for reproducibility.
    for level in range(scale):
        u = rng.random(m_samples)
        quad = (u >= a).astype(np.int64) + (u >= a + b) + (u >= a + b + c)
        src |= (quad >> 1) << level
        dst |= (quad & 1) << level
    return Graph.from_edges(n, src, dst, name=name or f"rmat-s{scale}")


def erdos_renyi(n: int, avg_degree: float, seed: int = 0, name=None) -> Graph:
    """G(n, m) random graph with ~``avg_degree * n / 2`` undirected edges."""
    rng = np.random.default_rng(seed)
    m = int(avg_degree * n / 2)
    src = rng.integers(0, n, size=2 * m)  # oversample to survive dedup
    dst = rng.integers(0, n, size=2 * m)
    g = Graph.from_edges(n, src, dst, name=name or f"er-{n}")
    if g.m > m:
        g = Graph(n=n, edges=g.edges[:m], name=g.name)
    return g


def powerlaw(
    n: int,
    alpha: float = 2.5,
    avg_degree: float = 8.0,
    seed: int = 0,
    name=None,
) -> Graph:
    """Chung–Lu-style skewed-degree fixture, deterministic given ``seed``.

    Endpoint ``v`` is drawn with probability ∝ ``(v + 1)^(-1/(alpha-1))``
    (the expected-degree sequence of a power law with exponent ``alpha``),
    so low ids become hubs and the degree distribution is heavy-tailed —
    the imbalance regime where the skip-aware rebalancer has real ties to
    break (many equal-degree leaves) *and* real stragglers to spread
    (hub-heavy blocks).  Sampled edges are deduplicated/symmetrized like
    :func:`erdos_renyi`.
    """
    assert alpha > 1.0, "powerlaw needs alpha > 1"
    rng = np.random.default_rng(seed)
    w = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (alpha - 1.0))
    p = w / w.sum()
    m = int(avg_degree * n / 2)
    src = rng.choice(n, size=2 * m, p=p)  # oversample to survive dedup
    dst = rng.choice(n, size=2 * m, p=p)
    g = Graph.from_edges(n, src, dst, name=name or f"powerlaw-{n}")
    if g.m > m:
        g = Graph(n=n, edges=g.edges[:m], name=g.name)
    return g


def star(n: int, name=None) -> Graph:
    """Hub-and-spoke graph on ``n`` vertices (0 triangles).

    Under the 2D cyclic decomposition every edge lands in the hub's
    block column, leaving most blocks empty — a skip-mask stressor.
    """
    assert n >= 2
    src = np.zeros(n - 1, dtype=np.int64)
    dst = np.arange(1, n, dtype=np.int64)
    return Graph.from_edges(n, src, dst, name=name or f"star-{n}")


def residue_cliques(k: int, size: int, name=None) -> Graph:
    """Block-diagonal fixture: ``k`` disjoint cliques of ``size`` vertices,
    clique ``r`` on the residue class ``{v : v % k == r}``.

    On a ``k x k`` grid every edge satisfies ``i ≡ j (mod k)``, so only
    the diagonal blocks of the cyclic decomposition are non-empty and
    each diagonal device has exactly one live Cannon shift — the other
    ``k^3 - k`` (device, shift) pairs are skippable.  Triangle count is
    ``k * C(size, 3)`` (non-zero, unlike a star), so a miscounting
    masked engine cannot hide.
    """
    assert k >= 1 and size >= 1
    n = k * size
    members = np.arange(size, dtype=np.int64)
    iu, ju = np.triu_indices(size, k=1)
    src, dst = [], []
    for r in range(k):
        verts = members * k + r  # residue class r, local order preserved
        src.append(verts[iu])
        dst.append(verts[ju])
    return Graph.from_edges(
        n,
        np.concatenate(src) if src else np.zeros(0, np.int64),
        np.concatenate(dst) if dst else np.zeros(0, np.int64),
        name=name or f"cliques-{k}x{size}",
    )


def random_edge_flips(graph: Graph, k: int, seed: int):
    """Sample ``k`` deterministic random edge flips of ``graph``.

    A sampled vertex pair that is already an edge becomes a removal,
    an absent pair an addition — the mutation model behind the
    ``delta:`` graph spec.  Pairs are
    distinct (no pair is flipped twice) and self loops are never drawn.
    Returns ``(add, remove)`` as ``(ka, 2)`` / ``(kr, 2)`` int64 arrays
    with ``ka + kr == k``.
    """
    n = graph.n
    assert n >= 2, "random_edge_flips needs at least two vertices"
    k = int(k)
    assert 0 <= k <= (n * (n - 1)) // 2, "more flips than vertex pairs"
    rng = np.random.default_rng(seed)
    chosen: list = []
    seen = set()
    while len(chosen) < k:
        want = k - len(chosen)
        u = rng.integers(0, n, size=2 * want + 8)
        v = rng.integers(0, n, size=2 * want + 8)
        ok = u != v
        lo = np.minimum(u[ok], v[ok])
        hi = np.maximum(u[ok], v[ok])
        for key in (lo * np.int64(n) + hi).tolist():
            if key not in seen:
                seen.add(key)
                chosen.append(key)
                if len(chosen) == k:
                    break
    keys = np.asarray(chosen, dtype=np.int64)
    base = graph.edges[:, 0] * np.int64(n) + graph.edges[:, 1]
    present = np.isin(keys, base)
    rem, add = keys[present], keys[~present]
    return (
        np.stack([add // n, add % n], axis=1),
        np.stack([rem // n, rem % n], axis=1),
    )


def flip_edges(graph: Graph, k: int, seed: int) -> Graph:
    """``graph`` with ``k`` deterministic random edge flips applied."""
    add, rem = random_edge_flips(graph, k, seed)
    n = np.int64(graph.n)
    base = graph.edges[:, 0] * n + graph.edges[:, 1]
    if base.size and not np.all(base[1:] > base[:-1]):
        base = np.sort(base)
    rem_k = rem[:, 0] * n + rem[:, 1]
    kept = base[~np.isin(base, rem_k)] if rem_k.size else base
    add_k = np.sort(add[:, 0] * n + add[:, 1])
    merged = (
        np.insert(kept, np.searchsorted(kept, add_k), add_k)
        if add_k.size
        else kept
    )
    edges = np.stack([merged // n, merged % n], axis=1)
    return Graph(
        n=graph.n, edges=edges, name=f"{graph.name}+flip{k}s{seed}"
    )


# Zachary's karate club (34 vertices, 78 edges, 45 triangles) as
# ``{u: neighbours v > u}`` — held here so the fixture needs no graph
# library at run time.
_KARATE_ADJ = {
    0: (1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 17, 19, 21, 31),
    1: (2, 3, 7, 13, 17, 19, 21, 30),
    2: (3, 7, 8, 9, 13, 27, 28, 32),
    3: (7, 12, 13),
    4: (6, 10),
    5: (6, 10, 16),
    6: (16,),
    8: (30, 32, 33),
    9: (33,),
    13: (33,),
    14: (32, 33),
    15: (32, 33),
    18: (32, 33),
    19: (33,),
    20: (32, 33),
    22: (32, 33),
    23: (25, 27, 29, 32, 33),
    24: (25, 27, 31),
    25: (31,),
    26: (29, 33),
    27: (33,),
    28: (31, 33),
    29: (32, 33),
    30: (32, 33),
    31: (32, 33),
    32: (33,),
}


def named_graph(which: str) -> Graph:
    """Small graphs with known triangle counts for unit tests."""
    if which == "triangle":
        return Graph.from_edges(3, [0, 1, 2], [1, 2, 0], name="triangle")
    if which == "k4":
        src, dst = zip(*[(i, j) for i in range(4) for j in range(i + 1, 4)])
        return Graph.from_edges(4, src, dst, name="k4")
    if which == "k10":
        src, dst = zip(*[(i, j) for i in range(10) for j in range(i + 1, 10)])
        return Graph.from_edges(10, src, dst, name="k10")
    if which == "path":
        return Graph.from_edges(5, [0, 1, 2, 3], [1, 2, 3, 4], name="path")
    if which == "star":
        return Graph.from_edges(8, [0] * 7, list(range(1, 8)), name="star")
    if which == "karate":
        src, dst = zip(
            *[(u, v) for u, nbrs in _KARATE_ADJ.items() for v in nbrs]
        )
        return Graph.from_edges(34, src, dst, name="karate")
    if which == "bull":
        return Graph.from_edges(
            5, [0, 0, 1, 1, 2], [1, 2, 2, 3, 4], name="bull"
        )
    raise ValueError(f"unknown graph {which!r}")


def graph_from_spec(spec: str) -> Graph:
    """Parse a command-line graph spec (shared by tc_run / serve / benches).

    Formats: ``rmat:<scale>[,<edge_factor>[,<seed>]]`` |
    ``er:<n>,<avg_degree>[,<seed>]`` |
    ``powerlaw:<n>,<alpha>[,<seed>]`` (skewed-degree rebalance fixture) |
    ``star:<n>`` |
    ``cliques:<k>,<size>`` (block-diagonal skip-mask fixture) |
    ``delta:<k>,<seed>,<base-spec>`` (base spec + ``k`` deterministic
    random edge flips — present pairs removed, absent pairs added; the
    streaming-fixture mutation model) |
    ``named:<id>`` | ``<id>`` (a bare named-graph id such as ``karate``).
    """
    kind, _, rest = spec.partition(":")
    if kind == "delta":
        parts = rest.split(",", 2)  # base spec may itself contain commas
        if len(parts) != 3:
            raise ValueError(f"malformed delta spec {spec!r}")
        return flip_edges(graph_from_spec(parts[2]), int(parts[0]),
                          int(parts[1]))
    if kind == "star":
        return star(int(rest))
    if kind == "cliques":
        parts = rest.split(",")
        return residue_cliques(int(parts[0]), int(parts[1]))
    if kind == "powerlaw":
        parts = rest.split(",")
        return powerlaw(
            int(parts[0]),
            float(parts[1]),
            seed=int(parts[2]) if len(parts) > 2 else 0,
        )
    if kind == "rmat":
        parts = rest.split(",")
        return rmat(
            int(parts[0]),
            int(parts[1]) if len(parts) > 1 else 16,
            seed=int(parts[2]) if len(parts) > 2 else 0,
        )
    if kind == "er":
        parts = rest.split(",")
        return erdos_renyi(
            int(parts[0]),
            float(parts[1]),
            seed=int(parts[2]) if len(parts) > 2 else 0,
        )
    if kind == "named":
        return named_graph(rest)
    if not rest:  # bare named-graph id
        return named_graph(kind)
    raise ValueError(f"unknown graph spec {spec!r}")


_NAMED_IDS = ("triangle", "k4", "k10", "path", "star", "karate", "bull")


def _spec_is_wellformed(spec: str) -> bool:
    """Cheap format check of one spec — no graph is built."""
    kind, _, rest = spec.partition(":")
    if kind == "delta":
        parts = rest.split(",", 2)
        try:
            return (
                len(parts) == 3
                and int(parts[0]) >= 0
                and int(parts[1]) >= 0
                and _spec_is_wellformed(parts[2])
            )
        except ValueError:
            return False
    parts = rest.split(",")
    try:
        if kind == "rmat":
            return 1 <= len(parts) <= 3 and all(int(p) >= 0 for p in parts)
        if kind == "er":
            if len(parts) not in (2, 3):
                return False
            int(parts[0]), float(parts[1])
            return len(parts) == 2 or int(parts[2]) >= 0
        if kind == "star":
            return len(parts) == 1 and int(parts[0]) >= 2
        if kind == "cliques":
            return len(parts) == 2 and all(int(p) >= 1 for p in parts)
        if kind == "powerlaw":
            if len(parts) not in (2, 3):
                return False
            if not (int(parts[0]) >= 2 and float(parts[1]) > 1.0):
                return False
            return len(parts) == 2 or int(parts[2]) >= 0
    except ValueError:
        return False
    if kind == "named":
        return rest in _NAMED_IDS
    return not rest and kind in _NAMED_IDS


def split_specs(specs: str) -> list:
    """Split a spec *list* string into individual spec strings.

    Specs are separated by ``;`` (unambiguous, since specs may contain
    comma parameters: ``rmat:10,8,1;karate``).  Without a ``;`` the
    whole string is tried as a single spec first — so ``rmat:10,8,1``
    stays one graph — and only if it is not well-formed is it
    comma-split by greedy longest-match: each element claims as many
    comma fragments as still parse as ONE well-formed spec, so
    ``karate,powerlaw:600,2.2`` is two specs, not three, and nested
    parameterized specs like ``delta:5,0,powerlaw:600,2.2`` survive in
    a list.  A fragment run that never parses passes through as-is, so
    :func:`graph_from_spec` rejects it loudly instead of this splitter
    silently shredding it.
    """
    if ";" in specs:
        return [s for s in specs.split(";") if s]
    if _spec_is_wellformed(specs):
        return [specs]
    parts = [s for s in specs.split(",") if s]
    out, i = [], 0
    while i < len(parts):
        for j in range(len(parts), i, -1):
            cand = ",".join(parts[i:j])
            if _spec_is_wellformed(cand):
                out.append(cand)
                i = j
                break
        else:
            out.append(parts[i])
            i += 1
    return out


def graphs_from_specs(specs: str) -> list:
    """Parse a spec list (see :func:`split_specs`) into graphs."""
    return [graph_from_spec(s) for s in split_specs(specs)]
