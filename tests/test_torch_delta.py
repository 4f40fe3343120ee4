"""The port's delta ladder against the JAX package's.

``apply_delta`` is host numpy in both packages, so parity is identity:
the same level for the same artifact and delta, spliced / repacked /
rebased plans byte for byte, reports ``==`` as dicts, the same lineage
keys and digests, and the same number of reused staged buffers.  Counts
are integers: every re-count must be the oracle's on Cannon, SUMMA and
the ring at grid sizes 1–3, and the reference's at q = 1 in process.

The port runs every grid in process, so it also counts what the
reference's in-process tests cannot reach: spliced plans at q = 2 and 3,
and in particular a splice that inherits the parent's engine fns while a
dirty block's task count changed — the port's fns hold the plan's host
task counts and skip mask, so the inherited fn must be the parent's
rebound onto the spliced plan's arrays, never the parent's as it is.
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jc
import repro.pipeline as jp
import repro_torch as rt
import repro_torch.core as tc
import repro_torch.core.cannon as cannon_mod
import repro_torch.pipeline as tp
from repro.pipeline import stages as js
from repro_torch.core.engine import (
    CannonSchedule,
    CSRStore,
    build_engine_fn,
    make_csr_kernel,
    restage_device_arrays,
)
from repro_torch.core.generators import random_edge_flips
from repro_torch.core.plan import bucketize_plan
from repro_torch.launch import tc_run
from repro_torch.pipeline import stages as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GRAPH = "er:300,9,5"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------
def _deltas(g, k, seed):
    """The same random flips as a delta of each package: (reference,
    port)."""
    add, rem = random_edge_flips(g, k, seed)
    return jp.EdgeDelta(add=add, remove=rem), tp.EdgeDelta(add=add, remove=rem)


def _same(a, b, path="plan"):
    """``b`` (the port's) equal to ``a`` (the reference's) field by field:
    arrays by dtype, shape and bytes; dataclasses (stats, blocks, compact
    schedule, hub side) recursively; everything else by ``==``."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert b.dtype == a.dtype and b.shape == a.shape, path
        assert b.tobytes() == a.tobytes(), path
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(b):
            assert hasattr(a, f.name), f"{path}.{f.name}"
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)) and a and not isinstance(a[0], int):
        assert len(a) == len(b), path
        for i, (va, vb) in enumerate(zip(a, b)):
            _same(va, vb, f"{path}[{i}]")
    else:
        assert b == a, path


def _same_artifact(ref, got):
    assert got.kind == ref.kind
    assert got.key == ref.key
    assert got.digest == ref.digest
    assert got.lineage == ref.lineage
    assert got.delta_report == ref.delta_report
    assert (got.perm is None) == (ref.perm is None)
    if ref.perm is not None:
        assert np.array_equal(got.perm, ref.perm)
    assert got.graph.n == ref.graph.n
    assert np.array_equal(got.graph.edges, ref.graph.edges)
    _same(ref.plan, got.plan)


def _cold_reference(g2, q, skew_perm, flags):
    """A cold pack of the mutated graph under the kept σ, through the
    same later stages the planner config runs."""
    ref = ts.pack_tc_plan(
        g2, q, skew_perm=skew_perm,
        keep_blocks=bool(flags.get("keep_blocks") or flags.get("bucketize")),
        aug_keys=flags.get("aug_keys", False),
    )
    if flags.get("bucketize"):
        ref = bucketize_plan(ref, d_small=flags.get("d_small", 32))
    if flags.get("autotune"):
        ref = ts.autotune_tc_plan(
            ref, two_sided=(flags["autotune"] == "fused"))
    return ref


def _assert_cold_parity(got, ref):
    for name, arr in ref.device_arrays().items():
        mine = got.device_arrays()[name]
        assert mine.dtype == arr.dtype and mine.shape == arr.shape, name
        assert np.array_equal(mine, arr), name
    for f in ("nnz_pad", "tmax", "dmax", "n_long", "d_small"):
        assert getattr(got, f) == getattr(ref, f), f
    if ref.stats is not None and got.stats is not None:
        assert (got.stats.intersection_tasks_total
                == ref.stats.intersection_tasks_total)
        assert np.array_equal(got.stats.probe_work_per_device_shift,
                              ref.stats.probe_work_per_device_shift)


def _cannon_pair(spec, q, **flags):
    """plan_cannon of ``spec`` in both packages: (reference, port)."""
    return (
        jp.plan_cannon(jc.graph_from_spec(spec), q, cache=jp.PlanCache(),
                       **flags),
        tp.plan_cannon(tc.graph_from_spec(spec), q, cache=tp.PlanCache(),
                       **flags),
    )


def _count(art, **kw):
    """The port's count of an artifact, on the CPU."""
    return rt.count_triangles(art.graph, plan=art, device="cpu", **kw)


# ----------------------------------------------------------------------
# EdgeDelta semantics
# ----------------------------------------------------------------------
@pytest.mark.parametrize("add,remove", [
    ([(5, 2), (2, 5), (3, 3), (1, 4)], None),
    (None, [(9, 1), (1, 9), (0, 7)]),
    ([(0, 1)], [(2, 3), (3, 2), (4, 4)]),
    (None, None),
    (np.zeros((0, 2), np.int64), [(6, 5)]),
])
def test_edge_delta_canonicalizes_as_the_reference(add, remove):
    ref = jp.EdgeDelta(add=add, remove=remove)
    got = tp.EdgeDelta(add=add, remove=remove)
    for side in ("add", "remove"):
        a, b = getattr(ref, side), getattr(got, side)
        assert b.dtype == a.dtype and b.shape == a.shape
        assert np.array_equal(a, b)
    assert got.k == ref.k
    assert got.digest() == ref.digest()


def test_edge_delta_canonical_form():
    d = tp.EdgeDelta(add=[(5, 2), (2, 5), (3, 3), (1, 4)])
    assert d.add.tolist() == [[1, 4], [2, 5]]
    assert d.remove.shape == (0, 2)
    assert d.k == 2


def test_edge_delta_rejects_overlap_with_the_reference_message():
    msgs = []
    for mod in (jp, tp):
        with pytest.raises(ValueError) as e:
            mod.EdgeDelta(add=[(1, 2)], remove=[(2, 1)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_edge_delta_digest_is_content_addressed():
    a = tp.EdgeDelta(add=[(1, 2)], remove=[(3, 4)])
    b = tp.EdgeDelta(add=[(2, 1)], remove=[(4, 3)])
    c = tp.EdgeDelta(add=[(3, 4)], remove=[(1, 2)])
    assert a.digest() == b.digest()
    assert a.digest() != c.digest()


@pytest.mark.parametrize("spec,k,seed", [
    ("er:60,5,1", 9, 3), ("named:karate", 12, 0), ("rmat:8,8,2", 30, 7),
    ("star:40", 5, 1), ("er:24,0", 6, 2),
])
def test_apply_to_random_flips_and_relabel_match_the_reference(spec, k, seed):
    gj, gt = jc.graph_from_spec(spec), tc.graph_from_spec(spec)
    dj = jp.EdgeDelta.random_flips(gj, k, seed=seed)
    dt = tp.EdgeDelta.random_flips(gt, k, seed=seed)
    assert np.array_equal(dj.add, dt.add) and np.array_equal(
        dj.remove, dt.remove)
    assert dt.digest() == dj.digest()
    g2j, g2t = dj.apply_to(gj), dt.apply_to(gt)
    assert g2t.n == g2j.n and g2t.name == g2j.name
    assert np.array_equal(g2t.edges, g2j.edges)
    perm = np.random.default_rng(seed).permutation(gt.n)
    assert dt.relabeled(perm).digest() == dj.relabeled(perm).digest()
    assert dt.relabeled(None) is dt
    base = {tuple(e) for e in gt.edges.tolist()}
    want = (base - {tuple(e) for e in dt.remove.tolist()}) | {
        tuple(e) for e in dt.add.tolist()}
    assert {tuple(e) for e in g2t.edges.tolist()} == want


def test_out_of_range_delta_raises_the_reference_message():
    msgs = []
    for core, pipe in ((jc, jp), (tc, tp)):
        art = pipe.plan_cannon(core.graph_from_spec("er:30,3,1"), 1,
                               reorder=False, cache=pipe.PlanCache())
        with pytest.raises(ValueError) as e:
            pipe.apply_delta(art, pipe.EdgeDelta(add=[(0, 30)]),
                             cache=pipe.PlanCache(maxsize=0))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------------------
# splice byte-parity: the reference's apply_delta, and a cold re-pack
# ----------------------------------------------------------------------
FLAGS = {
    "plain": dict(),
    "blocks+aug": dict(keep_blocks=True, aug_keys=True),
    "autotune": dict(autotune=True),
    "fused": dict(bucketize=True, autotune="fused"),
}


def _flips(q):
    # few enough flips that the dirty blocks stay under the splice
    # ladder's 50 % limit in some trials: fewer on the smaller grid
    return 2 if q == 2 else 5


@pytest.mark.parametrize("trial", range(6))
@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("q", [2, 3])
def test_apply_delta_matches_the_reference_and_a_cold_pack(q, flags, trial):
    kw = dict(reorder=False, **FLAGS[flags])
    aj, at = _cannon_pair(GRAPH, q, **kw)
    dj, dt = _deltas(at.graph, _flips(q), 40 + trial)
    bj = jp.apply_delta(aj, dj, cache=jp.PlanCache(maxsize=0))
    bt = tp.apply_delta(at, dt, cache=tp.PlanCache(maxsize=0))
    assert bt.delta_report["level"] in ("splice", "repack")
    _same_artifact(bj, bt)
    g2 = dt.apply_to(at.graph)
    assert bt.graph.m == g2.m
    _assert_cold_parity(bt.plan, _cold_reference(
        g2, q, at.plan.skew_perm, FLAGS[flags]))


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("q", [2, 3])
def test_localized_flips_take_the_splice(q, flags):
    at = tp.plan_cannon(tc.graph_from_spec(GRAPH), q, reorder=False,
                        cache=tp.PlanCache(), **FLAGS[flags])
    levels = [
        tp.apply_delta(at, _deltas(at.graph, _flips(q), 40 + t)[1],
                       cache=tp.PlanCache(maxsize=0)).delta_report["level"]
        for t in range(6)
    ]
    assert "splice" in levels


@pytest.mark.parametrize("kind", ["summa", "oned"])
@pytest.mark.parametrize("autotune", [False, "fused"])
@pytest.mark.parametrize("seed", [1, 2])
def test_repack_matches_the_reference_on_summa_and_the_ring(kind, autotune,
                                                            seed):
    """SUMMA and the ring have no splice: every delta repacks."""
    out = []
    for core, pipe in ((jc, jp), (tc, tp)):
        g = core.graph_from_spec("rmat:8,8,3")
        if kind == "summa":
            art = pipe.plan_summa(g, 2, 3, autotune=autotune,
                                  cache=pipe.PlanCache())
        else:
            art = pipe.plan_oned(g, 3, autotune=autotune,
                                 cache=pipe.PlanCache())
        add, rem = random_edge_flips(tc.graph_from_spec("rmat:8,8,3"), 6,
                                     seed)
        out.append(pipe.apply_delta(art, pipe.EdgeDelta(add=add, remove=rem),
                                    cache=pipe.PlanCache(maxsize=0)))
    assert out[1].delta_report["level"] == "repack"
    _same_artifact(*out)


def test_noop_reuses_everything_as_the_reference():
    out = []
    for core, pipe in ((jc, jp), (tc, tp)):
        art = pipe.plan_cannon(core.graph_from_spec("er:100,6,1"), 2,
                               cache=pipe.PlanCache())
        art2 = pipe.apply_delta(art, pipe.EdgeDelta(),
                                cache=pipe.PlanCache(maxsize=0))
        assert art2.delta_report["level"] == "noop"
        assert art2.plan is art.plan
        absent = [(u, v) for u in range(10) for v in range(u + 1, 10)
                  if not np.any((art.graph.edges == (u, v)).all(axis=1))][:3]
        # removing absent edges is also a noop after effect-filtering
        # (in original ids, mapped through the artifact's permutation)
        inv = np.argsort(art.perm)
        art3 = pipe.apply_delta(
            art, pipe.EdgeDelta(remove=inv[np.asarray(absent)]),
            cache=pipe.PlanCache(maxsize=0))
        assert art3.delta_report["level"] == "noop"
        out.append((art2, art3))
    for ref, got in zip(out[0], out[1]):
        _same_artifact(ref, got)


# ----------------------------------------------------------------------
# counting: every schedule, grid and method, against the oracle
# ----------------------------------------------------------------------
_GRIDS = {
    "cannon": [(1, 1), (2, 2), (3, 3)],
    "summa": [(1, 1), (2, 2), (2, 3)],
    "oned": [(1, 1), (1, 2), (1, 3)],  # the ring p = 1, 2, 3
}
_METHODS = {
    "cannon": ["search", "search2", "global", "fused", "auto"],
    "summa": ["search", "global", "fused", "auto"],
    "oned": ["search", "global", "fused", "auto"],
}
_COUNT_CASES = [
    (schedule, grid, method)
    for schedule in _GRIDS
    for grid in _GRIDS[schedule]
    for method in _METHODS[schedule]
]


@pytest.mark.parametrize("schedule,grid,method", _COUNT_CASES)
def test_count_triangles_delta_exact(schedule, grid, method):
    g = tc.graph_from_spec("er:150,7,2")
    cache = tp.PlanCache()
    kw = dict(grid=grid, schedule=schedule, method=method, device="cpu")
    art, levels = None, []
    for k, seed in ((3, 1), (40, 2), (2, 3)):
        d = tp.EdgeDelta.random_flips(g, k, seed=seed)
        res = rt.count_triangles_delta(g, d, artifact=art, cache=cache, **kw)
        g = d.apply_to(g)
        assert res.triangles == tc.triangle_count_oracle(g), (k, seed)
        assert res.delta["level"] in ("splice", "repack", "rebase")
        assert res.artifact.lineage is not None
        art = res.artifact
        levels.append(res.delta["level"])
    if schedule != "cannon":
        assert set(levels) == {"repack"}


@pytest.mark.parametrize("schedule", ["cannon", "summa", "oned"])
@pytest.mark.parametrize("method", ["search", "fused"])
def test_count_triangles_delta_matches_the_reference_at_q1(schedule, method):
    gj = jc.graph_from_spec("er:150,7,2")
    gt = tc.graph_from_spec("er:150,7,2")
    dj, dt = _deltas(gt, 10, 1)
    want = jc.count_triangles_delta(gj, dj, q=1, schedule=schedule,
                                    method=method, cache=jp.PlanCache())
    got = rt.count_triangles_delta(gt, dt, q=1, schedule=schedule,
                                   method=method, device="cpu",
                                   cache=tp.PlanCache())
    assert got.triangles == want.triangles == tc.triangle_count_oracle(
        dt.apply_to(gt))
    assert got.delta == want.delta
    assert got.artifact.lineage == want.artifact.lineage
    assert got.artifact.key == want.artifact.key


@pytest.mark.parametrize("q", [1, 2, 3])
def test_chained_deltas_rebase_as_the_reference(q):
    """Four chained deltas with ``rebase_every=2``: the same level, report,
    key and composed permutation round by round, and the oracle's count."""
    aj, at = _cannon_pair("er:120,6,4", q)
    cj, ct = jp.PlanCache(), tp.PlanCache()
    g = tc.graph_from_spec("er:120,6,4")
    levels = []
    for i in range(4):
        dj, dt = _deltas(g, 4, 50 + i)
        aj = jp.apply_delta(aj, dj, cache=cj, rebase_every=2)
        at = tp.apply_delta(at, dt, cache=ct, rebase_every=2)
        _same_artifact(aj, at)
        g = dt.apply_to(g)
        assert _count(at, method="search").triangles == (
            tc.triangle_count_oracle(g))
        if at.delta_report["rebased"]:
            assert at.delta_report["depth"] == 0
        levels.append(at.delta_report["level"])
    assert levels[2] == "rebase"
    assert at.lineage["depth"] <= 2


def test_chained_count_triangles_delta_matches_the_reference_at_q1():
    gj = jc.graph_from_spec("er:120,6,4")
    gt = tc.graph_from_spec("er:120,6,4")
    cj, ct = jp.PlanCache(), tp.PlanCache()
    aj = at = None
    for i in range(4):
        dj, dt = _deltas(gt, 4, 50 + i)
        rj = jc.count_triangles_delta(gj, dj, q=1, artifact=aj, cache=cj,
                                      rebase_every=2)
        rt_ = rt.count_triangles_delta(gt, dt, q=1, artifact=at, cache=ct,
                                       rebase_every=2, device="cpu")
        gj, gt = dj.apply_to(gj), dt.apply_to(gt)
        assert rt_.triangles == rj.triangles == tc.triangle_count_oracle(gt)
        assert rt_.delta == rj.delta
        aj, at = rj.artifact, rt_.artifact


def test_delta_count_equals_fresh_plan_count():
    g = tc.graph_from_spec("er:200,8,7")
    d = tp.EdgeDelta.random_flips(g, 8, seed=2)
    for q in (1, 2):
        inc = rt.count_triangles_delta(g, d, q=q, device="cpu",
                                       cache=tp.PlanCache())
        fresh = rt.count_triangles(d.apply_to(g), q=q, device="cpu",
                                   cache=tp.PlanCache())
        assert inc.triangles == fresh.triangles


@pytest.mark.parametrize("method", ["tile", "dense"])
def test_spliced_plan_counts_on_the_tile_and_dense_paths(method):
    g = tc.graph_from_spec(GRAPH)
    cache = tp.PlanCache()
    base = rt.count_triangles(g, q=3, method=method, device="cpu",
                              cache=cache)
    spliced = 0
    for seed in range(4):
        d = tp.EdgeDelta.random_flips(g, 3, seed=seed)
        res = rt.count_triangles_delta(g, d, artifact=base.artifact, q=3,
                                       method=method, device="cpu",
                                       cache=cache)
        assert res.triangles == tc.triangle_count_oracle(d.apply_to(g))
        spliced += res.delta["level"] == "splice"
    assert spliced


# ----------------------------------------------------------------------
# edge cases: emptied blocks, revived steps, nnz_pad, edgeless base
# ----------------------------------------------------------------------
def test_emptying_a_block_flips_the_skip_mask():
    # residue cliques mod 3: each clique's triangles live in one diagonal
    # block — deleting clique 0's edges empties block (0, 0)
    out = []
    for core, pipe in ((jc, jp), (tc, tp)):
        g = core.residue_cliques(3, 5)
        art = pipe.plan_cannon(g, 3, reorder=False, cache=pipe.PlanCache())
        clique0 = [tuple(e) for e in g.edges.tolist() if e[0] % 3 == 0]
        out.append((art, pipe.apply_delta(
            art, pipe.EdgeDelta(remove=clique0),
            cache=pipe.PlanCache(maxsize=0))))
    (aj, bj), (at, bt) = out
    _same_artifact(bj, bt)
    assert bt.delta_report["level"] == "splice"
    assert int(bt.plan.m_cnt[0, 0]) == 0
    _assert_cold_parity(bt.plan, _cold_reference(
        bt.graph, 3, bt.plan.skew_perm, {}))
    assert int(bt.plan.step_keep.sum()) < int(at.plan.step_keep.sum())
    for method in ("search", "global"):
        assert _count(bt, method=method).triangles == (
            tc.triangle_count_oracle(bt.graph))


def test_reviving_an_elided_step_drops_inheritance():
    # only diagonal blocks are non-empty, so compaction elides steps;
    # cross-class edges land work in block (0, 1): the splice must grow
    # the live set and build its engines anew, not keep the stale ones
    g = tc.residue_cliques(3, 5)
    cache = tp.PlanCache()
    base = rt.count_triangles(g, q=3, reorder=False, device="cpu",
                              cache=cache)
    cs = base.artifact.plan.compact
    assert cs.n_live < cs.n_total
    d = tp.EdgeDelta(add=[(0, 1), (3, 4), (6, 7)])
    res = rt.count_triangles_delta(g, d, artifact=base.artifact, q=3,
                                   device="cpu", cache=cache)
    rep, plan2 = res.delta, res.artifact.plan
    assert rep["level"] == "splice"
    assert "compact:live-steps" in rep["replanned_stages"]
    assert set(plan2.compact.live_steps) > set(cs.live_steps)
    assert not rep["fn_inherited"]
    assert not any(k[0] == "fn" for k in res.artifact._memo
                   if isinstance(k, tuple)) or all(
        fn is not base.artifact._memo.get(k)
        for k, fn in res.artifact._memo.items() if k[0] == "fn")
    assert res.triangles == tc.triangle_count_oracle(d.apply_to(g))
    aj = jp.plan_cannon(jc.residue_cliques(3, 5), 3, reorder=False,
                        keep_blocks=False, cache=jp.PlanCache())
    _same_artifact(
        jp.apply_delta(aj, jp.EdgeDelta(add=[(0, 1), (3, 4), (6, 7)]),
                       cache=jp.PlanCache(maxsize=0)),
        tp.apply_delta(base.artifact, d, cache=tp.PlanCache(maxsize=0)))


def _block_delta(g, q, bx, bz, grow, count):
    """Edits confined to canonical block ``(bx, bz)``: ``count`` absent
    pairs added (``grow``) or present edges removed."""
    have = {tuple(e) for e in g.edges.tolist()}
    if grow:
        pairs = ((i, j) for i in range(bx, g.n, q) for j in range(bz, g.n, q)
                 if i < j and (i, j) not in have)
        return list(itertools.islice(pairs, count)), None
    pairs = [e for e in sorted(have) if e[0] % q == bx and e[1] % q == bz]
    return None, pairs[:count]


@pytest.mark.parametrize("grow", [True, False], ids=["grow", "shrink"])
def test_splice_resizes_nnz_pad_exactly(grow):
    q = 3
    aj, at = _cannon_pair(GRAPH, q, reorder=False, aug_keys=True,
                          autotune="fused")
    cnt = at.plan.m_cnt.astype(np.int64)
    bx, bz = np.unravel_index(int(np.argmax(cnt)), cnt.shape)
    second = np.sort(cnt.ravel())[-2]
    n_edit = 25 if grow else int(cnt[bx, bz] - second) + 5
    add, rem = _block_delta(at.graph, q, int(bx), int(bz), grow, n_edit)
    bj = jp.apply_delta(aj, jp.EdgeDelta(add=add, remove=rem),
                        cache=jp.PlanCache(maxsize=0))
    bt = tp.apply_delta(at, tp.EdgeDelta(add=add, remove=rem),
                        cache=tp.PlanCache(maxsize=0))
    assert bt.delta_report["level"] == "splice"
    assert bt.delta_report["dirty_blocks"] == 1
    if grow:
        assert bt.plan.nnz_pad > at.plan.nnz_pad
    else:
        assert bt.plan.nnz_pad < at.plan.nnz_pad
    _same_artifact(bj, bt)
    _assert_cold_parity(bt.plan, _cold_reference(
        bt.graph, q, at.plan.skew_perm, dict(aug_keys=True,
                                             autotune="fused")))
    want = tc.triangle_count_oracle(bt.graph)
    for method in ("search", "global", "fused"):
        assert _count(bt, method=method).triangles == want, method


@pytest.mark.parametrize("base,q", [(24, 1), (24, 2), (100_000, 2)])
def test_key_width_survives_a_splice(base, q):
    """Row-encoded keys are int32 up to base 46,340 and int64 past it; a
    splice that widens ``nnz_pad`` rebuilds them over the new layout in
    the same dtype, equal to a cold pack's, and the staged keys count
    like the ones the global kernel builds on the device."""
    n = base * q - 1  # nb = ceil(n / q) = base: key base base + 1
    rng = np.random.default_rng(3)
    g = tc.Graph.from_edges(n, rng.integers(0, n, 400),
                            rng.integers(0, n, 400))
    art = tp.plan_cannon(g, q, reorder=False, aug_keys=True,
                         cache=tp.PlanCache())
    want_dtype = np.int32 if base <= 46_340 else np.int64
    assert art.plan.b_aug.dtype == want_dtype
    cnt = art.plan.m_cnt.astype(np.int64)
    bx, bz = np.unravel_index(int(np.argmax(cnt)), cnt.shape)
    add, _ = _block_delta(g, q, int(bx), int(bz), True, 12)
    d = tp.EdgeDelta(add=add)
    art2 = tp.apply_delta(art, d, cache=tp.PlanCache(maxsize=0))
    assert art2.delta_report["level"] in ("splice", "repack")
    assert art2.plan.b_aug.dtype == want_dtype
    cold = ts.pack_tc_plan(art2.graph, q, skew_perm=art.plan.skew_perm,
                           aug_keys=True)
    assert np.array_equal(art2.plan.b_aug, cold.b_aug)
    staged = _count(art2, method="global").triangles
    keyless = dataclasses.replace(art2.plan, b_aug=None)
    built = rt.count_triangles(art2.graph, plan=keyless, method="global",
                               device="cpu").triangles
    assert staged == built == tc.triangle_count_oracle(art2.graph)


@pytest.mark.parametrize("q", [1, 2])
def test_delta_from_an_edgeless_graph(q):
    g = tc.Graph(n=24, edges=np.zeros((0, 2), np.int64), name="empty")
    cache = tp.PlanCache()
    base = rt.count_triangles(g, q=q, device="cpu", cache=cache)
    assert base.triangles == 0
    tri = [(0, 1), (1, 2), (0, 2), (3, 4)]
    res = rt.count_triangles_delta(g, tp.EdgeDelta(add=tri), q=q,
                                   artifact=base.artifact, device="cpu",
                                   cache=cache)
    assert res.triangles == 1
    gj = jc.Graph(n=24, edges=np.zeros((0, 2), np.int64), name="empty")
    aj = jp.plan_cannon(gj, q, keep_blocks=False, cache=jp.PlanCache())
    _same_artifact(
        jp.apply_delta(aj, jp.EdgeDelta(add=tri),
                       cache=jp.PlanCache(maxsize=0)),
        tp.apply_delta(base.artifact, tp.EdgeDelta(add=tri),
                       cache=tp.PlanCache(maxsize=0)))


def test_rebase_composes_the_permutation():
    """After a rebase the artifact maps *original* ids: its permutation is
    the reference's, its graph the mutated graph relabeled by it, and the
    next delta — in original ids — still counts right."""
    g = tc.graph_from_spec("rmat:8,8,1")
    cache = tp.PlanCache()
    res = rt.count_triangles(g, q=2, device="cpu", cache=cache)
    art = res.artifact
    aj = jp.plan_cannon(jc.graph_from_spec("rmat:8,8,1"), 2,
                        keep_blocks=False, cache=jp.PlanCache())
    levels = []
    for i in range(3):
        dj, dt = _deltas(g, 5, 90 + i)
        aj = jp.apply_delta(aj, dj, cache=jp.PlanCache(maxsize=0),
                            rebase_every=1)
        res = rt.count_triangles_delta(g, dt, artifact=art, q=2,
                                       device="cpu", cache=cache,
                                       rebase_every=1)
        art, g = res.artifact, dt.apply_to(g)
        assert np.array_equal(art.perm, aj.perm)
        relabeled = g.relabel(art.perm)
        assert np.array_equal(art.graph.edges, relabeled.edges)
        assert res.triangles == tc.triangle_count_oracle(g)
        levels.append(res.delta["level"])
    assert "rebase" in levels


# ----------------------------------------------------------------------
# the inherited engine: rebound onto the spliced plan's own arrays
# ----------------------------------------------------------------------
# the Cannon runner's memo key: method, probe_shorter, use_step_mask,
# double_buffer, compact, reduce_strategy, npods, fused_tile
_FN_KEYS = {
    "search": ("fn", "search", True, None, True, None, "auto", 1, None),
    "global": ("fn", "global", True, None, True, None, "auto", 1, None),
    "fused": ("fn", "fused", True, None, True, None, "auto", 1, None),
}


@pytest.mark.parametrize("method", ["search", "global", "fused"])
def test_inherited_fn_counts_from_the_spliced_plans_own_arrays(method,
                                                               monkeypatch):
    """A splice that keeps the engine statics inherits the parent's fn —
    rebound onto the spliced plan's ``m_cnt`` / ``step_keep``.  On the
    cases where a dirty block's task count changed the parent's fn as it
    is (the reference's inheritance copied verbatim) counts something
    else, and the inherited one counts the oracle without a rebuild."""
    g = tc.graph_from_spec(GRAPH)
    base = rt.count_triangles(g, q=3, method=method, device="cpu",
                              cache=tp.PlanCache())
    parent = base.artifact
    fn1 = parent._memo[_FN_KEYS[method]]
    shown = 0
    for seed in range(60):
        d = tp.EdgeDelta.random_flips(g, 2, seed=seed)
        art2 = tp.apply_delta(parent, d, cache=tp.PlanCache(maxsize=0))
        rep = art2.delta_report
        if rep["level"] != "splice":
            continue
        fn2 = art2._memo.get(_FN_KEYS[method])
        assert (fn2 is not None) == rep["fn_inherited"]
        if fn2 is None:
            continue
        plan2 = art2.plan
        assert fn2 is not fn1
        assert fn2.store is fn1.store and fn2.schedule is fn1.schedule
        assert fn2.m_cnt is plan2.m_cnt
        assert np.array_equal(fn2.step_keep, plan2.step_keep)
        want = tc.triangle_count_oracle(d.apply_to(g))
        with monkeypatch.context() as m:
            m.setattr(cannon_mod, "build_cannon_fn", _no_rebuild)
            assert _count(art2, method=method).triangles == want
        if np.array_equal(plan2.m_cnt, parent.plan.m_cnt):
            continue
        try:
            stale = int(fn1(**art2.staged(CPU)))
        except (IndexError, RuntimeError):
            stale = None  # the parent's counts overrun the new task list
        if stale != want:
            shown += 1
    assert shown, "no splice with inherited fns changed a task count"


def _no_rebuild(*args, **kwargs):
    raise AssertionError("the engine fn was rebuilt, not inherited")


def test_rebind_shares_the_composition_and_keeps_the_mask_choice():
    art = tp.plan_cannon(tc.graph_from_spec(GRAPH), 2, cache=tp.PlanCache())
    plan = art.plan
    kernel = make_csr_kernel("search", dpad=plan.dmax, chunk=plan.chunk)
    store, sched = CSRStore(kernel), CannonSchedule(q=2)
    masked = build_engine_fn(store, sched, m_cnt=plan.m_cnt,
                             step_keep=plan.step_keep)
    bare = build_engine_fn(store, sched, m_cnt=plan.m_cnt)
    zeros = np.zeros_like(plan.m_cnt)
    staged = art.staged(CPU)
    for fn in (masked, bare):
        again = fn.rebind(m_cnt=zeros, step_keep=plan.step_keep)
        assert again.store is store and again.schedule is sched
        assert (again.step_keep is None) == (fn.step_keep is None)
        assert int(again(**staged)) == 0
        assert int(fn(**staged)) == tc.triangle_count_oracle(art.graph)
        back = again.rebind(m_cnt=plan.m_cnt, step_keep=plan.step_keep)
        assert int(back(**staged)) == int(fn(**staged))


def test_rebind_takes_the_hub_side_it_is_given():
    """``hub=`` rebinds the hub partial: the hub plan's own side gives the
    full count, none gives the residual's alone."""
    from repro_torch.core.engine import HubCount

    g = tc.graph_from_spec("powerlaw:600,2.2")
    art = tp.plan_cannon(g, 2, hub_split=True, cache=tp.PlanCache())
    plan = art.plan
    fn = cannon_mod.build_cannon_fn(art)
    staged = art.staged(CPU)
    full = tc.triangle_count_oracle(g)
    residual = rt.count_triangles(
        art.graph, plan=dataclasses.replace(plan, hub=None),
        device="cpu").triangles
    assert residual < full == int(fn(**staged))
    kw = dict(m_cnt=plan.m_cnt, step_keep=plan.step_keep)
    assert int(fn.rebind(hub=HubCount.from_plan(plan), **kw)(**staged)) == full
    assert int(fn.rebind(**kw)(**staged)) == residual


# ----------------------------------------------------------------------
# staging: reused buffers, per device
# ----------------------------------------------------------------------
@pytest.mark.parametrize("trial", range(6))
def test_stage_reused_buffers_match_the_reference(trial):
    aj, at = _cannon_pair(GRAPH, 3, reorder=False)
    aj.staged()
    parent = at.staged(CPU)
    dj, dt = _deltas(at.graph, 4, 70 + trial)
    bj = jp.apply_delta(aj, dj, cache=jp.PlanCache(maxsize=0))
    bt = tp.apply_delta(at, dt, cache=tp.PlanCache(maxsize=0))
    bj.staged()
    child = bt.staged(CPU)
    got = bt.stage_seconds["stage_reused_buffers"]
    assert got == bj.stage_seconds["stage_reused_buffers"]
    if bt.delta_report["level"] == "splice":
        assert got >= 1
    reused = [k for k in child if child[k] is parent.get(k)]
    assert len(reused) == got
    for k, t in child.items():
        assert np.array_equal(t.numpy(), bt.device_arrays()[k])


def test_restage_device_arrays_reuses_what_is_unchanged():
    a = np.arange(6, dtype=np.int32)
    b = np.ones((2, 3), dtype=bool)
    prev_host = dict(a=a, b=b, c=np.zeros(4, np.int32), d=np.arange(3))
    prev = {k: torch.from_numpy(v) for k, v in prev_host.items()}
    new_host = dict(
        a=a,  # the same object
        b=b.copy(),  # equal values
        c=np.zeros(5, np.int32),  # another shape
        d=np.arange(3, dtype=np.int32),  # another dtype
        e=np.arange(2),  # new
    )
    out, reused = restage_device_arrays(prev_host, prev, new_host, CPU)
    assert reused == 2 and list(out) == list(new_host)
    assert out["a"] is prev["a"] and out["b"] is prev["b"]
    for k in ("c", "d", "e"):
        assert out[k].dtype == torch.from_numpy(new_host[k]).dtype
        assert np.array_equal(out[k].numpy(), new_host[k])


def test_the_restage_handoff_is_per_device():
    """The parent's staged tensors travel per device: a child staged on
    a device the parent was staged on reuses that device's tensors, and
    on any other device stages afresh."""
    art = tp.plan_cannon(tc.graph_from_spec(GRAPH), 3, reorder=False,
                         cache=tp.PlanCache())
    on_cpu = art.staged("cpu")
    on_meta = art.staged("meta")
    for seed in range(20):
        d = tp.EdgeDelta.random_flips(art.graph, 3, seed=seed)
        art2 = tp.apply_delta(art, d, cache=tp.PlanCache(maxsize=0))
        if art2.delta_report["level"] == "splice":
            break
    prev_host, handoff = art2.restage_from
    assert set(handoff) == {"cpu", "meta"}
    assert handoff["cpu"] is on_cpu and handoff["meta"] is on_meta
    fresh = art2.staged("cpu:0")  # a device string the parent never had
    assert "stage_reused_buffers" not in art2.stage_seconds
    assert not any(fresh[k] is on_cpu.get(k) for k in fresh)
    meta = art2.staged("meta")
    reused = art2.stage_seconds["stage_reused_buffers"]
    assert reused >= 1
    assert all(t.device.type == "meta" for t in meta.values())
    assert sum(meta[k] is on_meta.get(k) for k in meta) == reused
    cpu = art2.staged("cpu")
    assert sum(cpu[k] is on_cpu.get(k) for k in cpu) == reused
    assert _count(art2).triangles == tc.triangle_count_oracle(art2.graph)


def test_the_splice_never_writes_into_the_parents_arrays():
    """On the CPU a staged tensor shares its numpy array's memory: every
    array of the parent — and so every parent tensor — is left as it
    was."""
    art = tp.plan_cannon(tc.graph_from_spec(GRAPH), 3, reorder=False,
                         aug_keys=True, autotune="fused",
                         cache=tp.PlanCache())
    staged = art.staged(CPU)
    before = {k: v.copy() for k, v in art.device_arrays().items()}
    for seed in range(10):
        d = tp.EdgeDelta.random_flips(art.graph, 3, seed=seed)
        tp.apply_delta(art, d, cache=tp.PlanCache(maxsize=0)).staged(CPU)
    for k, v in before.items():
        assert np.array_equal(art.device_arrays()[k], v), k
        assert np.array_equal(staged[k].numpy(), v), k


# ----------------------------------------------------------------------
# cache lineage + eviction hooks
# ----------------------------------------------------------------------
def test_lineage_cache_hit_and_keys_as_the_reference():
    keys = []
    for core, pipe in ((jc, jp), (tc, tp)):
        g = core.graph_from_spec("er:90,5,3")
        cache = pipe.PlanCache(maxsize=8)
        art = pipe.plan_cannon(g, 2, cache=cache)
        add, rem = random_edge_flips(tc.graph_from_spec("er:90,5,3"), 3, 9)
        d = pipe.EdgeDelta(add=add, remove=rem)
        a1 = pipe.apply_delta(art, d, cache=cache)
        assert not a1.cache_hit
        a2 = pipe.apply_delta(art, d, cache=cache)
        assert a2.cache_hit and a2 is a1 and a2.key == a1.key
        add3, rem3 = random_edge_flips(tc.graph_from_spec("er:90,5,3"), 3, 10)
        a3 = pipe.apply_delta(art, pipe.EdgeDelta(add=add3, remove=rem3),
                              cache=cache)
        assert not a3.cache_hit and a3.key != a1.key
        keys.append((a1.key, a1.digest, a3.key, a3.digest))
    assert keys[0] == keys[1]


def test_replaying_a_stream_hits_the_cache():
    g = tc.graph_from_spec(GRAPH)
    cache = tp.PlanCache(maxsize=16)
    base = tp.plan_cannon(g, 3, cache=cache)
    deltas = [tp.EdgeDelta.random_flips(g, 3, seed=s) for s in range(4)]
    first, art = [], base
    for d in deltas:
        art = tp.apply_delta(art, d, cache=cache, rebase_every=2)
        first.append(art)
    art = base
    for d, seen in zip(deltas, first):
        art = tp.apply_delta(art, d, cache=cache, rebase_every=2)
        assert art is seen and art.cache_hit
    # a derived artifact's lineage key extends its parent's (the tail
    # slice differs for a cold parent and a derived one)
    assert first[1].key[:3] == first[0].key[:3]
    assert first[1].key[3][:1] == first[0].key[3]
    assert first[1].key[4:] == first[0].key[4:] == base.key[2:]


def test_eviction_releases_artifact_buffers_and_the_handoff():
    g1, g2 = tc.graph_from_spec("er:60,4,1"), tc.graph_from_spec("er:70,4,2")
    tiny = tp.PlanCache(maxsize=1)
    a1 = tp.plan_cannon(g1, 2, cache=tiny)
    a1.staged(CPU)
    d = tp.EdgeDelta.random_flips(g1, 2, seed=1)
    a2 = tp.apply_delta(a1, d, cache=tp.PlanCache(maxsize=0))
    assert a1._memo and a2.restage_from is not None
    tp.plan_cannon(g2, 2, cache=tiny)  # evicts a1
    assert tiny.stats()["evictions"] >= 1
    assert not a1._memo and a1.restage_from is None
    a2.release()
    assert a2.restage_from is None and not a2._memo
    assert _count(a2).triangles == tc.triangle_count_oracle(a2.graph)


def test_eviction_custom_hook():
    seen = []
    tiny = tp.PlanCache(maxsize=1, on_evict=lambda v: seen.append(v))
    tiny.put(("k", 1), "a")
    tiny.put(("k", 2), "b")
    assert seen == ["a"]
    tiny.clear()
    assert seen == ["a", "b"]


# ----------------------------------------------------------------------
# hub-split plans: never spliced
# ----------------------------------------------------------------------
def _hub_delta(g):
    """A delta adding an edge onto the heaviest (hub) row and removing one
    existing edge."""
    deg = np.bincount(g.edges.reshape(-1), minlength=g.n)
    hub_v = int(np.argmax(deg))
    have = set(map(tuple, g.edges.tolist()))
    add = next(
        [min(u, hub_v), max(u, hub_v)]
        for u in range(g.n)
        if u != hub_v and (min(u, hub_v), max(u, hub_v)) not in have
    )
    return add, g.edges[0].tolist()


def _hub_pair(spec, q, **kw):
    """A hub-split plan (with the fused kernel's split) of ``spec`` and
    the hub delta applied to it, in both packages."""
    out = []
    for core, pipe in ((jc, jp), (tc, tp)):
        g = core.graph_from_spec(spec)
        art = pipe.plan_cannon(g, q, hub_split=True, autotune="fused",
                               cache=pipe.PlanCache(), **kw)
        add, rem = _hub_delta(g)
        out.append((art, pipe.apply_delta(
            art, pipe.EdgeDelta(add=[add], remove=[rem]),
            cache=pipe.PlanCache())))
    return out


@pytest.mark.parametrize("q", [1, 2])
def test_delta_refuses_the_splice_on_a_hub_plan(q):
    (aj, bj), (at, bt) = _hub_pair("powerlaw:600,2.2", q)
    assert at.plan.hub is not None
    rep = bt.delta_report
    assert rep["level"] == "repack" and rep["reason"] == "hub_split"
    assert "hubsplit" in rep["replanned_stages"]
    assert bt.plan.hub.h0 == at.plan.hub.h0
    _same_artifact(bj, bt)
    want = tc.triangle_count_oracle(bt.graph)
    for method in ("search", "fused"):
        assert _count(bt, method=method).triangles == want
    if q == 1:
        assert jc.count_triangles(bj.graph, q=1, plan=bj).triangles == want


def test_delta_rebases_a_misaligned_hub_plan():
    (aj, bj), (at, bt) = _hub_pair("powerlaw:600,2.2", 3, rebalance_trials=3)
    assert not at.plan.hub.aligned, "fixture drift: rebalance kept seed 0"
    rep = bt.delta_report
    assert rep["level"] == "rebase" and rep["reason"] == "hub_split_misaligned"
    assert bt.plan.hub is not None
    _same_artifact(bj, bt)
    g2 = tc.graph_from_spec("powerlaw:600,2.2")
    add, rem = _hub_delta(g2)
    g2 = tp.EdgeDelta(add=[add], remove=[rem]).apply_to(g2)
    assert _count(bt, method="fused").triangles == (
        tc.triangle_count_oracle(g2))


def test_a_hub_free_plan_still_splices():
    g = tc.graph_from_spec("named:karate")
    art = tp.plan_cannon(g, 1, hub_split=True, cache=tp.PlanCache())
    assert art.plan.hub is None
    d = tp.EdgeDelta(add=[[0, 21]], remove=[[0, 1]])
    art2 = tp.apply_delta(art, d, cache=tp.PlanCache())
    assert art2.delta_report["level"] in ("splice", "repack")
    assert "reason" not in art2.delta_report
    assert _count(art2).triangles == tc.triangle_count_oracle(d.apply_to(g))


def test_a_delta_draining_the_hub_side_leaves_no_hub():
    g = tc.graph_from_spec("powerlaw:600,2.2")
    art = tp.plan_cannon(g, 2, hub_split=True, autotune="fused",
                         cache=tp.PlanCache())
    h0 = art.plan.hub.h0
    inv = np.argsort(art.perm)  # relabeled id -> original id
    hub_orig = set(inv[h0:].tolist())
    rem = [e for e in g.edges.tolist() if e[0] in hub_orig or e[1] in hub_orig]
    out = []
    for core, pipe in ((jc, jp), (tc, tp)):
        a = pipe.plan_cannon(core.graph_from_spec("powerlaw:600,2.2"), 2,
                             hub_split=True, autotune="fused",
                             cache=pipe.PlanCache())
        out.append(pipe.apply_delta(a, pipe.EdgeDelta(remove=rem),
                                    cache=pipe.PlanCache()))
    bj, bt = out
    assert bt.delta_report["level"] == "repack"
    assert bt.plan.hub is None and bj.plan.hub is None
    _same_artifact(bj, bt)
    assert _count(bt, method="fused").triangles == (
        tc.triangle_count_oracle(bt.graph))


@pytest.mark.parametrize("q", [1, 2])
def test_a_stream_on_a_hub_plan_stays_exact(q):
    g = tc.graph_from_spec("powerlaw:600,1.8")
    gj = jc.graph_from_spec("powerlaw:600,1.8")
    art = tp.plan_cannon(g, q, hub_split=True, autotune="fused",
                         cache=tp.PlanCache())
    aj = jp.plan_cannon(gj, q, hub_split=True, autotune="fused",
                        cache=jp.PlanCache())
    rng = np.random.default_rng(7)
    for i in range(4):
        have = set(map(tuple, g.edges.tolist()))
        while True:
            u, v = sorted(rng.integers(0, g.n, size=2).tolist())
            if u != v and (u, v) not in have:
                break
        add, rem = [[u, v]], [g.edges[int(rng.integers(g.m))].tolist()]
        art = tp.apply_delta(art, tp.EdgeDelta(add=add, remove=rem),
                             cache=tp.PlanCache())
        aj = jp.apply_delta(aj, jp.EdgeDelta(add=add, remove=rem),
                            cache=jp.PlanCache())
        _same_artifact(aj, art)
        g = tp.EdgeDelta(add=add, remove=rem).apply_to(g)
        got = _count(art, method="fused").triangles
        assert got == tc.triangle_count_oracle(g), i


# ----------------------------------------------------------------------
# count_triangles_delta's refusals
# ----------------------------------------------------------------------
def test_count_triangles_delta_refuses_the_measured_autotune():
    g = tc.graph_from_spec("named:karate")
    with pytest.raises(ValueError, match="measured"):
        rt.count_triangles_delta(g, tp.EdgeDelta(), autotune="measured",
                                 device="cpu")


def test_count_triangles_delta_refuses_a_base_without_an_artifact():
    from repro_torch.core import api

    api.register_schedule("no_artifact", lambda graph, grid, ctx: (0, None))
    try:
        with pytest.raises(ValueError, match="pipeline-planned base"):
            rt.count_triangles_delta(tc.graph_from_spec("named:karate"),
                                     tp.EdgeDelta(), schedule="no_artifact",
                                     device="cpu")
    finally:
        del api._SCHEDULES["no_artifact"]


def test_count_triangles_delta_drops_the_replanning_knobs():
    """``reorder``, ``cyclic_p``, ``rebalance_trials`` and ``hub_split``
    were fixed when the base was planned: the re-count takes them and
    ignores them."""
    g = tc.graph_from_spec("powerlaw:600,2.2")
    d = tp.EdgeDelta.random_flips(g, 4, seed=3)
    res = rt.count_triangles_delta(g, d, q=2, hub_split=True,
                                   rebalance_trials=2, device="cpu",
                                   cache=tp.PlanCache())
    assert res.triangles == tc.triangle_count_oracle(d.apply_to(g))
    assert res.hub is not None


# ----------------------------------------------------------------------
# tc_run --stream
# ----------------------------------------------------------------------
def test_tc_run_stream_end_to_end(tmp_path):
    g = tc.graph_from_spec("er:140,6,2")
    deltas, cur = [], g
    for i in range(3):
        add, rem = random_edge_flips(cur, 5, seed=11 + i)
        deltas.append({"add": add.tolist(), "remove": rem.tolist()})
        cur = tp.EdgeDelta(add=add, remove=rem).apply_to(cur)
    deltas.append({"add": [], "remove": []})  # a noop round
    stream = tmp_path / "deltas.jsonl"
    stream.write_text("\n".join(json.dumps(d) for d in deltas) + "\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tc_run",
         "--graph", "er:140,6,2", "--grid", "2", "--method", "fused",
         "--stream", str(stream), "--rebase-every", "2", "--verify",
         "--json", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["deltas_applied"] == 4
    assert {"dirty_blocks", "replanned_stages", "rebased"} <= set(report)
    assert all(r["correct"] for r in report["rounds"])
    assert report["triangles"] == tc.triangle_count_oracle(cur)
    assert report["rounds"][2]["level"] == "rebase"
    assert report["rounds"][3]["level"] == "noop"
    assert report["plan_cache"]["size"] >= 1


def test_tc_run_stream_refuses_graphs():
    with pytest.raises(SystemExit) as e:
        tc_run.main(["--graphs", "named:karate,named:bull",
                     "--stream", "x.jsonl", "--device", "cpu"])
    assert "--stream" in str(e.value) and "--graphs" in str(e.value)


# ----------------------------------------------------------------------
# property suite: the reference's, with its max_examples
# ----------------------------------------------------------------------
@st.composite
def graph_and_delta(draw):
    n = draw(st.integers(min_value=4, max_value=32))
    m = draw(st.integers(min_value=0, max_value=3 * n))
    src = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m))
    dst = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m))
    g = tc.Graph.from_edges(n, src, dst)
    k = draw(st.integers(min_value=0, max_value=min(6, n * (n - 1) // 2)))
    seed = draw(st.integers(min_value=0, max_value=2**16))
    return g, tp.EdgeDelta.random_flips(g, k, seed=seed)


@pytest.mark.parametrize("schedule", ["cannon", "summa", "oned"])
@pytest.mark.parametrize("method", ["search2", "fused"])
@pytest.mark.parametrize("compact", [True, False])
@given(gd=graph_and_delta())
@settings(max_examples=4, deadline=None)
def test_property_delta_count_equivalence(schedule, method, compact, gd):
    g, d = gd
    # search2 is a Cannon method; the other schedules run search in its
    # slot, as the reference's suite does
    m = method if schedule == "cannon" or method == "fused" else "search"
    kwargs = dict(q=1, schedule=schedule, method=m, compact=compact,
                  device="cpu")
    inc = rt.count_triangles_delta(g, d, cache=tp.PlanCache(), **kwargs)
    g2 = d.apply_to(g)
    fresh = rt.count_triangles(g2, cache=tp.PlanCache(maxsize=2), **kwargs)
    assert inc.triangles == fresh.triangles == tc.triangle_count_oracle(g2)


@given(gd=graph_and_delta())
@settings(max_examples=15, deadline=None)
def test_property_splice_matches_the_reference_and_a_cold_pack(gd):
    g, d = gd
    if g.m == 0 and d.k == 0:
        return
    gj = jc.Graph(n=g.n, edges=g.edges.copy(), name=g.name)
    dj = jp.EdgeDelta(add=d.add, remove=d.remove)
    for q in (2, 3):
        art = tp.plan_cannon(g, q, reorder=False, cache=tp.PlanCache())
        art2 = tp.apply_delta(art, d, cache=tp.PlanCache(maxsize=0))
        ref = ts.pack_tc_plan(d.apply_to(g), q, skew_perm=art2.plan.skew_perm)
        _assert_cold_parity(art2.plan, ref)
        aj = jp.plan_cannon(gj, q, reorder=False, cache=jp.PlanCache())
        _same_artifact(jp.apply_delta(aj, dj, cache=jp.PlanCache(maxsize=0)),
                       art2)
        assert _count(art2, method="search").triangles == (
            tc.triangle_count_oracle(art2.graph))


def test_the_reference_stages_module_is_the_one_compared():
    """The cold re-pack of the port's tests is the port's packer; the
    reference's gives the same arrays for the same graph and σ."""
    g = tc.graph_from_spec(GRAPH)
    gj = jc.graph_from_spec(GRAPH)
    for q in (2, 3):
        sp = tuple(range(q))[::-1]
        _same(js.pack_tc_plan(gj, q, skew_perm=sp),
              ts.pack_tc_plan(g, q, skew_perm=sp))
