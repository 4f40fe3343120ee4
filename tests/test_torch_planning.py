"""Host planning of the PyTorch port against the JAX package's.

Planning is host numpy in both packages, so parity is byte identity: the
same graph spec gives the same edge array, the same permutation, and —
through ``plan_cannon`` — the same stacked arrays (dtype, shape, bytes),
the same derived shapes and the same cache key, for q in {1, 2, 3} over
the planner's flag grid.  No tolerance anywhere: everything is integers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.pipeline as jp
import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro.core.plan import _build_plan_loops as j_build_plan_loops
from repro_torch.core.plan import _build_plan_loops as t_build_plan_loops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPECS = [
    "rmat:8,8,5",
    "rmat:9,8",
    "er:200,6,3",
    "powerlaw:300,2.5,1",
    "star:50",
    "cliques:3,60",
    "cliques:2,10",
    "named:karate",
    "named:k10",
    "named:bull",
    "delta:5,0,rmat:8,8",
]


@pytest.mark.parametrize("spec", SPECS)
def test_generators_identical(spec):
    a = jc.graph_from_spec(spec)
    b = tc.graph_from_spec(spec)
    assert a.n == b.n and a.name == b.name
    assert a.edges.dtype == b.edges.dtype
    assert np.array_equal(a.edges, b.edges)


def test_karate_needs_no_graph_library():
    g = tc.named_graph("karate")
    assert (g.n, g.m) == (34, 78)
    assert tc.triangle_count_oracle(g) == 45


@pytest.mark.parametrize("spec", ["rmat:9,8", "powerlaw:300,2.5,1", "star:50"])
def test_preprocess_identical(spec):
    a, b = jc.graph_from_spec(spec), tc.graph_from_spec(spec)
    ga, pa = jc.preprocess(a)
    gb, pb = tc.preprocess(b)
    assert np.array_equal(pa, pb)
    assert np.array_equal(ga.edges, gb.edges)
    from repro.core.preprocess import cyclic_relabel as jcyc
    from repro_torch.core.preprocess import cyclic_relabel as tcyc

    for p in (1, 3, 7):
        assert np.array_equal(jcyc(a.n, p), tcyc(b.n, p))


def test_oracles_agree():
    g = tc.rmat(7, 8, seed=3)
    from repro_torch.core.graph import triangle_count_dense_oracle

    assert tc.triangle_count_oracle(g) == triangle_count_dense_oracle(g)
    assert tc.triangle_count_oracle(g) == jc.triangle_count_oracle(
        jc.rmat(7, 8, seed=3)
    )


def _assert_same_plan(pa, pb):
    da, db = pa.device_arrays(), pb.device_arrays()
    assert list(da) == list(db)
    for k in da:
        assert da[k].dtype == db[k].dtype, k
        assert da[k].shape == db[k].shape, k
        assert da[k].tobytes() == db[k].tobytes(), k
    for f in ("n", "m", "q", "nb", "nnz_pad", "tmax", "dmax", "chunk",
              "n_long", "d_small", "autotune", "skew_perm"):
        assert getattr(pa, f) == getattr(pb, f), f
    ca, cb = pa.compact, pb.compact
    assert (ca is None) == (cb is None)
    if ca is not None:
        assert ca.live_steps == cb.live_steps
        assert ca.n_total == cb.n_total
        assert ca.hops == cb.hops
    if pa.stats is not None:
        for f in dataclasses.fields(pa.stats):
            va, vb = getattr(pa.stats, f.name), getattr(pb.stats, f.name)
            if va is None or vb is None:
                continue  # the loop reference does not fill every field
            if isinstance(va, np.ndarray):
                assert np.array_equal(va, vb), f.name
            else:
                assert va == vb, f.name


PLAN_SPECS = ["rmat:8,8,5", "cliques:3,60"]


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("aug_keys", [False, True])
@pytest.mark.parametrize("autotune", [False, True, "fused"])
@pytest.mark.parametrize("q", [1, 2, 3])
def test_plan_cannon_byte_identical(q, autotune, aug_keys, compact):
    for spec in PLAN_SPECS:
        kw = dict(autotune=autotune, aug_keys=aug_keys, compact=compact,
                  keep_blocks=False)
        a = jp.plan_cannon(jc.graph_from_spec(spec), q,
                           cache=jp.PlanCache(), **kw)
        b = tp.plan_cannon(tc.graph_from_spec(spec), q,
                           cache=tp.PlanCache(), **kw)
        _assert_same_plan(a.plan, b.plan)
        assert a.key == b.key
        assert a.digest == b.digest
        assert np.array_equal(a.perm, b.perm)
        assert np.array_equal(a.graph.edges, b.graph.edges)


@pytest.mark.parametrize(
    "kw",
    [
        dict(cyclic_p=4),
        dict(skew=False),
        dict(with_stats=False),
        dict(step_masks=False),
        dict(reorder=False),
        dict(chunk=64, autotune=True),
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_plan_cannon_other_knobs_identical(kw):
    a = jp.plan_cannon(jc.rmat(8, 8, seed=2), 3, cache=jp.PlanCache(), **kw)
    b = tp.plan_cannon(tc.rmat(8, 8, seed=2), 3, cache=tp.PlanCache(), **kw)
    _assert_same_plan(a.plan, b.plan)
    assert a.key == b.key


def test_compaction_elides_steps_on_cliques():
    """cliques:3,60 at q = 3 is the fixture where the σ search elides
    steps — the port must pick the same σ and the same live steps."""
    b = tp.plan_cannon(tc.graph_from_spec("cliques:3,60"), 3,
                       cache=tp.PlanCache())
    a = jp.plan_cannon(jc.graph_from_spec("cliques:3,60"), 3,
                       cache=jp.PlanCache())
    assert b.plan.compact.n_elided > 0
    assert b.plan.compact.live_steps == a.plan.compact.live_steps
    assert b.plan.skew_perm == a.plan.skew_perm


@pytest.mark.parametrize("q", [1, 2, 3])
def test_loop_reference_pins_vectorized_packer(q):
    g = tc.preprocess(tc.rmat(8, 8, seed=7))[0]
    for kw in (dict(), dict(aug_keys=True), dict(skew=False)):
        _assert_same_plan(
            t_build_plan_loops(g, q, **kw), tc.build_plan(g, q, **kw)
        )
    gj = jc.preprocess(jc.rmat(8, 8, seed=7))[0]
    pa, pb = j_build_plan_loops(gj, q), t_build_plan_loops(g, q)
    assert pa.a_indices.tobytes() == pb.a_indices.tobytes()
    assert pa.step_keep.tobytes() == pb.step_keep.tobytes()


def test_graph_digest_and_cache_behaviour():
    from repro.pipeline.cache import graph_digest as jd
    from repro_torch.pipeline.cache import graph_digest as td

    g = tc.rmat(8, 8, seed=1)
    assert td(g) == jd(jc.rmat(8, 8, seed=1))
    shuffled = tc.Graph(n=g.n, edges=g.edges[::-1].copy())
    assert td(shuffled) == td(g)
    cache = tp.PlanCache()
    first = tp.plan_cannon(g, 2, cache=cache)
    again = tp.plan_cannon(shuffled, 2, cache=cache)
    assert again is first and again.cache_hit
    assert cache.stats()["hits"] >= 1
    other = tp.plan_cannon(g, 2, autotune="fused", cache=cache)
    assert other is not first


@pytest.mark.parametrize(
    "kw", [dict(rebalance_trials=2), dict(hub_split=True)],
    ids=["rebalance", "hub_split"],
)
def test_later_stages_raise_not_implemented(kw):
    """The rebalance and hub-split stages, once refused with
    ``NotImplementedError``, now plan: no stage raises, and the artifact
    has the reference's key, reports and arrays."""
    a = jp.plan_cannon(jc.rmat(7, 8), 2, cache=jp.PlanCache(), **kw)
    b = tp.plan_cannon(tc.rmat(7, 8), 2, cache=tp.PlanCache(), **kw)
    assert b.key == a.key
    assert b.rebalance == a.rebalance and b.hubsplit == a.hubsplit
    da, db = a.plan.device_arrays(), b.plan.device_arrays()
    assert list(db) == list(da)
    assert all(db[k].tobytes() == da[k].tobytes() for k in da)


def test_plan_from_numpy_round_trip():
    art = tp.plan_cannon(tc.graph_from_spec("cliques:3,60"), 3,
                         autotune="fused", aug_keys=True, cache=tp.PlanCache())
    p = art.plan
    meta = dict(n=p.n, m=p.m, q=p.q, nb=p.nb, nnz_pad=p.nnz_pad, tmax=p.tmax,
                dmax=p.dmax, chunk=p.chunk, n_long=p.n_long,
                d_small=p.d_small, autotune=p.autotune,
                skew_perm=p.skew_perm, live_steps=p.compact.live_steps)
    p2 = tc.plan_from_numpy(p.device_arrays(), meta)
    _assert_same_plan(dataclasses.replace(p, stats=None), p2)
    with pytest.raises(ValueError, match="missing"):
        tc.plan_from_numpy({"a_indptr": p.a_indptr}, meta)
