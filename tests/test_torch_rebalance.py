"""The port's skip-aware rebalance stage against the JAX package's.

Rebalancing is host numpy in both packages, so parity is identity: the
same trial permutations byte for byte, the same search report (``==`` as
dicts), the same winning plan arrays and the same cache keys, on Cannon,
SUMMA and the ring.  Counts of rebalanced plans are integers and must be
the oracle's on every schedule and method.  Counts of the reference at
q > 1 come from the one multi-device subprocess in
``tests/test_torch_hubsplit.py``.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jc
import repro.pipeline as jp
import repro_torch as rt
import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro.pipeline.rebalance import (
    masked_critical_path as j_mcp,
    rebalance_trial_perm as j_perm,
)
from repro_torch.launch.tc_run import _rebalance_fields
from repro_torch.pipeline.rebalance import (
    masked_critical_path,
    plan_cost,
    rebalance_trial_perm,
)

FIXTURES = {
    "karate": "named:karate",
    "powerlaw22": "powerlaw:600,2.2",
    "powerlaw18": "powerlaw:600,1.8",
    "rmat9": "rmat:9,8,1",
    "rmat10": "rmat:10,8,2",
    "star": "star:64",
    "cliques3": "cliques:3,60",
    "edgeless": "er:24,0",
}
_ORACLE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _oracle(name):
    if name not in _ORACLE:
        _ORACLE[name] = tc.triangle_count_oracle(
            tc.graph_from_spec(FIXTURES[name]))
    return _ORACLE[name]


def _plans(kind, spec, **kw):
    """The same planner call in both packages: (reference, port)."""
    out = []
    for core, pipe in ((jc, jp), (tc, tp)):
        g = core.graph_from_spec(spec)
        if kind == "cannon":
            out.append(pipe.plan_cannon(g, 2, cache=pipe.PlanCache(), **kw))
        elif kind == "summa":
            out.append(pipe.plan_summa(g, 2, 3, cache=pipe.PlanCache(), **kw))
        else:
            out.append(pipe.plan_oned(g, 4, cache=pipe.PlanCache(), **kw))
    return out


def _same_arrays(a, b):
    da, db = a.plan.device_arrays(), b.plan.device_arrays()
    assert list(db) == list(da)
    for k in da:
        assert db[k].dtype == da[k].dtype and db[k].shape == da[k].shape, k
        assert db[k].tobytes() == da[k].tobytes(), k


# ----------------------------------------------------------------------
# trial permutations and the cost
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", ["karate", "powerlaw22", "rmat9", "star",
                                  "edgeless"])
def test_trial_perm_byte_equal_and_degree_monotone(name, seed):
    g2, _ = tc.preprocess(tc.graph_from_spec(FIXTURES[name]))
    deg = g2.degrees()
    got = rebalance_trial_perm(deg, seed)
    want = j_perm(deg, seed)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.array_equal(np.sort(got), np.arange(g2.n))
    if seed == 0:
        assert np.array_equal(got, np.arange(g2.n))
    assert np.all(np.diff(g2.relabel(got).degrees()) >= 0)


@given(st.integers(1, 60), st.integers(0, 5), st.integers(0, 2**31 - 1))
@settings(max_examples=8, deadline=None)
def test_trial_perm_matches_on_random_degree_runs(n, seed, draw_seed):
    deg = np.sort(np.random.default_rng(draw_seed).integers(0, 4, n))
    assert rebalance_trial_perm(deg, seed).tobytes() == j_perm(
        deg, seed).tobytes()


@pytest.mark.parametrize("shape", [(4,), (2, 3, 4), (3, 3, 3), (0, 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_critical_path_matches(shape, masked):
    rng = np.random.default_rng(7)
    probe = rng.integers(0, 50, shape)
    keep = rng.random(shape) < 0.6 if masked else None
    assert masked_critical_path(probe, keep) == j_mcp(probe, keep)


def test_plan_cost_needs_stats():
    art = tp.plan_oned(tc.rmat(7, 8), 2, cache=tp.PlanCache())
    with pytest.raises(AssertionError, match="with_stats"):
        plan_cost(art.plan)


# ----------------------------------------------------------------------
# the stage through the three planners
# ----------------------------------------------------------------------
@pytest.mark.parametrize("trials", [1, 3])
@pytest.mark.parametrize("kind", ["cannon", "summa", "oned"])
@pytest.mark.parametrize("name", ["karate", "powerlaw22", "powerlaw18",
                                  "rmat10", "cliques3", "edgeless"])
def test_rebalance_report_and_plan_equal_the_reference(name, kind, trials):
    a, b = _plans(kind, FIXTURES[name], rebalance_trials=trials)
    assert b.rebalance == a.rebalance
    assert b.key == a.key
    assert np.array_equal(b.perm, a.perm)
    assert np.array_equal(b.graph.edges, a.graph.edges)
    _same_arrays(a, b)
    rb = b.rebalance
    assert len(rb["trials"]) == trials
    assert rb["best_masked_critical_path"] <= rb[
        "baseline_masked_critical_path"]
    assert rb["improvement"] >= 1.0
    assert b.stage_seconds["rebalance"] >= 0
    assert tc.triangle_count_oracle(b.graph) == _oracle(name)


@pytest.mark.parametrize("flags", [
    dict(with_stats=False),
    dict(keep_blocks=False),
    dict(keep_blocks=False, aug_keys=True),
    dict(keep_blocks=False, step_masks=False, compact=False),
    dict(bucketize=True),
    dict(autotune="fused"),
], ids=["no-stats", "lean", "aug", "no-masks", "bucketize", "fused"])
def test_winner_reused_or_repacked_as_the_reference(flags):
    """The winner's trial plan is the plan only when the caller's flags
    equal the trial flags; otherwise it is re-packed — byte-identical to
    the reference either way."""
    a, b = _plans("cannon", FIXTURES["powerlaw18"], rebalance_trials=3,
                  **flags)
    assert b.rebalance == a.rebalance and b.key == a.key
    _same_arrays(a, b)


@pytest.mark.parametrize("kind", ["cannon", "summa", "oned"])
def test_rebalance_cache_keying(kind):
    """Same trials: a warm hit; other trials: another key, as the
    reference keys them."""
    g = tc.graph_from_spec(FIXTURES["powerlaw22"])
    cache = tp.PlanCache()

    def plan(trials):
        if kind == "cannon":
            return tp.plan_cannon(g, 2, rebalance_trials=trials, cache=cache)
        if kind == "summa":
            return tp.plan_summa(g, 2, 2, rebalance_trials=trials,
                                 cache=cache)
        return tp.plan_oned(g, 3, rebalance_trials=trials, cache=cache)

    a1 = plan(2)
    assert not a1.cache_hit
    a2 = plan(2)
    assert a2 is a1 and a2.cache_hit
    a3 = plan(3)
    assert not a3.cache_hit and a3.key != a1.key
    assert plan(0).rebalance is None


# ----------------------------------------------------------------------
# counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", ["search", "global", "fused", "auto"])
@pytest.mark.parametrize("schedule,grid", [
    ("cannon", (2, 2)), ("cannon", (3, 3)), ("summa", (2, 3)),
    ("oned", (2, 2)),
], ids=["cannon-2", "cannon-3", "summa-2x3", "oned-4"])
@pytest.mark.parametrize("name", ["karate", "powerlaw18", "rmat9",
                                  "cliques3", "star"])
def test_rebalanced_count_matches_oracle(name, schedule, grid, method):
    r = rt.count_triangles(tc.graph_from_spec(FIXTURES[name]), grid=grid,
                           schedule=schedule, method=method,
                           rebalance_trials=3, device="cpu",
                           cache=tp.PlanCache())
    assert r.triangles == _oracle(name)
    assert r.rebalance is not None and r.rebalance == r.artifact.rebalance


@pytest.mark.parametrize("compact", [None, False])
@pytest.mark.parametrize("method", ["search2", "tile", "dense"])
def test_rebalanced_cannon_only_methods(method, compact):
    r = rt.count_triangles(tc.graph_from_spec(FIXTURES["powerlaw22"]), q=2,
                           method=method, rebalance_trials=2,
                           compact=compact, device="cpu",
                           cache=tp.PlanCache())
    assert r.triangles == _oracle("powerlaw22")


@pytest.mark.parametrize("schedule", ["cannon", "summa", "oned"])
def test_rebalanced_count_matches_the_reference_at_q1(schedule):
    spec = FIXTURES["powerlaw18"]
    want = jc.count_triangles(jc.graph_from_spec(spec), q=1,
                              schedule=schedule, rebalance_trials=3,
                              cache=jp.PlanCache())
    got = rt.count_triangles(tc.graph_from_spec(spec), q=1,
                             schedule=schedule, rebalance_trials=3,
                             device="cpu", cache=tp.PlanCache())
    assert got.triangles == want.triangles == _oracle("powerlaw18")
    assert got.rebalance == want.rebalance


# ----------------------------------------------------------------------
# refusals: the reference's
# ----------------------------------------------------------------------
def _message(call):
    with pytest.raises(ValueError) as e:
        call()
    return str(e.value)


@pytest.mark.parametrize("kind", ["cannon", "summa", "oned"])
def test_rebalance_refuses_reorder_false(kind):
    msgs = [_message(lambda: _plans_one(kind, core, pipe))
            for core, pipe in ((jc, jp), (tc, tp))]
    assert msgs[0] == msgs[1] and "reorder=True" in msgs[1]


def _plans_one(kind, core, pipe):
    g = core.rmat(7, 8)
    kw = dict(rebalance_trials=2, reorder=False, cache=pipe.PlanCache())
    if kind == "cannon":
        return pipe.plan_cannon(g, 2, **kw)
    if kind == "summa":
        return pipe.plan_summa(g, 2, 2, **kw)
    return pipe.plan_oned(g, 2, **kw)


def test_rebalance_refuses_a_caller_plan():
    ja = jp.plan_cannon(jc.rmat(7, 8), 1, cache=jp.PlanCache())
    ta = tp.plan_cannon(tc.rmat(7, 8), 1, cache=tp.PlanCache())
    want = _message(lambda: jc.count_triangles(
        jc.rmat(7, 8), q=1, plan=ja.plan, rebalance_trials=2))
    got = _message(lambda: rt.count_triangles(
        tc.rmat(7, 8), q=1, plan=ta.plan, rebalance_trials=2, device="cpu"))
    assert got == want


def test_report_fields_emit_null_for_an_infinite_improvement():
    rb = dict(trials=[{}, {}], best_seed=1, baseline_masked_critical_path=4.0,
              best_masked_critical_path=0.0, improvement=math.inf,
              skipped_steps=3, baseline_skipped_steps=1)
    out = _rebalance_fields(rb)
    assert out["rebalance_improvement"] is None
    assert out["rebalance_skipped_delta"] == 2 and out["rebalance_trials"] == 2
