"""The port's Cannon engine end to end, on the CPU, against the exact
oracle and against the JAX package.

``repro_torch.count_triangles`` must give the oracle's integer for every
fixture at q in {1, 2, 3}, for every method, with the step mask and the
compaction on and off; the JAX package's count in-process at q = 1 and,
through one 9-device subprocess, at q = 3; and the same integer when the
engine is run from a plan made by the JAX package's planner.  Counts are
integers: parity is ``==``.
"""
import json

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.pipeline as jp
import repro_torch as rt
import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro_torch.core.cannon import build_cannon_fn
from repro_torch.core.engine import CannonSchedule, shift_perm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIXTURES = {
    "karate": "named:karate",
    "rmat8": "rmat:8,8,5",
    "rmat9": "rmat:9,8,42",
    "er": "er:200,6,3",
    "cliques2": "cliques:2,10",
    "cliques3": "cliques:3,60",
    "star": "star:64",
    "edgeless": "er:24,0",
}
METHODS = ("search", "global", "fused")

_ORACLE = {}


def _graph(name):
    return tc.graph_from_spec(FIXTURES[name])


def _oracle(name):
    if name not in _ORACLE:
        _ORACLE[name] = tc.triangle_count_oracle(_graph(name))
    return _ORACLE[name]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_count_matches_oracle(name, q, method):
    r = rt.count_triangles(_graph(name), q=q, method=method, device="cpu")
    assert isinstance(r.triangles, int)
    assert r.triangles == _oracle(name)
    assert r.grid == (q, q) and r.method == method and r.device == "cpu"


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("compact", [None, False, True])
@pytest.mark.parametrize("use_step_mask", [None, False])
@pytest.mark.parametrize("name", ["rmat8", "cliques3", "star"])
def test_mask_and_compaction_do_not_change_the_count(
    name, use_step_mask, compact, method
):
    r = rt.count_triangles(
        _graph(name), q=3, method=method, use_step_mask=use_step_mask,
        compact=compact, device="cpu", cache=tp.PlanCache(),
    )
    assert r.triangles == _oracle(name)


def test_compaction_keeps_original_step_indices():
    """cliques:3,60 at q = 3: the σ search leaves one live step that is
    not step 0 of the identity order.  A loop that renumbered live steps
    (or mis-signed the prologue hop) would index the wrong mask column or
    pair the wrong blocks and lose triangles."""
    g = _graph("cliques3")
    art = tp.plan_cannon(g, 3, cache=tp.PlanCache())
    cs = art.plan.compact
    assert cs.n_elided > 0
    for method in ("search", "global"):
        fn = build_cannon_fn(art, method=method, compact=True)
        assert int(fn(**art.staged("cpu"))) == _oracle("cliques3")
    # a superset of the live set is still right (dead steps count zero)
    for live in ((0, 1, 2), (0, 2), (1, 2), (2,), (1,), (0,)):
        plan = art.plan
        keep_any = plan.step_keep.reshape(-1, 3).any(axis=0)
        if not all(keep_any[s] <= (s in live) for s in range(3)):
            continue
        sched_plan = tc.plan_from_numpy(
            plan.device_arrays(),
            dict(n=plan.n, m=plan.m, q=3, nb=plan.nb, nnz_pad=plan.nnz_pad,
                 tmax=plan.tmax, dmax=plan.dmax, chunk=plan.chunk,
                 skew_perm=plan.skew_perm, live_steps=live),
        )
        fn = build_cannon_fn(sched_plan, method="search", compact=True)
        assert int(fn(**art.staged("cpu"))) == _oracle("cliques3"), live


def test_shift_sign_matches_shift_perm():
    """A shift of k moves the block at grid position s to (s - k) % q:
    A along the column dimension, B along the row dimension."""
    q = 3
    a = torch.arange(q * q).reshape(q, q, 1)
    sched = CannonSchedule(q=q)
    for k in (1, 2):
        (a2,), (b2,) = sched._shift_k(((a,), (a,)), k)
        for s, dst in shift_perm(q, k):
            assert torch.equal(a2[:, dst], a[:, s])
            assert torch.equal(b2[dst, :], a[s, :])
    assert sched._shift_k(((a,), (a,)), q)[0][0] is a  # full turn: no-op


def test_per_device_counts_sum_to_the_total():
    g = _graph("rmat9")
    art = tp.plan_cannon(g, 3, cache=tp.PlanCache())
    per = build_cannon_fn(art, reduce_global=False)(**art.staged("cpu"))
    assert tuple(per.shape) == (3, 3) and per.dtype == torch.int64
    assert int(per.sum()) == _oracle("rmat9")
    with pytest.raises(ValueError, match="tree"):
        build_cannon_fn(art, reduce_strategy="tree")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", list(FIXTURES))
def test_matches_reference_in_process_q1(name, method):
    want = jc.count_triangles(
        jc.graph_from_spec(FIXTURES[name]), q=1, method=method
    ).triangles
    got = rt.count_triangles(_graph(name), q=1, method=method, device="cpu")
    assert got.triangles == want


@pytest.fixture(scope="module")
def reference_q3(distributed_runner):
    """The JAX package's counts at q = 3 (9 host devices), every fixture
    with the default method and two fixtures with the other two — one
    subprocess for all of them."""
    code = f"""
import json
from repro.core import count_triangles, graph_from_spec
fixtures = {FIXTURES!r}
out = {{}}
for name, spec in fixtures.items():
    g = graph_from_spec(spec)
    out[name + "/search"] = count_triangles(g, q=3, method="search").triangles
for name in ("rmat9", "cliques3"):
    g = graph_from_spec(fixtures[name])
    for method in ("global", "fused"):
        out[name + "/" + method] = count_triangles(g, q=3, method=method).triangles
print("RESULT" + json.dumps(out))
"""
    out = distributed_runner(code, ndev=9)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("name", list(FIXTURES))
def test_matches_reference_q3_search(reference_q3, name):
    got = rt.count_triangles(_graph(name), q=3, method="search", device="cpu")
    assert got.triangles == reference_q3[name + "/search"] == _oracle(name)


@pytest.mark.parametrize("method", ["global", "fused"])
@pytest.mark.parametrize("name", ["rmat9", "cliques3"])
def test_matches_reference_q3_other_methods(reference_q3, name, method):
    got = rt.count_triangles(_graph(name), q=3, method=method, device="cpu")
    assert got.triangles == reference_q3[f"{name}/{method}"] == _oracle(name)


def _port_plan_from_reference(art):
    """Extract plain numpy + Python values from a JAX-package plan."""
    p = art.plan
    arrays = {k: np.asarray(v) for k, v in p.device_arrays().items()}
    meta = dict(
        n=p.n, m=p.m, q=p.q, nb=p.nb, nnz_pad=p.nnz_pad, tmax=p.tmax,
        dmax=p.dmax, chunk=p.chunk, n_long=p.n_long, d_small=p.d_small,
        autotune=p.autotune, skew_perm=p.skew_perm,
        live_steps=None if p.compact is None else p.compact.live_steps,
    )
    return tc.plan_from_numpy(arrays, meta)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("q", [2, 3])
@pytest.mark.parametrize("name", ["rmat9", "cliques3", "karate"])
def test_engine_runs_from_a_reference_plan(name, q, method):
    art = jp.plan_cannon(
        jc.graph_from_spec(FIXTURES[name]), q,
        autotune="fused" if method == "fused" else False,
        aug_keys=(method != "search"), keep_blocks=False,
        cache=jp.PlanCache(),
    )
    plan = _port_plan_from_reference(art)
    r = rt.count_triangles(_graph(name), plan=plan, method=method,
                           device="cpu")
    assert r.triangles == _oracle(name)
    assert r.grid == (q, q) and r.artifact is None


def test_warm_second_count_hits_the_cache():
    cache = tp.PlanCache()
    g = _graph("rmat9")
    first = rt.count_triangles(g, q=2, method="fused", device="cpu",
                               cache=cache)
    hits = cache.hits
    second = rt.count_triangles(g, q=2, method="fused", device="cpu",
                                cache=cache)
    assert second.triangles == first.triangles == _oracle("rmat9")
    assert second.artifact is first.artifact and second.artifact.cache_hit
    assert cache.hits > hits
    staged = first.artifact.staged("cpu")
    assert first.artifact.staged("cpu") is staged  # memoised per device
    assert all(t.device.type == "cpu" for t in staged.values())
    assert staged["a_indices"].dtype == torch.int32
    # a PlanArtifact handed back in as the plan reuses its staged tensors
    third = rt.count_triangles(g, plan=first.artifact, method="fused",
                               device="cpu")
    assert third.triangles == first.triangles


def test_forced_int32_count_raises_on_overflow():
    from repro_torch.core.api import check_count_overflow

    assert check_count_overflow(2**31 - 2, torch.int32) == 2**31 - 2
    assert check_count_overflow(2**40, torch.int64) == 2**40
    with pytest.raises(OverflowError):
        check_count_overflow(2**31 - 1, torch.int32)
    r = rt.count_triangles(_graph("karate"), count_dtype=torch.int32,
                           device="cpu")
    assert r.triangles == 45
    with pytest.raises(ValueError, match="count_dtype"):
        rt.count_triangles(_graph("karate"), count_dtype=torch.float32,
                           device="cpu")


def test_unknown_method_and_schedule_list_what_is_registered():
    g = _graph("karate")
    with pytest.raises(
        ValueError,
        match=r"registered: \['auto', 'dense', 'fused', 'global', 'search', "
              r"'search2', 'tile'\]",
    ):
        rt.count_triangles(g, method="bogus", device="cpu")
    with pytest.raises(ValueError,
                       match=r"registered: \['cannon', 'oned', 'summa'\]"):
        rt.count_triangles(g, schedule="bogus", device="cpu")
    with pytest.raises(ValueError, match="autotune"):
        rt.count_triangles(g, autotune="bogus", device="cpu")
    # the measured mode is a mode now; it governs only auto and fused, so
    # an explicit search runs no autotune stage, as in the JAX package
    r = rt.count_triangles(g, autotune="measured", device="cpu")
    assert r.triangles == 45 and r.autotune_mode is None
    assert r.measured_table_hit is None
    assert rt.available_schedules() == ["cannon", "oned", "summa"]
