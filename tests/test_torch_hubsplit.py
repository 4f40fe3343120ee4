"""The port's hub-split stage and hub partial against the JAX package's.

Splitting is host numpy in both packages, so parity is identity: the same
cut, every hub-side array byte for byte, the same residual plan, reports
``==`` as dicts and the same cache keys.  Counts are integers: with the
hub side on, every schedule and method must give the oracle's count, and
the reference's at q = 1 in process.  This file also holds the one
multi-device subprocess of the reference that the planner-stage tests
take (4 host devices): hub-split and rebalanced counts and per-device
partials on Cannon 2 x 2, SUMMA 2 x 2 and the ring p = 4, and the batched
front end's counts, padding overhead and stacked arrays there.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.pipeline as jp
import repro_torch as rt
import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro.pipeline import hubsplit as jh
from repro_torch.core.cannon import build_cannon_fn
from repro_torch.core.engine import HubCount
from repro_torch.core.onedim import build_oned_fn
from repro_torch.core.summa import build_summa_fn
from repro_torch.pipeline import hubsplit as th

FIXTURES = {
    "karate": "named:karate",
    "powerlaw22": "powerlaw:600,2.2",
    "powerlaw18": "powerlaw:600,1.8",
    "rmat9": "rmat:9,8,1",
    "rmat11": "rmat:11,8,3",
    "star": "star:64",
    "cliques3": "cliques:3,60",
    "k10": "named:k10",
    "edgeless": "er:24,0",
}
METHODS = ("search", "global", "fused", "auto")
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


def _graph(name):
    return tc.graph_from_spec(FIXTURES[name])


def _oracle(name):
    if name not in _ORACLE:
        _ORACLE[name] = tc.triangle_count_oracle(_graph(name))
    return _ORACLE[name]


def _relabeled(core, name):
    return core.preprocess(core.graph_from_spec(FIXTURES[name]))[0]


def _same_hub(a, b):
    """Every field of the port's HubSide equal to the reference's: arrays
    by dtype, shape and bytes."""
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert vb.dtype == va.dtype and vb.shape == va.shape, f.name
            assert vb.tobytes() == va.tobytes(), f.name
        else:
            assert vb == va, f.name
    assert b.report() == a.report()
    assert list(b.device_arrays()) == list(a.device_arrays())


def _plans(kind, name, **kw):
    """The same planner call in both packages: (reference, port)."""
    out = []
    for core, pipe in ((jc, jp), (tc, tp)):
        g = core.graph_from_spec(FIXTURES[name])
        if kind == "cannon":
            out.append(pipe.plan_cannon(g, 2, cache=pipe.PlanCache(), **kw))
        elif kind == "summa":
            out.append(pipe.plan_summa(g, 2, 3, cache=pipe.PlanCache(), **kw))
        else:
            out.append(pipe.plan_oned(g, 4, cache=pipe.PlanCache(), **kw))
    return out


# ----------------------------------------------------------------------
# the knob and the cut
# ----------------------------------------------------------------------
@pytest.mark.parametrize("value", [False, None, True, 0, 0.0, 1, 2.5, "3"])
def test_normalize_hub_split_matches(value):
    assert th.normalize_hub_split(value) == jh.normalize_hub_split(value)
    assert th.DEFAULT_HUB_C == jh.DEFAULT_HUB_C == 8.0


def test_normalize_hub_split_refuses_a_negative_threshold():
    msgs = []
    for mod in (jh, th):
        with pytest.raises(ValueError) as e:
            mod.normalize_hub_split(-1.0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("c", [0.0, 1.0, 8.0])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_detect_hub_cut_matches(name, c):
    h0 = th.detect_hub_cut(_relabeled(tc, name), c)
    assert h0 == jh.detect_hub_cut(_relabeled(jc, name), c)
    g2 = _relabeled(tc, name)
    if c == 0.0 and g2.m:  # every vertex of nonzero degree is a hub
        assert h0 == int((g2.degrees() == 0).sum())
    if g2.m == 0:
        assert h0 == g2.n


def test_detect_hub_cut_on_a_graph_without_vertices():
    g = tc.Graph.from_edges(0, [], [])
    assert th.detect_hub_cut(g, 8.0) == 0


# ----------------------------------------------------------------------
# the hub side, byte for byte
# ----------------------------------------------------------------------
@pytest.mark.parametrize("c", [0.0, 1.0, 8.0])
@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (2, 3), (4,)], ids=str)
@pytest.mark.parametrize("name", ["karate", "powerlaw22", "powerlaw18",
                                  "rmat11", "star", "cliques3", "k10",
                                  "edgeless"])
def test_hub_side_byte_equal(name, grid, c):
    ra, ha = jh.hubsplit_stage(_relabeled(jc, name), grid, c=c, chunk=64)
    rb, hb = th.hubsplit_stage(_relabeled(tc, name), grid, c=c, chunk=64)
    _same_hub(ha, hb)
    assert rb.n == ra.n and rb.name == ra.name
    assert rb.edges.tobytes() == ra.edges.tobytes()


@pytest.mark.parametrize("name", ["powerlaw22", "powerlaw18", "rmat11",
                                  "star", "cliques3"])
def test_residual_and_hub_partition_the_edges(name):
    """residual nnz + hub nnz == m, the residual holds every U edge below
    the cut, and T(residual) + the hub partial == T(G) at any cut —
    with the hub partial counted by HubCount over the staged arrays."""
    g2 = _relabeled(tc, name)
    for h0 in sorted({1, g2.n // 2, max(1, g2.n - 3)}):
        res, hub = th.hubsplit_stage(g2, (2, 3), h0=h0)
        if hub is None:
            assert tc.triangle_count_oracle(res) == _oracle(name)
            continue
        assert res.m + hub.hub_nnz == g2.m
        assert (res.edges[:, 1] < h0).all() and hub.h0 == h0
        arrays = {k: torch.from_numpy(v)
                  for k, v in hub.device_arrays().items()}
        count = HubCount(dpad=hub.dpad, chunk=hub.chunk,
                         sentinel=hub.sentinel, hub_cnt=hub.hub_cnt)
        out = count.count(arrays, torch.zeros((2, 3), dtype=torch.int64))
        assert tc.triangle_count_oracle(res) + int(out.sum()) == _oracle(name)


@pytest.mark.parametrize("flags", [
    dict(hub_split=True),
    dict(hub_split=1.0, autotune="fused"),
    dict(hub_split=0.0),
    dict(hub_split=True, rebalance_trials=3),
    dict(hub_split=2.0, rebalance_trials=2, compact=False),
], ids=["default", "fused", "all-hubs", "rebalance", "rebalance-nocompact"])
@pytest.mark.parametrize("kind", ["cannon", "summa", "oned"])
@pytest.mark.parametrize("name", ["powerlaw22", "powerlaw18", "star",
                                  "edgeless"])
def test_hub_plan_equals_the_reference(name, kind, flags):
    """Key, report, residual arrays with the hub arrays among them, the
    full relabeled graph on the artifact and the ``aligned`` flag."""
    a, b = _plans(kind, name, **flags)
    assert b.key == a.key
    assert b.config == a.config
    assert b.hubsplit == a.hubsplit and b.rebalance == a.rebalance
    _same_hub(a.plan.hub, b.plan.hub)
    da, db = a.plan.device_arrays(), b.plan.device_arrays()
    assert list(db) == list(da)
    for k in da:
        assert db[k].dtype == da[k].dtype and db[k].tobytes() == da[
            k].tobytes(), k
    assert b.graph.n == a.graph.n
    assert b.graph.edges.tobytes() == a.graph.edges.tobytes()
    assert np.array_equal(b.perm, a.perm)
    if b.plan.hub is not None:
        assert b.graph.m == _graph(name).m  # the full graph, not the residual
        assert b.plan.m < b.graph.m or b.plan.hub.hub_nnz == 0
        assert b.stage_seconds["hubsplit"] >= 0


def test_hub_split_keys_are_canonical():
    """``True`` and ``8`` are the same knob: one cache entry."""
    cache = tp.PlanCache()
    g = _graph("powerlaw22")
    a = tp.plan_cannon(g, 2, hub_split=True, cache=cache)
    b = tp.plan_cannon(g, 2, hub_split=8, cache=cache)
    c = tp.plan_cannon(g, 2, hub_split=2.0, cache=cache)
    d = tp.plan_cannon(g, 2, cache=cache)
    assert b is a and b.cache_hit and a.key[-1] == 8.0
    assert c.key != a.key and d.key != a.key and d.key[-1] is None


def test_residual_dmax_shrinks():
    g = _graph("powerlaw22")
    full = tp.plan_cannon(g, 1, autotune=True, cache=tp.PlanCache()).plan
    split = tp.plan_cannon(g, 1, hub_split=True, autotune=True,
                           cache=tp.PlanCache()).plan
    assert split.hub is not None and split.dmax < full.dmax
    assert split.d_small <= full.d_small
    for plan in (full, split):
        frag = max(int(np.diff(plan.a_indptr, axis=-1).max()),
                   int(np.diff(plan.b_indptr, axis=-1).max()))
        assert plan.dmax == frag


# ----------------------------------------------------------------------
# counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("compact", [None, False])
@pytest.mark.parametrize("schedule,grid", [
    ("cannon", (2, 2)), ("cannon", (3, 3)), ("summa", (2, 3)),
    ("oned", (2, 2)), ("oned", (1, 3)),
], ids=["cannon-2", "cannon-3", "summa-2x3", "oned-4", "oned-3"])
@pytest.mark.parametrize("name", ["powerlaw22", "powerlaw18", "rmat11",
                                  "star", "cliques3", "edgeless"])
def test_hub_split_count_matches_oracle(name, schedule, grid, compact,
                                        method):
    r = rt.count_triangles(_graph(name), grid=grid, schedule=schedule,
                           method=method, hub_split=True, compact=compact,
                           device="cpu", cache=tp.PlanCache())
    assert r.triangles == _oracle(name)
    if r.hub is not None:
        assert r.hub == {**r.artifact.hubsplit,
                         "residual_mcp": r.hub["residual_mcp"]}


@pytest.mark.parametrize("hub_split", [0.0, 2.0])
@pytest.mark.parametrize("method", ["search", "search2", "fused"])
@pytest.mark.parametrize("name", ["powerlaw18", "cliques3", "star"])
def test_hub_split_with_rebalance_and_search2(name, method, hub_split):
    r = rt.count_triangles(_graph(name), q=3, method=method,
                           hub_split=hub_split, rebalance_trials=3,
                           device="cpu", cache=tp.PlanCache())
    assert r.triangles == _oracle(name)
    assert r.rebalance is not None


@pytest.mark.parametrize("schedule", ["cannon", "summa", "oned"])
@pytest.mark.parametrize("kw", [dict(hub_split=True),
                                dict(hub_split=True, rebalance_trials=2),
                                dict(hub_split=0.0)],
                         ids=["hub", "hub+rebalance", "all-hubs"])
@pytest.mark.parametrize("name", ["powerlaw22", "karate"])
def test_hub_count_and_report_match_the_reference_at_q1(name, kw, schedule):
    want = jc.count_triangles(jc.graph_from_spec(FIXTURES[name]), q=1,
                              schedule=schedule, cache=jp.PlanCache(), **kw)
    got = rt.count_triangles(_graph(name), q=1, schedule=schedule,
                             device="cpu", cache=tp.PlanCache(), **kw)
    assert got.triangles == want.triangles == _oracle(name)
    assert got.hub == want.hub and got.rebalance == want.rebalance


def test_hub_partial_runs_inside_a_tc_hub_range():
    from torch.profiler import ProfilerActivity, profile

    g = _graph("powerlaw22")
    rt.count_triangles(g, q=2, method="fused", hub_split=True, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = rt.count_triangles(g, q=2, method="fused", hub_split=True,
                               device="cpu")
    assert r.triangles == _oracle("powerlaw22")
    names = {ev.key for ev in prof.key_averages()}
    assert "tc_hub" in names


def test_per_device_partials_hold_the_hub_share():
    """``reduce_global=False`` gives each device its residual plus its hub
    partial; the hub-free plan's partials miss exactly the hub sum."""
    art = tp.plan_cannon(_graph("powerlaw22"), 2, hub_split=True,
                         cache=tp.PlanCache())
    st = art.staged("cpu")
    per = build_cannon_fn(art, reduce_global=False)(**st)
    bare = build_cannon_fn(dataclasses.replace(art.plan, hub=None),
                           reduce_global=False)(**st)
    h = art.plan.hub
    hub = HubCount(dpad=h.dpad, chunk=h.chunk, sentinel=h.sentinel,
                   hub_cnt=h.hub_cnt).count(st, torch.zeros_like(per))
    assert torch.equal(per, bare + hub)
    assert int(per.sum()) == _oracle("powerlaw22")


# ----------------------------------------------------------------------
# refusals: the reference's
# ----------------------------------------------------------------------
def _message(call, exc=ValueError):
    with pytest.raises(exc) as e:
        call()
    return str(e.value)


def _plan_one(kind, pipe, g, **kw):
    kw["cache"] = pipe.PlanCache()
    if kind == "cannon":
        return pipe.plan_cannon(g, 2, **kw)
    if kind == "summa":
        return pipe.plan_summa(g, 2, 2, **kw)
    return pipe.plan_oned(g, 2, **kw)


@pytest.mark.parametrize("bad", [dict(reorder=False), dict(cyclic_p=2)],
                         ids=["reorder", "cyclic_p"])
@pytest.mark.parametrize("kind", ["cannon", "summa", "oned"])
def test_hub_split_refuses_what_the_reference_refuses(kind, bad):
    msgs = [_message(lambda: _plan_one(kind, pipe, core.rmat(7, 8),
                                       hub_split=True, **bad))
            for core, pipe in ((jc, jp), (tc, tp))]
    assert msgs[1] == msgs[0]


def test_hub_split_refuses_a_caller_plan():
    ja = jp.plan_cannon(jc.rmat(7, 8), 1, cache=jp.PlanCache())
    ta = tp.plan_cannon(tc.rmat(7, 8), 1, cache=tp.PlanCache())
    want = _message(lambda: jc.count_triangles(jc.rmat(7, 8), q=1,
                                               plan=ja.plan, hub_split=True))
    got = _message(lambda: rt.count_triangles(
        tc.rmat(7, 8), q=1, plan=ta.plan, hub_split=True, device="cpu"))
    assert got == want


@pytest.mark.parametrize("method", ["dense", "tile"])
def test_hub_split_refuses_the_tile_and_dense_paths(method):
    spec = FIXTURES["powerlaw22"]
    want = _message(lambda: jc.count_triangles(
        jc.graph_from_spec(spec), q=1, method=method, hub_split=True))
    got = _message(lambda: rt.count_triangles(
        tc.graph_from_spec(spec), q=1, method=method, hub_split=True,
        device="cpu"))
    assert got == want and "hub-split" in got


def test_hub_split_refuses_the_batched_engine():
    from repro.core.api import make_grid_mesh
    from repro.core.cannon import build_cannon_fn as j_build

    spec = FIXTURES["powerlaw22"]
    ja = jp.plan_cannon(jc.graph_from_spec(spec), 1, hub_split=True,
                        cache=jp.PlanCache())
    ta = tp.plan_cannon(tc.graph_from_spec(spec), 1, hub_split=True,
                        cache=tp.PlanCache())
    want = _message(lambda: j_build(ja.plan, make_grid_mesh(1),
                                    batched=True), AssertionError)
    got = _message(lambda: build_cannon_fn(ta.plan, batched=True))
    assert got == want
    assert HubCount.from_plan(ta.plan) is not None
    assert HubCount.from_plan(dataclasses.replace(ta.plan, hub=None)) is None


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def _cli(*args):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tc_run", *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_hub_split_and_rebalance_verify():
    proc = _cli("--graph", "powerlaw:600,2.2", "--grid", "2", "--schedule",
                "oned", "--method", "fused", "--hub-split", "--rebalance",
                "3", "--device", "cpu", "--verify", "--json")
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["correct"] and rep["triangles"] == _oracle("powerlaw22")
    assert rep["hub_rows"] > 0 and 0 < rep["hub_nnz_frac"] <= 1
    assert rep["rebalance_trials"] == 3 and rep["grid"] == [4]


def test_cli_hub_split_refuses_the_tile_path():
    proc = _cli("--graph", "powerlaw:600,2.2", "--hub-split", "2.5",
                "--method", "tile", "--device", "cpu")
    assert proc.returncode != 0
    assert "--hub-split is not supported with --method tile" in proc.stderr


# ----------------------------------------------------------------------
# the reference on 4 devices
# ----------------------------------------------------------------------
REF4 = ("powerlaw22", "rmat11")
BATCH4 = ("karate", "rmat9", "cliques3", "powerlaw18")
BATCH4_RUNS = [("cannon", "search"), ("cannon", "global"),
               ("cannon", "search2"), ("summa", "search"),
               ("summa", "global"), ("oned", "search")]


def _digest(arrays):
    return {k: hashlib.sha256(
        f"{v.dtype}{v.shape}".encode() + np.ascontiguousarray(v).tobytes()
    ).hexdigest() for k, v in arrays.items()}


@pytest.fixture(scope="module")
def reference_4(distributed_runner):
    """The JAX package on 4 host devices: hub-split (and hub-split +
    rebalanced) totals and reports on Cannon 2 x 2, SUMMA 2 x 2 and the
    ring p = 4 with ``search`` and ``fused``, per-device partials of the
    hub-split ``search`` count, and ``count_triangles_many`` (counts,
    padding overhead, digests of the stacked arrays)."""
    code = f"""
import functools, hashlib, json
import jax.numpy as jnp
import numpy as np
from repro import compat
from repro.core import count_triangles, count_triangles_many, graph_from_spec
import repro.core.engine as E
import repro.pipeline as jp
from repro.pipeline import batch as jb
from repro.core.cannon import build_cannon_fn
from repro.core.onedim import build_oned_fn
from repro.core.summa import build_summa_fn
fixtures = {FIXTURES!r}
mesh = compat.make_mesh((2, 2), ("data", "model"))
flat = compat.make_mesh((4,), ("flat",))
def digest(arrays):
    return {{k: hashlib.sha256(
        f"{{v.dtype}}{{v.shape}}".encode() + np.ascontiguousarray(v).tobytes()
    ).hexdigest() for k, v in arrays.items()}}
out = {{}}
for name in {REF4!r}:
    g = graph_from_spec(fixtures[name])
    for kind in ("cannon", "summa", "oned"):
        for method in ("search", "fused"):
            r = count_triangles(g, mesh, schedule=kind, method=method,
                                hub_split=True)
            out[f"{{name}}/{{kind}}/{{method}}"] = [r.triangles, r.hub]
        r = count_triangles(g, mesh, schedule=kind, method="fused",
                            hub_split=True, rebalance_trials=3)
        out[f"{{name}}/{{kind}}/rebalance"] = [r.triangles, r.hub,
                                               r.rebalance]
    art = jp.plan_cannon(g, 2, hub_split=True, cache=jp.PlanCache())
    st = {{k: jnp.asarray(v) for k, v in art.plan.device_arrays().items()}}
    fn = build_cannon_fn(art.plan, mesh, reduce_global=False)
    out[f"{{name}}/cannon/per"] = np.asarray(fn(**st)).tolist()
    art = jp.plan_summa(g, 2, 2, hub_split=True, cache=jp.PlanCache())
    st = {{k: jnp.asarray(v) for k, v in art.plan.device_arrays().items()}}
    fn = build_summa_fn(art.plan, mesh, reduce_global=False)
    out[f"{{name}}/summa/per"] = np.asarray(fn(**st)).tolist()
    keep = E.Reduction
    E.Reduction = functools.partial(keep, global_sum=False)
    try:
        art = jp.plan_oned(g, 4, hub_split=True, cache=jp.PlanCache())
        fn = build_oned_fn(art.plan, flat)
    finally:
        E.Reduction = keep
    st = {{k: jnp.asarray(v) for k, v in art.plan.device_arrays().items()}}
    out[f"{{name}}/oned/per"] = np.asarray(fn(**st)).tolist()
graphs = [graph_from_spec(fixtures[n]) for n in {BATCH4!r}]
for kind, method in {BATCH4_RUNS!r}:
    r = count_triangles_many(graphs, mesh, schedule=kind, method=method,
                             cache=jp.PlanCache())
    prog = jb._build_batch_program(
        graphs, mesh, q=2, schedule=kind, method=method, chunk=512,
        reorder=True, cyclic_p=None, probe_shorter=True,
        count_dtype=compat.default_count_dtype(), cache=jp.PlanCache())
    staged = {{k: np.asarray(v) for k, v in prog.staged.items()}}
    out[f"many/{{kind}}/{{method}}"] = [r.triangles, r.padding_overhead,
                                        list(r.grid), digest(staged)]
print("RESULT" + json.dumps(out))
"""
    out = distributed_runner(code, ndev=4)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("method", ["search", "fused", "rebalance"])
@pytest.mark.parametrize("kind", ["cannon", "summa", "oned"])
@pytest.mark.parametrize("name", REF4)
def test_hub_counts_match_the_reference_on_4_devices(reference_4, name,
                                                     kind, method):
    kw = dict(hub_split=True)
    if method == "rebalance":
        kw["rebalance_trials"] = 3
    r = rt.count_triangles(_graph(name), q=2, schedule=kind,
                           method="fused" if method == "rebalance" else method,
                           device="cpu", cache=tp.PlanCache(), **kw)
    want = reference_4[f"{name}/{kind}/{method}"]
    assert r.triangles == want[0] == _oracle(name)
    assert r.hub == want[1]
    if method == "rebalance":
        assert json.loads(json.dumps(r.rebalance)) == want[2]


@pytest.mark.parametrize("kind", ["cannon", "summa", "oned"])
@pytest.mark.parametrize("name", REF4)
def test_hub_per_device_partials_match_the_reference(reference_4, name,
                                                     kind):
    cache = tp.PlanCache()
    g = _graph(name)
    if kind == "cannon":
        art = tp.plan_cannon(g, 2, hub_split=True, cache=cache)
        fn = build_cannon_fn(art, reduce_global=False)
    elif kind == "summa":
        art = tp.plan_summa(g, 2, 2, hub_split=True, cache=cache)
        fn = build_summa_fn(art, reduce_global=False)
    else:
        art = tp.plan_oned(g, 4, hub_split=True, cache=cache)
        fn = build_oned_fn(art, reduce_global=False)
    per = fn(**art.staged("cpu"))
    want = np.asarray(reference_4[f"{name}/{kind}/per"])
    assert per.dtype == torch.int64
    assert np.array_equal(per.numpy().reshape(want.shape), want)


@pytest.mark.parametrize("kind,method", BATCH4_RUNS)
def test_batch_matches_the_reference_on_4_devices(reference_4, kind, method):
    from repro_torch.pipeline import batch as tb

    graphs = [_graph(n) for n in BATCH4]
    want = reference_4[f"many/{kind}/{method}"]
    r = rt.count_triangles_many(graphs, q=2, schedule=kind, method=method,
                                device="cpu", cache=tp.PlanCache())
    assert r.triangles == want[0] == [_oracle(n) for n in BATCH4]
    assert r.padding_overhead == want[1]
    assert list(r.grid) == want[2]
    prog = tb._build_batch_program(
        graphs, grid=(2, 2), schedule=kind, method=method, chunk=512,
        reorder=True, cyclic_p=None, probe_shorter=True,
        device=torch.device("cpu"), cache=tp.PlanCache())
    assert _digest({k: v.numpy() for k, v in prog.staged.items()}) == want[3]
