"""The port's SUMMA and 1D-ring schedules against the JAX package.

Planning is host numpy in both packages, so the SUMMA and ring plans must
be byte-identical (arrays, derived shapes, stats, compaction, autotune
report, cache key).  Counting runs the engine on the CPU: every fixture,
grid and method must give the oracle's integer, the reference's in-process
at q = 1, and — through one 8-device subprocess of the reference (SUMMA on
a (2, 4) mesh, the ring at p = 8) — the same total and the same
per-device partials.  Counts are integers: parity is ``==``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.pipeline as jp
import repro_torch as rt
import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro_torch.core.engine import RingSchedule, shift_perm
from repro_torch.core.onedim import OneDPlan, build_oned_fn
from repro_torch.core.summa import SummaPlan, build_summa_fn
from repro_torch.pipeline.stages import pack_oned_plan, pack_summa_plan


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
METHODS = ("search", "global", "fused", "auto")
SUMMA_GRIDS = [(1, 1), (1, 2), (2, 3), (3, 2), (2, 4)]
RING_PS = [1, 2, 3, 4]
PLAN_SPECS = ["rmat:8,8,5", "cliques:3,60", "star:64"]

_ORACLE = {}


def _graph(name):
    return tc.graph_from_spec(FIXTURES[name])


def _oracle(name):
    if name not in _ORACLE:
        _ORACLE[name] = tc.triangle_count_oracle(_graph(name))
    return _ORACLE[name]


def _assert_same_plan(pa, pb):
    """Every field of the port's plan equal to the reference's: arrays by
    dtype, shape and bytes; stats field by field; the compacted schedule
    by its steps."""
    da, db = pa.device_arrays(), pb.device_arrays()
    assert list(da) == list(db)
    for f in dataclasses.fields(pb):
        va, vb = getattr(pa, f.name), getattr(pb, f.name)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            assert va.shape == vb.shape, f.name
            assert va.tobytes() == vb.tobytes(), f.name
        elif f.name == "stats" and vb is not None:
            assert np.array_equal(va.probe_work_per_device_shift,
                                  vb.probe_work_per_device_shift)
            assert va.probe_imbalance == vb.probe_imbalance
        elif f.name == "compact" and vb is not None:
            assert (va.n_total, va.live_steps, va.hops) == (
                vb.n_total, vb.live_steps, vb.hops)
        else:
            assert (va is None) == (vb is None), f.name
            if vb is not None:
                assert va == vb, f.name


# ----------------------------------------------------------------------
# plans
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("step_masks", [False, True])
@pytest.mark.parametrize("grid", SUMMA_GRIDS, ids=str)
def test_pack_summa_plan_byte_identical(grid, step_masks, with_stats):
    from repro.pipeline.stages import pack_summa_plan as j_pack

    for spec in PLAN_SPECS:
        ga = jc.preprocess(jc.graph_from_spec(spec))[0]
        gb = tc.preprocess(tc.graph_from_spec(spec))[0]
        kw = dict(chunk=64, step_masks=step_masks, with_stats=with_stats)
        pb = pack_summa_plan(gb, *grid, **kw)
        assert isinstance(pb, SummaPlan)
        _assert_same_plan(pb, j_pack(ga, *grid, **kw))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("autotune", [False, True, "fused"])
@pytest.mark.parametrize("grid", SUMMA_GRIDS, ids=str)
def test_plan_summa_byte_identical(grid, autotune, compact):
    for spec in PLAN_SPECS:
        kw = dict(autotune=autotune, compact=compact, broadcast="onehot")
        a = jp.plan_summa(jc.graph_from_spec(spec), *grid,
                          cache=jp.PlanCache(), **kw)
        b = tp.plan_summa(tc.graph_from_spec(spec), *grid,
                          cache=tp.PlanCache(), **kw)
        _assert_same_plan(b.plan, a.plan)
        assert a.key == b.key and b.kind == "summa"
        assert np.array_equal(a.perm, b.perm)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("step_masks", [False, True])
@pytest.mark.parametrize("p", RING_PS)
def test_pack_oned_plan_byte_identical(p, step_masks, with_stats):
    from repro.pipeline.stages import pack_oned_plan as j_pack

    for spec in PLAN_SPECS:
        ga = jc.preprocess(jc.graph_from_spec(spec))[0]
        gb = tc.preprocess(tc.graph_from_spec(spec))[0]
        kw = dict(chunk=64, step_masks=step_masks, with_stats=with_stats)
        pb = pack_oned_plan(gb, p, **kw)
        assert isinstance(pb, OneDPlan)
        _assert_same_plan(pb, j_pack(ga, p, **kw))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("autotune", [False, True, "fused"])
@pytest.mark.parametrize("p", RING_PS)
def test_plan_oned_byte_identical(p, autotune, compact):
    for spec in PLAN_SPECS:
        kw = dict(autotune=autotune, compact=compact)
        a = jp.plan_oned(jc.graph_from_spec(spec), p, cache=jp.PlanCache(),
                         **kw)
        b = tp.plan_oned(tc.graph_from_spec(spec), p, cache=tp.PlanCache(),
                         **kw)
        _assert_same_plan(b.plan, a.plan)
        assert a.key == b.key and b.kind == "oned"


# where compaction drops SUMMA rounds / ring steps: star:64 keeps only
# round 3 of a (2, 4) grid (every U column is the hub, 63 % 4 = 3);
# cliques:3,60 keeps ring steps 0, 3 and 6 of 9
ELIDING = {"summa": ("star", (2, 4), (3,)),
           "oned": ("cliques3", 9, (0, 3, 6))}


def _plan_eliding(kind, pkg, **kw):
    name, shape, _ = ELIDING[kind]
    g = pkg[0].graph_from_spec(FIXTURES[name])
    if kind == "summa":
        return pkg[1].plan_summa(g, *shape, cache=pkg[1].PlanCache(), **kw)
    return pkg[1].plan_oned(g, shape, cache=pkg[1].PlanCache(), **kw)


@pytest.mark.parametrize("kind", ["summa", "oned"])
def test_compaction_elides_rounds(kind):
    """The port stages the reference's live list where rounds / ring
    steps are elided, and the live list does not start at 0 or is not
    contiguous — so a renumbering run would read the wrong operands."""
    b = _plan_eliding(kind, (tc, tp))
    a = _plan_eliding(kind, (jc, jp))
    assert b.plan.compact.n_elided > 0
    assert b.plan.compact.live_steps == a.plan.compact.live_steps
    assert b.plan.compact.live_steps == ELIDING[kind][2]


# ----------------------------------------------------------------------
# counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("schedule,grid,want_grid", [
    ("summa", (2, 2), (2, 2)), ("summa", (2, 3), (2, 3)),
    ("oned", (2, 2), (4,)), ("oned", (1, 3), (3,)),
], ids=["summa-2x2", "summa-2x3", "oned-4", "oned-3"])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_count_matches_oracle(name, schedule, grid, want_grid, method):
    r = rt.count_triangles(_graph(name), grid=grid, schedule=schedule,
                           method=method, device="cpu")
    assert isinstance(r.triangles, int)
    assert r.triangles == _oracle(name)
    assert r.grid == want_grid and r.schedule == schedule
    if method == "auto":
        assert r.method in ("search", "search2") and r.autotune_mode
        if schedule == "oned":
            assert r.method == "search"
    else:
        assert r.method == method


@pytest.mark.parametrize("method", ["search", "fused"])
@pytest.mark.parametrize("compact", [None, False, True])
@pytest.mark.parametrize("use_step_mask", [None, False])
@pytest.mark.parametrize("schedule", ["summa", "oned"])
@pytest.mark.parametrize("name", ["rmat8", "cliques3", "star"])
def test_mask_and_compaction_do_not_change_the_count(
    name, schedule, use_step_mask, compact, method
):
    r = rt.count_triangles(
        _graph(name), q=3, schedule=schedule, method=method,
        use_step_mask=use_step_mask, compact=compact, device="cpu",
        cache=tp.PlanCache(),
    )
    assert r.triangles == _oracle(name)


@pytest.mark.parametrize("kind", ["summa", "oned"])
def test_compacted_runs_keep_original_indices(kind):
    """Runs that renumbered the live rounds / steps would read the wrong
    panels, mask column or task group; a superset of the live set still
    counts right (dead steps count zero)."""
    name = ELIDING[kind][0]
    art = _plan_eliding(kind, (tc, tp))
    fused = _plan_eliding(kind, (tc, tp), autotune="fused")
    build = build_summa_fn if kind == "summa" else build_oned_fn
    for method, a in (("search", art), ("global", art), ("fused", fused)):
        fn = build(a, method=method, compact=True)
        assert int(fn(**a.staged("cpu"))) == _oracle(name), method
    plan = art.plan
    live = plan.compact.live_steps
    for extra in range(plan.compact.n_total):
        wider = tuple(sorted(set(live) | {extra}))
        p2 = dataclasses.replace(plan, compact=dataclasses.replace(
            plan.compact, live_steps=wider))
        fn = build(p2, method="search", compact=True)
        assert int(fn(**art.staged("cpu"))) == _oracle(name), wider


def test_ring_roll_sign_matches_shift_perm():
    """A rotation by k moves the block at ring position s to (s - k) % p,
    so at step t device d holds owner (d + t) % p's block."""
    p = 5
    blocks = torch.arange(p * 3).reshape(p, 3)
    sched = RingSchedule(p=p)
    for k in (1, 2, 4):
        (rolled,) = sched._shift_k((blocks,), k)
        for s, dst in shift_perm(p, k):
            assert torch.equal(rolled[dst], blocks[s])
        for d in range(p):
            assert torch.equal(rolled[d], blocks[(d + k) % p])
    assert sched._shift_k((blocks,), p)[0] is blocks  # full turn: no-op


@pytest.mark.parametrize("broadcast", ["onehot", "chain", "auto", None])
def test_every_broadcast_gives_the_same_count(broadcast):
    r = rt.count_triangles(_graph("rmat9"), grid=(2, 3), schedule="summa",
                           broadcast=broadcast, device="cpu",
                           cache=tp.PlanCache())
    assert r.triangles == _oracle("rmat9")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("schedule", ["summa", "oned"])
@pytest.mark.parametrize("name", ["karate", "rmat9", "cliques3", "edgeless"])
def test_matches_reference_in_process_q1(name, schedule, method):
    want = jc.count_triangles(jc.graph_from_spec(FIXTURES[name]), q=1,
                              schedule=schedule, method=method)
    got = rt.count_triangles(_graph(name), q=1, schedule=schedule,
                             method=method, device="cpu")
    assert got.triangles == want.triangles == _oracle(name)
    assert got.method == want.method


REF_NAMES = ("rmat9", "cliques3", "karate")


@pytest.fixture(scope="module")
def reference_8(distributed_runner):
    """The JAX package on 8 host devices: SUMMA on a (2, 4) mesh and the
    ring at p = 8, ``search`` and ``fused``, totals and per-device
    partials, on three fixtures; and its ring ``global`` count of rmat9,
    which miscounts (ROADMAP.md, Queue C)."""
    code = f"""
import functools, json
import jax.numpy as jnp
import numpy as np
from repro import compat
from repro.core import count_triangles, graph_from_spec
import repro.core.engine as E
import repro.pipeline as jp
from repro.core.onedim import build_oned_fn
from repro.core.summa import build_summa_fn
fixtures = {FIXTURES!r}
mesh = compat.make_mesh((2, 4), ("data", "model"))
flat = compat.make_mesh((8,), ("flat",))
out = {{}}
for name in {REF_NAMES!r}:
    g = graph_from_spec(fixtures[name])
    for method in ("search", "fused"):
        at = "fused" if method == "fused" else False
        for kind in ("summa", "oned"):
            out[f"{{name}}/{{kind}}/{{method}}"] = count_triangles(
                g, mesh, schedule=kind, method=method).triangles
        art = jp.plan_summa(g, 2, 4, autotune=at, cache=jp.PlanCache())
        fn = build_summa_fn(art.plan, mesh, method=method,
                            reduce_global=False)
        st = {{k: jnp.asarray(v) for k, v in art.plan.device_arrays().items()}}
        out[f"{{name}}/summa/{{method}}/per"] = np.asarray(fn(**st)).tolist()
        # build_oned_fn takes no reduce_global: build it with the
        # per-device reduction instead
        keep = E.Reduction
        E.Reduction = functools.partial(keep, global_sum=False)
        try:
            art = jp.plan_oned(g, 8, autotune=at, cache=jp.PlanCache())
            fn = build_oned_fn(art.plan, flat, method=method)
        finally:
            E.Reduction = keep
        st = {{k: jnp.asarray(v) for k, v in art.plan.device_arrays().items()}}
        out[f"{{name}}/oned/{{method}}/per"] = np.asarray(fn(**st)).tolist()
g = graph_from_spec(fixtures["rmat9"])
out["rmat9/oned/global"] = count_triangles(
    g, mesh, schedule="oned", method="global").triangles
print("RESULT" + json.dumps(out))
"""
    out = distributed_runner(code, ndev=8)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("method", ["search", "fused"])
@pytest.mark.parametrize("schedule", ["summa", "oned"])
@pytest.mark.parametrize("name", REF_NAMES)
def test_matches_reference_on_8_devices(reference_8, name, schedule, method):
    g = _graph(name)
    got = rt.count_triangles(g, grid=(2, 4), schedule=schedule,
                             method=method, device="cpu",
                             cache=tp.PlanCache())
    want = reference_8[f"{name}/{schedule}/{method}"]
    assert got.triangles == want == _oracle(name)
    at = "fused" if method == "fused" else False
    if schedule == "summa":
        art = tp.plan_summa(g, 2, 4, autotune=at, cache=tp.PlanCache())
        fn = build_summa_fn(art, method=method, reduce_global=False)
    else:
        art = tp.plan_oned(g, 8, autotune=at, cache=tp.PlanCache())
        fn = build_oned_fn(art, method=method, reduce_global=False)
    per = fn(**art.staged("cpu"))
    want_per = np.asarray(reference_8[f"{name}/{schedule}/{method}/per"])
    assert per.dtype == torch.int64
    assert np.array_equal(per.numpy().reshape(want_per.shape), want_per)
    assert tuple(per.shape) == ((2, 4) if schedule == "summa" else (8,))


def test_ring_global_counts_right_where_the_reference_does_not(reference_8):
    """The ring's columns are global ids: keys on the block-local base
    ``nb + 1`` overlap between rows.  The reference counts rmat9 wrong at
    p = 8; the port builds its keys on ``n + 2`` and counts right."""
    got = rt.count_triangles(_graph("rmat9"), grid=(2, 4), schedule="oned",
                             method="global", device="cpu")
    assert got.triangles == _oracle("rmat9")
    assert reference_8["rmat9/oned/global"] != _oracle("rmat9")


def _meta(plan, names):
    meta = {k: getattr(plan, k) for k in names}
    meta.update(n_long=plan.n_long, d_small=plan.d_small,
                autotune=plan.autotune,
                live_steps=None if plan.compact is None
                else plan.compact.live_steps)
    return meta


@pytest.mark.parametrize("method", ["search", "global", "fused"])
@pytest.mark.parametrize("schedule", ["summa", "oned"])
@pytest.mark.parametrize("name", ["rmat9", "cliques3", "karate"])
def test_engine_runs_from_a_reference_plan(name, schedule, method):
    g = jc.graph_from_spec(FIXTURES[name])
    at = "fused" if method == "fused" else False
    if schedule == "summa":
        art = jp.plan_summa(g, 2, 3, autotune=at, broadcast="chain",
                            cache=jp.PlanCache())
        meta = _meta(art.plan, ("n", "m", "r", "c", "nb_r", "nb_c", "npan",
                                "a_nnz_pad", "b_nnz_pad", "tmax", "dmax",
                                "chunk"))
        meta["broadcast"] = art.plan.broadcast
    else:
        art = jp.plan_oned(g, 5, autotune=at, cache=jp.PlanCache())
        meta = _meta(art.plan, ("n", "m", "p", "nb", "nnz_pad", "gmax",
                                "dmax", "chunk"))
    arrays = {k: np.asarray(v) for k, v in art.plan.device_arrays().items()}
    plan = tc.plan_from_numpy(arrays, meta)
    _assert_same_plan(plan, art.plan)
    r = rt.count_triangles(_graph(name), plan=plan, schedule=schedule,
                           method=method, device="cpu")
    assert r.triangles == _oracle(name) and r.artifact is None
    assert r.grid == ((2, 3) if schedule == "summa" else (5,))


# ----------------------------------------------------------------------
# errors: the reference's
# ----------------------------------------------------------------------
def _errors(count, graph, **kw):
    with pytest.raises(ValueError) as e:
        count(graph, **kw)
    return str(e.value)


@pytest.mark.parametrize("case", [
    dict(schedule="summa", broadcast="ring"),
    dict(schedule="summa", method="search2"),
    dict(schedule="oned", method="search2"),
    dict(schedule="hypercube"),
], ids=["broadcast", "summa-search2", "oned-search2", "schedule"])
def test_errors_match_the_reference(case):
    want = _errors(jc.count_triangles, jc.graph_from_spec("named:karate"),
                   q=1, **case)
    got = _errors(rt.count_triangles, _graph("karate"), q=1, device="cpu",
                  **case)
    if case.get("schedule") == "hypercube":
        assert got.startswith("unknown schedule 'hypercube'")
        assert want.startswith("unknown schedule 'hypercube'")
        assert got.endswith("['cannon', 'oned', 'summa']")
    else:
        assert got == want


def test_grid_and_plan_kind_are_checked():
    g = _graph("karate")
    with pytest.raises(ValueError, match="square"):
        rt.count_triangles(g, grid=(2, 3), device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        rt.count_triangles(g, q=2, grid=(2, 3), schedule="summa",
                           device="cpu")
    with pytest.raises(ValueError, match=r"\(r, c\)"):
        rt.count_triangles(g, grid=(0, 3), schedule="summa", device="cpu")
    oned = tp.plan_oned(tc.preprocess(g)[0], 2, reorder=False,
                        cache=tp.PlanCache()).plan
    with pytest.raises(ValueError, match="SummaPlan"):
        rt.count_triangles(g, plan=oned, schedule="summa", device="cpu")
    with pytest.raises(ValueError, match="tree"):
        build_oned_fn(oned, reduce_strategy="tree")


@pytest.mark.parametrize("kind", ["summa", "oned"])
@pytest.mark.parametrize("kw", [dict(rebalance_trials=2),
                                dict(hub_split=True)],
                         ids=["rebalance", "hub_split"])
def test_later_stages_raise_not_implemented(kind, kw):
    """The rebalance and hub-split stages, once refused with
    ``NotImplementedError`` on SUMMA and the ring, now plan: no stage
    raises, and the artifact has the reference's key and reports."""
    if kind == "summa":
        a = jp.plan_summa(jc.rmat(7, 8), 2, 2, cache=jp.PlanCache(), **kw)
        b = tp.plan_summa(tc.rmat(7, 8), 2, 2, cache=tp.PlanCache(), **kw)
    else:
        a = jp.plan_oned(jc.rmat(7, 8), 4, cache=jp.PlanCache(), **kw)
        b = tp.plan_oned(tc.rmat(7, 8), 4, cache=tp.PlanCache(), **kw)
    assert b.key == a.key
    assert b.rebalance == a.rebalance and b.hubsplit == a.hubsplit


def test_warm_count_hits_the_cache_and_reuses_staged_tensors():
    cache = tp.PlanCache()
    g = _graph("rmat9")
    for schedule in ("summa", "oned"):
        first = rt.count_triangles(g, grid=(2, 3), schedule=schedule,
                                   method="fused", device="cpu", cache=cache)
        hits = cache.hits
        second = rt.count_triangles(g, grid=(2, 3), schedule=schedule,
                                    method="fused", device="cpu",
                                    cache=cache)
        assert second.triangles == first.triangles == _oracle("rmat9")
        assert second.artifact is first.artifact
        assert second.artifact.cache_hit and cache.hits > hits
        assert first.artifact.staged("cpu") is first.artifact.staged("cpu")
        assert first.autotune_mode == "percentile"


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def _cli(*args):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tc_run", *args],
        capture_output=True, text=True, env=env, timeout=300)


@pytest.mark.parametrize("schedule,method,broadcast,grid", [
    ("summa", "auto", "chain", [2, 2]),
    ("summa", "fused", "onehot", [2, 2]),
    ("oned", "fused", None, [4]),
    ("cannon", "search2", None, [2, 2]),
])
def test_cli_schedules_and_methods_verify(schedule, method, broadcast, grid):
    args = ["--graph", "rmat:9,8,42", "--grid", "2", "--schedule", schedule,
            "--method", method, "--device", "cpu", "--verify", "--json"]
    if broadcast:
        args += ["--broadcast", broadcast]
    proc = _cli(*args)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["correct"] and rep["triangles"] == _oracle("rmat9")
    assert rep["schedule"] == schedule and rep["grid"] == grid
    assert rep["method"] == (method if method != "auto" else rep["method"])
    assert rep["schedules"] == ["cannon", "oned", "summa"]


def test_cli_refuses_an_unknown_schedule():
    proc = _cli("--graph", "named:karate", "--schedule", "hypercube",
                "--device", "cpu")
    assert proc.returncode != 0
    assert "registered: ['cannon', 'oned', 'summa']" in proc.stderr
