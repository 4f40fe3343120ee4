"""The port's runtime against the JAX package's: deterministic fault
injection, the restart supervisor with its demotion ladder and elastic
regrid, ``run_with_restarts``, ``best_grid``, ``replan_elastic``,
``rebalance_plan`` and ``tc_run --inject-faults / --supervise``.

Both packages get the same spec, seed and a fake clock, and must give
equal sites, logs, supervision records (dict for dict) and counts (``==``).
Single-device supervision runs in this process (the reference on its one
host device, the port at q = 1); the regrid on 9 and the CLI on 4 host
devices run the reference in a subprocess each.  On one device the port
counts survivors on the logical grid supervision started with, the
reference on ``len(jax.devices())``: the two agree where the mesh spans
every device, and differ where it does not (pinned below, ROADMAP.md
Queue C).
"""
import json
import os
import random
import warnings

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.runtime as jr
import repro_torch.core as tc
import repro_torch.pipeline as tp
import repro_torch.runtime as tr
from repro.runtime import faultinject as jfi
from repro.runtime import supervisor as jsup
from repro_torch.launch import tc_run
from repro_torch.runtime import faultinject as tfi
from repro_torch.runtime import supervisor as tsup

SCHEDULES = ("cannon", "summa", "oned")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, d):
        self.t += d


def _fake_supervisor(pkg, **kw):
    clk = _FakeClock()
    kw.setdefault(
        "backoff", pkg.BackoffPolicy(base=1.0, factor=2.0, max_delay=8.0,
                                     jitter=0.0)
    )
    return pkg.Supervisor(clock=clk, sleep=clk.sleep, **kw), clk


# ----------------------------------------------------------------------
# fault plan: grammar, fire semantics, seeded sites
# ----------------------------------------------------------------------
SPECS = (
    "step@2;step@1=devicelost:5;fused=stepfault*-1;ckpt_save;"
    "plan_stage=stage_fault*3",
    "step@0",
    "device_stage=stagefault*2;ckpt_save=ckptcorrupt",
    "delta_splice;plan_stage",
)


def _sites(plan):
    return [(s.point, s.fault.__name__, s.step, s.times, s.lost)
            for s in plan.sites]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_grammar_matches_the_reference(spec):
    mine, ref = tfi.FaultPlan.parse(spec), jfi.FaultPlan.parse(spec)
    assert _sites(mine) == _sites(ref)
    assert mine.describe() == ref.describe()
    # describe() round-trips through parse()
    assert tfi.FaultPlan.parse(mine.describe()).describe() == mine.describe()


def test_fault_spec_grammar_refusals():
    with pytest.raises(ValueError, match="unknown injection point"):
        tfi.FaultPlan.parse("warp_core@3")
    with pytest.raises(ValueError, match="unknown fault type"):
        tfi.FaultPlan.parse("step=gremlin")
    with pytest.raises(ValueError, match="empty fault spec"):
        tfi.FaultPlan.parse(" ; ")
    plan = tfi.FaultPlan.parse(SPECS[0])
    assert (plan.sites[1].fault, plan.sites[1].lost) == (tfi.DeviceLost, 5)
    assert plan.sites[3].fault is tfi.CkptCorrupt  # the point's default
    assert tfi.POINTS == jfi.POINTS


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("points", [("step",), tuple(jfi.POINTS)])
def test_fault_plan_random_matches_the_reference(seed, points):
    mine = tfi.FaultPlan.random(n_steps=5, k=4, seed=seed, points=points)
    ref = jfi.FaultPlan.random(n_steps=5, k=4, seed=seed, points=points)
    assert _sites(mine) == _sites(ref) and mine.seed == ref.seed


def _fire_all(fi, plan, calls):
    """Fire ``calls`` (point, step) under ``plan``; which raised what."""
    out = []
    with fi.armed(plan):
        for point, step in calls:
            try:
                fi.fire(point, step=step)
                out.append(None)
            except fi.InjectedFault as e:
                out.append((type(e).__name__, getattr(e, "lost", None)))
    return out


def test_fault_fire_semantics_and_logs_match_the_reference():
    calls = [("step", 0), ("step", 1), ("step", 1), ("device_stage", None),
             ("device_stage", None), ("device_stage", None), ("fused", None),
             ("fused", None), ("step", 2), ("plan_stage", None)]
    spec = "step@1;device_stage=stagefault*2;fused*-1;step@2=devicelost:3"
    mine, ref = tfi.FaultPlan.parse(spec), jfi.FaultPlan.parse(spec)
    assert _fire_all(tfi, mine, calls) == _fire_all(jfi, ref, calls)
    assert mine.log == ref.log and len(mine.log) == 6
    assert mine.spent() == ref.spent() is False  # fused fires forever
    assert not tfi.is_armed() and tfi.active_plan() is None
    tfi.fire("step", step=1)  # unarmed: a no-op at a matching point
    assert tfi.armed(None).__enter__() is None


def test_ckpt_corrupt_flips_a_byte_after_the_write(tmp_path):
    path = tmp_path / "payload.bin"
    path.write_bytes(bytes(range(10)))
    plan = tfi.FaultPlan.parse("ckpt_save")
    with plan.armed():
        tfi.fire("ckpt_save", step=3)  # the pre-write call: no raise
        tfi.fire("ckpt_save", step=3, path=str(path))
    assert path.read_bytes()[5] == 5 ^ 0xFF and plan.spent()
    assert plan.log == [dict(point="ckpt_save", step=3, fault="CkptCorrupt")]


# ----------------------------------------------------------------------
# the supervisor with a fake clock
# ----------------------------------------------------------------------
def _scripted(pkg_fi, faults):
    """An attempt function raising the fault named ``faults[i]`` on
    attempt i (the last name for every later attempt): ``None`` succeeds,
    ``"slow"`` outlasts the deadline on ``attempt.clock``."""

    def attempt(i, guard):
        name = faults[min(i, len(faults) - 1)]
        if name == "slow":
            attempt.clock.t += 10.0
            guard()
            return "late"
        if name is None:
            return 42
        if name == "DeviceLost":
            raise pkg_fi.DeviceLost("gone", lost=2)
        raise getattr(pkg_fi, name)(f"boom {i}")

    return attempt


SCRIPTS = (
    ["StepFault", "StepFault", "StageFault", None],
    ["DeviceLost", "CkptCorrupt", None],
    ["StepFault"] * 9,
    ["slow", None],
    [None],
)


@pytest.mark.parametrize("faults", SCRIPTS)
@pytest.mark.parametrize("jitter,seed", [(0.0, 0), (0.5, 3)])
def test_supervisor_reports_match_the_reference(faults, jitter, seed):
    reports = []
    for pkg, fi in ((tr, tfi), (jr, jfi)):
        sup, clk = _fake_supervisor(
            pkg, max_restarts=4, seed=seed, attempt_deadline=5.0,
            backoff=pkg.BackoffPolicy(base=1.0, factor=2.0, max_delay=8.0,
                                      jitter=jitter))
        attempt = _scripted(fi, faults)
        attempt.clock = clk
        try:
            out = sup.run(attempt, on_fault=lambda e, rec: type(e).__name__)
        except (fi.InjectedFault, RuntimeError) as e:
            out = type(e).__name__
        reports.append((out, sup.report.to_dict(), clk.t))
    assert reports[0] == reports[1]


def test_supervisor_backoff_budget_and_non_retryable():
    sup, clk = _fake_supervisor(tr, max_restarts=5)
    attempt = _scripted(tfi, ["StepFault"] * 3 + [None])
    attempt.clock = clk
    assert sup.run(attempt) == 42
    assert [a.backoff for a in sup.report.attempts[:3]] == [1.0, 2.0, 4.0]
    assert sup.report.restarts == 3 and clk.t == pytest.approx(7.0)

    sup, _ = _fake_supervisor(tr, max_restarts=2)
    with pytest.raises(tfi.StepFault):
        sup.run(_scripted(tfi, ["StepFault"]))
    assert sup.report.gave_up and len(sup.report.attempts) == 3

    sup, _ = _fake_supervisor(tr, max_restarts=5)

    def not_a_fault(i, guard):
        raise KeyError("not a fault")

    with pytest.raises(KeyError):
        sup.run(not_a_fault)
    assert sup.report.restarts == 0


def test_backoff_jitter_matches_the_reference():
    for seed in (0, 7, 99):
        mine = tr.BackoffPolicy(base=1.0, max_delay=64.0, jitter=0.5)
        ref = jr.BackoffPolicy(base=1.0, max_delay=64.0, jitter=0.5)
        r1, r2 = random.Random(seed), random.Random(seed)
        assert [mine.delay(i, r1) for i in range(1, 8)] == [
            ref.delay(i, r2) for i in range(1, 8)]


# ----------------------------------------------------------------------
# the ladder and cross-grid portability
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [
    dict(method="fused", reduce_strategy="tree", hub_split=True),
    dict(method="fused", schedule="oned"),
    dict(method="search2", compact=False),
    dict(method="search", compact=False, reduce_strategy="flat"),
])
def test_next_demotion_ladder_matches_the_reference(cfg):
    mine, ref = dict(cfg), dict(cfg)
    while True:
        a, b = tsup.next_demotion(mine), jsup.next_demotion(ref)
        assert a == b and mine == ref
        if a is None:
            break


def test_check_partials_portable():
    tsup.check_partials_portable({"grid": "3x3"}, "3x3")
    tsup.check_partials_portable({}, "2x2")
    with pytest.raises(tr.GridTransferRefused, match="decomposition-specific"):
        tsup.check_partials_portable({"grid": "3x3"}, "2x2")


def test_note_demotion_collects_only_inside():
    tsup.note_demotion("method", "fused", "search", reason="outside")
    with tsup.collecting_demotions() as demos:
        tsup.note_demotion("method", "fused", "search", reason="inside")
    assert demos == [dict(rung="method", frm="fused", to="search",
                          reason="inside")]


# ----------------------------------------------------------------------
# supervised_count at q = 1, both packages in this process
# ----------------------------------------------------------------------
G8 = "rmat:8,8,3"


def _supervised(pkg, spec, **kw):
    sup, _ = _fake_supervisor(pkg, max_restarts=4, seed=5,
                              backoff=pkg.BackoffPolicy(base=0.5, jitter=0.3))
    graph = (tc if pkg is tr else jc).graph_from_spec(G8)
    extra = dict(device="cpu") if pkg is tr else {}
    return (pkg.supervisor.supervised_count if pkg is tr
            else jsup.supervised_count)(
        graph, supervisor=sup, fault_plan=pkg.FaultPlan.parse(spec),
        q=1, **extra, **kw)


def _live(schedule, compact):
    plan = {"cannon": tp.plan_cannon, "summa": lambda g, q: tp.plan_summa(
        g, q, q), "oned": tp.plan_oned}[schedule](tc.graph_from_spec(G8), 1)
    return tfi.live_step_indices(plan.plan, compact is not False)


@pytest.mark.parametrize("compact", [None, False])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_supervised_count_every_point_matches_the_reference(schedule,
                                                           compact):
    exp = tc.triangle_count_oracle(tc.graph_from_spec(G8))
    specs = ["plan_stage", "device_stage"] + [
        f"step@{s}" for s in _live(schedule, compact)]
    for spec in specs:
        mine = _supervised(tr, spec, schedule=schedule, compact=compact)
        ref = _supervised(jr, spec, schedule=schedule, compact=compact)
        key = (schedule, compact, spec)
        assert mine.triangles == ref.triangles == exp, key
        assert mine.supervision == ref.supervision, key
        assert mine.supervision["restarts"] == 1, key


@pytest.mark.parametrize("schedule", ["cannon", "oned"])
def test_supervised_count_demotes_a_persistent_fused_fault(schedule):
    exp = tc.triangle_count_oracle(tc.graph_from_spec(G8))
    mine = _supervised(tr, "fused=stepfault*-1", schedule=schedule,
                       method="fused", demote_after=2)
    ref = _supervised(jr, "fused=stepfault*-1", schedule=schedule,
                      method="fused", demote_after=2)
    assert mine.triangles == ref.triangles == exp
    assert mine.supervision == ref.supervision
    assert mine.method == ref.method != "fused"
    demo = mine.supervision["demotions"][0]
    assert (demo["frm"], demo["to"]) == (
        "fused", "search" if schedule == "oned" else "search2")
    assert "persistent StepFault" in demo["reason"]


def test_the_ladder_demotes_summa_to_a_method_summa_refuses():
    """The reference's ladder takes SUMMA's ``fused`` to ``search2``,
    which SUMMA refuses: the supervised count ends in that ``ValueError``
    (not retryable) after the demotion.  The port copies it (ROADMAP.md
    Queue C)."""
    for pkg in (tr, jr):
        with pytest.raises(ValueError, match="needs a bucketized plan"):
            _supervised(pkg, "fused=stepfault*-1", schedule="summa",
                        method="fused", demote_after=2)


def test_supervised_count_gives_up_within_budget():
    sup, _ = _fake_supervisor(tr, max_restarts=2)
    with pytest.raises(tr.StageFault):
        tr.supervised_count(
            tc.graph_from_spec(G8), supervisor=sup, ladder=False, q=1,
            fault_plan=tr.FaultPlan.parse("plan_stage=stagefault*-1"),
            device="cpu")
    assert sup.report.gave_up and len(sup.report.attempts) == 3


def test_fused_site_order_on_cannon_differs_from_the_reference():
    """The port's Cannon runner binds the kernel before staging (it
    refuses a bad pod count before staging anything), so a ``fused`` site
    fires before a ``device_stage`` site of the same attempt; the
    reference binds it after ``mark_counting``.  Same restarts and count,
    the two attempt records in the other order (ROADMAP.md Queue C).  On
    SUMMA the orders agree."""
    spec = "fused;device_stage"
    mine = _supervised(tr, spec, method="fused")
    ref = _supervised(jr, spec, method="fused")
    assert mine.triangles == ref.triangles
    assert mine.supervision["restarts"] == ref.supervision["restarts"] == 2
    assert [e["point"] for e in mine.supervision["fault_log"]] == [
        "fused", "device_stage"]
    assert [e["point"] for e in ref.supervision["fault_log"]] == [
        "device_stage", "fused"]
    mine = _supervised(tr, spec, method="fused", schedule="summa")
    ref = _supervised(jr, spec, method="fused", schedule="summa")
    assert mine.supervision == ref.supervision


# ----------------------------------------------------------------------
# the injection points and traps
# ----------------------------------------------------------------------
def test_step_faults_fire_before_any_dispatch_by_original_index(monkeypatch):
    """``step`` faults fire at ``mark_counting``, by ORIGINAL step index,
    before the first kernel runs; under compaction an elided step's fault
    never fires."""
    import repro_torch.core.count as count_mod

    g = tc.graph_from_spec("cliques:3,60")
    cache = tp.PlanCache()
    live = tfi.live_step_indices(tp.plan_cannon(g, 3, cache=cache).plan)
    assert live == [0]  # cliques:3,60 at q = 3 elides steps 1 and 2
    calls = []
    plain = count_mod.count_pair_search
    monkeypatch.setattr(count_mod, "count_pair_search",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    plan = tfi.FaultPlan.parse("step@2")
    res = tc.count_triangles(g, q=3, fault_plan=plan, cache=cache,
                             device="cpu")
    assert res.triangles == tc.triangle_count_oracle(g)
    assert plan.log == [] and not plan.spent() and calls
    calls.clear()
    with pytest.raises(tfi.StepFault):
        tc.count_triangles(g, q=3, compact=False, fault_plan=plan,
                           cache=cache, device="cpu")
    assert calls == [] and plan.log[0]["step"] == 2


def test_a_retry_stages_nothing_twice(monkeypatch):
    """Every attempt after the first counts from the artifact's memoised
    staged tensors."""
    import repro_torch.pipeline.artifact as artifact

    staged = []
    plain = artifact.stage_arrays
    monkeypatch.setattr(artifact, "stage_arrays",
                        lambda arrays, device: staged.append(1) or plain(
                            arrays, device))
    sup, _ = _fake_supervisor(tr, max_restarts=5)
    g = tc.graph_from_spec("rmat:9,8,2")
    res = tr.supervised_count(
        g, supervisor=sup, q=2, method="fused", cache=tp.PlanCache(),
        fault_plan=tr.FaultPlan.parse("device_stage;step@0;step@1"),
        device="cpu")
    assert res.triangles == tc.triangle_count_oracle(g)
    assert res.supervision["restarts"] == 3 and staged == [1]


def test_batch_injection_points():
    g = tc.graph_from_spec("rmat:8,8,3")
    plan = tfi.FaultPlan.parse("plan_stage;device_stage")
    with plan.armed():
        for _ in range(2):
            with pytest.raises(tfi.StageFault):
                tc.count_triangles_many([g, g], q=1, device="cpu",
                                        cache=tp.PlanCache())
        res = tc.count_triangles_many([g, g], q=1, device="cpu",
                                      cache=tp.PlanCache())
    assert [e["point"] for e in plan.log] == ["plan_stage", "device_stage"]
    assert plan.log[0]["kind"] == "many"
    assert res.triangles == [tc.triangle_count_oracle(g)] * 2


def test_delta_splice_injection_point():
    g = tc.graph_from_spec("rmat:8,8,3")
    have = {tuple(e) for e in np.sort(g.edges, axis=1).tolist()}
    v = next(v for v in range(1, g.n) if (0, v) not in have)
    cache = tp.PlanCache()
    art = tp.plan_cannon(g, 2, cache=cache)
    delta = tp.EdgeDelta(add=[[0, v]])
    plan = tfi.FaultPlan.parse("delta_splice")
    with plan.armed(), pytest.raises(tfi.StageFault):
        tp.apply_delta(art, delta, cache=cache)
    assert plan.log == [dict(point="delta_splice", step=None,
                             fault="StageFault")]
    assert tp.apply_delta(art, delta, cache=cache).delta_report[
        "level"] == "splice"


# ----------------------------------------------------------------------
# run_with_restarts, best_grid, replan_elastic, rebalance_plan
# ----------------------------------------------------------------------
def test_run_with_restarts(tmp_path):
    calls = {"failures": 0}

    def injector(step):
        if step == 5 and calls["failures"] == 0:
            calls["failures"] += 1
            raise RuntimeError("injected device loss")

    state = tr.run_with_restarts(
        lambda: {"x": torch.zeros((), dtype=torch.float64)},
        lambda st, i: {"x": st["x"] + 1.0},
        n_steps=10, ckpt_dir=str(tmp_path), ckpt_every=2,
        fault_injector=injector,
    )
    assert float(state["x"]) == 10.0 and calls["failures"] == 1
    assert state["x"].dtype == torch.float64


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15, 16, 18,
                               30, 255, 256])
@pytest.mark.parametrize("square", [False, True])
def test_best_grid_matches_the_reference(n, square):
    assert tr.best_grid(n, require_square=square) == jr.best_grid(
        n, require_square=square)


@pytest.mark.parametrize("n,schedule", [(4, None), (8, None), (8, "cannon"),
                                        (9, "summa"), (12, None)])
def test_replan_elastic_matches_the_reference(n, schedule):
    g = "rmat:9,8,2"
    mine = tr.replan_elastic(tc.graph_from_spec(g), n, schedule=schedule,
                             rebalance_trials=2, cache=tp.PlanCache())
    import repro.pipeline as jp

    ref = jr.replan_elastic(jc.graph_from_spec(g), n, schedule=schedule,
                            rebalance_trials=2, cache=jp.PlanCache())
    assert mine[0] == ref[0] and mine[2] == ref[2]
    a, b = mine[1].plan.device_arrays(), ref[1].plan.device_arrays()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    assert mine[1].rebalance["best_seed"] == ref[1].rebalance["best_seed"]


def test_replan_elastic_is_a_cached_pipeline_plan():
    g = tc.graph_from_spec("rmat:9,8,2")
    cache = tp.PlanCache(maxsize=8)
    sched, art, grid = tr.replan_elastic(g, 4, cache=cache)
    assert sched == "cannon" and grid == (2, 2)
    misses = cache.stats()["misses"]
    assert tr.replan_elastic(g, 4, cache=cache)[1] is art
    assert cache.stats()["misses"] == misses


def test_replan_elastic_legacy_path_deprecated():
    g = tc.graph_from_spec("rmat:9,8,2")
    with pytest.deprecated_call():
        sched, plan, grid = tr.replan_elastic(g, 4, legacy=True)
    assert sched == "cannon" and grid == (2, 2)
    assert getattr(plan, "compact", None) is None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert tr.replan_elastic(g, 8, legacy=True)[0] == "summa"


@pytest.mark.parametrize("schedule,q", [("cannon", 3), ("summa", 2),
                                        ("oned", 4)])
def test_rebalance_plan_matches_the_reference(schedule, q):
    import repro.pipeline as jp

    mine, mrep = tr.rebalance_plan(tc.graph_from_spec("rmat:10,8,1"), q,
                                   trials=4, schedule=schedule,
                                   cache=tp.PlanCache(0))
    ref, rrep = jr.rebalance_plan(jc.graph_from_spec("rmat:10,8,1"), q,
                                  trials=4, schedule=schedule,
                                  cache=jp.PlanCache(0))
    assert mrep == rrep and mrep["improvement"] >= 1.0
    np.testing.assert_array_equal(mine.step_keep, np.asarray(ref.step_keep))


# ----------------------------------------------------------------------
# the regrid on 9 devices, and a second event (one reference subprocess)
# ----------------------------------------------------------------------
REGRID_CASES = (
    # (q, spec): 9 - 5 = 4 -> 2 x 2; then 9 - 8 = 1 -> 1 x 1
    (3, "step@0=devicelost:5"),
    (3, "step@0=devicelost:5;step@0=devicelost:8"),
    # 9 - 1 = 8 -> SUMMA 2 x 4, then the ring keeps its schedule
    (3, "step@0=devicelost:1"),
)
REGRID_SCHEDULES = ("cannon", "oned")

REGRID_CODE = """
import json
import jax
jax.config.update("jax_enable_x64", True)
from repro.core import rmat
from repro.runtime import BackoffPolicy, FaultPlan, Supervisor
from repro.runtime.supervisor import supervised_count

class Clock:
    t = 0.0
    def __call__(self):
        return self.t
    def sleep(self, d):
        self.t += d

g = rmat(9, 8, seed=2)
out = []
for q, spec in {cases!r}:
    for schedule in {schedules!r}:
        clk = Clock()
        sup = Supervisor(max_restarts=4, seed=5, clock=clk, sleep=clk.sleep,
                         backoff=BackoffPolicy(base=0.5, jitter=0.3))
        res = supervised_count(g, supervisor=sup, q=q, schedule=schedule,
                               fault_plan=FaultPlan.parse(spec))
        out.append(dict(triangles=res.triangles, supervision=res.supervision))
# a q = 2 count in a 9-device process: the reference counts the
# survivors on every host device, not on the grid the count ran on
clk = Clock()
sup = Supervisor(max_restarts=4, clock=clk, sleep=clk.sleep)
res = supervised_count(g, supervisor=sup, q=2,
                       fault_plan=FaultPlan.parse("step@0=devicelost:1"))
out.append(dict(triangles=res.triangles, supervision=res.supervision))
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def regrid_reference(distributed_runner):
    code = REGRID_CODE.format(cases=REGRID_CASES, schedules=REGRID_SCHEDULES)
    out = distributed_runner(code, 9)
    line = [ln for ln in out.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


def _port_supervised(q, spec, **kw):
    clk = _FakeClock()
    sup = tr.Supervisor(max_restarts=4, seed=kw.pop("seed", 5), clock=clk,
                        sleep=clk.sleep,
                        backoff=tr.BackoffPolicy(base=0.5, jitter=0.3))
    return tr.supervised_count(
        tc.rmat(9, 8, seed=2), supervisor=sup, q=q,
        fault_plan=tr.FaultPlan.parse(spec), device="cpu", **kw)


def test_regrid_matches_the_reference_on_9_devices(regrid_reference):
    exp = tc.triangle_count_oracle(tc.rmat(9, 8, seed=2))
    i = 0
    for q, spec in REGRID_CASES:
        for schedule in REGRID_SCHEDULES:
            ref = regrid_reference[i]
            i += 1
            mine = _port_supervised(q, spec, schedule=schedule)
            key = (q, spec, schedule)
            assert mine.triangles == ref["triangles"] == exp, key
            assert mine.supervision == ref["supervision"], key
    first = regrid_reference[0]["supervision"]
    assert first["regrids"] == [
        {"lost": 5, "grid": [2, 2], "schedule": "cannon"}]
    assert [r["grid"] for r in regrid_reference[2]["supervision"][
        "regrids"]] == [[2, 2], [1, 1]]
    assert regrid_reference[4]["supervision"]["regrids"] == [
        {"lost": 1, "grid": [2, 4], "schedule": "summa"}]


def test_regrid_counts_the_logical_grid_not_the_process(regrid_reference):
    """The one place the port's regrid must differ: at q = 2 in a
    9-device process the reference sees 9 - 1 = 8 survivors (SUMMA
    2 x 4), the port the 4 - 1 = 3 of the grid the count ran on (SUMMA
    1 x 3).  Both counts are exact (ROADMAP.md Queue C)."""
    ref = regrid_reference[-1]
    mine = _port_supervised(2, "step@0=devicelost:1", seed=0)
    assert mine.triangles == ref["triangles"]
    assert ref["supervision"]["regrids"] == [
        {"lost": 1, "grid": [2, 4], "schedule": "summa"}]
    assert mine.supervision["regrids"] == [
        {"lost": 1, "grid": [1, 3], "schedule": "summa"}]
    with pytest.raises(RuntimeError, match="cannot regrid"):
        _port_supervised(2, "step@0=devicelost:4")


@pytest.mark.parametrize("cfg,devices", [
    (dict(q=3), 9), (dict(grid=(2, 4)), 8), (dict(q=2, npods=2), 8),
    (dict(), 1), (dict(grid=(1, 3), schedule="oned"), 3)])
def test_logical_devices_of_a_count(cfg, devices):
    assert tsup._logical_devices(cfg) == devices


def test_regrid_keeps_pods_out_and_the_ring_in_place():
    res = _port_supervised(2, "step@0=devicelost:2", npods=2,
                           schedule="oned")
    assert res.supervision["regrids"] == [
        {"lost": 2, "grid": [1, 6], "schedule": "oned"}]
    assert res.grid == (6,)
    assert res.triangles == tc.triangle_count_oracle(tc.rmat(9, 8, seed=2))


# ----------------------------------------------------------------------
# tc_run --inject-faults / --supervise
# ----------------------------------------------------------------------
CLI_CODE = """
import os, sys
sys.argv = ["tc_run", "--graph", "rmat:9", "--grid", "2",
            "--ckpt-dir", {ckpt!r},
            "--inject-faults", "step@1;ckpt_save=ckptcorrupt",
            "--verify", "--json"]
from repro.launch.tc_run import main
main()
print("FILES", sorted(os.listdir({ckpt!r})))
"""


def _report(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def test_tc_run_inject_faults_matches_the_reference(distributed_runner,
                                                    tmp_path, capsys):
    ref_dir, my_dir = tmp_path / "ref", tmp_path / "mine"
    out = distributed_runner(CLI_CODE.format(ckpt=str(ref_dir)), 4)
    ref = _report(out)
    tc_run.main(["--graph", "rmat:9", "--grid", "2", "--ckpt-dir",
                 str(my_dir), "--inject-faults",
                 "step@1;ckpt_save=ckptcorrupt", "--verify", "--json",
                 "--device", "cpu"])
    mine = _report(capsys.readouterr().out)
    assert mine["correct"] and ref["correct"]
    for key in ("triangles", "checkpointed", "live_steps", "schedule_shifts",
                "supervision_restarts", "supervision_fault_log"):
        assert mine[key] == ref[key], key
    assert [(a["outcome"], a.get("point"), a.get("step"))
            for a in mine["supervision_attempts"]] == [
        (a["outcome"], a.get("point"), a.get("step"))
        for a in ref["supervision_attempts"]]
    assert any(e["fault"] == "CkptCorrupt"
               for e in mine["supervision_fault_log"])
    assert sorted(os.listdir(my_dir)) == sorted(os.listdir(ref_dir))
    assert [f for f in os.listdir(my_dir) if f.endswith(".corrupt")]


def test_tc_run_supervise_with_faults(capsys):
    tc_run.main(["--graph", "rmat:9", "--grid", "2", "--method", "fused",
                 "--inject-faults", "step@0=devicelost:1;plan_stage",
                 "--verify", "--json", "--device", "cpu"])
    rep = _report(capsys.readouterr().out)
    assert rep["correct"] and rep["supervision_restarts"] == 2
    assert rep["supervision_regrids"] == [
        {"lost": 1, "grid": [1, 3], "schedule": "summa"}]
    assert rep["grid"] == [1, 3] and rep["schedule"] == "summa"
    tc_run.main(["--graph", "rmat:9", "--grid", "2", "--supervise",
                 "--json", "--device", "cpu"])
    rep = _report(capsys.readouterr().out)
    assert rep["supervision_restarts"] == 0
    assert "supervision_fault_log" not in rep


@pytest.mark.parametrize("argv,match", [
    (["--graphs", "rmat:8;rmat:9", "--inject-faults", "step@0"],
     "--inject-faults/--supervise cover"),
    (["--stream", "x.jsonl", "--supervise"], "--inject-faults/--supervise"),
    (["--ckpt-dir", "x", "--rebalance", "2"], "--rebalance is not supported"),
    (["--ckpt-dir", "x", "--hub-split"], "no slot for the hub-split"),
    (["--ckpt-dir", "x", "--stream", "x.jsonl"], "--stream composes"),
])
def test_tc_run_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        tc_run.main(["--graph", "rmat:8", "--device", "cpu", *argv])
