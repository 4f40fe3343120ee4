"""The shift-count overlap on a device mesh: Cannon's double buffer, the
single-buffered and compacted bodies, 2.5D pods and the ring, with every
shift's copies on per-device copy streams ordered by events
(``repro_torch.core.lanes``).

Every mesh here is a CPU mesh.  There the stream layer is inert (copies run
in order), but it keeps its books, and ``lanes.issue_log()`` hands the
tests the order in which event records, waits, copies, counts and joins
were issued.  The tests hold that order to the contract the card relies
on: a count waits for the copies that wrote its blocks, a copy waits for
the last count that read its buffer, the shift that feeds a later step is
issued before the current step counts, the receive buffers stay within
two or three generations, and every run ends with the join.  Counts and
per-position partials are held ``==`` to the one-device engine's and, for
one double- and one single-buffered case, to the reference's host mesh.
"""
import json

import numpy as np
import pytest
import torch
from test_torch_mesh import placement  # noqa: F401  (the fixture)

import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro_torch.ckpt.checkpoint import (host_array, load_checkpoint,
                                         save_checkpoint)
from repro_torch.core import engine, lanes
from repro_torch.core.cannon import (build_cannon_fn, build_cannon_stepper,
                                     pod_stack_arrays)
from repro_torch.core.engine import CannonSchedule, CSRStore
from repro_torch.core.onedim import build_oned_fn
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.pipeline.artifact import stage_arrays, stage_on_mesh

GRAPH = "rmat:7,8,3"
# graphs whose plans compact: bull at q = 3 counts step 2 only (a prologue
# hop of 2), cliques:4,60 at q = 4 steps 0 and 3 (one hop of 3)
COMPACT = {1: GRAPH, 2: GRAPH, 3: "named:bull", 4: "cliques:4,60"}
KNOBS = {"on": {}, "off": dict(compact=False, use_step_mask=False)}
REF_Q = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g(spec):
    return tc.graph_from_spec(spec)


def _cpu_mesh(q, npods=1):
    return tc.make_grid_mesh(q, npods=npods, devices=["cpu"] * (q * q * npods))


def _ring_mesh(p):
    return make_mesh_for((p,), ("flat",), devices=["cpu"] * p)


# ----------------------------------------------------------------------
# the reference on a host mesh
# ----------------------------------------------------------------------
_REFERENCE = """
import json
import jax, jax.numpy as jnp
import numpy as np
from repro import compat
from repro.core import count_triangles, graph_from_spec
from repro.core.cannon import build_cannon_fn
import repro.pipeline as jp

q = {q}
m = compat.make_mesh((q, q), ("data", "model"), devices=jax.devices()[:q * q])
g = graph_from_spec({graph!r})
plan = jp.plan_cannon(g, q, cache=jp.PlanCache()).plan
st = {{k: jnp.asarray(v) for k, v in plan.device_arrays().items()}}
out = {{}}
for db in (True, False):
    out[f"count/{{db}}"] = count_triangles(g, m, double_buffer=db).triangles
    out[f"per/{{db}}"] = np.asarray(build_cannon_fn(
        plan, m, reduce_global=False, double_buffer=db)(**st)).reshape(
            q, q).tolist()
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(distributed_runner):
    out = distributed_runner(_REFERENCE.format(q=REF_Q, graph=GRAPH),
                             REF_Q * REF_Q, timeout=300)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("double", [True, False])
def test_both_bodies_match_the_reference_host_mesh(ref, double):
    g, mesh = _g(GRAPH), _cpu_mesh(REF_Q)
    res = tc.count_triangles(g, mesh, double_buffer=double,
                             cache=tp.PlanCache())
    assert res.triangles == ref[f"count/{double}"]
    art = res.artifact
    got = build_cannon_fn(art.plan, reduce_global=False, double_buffer=double,
                          mesh=mesh)(**art.staged(mesh))
    assert got.tolist() == ref[f"per/{double}"]


# ----------------------------------------------------------------------
# counts and partials against one device
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", ["search", "fused"])
@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("q", [1, 2, 3])
def test_cannon_bodies_match_one_device(q, double, knob, method):
    """Counts and per-position partials of both bodies, with and without
    compaction (``COMPACT[q]`` compacts where the grid allows), ``==`` the
    one-device engine's and the oracle."""
    g, cache, mesh = _g(COMPACT[q]), tp.PlanCache(), _cpu_mesh(q)
    kw = dict(method=method, double_buffer=double, **KNOBS[knob])
    res = tc.count_triangles(g, mesh, cache=cache, **kw)
    one = tc.count_triangles(g, q=q, device="cpu", cache=cache, **kw)
    assert res.triangles == one.triangles == tc.triangle_count_oracle(g)
    art = res.artifact
    build = dict(method=method, reduce_global=False, double_buffer=double,
                 compact=kw.get("compact"),
                 use_step_mask=kw.get("use_step_mask"))
    got = build_cannon_fn(art.plan, mesh=mesh, **build)(**art.staged(mesh))
    base = build_cannon_fn(art.plan, **build)(**art.staged("cpu"))
    assert got.tolist() == base.tolist()


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("strategy", ["flat", "tree"])
def test_two_pods_match_one_device(strategy, double):
    g, cache = _g(GRAPH), tp.PlanCache()
    kw = dict(method="fused", reduce_strategy=strategy, double_buffer=double)
    res = tc.count_triangles(g, _cpu_mesh(2, npods=2), cache=cache, **kw)
    one = tc.count_triangles(g, q=2, npods=2, device="cpu", cache=cache, **kw)
    assert res.triangles == one.triangles == tc.triangle_count_oracle(g)
    art, mesh = res.artifact, _cpu_mesh(2, npods=2)
    got = build_cannon_fn(art.plan, reduce_global=False, npods=2,
                          double_buffer=double, mesh=mesh)(**art.staged(mesh))
    base = build_cannon_fn(art.plan, reduce_global=False, npods=2,
                           double_buffer=double)(**stage_arrays(
                               pod_stack_arrays(art.plan.device_arrays(), 2,
                                                2), "cpu"))
    assert got.tolist() == base.tolist()


@pytest.mark.parametrize("p", [2, 3])
def test_ring_matches_one_device(p):
    g, cache = _g(GRAPH), tp.PlanCache()
    res = tc.count_triangles(g, _ring_mesh(p), schedule="oned",
                             method="fused", cache=cache)
    assert res.triangles == tc.triangle_count_oracle(g)
    art = tp.plan_oned(g, p, cache=cache)
    got = build_oned_fn(art.plan, reduce_global=False, mesh=_ring_mesh(p))(
        **art.staged(_ring_mesh(p)))
    base = build_oned_fn(art.plan, reduce_global=False)(**art.staged("cpu"))
    assert got.tolist() == base.tolist()


# ----------------------------------------------------------------------
# the issue log
# ----------------------------------------------------------------------
def _cannon_run(q, double, live=None, npods=1, spec=GRAPH):
    """``(fn, staged, one-device fn, one-device staged)`` of a Cannon
    count through the engine itself (``live``: a compacted schedule of
    those steps, the mask off, so the one-device engine counts the same
    wrong total)."""
    art = tp.plan_cannon(_g(spec), q, cache=tp.PlanCache())
    plan, mesh = art.plan, _cpu_mesh(q, npods)

    def fn(m):
        schedule = CannonSchedule(q=q, double_buffer=double, live_steps=live,
                                  npods=npods)
        kernel = engine.make_csr_kernel("search", dpad=plan.dmax,
                                        chunk=plan.chunk)
        return engine.build_engine_fn(
            CSRStore(kernel), schedule, m_cnt=plan.m_cnt,
            reduction=engine.Reduction(global_sum=False), mesh=m)

    host = (plan.device_arrays() if npods == 1
            else pod_stack_arrays(plan.device_arrays(), npods, q))
    return fn(mesh), art.staged(mesh), fn(None), stage_arrays(host, "cpu")


def _ring_run(p):
    art = tp.plan_oned(_g(GRAPH), p, cache=tp.PlanCache())
    mesh = _ring_mesh(p)
    return (build_oned_fn(art.plan, reduce_global=False, mesh=mesh),
            art.staged(mesh), build_oned_fn(art.plan, reduce_global=False),
            art.staged("cpu"))


# name: (run, receive buffers a position (the ring), the generation ahead
# of the counted one that is in flight, generations)
LOG_CASES = {
    "double": (lambda: _cannon_run(5, True), 3, 2, 4),
    "double-q4": (lambda: _cannon_run(4, True), 3, 2, 3),
    "single": (lambda: _cannon_run(4, False), 2, 1, 3),
    "compact": (lambda: _cannon_run(4, False, live=(1, 2, 3)), 2, 1, 3),
    "compact-hops": (lambda: _cannon_run(4, True, live=(0, 3)), 1, 1, 1),
    "pods-double": (lambda: _cannon_run(4, True, npods=2), 1, 2, 1),
    "ring": (lambda: _ring_run(4), 2, 1, 3),
}


def _waited(log, i, stream, mark):
    """Whether ``stream`` waited, before entry ``i``, for ``mark`` or a
    later event of its stream."""
    return mark.stream == stream or any(
        e["op"] == "wait" and e["stream"] == stream
        and e["on"].stream == mark.stream and e["on"].seq >= mark.seq
        for e in log[:i])


def _next(log, i, pred):
    return next(e for e in log[i:] if pred(e))


def _check_log(log, ring, ahead, gens):
    """The contract of one run's issue log (see the module docstring)."""
    copies = [(i, e) for i, e in enumerate(log) if e["op"] == "copy"]
    counts = [(i, e) for i, e in enumerate(log) if e["op"] == "count"]
    assert counts and log[-1]["op"] == "join"
    assert max((e["gen"] for _, e in copies), default=0) == gens
    for _, c in counts:
        assert len(set(c["gens"])) == 1
    # the receive buffers: a ring of ``ring`` a position, allocated at the
    # entry, which every copy stream waits for before its first copy;
    # generation g in buffer (g - 1) % ring
    assert {e["slot"] for _, e in copies} == set(range(min(ring, gens)))
    assert all(e["slot"] == (e["gen"] - 1) % ring for _, e in copies)
    entry = {e["stream"][1]: e["mark"] for e in log
             if e["op"] == "record" and e["what"] == "entry"}
    for i, c in copies:
        for lane in (c["src_stream"], c["dst_stream"]):
            assert _waited(log, i, lane, entry[lane[1]]), (i, lane)
    # a copy reads a block after the copy that received it, on the lane
    # that received it (the copy streams order themselves)
    for i, c in copies:
        if c["gen"] > 1:
            wrote = [e for _, e in copies[:i] if e["pos"] == c["src_pos"]
                     and e["gen"] == c["gen"] - 1]
            assert wrote and wrote[-1]["dst_stream"] == c["src_stream"]
    # a count waits for the event after the shift that wrote its blocks
    for i, c in counts:
        for g in set(c["gens"]) - {0}:
            last = max(j for j, e in copies
                       if e["gen"] == g and e["pos"] == c["pos"])
            rec = _next(log, last, lambda e: e["op"] == "record"
                        and e["what"] == "written"
                        and e["stream"] == ("copy", c["stream"][1]))
            assert last < i and _waited(log, i, c["stream"], rec["mark"])
    # a copy writes a buffer only after every count of the buffer's
    # earlier generations at that position was issued, and after the
    # event that followed the last of them
    for i, c in copies:
        for j, k in counts:
            older = [g for g in k["gens"] if 0 < g < c["gen"]
                     and (g - 1) % ring == c["slot"]]
            if k["pos"] != c["pos"] or not older:
                continue
            read = _next(log, j, lambda e: e["op"] == "record"
                         and e["what"] == "read" and e["stream"] == k["stream"])
            assert j < i and _waited(log, i, c["dst_stream"], read["mark"])
    # the shift feeding a later step is issued before the current count
    for i, c in counts:
        ahead_of = [j for j, e in copies if e["gen"] == c["gens"][0] + ahead]
        assert all(j < i for j in ahead_of), (c, ahead_of)
    if gens > ring:  # the ring wraps: a buffer is written a second time
        assert any(e["gen"] > ring for _, e in copies)


@pytest.mark.parametrize("name", sorted(LOG_CASES))
def test_issue_log_orders_copies_and_counts(name):
    make, ring, ahead, gens = LOG_CASES[name]
    fn, staged, one, one_staged = make()
    with lanes.issue_log() as log:
        got = fn(**staged)
    assert got.tolist() == one(**one_staged).tolist()
    _check_log(log, ring, ahead, gens)
    # copies run on the copy lanes only, counts on the compute lanes
    assert {e["src_stream"][0] for e in log if e["op"] == "copy"} == {"copy"}
    assert {e["stream"][0] for e in log if e["op"] == "count"} == {"compute"}


def test_a_shift_inside_a_run_needs_the_runs_receive_buffers():
    """A run allocates its receive buffers before its entry; a payload
    without them is refused rather than given buffers mid-run."""
    mesh = _cpu_mesh(2)
    x = stage_on_mesh(np.arange(8, dtype=np.int32).reshape(2, 2, 2), mesh)
    with lanes.lanes(mesh), pytest.raises(ValueError, match="receive"):
        engine.tree_ppermute((x,), 1, engine.shift_perm(2, 1))


def test_a_shift_outside_a_run_joins_its_copies():
    mesh = _cpu_mesh(2)
    x = stage_on_mesh(np.arange(8, dtype=np.int32).reshape(2, 2, 2), mesh)
    with lanes.issue_log() as log:
        (y,) = engine.tree_ppermute((x,), 1, engine.shift_perm(2, 1))
    assert [e["op"] for e in log if e["op"] in ("copy", "join")] == [
        "copy"] * 4 + ["join"]
    assert torch.equal(torch.from_numpy(host_array(y)),
                       torch.from_numpy(host_array(x)).roll(-1, dims=1))
    assert lanes.active() is None


# ----------------------------------------------------------------------
# placement, through test_torch_mesh.py's dispatch mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("npods", [1, 2])
def test_both_bodies_read_one_position_and_move_the_tally(placement, npods,
                                                          double):
    """Outside a shift and the reduce no op reads two positions' blocks,
    and the bytes copied are the tally's, which are one device's."""
    g = _g(GRAPH)
    art = tp.plan_cannon(g, 2, autotune="fused", cache=tp.PlanCache())
    mesh = _cpu_mesh(2, npods=npods)
    kw = dict(method="fused", npods=npods, double_buffer=double,
              reduce_strategy="tree" if npods > 1 else "flat")
    staged = art.staged(mesh)
    for a in staged.values():
        placement.label(a)
    with engine.tally_moved_bytes() as tally, placement:
        got = build_cannon_fn(art.plan, mesh=mesh, **kw)(**staged)
    host = (art.plan.device_arrays() if npods == 1 else
            pod_stack_arrays(art.plan.device_arrays(), npods, 2))
    with engine.tally_moved_bytes() as one_tally:
        one = build_cannon_fn(art.plan, **kw)(**stage_arrays(host, "cpu"))
    assert int(got) == int(one) == tc.triangle_count_oracle(g)
    assert placement.ops > 0 and not placement.mixed, placement.mixed
    assert placement.copied == tally["shift"] + tally["reduce"] > 0
    assert tally["shift"] == one_tally["shift"]


# ----------------------------------------------------------------------
# the stepper on a mesh, with checkpoints across one device and the mesh
# ----------------------------------------------------------------------
def _stepper_state(carry, acc):
    return {**{f"carry{i}": c for i, c in enumerate(carry)}, "acc": acc}


@pytest.mark.parametrize("double", [True, False])
def test_stepper_checkpoints_restore_across_one_device_and_the_mesh(
        tmp_path, double):
    """After each step the mesh's state checkpoints to the bytes one
    device's does; it restores onto one device and onto the mesh, and each
    restored run ends at the oracle.  Each call's log ends with the join,
    its shift issued before its count."""
    q, g = 3, _g(GRAPH)
    plan = tp.plan_cannon(g, q, cache=tp.PlanCache()).plan
    mesh = _cpu_mesh(q)
    on_mesh = build_cannon_stepper(plan, mesh, double_buffer=double)
    one = build_cannon_stepper(plan, double_buffer=double)
    assert on_mesh.n_carry == one.n_carry == (8 if double else 4)
    host = plan.device_arrays()
    arrays = {"mesh": stage_arrays(host, mesh), "one": stage_arrays(host,
                                                                    "cpu")}
    zeros = np.zeros((q, q), dtype=np.int64)
    acc = {"mesh": stage_on_mesh(zeros, mesh), "one": torch.from_numpy(zeros)}
    fns = {"mesh": on_mesh, "one": one}
    with lanes.issue_log() as log:
        carry = {k: fns[k].prime(arrays[k]) for k in fns}
    assert [e["op"] for e in log].count("join") == 1

    def finish(where, state, start):
        for s in range(start, q):
            *c, a = fns[where]((*[state[f"carry{i}"] for i in range(
                fns[where].n_carry)], state["acc"]), arrays[where], step=s)
            state = _stepper_state(c, a)
        a = state["acc"]
        return int(engine.Reduction().resolve().apply(a)) if where == "mesh" \
            else int(a.sum())

    for s in range(q):
        state = {}
        for k in fns:
            with lanes.issue_log() as log:
                *c, a = fns[k]((*carry[k], acc[k]), arrays[k], step=s)
            carry[k], acc[k] = c, a
            state[k] = _stepper_state(c, a)
            if k == "mesh":
                ops = [e["op"] for e in log]
                assert ops[-1] == "join"
                if "copy" in ops:
                    assert ops.index("copy") < ops.index("count")
            save_checkpoint(str(tmp_path / f"{k}{s}"), s + 1, state[k])
        for f in (f"step_{s + 1:010d}.npz", f"step_{s + 1:010d}.json"):
            assert (tmp_path / f"mesh{s}" / f).read_bytes() == (
                tmp_path / f"one{s}" / f).read_bytes()
        for where in fns:
            back, _ = load_checkpoint(str(tmp_path / f"mesh{s}"), s + 1,
                                      state[where])
            assert finish(where, back, s + 1) == tc.triangle_count_oracle(g)


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("method", ["fused", "search"])
def test_copy_streams_on_the_card(method):
    """Meshes of 2 x 2, 3 x 3 and 4 x 4 positions on ``cuda:0``: the copy
    stream is not the current stream, every shift copy is issued on it,
    and both bodies count ``==`` one device, also while the compute
    stream is held busy before the count (a sleep kernel), so that the
    copies run ahead of queued counts whose temporaries the allocator
    recycles on the compute stream (the search's; from q = 3 single- and
    q = 4 double-buffered a shift is issued after a count).
    ``python3 chip_smoke.py``'s ``mesh_path`` traces the same at the main
    path's size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh's positions lie on "
                    "cuda:0")
    g, cache = _g("rmat:12,8,1"), tp.PlanCache()
    for q in (2, 3, 4):
        mesh = tc.make_grid_mesh(q, devices=["cuda:0"] * (q * q))
        assert lanes.copy_stream(mesh, "cuda:0") != torch.cuda.current_stream(0)
        one = tc.count_triangles(g, q=q, method=method, device="cuda:0",
                                 cache=cache)
        assert one.triangles == tc.triangle_count_oracle(g)
        for double in (True, False):
            for busy in (0, 200_000_000):
                torch.cuda._sleep(busy)
                with lanes.issue_log() as log:
                    res = tc.count_triangles(g, mesh, method=method,
                                             cache=cache, double_buffer=double)
                assert res.triangles == one.triangles, (q, double, busy)
                copies = [e for e in log if e["op"] == "copy"]
                assert copies and {e["src_stream"][0]
                                   for e in copies} == {"copy"}
                assert [e["op"] for e in log][-1] == "join"
