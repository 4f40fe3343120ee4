"""The counting engine on a device mesh against the one-device engine and
the JAX package on a host mesh.

Every mesh here is a CPU mesh, ``make_grid_mesh(q, devices=["cpu"] * n)``:
each grid position holds its own blocks, but all positions are the same
device, so placement is not visible to the tensors themselves.  A
``TorchDispatchMode`` makes it visible: it labels every staged block with
its grid position, carries the labels through every op, and checks that
an op outside a shift, a SUMMA broadcast or the reduction reads the blocks
of one position only, and that the bytes copied inside those phases are the
bytes the engine's tally counts.

Counts and per-position partials are held with ``==`` to the one-device
engine's and to the reference's, which two subprocesses compute at once
on nine host devices.
"""
import json
from collections import Counter

import pytest
import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro_torch.core import engine
from repro_torch.core.cannon import (
    build_cannon_fn,
    build_cannon_tile_fn,
    pod_stack_arrays,
)
from repro_torch.core.onedim import build_oned_fn
from repro_torch.core.summa import build_summa_fn
from repro_torch.core.tiles import build_tile_plan, stage_tile_plan
from repro_torch.launch.mesh import DeviceMesh, make_mesh_for
from repro_torch.pipeline.artifact import stage_arrays

GRAPH = "rmat:7,8,3"
BATCH = ("rmat:6,6,1", "named:karate", "er:60,5,2")
METHODS = ("search", "search2", "global", "fused", "dense", "tile")
# compaction and the step mask: as planned (on where the plan elides a
# step), and both forced off
KNOBS = {"on": {}, "off": dict(compact=False, use_step_mask=False)}
HUB_C = 2.0
DELTAS = ((3, 1), (40, 2), (2, 3))  # (flips, seed) of three rounds
# one method a variant off the Cannon sweep, the fused kernel in each
POD_CASES = (("search", "flat"), ("fused", "tree"))
SUMMA_CASES = (("onehot", "search"), ("chain", "fused"))
RING_CASES = ((2, "fused"), (3, "search"))


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


def _rect_mesh(r, c):
    return make_mesh_for((r, c), ("data", "model"), devices=["cpu"] * (r * c))


def _both(spec, mesh, **kw):
    """``(mesh count, one-device count)`` of the same call."""
    g, cache = _g(spec), tp.PlanCache()  # one plan, staged both ways
    on_mesh = tc.count_triangles(g, mesh, cache=cache, **kw)
    npods = mesh.shape[0] if len(mesh.shape) == 3 else 1
    grid = tuple(mesh.shape[-2:])
    one = tc.count_triangles(g, grid=grid, npods=npods, device="cpu",
                             cache=cache, **kw)
    assert on_mesh.grid == one.grid
    return on_mesh.triangles, one.triangles


# ----------------------------------------------------------------------
# the reference on host meshes
# ----------------------------------------------------------------------
_REFERENCE_HEAD = """
import json
import jax, jax.numpy as jnp
import numpy as np
from repro import compat
from repro.core import count_triangles, count_triangles_delta, graph_from_spec
from repro.core.cannon import build_cannon_fn, pod_stack_arrays
from repro.core.summa import build_summa_fn
import repro.pipeline as jp

devs = jax.devices()
def mesh(shape, names=("data", "model")):
    return compat.make_mesh(shape, names, devices=devs[:int(np.prod(shape))])
out = {{}}
g = graph_from_spec({graph!r})
pods = mesh((2, 2, 2), ("pod", "data", "model"))
"""

# the Cannon sweep, in a subprocess of its own beside the rest
_REFERENCE_SWEEP = _REFERENCE_HEAD + """
for q in (1, 2, 3):
    m = mesh((q, q))
    for meth in {methods!r}:
        for knob, kw in {knobs!r}.items():
            out[f"cannon/{{q}}/{{meth}}/{{knob}}"] = count_triangles(
                g, m, method=meth, **kw).triangles
print("RESULT" + json.dumps(out))
"""

_REFERENCE_REST = _REFERENCE_HEAD + """
for meth, strat in {pod_cases!r}:
    out[f"pods/{{meth}}/{{strat}}"] = count_triangles(
        g, pods, method=meth, reduce_strategy=strat).triangles
out["hub"] = count_triangles(g, mesh((2, 2)), hub_split={hub!r}).triangles
for b, meth in {summa_cases!r}:
    out[f"summa/{{b}}/{{meth}}"] = count_triangles(
        g, mesh((2, 3)), schedule="summa", broadcast=b, method=meth).triangles
for q, meth in {ring_cases!r}:
    out[f"ring/{{q * q}}/{{meth}}"] = count_triangles(
        g, mesh((q, q)), schedule="oned", method=meth).triangles
out["many"] = list(jp.count_triangles_many(
    [graph_from_spec(s) for s in {batch!r}], mesh((2, 2))).triangles)
art, cur, rounds = None, g, []
for k, seed in {deltas!r}:
    d = jp.EdgeDelta.random_flips(cur, k, seed=seed)
    res = count_triangles_delta(cur, d, mesh((2, 2)), artifact=art,
                                method="fused")
    rounds.append(res.triangles)
    art, cur = res.artifact, d.apply_to(cur)
out["delta"] = rounds
out["cliques"] = count_triangles(
    graph_from_spec("cliques:3,60"), mesh((3, 3)), method="fused").triangles
out["star"] = count_triangles(
    graph_from_spec("star:64"), mesh((2, 4)), schedule="summa",
    method="fused").triangles

def per(fn, st, shape):
    return np.asarray(fn(**st)).reshape(shape).tolist()

for q, spec in ((2, {graph!r}), (3, {graph!r}), (3, "cliques:3,60")):
    plan = jp.plan_cannon(graph_from_spec(spec), q, cache=jp.PlanCache()).plan
    st = {{k: jnp.asarray(v) for k, v in plan.device_arrays().items()}}
    out[f"per/cannon/{{q}}/{{spec}}"] = per(
        build_cannon_fn(plan, mesh((q, q)), reduce_global=False), st, (q, q))
for hub in (False, True):
    plan = jp.plan_cannon(g, 2, hub_split={hub!r} if hub else False,
                          cache=jp.PlanCache()).plan
    st = {{k: jnp.asarray(v) for k, v in
          pod_stack_arrays(plan.device_arrays(), 2, 2).items()}}
    out[f"per/pods/{{hub}}"] = per(build_cannon_fn(
        plan, pods, pod_axis="pod", reduce_global=False), st, (2, 2, 2))
for spec, (r, c) in (({graph!r}, (2, 3)), ("star:64", (2, 4))):
    plan = jp.plan_summa(graph_from_spec(spec), r, c, cache=jp.PlanCache()).plan
    st = {{k: jnp.asarray(v) for k, v in plan.device_arrays().items()}}
    out[f"per/summa/{{spec}}"] = per(
        build_summa_fn(plan, mesh((r, c)), reduce_global=False), st, (r, c))
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(distributed_runner):
    """The reference's counts and partials: two subprocesses on nine host
    devices, run at once (the Cannon sweep, and the rest)."""
    from concurrent.futures import ThreadPoolExecutor

    fields = dict(graph=GRAPH, methods=METHODS, knobs=KNOBS, hub=HUB_C,
                  batch=BATCH, deltas=DELTAS, pod_cases=POD_CASES,
                  summa_cases=SUMMA_CASES, ring_cases=RING_CASES)
    with ThreadPoolExecutor(2) as pool:
        outs = list(pool.map(
            lambda code: distributed_runner(code.format(**fields), 9,
                                            timeout=300),
            (_REFERENCE_SWEEP, _REFERENCE_REST)))
    merged = {}
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
        merged.update(json.loads(line[len("RESULT"):]))
    return merged


# ----------------------------------------------------------------------
# counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("q", [1, 2, 3])
def test_cannon_on_a_mesh(ref, q, method, knob):
    got, one = _both(GRAPH, _cpu_mesh(q), method=method, **KNOBS[knob])
    assert got == one == ref[f"cannon/{q}/{method}/{knob}"]


@pytest.mark.parametrize("method,strategy", POD_CASES)
def test_cannon_with_two_pods_on_a_mesh(ref, method, strategy):
    got, one = _both(GRAPH, _cpu_mesh(2, npods=2), method=method,
                     reduce_strategy=strategy)
    assert got == one == ref[f"pods/{method}/{strategy}"]


def test_hub_split_on_a_mesh(ref):
    got, one = _both(GRAPH, _cpu_mesh(2), hub_split=HUB_C)
    assert got == one == ref["hub"]


@pytest.mark.parametrize("broadcast,method", SUMMA_CASES)
def test_summa_on_a_mesh(ref, broadcast, method):
    got, one = _both(GRAPH, _rect_mesh(2, 3), schedule="summa",
                     broadcast=broadcast, method=method)
    assert got == one == ref[f"summa/{broadcast}/{method}"]


@pytest.mark.parametrize("q,method", RING_CASES)
def test_ring_on_a_mesh(ref, q, method):
    got, one = _both(GRAPH, _cpu_mesh(q), schedule="oned", method=method)
    assert got == one == ref[f"ring/{q * q}/{method}"]


def test_traps_on_a_mesh(ref):
    """Step indices stay original under compaction: ``cliques:3,60`` at
    q = 3 elides steps, ``star:64`` on SUMMA (2, 4) elides rounds."""
    got, one = _both("cliques:3,60", _cpu_mesh(3), method="fused")
    assert got == one == ref["cliques"]
    got, one = _both("star:64", _rect_mesh(2, 4), schedule="summa",
                     method="fused")
    assert got == one == ref["star"]


@pytest.mark.parametrize("schedule", ["cannon", "summa", "oned"])
def test_batched_count_on_a_mesh(ref, schedule):
    graphs = [_g(s) for s in BATCH]
    mesh = _rect_mesh(2, 3) if schedule == "summa" else _cpu_mesh(2)
    got = tc.count_triangles_many(graphs, mesh, schedule=schedule,
                                  cache=tp.PlanCache())
    one = tc.count_triangles_many(graphs, grid=tuple(mesh.shape),
                                  schedule=schedule, device="cpu",
                                  cache=tp.PlanCache())
    assert got.triangles == one.triangles == [
        tc.triangle_count_oracle(g) for g in graphs]
    if schedule == "cannon":
        assert got.triangles == ref["many"]


def test_three_delta_rounds_on_a_mesh(ref):
    """The derived artifact restages per position: an array the delta
    changed keeps the parent's block wherever that position's slice is
    unchanged, and nothing is written into the parent's tensors."""
    mesh, cache = _cpu_mesh(2), tp.PlanCache()
    art, cur, got, kept = None, _g(GRAPH), [], 0
    for k, seed in DELTAS:
        d = tp.EdgeDelta.random_flips(cur, k, seed=seed)
        prev = None if art is None else {
            n: dict(a.blocks) for n, a in art.staged(mesh).items()}
        snap = None if prev is None else {
            (n, p): b.clone() for n, bl in prev.items() for p, b in bl.items()}
        res = tc.count_triangles_delta(cur, d, mesh, artifact=art,
                                       method="fused", cache=cache)
        if prev is not None:
            new = res.artifact.staged(mesh)
            kept += sum(new[n].blocks[p] is b for n, bl in prev.items()
                        if n in new for p, b in bl.items())
            assert all(torch.equal(prev[n][p], b) for (n, p), b in snap.items())
        got.append(res.triangles)
        art, cur = res.artifact, d.apply_to(cur)
        assert res.triangles == tc.triangle_count_oracle(cur)
    assert got == ref["delta"]
    assert kept > 0


# ----------------------------------------------------------------------
# per-position partials
# ----------------------------------------------------------------------
@pytest.mark.parametrize("q,spec", [(2, GRAPH), (3, GRAPH),
                                    (3, "cliques:3,60")])
def test_cannon_partials_on_a_mesh(ref, q, spec):
    art = tp.plan_cannon(_g(spec), q, cache=tp.PlanCache())
    mesh = _cpu_mesh(q)
    one = build_cannon_fn(art.plan, reduce_global=False)(**art.staged("cpu"))
    got = build_cannon_fn(art.plan, reduce_global=False, mesh=mesh)(
        **art.staged(mesh))
    assert got.shape == (q, q) and got.dtype == torch.int64
    assert got.tolist() == one.tolist() == ref[f"per/cannon/{q}/{spec}"]


@pytest.mark.parametrize("hub", [False, True])
def test_pod_partials_on_a_mesh(ref, hub):
    art = tp.plan_cannon(_g(GRAPH), 2, hub_split=HUB_C if hub else False,
                         cache=tp.PlanCache())
    mesh = _cpu_mesh(2, npods=2)
    stacked = pod_stack_arrays(art.plan.device_arrays(), 2, 2)
    one = build_cannon_fn(art.plan, reduce_global=False, npods=2)(
        **stage_arrays(stacked, "cpu"))
    staged = art.staged(mesh)
    got = build_cannon_fn(art.plan, reduce_global=False, npods=2,
                          mesh=mesh)(**staged)
    assert got.tolist() == one.tolist() == ref[f"per/pods/{hub}"]
    # pod t's replica of the task lists is its own tensor
    assert staged["m_ti"][0, 1, 1] is not staged["m_ti"][1, 1, 1]
    assert torch.equal(staged["m_ti"][0, 1, 1], staged["m_ti"][1, 1, 1])


@pytest.mark.parametrize("spec,grid", [(GRAPH, (2, 3)), ("star:64", (2, 4))])
def test_summa_partials_on_a_mesh(ref, spec, grid):
    art = tp.plan_summa(_g(spec), *grid, cache=tp.PlanCache())
    mesh = _rect_mesh(*grid)
    one = build_summa_fn(art.plan, reduce_global=False)(**art.staged("cpu"))
    for b in ("onehot", "chain"):
        got = build_summa_fn(art.plan, reduce_global=False, broadcast=b,
                             mesh=mesh)(**art.staged(mesh))
        assert got.tolist() == one.tolist() == ref[f"per/summa/{spec}"]


def test_ring_partials_on_a_mesh():
    art = tp.plan_oned(_g(GRAPH), 4, cache=tp.PlanCache())
    ring = _cpu_mesh(2).reshaped((4,), ("flat",))
    one = build_oned_fn(art.plan, reduce_global=False)(**art.staged("cpu"))
    got = build_oned_fn(art.plan, reduce_global=False, mesh=ring)(
        **art.staged(ring))
    assert got.tolist() == one.tolist()


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------
def test_make_grid_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        tc.make_grid_mesh(3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="need 8 devices"):
        tc.make_grid_mesh(2, npods=2, devices=["cpu"] * 4)
    m = tc.make_grid_mesh(2, npods=2, devices=["cpu"] * 9)
    assert m.shape == (2, 2, 2) and m.axis_names == ("pod", "data", "model")
    assert m.size == 8 and isinstance(m, DeviceMesh)


def test_make_grid_mesh_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.make_grid_mesh(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        tc.make_grid_mesh(2)


def test_mesh_refuses_a_device_and_a_disagreeing_grid():
    g, mesh = _g("named:karate"), _cpu_mesh(2)
    with pytest.raises(ValueError, match="mesh or device"):
        tc.count_triangles(g, mesh, device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        tc.count_triangles(g, mesh, q=3)
    with pytest.raises(ValueError, match="square"):
        tc.count_triangles(g, _rect_mesh(2, 3))
    art = tp.plan_cannon(g, 2, cache=tp.PlanCache())
    fn = build_cannon_fn(art.plan, mesh=mesh)
    with pytest.raises(ValueError, match="built for a mesh"):
        fn(**art.staged("cpu"))
    with pytest.raises(ValueError, match="another mesh"):
        fn(**art.staged(_cpu_mesh(2).reshaped((2, 2), ("x", "y"))))
    with pytest.raises(ValueError, match="grid"):
        build_cannon_fn(art.plan, mesh=_cpu_mesh(3))


# ----------------------------------------------------------------------
# placement, seen through the dispatcher
# ----------------------------------------------------------------------
class _Placement(TorchDispatchMode):
    """Labels tensors with the grid positions whose data they hold and
    checks each op outside a move phase against them."""

    def __init__(self):
        super().__init__()
        self.labels = WeakTensorKeyDictionary()
        self.phase = None
        self.copied = 0
        self.mixed = Counter()
        self.ops = 0

    def label(self, array: "engine.MeshArray"):
        for pos, block in array.blocks.items():
            self.labels[block] = frozenset([pos])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        seen = frozenset().union(*(self.labels.get(t, frozenset())
                                   for t in ins))
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if self.phase is None:
            self.ops += 1
            if len(seen) > 1:
                self.mixed[name] += 1
        elif name == "copy_":
            self.copied += args[1].numel() * args[1].element_size()
        if seen:
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            if name.endswith("_") and ins:
                outs.append(ins[0])
            for t in outs:
                self.labels[t] = self.labels.get(t, frozenset()) | seen
        return out


@pytest.fixture
def placement(monkeypatch):
    """A :class:`_Placement` mode with the engine's move phases wrapped:
    inside them ops may mix positions and their copies are counted; their
    results are labelled with the positions that received them."""
    mode = _Placement()

    def moving(phase, fn, relabel):
        def run(*a, **k):
            outer, mode.phase = mode.phase, phase
            try:
                out = fn(*a, **k)
            finally:
                mode.phase = outer
            relabel(out)
            return out
        return run

    def relabel_arrays(out):
        for t in out:
            mode.label(t)

    def relabel_result(out):
        mode.labels[out] = frozenset([(0,)])

    monkeypatch.setattr(engine, "tree_ppermute", moving(
        "shift", engine.tree_ppermute, relabel_arrays))
    select = engine.SummaCSRStore.select
    monkeypatch.setattr(engine.SummaCSRStore, "select", lambda self, *a: moving(
        "broadcast", lambda: select(self, *a), relabel_arrays)())
    apply = engine.Reduction._apply_mesh
    monkeypatch.setattr(engine.Reduction, "_apply_mesh", lambda self, per: moving(
        "reduce", lambda: apply(self, per), relabel_result)())
    return mode


def _placement_case(name):
    """``(graph, mesh, build(mesh), stage(mesh))`` of one case; ``None``
    as the mesh builds and stages the one-device counterpart."""
    g = _g(GRAPH)
    if name.startswith("summa"):
        art = tp.plan_summa(g, 2, 3, autotune="fused", cache=tp.PlanCache())
        return g, _rect_mesh(2, 3), lambda m: build_summa_fn(
            art.plan, method="fused", broadcast=name.split("-")[1],
            mesh=m), lambda m: art.staged(m or "cpu")
    if name == "ring":
        art = tp.plan_oned(g, 4, cache=tp.PlanCache())
        return g, _cpu_mesh(2).reshaped((4,), ("flat",)), lambda m: (
            build_oned_fn(art.plan, mesh=m)), lambda m: art.staged(m or "cpu")
    if name == "tile":
        art = tp.plan_cannon(g, 2, keep_blocks=True, cache=tp.PlanCache())
        tiles = build_tile_plan(art.plan)
        return g, _cpu_mesh(2), lambda m: build_cannon_tile_fn(
            art.plan, mesh=m), lambda m: stage_tile_plan(tiles, m or "cpu")
    npods = 2 if name == "cannon-pods" else 1
    art = tp.plan_cannon(g, 2, autotune="fused", hub_split=HUB_C,
                         cache=tp.PlanCache())

    def stage(m):
        if m is not None:
            return art.staged(m)
        if npods == 1:
            return art.staged("cpu")
        return stage_arrays(pod_stack_arrays(art.plan.device_arrays(),
                                             npods, 2), "cpu")

    return g, _cpu_mesh(2, npods=npods), lambda m: build_cannon_fn(
        art.plan, method="fused", npods=npods,
        reduce_strategy="tree" if npods > 1 else "flat", mesh=m), stage


@pytest.mark.parametrize("name", ["cannon", "cannon-pods", "summa-onehot",
                                  "summa-chain", "ring", "tile"])
def test_counts_read_one_position_and_moves_equal_the_tally(placement, name):
    """Outside a shift, a broadcast and the reduce no op reads two
    positions' data; the bytes copied inside them are the tally's; and the
    shift and reduce tallies are the one-device engine's."""
    g, mesh, build, stage = _placement_case(name)
    staged = stage(mesh)
    for a in staged.values():
        placement.label(a)
    with engine.tally_moved_bytes() as tally, placement:
        got = build(mesh)(**staged)
    with engine.tally_moved_bytes() as one_tally:
        one = build(None)(**stage(None))
    assert int(got) == int(one) == tc.triangle_count_oracle(g)
    assert placement.ops > 0 and not placement.mixed, placement.mixed
    moved = tally["shift"] + tally["broadcast"] + tally["reduce"]
    assert placement.copied == moved > 0
    assert tally["shift"] == one_tally["shift"]
    assert tally["reduce"] == one_tally["reduce"]
    if name.startswith("summa"):
        assert tally["broadcast"] > 0 == one_tally["broadcast"]


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mesh_path_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s ``mesh_path`` at scale 10 with every position on
    the CPU, the entry points' device resolved to the CPU and the fused
    kernel's launch counter bumped where the engine would launch it (on
    the CPU the wrapper takes its plain route and counts nothing)."""
    import repro_torch.core.api as api
    import repro_torch.kernels.tc_fused as tf
    from repro_torch.kernels.tc_fused import tc_fused as kmod

    chip_smoke = _chip_smoke()
    cpu = torch.device("cpu")
    monkeypatch.setattr(api, "resolve_device", lambda device=None: cpu)
    monkeypatch.setattr(chip_smoke, "mesh_cards", lambda n: [cpu] * n)
    plain = tf.count_pair_fused

    def counted(*args, **kw):
        kmod.LAUNCHES += 1
        return plain(*args, **kw)

    monkeypatch.setattr(tf, "count_pair_fused", counted)
    g = tc.rmat(10, chip_smoke.EDGE_FACTOR, seed=1)
    oracle = chip_smoke.scipy_triangle_oracle(g.n, g.edges)
    q = chip_smoke.GRID
    tc.count_triangles(g, q=q, method="fused")  # the main path's plan
    for sched, grid in (("summa", chip_smoke.MESH_SUMMA), ("oned", (q, q))):
        tc.count_triangles(g, grid=grid, schedule=sched, method="fused")
    chip_smoke.mesh_path(g, oracle, cpu, q, "rmat:10,16,1")
    out = capsys.readouterr().out
    (line,) = [json.loads(ln)["mesh_path"] for ln in out.splitlines()
               if ln.startswith('{"mesh_path"')]
    assert line["ok"] and line["triangles"] == oracle
    assert line["kernel_launches"] == line["device_steps_counted"] > 0
    assert line["cards"] == ["cpu"] and line["positions"] == q * q
    assert line["moved_bytes_mesh"]["shift"] == line[
        "moved_bytes_one_device"]["shift"] > 0
    assert line["summa"]["grid"] == list(chip_smoke.MESH_SUMMA)
    assert line["oned"]["grid"] == [q * q]
    assert line["pods_tree"]["grid"] == [chip_smoke.MESH_PODS, q, q]
    for name in ("summa", "oned", "pods_tree"):
        assert line[name]["triangles"] == oracle
    # both Cannon bodies: warm counts, and each traced count's copies (on
    # the CPU not traced: the issue log's lanes)
    assert len(line["warm_count_seconds_mesh_single"]) == chip_smoke.MESH_WARM
    for body in ("double", "single"):
        times = line["engine_ms"][body]
        assert len(times["issue"]) == chip_smoke.MESH_ENGINE_REPS
        assert all(0 < a <= b for a, b in zip(times["issue"], times["total"]))
    for body in ("double", "single"):
        got = line["overlap"][body]
        assert got["trace"] == "not measured" and got["copy_lanes"] == ["copy"]
        assert got["shift_copies_issued"] == 2 * q * q * (q - 1)
    # what each card holds: the walk's books; nothing measured off the
    # card, and no cap with one card
    (memory,) = [json.loads(ln)["mesh_memory"] for ln in out.splitlines()
                 if ln.startswith('{"mesh_memory"')]
    assert memory["ok"] and memory["capped"] == "needs 2+ cards"
    assert memory["one_device"]["triangles"] == oracle
    assert memory["one_device"]["measured_peak"] is None
    for body, ring in (("double", 3), ("single", 2)):
        card = memory[body]["per_card"]["cpu"]
        assert memory[body]["triangles"] == oracle
        assert card["positions"] == q * q and card["measured_peak"] is None
        assert card["ring"] == ring * card["payload"] > 0
        assert card["walk_peak"] > card["staged"] + card["payload"] + card[
            "ring"]


@pytest.mark.gpu
def test_cannon_over_four_cards():
    """Cannon q = 2 with one card a position: every shift is a peer copy
    and the fused kernel launches on every card.  ``python3 chip_smoke.py``
    runs the mesh on the cards there are."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices: the mesh puts one position on "
                    "each card")
    from repro_torch.kernels.tc_fused import tc_fused

    g = _g("rmat:12,8,1")
    mesh = tc.make_grid_mesh(2)
    assert len(set(mesh.devices)) == 4
    before = tc_fused.launch_count()
    res = tc.count_triangles(g, mesh, method="fused", cache=tp.PlanCache())
    assert tc_fused.launch_count() > before
    assert res.triangles == tc.triangle_count_oracle(g)
    art = res.artifact
    got = build_cannon_fn(art.plan, method="fused", reduce_global=False,
                          mesh=mesh)(**art.staged(mesh))
    one = build_cannon_fn(art.plan, method="fused", reduce_global=False)(
        **art.staged("cuda:0"))
    assert got.device == mesh.first and got.tolist() == one.tolist()
