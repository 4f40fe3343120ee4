"""The triangle count's memory per card on a device mesh: the walk's books.

``roofline.walk_engine`` over a mesh count's staged ``MeshArray`` s keeps
each card's books (``EngineWalk.cards``).  On CPU meshes every position
shares one device, so the tests put each position on a card of its own
(``cards=lambda pos: pos``) and hold the books to what the engine really
made: each position's staged blocks, the packed blobs and the receive
buffers the body allocates, summed over the positions the one-device
staging.  A sampled walk of an analytic plan equals a full one on a mesh
too; the dry run's rows keep every field and gain ``card_bytes`` /
``card_fits``; and a position's staged bytes on a 2 x 2 mesh equal XLA's
``argument_size_in_bytes`` for the JAX package's sharded Cannon program
(one subprocess on 4 host devices).  The whole file takes about 20 s in
one process.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro_torch.core import engine
from repro_torch.core.cannon import (build_cannon_fn, cannon_in_specs,
                                     pod_stack_arrays)
from repro_torch.core.onedim import build_oned_fn
from repro_torch.core.plan import analytic_plan
from repro_torch.core.summa import build_summa_fn
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import (DeviceMesh, make_mesh_for,
                                     make_production_mesh)
from repro_torch.pipeline.artifact import stage_arrays

GRAPH = "rmat:9,8,3"
SMALL = tcfg.TCGraphConfig("small", 1000, 8000, 0, 40)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return tc.graph_from_spec(GRAPH)


def _cpu_mesh(q, npods=1):
    return tc.make_grid_mesh(q, npods=npods, devices=["cpu"] * (q * q * npods))


def _nbytes(t):
    return t.numel() * t.element_size()


def _case(g, name, q):
    """``(fn, mesh arrays, one-device bytes staged, bytes of one ring
    buffer a position, ring buffers)`` of one case: Cannon's two bodies
    (uncompacted: ``q - 1`` shifts), 2 pods (``q // 2 - 1`` shifts), SUMMA
    ``q x (q + 1)`` (no shift) and the ring ``p = q * q`` (``p - 1``)."""
    if name == "summa":
        art = tp.plan_summa(g, q, q + 1, autotune="fused", cache=tp.PlanCache())
        mesh = make_mesh_for((q, q + 1), ("data", "model"),
                             devices=["cpu"] * (q * (q + 1)))
        fn = build_summa_fn(art.plan, method="fused", mesh=mesh)
        staged = art.staged(mesh)
        one = sum(map(_nbytes, art.staged("cpu").values()))
        return fn, staged, one, 0, 0
    if name == "ring":
        p = q * q
        art = tp.plan_oned(g, p, cache=tp.PlanCache())
        mesh = _cpu_mesh(q).reshaped((p,), ("flat",))
        fn = build_oned_fn(art.plan, mesh=mesh, compact=False)
        staged = art.staged(mesh)
        blob = sum(_nbytes(staged[k].blocks[(0,)])
                   for k in ("indptr", "indices"))
        one = sum(map(_nbytes, art.staged("cpu").values()))
        return fn, staged, one, blob, min(2, p - 1)
    npods = 2 if name == "pods" else 1
    art = tp.plan_cannon(g, q, autotune="fused", cache=tp.PlanCache())
    mesh = _cpu_mesh(q, npods)
    fn = build_cannon_fn(art.plan, method="fused", mesh=mesh, npods=npods,
                         double_buffer=name != "single", compact=False,
                         reduce_strategy="tree" if npods > 1 else "flat")
    staged = art.staged(mesh)
    anywhere = next(iter(staged["a_indptr"].blocks))
    blob = sum(_nbytes(staged[k].blocks[anywhere])
               for k in ("a_indptr", "a_indices", "b_indptr", "b_indices"))
    if npods == 1:
        one = sum(map(_nbytes, art.staged("cpu").values()))
    else:  # the pods' stacked arrays, and a replica of the task lists a pod
        host = pod_stack_arrays(art.plan.device_arrays(), npods, q)
        specs = cannon_in_specs("data", "model", "pod")
        one = sum(_nbytes(t) * (npods if len(specs.get(k, ("pod",))) == 2
                                else 1)
                  for k, t in stage_arrays(host, "cpu").items())
    shifts = q // npods - 1
    return fn, staged, one, blob, min(3 if name != "single" else 2, shifts)


CASES = [(name, q) for q in (2, 3) for name in ("double", "single", "summa",
                                                "ring")] + [("pods", 2),
                                                            ("pods", 4)]


@pytest.mark.parametrize("name,q", CASES)
def test_each_positions_books_are_what_the_engine_made(graph, name, q):
    """Each position's staged bytes are its blocks' (summed over the
    positions: the one-device staging, the pods' replicated task lists
    once a pod), its payload the packed blobs, its receive buffers a ring
    of the body's length of blob-sized buffers, and its peak at least
    all of them; the walk's count is the real one."""
    fn, staged, one, blob, ring = _case(graph, name, q)
    walk = roofline.walk_engine(fn, staged, cards=lambda pos: pos)
    mesh = next(iter(staged.values())).mesh
    assert set(walk.cards) == set(np.ndindex(*mesh.shape))
    for pos, card in walk.cards.items():
        assert card.positions == (pos,)
        assert card.staged_bytes == sum(_nbytes(t.blocks[pos])
                                        for t in staged.values())
        assert card.ring_bytes == ring * blob
        assert card.payload_bytes == blob
        assert card.peak_bytes >= (card.staged_bytes + card.payload_bytes
                                   + card.ring_bytes)
    assert sum(c.staged_bytes for c in walk.cards.values()) == one
    assert walk.staged_bytes == one
    assert walk.args_per_device == max(c.staged_bytes
                                       for c in walk.cards.values())
    assert int(fn(**staged)) == tc.triangle_count_oracle(graph)


def test_a_card_of_several_positions_holds_their_sum(graph):
    """Two positions a card: the staged, payload and ring books add, and
    the card's peak lies between its positions' largest and their sum."""
    fn, staged, _, _, _ = _case(graph, "double", 2)
    alone = roofline.walk_engine(fn, staged, cards=lambda pos: pos).cards
    paired = roofline.walk_engine(fn, staged, cards=lambda pos: pos[0]).cards
    for x in range(2):
        mine = [alone[(x, y)] for y in range(2)]
        card = paired[x]
        assert card.positions == ((x, 0), (x, 1))
        for f in ("staged_bytes", "payload_bytes", "ring_bytes"):
            assert getattr(card, f) == sum(getattr(c, f) for c in mine)
        assert max(c.peak_bytes for c in mine) < card.peak_bytes <= sum(
            c.peak_bytes for c in mine)
    # by default a card is the device: every position of a CPU mesh
    (cpu,) = roofline.walk_engine(fn, staged).cards.values()
    assert len(cpu.positions) == 4


def test_a_mesh_count_stages_nothing_on_the_first_device(graph):
    """``count_triangles`` on a mesh puts the mesh's first device in the
    run's context (``device = mesh.first``); the artifact holds only the
    mesh's staging afterwards, never a whole one-device copy, on every
    schedule, with pods and with a hub split."""
    mesh = _cpu_mesh(2)
    for kw in (dict(), dict(double_buffer=False), dict(schedule="oned"),
               dict(hub_split=2.0), dict(method="search2")):
        res = tc.count_triangles(graph, mesh, cache=tp.PlanCache(),
                                 **dict(dict(method="fused"), **kw))
        assert res.triangles == tc.triangle_count_oracle(graph)
        assert res.artifact.staged_if_any("cpu") is None, kw
    pods = _cpu_mesh(2, npods=2)
    res = tc.count_triangles(graph, pods, method="fused",
                             reduce_strategy="tree", cache=tp.PlanCache())
    assert res.artifact.staged_if_any("cpu") is None
    staged = res.artifact.staged(pods)
    # A and B split over the pod axis: pod t's block is the plan's,
    # rolled to skew offset t
    host = res.artifact.plan.device_arrays()["a_indices"]
    for t in range(2):
        np.testing.assert_array_equal(
            staged["a_indices"].blocks[(t, 0, 0)].numpy(), host[0, t % 2])
    summa = make_mesh_for((2, 3), ("data", "model"), devices=["cpu"] * 6)
    res = tc.count_triangles(graph, summa, schedule="summa", method="fused",
                             cache=tp.PlanCache())
    assert res.artifact.staged_if_any("cpu") is None


def test_a_walk_places_every_tensor_or_refuses():
    """A tensor the engine makes outside ``placed_at`` from two positions'
    data has no position: the walk refuses it by op name; a position's
    tensor on another device than the position's is refused too."""
    mesh = _cpu_mesh(2)
    a = engine.MeshArray(mesh, {pos: torch.zeros(3) for pos in
                                np.ndindex(2, 2)})
    walk = roofline._Walk(None, mesh=mesh,
                          card_of={p: p for p in np.ndindex(2, 2)})
    for pos, b in a.blocks.items():
        walk.track(b, place=pos)
    with walk, pytest.raises(ValueError, match="aten.add"):
        a.blocks[(0, 0)] + a.blocks[(1, 1)]
    with walk:
        with engine.placed_at((1, 0)):
            a.blocks[(0, 0)] + a.blocks[(1, 1)]
        a.blocks[(0, 1)] * 2  # one position's data
    # each result was charged to its position while it lived, then freed
    assert walk.card_live[(1, 0)] == walk.card_live[(0, 1)] == 12
    assert walk.card_peak[(1, 0)] == walk.card_peak[(0, 1)] == 2 * 12
    mixed = DeviceMesh((2,), ("flat",), ("cpu", "meta"))
    walk = roofline._Walk(None, mesh=mixed, card_of={(0,): 0, (1,): 1})
    with pytest.raises(ValueError, match="lies on cpu"):
        walk.track(torch.zeros(1), place=(1,))


# ----------------------------------------------------------------------
# the sampled walk on a mesh, and the dry run's rows
# ----------------------------------------------------------------------
def _on_cpu(arrays):
    """Meta mesh arrays as zero blocks on a CPU mesh of the same shape."""
    meta = next(iter(arrays.values())).mesh
    mesh = DeviceMesh(meta.shape, meta.axis_names, ("cpu",) * meta.size)
    return {k: engine.MeshArray(mesh, {
        pos: torch.zeros(b.shape, dtype=b.dtype) for pos, b in v.blocks.items()})
        for k, v in arrays.items()}


@pytest.mark.parametrize("sched,shape", [
    ("cannon", (4, 4)), ("cannon2l", (4, 4)), ("cannon25d", (2, 4, 4)),
    ("oned", (4, 4))])
def test_the_sampled_mesh_walk_equals_a_full_one(sched, shape):
    """An analytic plan's cell at q = 4 over 16 positions (32 with pods,
    the ring p = 16), one a card: the sampled walk's every field and
    every card's books equal a full walk's over CPU zeros."""
    axes = ("pod", "data", "model")[-len(shape):]
    logical = make_mesh_for(shape, axes)
    cell = dryrun.tc_cell(SMALL, sched, logical.size, q=4)
    _, arrays = dryrun.cell_mesh(cell, sched, logical)
    sampled = roofline.walk_engine(cell.fn, arrays, sample=True,
                                   cards=lambda pos: pos)
    full = roofline.walk_engine(cell.fn, _on_cpu(arrays),
                                cards=lambda pos: pos)
    s, f = dataclasses.asdict(sampled), dataclasses.asdict(full)
    assert s.pop("sampled") and not f.pop("sampled")
    assert s == f
    # an analytic plan's positions are alike: one peak, the positions'
    # blocks the staged grid's split
    assert len({c.peak_bytes for c in sampled.cards.values()}) == 1
    staged = sum(_nbytes(t) for t in cell.arrays.values())
    if sched == "cannon25d":  # the task lists once a pod
        staged += sum(_nbytes(t) for k, t in cell.arrays.items()
                      if t.dim() > 0 and t.shape[0] != 2)
    assert sampled.staged_bytes == staged


@pytest.fixture(scope="module")
def rows():
    cells = [c for c in dryrun.all_cells() if c[0] == "tc-twitter"]
    return {c: dryrun.run_cell(*c) for c in cells}


def test_dry_run_rows_keep_their_fields_and_add_the_card(rows):
    """Every field a row had is the one-device walk's as before;
    ``card_bytes`` is the largest card's peak with one position a card,
    at most ``grid_bytes``, and ``card_fits`` holds it to the card."""
    for (graph, sched, mesh_name), row in rows.items():
        mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
        cfg = tcfg.get_config(graph)
        cell = dryrun.tc_cell(cfg, sched, mesh.size)
        old = roofline.roofline_from_walk(
            f"{graph}:{sched}:{mesh_name}",
            roofline.walk_engine(cell.fn, cell.arrays, sample=True),
            mesh_name=mesh_name, chips=mesh.size,
            model_flops=dryrun.useful_ops(cfg)).row()
        old.update(nshifts=cell.nshifts, nnz_pad_per_device=cell.plan.nnz_pad)
        mine = dict(row)
        card = mine.pop("card_bytes")
        assert mine.pop("card_fits") is (card <= roofline.card_memory_bytes())
        assert mine == old
        walk = dryrun.walk_cell_cards(cfg, sched, mesh)
        assert len(walk.cards) == mesh.size
        assert card == max(c.peak_bytes for c in walk.cards.values())
        assert row["memory_per_device"]["args"] <= card <= row["grid_bytes"]


def test_fewest_cards_is_the_smallest_even_spread_that_fits():
    """An analytic cell on a 4 x 4 grid: each even spread's largest card
    peak falls as the cards grow, and ``fewest_cards`` picks the first
    spread under the memory it is given (none: one position a card does
    not fit)."""
    mesh = make_mesh_for((4, 4), ("data", "model"))
    peaks = {n: max(c.peak_bytes for c in dryrun.walk_cell_cards(
        SMALL, "cannon", mesh, per_card=16 // n).cards.values())
        for n in (1, 2, 4, 8, 16)}
    assert [peaks[n] for n in sorted(peaks)] == sorted(peaks.values(),
                                                       reverse=True)
    assert len(set(peaks.values())) == 5
    for n in (2, 8):
        assert dryrun.fewest_cards(SMALL, "cannon", mesh,
                                   memory=peaks[n]) == (n, peaks[n])
    assert dryrun.fewest_cards(SMALL, "cannon", mesh,
                               memory=peaks[4] - 1) == (8, peaks[8])
    assert dryrun.fewest_cards(SMALL, "cannon", mesh,
                               memory=peaks[16] - 1) == (None, peaks[16])


# ----------------------------------------------------------------------
# a position's arguments against XLA's, on four host devices
# ----------------------------------------------------------------------
_XLA_ARGS = """
    import json
    from repro.core.api import get_schedule
    from repro.core.plan import analytic_plan
    from repro.launch.mesh import make_mesh_for

    mesh = make_mesh_for((2, 2), ("data", "model"))
    plan = analytic_plan(1000, 8000, 2, dmax_block=40, chunk=7)
    fn = get_schedule("cannon").build_fn(plan, mesh, method="search")
    ma = fn.lower(**plan.shape_structs()).compile().memory_analysis()
    print(json.dumps(ma.argument_size_in_bytes))
"""


def test_a_positions_args_equal_xlas_on_a_two_by_two_mesh(distributed_runner):
    """The JAX package's sharded Cannon program of a small analytic plan
    on a 2 x 2 host mesh takes ``argument_size_in_bytes`` a device; the
    port's walk of the same plan over a 2 x 2 mesh stages exactly that at
    every position."""
    out = distributed_runner(_XLA_ARGS, 4, timeout=300)
    xla = json.loads(out.strip().splitlines()[-1])
    plan = analytic_plan(1000, 8000, 2, dmax_block=40, chunk=7)
    fn = build_cannon_fn(plan, method="search").rebind(
        m_cnt=np.full((2, 2), plan.tmax, np.int32))
    cell = dryrun.TCCell(plan, fn, plan.shape_structs(device="meta"), 2)
    _, arrays = dryrun.cell_mesh(cell, "cannon",
                                 make_mesh_for((2, 2), ("data", "model")))
    walk = roofline.walk_engine(fn, arrays, sample=True,
                                cards=lambda pos: pos)
    assert walk.args_per_device == xla
    assert {c.staged_bytes for c in walk.cards.values()} == {xla}
    assert xla * 4 == sum(math.prod(t.shape) * t.element_size()
                          for t in plan.shape_structs(device="meta").values())
