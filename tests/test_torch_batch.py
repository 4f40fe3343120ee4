"""The port's batched front end (``count_triangles_many``) against the JAX
package's.

A batch is host-padded numpy stacked on a leading dimension, so parity is
identity: the same stacked arrays byte for byte and the same
``padding_overhead`` float; the per-graph counts are integers equal to
``count_triangles`` graph by graph and to the oracle.  The reference runs
in process at q = 1 here; its 4-device batch is held against the port in
``tests/test_torch_hubsplit.py`` (the one multi-device subprocess).
"""
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
from repro.pipeline import batch as jb
from repro_torch.pipeline import batch as tb

SETS = {
    "mixed": ["named:karate", "rmat:9,8,1", "cliques:3,60", "star:64"],
    "heavy": ["powerlaw:600,2.2", "powerlaw:600,1.8", "rmat:10,8,2"],
    "tiny": ["named:bull", "er:24,0", "named:k4"],
}
RUNS = [("cannon", "search"), ("cannon", "global"), ("cannon", "search2"),
        ("summa", "search"), ("summa", "global"), ("oned", "search"),
        ("oned", "global")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graphs(core, name):
    return [core.graph_from_spec(s) for s in SETS[name]]


def _oracles(name):
    return [tc.triangle_count_oracle(g) for g in _graphs(tc, name)]


# Cannon runs square grids only
GRID_RUNS = [(grid, schedule, method)
             for grid in [(1, 1), (2, 2), (2, 3), (3, 3)]
             for schedule, method in RUNS
             if schedule != "cannon" or grid[0] == grid[1]]


@pytest.mark.parametrize("grid,schedule,method", GRID_RUNS)
@pytest.mark.parametrize("name", list(SETS))
def test_batch_counts_equal_per_graph_counts(name, grid, schedule, method):
    graphs = _graphs(tc, name)
    cache = tp.PlanCache()
    res = rt.count_triangles_many(graphs, grid=grid, schedule=schedule,
                                  method=method, device="cpu", cache=cache)
    per = [rt.count_triangles(g, grid=grid, schedule=schedule,
                              method=method, device="cpu",
                              cache=cache).triangles for g in graphs]
    assert res.triangles == per == _oracles(name)
    assert all(isinstance(t, int) for t in res.triangles)
    assert res.batch == len(graphs) and res.method == method
    assert res.grid == ((int(np.prod(grid)),) if schedule == "oned"
                        else grid)
    assert res.padding_overhead >= 0.0


@pytest.mark.parametrize("schedule,method", RUNS)
@pytest.mark.parametrize("name", list(SETS))
def test_batch_matches_the_reference_at_q1(name, schedule, method):
    """Counts, ``padding_overhead`` (the same float) and every stacked
    array byte for byte."""
    from repro.core.api import make_grid_mesh

    want = jb.count_triangles_many(_graphs(jc, name), schedule=schedule,
                                   method=method, cache=jp.PlanCache())
    got = rt.count_triangles_many(_graphs(tc, name), schedule=schedule,
                                  method=method, device="cpu",
                                  cache=tp.PlanCache())
    assert got.triangles == want.triangles == _oracles(name)
    assert got.padding_overhead == want.padding_overhead
    assert got.grid == want.grid
    jprog = jb._build_batch_program(
        _graphs(jc, name), make_grid_mesh(1), q=1, schedule=schedule,
        method=method, chunk=512, reorder=True, cyclic_p=None,
        probe_shorter=True, count_dtype=np.int32, cache=jp.PlanCache())
    tprog = tb._build_batch_program(
        _graphs(tc, name), grid=(1, 1), schedule=schedule, method=method,
        chunk=512, reorder=True, cyclic_p=None, probe_shorter=True,
        device=torch.device("cpu"), cache=tp.PlanCache())
    assert list(tprog.staged) == list(jprog.staged)
    for k, v in jprog.staged.items():
        v = np.asarray(v)
        t = tprog.staged[k].numpy()
        assert t.dtype == v.dtype and t.shape == v.shape, k
        assert t.tobytes() == v.tobytes(), k


@pytest.mark.parametrize("chunk", [1, 7, 512, 8192])
@pytest.mark.parametrize("schedule", ["cannon", "summa", "oned"])
def test_batch_count_does_not_depend_on_the_chunk(schedule, chunk):
    res = rt.count_triangles_many(_graphs(tc, "heavy"), q=2,
                                  schedule=schedule, chunk=chunk,
                                  device="cpu", cache=tp.PlanCache())
    assert res.triangles == _oracles("heavy")


def test_batch_lifts_graphs_to_the_largest_vertex_count():
    graphs = [tc.named_graph("k4"), tc.rmat(9, 8, seed=3)]
    prog = tb._build_batch_program(
        graphs, grid=(2, 2), schedule="cannon", method="search", chunk=64,
        reorder=True, cyclic_p=None, probe_shorter=True,
        device=torch.device("cpu"), cache=tp.PlanCache())
    assert prog.staged["a_indptr"].shape[:3] == (2, 2, 2)
    assert prog.staged["a_indptr"].shape[-1] == 512 // 2 + 1
    assert int(prog.fn(**prog.staged)[0]) == 4


def test_program_cache_hits_on_repeat():
    graphs = _graphs(tc, "mixed")
    cache = tp.PlanCache()
    a = rt.count_triangles_many(graphs, q=2, device="cpu", cache=cache)
    b = rt.count_triangles_many(graphs, q=2, device="cpu", cache=cache)
    assert not a.cache_hit and b.cache_hit
    assert a.triangles == b.triangles == _oracles("mixed")
    c = rt.count_triangles_many(graphs, q=2, chunk=64, device="cpu",
                                cache=cache)
    d = rt.count_triangles_many(graphs[::-1], q=2, device="cpu", cache=cache)
    assert not c.cache_hit and not d.cache_hit
    assert d.triangles == _oracles("mixed")[::-1]
    e = rt.count_triangles_many(graphs, q=2, device="cpu",
                                cache=tp.PlanCache(maxsize=0))
    assert not e.cache_hit


def test_batch_front_end_is_exported():
    assert tc.count_triangles_many is not None
    assert tp.count_triangles_many is tb.count_triangles_many
    assert rt.count_triangles_many is tc.count_triangles_many
    assert tp.ManyResult is tb.ManyResult


# ----------------------------------------------------------------------
# refusals: the reference's
# ----------------------------------------------------------------------
def _message(call, exc=ValueError):
    with pytest.raises(exc) as e:
        call()
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(method="fused"), dict(method="tile"), dict(method="dense"),
    dict(method="auto"), dict(method="search2", schedule="summa"),
    dict(method="search2", schedule="oned"), dict(schedule="hypercube"),
], ids=["fused", "tile", "dense", "auto", "summa-search2", "oned-search2",
        "schedule"])
def test_batch_refusals_match_the_reference(kw):
    want = _message(lambda: jb.count_triangles_many(
        _graphs(jc, "tiny"), cache=jp.PlanCache(), **kw))
    got = _message(lambda: rt.count_triangles_many(
        _graphs(tc, "tiny"), device="cpu", cache=tp.PlanCache(), **kw))
    assert got == want


def test_batch_refuses_an_empty_list_and_a_rectangular_cannon_grid():
    with pytest.raises(ValueError, match="at least one graph"):
        rt.count_triangles_many([], device="cpu")
    with pytest.raises(ValueError, match="square"):
        rt.count_triangles_many(_graphs(tc, "tiny"), grid=(2, 3),
                                device="cpu")


def test_batched_builders_refuse_what_the_reference_refuses():
    from repro.core.plan import resolve_broadcast as j_bcast
    from repro.core.plan import resolve_compact_steps as j_compact
    from repro_torch.core.plan import resolve_broadcast, resolve_compact_steps

    ja = jp.plan_summa(jc.graph_from_spec("star:64"), 2, 4,
                       cache=jp.PlanCache())
    ta = tp.plan_summa(tc.graph_from_spec("star:64"), 2, 4,
                       cache=tp.PlanCache())
    assert resolve_broadcast(ta, "auto", batched=True) == j_bcast(
        ja, "auto", batched=True) == "onehot"
    assert resolve_broadcast(ta, None) == j_bcast(ja, None) == "chain"
    assert _message(lambda: resolve_broadcast(ta, "chain", batched=True)) \
        == _message(lambda: j_bcast(ja, "chain", batched=True))
    assert _message(lambda: resolve_compact_steps(ta, True, batched=True)) \
        == _message(lambda: j_compact(ja, True, batched=True))
    assert resolve_compact_steps(ta, None, batched=True) is None
    assert resolve_compact_steps(ta, None) == (3,)


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def _cli(*args):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tc_run", *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_graphs_verify_every_graph():
    proc = _cli("--graphs", "named:karate,rmat:9,8,1,cliques:3,60",
                "--grid", "2", "--schedule", "oned", "--repeat", "2",
                "--device", "cpu", "--verify", "--json")
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["graphs"] == ["named:karate", "rmat:9,8,1", "cliques:3,60"]
    assert rep["correct"] and rep["triangles"] == rep["expected"]
    assert rep["batch"] == 3 and rep["grid"] == [4] and rep["cache_hit"]
    assert rep["padding_overhead"] > 0


@pytest.mark.parametrize("extra,needle", [
    (["--rebalance", "2"], "--rebalance is not supported with --graphs"),
    (["--hub-split"], "--hub-split is a single-graph pipeline stage"),
    (["--method", "fused"], "--method fused is not supported with --graphs"),
], ids=["rebalance", "hub-split", "fused"])
def test_cli_graphs_refusals(extra, needle):
    proc = _cli("--graphs", "named:karate;named:bull", "--device", "cpu",
                *extra)
    assert proc.returncode != 0 and needle in proc.stderr
