"""The port's blob shifts, ``tc_run --opt`` / ``--time-split``, the bytes
the engine moves, and the examples, against the JAX package's.

* Blobs and uint16 length pairs: the port's ``pack_blob`` /
  ``unpack_blob`` and ``CSRStore._pack_lengths`` / ``_unpack_lengths``
  give, device by device, the reference's arrays (a row of 40,000 — a
  negative packed int32 — and an odd ``nb`` included); counts with and
  without blobs, compressed lengths, pods and staged keys equal the
  oracle at q = 1, 2, 3.
* ``tc_run --opt --json``: every field but the timings (and the port's
  ``device``) equal to the reference's on three graphs at grids 1–3, and
  the same refusals.
* ``--time-split``: its keys on every schedule; the count-only engines
  count exactly at one device.
* Shift bytes: one shift moves the same payload in both packages; the
  port tallies the whole grid (``ndev`` devices on one card) and runs the
  ``q - 1`` shifts a count needs, where the reference's scan body shifts
  at every step (one result discarded) and its double-buffered prologue
  adds one more — pinned below, ROADMAP.md Queue C.

The reference runs as its own tests run it: one subprocess on 9 host
devices for grids 2 and 3.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import repro.core.engine as jengine
import repro.core.blob as jblob
import repro_torch.core as tc
from repro_torch.core import blob as tblob
from repro_torch.core.cannon import build_cannon_fn, pod_stack_arrays
from repro_torch.core.engine import CSRStore
from repro_torch.core.onedim import build_oned_fn
from repro_torch.core.summa import build_summa_fn
from repro_torch.launch import tc_run
from repro_torch.launch.roofline import collective_phases
from repro_torch.pipeline import PlanCache, plan_cannon, plan_oned, plan_summa
from repro_torch.pipeline.artifact import stage_arrays

CPU = torch.device("cpu")
OPT_SPECS = ("named:karate", "rmat:10", "cliques:3,60")
BYTES_SPEC = "rmat:9"
TIMINGS = ("ppt_seconds", "tct_seconds", "device")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REFERENCE = """
import contextlib, io, json, sys
import jax
jax.config.update("jax_enable_x64", True)
from repro import compat
from repro.core import graph_from_spec
from repro.core.api import make_grid_mesh
from repro.core.cannon import build_cannon_fn
from repro.core.onedim import build_oned_fn
from repro.launch import tc_run
from repro.launch.roofline import collective_phases
from repro.pipeline import PlanCache, plan_cannon, plan_oned, set_default_cache

out = {"opt": {}, "bytes": {}}
for q in (1, 2, 3):
    for spec in %(specs)r:
        set_default_cache(PlanCache())
        sys.argv = ["tc_run", "--graph", spec, "--grid", str(q), "--opt",
                    "--verify", "--json"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tc_run.main()
        out["opt"][f"{spec}|{q}"] = json.loads(buf.getvalue().splitlines()[-1])

g = graph_from_spec(%(bytes_spec)r)
for q in (2, 3):
    art = plan_cannon(g, q, chunk=512, cache=PlanCache())
    staged = dict(art.staged())
    for name, db in (("cannon", True), ("cannon_single", False)):
        fn = build_cannon_fn(art.plan, make_grid_mesh(q), double_buffer=db)
        out["bytes"][f"{name}|{q}"] = collective_phases(
            fn.lower(**staged).compile().as_text())
    p = q * q
    art = plan_oned(g, p, chunk=512, cache=PlanCache())
    fn = build_oned_fn(art.plan, compat.make_mesh((p,), ("flat",)))
    out["bytes"][f"oned|{q}"] = collective_phases(
        fn.lower(**dict(art.staged())).compile().as_text())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(distributed_runner):
    """The reference's ``tc_run --opt --json`` reports and
    ``collective_phases`` bytes, from one subprocess on 9 host devices."""
    code = REFERENCE % dict(specs=OPT_SPECS, bytes_spec=BYTES_SPEC)
    return json.loads(distributed_runner(code, ndev=9).splitlines()[-1])


def _tc_run(argv):
    """The port's ``tc_run --json`` in this process; its parsed report."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tc_run.main(argv + ["--device", "cpu", "--json"])
    return json.loads(buf.getvalue().splitlines()[-1])


def _untimed(report):
    """A report's fields but the timings and the port's ``device``."""
    return {k: v for k, v in report.items() if k not in TIMINGS}


# ----------------------------------------------------------------------
# blobs and uint16 length pairs
# ----------------------------------------------------------------------
def test_pack_and_unpack_blob_match_the_reference():
    rng = np.random.default_rng(0)
    ptr = rng.integers(0, 99, size=(2, 3, 8)).astype(np.int32)
    idx = rng.integers(0, 99, size=(2, 3, 21)).astype(np.int32)
    layout, total = tblob.blob_layout([ptr.shape[2:], idx.shape[2:]])
    assert (layout, total) == jblob.blob_layout([ptr.shape[2:],
                                                 idx.shape[2:]])
    blob = tblob.pack_blob([torch.from_numpy(ptr), torch.from_numpy(idx)],
                           lead=2)
    assert blob.shape == (2, 3, total)
    for x, y in np.ndindex(2, 3):
        ref = np.asarray(jblob.pack_blob([ptr[x, y], idx[x, y]]))
        dev = blob[x, y]
        assert np.array_equal(dev.numpy(), ref)
        got = tblob.unpack_blob(dev, layout)
        want = jblob.unpack_blob(ref, layout)
        for g, w in zip(got, want):
            assert g.is_contiguous() and g.data_ptr() >= dev.data_ptr()
            assert np.array_equal(g.numpy(), np.asarray(w))
    # the whole grid's views keep the grid dimensions
    p2, i2 = tblob.unpack_blob(blob, layout)
    assert np.array_equal(p2.numpy(), ptr) and np.array_equal(i2.numpy(), idx)


@pytest.mark.parametrize("lens", [
    [3, 40_000, 7, 0, 65_535],          # odd nb, a negative packed pair
    [40_000, 1, 32_768, 32_767, 5, 2],  # even nb, lo halves past 2^15
    [1],
])
def test_length_pairs_match_the_reference(lens):
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    nb = len(lens)
    ref = np.asarray(jengine.CSRStore._pack_lengths(ptr))
    # the port packs a stacked (2, 2, nb + 1) grid; every device's row of
    # pairs is the reference's
    grid = torch.from_numpy(np.stack([np.stack([ptr] * 2)] * 2))
    got = CSRStore._pack_lengths(grid)
    assert got.dtype == torch.int32 and got.shape == (2, 2, (nb + 1) // 2)
    for x, y in np.ndindex(2, 2):
        assert np.array_equal(got[x, y].numpy(), ref)
    assert (ref < 0).any() == any(v >= 32_768 for v in lens[1::2])
    back = CSRStore._unpack_lengths(got, nb)
    ref_back = np.asarray(jengine.CSRStore._unpack_lengths(ref, nb))
    assert np.array_equal(ref_back, ptr)
    for x, y in np.ndindex(2, 2):
        assert np.array_equal(back[x, y].numpy(), ptr)


def test_compress_lengths_refusals():
    with pytest.raises(ValueError, match="only applies to blob shifts"):
        CSRStore(None, use_blob=False, compress_lengths=True, dmax=10)
    with pytest.raises(ValueError, match="needs d < 2"):
        CSRStore(None, compress_lengths=True, dmax=65_536)
    with pytest.raises(ValueError, match="needs d < 2"):
        CSRStore(None, compress_lengths=True)
    CSRStore(None, compress_lengths=True, dmax=65_535)


@pytest.fixture(scope="module")
def blob_graph():
    g = tc.graph_from_spec("powerlaw:300,2.1,4")
    return g, tc.triangle_count_oracle(g)


@pytest.mark.parametrize("aug", [False, True], ids=["search", "search2+aug"])
@pytest.mark.parametrize("use_blob,compress", [
    (False, False), (True, False), (True, True)],
    ids=["arrays", "blob", "blob+u16"])
@pytest.mark.parametrize("q,npods", [(1, 1), (2, 1), (2, 2), (3, 1),
                                     (3, 3)])
def test_blob_counts_equal_the_oracle(blob_graph, q, npods, use_blob,
                                      compress, aug):
    g, want = blob_graph
    plan = plan_cannon(g, q, chunk=64, bucketize=aug, aug_keys=aug,
                       cache=PlanCache()).plan
    host = plan.device_arrays()
    if npods > 1:
        host = pod_stack_arrays(host, npods, q)
    fn = build_cannon_fn(plan, method="search2" if aug else "search",
                         npods=npods, use_blob=use_blob,
                         compress_lengths=compress)
    assert fn.store.use_blob is use_blob
    assert fn.store.compress_lengths is compress
    assert fn.store.with_aug is aug
    assert int(fn(**stage_arrays(host, CPU))) == want


# ----------------------------------------------------------------------
# tc_run --opt
# ----------------------------------------------------------------------
@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("spec", OPT_SPECS)
def test_opt_report_matches_the_reference(reference, spec, q):
    ref = reference["opt"][f"{spec}|{q}"]
    got = _tc_run(["--graph", spec, "--grid", str(q), "--opt", "--verify"])
    assert got["optimized"] is True and got["correct"] is True
    assert got["triangles"] == got["expected"] == ref["triangles"]
    assert _untimed(got) == _untimed(ref)


def test_opt_counts_with_rebalance_and_no_compact():
    g = tc.graph_from_spec("cliques:4,40")
    want = tc.triangle_count_oracle(g)
    got = _tc_run(["--graph", "cliques:4,40", "--grid", "2", "--opt",
                   "--rebalance", "2", "--no-compact", "--repeat", "2"])
    assert got["triangles"] == want and got["rebalance_trials"] == 2
    assert "live_steps" not in got


def test_opt_falls_through_on_other_schedules():
    got = _tc_run(["--graph", "rmat:8", "--grid", "2", "--schedule", "oned",
                   "--opt", "--verify"])
    assert "optimized" not in got and got["correct"] is True


@pytest.mark.parametrize("argv,words", [
    (["--opt", "--hub-split"], "not wired through the --opt"),
    (["--opt", "--stream", "deltas.jsonl"], "--stream composes with"),
    (["--time-split", "--stream", "deltas.jsonl"], "--stream composes with"),
    (["--opt", "--inject-faults", "step@1"], "drop --graphs/--opt/"),
    (["--time-split", "--supervise"], "drop --graphs/--opt/"),
    (["--graphs", "rmat:8;named:karate", "--time-split"],
     "--time-split is not supported with --graphs"),
])
def test_opt_and_time_split_refusals(argv, words):
    with pytest.raises(SystemExit, match=words):
        tc_run.main(["--graph", "rmat:8", "--device", "cpu"] + argv)


# ----------------------------------------------------------------------
# tc_run --time-split and the bytes the engine moves
# ----------------------------------------------------------------------
@pytest.mark.parametrize("schedule,only", [
    ("cannon", "tct_shift_only"), ("summa", "tct_broadcast_only"),
    ("oned", "tct_shift_only")])
def test_time_split_keys(schedule, only):
    got = _tc_run(["--graph", "rmat:9", "--grid", "2", "--schedule",
                   schedule, "--time-split", "--verify"])
    keys = {only, "tct_count_only", "coll_shift_bytes",
            "coll_broadcast_bytes", "coll_reduce_bytes", "coll_other_bytes"}
    assert keys <= set(got) and got["correct"] is True
    assert all(got[k] >= 0 for k in keys)
    assert got["coll_broadcast_bytes"] == 0
    assert (got["coll_shift_bytes"] > 0) == (schedule != "summa")
    assert got["coll_reduce_bytes"] == 4 * 8  # the (2, 2) int64 partials


def test_count_only_engines_count_exactly_at_one_device(blob_graph):
    g, want = blob_graph
    art = plan_cannon(g, 1, cache=PlanCache())
    assert int(build_cannon_fn(art.plan, elide_shifts=True)(
        **art.staged(CPU))) == want
    art = plan_summa(g, 1, 1, cache=PlanCache())
    assert int(build_summa_fn(art.plan, elide_broadcast=True)(
        **art.staged(CPU))) == want
    art = plan_oned(g, 1, cache=PlanCache())
    assert int(build_oned_fn(art.plan, elide_shifts=True)(
        **art.staged(CPU))) == want
    # past one device the probes leave the shifts out: no bytes, and the
    # count is not the graph's
    art = plan_cannon(g, 2, cache=PlanCache())
    fn = build_cannon_fn(art.plan, elide_shifts=True, compact=False)
    moved = collective_phases(fn, art.staged(CPU))
    assert moved["shift"] == 0 and int(fn(**art.staged(CPU))) != want


@pytest.mark.parametrize("q", [2, 3])
def test_shift_bytes_against_the_reference(reference, q):
    g = tc.graph_from_spec(BYTES_SPEC)
    ndev = q * q

    art = plan_cannon(g, q, chunk=512, cache=PlanCache())
    staged = art.staged(CPU)
    per_shift = sum(staged[k][0, 0].numel() * 4 for k in (
        "a_indptr", "a_indices", "b_indptr", "b_indices"))
    live = art.plan.compact.live_steps
    assert list(live) == list(range(q))  # nothing elided: q - 1 unit hops
    port = collective_phases(build_cannon_fn(art.plan), staged)
    assert set(port) == {"shift", "broadcast", "reduce", "other"}
    # one device's share of one shift is the same payload in both
    assert port["shift"] == ndev * (q - 1) * per_shift
    assert reference["bytes"][f"cannon_single|{q}"]["shift"] == q * per_shift
    assert reference["bytes"][f"cannon|{q}"]["shift"] == (q + 1) * per_shift
    # the blobs are packed once a count: A and B of every device
    assert port["other"] == ndev * per_shift

    art = plan_oned(g, ndev, chunk=512, cache=PlanCache())
    staged = art.staged(CPU)
    per_shift = (staged["indptr"][0].numel()
                 + staged["indices"][0].numel()) * 4
    port = collective_phases(build_oned_fn(art.plan), staged)
    assert port["shift"] == ndev * (ndev - 1) * per_shift
    assert reference["bytes"][f"oned|{q}"]["shift"] == ndev * per_shift
    for name in ("cannon", "cannon_single", "oned"):
        assert reference["bytes"][f"{name}|{q}"]["broadcast"] == 0


# ----------------------------------------------------------------------
# the examples
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["quickstart", "distributed_tc",
                                  "fault_tolerance"])
def test_example_runs_on_the_cpu(name, capsys):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "✓" in out.splitlines()[-1]
