"""The port's dry run of the paper's graphs against the JAX package's.

Every plan field, every shape struct (name, shape, dtype), every graph
config and the cell list equal the reference's (``==``).  The reference's
cell is captured where it would lower: its schedule builders are replaced
by one that raises with the plan and the structs it is handed, so nothing
is compiled (its compiled cost numbers come from another machine's XLA
and are not compared).  The port's rows are walks of its engine on meta
tensors; the traps of that walk are pinned here: an analytic plan's
all-zero task counts, the sampled walk against a full one, no value read
from a meta tensor, and the staged dtypes.
"""
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

import repro.compat
import repro.configs as jcfg
import repro.core.api as japi
import repro.launch.roofline as jroof
import repro_torch.configs as tcfg
from repro_torch.core import count as tcount
from repro_torch.core.cannon import build_cannon_fn
from repro_torch.core.plan import analytic_plan
from repro_torch.launch import dryrun, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = list(tcfg.TC_GRAPHS)
SCHEDS = ("cannon", "cannon25d", "oned")
CHIPS = {"cannon": 256, "cannonopt": 256, "cannon2l": 256, "cannon25d": 512,
         "oned": 256}
PLAN_FIELDS = ("n", "m", "q", "nb", "nnz_pad", "tmax", "dmax", "chunk")
ONED_FIELDS = ("n", "m", "p", "nb", "nnz_pad", "gmax", "dmax", "chunk")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are meta
    or tiny, and under pytest-xdist every worker's full-width thread pool
    would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module.  Importing it sets ``XLA_FLAGS``
    to 512 host devices: the backend is brought up first (so the flag is
    not consumed) and the variable is put back."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags


class _Lowered(Exception):
    """Raised by the stand-in schedule builder where the reference's cell
    would lower: carries what it was handed."""

    def __init__(self, plan, kw, structs):
        super().__init__("lowered")
        self.plan, self.kw, self.structs = plan, kw, structs


def reference_cell(jdry, graph, sched, monkeypatch):
    """The reference's ``_run_tc_cell`` up to its ``fn.lower(**structs)``."""

    class Fn:
        def __init__(self, plan, kw):
            self.plan, self.kw = plan, kw

        def lower(self, **structs):
            raise _Lowered(self.plan, self.kw, structs)

    monkeypatch.setattr(japi, "get_schedule", lambda name: types.SimpleNamespace(
        build_fn=lambda plan, mesh, **kw: Fn(plan, kw)))
    monkeypatch.setattr(repro.compat, "make_mesh", lambda *a, **k: None)
    with pytest.raises(_Lowered) as info:
        jdry._run_tc_cell(jcfg.get_config(graph), sched, None, CHIPS[sched],
                          f"{graph}:{sched}")
    return info.value


def _structs(d):
    return {k: (tuple(v.shape), np.dtype(str(v.dtype).replace("torch.", "")))
            for k, v in d.items()}


# ----------------------------------------------------------------------
# configs, cells and plans against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("graph", GRAPHS)
def test_graph_configs_equal_the_reference(graph):
    mine = tcfg.get_config(graph)
    assert dataclasses.asdict(mine) == dataclasses.asdict(
        jcfg.get_config(graph))
    assert mine.family == "tc"


def test_graph_list_and_registry():
    """The port registers every name the reference does, of every
    family."""
    assert tcfg.TC_GRAPHS == jcfg.TC_GRAPHS
    assert tcfg.list_configs() == jcfg.base.list_configs()
    assert set(GRAPHS) <= set(tcfg.list_configs())


@pytest.mark.parametrize("name", ["nequip", "gat-cora", "dlrm-mlperf",
                                  "no-such-graph"])
def test_get_config_of_a_name_the_port_lacks_raises(name):
    """Only a name nobody registers raises now: the GNN and recsys names
    resolve to the reference's fields."""
    if name == "no-such-graph":
        with pytest.raises(KeyError, match="tc-twitter"):
            tcfg.get_config(name)
        return
    mine, ref = tcfg.get_config(name), jcfg.get_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.family == ref.family != "tc"


@pytest.mark.parametrize("multi_pod,shape,axes", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_meshes_are_logical_grids(multi_pod, shape, axes):
    from repro_torch.launch.mesh import LogicalMesh, make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod)
    assert (mesh.shape, mesh.axis_names) == (shape, axes)
    assert mesh.size == math.prod(shape)
    with pytest.raises(ValueError, match="differ in length"):
        LogicalMesh((16, 16), ("data",))


def test_all_cells_are_the_references_triangle_count_cells(jdry):
    ref = [c for c in jdry.all_cells() if c[0] in jcfg.TC_GRAPHS]
    mine = dryrun.all_cells()
    assert [c for c in mine if c[0] in tcfg.TC_GRAPHS] == ref
    assert len(ref) == 18
    assert mine[-18:] == ref  # after the model cells, as in the reference


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("sched", SCHEDS)
def test_cell_plan_and_structs_equal_the_reference(jdry, graph, sched,
                                                   monkeypatch):
    ref = reference_cell(jdry, graph, sched, monkeypatch)
    cell = dryrun.tc_cell(tcfg.get_config(graph), sched, CHIPS[sched])
    if sched == "oned":
        for f in ONED_FIELDS:
            assert getattr(cell.oplan, f) == getattr(ref.plan, f), f
    else:
        for f in PLAN_FIELDS:
            assert getattr(cell.plan, f) == getattr(ref.plan, f), f
        np.testing.assert_array_equal(cell.plan.m_cnt, ref.plan.m_cnt)
        assert cell.plan.m_cnt.dtype == ref.plan.m_cnt.dtype
    assert _structs(cell.arrays) == _structs(ref.structs)
    assert all(v.device.type == "meta" for v in cell.arrays.values())


@pytest.mark.parametrize("sched", ["cannonopt", "cannon2l"])
def test_beyond_paper_cells_equal_the_reference(jdry, sched, monkeypatch):
    ref = reference_cell(jdry, "tc-twitter", sched, monkeypatch)
    cell = dryrun.tc_cell(tcfg.get_config("tc-twitter"), sched, 256)
    for f in PLAN_FIELDS + ("n_long", "d_small"):
        assert getattr(cell.plan, f) == getattr(ref.plan, f), f
    assert ref.kw["compress_lengths"] is True
    assert cell.fn.store.compress_lengths
    assert _structs(cell.arrays) == _structs(ref.structs)


@pytest.mark.parametrize("spec,kind", [("named:karate", "summa"),
                                       ("rmat:8,8,5", "oned"),
                                       ("rmat:8,8,5", "cannon")])
def test_shape_structs_of_real_plans_equal_the_references(spec, kind):
    import repro.core as jc
    import repro.pipeline as jp
    import repro_torch.core as tc
    import repro_torch.pipeline as tp

    out = []
    for pipe, core in ((jp, jc), (tp, tc)):
        g = core.graph_from_spec(spec)
        if kind == "summa":
            art = pipe.plan_summa(g, 2, 3, cache=pipe.PlanCache())
        elif kind == "oned":
            art = pipe.plan_oned(g, 4, cache=pipe.PlanCache())
        else:
            art = pipe.plan_cannon(g, 2, cache=pipe.PlanCache())
        out.append(_structs(art.plan.shape_structs()))
    assert out[0] == out[1]


# ----------------------------------------------------------------------
# the rows
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def rows():
    cells = [c for c in dryrun.all_cells() if c[0] in GRAPHS] + [
        ("tc-twitter", "cannonopt", "pod"), ("tc-twitter", "cannon2l", "pod")]
    return {c: dryrun.run_cell(*c) for c in cells}


def test_row_keys_are_the_reference_report_plus_six(rows):
    ref = {f.name for f in dataclasses.fields(jroof.RooflineReport)}
    extra = {"nshifts", "nnz_pad_per_device", "grid_bytes", "fits",
             "card_bytes", "card_fits"}
    for row in rows.values():
        assert set(row) == ref | extra
        assert set(row["memory_per_device"]) == {"args", "outputs", "temps",
                                                 "aliased"}


def test_nshifts_nnz_pad_and_args_follow_the_reference(rows):
    for (graph, sched, mesh), row in rows.items():
        cfg = tcfg.get_config(graph)
        plan = analytic_plan(cfg.n_vertices, cfg.n_edges, 16,
                             dmax_block=cfg.dmax_block_est, chunk=512)
        assert row["nshifts"] == {"cannon25d": 8, "oned": 256}.get(sched, 16)
        assert row["nnz_pad_per_device"] == plan.nnz_pad
        assert row["chips"] == (512 if mesh == "multipod" else 256)
        assert row["mesh"] == mesh
        cell = dryrun.tc_cell(cfg, sched, row["chips"])
        # one logical device's slice of every staged tensor: the pods
        # stack A and B (512 slices) and share the task lists (256)
        per_dev = sum(v.numel() * v.element_size() // math.prod(
            v.shape[:3 if v.dim() == 4 else 1 if sched == "oned" else 2])
            for v in cell.arrays.values())
        assert row["memory_per_device"]["args"] == per_dev
        assert row["memory_per_device"]["outputs"] == 8
        assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
        assert row["coll_breakdown"]["broadcast"] == 0
        assert row["bottleneck"] in ("compute", "memory", "collective")


def test_twitter_fits_one_card_and_s29_does_not(rows):
    tw = rows[("tc-twitter", "cannon", "pod")]
    cfg = tcfg.get_config("tc-twitter")
    plan = analytic_plan(cfg.n_vertices, cfg.n_edges, 16,
                         dmax_block=cfg.dmax_block_est)
    staged = 256 * tw["memory_per_device"]["args"]
    # the staged grid is the 29.4 GB the analytic sizes give
    assert abs(staged - 29.4e9) <= 0.01 * 29.4e9
    # at a shift the count holds two generations of the blob payload (the
    # packed blobs and their rolled copy) and the int64 per-device
    # partials: the peak the walk sees
    payload = 256 * 2 * 4 * (plan.nb + 1 + plan.nnz_pad)
    assert tw["grid_bytes"] == staged + 2 * payload + 256 * 8
    assert tw["fits"] is True
    assert rows[("tc-g500-s29", "cannon", "pod")]["fits"] is False
    assert rows[("tc-g500-s29", "cannon", "pod")]["grid_bytes"] > 80e9


# ----------------------------------------------------------------------
# the walk's traps
# ----------------------------------------------------------------------
SMALL = dict(n=1000, m=8000, q=2, dmax_block=40, chunk=7)


def _small_plan(chunk=SMALL["chunk"]):
    s = dict(SMALL, chunk=chunk)
    return analytic_plan(s["n"], s["m"], s["q"], dmax_block=s["dmax_block"],
                         chunk=s["chunk"])


def test_the_analytic_plans_zero_task_counts_are_refused_and_the_cell_counts_tmax():
    plan = _small_plan()
    structs = plan.shape_structs()
    assert not plan.m_cnt.any()  # the trap: every device has 0 tasks
    fn = build_cannon_fn(plan, method="search")
    with pytest.raises(ValueError, match="counted no device-step"):
        roofline.walk_engine(fn, structs)
    cell = dryrun.tc_cell(tcfg.get_config("tc-twitter"), "cannon", 256)
    assert (cell.fn.m_cnt == cell.plan.tmax).all()
    walk = roofline.walk_engine(cell.fn, cell.arrays, sample=True)
    assert walk.device_steps == 16 ** 3  # every device at every step
    assert walk.searched == {"torch.int32": 16 ** 3 * cell.plan.tmax
                             * cell.plan.dmax}


def _cpu(arrays):
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in arrays.items()}


def _compare(fn, arrays):
    sampled = dataclasses.asdict(roofline.walk_engine(fn, arrays, sample=True))
    full = dataclasses.asdict(roofline.walk_engine(fn, _cpu(arrays)))
    assert sampled.pop("sampled") and not full.pop("sampled")
    assert sampled == full


def test_the_sampled_walk_equals_a_full_walk():
    """q = 2, n = 1,000, m = 8,000, chunk 7: 357 full chunks and a ragged
    one a device-step; the full walk runs every chunk of every device-step
    on zero-filled CPU tensors of the same shapes."""
    plan = _small_plan()
    full_cnt = np.full((2, 2), plan.tmax, np.int32)
    _compare(build_cannon_fn(plan, method="search").rebind(m_cnt=full_cnt),
             plan.shape_structs())


@pytest.mark.parametrize("sched", ["cannonopt", "cannon2l", "cannon25d",
                                   "oned"])
def test_the_sampled_walk_equals_a_full_walk_on_every_schedule(sched):
    """Each cell's own program at q = 4 (the ring at p = 4)."""
    cfg = tcfg.TCGraphConfig("small", 1000, 8000, 0, 40)
    cell = dryrun.tc_cell(cfg, sched, 4, q=4)
    _compare(cell.fn, cell.arrays)


def test_a_sampled_walk_refuses_uneven_device_steps():
    plan = _small_plan()
    cnt = np.full((2, 2), plan.tmax, np.int32)
    cnt[0, 1] -= 1
    fn = build_cannon_fn(plan, method="search").rebind(m_cnt=cnt)
    with pytest.raises(ValueError, match="sample=False"):
        roofline.walk_engine(fn, plan.shape_structs(), sample=True)


def test_the_walk_reads_no_meta_value():
    """The engine's host loop reads task counts and the skip mask from
    the plan's numpy arrays, never from a staged tensor: every cell walks
    on meta (``rows``); an op that reads a value is refused by name."""
    cell = dryrun.tc_cell(tcfg.get_config("tc-friendster"), "cannon", 256)
    assert isinstance(cell.fn.m_cnt, np.ndarray)
    count = cell.fn.store.count

    def reads(*args, **kw):
        c = count(*args, **kw)
        int(c)  # what a host loop reading a device value would do
        return c

    cell.fn.store.count = reads
    with pytest.raises(RuntimeError, match="reads a tensor's values"):
        roofline.walk_engine(cell.fn, cell.arrays, sample=True)
    del cell.fn.store.count
    with pytest.raises(ValueError, match="one device"):
        roofline.walk_engine(cell.fn, dict(cell.arrays,
                                           m_cnt=torch.zeros(16, 16)))


@pytest.mark.parametrize("kind", ["cannon", "oned"])
def test_walk_dtypes_equal_a_real_plans_staged_tensors(kind):
    import repro_torch.core as tc
    import repro_torch.pipeline as tp

    g = tc.graph_from_spec("rmat:9,8,3")
    if kind == "cannon":
        art = tp.plan_cannon(g, 2, cache=tp.PlanCache())
        cell = dryrun.tc_cell(tcfg.get_config("tc-g500-s29"), "cannon", 256)
    else:
        art = tp.plan_oned(g, 4, cache=tp.PlanCache())
        cell = dryrun.tc_cell(tcfg.get_config("tc-g500-s29"), "oned", 256)
    staged = art.staged("cpu")
    for k, v in cell.arrays.items():
        assert staged[k].dtype == v.dtype, k


def test_key_width_follows_the_base():
    """Row-encoded keys ``row * base + col`` are int32 up to base 46,340
    and int64 past it; the ring's search keeps int32 global ids up to
    n = 536,870,912."""
    assert tcount.aug_key_dtype(46340) == torch.int32
    assert tcount.aug_key_dtype(46341) == torch.int64
    tw = tcfg.get_config("tc-twitter")
    walk = roofline.walk_engine(*_fn_arrays(tw, "cannon2l"), sample=True)
    assert walk.searched["torch.int64"] > 0  # the keys; int32: the row ids
    walk = roofline.walk_engine(*_fn_arrays(tw, "cannon"), sample=True)
    assert set(walk.searched) == {"torch.int32"}
    s29 = tcfg.get_config("tc-g500-s29")
    assert s29.n_vertices + 1 < 2 ** 31
    walk = roofline.walk_engine(*_fn_arrays(s29, "oned"), sample=True)
    assert set(walk.searched) == {"torch.int32"}


def _fn_arrays(cfg, sched):
    cell = dryrun.tc_cell(cfg, sched, 256)
    return cell.fn, cell.arrays


# ----------------------------------------------------------------------
# the command line, and the package standing alone
# ----------------------------------------------------------------------
def _run(code):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_cli_sizes_s29_without_allocating_and_imports_no_jax():
    proc = _run("""
        import resource, sys, time
        t0 = time.perf_counter()
        sys.argv = ["dryrun", "--cell", "tc-g500-s29:cannon:pod"]
        from repro_torch.launch import dryrun
        try:
            dryrun.main()
        except SystemExit as e:
            code = e.code
        import repro_torch.optim, repro_torch.sparse, repro_torch.data.pipeline
        bad = sorted(m for m in sys.modules if m in ("jax", "repro")
                     or m.startswith(("jax.", "repro.")))
        print(code, time.perf_counter() - t0,
              resource.getrusage(resource.RUSAGE_SELF).ru_maxrss, bad)
    """)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    row = json.loads(lines[0])
    code, seconds, rss_kb, bad = lines[-1].split(" ", 3)
    assert code == "0" and bad == "[]"
    assert float(seconds) < 10
    assert int(rss_kb) < 2_000_000  # the staged grid alone is 240 GB
    assert row["status"] == "ok" and row["fits"] is False
    cfg = tcfg.get_config("tc-g500-s29")
    plan = analytic_plan(cfg.n_vertices, cfg.n_edges, 16,
                         dmax_block=cfg.dmax_block_est)
    staged = sum(v.numel() * v.element_size()
                 for v in plan.shape_structs().values())
    assert row["memory_per_device"]["args"] * 256 == staged


def test_cli_lists_the_cells_and_reports_an_error_row(capsys):
    dryrun.main(["--list"])
    with pytest.raises(SystemExit) as info:
        dryrun.main(["--cell", "tc-twitter:nosuch:pod"])
    assert info.value.code == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:88] == [":".join(c) for c in dryrun.all_cells()]
    row = json.loads(lines[88])
    assert row["status"] == "error" and "ValueError" in row["error"]
