"""The triangle count's runtime on a device mesh against the one-device
runtime and the JAX package's on a host mesh.

``supervised_count(graph, mesh)`` with its regrid onto the first surviving
positions, the shift-at-a-time stepper on a mesh, checkpoints of mesh
state (the bytes one device's run writes, restored across one device, a
mesh and the reference), ``tc_run --mesh`` with ``--ckpt-dir``,
``--inject-faults``, ``--supervise``, ``--opt`` and ``--time-split``, and
``distributed_degree_rank`` over a one-axis mesh.

Every mesh here is a CPU mesh (``make_grid_mesh(q, devices=["cpu"] *
n)``, or ``cpu:i`` labels where a test reads which positions a mesh
stands on).  Counts, supervision records, partials and carries are held
with ``==`` to the reference's, which two subprocesses compute at once on
nine host devices, and to the one-device port's.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.pipeline as tp
import repro_torch.runtime as tr
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import (host_array, load_checkpoint,
                                         save_checkpoint)
from repro_torch.core import engine
from repro_torch.core.cannon import build_cannon_stepper
from repro_torch.core.engine import MeshArray
from repro_torch.core.plan import CompactSchedule
from repro_torch.core.preprocess import distributed_degree_rank
from repro_torch.launch import tc_run
from repro_torch.launch.mesh import DeviceMesh, make_mesh_for
from repro_torch.pipeline.artifact import stage_on_mesh
from repro_torch.runtime import faultinject as tfi

from test_torch_mesh import _chip_smoke, placement  # noqa: F401

G = "rmat:8,8,3"  # the supervised counts' graph
CLI_GRAPH = "rmat:9"
SCHEDULES = ("cannon", "summa", "oned")
LOST = (5, 3)  # 3 x 3 -> 2 x 2 (the schedule kept); 9 - 3 = 6 -> 1 x 6
# (name, graph, q, double_buffer, compact, widen the live list by a step)
STEPPER_CASES = (
    ("q1", "rmat:8,8,11", 1, True, None, False),
    ("q2_db", "rmat:8,8,11", 2, True, None, False),
    ("q2_single", "rmat:8,8,11", 2, False, None, False),
    ("q3_db", "rmat:9,8,2", 3, True, None, False),
    ("cliques_q3_compact", "cliques:3,60", 3, True, None, True),
    ("cliques_q3_single_full", "cliques:3,60", 3, False, False, False),
)
RANK_P = (1, 4, 8)
# the reference's tc_run on a host mesh: (name, argv after --graph)
CLI_RUNS = (
    ("ckpt_faults", ["--grid", "3", "--ckpt-dir", "{d}/faults",
                     "--inject-faults", "step@1;ckpt_save=ckptcorrupt"]),
    ("ckpt_lost", ["--grid", "3", "--ckpt-dir", "{d}/lost",
                   "--inject-faults", "step@1=devicelost:5"]),
    ("lost", ["--grid", "3", "--inject-faults", "step@0=devicelost:3"]),
    ("supervise", ["--grid", "2", "--supervise"]),
    ("opt", ["--grid", "3", "--opt"]),
    ("split_cannon", ["--grid", "2", "--time-split"]),
    ("split_summa", ["--grid", "2", "--schedule", "summa", "--time-split"]),
    ("split_oned", ["--grid", "2", "--schedule", "oned", "--time-split"]),
    # stops for good at shift 1: its directory holds shift 1's checkpoint
    ("partial", ["--grid", "2", "--ckpt-dir", "{d}/partial",
                 "--inject-faults", "step@1=stepfault*-1",
                 "--restart-budget", "0"]),
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(q, labels=False):
    """A ``q x q`` CPU mesh; with ``labels`` position ``i`` on ``cpu:i``."""
    n = q * q
    return tc.make_grid_mesh(
        q, devices=[f"cpu:{i}" for i in range(n)] if labels else ["cpu"] * n)


def _live_specs(schedule):
    """Every fault point of a supervised count on the 3 x 3 grid: the two
    staging points and each live step (the port's plans are the
    reference's, byte for byte), then the two device losses."""
    g, cache = tc.graph_from_spec(G), tp.PlanCache()
    art = {"cannon": lambda: tp.plan_cannon(g, 3, cache=cache),
           "summa": lambda: tp.plan_summa(g, 3, 3, cache=cache),
           "oned": lambda: tp.plan_oned(g, 9, cache=cache)}[schedule]()
    return (["plan_stage", "device_stage"]
            + [f"step@{s}" for s in tfi.live_step_indices(art.plan)]
            + [f"step@0=devicelost:{n}" for n in LOST])


# ----------------------------------------------------------------------
# the reference on nine host devices
# ----------------------------------------------------------------------
_SUPERVISED = """
import json
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import graph_from_spec, rmat
from repro.core.preprocess import distributed_degree_rank
from repro.runtime import BackoffPolicy, FaultPlan, Supervisor
from repro.runtime.supervisor import supervised_count

devs = jax.devices()
def mesh(shape, names=("data", "model")):
    return compat.make_mesh(shape, names, devices=devs[:int(np.prod(shape))])

class Clock:
    t = 0.0
    def __call__(self):
        return self.t
    def sleep(self, d):
        self.t += d

def supervised(m, spec, **kw):
    clk = Clock()
    sup = Supervisor(max_restarts=4, seed=5, clock=clk, sleep=clk.sleep,
                     backoff=BackoffPolicy(base=0.5, jitter=0.3))
    res = supervised_count(g, m, supervisor=sup,
                           fault_plan=FaultPlan.parse(spec), **kw)
    return dict(triangles=res.triangles, supervision=res.supervision)

g = graph_from_spec({graph!r})
out = {{}}
for schedule, specs in {cases!r}.items():
    for spec in specs:
        out[f"{{schedule}}/{{spec}}"] = supervised(mesh((3, 3)), spec,
                                                 schedule=schedule)
# a 2 x 2 mesh in a 9-device process: the survivors are the process's
out["q2_lost1"] = supervised(mesh((2, 2)), "step@0=devicelost:1")
deg = rmat(6, 6, seed=9).degrees()
for p in {ranks!r}:
    fn = jax.jit(compat.shard_map(
        lambda d: distributed_degree_rank(d, "x"),
        mesh=compat.make_mesh((p,), ("x",), devices=devs[:p]),
        in_specs=P("x"), out_specs=P("x"), check_vma=False))
    out[f"rank/{{p}}"] = np.asarray(
        fn(jnp.asarray(deg, dtype=jnp.int32))).tolist()
print("RESULT" + json.dumps(out))
"""

_STEPPER_AND_CLI = """
import contextlib, io, json, sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.core import graph_from_spec
from repro.core.api import make_grid_mesh
from repro.core.cannon import build_cannon_stepper
from repro.core.plan import CompactSchedule
from repro.launch import tc_run
from repro.pipeline import plan_cannon
from repro.pipeline.cache import PlanCache

dump = {{}}
for name, spec, q, db, compact, widen in {cases!r}:
    plan = plan_cannon(graph_from_spec(spec), q, cache=PlanCache()).plan
    if widen:
        live = plan.compact.live_steps
        extra = next(s for s in range(q) if s not in live)
        plan.compact = CompactSchedule(
            n_total=q, live_steps=tuple(sorted(set(live) | {{extra}})))
    stepper = build_cannon_stepper(plan, make_grid_mesh(q),
                                   double_buffer=db, compact=compact)
    arrays = {{k: jnp.asarray(v) for k, v in plan.device_arrays().items()}}
    statics = {{k: arrays[k] for k in ("m_ti", "m_tj", "m_cnt", "step_keep")}}
    carry = list(stepper.prime(arrays))
    acc = jnp.zeros((q, q), jnp.int32)
    steps = stepper.live_steps if stepper.live_steps is not None else range(q)
    dump[f"{{name}}/steps"] = np.asarray(list(steps))
    for s in steps:
        res = stepper(tuple(carry) + (acc,), statics, step=s)
        carry, acc = list(res[:-1]), res[-1]
        dump[f"{{name}}/{{s}}/acc"] = np.asarray(acc)
        for i, c in enumerate(carry):
            dump[f"{{name}}/{{s}}/carry{{i}}"] = np.asarray(c)
np.savez({npz!r}, **dump)

reports = {{}}
for name, argv in {runs!r}:
    sys.argv = ["tc_run", "--graph", {graph!r}, "--json"] + [
        a.format(d={d!r}) for a in argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            tc_run.main()
    except Exception as e:  # the partial run gives up, as it is told to
        reports[name] = dict(error=type(e).__name__)
        continue
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{{")]
    reports[name] = json.loads(lines[-1])
print("RESULT" + json.dumps(reports))
"""


@pytest.fixture(scope="module")
def ref(distributed_runner, tmp_path_factory):
    """The reference's supervised counts, degree ranks, stepper states and
    ``tc_run`` reports: two subprocesses on nine host devices, run at
    once.  ``ref["dir"]`` holds its ``tc_run`` checkpoint directories."""
    from concurrent.futures import ThreadPoolExecutor

    base = tmp_path_factory.mktemp("mesh_runtime_ref")
    npz = str(base / "stepper.npz")
    codes = (
        _SUPERVISED.format(graph=G, ranks=RANK_P, cases={
            s: _live_specs(s) for s in SCHEDULES}),
        _STEPPER_AND_CLI.format(cases=STEPPER_CASES, npz=npz, runs=CLI_RUNS,
                                graph=CLI_GRAPH, d=str(base)),
    )
    with ThreadPoolExecutor(2) as pool:
        outs = list(pool.map(
            lambda code: distributed_runner(code, 9, timeout=300), codes))
    sup, cli = (json.loads([ln for ln in o.splitlines()
                            if ln.startswith("RESULT")][-1][len("RESULT"):])
                for o in outs)
    with np.load(npz) as data:
        stepper = {k: data[k] for k in data.files}
    return dict(sup=sup, cli=cli, stepper=stepper, dir=base)


# ----------------------------------------------------------------------
# supervised_count on a mesh
# ----------------------------------------------------------------------
class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, d):
        self.t += d


def _supervised(mesh, spec, **kw):
    clk = _FakeClock()
    sup = tr.Supervisor(max_restarts=4, seed=5, clock=clk, sleep=clk.sleep,
                        backoff=tr.BackoffPolicy(base=0.5, jitter=0.3))
    return tr.supervised_count(tc.graph_from_spec(G), mesh, supervisor=sup,
                               fault_plan=tr.FaultPlan.parse(spec), **kw)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_supervised_count_on_a_mesh_matches_the_reference(ref, schedule):
    """Every fault point on the 3 x 3 mesh: the same count, attempts,
    fault log and regrid records as the reference's on all nine host
    devices."""
    exp = tc.triangle_count_oracle(tc.graph_from_spec(G))
    for spec in _live_specs(schedule):
        mine = _supervised(_cpu_mesh(3), spec, schedule=schedule)
        want = ref["sup"][f"{schedule}/{spec}"]
        assert mine.triangles == want["triangles"] == exp, spec
        assert mine.supervision == want["supervision"], spec
        assert mine.supervision["restarts"] == 1, spec
    regrids = [ref["sup"][f"{schedule}/step@0=devicelost:{n}"]["supervision"][
        "regrids"] for n in LOST]
    square = "cannon" if schedule == "cannon" else schedule
    assert regrids == [
        [dict(lost=5, grid=[2, 2], schedule=square)],
        [dict(lost=3, grid=[1, 6],
              schedule="oned" if schedule == "oned" else "summa")]]


@pytest.mark.parametrize("schedule,lost,grid,shape", [
    ("cannon", 5, (2, 2), (2, 2)), ("cannon", 3, (1, 6), (1, 6)),
    ("summa", 5, (2, 2), (2, 2)), ("oned", 3, (1, 6), (6,))])
def test_each_retry_runs_on_the_first_survivors(monkeypatch, schedule, lost,
                                                grid, shape):
    """A recorded ``count_triangles``: the first attempt gets the starting
    mesh, the retry a mesh over its first ``r * c`` positions' devices, in
    order, with no ``q``, ``grid`` or ``npods``."""
    import repro_torch.core.api as api

    calls = []
    plain = api.count_triangles

    def recorded(graph, mesh=None, **kw):
        calls.append((mesh, {k: kw.get(k) for k in ("q", "grid", "npods",
                                                     "schedule")}))
        return plain(graph, mesh, **kw)

    monkeypatch.setattr(api, "count_triangles", recorded)
    start = _cpu_mesh(3, labels=True)
    res = _supervised(start, f"step@0=devicelost:{lost}", schedule=schedule)
    assert res.triangles == tc.triangle_count_oracle(tc.graph_from_spec(G))
    (first, _), (retry, kw) = calls
    assert first is start
    r, c = grid
    assert isinstance(retry, DeviceMesh) and retry.shape == shape
    assert retry.devices == start.devices[:r * c]
    assert kw["q"] is kw["grid"] is kw["npods"] is None
    assert kw["schedule"] == res.supervision["regrids"][0]["schedule"]
    assert res.device == ",".join(str(d) for d in start.devices[:r * c])


def test_regrid_counts_the_mesh_positions_not_the_process(ref):
    """The port's regrid counts the starting mesh's positions, the
    reference every device of its process: on a 2 x 2 mesh in a 9-device
    process the reference sees 9 - 1 = 8 survivors (SUMMA 2 x 4), the port
    4 - 1 = 3 (SUMMA 1 x 3).  Both counts are exact; the two agree where
    the mesh covers every device (above).  ROADMAP.md Queue C."""
    want = ref["sup"]["q2_lost1"]
    mine = _supervised(_cpu_mesh(2), "step@0=devicelost:1")
    assert mine.triangles == want["triangles"]
    assert want["supervision"]["regrids"] == [
        dict(lost=1, grid=[2, 4], schedule="summa")]
    assert mine.supervision["regrids"] == [
        dict(lost=1, grid=[1, 3], schedule="summa")]
    # a device at several positions counts at each: 9 positions on one CPU
    many = _supervised(_cpu_mesh(3), "step@0=devicelost:5")
    assert many.supervision["regrids"][0]["grid"] == [2, 2]
    with pytest.raises(RuntimeError, match="cannot regrid"):
        _supervised(_cpu_mesh(2), "step@0=devicelost:4")


def test_supervised_count_on_a_pod_mesh_and_a_flat_ring():
    """A pod mesh's positions count with their pods; the ring takes its
    ``("flat",)`` mesh from the start."""
    g = tc.graph_from_spec(G)
    pods = tc.make_grid_mesh(2, npods=2, devices=["cpu"] * 8)
    res = _supervised(pods, "step@0=devicelost:2", reduce_strategy="tree")
    assert res.supervision["regrids"] == [
        dict(lost=2, grid=[1, 6], schedule="summa")]
    assert res.triangles == tc.triangle_count_oracle(g)
    flat = make_mesh_for((5,), ("flat",), devices=["cpu"] * 5)
    res = _supervised(flat, "step@0=devicelost:1", schedule="oned")
    assert res.supervision["regrids"] == [
        dict(lost=1, grid=[2, 2], schedule="oned")]
    assert res.grid == (4,) and res.triangles == tc.triangle_count_oracle(g)


# ----------------------------------------------------------------------
# the stepper on a mesh
# ----------------------------------------------------------------------
def _global(array):
    """A mesh array's global tensor (its checkpoint's array)."""
    return torch.from_numpy(host_array(array))


def _stepper_case(case, mesh=None):
    name, spec, q, db, compact, widen = case
    plan = tp.plan_cannon(tc.graph_from_spec(spec), q,
                          cache=tp.PlanCache()).plan
    if widen:
        live = plan.compact.live_steps
        extra = next(s for s in range(q) if s not in live)
        plan.compact = CompactSchedule(
            n_total=q, live_steps=tuple(sorted(set(live) | {extra})))
    return plan, build_cannon_stepper(plan, mesh, double_buffer=db,
                                      compact=compact)


def _run_stepper(plan, stepper, where, q):
    """Every step's ``(acc, carry)`` from the stepper's run on ``where``."""
    from repro_torch.pipeline.artifact import stage_arrays

    arrays = stage_arrays(plan.device_arrays(), where)
    zeros = np.zeros((q, q), dtype=np.int64)
    acc = (torch.from_numpy(zeros).to(where) if isinstance(where, str)
           else stage_on_mesh(zeros, where))
    carry = stepper.prime(arrays)
    steps = (list(stepper.live_steps) if stepper.live_steps is not None
             else list(range(q)))
    out = []
    for s in steps:
        res = stepper((*carry, acc), arrays, step=s)
        carry, acc = res[:-1], res[-1]
        out.append((s, acc, carry))
    return out


@pytest.mark.parametrize("case", STEPPER_CASES,
                         ids=[c[0] for c in STEPPER_CASES])
def test_stepper_on_a_mesh_matches_one_device_and_the_reference(ref, case):
    name, spec, q = case[:3]
    mesh = _cpu_mesh(q)
    plan, on_mesh = _stepper_case(case, mesh)
    _, one = _stepper_case(case)
    assert on_mesh.n_carry == one.n_carry
    want = ref["stepper"]
    got = _run_stepper(plan, on_mesh, mesh, q)
    base = _run_stepper(plan, one, "cpu", q)
    assert [s for s, _, _ in got] == want[f"{name}/steps"].tolist()
    for (s, acc, carry), (_, acc1, carry1) in zip(got, base):
        assert isinstance(acc, MeshArray) and acc.mesh == mesh
        assert all(b.dim() == 0 and b.dtype == torch.int64
                   for b in acc.blocks.values())
        assert torch.equal(_global(acc), acc1)
        assert _global(acc).tolist() == want[f"{name}/{s}/acc"].tolist()
        for i, (c, c1) in enumerate(zip(carry, carry1)):
            assert torch.equal(_global(c), c1), (s, i)
            np.testing.assert_array_equal(_global(c).numpy(),
                                          want[f"{name}/{s}/carry{i}"])
    total = int(engine.Reduction().resolve().apply(got[-1][1]))
    assert total == tc.triangle_count_oracle(tc.graph_from_spec(spec))


@pytest.mark.parametrize("case", [STEPPER_CASES[3], STEPPER_CASES[4]],
                         ids=["q3_db", "cliques_q3_compact"])
def test_stepper_counts_read_one_position(placement, case):
    """Under ``test_torch_mesh.py``'s dispatch mode: outside a shift no op
    reads two positions' blocks, and the copies inside shifts are the
    bytes the engine's tally counts."""
    q = case[2]
    mesh = _cpu_mesh(q)
    plan, stepper = _stepper_case(case, mesh)
    from repro_torch.pipeline.artifact import stage_arrays

    arrays = stage_arrays(plan.device_arrays(), mesh)
    for a in arrays.values():
        placement.label(a)
    acc = stage_on_mesh(np.zeros((q, q), dtype=np.int64), mesh)
    placement.label(acc)
    steps = (list(stepper.live_steps) if stepper.live_steps is not None
             else list(range(q)))
    with engine.tally_moved_bytes() as tally, placement:
        carry = stepper.prime(arrays)
        for s in steps:
            *carry, acc = stepper((*carry, acc), arrays, step=s)
    assert placement.ops > 0 and not placement.mixed, placement.mixed
    assert placement.copied == tally["shift"] > 0
    assert int(engine.Reduction().resolve().apply(acc)) == \
        tc.triangle_count_oracle(tc.graph_from_spec(case[1]))


def test_stepper_refuses_arrays_staged_elsewhere():
    plan, on_mesh = _stepper_case(STEPPER_CASES[1], _cpu_mesh(2))
    _, one = _stepper_case(STEPPER_CASES[1])
    from repro_torch.pipeline.artifact import stage_arrays

    host = plan.device_arrays()
    with pytest.raises(ValueError, match="built for a mesh"):
        on_mesh.prime(stage_arrays(host, "cpu"))
    with pytest.raises(ValueError, match="built for one device"):
        one.prime(stage_arrays(host, _cpu_mesh(2)))
    other = _cpu_mesh(2).reshaped((2, 2), ("x", "y"))
    with pytest.raises(ValueError, match="built for a mesh"):
        on_mesh.prime(stage_arrays(host, other))
    with pytest.raises(ValueError, match="grid"):
        build_cannon_stepper(plan, _cpu_mesh(3))


# ----------------------------------------------------------------------
# checkpoints of mesh state
# ----------------------------------------------------------------------
def test_checkpoint_of_a_mesh_array_is_its_global_array(tmp_path):
    """The payload entry of a mesh array is the stacked tensor one device
    holds, byte for byte; it restores onto a mesh from a mesh array
    ``like``, onto a tensor's device from a tensor ``like``, and with
    ``mesh=``/``specs=`` by the specs (a prefix tree; ``None`` splits over
    every axis)."""
    mesh = _cpu_mesh(2)
    host = np.arange(24, dtype=np.int32).reshape(2, 2, 6)
    acc = np.arange(4, dtype=np.int64).reshape(2, 2)
    tree = {"c": stage_on_mesh(host, mesh), "acc": stage_on_mesh(acc, mesh)}
    one = {"c": torch.from_numpy(host), "acc": torch.from_numpy(acc)}
    save_checkpoint(str(tmp_path / "m"), 1, tree)
    save_checkpoint(str(tmp_path / "o"), 1, one)
    for f in ("step_0000000001.npz", "step_0000000001.json"):
        assert (tmp_path / "m" / f).read_bytes() == (
            tmp_path / "o" / f).read_bytes()
    back, _ = load_checkpoint(str(tmp_path / "o"), 1, tree)
    assert back["acc"].mesh == mesh and back["acc"][1, 0].dim() == 0
    assert torch.equal(_global(back["c"]), one["c"])
    back, _ = load_checkpoint(str(tmp_path / "m"), 1,
                              {k: torch.zeros(()) for k in one})
    assert all(torch.equal(back[k], one[k]) for k in one)
    task = np.arange(8, dtype=np.int32).reshape(2, 2, 2)
    pods = tc.make_grid_mesh(2, npods=2, devices=["cpu"] * 8)
    save_checkpoint(str(tmp_path / "p"), 1, {"t": task, "x": host})
    back, _ = load_checkpoint(
        str(tmp_path / "p"), 1, {"t": torch.zeros(()), "x": torch.zeros(())},
        mesh=pods, specs={"t": ("data", "model"), "x": ("data", "model")})
    # split over the grid's axes, each pod holds a replica
    assert back["t"][1, 0, 1].tolist() == task[0, 1].tolist()
    assert back["t"][0, 0, 1] is not back["t"][1, 0, 1]
    back, _ = load_checkpoint(str(tmp_path / "o"), 1,
                              {k: torch.zeros(()) for k in one}, mesh=mesh,
                              specs=None)
    assert back["c"].mesh == mesh
    assert back["c"][1, 0].tolist() == host[1, 0].tolist()


def test_async_snapshot_of_a_mesh_array_copies_every_block(tmp_path):
    """The async save snapshots each block: a block written after the save
    returns does not reach the payload."""
    mesh = _cpu_mesh(2)
    arr = stage_on_mesh(np.zeros((2, 2, 3), dtype=np.int64), mesh)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(1, {"a": arr})
    for b in arr.blocks.values():
        b.fill_(7)
    mgr.wait()
    _, back, _ = mgr.restore_latest({"a": arr})
    mgr.close()
    assert int(_global(back["a"]).abs().sum()) == 0


# ----------------------------------------------------------------------
# tc_run --mesh
# ----------------------------------------------------------------------
def _run(capsys, *argv, graph=CLI_GRAPH):
    tc_run.main(["--graph", graph, "--device", "cpu", "--json", *argv])
    out = capsys.readouterr().out
    return out, json.loads([ln for ln in out.splitlines()
                            if ln.startswith("{")][-1])


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))
            if os.path.isfile(d / f)}


def test_tc_run_mesh_checkpoints_are_the_one_device_bytes(ref, tmp_path,
                                                          capsys):
    """``--ckpt-dir`` with a step fault and a corrupted checkpoint: the
    mesh run's report is the reference's and the one-device run's, and
    its directory holds the one-device run's files, byte for byte; a rerun
    resumes; another collective strategy or carry arity is refused."""
    faults = ["--inject-faults", "step@1;ckpt_save=ckptcorrupt"]
    d_mesh, d_one = tmp_path / "mesh", tmp_path / "one"
    _, mine = _run(capsys, "--grid", "3", "--mesh", "--ckpt-dir", str(d_mesh),
                   *faults)
    _, one = _run(capsys, "--grid", "3", "--ckpt-dir", str(d_one), *faults)
    want = ref["cli"]["ckpt_faults"]
    for key in ("triangles", "checkpointed", "live_steps", "schedule_shifts",
                "supervision_restarts", "supervision_fault_log"):
        assert mine[key] == one[key] == want[key], key
    assert mine["device"] == "cpu"
    assert _files(d_mesh) == _files(d_one)
    assert sorted(_files(d_mesh)) == sorted(os.listdir(
        ref["dir"] / "faults"))
    out, again = _run(capsys, "--grid", "3", "--mesh", "--ckpt-dir",
                      str(d_mesh))
    assert "resumed at shift 3" in out and again["triangles"] == want[
        "triangles"]
    with pytest.raises(SystemExit, match="collectives"):
        _run(capsys, "--grid", "3", "--mesh", "--ckpt-dir", str(d_mesh),
             "--reduce-strategy", "flat")
    single = str(tmp_path / "single")  # one carry generation, not two
    _run(capsys, "--grid", "3", "--mesh", "--ckpt-dir", single,
         "--no-double-buffer")
    with pytest.raises(SystemExit, match="missing 'carry4"):
        _run(capsys, "--grid", "3", "--mesh", "--ckpt-dir", single)


def test_tc_run_mesh_regrid_refuses_to_move_partials(ref, tmp_path, capsys):
    d = tmp_path / "r"
    out, rep = _run(capsys, "--grid", "3", "--mesh", "--ckpt-dir", str(d),
                    "--inject-faults", "step@1=devicelost:5")
    want = ref["cli"]["ckpt_lost"]
    assert rep["triangles"] == want["triangles"]
    assert rep["final_grid"] == want["final_grid"] == [2, 2]
    assert "(device lost: refusing to transfer" in out
    assert "from grid 3x3 to 2x2" in out
    assert rep["supervision_regrids"] == [
        dict(lost=5, grid=[2, 2], ckpt_dir=str(d / "regrid_2x2"))]
    assert [(r["lost"], r["grid"]) for r in want["supervision_regrids"]] == [
        (5, [2, 2])]
    assert sorted(os.listdir(d / "regrid_2x2")) == sorted(os.listdir(
        ref["dir"] / "lost" / "regrid_2x2"))


def test_tc_run_mesh_stages_once_a_grid(tmp_path, capsys, monkeypatch):
    """Every attempt counts from the staged mesh arrays: three faults, one
    staging; a regrid stages its own grid once."""
    import repro_torch.pipeline.artifact as artifact

    staged = []
    plain = artifact.stage_arrays
    monkeypatch.setattr(artifact, "stage_arrays", lambda arrays, device, **kw:
                        staged.append(device) or plain(arrays, device, **kw))
    _, rep = _run(capsys, "--graph", "rmat:9,8,7", "--grid", "2", "--mesh",
                  "--ckpt-dir", str(tmp_path / "a"), "--inject-faults",
                  "step@0;step@1;ckpt_save@2=stepfault", "--verify")
    assert rep["correct"] and rep["supervision_restarts"] == 3
    assert len(staged) == 1 and isinstance(staged[0], DeviceMesh)
    staged.clear()
    _, rep = _run(capsys, "--graph", "rmat:9,8,8", "--grid", "3", "--mesh",
                  "--ckpt-dir", str(tmp_path / "b"), "--inject-faults",
                  "step@0;step@1=devicelost:5;step@0", "--verify")
    assert rep["correct"] and rep["final_grid"] == [2, 2]
    assert [m.shape for m in staged] == [(3, 3), (2, 2)]


def test_tc_run_checkpoints_restore_across_one_device_a_mesh_and_the_reference(
        ref, tmp_path, capsys):
    """A run stopped for good at shift 1 (a persistent step fault, no
    restart left) resumes at shift 1 in the other placement: one device
    to a mesh, a mesh to one device, and the reference's host-mesh
    checkpoint (int32 partials) on the port's CPU mesh."""
    stop = ["--inject-faults", "step@1=stepfault*-1", "--restart-budget", "0"]
    exp = tc.triangle_count_oracle(tc.graph_from_spec(CLI_GRAPH))
    for first, then in (([], ["--mesh"]), (["--mesh"], [])):
        d = str(tmp_path / ("m" if first else "o"))
        with pytest.raises(tr.StepFault):
            _run(capsys, "--grid", "2", "--ckpt-dir", d, *first, *stop)
        out, rep = _run(capsys, "--grid", "2", "--ckpt-dir", d, *then)
        assert "resumed at shift 1" in out and rep["triangles"] == exp
    assert ref["cli"]["partial"] == dict(error="StepFault")
    d = tmp_path / "ref"
    shutil.copytree(ref["dir"] / "partial", d)
    out, rep = _run(capsys, "--grid", "2", "--mesh", "--ckpt-dir", str(d))
    assert "resumed at shift 1" in out and rep["triangles"] == exp


@pytest.mark.parametrize("name,argv", [
    ("lost", ["--grid", "3", "--inject-faults", "step@0=devicelost:3"]),
    ("supervise", ["--grid", "2", "--supervise"]),
    ("opt", ["--grid", "3", "--opt"]),
    ("split_cannon", ["--grid", "2", "--time-split"]),
    ("split_summa", ["--grid", "2", "--schedule", "summa", "--time-split"]),
    ("split_oned", ["--grid", "2", "--schedule", "oned", "--time-split"]),
])
def test_tc_run_mesh_modes_match_one_device_and_the_reference(ref, capsys,
                                                              name, argv):
    _, mine = _run(capsys, "--mesh", *argv)
    _, one = _run(capsys, *argv)
    want = ref["cli"][name]
    assert mine["triangles"] == one["triangles"] == want["triangles"]
    assert mine["device"] == "cpu"
    if name == "lost":
        assert mine["supervision_regrids"] == one["supervision_regrids"] == \
            want["supervision_regrids"] == [
                dict(lost=3, grid=[1, 6], schedule="summa")]
        assert mine["grid"] == [1, 6]
    if name.startswith("split"):
        keys = ("tct_count_only", "coll_shift_bytes", "coll_reduce_bytes",
                "coll_broadcast_bytes")
        assert all(k in mine for k in keys[:2])
        # a shift moves what a roll moves; the reduce reads each partial
        assert mine["coll_shift_bytes"] == one["coll_shift_bytes"]
        assert mine["coll_reduce_bytes"] == one["coll_reduce_bytes"]
        if name == "split_summa":
            assert mine["coll_broadcast_bytes"] > 0 == one[
                "coll_broadcast_bytes"]
            assert "tct_broadcast_only" in mine
        else:
            assert "tct_shift_only" in mine
    if name == "opt":
        assert mine["optimized"] and mine["bucket_reduction"] == one[
            "bucket_reduction"]


def test_tc_run_mesh_pods_time_split_and_refusals(capsys):
    exp = tc.triangle_count_oracle(tc.graph_from_spec(CLI_GRAPH))
    _, rep = _run(capsys, "--grid", "2", "--pods", "2", "--mesh",
                  "--time-split", "--reduce-strategy", "tree")
    assert rep["triangles"] == exp and rep["grid"] == [2, 2, 2]
    _, rep = _run(capsys, "--grid", "2", "--pods", "2", "--mesh",
                  "--schedule", "oned", "--time-split")
    assert rep["triangles"] == exp and rep["coll_shift_bytes"] > 0
    with pytest.raises(SystemExit, match="drop --device"):
        tc_run.main(["--graph", CLI_GRAPH, "--grid", "2", "--mesh",
                     "--device", "cuda:1", "--ckpt-dir", "x"])


# ----------------------------------------------------------------------
# distributed_degree_rank across positions
# ----------------------------------------------------------------------
def _ring(p, labels=False):
    devs = [f"cpu:{i}" for i in range(p)] if labels else ["cpu"] * p
    return make_mesh_for((p,), ("flat",), devices=devs)


def _shards(deg, mesh, sizes):
    cuts = np.cumsum([0] + list(sizes))
    return MeshArray(mesh, {(s,): torch.from_numpy(deg[cuts[s]:cuts[s + 1]])
                            for s in range(mesh.size)})


def _gathered(ranks):
    return np.concatenate([ranks.blocks[(s,)].numpy()
                           for s in range(ranks.mesh.size)])


@pytest.mark.parametrize("p", RANK_P)
def test_mesh_degree_rank_matches_the_tensor_form_and_the_reference(ref, p):
    g = tc.rmat(6, 6, seed=9)
    deg = g.degrees().astype(np.int64)
    mesh = _ring(p, labels=True)
    got = distributed_degree_rank(_shards(deg, mesh, [g.n // p] * p))
    assert isinstance(got, MeshArray) and got.mesh == mesh
    assert all(b.dtype == torch.int64 for b in got.blocks.values())
    tensor = distributed_degree_rank(torch.from_numpy(deg).view(p, -1))
    assert _gathered(got).tolist() == tensor.reshape(-1).tolist() == ref[
        "sup"][f"rank/{p}"]
    assert np.array_equal(_gathered(got), tc.degree_order(g))


@pytest.mark.parametrize("p", RANK_P)
@pytest.mark.parametrize("spec", ["rmat:7,8,3", "star:61"])
def test_mesh_degree_rank_where_p_does_not_divide_n(spec, p):
    """Shards of unequal length (``np.array_split``), and the padded
    ``(p, chunk)`` form: the degree order either way."""
    g = tc.graph_from_spec(spec)
    deg = g.degrees().astype(np.int64)
    sizes = [len(a) for a in np.array_split(deg, p)]
    got = distributed_degree_rank(_shards(deg, _ring(p), sizes))
    assert np.array_equal(_gathered(got), tc.degree_order(g))
    chunk = -(-g.n // p)
    padded = np.zeros(chunk * p, dtype=np.int64)
    padded[:g.n] = deg
    on_mesh = distributed_degree_rank(_shards(padded, _ring(p), [chunk] * p))
    tensor = distributed_degree_rank(torch.from_numpy(padded).view(p, -1))
    assert _gathered(on_mesh).tolist() == tensor.reshape(-1).tolist()


def test_mesh_degree_rank_moves_its_histograms(monkeypatch):
    """The all-reduce goes through the first position, the prefix along
    the ring: p histograms to the first device and the sum back to p
    positions (the first position's own copies counted), p - 1 along the
    ring."""
    p = 4
    g = tc.rmat(6, 6, seed=9)
    deg = g.degrees().astype(np.int64)
    with engine.tally_moved_bytes() as tally:
        distributed_degree_rank(_shards(deg, _ring(p), [g.n // p] * p))
    hist = (g.n + 1) * 8
    assert tally["reduce"] == p * hist
    assert tally["shift"] == (p - 1) * hist
    assert tally["broadcast"] == p * hist
    with pytest.raises(ValueError, match="one axis"):
        distributed_degree_rank(MeshArray(_cpu_mesh(2), {
            pos: torch.zeros(3, dtype=torch.int64)
            for pos in np.ndindex(2, 2)}))


# ----------------------------------------------------------------------
# chip_smoke.py's phase, rehearsed on the CPU
# ----------------------------------------------------------------------
def test_mesh_runtime_path_phase_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                     tmp_path):
    """``chip_smoke.py``'s ``mesh_runtime_path`` at scale 10 with every
    position on the CPU, the entry points' devices resolved to the CPU and
    the fused kernel's launch counter bumped where the engine would launch
    it (on the CPU the wrapper takes its plain route and counts
    nothing)."""
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
    scale = 10
    g = tc.rmat(scale, chip_smoke.EDGE_FACTOR, seed=1)
    oracle = chip_smoke.scipy_triangle_oracle(g.n, g.edges)
    q = chip_smoke.GRID
    tc.count_triangles(g, q=q, method="fused")  # the main path's plan
    graph = f"rmat:{scale},{chip_smoke.EDGE_FACTOR},1"
    side = {k: (graph, g, oracle) for k in ("split", "opt")}
    chip_smoke.mesh_runtime_path(g, oracle, cpu, q, graph, side)
    out = capsys.readouterr().out
    (line,) = [json.loads(ln)["mesh_runtime_path"] for ln in out.splitlines()
               if ln.startswith('{"mesh_runtime_path"')]
    assert line["ok"] and not line["failed"]
    assert line["positions"] == q * q and line["cards"] == ["cpu"]
    lost = line["device_lost"]
    assert lost["regrids"] == [dict(lost=chip_smoke.RUNTIME_LOST,
                                     grid=[3, 3], schedule="cannon")]
    assert lost["kernel_launches"] == lost["device_steps_counted"] > 0
    assert line["transient"]["restarts"] == 3
    assert "resumed at shift 4" in line["checkpointed_cli"]["resume"][
        "printed"]
    assert line["degree_rank"]["equal"]
    for name in chip_smoke.MESH_SPLIT_KINDS:
        assert line["time_split"][name]["triangles"] == oracle
        assert line["time_split"][name]["coll_shift_bytes"] > 0
    assert line["opt"]["triangles"] == oracle


# ----------------------------------------------------------------------
# the cards
# ----------------------------------------------------------------------
@pytest.mark.gpu
def test_runtime_over_four_cards(tmp_path, capsys):
    """One card a position: a supervised count regrids onto the first
    three cards, the stepper's partials on the 2 x 2 mesh equal one
    card's, and ``tc_run --mesh --ckpt-dir`` counts and resumes.
    ``python3 chip_smoke.py`` runs the runtime on the cards there are."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices: the mesh puts one position on "
                    "each card")
    g = tc.graph_from_spec("rmat:12,8,1")
    exp = tc.triangle_count_oracle(g)
    mesh = tc.make_grid_mesh(2)
    res = tr.supervised_count(
        g, mesh, method="fused", cache=tp.PlanCache(),
        fault_plan=tr.FaultPlan.parse("step@0=devicelost:1"))
    assert res.triangles == exp
    assert res.supervision["regrids"] == [
        dict(lost=1, grid=[1, 3], schedule="summa")]
    assert res.device == "cuda:0,cuda:1,cuda:2"
    plan = tp.plan_cannon(g, 2, cache=tp.PlanCache()).plan
    on_mesh = build_cannon_stepper(plan, mesh)
    one = build_cannon_stepper(plan)
    got = _run_stepper(plan, on_mesh, mesh, 2)
    base = _run_stepper(plan, one, "cuda:0", 2)
    for (_, acc, _), (_, acc1, _) in zip(got, base):
        assert {str(b.device) for b in acc.blocks.values()} == {
            f"cuda:{i}" for i in range(4)}
        assert _global(acc).tolist() == acc1.tolist()
    argv = ["--graph", "rmat:12,8,1", "--grid", "2", "--mesh", "--json",
            "--ckpt-dir", str(tmp_path)]
    tc_run.main(argv + ["--inject-faults", "step@1"])
    rep = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rep["triangles"] == exp and rep["device"] == ",".join(
        f"cuda:{i}" for i in range(4))
    tc_run.main(argv)
    assert "resumed at shift 2" in capsys.readouterr().out
