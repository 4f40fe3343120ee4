"""The port's shift-at-a-time Cannon stepper against the JAX package's.

``build_cannon_stepper`` must give, after every shift, the reference's
per-device partial counts and carry contents (the rolled ``(q, q, ...)``
operand stacks, two generations when double-buffered) at q in {2, 3}:
double-buffered, single-buffered and compacted (``cliques:3,60`` at
q = 3 elides steps; its live list is widened by one step, as the
reference's own test does, so a checkpoint lands between live steps).
The reference runs once, in one subprocess on 9 host devices.  Then the
port's own contract: a mid-loop checkpoint round trip, the refusals
(hub plans, ``fused`` and ``search2``, a cross-mode resume, a checkpoint
of another grid) and ``tc_run --ckpt-dir``'s resume and regrid.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.cannon import build_cannon_fn, build_cannon_stepper
from repro_torch.core.plan import CompactSchedule
from repro_torch.launch import tc_run
from repro_torch.pipeline.artifact import stage_arrays
from repro_torch.runtime import GridTransferRefused
from repro_torch.runtime.supervisor import check_partials_portable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (name, graph spec, q, double_buffer, compact, widen the live list)
CASES = (
    ("rmat_q2_db", "rmat:8,8,11", 2, True, None, False),
    ("rmat_q2_single", "rmat:8,8,11", 2, False, None, False),
    ("rmat_q3_db", "rmat:9,8,2", 3, True, None, False),
    ("rmat_q3_single", "rmat:9,8,2", 3, False, False, False),
    ("cliques_q3_compact", "cliques:3,60", 3, True, None, True),
    ("cliques_q3_db_full", "cliques:3,60", 3, True, False, False),
    ("cliques_q3_single_full", "cliques:3,60", 3, False, False, False),
)

STEPPER_CODE = """
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from repro.core import graph_from_spec
from repro.core.api import make_grid_mesh
from repro.core.cannon import build_cannon_stepper
from repro.core.plan import CompactSchedule
from repro.pipeline import plan_cannon
from repro.pipeline.cache import PlanCache

out = {{}}
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
    acc = jnp.zeros((q, q), jnp.int64)
    steps = stepper.live_steps if stepper.live_steps is not None else range(q)
    out[f"{{name}}/n_carry"] = np.asarray(stepper.n_carry)
    out[f"{{name}}/steps"] = np.asarray(list(steps))
    for i, c in enumerate(carry):
        out[f"{{name}}/prime/carry{{i}}"] = np.asarray(c)
    for s in steps:
        res = stepper(tuple(carry) + (acc,), statics, step=s)
        carry, acc = list(res[:-1]), res[-1]
        out[f"{{name}}/{{s}}/acc"] = np.asarray(acc)
        for i, c in enumerate(carry):
            out[f"{{name}}/{{s}}/carry{{i}}"] = np.asarray(c)
np.savez({path!r}, **out)
print("STEPPER-DUMPED")
"""


@pytest.fixture(scope="module")
def reference(distributed_runner, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stepper") / "ref.npz")
    out = distributed_runner(STEPPER_CODE.format(cases=CASES, path=path), 9)
    assert "STEPPER-DUMPED" in out
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _setup(spec, q, widen=False, cache=None):
    g = tc.graph_from_spec(spec)
    plan = tp.plan_cannon(g, q, cache=cache or tp.PlanCache()).plan
    if widen:
        live = plan.compact.live_steps
        extra = next(s for s in range(q) if s not in live)
        plan.compact = CompactSchedule(
            n_total=q, live_steps=tuple(sorted(set(live) | {extra})))
    return g, plan, stage_arrays(plan.device_arrays(), "cpu")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stepper_partials_and_carries_match_the_reference(reference, case):
    name, spec, q, db, compact, widen = case
    g, plan, arrays = _setup(spec, q, widen)
    stepper = build_cannon_stepper(plan, double_buffer=db, compact=compact)
    assert stepper.n_carry == int(reference[f"{name}/n_carry"])
    steps = (list(stepper.live_steps) if stepper.live_steps is not None
             else list(range(q)))
    assert steps == reference[f"{name}/steps"].tolist()
    carry = stepper.prime(arrays)
    for i, c in enumerate(carry):
        np.testing.assert_array_equal(c.numpy(),
                                      reference[f"{name}/prime/carry{i}"])
    acc = torch.zeros((q, q), dtype=torch.int64)
    for s in steps:
        out = stepper((*carry, acc), arrays, step=s)
        carry, acc = out[:-1], out[-1]
        assert acc.dtype == torch.int64
        np.testing.assert_array_equal(acc.numpy(), reference[f"{name}/{s}/acc"])
        for i, c in enumerate(carry):
            np.testing.assert_array_equal(
                c.numpy(), reference[f"{name}/{s}/carry{i}"],
                err_msg=f"{name} step {s} carry {i}")
    assert int(acc.sum()) == tc.triangle_count_oracle(g)


def test_carry_arity():
    _, plan, _ = _setup("rmat:8,8,11", 2)
    assert build_cannon_stepper(plan).n_carry == 8
    assert build_cannon_stepper(plan, double_buffer=False).n_carry == 4
    _, plan, _ = _setup("cliques:3,60", 3)
    stepper = build_cannon_stepper(plan)
    assert stepper.live_steps == (0,) and stepper.n_carry == 4
    assert build_cannon_stepper(plan, compact=False).n_carry == 8


@pytest.mark.parametrize("db", [True, False])
@pytest.mark.parametrize("spec,q,widen", [("rmat:8,8,11", 2, False),
                                          ("cliques:3,60", 3, True)])
def test_checkpoint_round_trip_mid_loop(tmp_path, spec, q, widen, db):
    """Checkpoint the state before the second step, restore it through
    the manager, replay the tail: the count and every carry tensor equal
    the uninterrupted loop's (the reference's stepper round trips)."""
    g, plan, arrays = _setup(spec, q, widen)
    stepper = build_cannon_stepper(plan, double_buffer=db)
    steps = (list(stepper.live_steps) if stepper.live_steps is not None
             else list(range(q)))
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    carry, acc = stepper.prime(arrays), torch.zeros((q, q), dtype=torch.int64)
    for s in steps:
        if s == steps[1]:
            st = {f"carry{i}": c for i, c in enumerate(carry)}
            st["acc"] = acc
            mgr.save(s, st, extra={"shift": s})
        out = stepper((*carry, acc), arrays, step=s)
        carry, acc = out[:-1], out[-1]
    mgr.wait()
    like = {f"carry{i}": arrays["a_indptr"] for i in range(stepper.n_carry)}
    like["acc"] = torch.zeros((q, q), dtype=torch.int64)
    _, st, extra = mgr.restore_latest(like)
    mgr.close()
    carry2 = tuple(st[f"carry{i}"] for i in range(stepper.n_carry))
    acc2 = st["acc"]
    for s in [t for t in steps if t >= extra["shift"]]:
        out = stepper((*carry2, acc2), arrays, step=s)
        carry2, acc2 = out[:-1], out[-1]
    assert int(acc.sum()) == int(acc2.sum()) == tc.triangle_count_oracle(g)
    for a, b in zip(carry, carry2):
        assert a.dtype == b.dtype and torch.equal(a, b)
    fn = build_cannon_fn(plan)
    assert int(fn(**arrays)) == tc.triangle_count_oracle(g)


def test_stepper_refusals():
    g = tc.graph_from_spec("rmat:8,8,11")
    hub = tp.plan_cannon(g, 2, hub_split=2.0, cache=tp.PlanCache())
    assert hub.plan.hub is not None
    with pytest.raises(ValueError, match="no slot for the hub-split"):
        build_cannon_stepper(hub)
    _, plan, arrays = _setup("rmat:8,8,11", 2)
    for method in ("fused", "search2"):
        with pytest.raises(ValueError, match="n_long/d_small"):
            build_cannon_stepper(plan, method=method)
    stepper = build_cannon_stepper(plan, method="global")
    carry = stepper.prime(arrays)
    with pytest.raises(ValueError, match="expected 8"):
        stepper((*carry[:4], torch.zeros((2, 2), dtype=torch.int64)), arrays)
    _, plan, arrays = _setup("cliques:3,60", 3)
    stepper = build_cannon_stepper(plan)
    with pytest.raises(ValueError):  # the host loop must pass a live step
        stepper((*stepper.prime(arrays), torch.zeros((3, 3))), arrays, step=1)


def test_partials_never_move_between_grids():
    check_partials_portable({"grid": "4x4", "shift": 2}, "4x4")
    for saved, now in (("4x4", "3x3"), ("2x2", "3x3"), ("3x3", "1x1")):
        with pytest.raises(GridTransferRefused, match="from grid"):
            check_partials_portable({"grid": saved}, now)


# ----------------------------------------------------------------------
# tc_run --ckpt-dir
# ----------------------------------------------------------------------
def _run(capsys, *argv):
    tc_run.main(["--graph", "rmat:9", "--device", "cpu", "--json", *argv])
    out = capsys.readouterr().out
    return out, json.loads([ln for ln in out.splitlines()
                            if ln.startswith("{")][-1])


def test_tc_run_resumes_and_refuses_a_cross_mode_checkpoint(tmp_path,
                                                            capsys):
    d = str(tmp_path / "c")
    out, rep = _run(capsys, "--grid", "2", "--ckpt-dir", d,
                    "--fail-at-shift", "1", "--verify")
    assert "(injected failure at shift 1; restarting from ckpt)" in out
    assert rep["correct"] and rep["checkpointed"]
    assert rep["live_steps"] == rep["schedule_shifts"] == 2
    out, again = _run(capsys, "--grid", "2", "--ckpt-dir", d, "--verify")
    assert "resumed at shift 2" in out and again["correct"]
    with pytest.raises(SystemExit, match="collectives"):
        _run(capsys, "--grid", "2", "--ckpt-dir", d,
             "--reduce-strategy", "flat")
    # a compacted checkpoint (cliques:3,60 elides two of three steps; one
    # carry generation) under --no-compact: two generations, or with
    # --no-double-buffer one, and another step list
    d2 = str(tmp_path / "k")
    tc_run.main(["--graph", "cliques:3,60", "--grid", "3", "--ckpt-dir", d2,
                 "--device", "cpu", "--json"])
    capsys.readouterr()
    base = ["--graph", "cliques:3,60", "--grid", "3", "--ckpt-dir", d2,
            "--no-compact", "--device", "cpu"]
    with pytest.raises(SystemExit, match="missing 'carry4"):
        tc_run.main(base)
    with pytest.raises(SystemExit, match=r"steps \[0\] vs \[0,1,2\]"):
        tc_run.main(base + ["--no-double-buffer"])
    # a single-buffered checkpoint under the double-buffered carry
    d3 = str(tmp_path / "s")
    _run(capsys, "--grid", "2", "--ckpt-dir", d3, "--no-double-buffer")
    with pytest.raises(SystemExit, match="missing"):
        _run(capsys, "--grid", "2", "--ckpt-dir", d3)


def test_tc_run_regrid_refuses_to_move_partials(tmp_path, capsys):
    d = tmp_path / "r"
    out, rep = _run(capsys, "--grid", "3", "--ckpt-dir", str(d),
                    "--inject-faults", "step@1=devicelost:5", "--verify")
    assert rep["correct"] and rep["final_grid"] == [2, 2]
    assert "(device lost: refusing to transfer" in out
    assert "from grid 3x3 to 2x2" in out
    assert rep["supervision_regrids"] == [
        dict(lost=5, grid=[2, 2], ckpt_dir=str(d / "regrid_2x2"))]
    assert sorted(os.listdir(d / "regrid_2x2")) == [
        "step_0000000001.json", "step_0000000001.npz",
        "step_0000000002.json", "step_0000000002.npz"]


def test_tc_run_stages_once_a_grid(tmp_path, capsys, monkeypatch):
    """Every attempt of the checkpointed loop counts from the same staged
    tensors: a supervised run with three faults stages the plan once."""
    import repro_torch.pipeline.artifact as artifact

    staged = []
    plain = artifact.stage_arrays
    monkeypatch.setattr(artifact, "stage_arrays",
                        lambda arrays, device: staged.append(1) or plain(
                            arrays, device))
    _, rep = _run(capsys, "--graph", "rmat:9,8,7", "--grid", "2",
                  "--ckpt-dir", str(tmp_path),
                  "--inject-faults", "step@0;step@1;ckpt_save@2=stepfault",
                  "--verify")
    assert rep["correct"] and rep["supervision_restarts"] == 3
    assert staged == [1]
