"""Rehearse ``chip_smoke.py``'s planner-stage phases on the CPU.

The script runs only on a GPU; its ``hub_path``, ``rebalance_path``,
``many_path``, ``delta_path``, ``serve_path``, ``pod_path`` and
``measured_path`` phases, its ``search2`` phase, its ``dryrun_path``
and ``substrate_path`` phases and its ``lm_path``, ``lm_train_path``
and ``lm_mesh_path`` phases (on ``-smoke``
configs only) are called here at a tiny scale with ``dev=cpu``,
with the CUDA timing calls stubbed, the entry points' device resolved to
the CPU, and the fused kernel's launch counter bumped where the engine
would launch it (on the CPU the wrapper takes its plain route and counts
nothing).  Each phase must print its JSON line with ``ok: true`` — so a
phase reaches the card tried.
"""
import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch

import repro_torch as rt
import repro_torch.core.api as api
import repro_torch.kernels.tc_fused as tf
import repro_torch.pipeline.batch as batch
from repro_torch.kernels.tc_fused import tc_fused as kmod
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
CPU = torch.device("cpu")
SCALE = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Event:
    """Host-clock stand-in for ``torch.cuda.Event``."""

    def __init__(self, **kw):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(api, "resolve_device", lambda device=None: CPU)
    monkeypatch.setattr(batch, "resolve_device", lambda device=None: CPU)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    plain = tf.count_pair_fused

    def counted(*args, **kw):
        kmod.LAUNCHES += 1
        return plain(*args, **kw)

    monkeypatch.setattr(tf, "count_pair_fused", counted)
    monkeypatch.setattr(chip_smoke, "profile_count", _profile_on_cpu)


def _profile_on_cpu(count, expect, **kw):
    """``profile_count`` with the CPU activity only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        count()
    return {"expected_launches": int(expect), "cpu_only": True}


def _line(capsys, tag):
    out = capsys.readouterr().out
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    mine = [r[tag] for r in rows if tag in r]
    assert len(mine) == 1, out[-2000:]
    return mine[0]


@pytest.fixture(scope="module")
def graph():
    g = rt.rmat(SCALE, chip_smoke.EDGE_FACTOR, seed=1)
    return g, chip_smoke.scipy_triangle_oracle(g.n, g.edges)


def test_hub_path_phase(on_cpu, graph, capsys):
    g, oracle = graph
    rows = chip_smoke.hub_path(g, oracle, CPU, f"rmat:{SCALE}")
    line = _line(capsys, "hub_path")
    assert line["ok"] and not line["mismatches"]
    for kind in ("oned", "cannon"):
        row = line[kind]
        assert row["triangles"] == oracle
        assert row["hub"]["hub_rows"] > 0
        assert row["kernel_launches"] == row["device_steps_counted"] > 0
        assert row["tasks_past_stage_limit"] == 0
    # the ring only: Cannon's warm count, search and halves were cut for
    # the LM training path
    row = line["oned"]
    assert row["triangles_search"] == oracle and row["cache_hit"]
    assert row["hub_partial"]["triangles"] + row["residual"][
        "triangles"] == oracle
    assert "triangles_search" not in line["cannon"]
    # the ring's hub partial at chunk 512 was cut for the LM training path
    assert "hub_partial_chunk512" not in line["oned"]
    (rec,) = rows
    assert rec["path"] == "oned_hub" and rec["equal"]
    assert rec["launches"] == line["oned"]["kernel_launches"]
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "source", "replaces", "route"):
        assert key in rec


def test_rebalance_path_phase(on_cpu, graph, capsys):
    g, oracle = graph
    rt.count_triangles(g, q=chip_smoke.GRID, method="fused")
    chip_smoke.rebalance_path(g, oracle, CPU, chip_smoke.GRID)
    line = _line(capsys, "rebalance_path")
    assert line["ok"] and set(line["triangles"]) == {oracle}
    assert len(line["trials"]) == chip_smoke.REBALANCE_TRIALS
    assert line["kernel_launches"] == line["device_steps_counted"] > 0
    assert len(line["warm_count_seconds"]["plain"]) == 2


def test_many_path_phase(on_cpu, capsys):
    chip_smoke.many_path(CPU, 1, (7, 8, 9))
    line = _line(capsys, "many_path")
    assert line["ok"] and not line["mismatches"]
    assert len(line["graphs"]) == 5
    for kind, _, chunk in chip_smoke.MANY_CELLS:
        row = line[f"{kind}/chunk{chunk}"]
        assert row["triangles"] == line["triangles_scipy_oracle"]
        assert row["padding_overhead"] > 0
    # the ring's chunk-512 batch was cut for the LM training path
    assert [(kind, chunk) for kind, _, chunk in chip_smoke.MANY_CELLS] == [
        ("cannon", 8192), ("oned", 8192)]


def test_delta_path_phase(on_cpu, graph, capsys, monkeypatch):
    g, oracle = graph
    monkeypatch.setattr(chip_smoke, "STREAM_GRAPH", "rmat:9")
    rt.count_triangles(g, q=chip_smoke.GRID, method="fused")
    rec = chip_smoke.delta_path(g, oracle, CPU, chip_smoke.GRID, 1)
    line = _line(capsys, "delta_path")
    assert line["ok"] and not line["mismatches"]
    assert line["levels"] == list(chip_smoke.DELTA_PLANNED)
    assert line["levels_as_planned"] and line["replay_cache_hit"]
    for row in line["rounds"]:
        assert row["triangles"] == row["expected"]
        assert row["kernel_launches"] == row["device_steps_counted"] > 0
    assert line["tc_run_stream"]["correct"]
    assert rec["path"] == "cannon_delta" and rec["equal"]
    assert rec["launches"] == line["kernel_launches"] > 0
    assert 0 < rec["compared_device_steps"] <= chip_smoke.GRID ** 3
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "source", "replaces", "route"):
        assert key in rec


def test_serve_path_phase(on_cpu, graph, capsys, monkeypatch):
    g, oracle = graph
    monkeypatch.setattr(chip_smoke, "OPT_GRAPH", "rmat:9,16,1")
    monkeypatch.setattr(chip_smoke, "SPLIT_GRAPH", "rmat:8,16,1")
    monkeypatch.setattr(chip_smoke, "SERVE_BATCH", "named:karate;rmat:8")
    rt.count_triangles(g, q=chip_smoke.GRID, method="fused")
    spec = f"rmat:{SCALE},{chip_smoke.EDGE_FACTOR},1"
    rec = chip_smoke.serve_path(g, oracle, CPU, chip_smoke.GRID, spec)
    out = capsys.readouterr().out
    lines = {}
    for ln in out.splitlines():
        if ln.startswith("{"):
            lines.update(json.loads(ln))
    assert lines["serve_path"]["ok"]
    stream = lines["serve_stream"]
    assert stream["ok"] and len(stream["triangles"]) == chip_smoke.SERVE_ROUNDS
    assert stream["triangles"] == stream["expected"]
    assert "1 restarts" in stream["supervision"]
    batch = lines["serve_batch"]
    assert batch["ok"] and batch["warm"] == [False, True, True]
    assert list(batch["triangles"].values()) == [[45, 10843]] * 3
    opt = lines["tc_run_opt"]
    assert opt["optimized"] is True
    assert opt["triangles"] == opt["triangles_scipy_oracle"]
    for kind in ("cannon", "summa", "oned"):
        row = lines["tc_run_time_split"][f"time_split_{kind}"]
        assert row["triangles"] == row["triangles_scipy_oracle"]
    blob = lines["serve_blob"]
    assert blob["ok"] and not blob["mismatches"]
    assert blob["blob"]["kernel_launches"] == blob["arrays"][
        "kernel_launches"] > 0
    assert blob["blob"]["moved_bytes"]["shift"] == blob["arrays"][
        "moved_bytes"]["shift"] > 0
    assert blob["arrays"]["moved_bytes"]["other"] == 0
    assert rec["path"] == "serve_stream" and rec["equal"]
    assert rec["launches"] == stream["kernel_launches"] > 0
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "source", "replaces", "route"):
        assert key in rec


@pytest.mark.parametrize("spec,rounds", [
    ("named:karate", (4, 6, 20)),
    ("rmat:8,8,3", (4, 64, 2)),
    ("er:60,12,1", (10, 30)),
    ("cliques:3,12", (6, 6)),
])
def test_incremental_oracle_matches_the_exact_count(spec, rounds):
    """The delta path's oracle, round by round, against
    ``triangle_count_oracle`` of the mutated graph."""
    g = rt.graph_from_spec(spec)
    deltas, changes, cur = chip_smoke.delta_stream((g.n, g.edges), rounds, 5)
    want = rt.triangle_count_oracle(g)
    keys = chip_smoke.EdgeKeys(g.n, g.edges)
    for (rem, add), change, k in zip(deltas, changes, rounds):
        assert rem.shape[0] + add.shape[0] == k
        want += change
        for a, b in rem.tolist():
            assert keys.has(a, b)
        for a, b in add.tolist():
            assert not keys.has(a, b)
        keys.apply(rem[:, 0] * g.n + rem[:, 1], add[:, 0] * g.n + add[:, 1])
        mutated = rt.Graph(n=g.n, edges=keys.pairs(keys.keys))
        assert want == rt.triangle_count_oracle(mutated)
    assert np.array_equal(keys.keys, cur.keys)


def test_pod_path_phase(on_cpu, graph, capsys):
    g, oracle = graph
    rt.count_triangles(g, q=chip_smoke.GRID, method="fused")
    rec = chip_smoke.pod_path(g, oracle, CPU, chip_smoke.GRID)
    line = _line(capsys, "pod_path")
    assert line["ok"] and not line["mismatches"]
    assert [(r["npods"], r["reduce_strategy"]) for r in line["pods"]] == [
        tuple(run) for run in chip_smoke.POD_RUNS]
    for row in line["pods"]:
        assert row["triangles"] == row["triangles_warm"] == oracle
        assert row["grid"] == [row["npods"], chip_smoke.GRID, chip_smoke.GRID]
        assert row["kernel_launches"] == row["device_steps_counted"] > 0
        assert row["device_steps_skipped"] == (
            chip_smoke.GRID ** 3 - row["device_steps_counted"])
        # A and B are uploaded per pod count, the task lists are shared
        assert row["staged_bytes"]["tasks"] == 0
        assert row["staged_bytes"]["ab"] == row["npods"] * line[
            "single_pod"]["staged_bytes"]["ab"]
    # one count's whole footprint on the raw plan, one pod and each pod
    # count of POD_RUNS
    assert sorted(line["footprint_by_npods"], key=int) == [
        str(n) for n in sorted({1} | {n for n, _ in chip_smoke.POD_RUNS})]
    for row in line["pods"]:
        assert "bytes_left_allocated_by_count" in row
    assert rec["path"] == "cannon_pods" and rec["equal"]
    assert rec["compared_device_steps"] == 2 * chip_smoke.POD_COMPARE
    assert rec["launches"] == sum(r["kernel_launches"] for r in line["pods"])
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "source", "replaces", "route"):
        assert key in rec


@pytest.mark.parametrize("kind,grid", [("cannon", (4, 4)), ("summa", (2, 8)),
                                       ("oned", (4, 4))])
def test_measured_count_phase(on_cpu, graph, tmp_path, kind, grid):
    g, oracle = graph
    rt.count_triangles(g, grid=grid, schedule=kind, method="fused")
    row, ok = chip_smoke.measured_count(kind, g, oracle, CPU, grid,
                                        str(tmp_path))
    assert ok and row["plan_cache_hit"]
    assert row["measured_table_hit"] == [False, True]
    assert row["triangles"] == [oracle, oracle]
    assert row["resolved"][0] == row["resolved"][1]
    assert row["entry"]["baseline"] == ("search" if kind == "oned"
                                        else "search2")
    assert len(row["candidate_checks"]) == len(row["entry"]["candidates"])
    assert all(c["equal"] for c in row["candidate_checks"])
    if row["resolved"][1] == "fused":
        assert row["warm_kernel_launches"] == row["device_steps_counted"]


def test_search2_phase(on_cpu, graph, capsys):
    g, oracle = graph
    chip_smoke.search2_phase(g, oracle, chip_smoke.GRID, SCALE, 1)
    line = _line(capsys, "search2")
    assert line["ok"] and not line["mismatches"]
    assert line["search2"]["graph"] == f"rmat:{SCALE},16,1"
    assert line["auto"]["graph"] == (
        f"rmat:{SCALE - chip_smoke.AUTO_SCALE_CUT},16,1")
    assert line["auto"]["triangles"] == line["auto"]["triangles_scipy_oracle"]


def test_runtime_path_phase(on_cpu, graph, capsys):
    g, oracle = graph
    rt.count_triangles(g, q=chip_smoke.GRID, method="fused")
    spec = f"rmat:{SCALE},{chip_smoke.EDGE_FACTOR},1"
    rec = chip_smoke.runtime_path(g, oracle, CPU, chip_smoke.GRID, spec)
    line = _line(capsys, "runtime_path")
    assert line["ok"] and not line["failed"]
    tr = line["transient"]
    assert tr["triangles"] == oracle and tr["restarts"] == 3
    assert [a["point"] for a in tr["attempts"][:3]] == [
        "plan_stage", "device_stage", "step"]
    assert tr["kernel_launches"] == tr["device_steps_counted"] > 0
    per = line["persistent"]
    assert per["method"] == "search2" and per["triangles"] == oracle
    assert per["demotions"][0]["frm"] == "fused"
    lost = line["device_lost"]
    assert lost["grid"] == [3, 3] and lost["triangles"] == oracle
    assert lost["regrids"] == [
        {"lost": chip_smoke.RUNTIME_LOST, "grid": [3, 3],
         "schedule": "cannon"}]
    cli = line["checkpointed_cli"]
    assert cli["faults"]["corrupt_files"] and cli["faults"]["restarts"] >= 1
    assert {r["triangles"] for r in cli.values()} == {oracle}
    # the faults run saves a shift at a time (the corrupted step 1 too,
    # and again after redoing shift 0); the resume only restores; the
    # --fail-at-shift run was cut for the LM training path
    assert [s["step"] for s in cli["faults"]["saves"]] == [1, 1, 2, 3, 4]
    assert "fail_at_shift" not in cli
    assert all(s["bytes"] > 0 for s in cli["faults"]["saves"])
    assert cli["resume"]["saves"] == []
    assert rec["path"] == "cannon_regrid" and rec["equal"]
    assert rec["launches"] == lost["kernel_launches"]
    assert rec["compared_device_steps"] == lost["device_steps_counted"]
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "source", "replaces", "route"):
        assert key in rec


def test_dryrun_path_phase(on_cpu, capsys):
    """The 24 dry-run cells on meta (18 triangle-count cells, Twitter's
    two beyond-paper schedules and four model cells), the walk of a real
    plan against the count (the CUDA peak is stubbed to 0 here: the staged
    bytes alone), and the analytic plan of a main graph beside its real
    plan."""
    g = rt.rmat(SCALE, chip_smoke.EDGE_FACTOR, seed=1)
    art = rt.count_triangles(g, q=4, method="fused", device="cpu").artifact
    chip_smoke.dryrun_path(CPU, art.plan, SCALE, real_scale=SCALE)
    out = capsys.readouterr().out
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    cells = [r["dryrun_cell"] for r in rows if "dryrun_cell" in r]
    assert len(cells) == 24 and all(c["status"] == "ok" for c in cells)
    assert [c["name"] for c in cells[20:]] == [
        ":".join(c) for c in chip_smoke.DRYRUN_MODEL]
    assert [c["name"] for c in cells[:18]] == [
        ":".join(c) for c in dryrun.all_cells()[-18:]]
    (line,) = [r["dryrun_path"] for r in rows if "dryrun_path" in r]
    assert line["cells"] == 24
    assert set(line["model_cell_seconds"]) == {
        ":".join(c) for c in chip_smoke.DRYRUN_MODEL}
    assert line["ok"] and not line["failed_cells"]
    real = line["real_plan"]
    assert real["args_equal"]
    assert real["triangles"] == real["triangles_scipy_oracle"]
    assert real["walk_grid_bytes"] >= real["staged_bytes_cuda"]
    main = line["main_graph"]
    assert main["nnz_pad"]["real"] == art.plan.nnz_pad
    assert main["tmax"]["analytic"] == main["nnz_pad"]["analytic"]


def test_substrate_path_phase(capsys):
    chip_smoke.substrate_path(CPU)
    line = _line(capsys, "substrate_path")
    assert line["ok"] and not line["failed"]
    assert line["adamw"]["steps"] == line["adafactor"]["steps"] == 20
    assert line["compressed_psum"]["equal"]
    assert line["compressed_psum"]["rel_err_to_plain_sum"] < 0.02
    for k in ("segment_sum", "segment_softmax", "degree", "spmm_max",
              "embedding_bag_mean"):
        assert line[k]["err_over_tol"] == 0.0


def _profile_lm_on_cpu(count, expect, **kw):
    """``profile_count`` with the CPU activity only, with the keys the LM
    path reads (no device activity to count here)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        count()
    return {"device_launches": 0, "device_seconds": 0.0,
            "profiled_wall_seconds": time.perf_counter() - t0,
            "device_busy_share_of_profiled_wall": None, "top": [],
            "cpu_only": True}


def test_lm_path_phase(on_cpu, capsys, monkeypatch):
    """The five smoke configs in both dtypes (the CPU against itself, the
    router teacher-forced as on the card), then the full-width parts on
    qwen2-0.5b-smoke in its place: a 2,048-token prefill, prompts
    prefilled and decoded, ``serve``'s loop, a profiled decode step and
    the float32 comparison."""
    monkeypatch.setattr(chip_smoke, "profile_count", _profile_lm_on_cpu)
    chip_smoke.lm_path(CPU, "cpu", full="qwen2-0.5b-smoke")
    line = _line(capsys, "lm_path")
    assert line["ok"] and not line["failed"]
    assert len(line["smoke"]) == 10
    for key, row in line["smoke"].items():
        assert row["ok"] and row["router_flips"] == 0, key
        assert row["err_hidden"] == row["err_logits"] == 0.0, key
        assert row["tokens_decided"] == row["tokens_equal"] > 0, key
        moe = key.startswith(("grok", "deepseek"))
        assert (row["router_calls"] > 0) == moe, key
    full = line["full_bf16"]
    assert full["prefill_chunks"] == [512, 1024]
    assert len(full["prefill_ms"]) == chip_smoke.LM_PREFILL_REPS
    assert full["param_bytes"] == 2 * full["param_numel"]
    dvp = full["decode_vs_prefill"]
    assert dvp["ok"] and dvp["err"] <= dvp["tol"]
    assert dvp["steps"] == chip_smoke.LM_PROMPT_LEN
    assert dvp["argmax_equal"] == dvp["decided"] > 0
    dvc = full["decode_vs_cpu"]  # the CPU against itself: exact
    assert dvc["ok"] and dvc["err_logits"] == dvc["err_cache"] == 0.0
    assert dvc["steps"] == chip_smoke.LM_CPU_STEPS
    assert dvc["tokens_equal"] == dvc["decided"] > 0
    fault = full["planted_fault"]
    assert fault["caught_vs_cpu"] and fault["err_vs_cpu"] > dvc["tol"][1]
    assert full["serve"]["tokens_in_vocab"]
    assert full["decode_bytes"] < full["param_bytes"]
    f32 = line["full_f32"]
    assert f32["err_hidden"] == f32["err_logits"] == 0.0
    f32_decode = f32["decode_vs_cpu"]
    assert f32_decode["ok"] and f32_decode["steps"] == 16
    assert f32_decode["err_logits"] == f32_decode["err_cache"] == 0.0
    assert not f32["matmul_allow_tf32"]


def test_lm_train_path_phase(on_cpu, capsys, monkeypatch):
    """The five smoke configs' train step in both dtypes (the CPU against
    itself, the router teacher-forced as on the card), the float32 loss
    curve, the full-width parts on qwen2-0.5b-smoke in qwen2-0.5b's place
    (a fall of 0.1 nat over its eight steps, where qwen2-0.5b's batch of
    32 x 512 must fall 1 nat), the planted dropped microbatch, and the
    ``train`` CLI's resume."""
    monkeypatch.setattr(chip_smoke, "profile_count", _profile_lm_on_cpu)
    chip_smoke.lm_train_path(CPU, "cpu", full="qwen2-0.5b-smoke",
                             full_batch=(4, 32), f32_batch=(4, 16),
                             full_fall=0.1)
    line = _line(capsys, "lm_train_path")
    assert line["ok"] and not line["failed"]
    # ten with AdamW, six with Adafactor (the three full configs that
    # train with it)
    assert len(line["smoke"]) == 16
    for key, row in line["smoke"].items():
        assert row["ok"] and row["router_flips"] == 0, key
        for k in ("loss", "states", "params"):  # the CPU against itself
            assert row[f"err_{k}"] == 0.0, (key, k)
        moe = key.startswith(("grok", "deepseek"))
        assert (row["router_calls"] > 0) == moe, key
        assert ("err_grad_norm" in row) == key.endswith("/adamw"), key
    curve = line["curve"]
    assert curve["ok"] and curve["err"] == 0.0
    assert len(curve["losses"]["card"]) == chip_smoke.LM_CURVE[1]
    assert min(curve["fall"].values()) >= chip_smoke.LM_CURVE_FALL
    full = line["full_bf16"]
    assert len(full["losses"]) == chip_smoke.LM_FULL_TRAIN_STEPS
    assert full["fall"] >= 0.1 and full["microbatch"] == 2
    assert full["tokens_per_step"] == 4 * 32
    assert full["n_multiplied"] == full["param_numel"] - 512 * 64
    # the dry run's walk of the very step: FLOPs equal FlopCounterMode's
    # count of a real step (the CUDA peak is stubbed to 0 here); at two
    # layers and two microbatches the plan is the step itself, one walk
    walk = full["walk"]
    assert walk["flops_equal"] and walk["card_flops"] > 0
    assert walk["walks"] == 1 and not walk["under"]
    assert walk["walk_peak"] > 0 and walk["walk_over_measured"] is None
    for key in ("remat_off", "indexed_layers"):
        assert not full[key]["oom"]
        assert full[key]["loss"] == pytest.approx(full["losses"][-1],
                                                  abs=1.0)
    # indexing the stacks changes where gradients come from, not a bit
    assert full["indexed_layers"]["loss"] == full["remat_off"]["loss"]
    f32 = line["full_f32"]
    assert f32["err_loss"] == f32["err_states"] == f32["err_params"] == 0.0
    assert not f32["matmul_allow_tf32"]
    fault = f32["planted_fault"]
    assert fault["caught"] and fault["loss_calls"] == 2
    assert fault["err_loss"] == 0.0  # the value kept, the gradient gone
    assert fault["err_over_tol"]["states"] > 1
    cli = line["cli"]
    assert cli["resumed"] and cli["err_resumed_vs_whole"] == 0.0
    assert cli["lines"][0] == "resumed at step 10"
    assert cli["checkpoints"] == ["step_0000000010.json",
                                  "step_0000000010.npz",
                                  "step_0000000020.json",
                                  "step_0000000020.npz"]


def test_lm_mesh_path_phase(on_cpu, capsys, monkeypatch):
    """The five smoke configs' train, prefill and decode steps on a (2, 2)
    mesh of four CPU positions against one device in both dtypes, each
    train step's parameter traffic equal to its closed form, both planted
    faults caught (the gradients' reduce-scatter over ``data`` skipped;
    the decode combine without its rescale), and the full-width parts on
    qwen2-0.5b-smoke in qwen2-0.5b's place at small shapes."""
    monkeypatch.setattr(chip_smoke, "profile_count", _profile_lm_on_cpu)
    chip_smoke.lm_mesh_path(CPU, "cpu", full="qwen2-0.5b-smoke",
                            train=(8, 64), prefill=(1, 128), decode=(4, 12))
    line = _line(capsys, "lm_mesh_path")
    assert line["ok"] and not line["failed"]
    assert line["mesh"] == [2, 2] and line["devices"] == ["cpu"] * 4
    assert len(line["smoke"]) == 10
    for key, row in line["smoke"].items():
        assert row["ok"] and row["train"]["param_bytes_equal"], key
        moe = key.startswith(("grok", "deepseek"))
        assert (row["train"]["collective_bytes"].get("all_gather:route", 0)
                > 0) == moe, key
    faults = line["planted_faults"]
    assert faults["no_grad_reduce_scatter"]["caught"]
    assert faults["no_grad_reduce_scatter"]["err_states"] > \
        chip_smoke.LM_TRAIN_TOL["float32"]["states"]
    assert faults["no_decode_rescale"]["caught"]
    full = line["full"]
    assert full["ok"] and len(full["train"]) == chip_smoke.LM_MESH_FULL_STEPS
    first = full["train"][0]
    assert first["param_bytes_equal"] and first["err_params"] <= \
        chip_smoke.LM_TRAIN_TOL["bfloat16"]["params"]
    for diag in ("f32_partials", "one_device_rows_split"):
        assert first[diag]["err_states"] <= \
            chip_smoke.LM_TRAIN_TOL["bfloat16"]["states"], diag
    pre = full["prefill"]
    assert pre["ok"] and pre["token_equal"]
    assert pre["err_logits"] <= chip_smoke.LM_FULL_CPU_TOL
    assert full["decode"]["ok"] and full["decode"]["tokens_differ"] == 0
    assert full["decode"]["err_prefill_logits"] <= chip_smoke.LM_FULL_CPU_TOL
    assert line["seconds"] <= chip_smoke.LM_MESH_BUDGET_S


@pytest.mark.gpu
def test_lm_mesh_path_on_the_card(capsys):
    """``lm_mesh_path`` as the card runs it: four positions on ``cuda:0``
    (``python3 chip_smoke.py`` runs it there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase's mesh lies on cuda:0")
    dev = torch.device("cuda", 0)
    chip_smoke.lm_mesh_path(dev, "card", full="qwen2-0.5b-smoke",
                            train=(8, 64), prefill=(1, 128), decode=(4, 12))
    assert _line(capsys, "lm_mesh_path")["ok"]


def test_lm_train_checks_catch_a_dropped_microbatch_on_a_smoke_config():
    """The planted fault on a smoke config in both dtypes: the loss keeps
    its value, and the states (and AdamW's grad norm) leave their bounds."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer as tr

    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("qwen2-0.5b-smoke"), dtype=dtype)
        params = tr.lm_init(torch.Generator().manual_seed(0), cfg,
                            device=CPU)
        batch = TokenPipeline(cfg.vocab, 4, 32).next_batch()
        ref = chip_smoke._lm_train_once(cfg, params, batch, 2000, CPU)
        with chip_smoke._lm_planted_dropped_microbatch() as calls:
            bad = chip_smoke._lm_train_once(cfg, params, batch, 2000, CPU)
        tol = chip_smoke.LM_TRAIN_TOL[dtype]
        errs, ok = chip_smoke.lm_step_errs(bad, ref, cfg, 2000, tol)
        assert calls[0] == 2 and not ok, dtype
        assert errs["loss"] == 0.0
        assert errs["states"] > tol["states"]
        assert errs["grad_norm"] > tol["grad_norm"]


def test_lm_prefill_flops_counts_the_causal_triangle():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr

    cfg = get_config("qwen2-0.5b")
    params = tr.lm_init(None, cfg, device="meta")
    flops = chip_smoke._lm_prefill_flops(cfg, params, 1, 2048)
    d, ff, h, dh, kv = 896, 4864, 14, 64, 2
    mats = 24 * (d * h * dh * 2 + 2 * d * kv * dh + 3 * d * ff)
    att = 24 * 2 * 2048 ** 2 * h * dh
    assert flops == 2 * 2048 * mats + 2 * d * 151936 + att


def test_recsys_path_phase(on_cpu, capsys, monkeypatch):
    """DLRM's smoke config (the CPU against itself: exact) with the
    planted pair order caught, then the full-width parts at the published
    widths with every table cut to 64 rows, a batch of 256 for 4 steps,
    serving 16 and 256, and 60 retrieval candidates."""
    monkeypatch.setattr(chip_smoke, "profile_count", _profile_lm_on_cpu)
    chip_smoke.recsys_path(CPU, "cpu",
                           full_cfg=chip_smoke.capped_recsys(cap=64),
                           train=(256, 4), serve=(16, 5, 256, 2), n_cand=60)
    line = _line(capsys, "recsys_path")
    assert line["ok"]
    smoke = line["smoke"]
    for k in ("loss", "grad_norm", "states", "params", "probs"):
        assert smoke[f"err_{k}"] == 0.0, k
    top = smoke["retrieval"]
    assert top["k"] == 40 and top["idx_equal"] == 40 and top["distinct"]
    fault = smoke["planted_pair_order"]
    assert fault["caught"] and fault["err_probs"] > chip_smoke.MODEL_OUT_TOL
    full = line["full"]
    assert full["rows_cap"] == 64 and full["rows"] == 26 * 64 - 6 * 61 + 512 \
        - (26 * 64 - 6 * 61) % 512
    train = full["train"]
    assert len(train["losses"]) == 4 and train["fall"] > 0
    assert train["walk"]["walks"] == 1 and not train["walk"]["under"]
    assert train["walk"]["walk_peak"] > 0
    assert train["samples_per_s"] > 0
    assert full["serve"]["probs_in_range"] and full["serve"]["calls"] == 5
    ret = full["retrieval"]
    assert ret["k"] == 60 and ret["distinct"] and ret["err_rank"] <= 1e-5


def test_capped_recsys_has_the_rows_the_card_holds():
    """Each table capped at 2^20 rows: 7,206,400 rows after padding, a
    3.69 GB float32 table (six of the 26 tables cut); uncapped
    177,944,576 rows (91.1 GB)."""
    from repro_torch.configs import get_config
    from repro_torch.models.dlrm import padded_rows

    cfg = chip_smoke.capped_recsys()
    assert padded_rows(cfg) == 7_206_400
    assert padded_rows(cfg) * 128 * 4 / 1e9 == pytest.approx(3.69, abs=0.01)
    assert sum(a != b for a, b in zip(
        cfg.table_sizes, get_config("dlrm-mlperf").table_sizes)) == 6
    assert padded_rows(get_config("dlrm-mlperf")) == 177_944_576
    assert cfg.embed_dim == 128 and cfg.top_mlp[0] == 1024


def test_gnn_path_phase(on_cpu, capsys, monkeypatch):
    """The four smoke configs' steps (the CPU against itself: exact) with
    the planted NequIP fault caught, the equivariance checks, the
    full-width parts on the smoke configs at small cells, and the
    ``train_gnn`` example."""
    monkeypatch.setattr(chip_smoke, "profile_count", _profile_lm_on_cpu)
    mol = dict(kind="batched", n_nodes=6, n_edges=8, batch=4)
    graph = dict(kind="full", n_nodes=40, n_edges=120, d_feat=12)
    chip_smoke.gnn_path(CPU, "cpu", full=(
        ("equiformer-v2-smoke", mol), ("nequip-smoke", mol),
        ("graphcast-smoke", graph), ("gat-cora-smoke", graph)), steps=2)
    line = _line(capsys, "gnn_path")
    assert line["ok"] and not line["failed"]
    assert len(line["smoke"]) == 4
    for key, row in line["smoke"].items():
        assert row["ok"], key
        for k in ("loss", "grad_norm", "states", "params"):
            assert row[f"err_{k}"] == 0.0, (key, k)
    fault = line["smoke"]["nequip-smoke"]["planted_dropped_forces"]
    assert fault["caught"] and fault["err_states"] > 1e-4
    assert all(r["ok"] for r in line["equivariance"].values())
    full = line["full"]
    assert full["nequip-smoke"]["nodes"] == 512  # 24 atoms, padded
    assert full["nequip-smoke"]["edges"] == 512
    assert full["gat-cora-smoke"]["nodes"] == 512
    for row in full.values():
        assert len(row["losses"]) == 2 and np.isfinite(row["losses"]).all()
    assert [k for k, row in full.items() if "walk" in row] == [
        "equiformer-v2-smoke"]
    assert full["equiformer-v2-smoke"]["walk"]["walk_peak"] > 0
    assert line["train_gnn"]["ok"] and line["train_gnn"]["accuracy"] > 0.7
    assert len(line["train_gnn"]["checkpoints"]) == 4


def test_molecule_cell_pads_as_the_input_specs_do():
    """128 molecules x 30 atoms, 64 edges each: 4,096 atoms (256 padding
    atoms with ``graph_id`` 128, dropped by the energy's segment sum) and
    8,192 edges, each between two atoms of one molecule."""
    from repro_torch.configs import get_config

    b, d = chip_smoke.gnn_cell_batch(get_config("nequip"),
                                     chip_smoke.MOLECULE,
                                     np.random.default_rng(0))
    assert d == 0 and b["species"].shape == (4096,)
    assert b["edge_src"].shape == (8192,) and b["forces"].shape == (4096, 3)
    assert (b["graph_id"][3840:] == 128).all()
    assert (b["edge_src"] // 30 == b["edge_dst"] // 30).all()
    assert (b["edge_src"] != b["edge_dst"]).all()
    assert (b["graph_id"][b["edge_src"]] == b["edge_src"] // 30).all()
