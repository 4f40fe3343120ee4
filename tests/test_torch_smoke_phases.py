"""Rehearse ``chip_smoke.py``'s planner-stage phases on the CPU.

The script runs only on a GPU; its ``hub_path``, ``rebalance_path`` and
``many_path`` phases are called here at a tiny scale with ``dev=cpu``,
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

import pytest
import torch

import repro_torch as rt
import repro_torch.core.api as api
import repro_torch.kernels.tc_fused as tf
import repro_torch.pipeline.batch as batch
from repro_torch.kernels.tc_fused import tc_fused as kmod

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
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    plain = tf.count_pair_fused

    def counted(*args, **kw):
        kmod.LAUNCHES += 1
        return plain(*args, **kw)

    monkeypatch.setattr(tf, "count_pair_fused", counted)
    monkeypatch.setattr(chip_smoke, "profile_count", _profile_on_cpu)


def _profile_on_cpu(count, expect, annotation=None, **kw):
    """``profile_count`` with the CPU activity only: the ``tc_hub`` range
    must show up in the trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        count()
    keys = {ev.key for ev in prof.key_averages()}
    if annotation is not None:
        assert annotation in keys
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
        assert row["triangles"] == row["triangles_search"] == oracle
        assert row["hub"]["hub_rows"] > 0
        assert row["hub_partial"]["triangles"] + row["residual"][
            "triangles"] == oracle
        assert row["kernel_launches"] == row["device_steps_counted"] > 0
        assert row["tasks_past_stage_limit"] == 0
    assert line["oned"]["hub_partial_chunk512"]["chunk"] == 512
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
    for kind, _ in chip_smoke.MANY_GRIDS:
        for chunk in (chip_smoke.DEFAULT_CHUNK, chip_smoke.HUB_CHUNK):
            row = line[f"{kind}/chunk{chunk}"]
            assert row["triangles"] == line["triangles_scipy_oracle"]
            assert row["padding_overhead"] > 0
