"""The port's measured autotune table and the card's roofline constants
against the JAX package.

The table key is the reference's blake2b over the same tuple, so the same
inputs give the same key; the candidate shapes and the busiest block are
the reference's; a cold count writes one JSON entry and a warm one reads
it on every schedule, with counts ``==`` the oracle.  The CPU timing
verdict itself is host noise and is not asserted: the resolution is
tested against entries whose verdict the test writes, and the roofline
model against its ranking with the rates passed in.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.pipeline as jp
import repro_torch as rt
import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro_torch.kernels.tc_fused import (
    measured_entry,
    measured_table_key,
    predict_fused_wins,
    roofline_predict,
)
from repro_torch.kernels.tc_fused import autotune as at
from repro_torch.launch import roofline, tc_run


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SCHEDULES = {  # schedule -> count_triangles grid keywords
    "cannon": dict(q=2),
    "summa": dict(grid=(2, 3)),
    "oned": dict(q=2),
}
GRAPHS = ("named:karate", "cliques:3,60", "er:200,6,3", "rmat:8,8,5")


def _plans(spec, kind):
    """The reference's and the port's maxfrag-split plans of ``spec``."""
    out = []
    for pipe, core in ((jp, jc), (tp, tc)):
        g = core.graph_from_spec(spec)
        if kind == "cannon":
            art = pipe.plan_cannon(g, 2, autotune="fused",
                                   cache=pipe.PlanCache())
        elif kind == "summa":
            art = pipe.plan_summa(g, 2, 3, autotune="fused",
                                  cache=pipe.PlanCache())
        else:
            art = pipe.plan_oned(g, 4, autotune="fused",
                                 cache=pipe.PlanCache())
        out.append(art.plan)
    return out


# ----------------------------------------------------------------------
# keys, candidates, busiest blocks
# ----------------------------------------------------------------------
_KEY_BASE = dict(kind="cannon", backend="cpu", dtype="int32", nb=100,
                 nnz_pad=1000, tmax=500, dmax=64, d_small=16,
                 tail_heavy=False)


@pytest.mark.parametrize("change", [
    {}, {"nnz_pad": 900}, {"nnz_pad": 1025}, {"d_small": 24},
    {"backend": "cuda:NVIDIA H100 80GB HBM3"}, {"tail_heavy": True},
    {"kind": "oned", "tmax": 3}, {"nb": 7, "dmax": 1},
], ids=str)
def test_measured_table_key_equals_the_reference(change):
    from repro.kernels.tc_fused.autotune import measured_table_key as j_key

    kw = {**_KEY_BASE, **change}
    assert measured_table_key(**kw) == j_key(**kw)


def test_measured_table_key_buckets():
    k = measured_table_key(**_KEY_BASE)
    # same power-of-two bucket -> same key (reusable across graphs of the
    # same size class); crossing the bucket or changing a split parameter
    # or backend re-keys
    assert measured_table_key(**{**_KEY_BASE, "nnz_pad": 900}) == k
    assert measured_table_key(**{**_KEY_BASE, "nnz_pad": 1025}) != k
    assert measured_table_key(**{**_KEY_BASE, "d_small": 24}) != k
    assert measured_table_key(**{**_KEY_BASE, "backend": "tpu"}) != k
    assert measured_table_key(**{**_KEY_BASE, "tail_heavy": True}) != k
    assert at.table_backend("cpu") == "cpu"


@pytest.mark.parametrize("d_small", [1, 4, 8, 16, 24, 31, 64, 144, 300])
@pytest.mark.parametrize("dmax", [1, 16, 40, 186, 700])
def test_candidates_equal_the_reference(d_small, dmax):
    from repro.kernels.tc_fused.autotune import _candidates as j_cands

    if dmax < d_small:
        dmax = d_small
    assert at._candidates(d_small, 512, dmax) == j_cands(d_small, 512, dmax)


@pytest.mark.parametrize("kind", list(SCHEDULES))
@pytest.mark.parametrize("spec", GRAPHS)
def test_busiest_block_and_entry_key_equal_the_reference(tmp_path, spec,
                                                         kind):
    from repro.kernels.tc_fused.autotune import _busiest_arrays as j_busiest

    pa, pb = _plans(spec, kind)
    want, got = j_busiest(pa), at._busiest_arrays(pb)
    assert got[6:] == want[6:]  # count, sentinel, kind
    for a, b in zip(got[:6], want[:6]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    entry, hit = measured_entry(pb, device="cpu", table_dir=str(tmp_path))
    assert not hit and entry["kind"] == kind and entry["backend"] == "cpu"
    ref_key = jc_key_of(pa)
    assert entry["key"] == ref_key
    assert (tmp_path / f"{ref_key}.json").exists()
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]


def jc_key_of(plan):
    """The key the reference's ``measured_entry`` gives ``plan`` on the
    CPU, from its own busiest block."""
    from repro.kernels.tc_fused.autotune import _busiest_arrays as j_busiest
    from repro.kernels.tc_fused.autotune import measured_table_key as j_key

    a_ptr, a_idx, _, _, ti, _, _, _, kind = j_busiest(plan)
    return j_key(
        kind=kind, backend="cpu", dtype=str(np.asarray(a_idx).dtype),
        nb=a_ptr.shape[0] - 1, nnz_pad=a_idx.shape[0], tmax=ti.shape[0],
        dmax=plan.dmax, d_small=plan.d_small,
        tail_heavy=bool((plan.autotune or {}).get("tail_heavy", False)),
    )


def test_the_reference_entry_has_the_same_key(tmp_path):
    """The reference's own ``measured_entry`` on the CPU names its file
    with the key the port computes for the byte-identical plan."""
    from repro.kernels.tc_fused.autotune import measured_entry as j_entry

    pa, pb = _plans("cliques:3,60", "cannon")
    want, _ = j_entry(pa, backend="cpu", table_dir=str(tmp_path / "jax"))
    got, _ = measured_entry(pb, device="cpu", table_dir=str(tmp_path / "pt"))
    assert got["key"] == want["key"]
    assert [c[k] for c in got["candidates"] for k in ("tile", "d_small")] == [
        c[k] for c in want["candidates"] for k in ("tile", "d_small")]
    assert got["baseline"] == want["baseline"] == "search2"


# ----------------------------------------------------------------------
# the table on disk, cold then warm, on every schedule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", ["auto", "fused"])
@pytest.mark.parametrize("kind", list(SCHEDULES))
@pytest.mark.parametrize("spec", GRAPHS)
def test_measured_table_cold_then_warm(tmp_path, spec, kind, method):
    g = tc.graph_from_spec(spec)
    exp = tc.triangle_count_oracle(g)
    cache = tp.PlanCache()

    def count():
        return rt.count_triangles(
            g, schedule=kind, method=method, autotune="measured",
            measured_dir=str(tmp_path), device="cpu", cache=cache,
            **SCHEDULES[kind])

    r1 = count()
    assert r1.autotune_mode == "measured"
    assert r1.measured_table_hit is False
    assert r1.triangles == exp
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    entry = json.loads(files[0].read_text())
    assert r1.method in ("fused", entry["baseline"], "search")
    r2 = count()
    assert r2.measured_table_hit is True
    assert r2.triangles == exp and r2.method == r1.method
    assert len(list(tmp_path.glob("*.json"))) == 1
    if r1.method == "fused":  # the count ran at the table's tile
        assert any(isinstance(k, tuple) and k[0] == "fn"
                   and k[-1] == entry["best"]["tile"]
                   for k in r1.artifact._memo)


def _write_verdict(tmp_path, plan, winner, tile):
    """Put an entry with the given verdict where the table looks for
    ``plan``'s bucket."""
    entry, _ = measured_entry(plan, device="cpu", table_dir=str(tmp_path))
    entry = dict(entry, winner=winner, best=dict(entry["best"], tile=tile))
    path = tmp_path / f"{entry['key']}.json"
    path.write_text(json.dumps(entry))
    return entry


@pytest.mark.parametrize("winner", ["fused", "baseline"])
@pytest.mark.parametrize("kind", list(SCHEDULES))
def test_auto_resolves_from_the_tables_verdict(tmp_path, kind, winner):
    """``auto`` under measured mode is ``fused`` at the entry's tile where
    the verdict is the fused kernel, and the schedule's percentile
    resolution otherwise (``search`` on the ring)."""
    g = tc.graph_from_spec("rmat:8,8,5")
    cache = tp.PlanCache()
    kw = dict(schedule=kind, method="auto", autotune="measured",
              measured_dir=str(tmp_path), device="cpu", cache=cache,
              **SCHEDULES[kind])
    first = rt.count_triangles(g, **kw)  # plans and writes the entry
    entry = _write_verdict(
        tmp_path, first.plan, "fused" if winner == "fused" else "search2", 8)
    assert predict_fused_wins(entry) == (winner == "fused")
    r = rt.count_triangles(g, **kw)
    assert r.measured_table_hit is True
    assert r.triangles == tc.triangle_count_oracle(g)
    if winner == "fused":
        assert r.method == "fused"
        assert any(isinstance(k, tuple) and k[:2] == ("fn", "fused")
                   and k[-1] == 8 for k in r.artifact._memo)
    else:
        from repro_torch.core.api import _resolve_auto_method

        want = "search" if kind == "oned" else _resolve_auto_method(
            first.plan)
        assert r.method == want


def test_measured_with_pods(tmp_path):
    g = tc.graph_from_spec("cliques:3,60")
    for _ in range(2):
        r = rt.count_triangles(g, q=2, npods=2, method="auto",
                               autotune="measured",
                               measured_dir=str(tmp_path), device="cpu",
                               cache=tp.PlanCache())
        assert r.triangles == tc.triangle_count_oracle(g)
        assert r.grid == (2, 2, 2)
    assert r.measured_table_hit is True


def test_default_table_dir_is_the_ports_own(monkeypatch, tmp_path):
    from repro.kernels.tc_fused.autotune import default_table_dir as j_dir

    monkeypatch.delenv("REPRO_TORCH_TC_MEASURED_DIR", raising=False)
    monkeypatch.delenv("REPRO_TC_MEASURED_DIR", raising=False)
    assert at.default_table_dir() != j_dir()
    monkeypatch.setenv("REPRO_TORCH_TC_MEASURED_DIR", str(tmp_path))
    assert at.default_table_dir() == str(tmp_path)


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------
def test_measured_entry_requires_the_maxfrag_split(tmp_path):
    from repro.kernels.tc_fused.autotune import measured_entry as j_entry

    ga = jc.preprocess(jc.rmat(7, 8, seed=3))[0]
    gb = tc.preprocess(tc.rmat(7, 8, seed=3))[0]
    with pytest.raises(ValueError, match="maxfrag") as want:
        j_entry(jc.build_plan(ga, 1), table_dir=str(tmp_path))
    with pytest.raises(ValueError, match="maxfrag") as got:
        measured_entry(tc.build_plan(gb, 1), device="cpu",
                       table_dir=str(tmp_path))
    assert str(got.value) == str(want.value)
    assert not list(tmp_path.iterdir())


def test_measured_refuses_a_caller_plan():
    ga, gb = jc.graph_from_spec("named:karate"), tc.graph_from_spec(
        "named:karate")
    pa = jp.plan_cannon(ga, 1, cache=jp.PlanCache()).plan
    pb = tp.plan_cannon(gb, 1, cache=tp.PlanCache()).plan
    with pytest.raises(ValueError) as want:
        jc.count_triangles(ga, plan=pa, autotune="measured")
    with pytest.raises(ValueError) as got:
        rt.count_triangles(gb, plan=pb, autotune="measured", device="cpu")
    assert str(got.value) == str(want.value)


def test_the_delta_path_refuses_measured():
    ga, gb = jc.graph_from_spec("named:karate"), tc.graph_from_spec(
        "named:karate")
    with pytest.raises(ValueError) as want:
        jc.count_triangles_delta(ga, jp.EdgeDelta(), autotune="measured")
    with pytest.raises(ValueError) as got:
        rt.count_triangles_delta(gb, tp.EdgeDelta(), autotune="measured",
                                 device="cpu")
    assert str(got.value) == str(want.value)


def test_unknown_autotune_mode_is_refused_as_the_reference():
    ga, gb = jc.graph_from_spec("named:karate"), tc.graph_from_spec(
        "named:karate")
    with pytest.raises(ValueError) as want:
        jc.count_triangles(ga, autotune="bogus")
    with pytest.raises(ValueError) as got:
        rt.count_triangles(gb, autotune="bogus", device="cpu")
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------------
# the roofline: constants and ranking
# ----------------------------------------------------------------------
def test_hw_holds_the_h100_data_sheet_rates():
    assert roofline.HW == dict(hbm_bw=3.35e12, peak_flops=989e12,
                               fp32_ops=67e12, hbm_bytes=80e9)


def test_measure_hw_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        roofline.measure_hw("cpu")


@pytest.mark.parametrize("tshort,d_small,dpad,nnz", [
    (1, 1, 1, 2), (100, 16, 16, 1000), (976310, 144, 144, 15_000_000),
    (60784, 32, 32, 1 << 20), (5, 300, 300, 10),
])
def test_roofline_model_is_the_references_with_its_rates(tshort, d_small,
                                                         dpad, nnz):
    """With the reference's two rates passed in, the port's model gives
    the reference's times and winner."""
    from repro.kernels.tc_fused.autotune import roofline_predict as j_pred
    from repro.launch.roofline import HW as JHW

    want = j_pred(tshort=tshort, d_small=d_small, dpad=dpad, nnz=nnz)
    got = roofline_predict(
        tshort=tshort, d_small=d_small, dpad=dpad, nnz=nnz,
        hw=dict(hbm_bw=JHW["hbm_bw"], fp32_ops=JHW["peak_flops"]))
    for k in ("t_search", "t_fused", "predicted_winner"):
        assert got[k] == want[k], k


def test_roofline_ranking_follows_the_compare_rate():
    """The fused kernel's compares grow with d_small², the baseline's
    bytes with d_small·log(nnz): a slow compare rate hands the win to the
    baseline, a fast one to the fused kernel."""
    kw = dict(tshort=10_000, d_small=144, dpad=144, nnz=1 << 24)
    fast = roofline_predict(**kw, hw=dict(hbm_bw=3.35e12, fp32_ops=1e18))
    slow = roofline_predict(**kw, hw=dict(hbm_bw=3.35e12, fp32_ops=1e9))
    assert fast["predicted_winner"] == "fused"
    assert slow["predicted_winner"] == "search2"
    default = roofline_predict(**kw)
    assert default["hbm_bw"] == 3.35e12 and default["fp32_ops"] == 67e12


# ----------------------------------------------------------------------
# tc_run
# ----------------------------------------------------------------------
def test_tc_run_measured_auto(tmp_path, capsys):
    args = ["--graph", "rmat:9", "--grid", "2", "--method", "auto",
            "--autotune", "measured", "--measured-dir", str(tmp_path),
            "--verify", "--json", "--device", "cpu"]
    reports = []
    for _ in range(2):
        tc_run.main(args)
        reports.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    cold, warm = reports
    assert cold["correct"] and warm["correct"]
    assert cold["autotune_mode"] == warm["autotune_mode"] == "measured"
    assert cold["measured_table_hit"] is False
    assert warm["measured_table_hit"] is True
    assert cold["method"] in ("fused", "search", "search2")
    assert cold["triangles"] == cold["expected"]
    assert len(list(tmp_path.glob("*.json"))) == 1


@pytest.mark.parametrize("argv,words", [
    (["--graphs", "named:karate,named:bull", "--autotune", "measured"],
     ["--autotune measured", "--graphs"]),
    (["--graphs", "named:karate,named:bull", "--reduce-strategy", "tree"],
     ["--reduce-strategy", "--graphs"]),
    (["--graph", "named:karate", "--stream", "x.jsonl", "--autotune",
      "measured"], ["--stream", "--autotune measured"]),
])
def test_tc_run_refuses_what_the_reference_refuses(argv, words):
    with pytest.raises(SystemExit) as e:
        tc_run.main(argv + ["--device", "cpu"])
    assert all(w in str(e.value) for w in words)
