"""The port's ``serve`` front end against the JAX package's, line for line.

Both packages serve the same sessions from a fresh plan cache each: the
batch mode (``--tc-graphs``, rounds 1 and later warm), the streaming mode
(``--tc-stream``, one random edge delta a round through the delta
ladder) at grids 1 and 2, and both under ``--inject-faults`` — a retried
round, a failed round that leaves the live graph at its last good state,
and the failure budget's ``SystemExit``.  Every printed line must be the
reference's with its milliseconds and graphs/s taken out; a session that
exits must exit with the reference's message.  The reference serves all
sessions in one subprocess on 4 host devices.
"""
import contextlib
import io
import json
import re

import pytest
import torch

import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro_torch.launch import serve

SESSIONS = {
    "batch": ["--tc-graphs", "named:karate;rmat:9", "--grid", "1",
              "--rounds", "3", "--verify"],
    "stream_q1": ["--tc-stream", "er:500,8,3", "--grid", "1", "--verify"],
    "stream_q2": ["--tc-stream", "er:500,8,3", "--grid", "2", "--rounds",
                  "5", "--delta-edges", "4", "--verify"],
    "batch_retry": ["--tc-graphs", "named:karate;rmat:9", "--grid", "1",
                    "--rounds", "3", "--inject-faults", "plan_stage",
                    "--verify"],
    "batch_budget": ["--tc-graphs", "named:karate", "--grid", "1",
                     "--rounds", "4", "--request-retries", "1",
                     "--failure-budget", "1", "--inject-faults",
                     "plan_stage*-1"],
    "stream_faults": ["--tc-stream", "er:500,8,3", "--grid", "2",
                      "--rounds", "5", "--delta-edges", "4",
                      "--inject-faults", "step@1;delta_splice*3",
                      "--verify"],
}

REFERENCE = """
import contextlib, io, json, sys
from repro.launch import serve
from repro.pipeline import PlanCache, set_default_cache

out = {}
for name, argv in %(sessions)r.items():
    set_default_cache(PlanCache())
    sys.argv = ["serve"] + argv
    buf, code = io.StringIO(), None
    with contextlib.redirect_stdout(buf):
        try:
            serve.main()
        except SystemExit as e:
            code = str(e)
    out[name] = dict(stdout=buf.getvalue(), exit=code)
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(distributed_runner):
    out = distributed_runner(REFERENCE % dict(sessions=SESSIONS), ndev=4)
    return json.loads(out.splitlines()[-1])


def _port(argv):
    """One session of the port's serve on the CPU from a fresh plan cache:
    ``(stdout, SystemExit message or None)``."""
    prev = tp.set_default_cache(tp.PlanCache())
    buf, code = io.StringIO(), None
    try:
        with contextlib.redirect_stdout(buf):
            try:
                serve.main(argv + ["--device", "cpu"])
            except SystemExit as e:
                code = str(e)
    finally:
        tp.set_default_cache(prev)
    return buf.getvalue(), code


_TIMES = re.compile(r" in [0-9.]+ms| \([0-9.]+ graphs/s,")


def _lines(stdout):
    return [_TIMES.sub("", ln) for ln in stdout.splitlines()]


@pytest.mark.parametrize("name", list(SESSIONS))
def test_serve_prints_the_reference_lines(reference, name):
    out, code = _port(SESSIONS[name])
    assert _lines(out) == _lines(reference[name]["stdout"])
    assert code == reference[name]["exit"]


def test_sessions_show_what_they_exercise(reference):
    """Pin what each session is for, so the comparison above cannot pass
    on sessions that exercise nothing."""
    batch = reference["batch"]["stdout"].splitlines()
    assert "cold" in batch[0] and all("warm" in ln for ln in batch[1:3])
    assert "0 restarts" in batch[-1]
    assert "1 restarts" in reference["batch_retry"]["stdout"]
    assert reference["batch_budget"]["exit"].startswith(
        "failure budget exhausted: 2 failed requests > budget 1")
    faults = reference["stream_faults"]["stdout"]
    assert "round 1 FAILED after 2 retries" in faults
    assert "1 failed" in faults.splitlines()[-1]
    for name in ("stream_q1", "stream_q2", "stream_faults"):
        assert reference[name]["exit"] is None


def test_stream_returns_the_live_graph_and_last_result():
    args = serve.build_parser().parse_args(
        ["--tc-stream", "er:300,6,2", "--grid", "2", "--rounds", "3",
         "--device", "cpu"])
    g0 = tc.graph_from_spec("er:300,6,2")
    with contextlib.redirect_stdout(io.StringIO()):
        g, res = serve._serve_tc_stream(args, graph=g0)
    assert g is not g0 and res.triangles == tc.triangle_count_oracle(g)


def test_verify_mismatch_is_not_retried(monkeypatch):
    monkeypatch.setattr(serve, "_maybe_verify", lambda args, g, got: (
        _ for _ in ()).throw(SystemExit("count mismatch: 1 != 2")))
    out, code = _port(["--tc-stream", "er:300,6,2", "--rounds", "2",
                       "--verify"])
    assert code == "count mismatch: 1 != 2"
    assert "round 1" not in out


def test_arch_is_refused():
    """``--arch`` serves an LM arch (the LM mode, since the LM family was
    ported); a config of another family and no mode at all are refused,
    the latter with the reference's message."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        toks = serve.main(["--arch", "qwen2-0.5b-smoke", "--batch", "2",
                           "--gen", "3", "--device", "cpu"])
    assert buf.getvalue().startswith("decoded 2x3 tokens in ")
    assert toks.shape == (2, 3)
    with pytest.raises(SystemExit, match="a 'tc' config; LM serving"):
        serve.main(["--arch", "tc-twitter", "--device", "cpu"])
    with pytest.raises(SystemExit, match=re.escape(
            "pass --arch (LM serving), --tc-graphs, or --tc-stream")):
        serve.main(["--device", "cpu"])


@pytest.mark.parametrize("spec", ["er:500,8,3", "rmat:9", "named:karate"])
@pytest.mark.parametrize("shuffled", [False, True])
def test_random_flips_match_the_reference_without_isin(spec, shuffled,
                                                       monkeypatch):
    """The serve stream draws its delta with ``random_edge_flips``; the
    port tests membership by a binary search into the sorted edge keys
    (``np.isin`` would take the unique of every key each round), with the
    reference's flips, whatever the order of the graph's edges."""
    import numpy as np
    import repro.core as jc
    from repro.core.generators import random_edge_flips as ref_flips
    from repro_torch.core import generators as tgen

    g = tc.graph_from_spec(spec)
    edges = g.edges
    if shuffled:
        edges = edges[np.random.default_rng(0).permutation(g.m)]
    mine = tc.Graph(n=g.n, edges=edges)
    ref = jc.Graph(n=g.n, edges=edges)
    draws = [(seed, k) for seed in range(4) for k in (1, 4, 40)]
    want = [ref_flips(ref, k, seed) for seed, k in draws]
    monkeypatch.setattr(np, "isin", None)  # any call would fail
    for (seed, k), (radd, rrem) in zip(draws, want):
        add, rem = tgen.random_edge_flips(mine, k, seed)
        assert np.array_equal(add, radd) and np.array_equal(rem, rrem)
    # a draw of every pair of a complete graph removes each edge
    k10 = tc.graph_from_spec("named:k10")
    add, rem = tgen.random_edge_flips(k10, 45, 0)
    assert len(rem) == 45 and len(add) == 0
