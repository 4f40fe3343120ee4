"""The port's tile and dense paths, on the CPU, against the JAX package.

The tile kernels' plain versions (popcount and unpack-and-multiply) must
give the JAX kernels' integers (Pallas in interpret mode) and both
references'; the tile plans must be byte-identical to the JAX package's;
``count_triangles(method="tile" | "dense")`` must give the oracle's and
the JAX package's count at q in {1, 2, 3}.  Inputs are made from a seed
with numpy and handed to both packages.  Parity is ``==``.
"""
import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.pipeline as jp
from repro.core.decomp import cyclic_blocks as j_cyclic_blocks
from repro.core.tiles import build_tile_plan as j_build_tile_plan
from repro.core.tiles import pack_block_tiles as j_pack_block_tiles
from repro.kernels.tc_tile.ref import tile_triple_counts_ref as j_ref
from repro.kernels.tc_tile.tc_tile import tile_triple_counts as j_counts
from repro.kernels.tc_tile.tc_tile import unpack_bits_tile as j_unpack
import repro_torch as rt
import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro_torch.core.cannon import build_cannon_dense_fn, build_cannon_tile_fn
from repro_torch.core.count import count_pair_dense
from repro_torch.core.decomp import cyclic_blocks
from repro_torch.core.plan import compact_live_steps
from repro_torch.core.tiles import build_tile_plan, pack_block_tiles, stage_tile_plan
from repro_torch.kernels.tc_tile import (
    MODES,
    TILE,
    WORDS,
    tile_pair_count,
    tile_triple_counts,
    tile_triple_counts_plain,
    tile_triple_counts_ref,
    unpack_bits_tile,
)
from repro_torch.kernels.tc_tile import tc_tile as kmod
from repro_torch.kernels.tc_tile.tc_tile import dense_threshold


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py builds the tile kernels' trap cases; it imports nothing at
# module level but numpy and torch
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
FIXTURES = {
    "karate": "named:karate",
    "rmat8": "rmat:8,8,5",
    "rmat9": "rmat:9,8,42",
    "cliques3": "cliques:3,60",
    "star": "star:64",
    "edgeless": "er:24,0",
}
METHODS = ("tile", "dense")
_ORACLE = {}


def _graph(name):
    return tc.graph_from_spec(FIXTURES[name])


def _oracle(name):
    if name not in _ORACLE:
        _ORACLE[name] = tc.triangle_count_oracle(_graph(name))
    return _ORACLE[name]


def _tiles(rng, n, density):
    """``n`` random packed tiles, uint32, bit density about ``density``."""
    bits = (rng.random((n, TILE, WORDS, 32)) < density).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _t(a):
    """numpy (uint32 tiles or int32 triples) -> the port's int32 tensor."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _case(seed, ntiles, ntrips, density):
    rng = np.random.default_rng(seed)
    a, b = _tiles(rng, ntiles, density), _tiles(rng, ntiles, density)
    m = _tiles(rng, ntiles, min(0.5, density * 2))
    trips = rng.integers(0, ntiles, size=(ntrips, 4)).astype(np.int32)
    trips[:, 3] = np.arange(ntrips) % 3 != 2
    return trips, a, b, m


# ----------------------------------------------------------------------
# kernels: plain versions vs the JAX kernels and both references
# ----------------------------------------------------------------------
@pytest.mark.parametrize("density", [0.02, 0.3, 0.9])
@pytest.mark.parametrize("ntiles,ntrips", [(1, 1), (3, 4), (8, 16)])
@pytest.mark.parametrize("mode", MODES)
def test_plain_versions_match_the_jax_kernel(mode, ntiles, ntrips, density):
    trips, a, b, m = _case(ntiles * 31 + ntrips, ntiles, ntrips, density)
    want = np.asarray(j_counts(jnp.asarray(trips), jnp.asarray(a),
                               jnp.asarray(b), jnp.asarray(m), mode=mode,
                               interpret=True))
    j_oracle = np.asarray(j_ref(jnp.asarray(trips), jnp.asarray(a),
                                jnp.asarray(b), jnp.asarray(m)))
    args = [_t(v) for v in (trips, a, b, m)]
    got = tile_triple_counts(*args, mode=mode)
    assert got.dtype == torch.int32 and got.shape == (ntrips,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), j_oracle)
    np.testing.assert_array_equal(tile_triple_counts_ref(*args).numpy(), want)


def test_unpack_bits_tile_is_exact_bit_31_included():
    words = np.zeros((TILE, WORDS), dtype=np.uint32)
    words[5, 0] = 1  # bit 0 -> column 0
    words[7, 1] = 0x80000000  # bit 31 of word 1 -> column 63
    words[9, 3] = 0xFFFFFFFF  # every bit of word 3 -> columns 96..127
    out = unpack_bits_tile(_t(words), torch.int32)
    assert out[5, 0] == 1 and out[7, 63] == 1
    assert int(out[9, 96:].sum()) == 32 and int(out.sum()) == 34
    rnd = _tiles(np.random.default_rng(3), 2, 0.5)
    for k in range(2):
        np.testing.assert_array_equal(
            unpack_bits_tile(_t(rnd[k]), torch.int32).numpy(),
            np.asarray(j_unpack(jnp.asarray(rnd[k]), jnp.int32)),
        )
    assert unpack_bits_tile(_t(rnd), torch.bfloat16).shape == (2, TILE, TILE)


SINGLE_BITS = chip_smoke.SINGLE_BITS
# triples of the ragged case: prime, so no grid's warp count divides it
RAGGED_CPU, RAGGED_GPU = 1009, chip_smoke.RAGGED


def _edge_cases(ragged=RAGGED_CPU):
    """``chip_smoke.tile_trap_cases`` with the tiles as uint32, as the JAX
    package takes them."""
    return {name: (trips, *(v.view(np.uint32) for v in tiles))
            for name, (trips, *tiles)
            in chip_smoke.tile_trap_cases(ragged=ragged).items()}


def _ref(trips, a, b, m):
    """``tile_triple_counts_ref`` taken once per distinct triple."""
    if trips.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64)
    uniq, inv = torch.unique(trips, dim=0, return_inverse=True)
    return tile_triple_counts_ref(uniq, a, b, m)[inv]


def _pair_count(a, b, i, j):
    """``popcount(A[i] & B[j])`` of two uint32 tiles, in numpy."""
    return sum(bin(int(w)).count("1") for w in a[i] & b[j])


@pytest.mark.parametrize("case", list(_edge_cases()))
@pytest.mark.parametrize("mode", MODES)
def test_plain_versions_on_edge_cases(mode, case):
    trips, a, b, m = _edge_cases()[case]
    args = [_t(v) for v in (trips, a, b, m)]
    got = tile_triple_counts(*args, mode=mode)
    want = _ref(*args)
    assert torch.equal(got.long(), want)
    if case == "all_bits":  # the padding triple names the full slot 0
        assert got.tolist() == [TILE ** 3, TILE ** 3, 0]
    if case == "bit31_only":  # columns 31/63/95/127 set in every row:
        # 128 rows x 4 mask bits x 4 shared columns
        assert got.tolist() == [TILE * WORDS * WORDS] * 2 + [0]
    if case == "invalid_real_slots":
        assert got[:3].tolist() == [0, 0, 0] and int(got[3]) > 0
    if case == "single_bits":
        assert got.tolist() == [_pair_count(a[ta], b[tb], i, j)
                                for (ta, tb, _, _), (i, j)
                                in zip(trips, SINGLE_BITS)]
        assert min(got.tolist()) > 0
    if case == "one_bit_per_block":
        ii, jj = np.nonzero(unpack_bits_tile(_t(m[0]), torch.int32).numpy())
        assert len(ii) == (TILE // 16) * (TILE // 8)
        assert got.tolist() == [
            sum(_pair_count(a[ta], b[tb], i, j) for i, j in zip(ii, jj))
            for ta, tb, _, _ in trips]
    if case == "empty_mask_valid":
        assert got.tolist() == [0, 0]
    if case == "ragged_one_slot":
        assert got.shape == (RAGGED_CPU,) and RAGGED_CPU % 5 != 0
        assert torch.equal(got[:5].repeat(RAGGED_CPU // 5 + 1)[:RAGGED_CPU],
                           got)


@pytest.mark.parametrize("case", list(_edge_cases()))
@pytest.mark.parametrize("mode", MODES)
def test_plain_versions_match_the_jax_kernel_on_edge_cases(mode, case):
    """The JAX kernel in interpret mode, once per distinct triple."""
    trips, a, b, m = _edge_cases()[case]
    got = tile_triple_counts(*[_t(v) for v in (trips, a, b, m)], mode=mode)
    if trips.shape[0] == 0:
        assert got.shape == (0,)
        return
    uniq, inv = np.unique(trips, axis=0, return_inverse=True)
    want = np.asarray(j_counts(jnp.asarray(uniq), jnp.asarray(a),
                               jnp.asarray(b), jnp.asarray(m), mode=mode,
                               interpret=True))[inv.reshape(-1)]
    np.testing.assert_array_equal(got.numpy(), want)


def test_tile_pair_count_sums_in_int64(monkeypatch):
    """The per-triple partials are int32; their sum over a block pair is
    taken in int64 and does not wrap."""
    import repro_torch.kernels.tc_tile.ops as ops

    parts = torch.full((3,), 2**30, dtype=torch.int32)
    monkeypatch.setattr(ops, "tile_triple_counts", lambda *a, **k: parts)
    total = tile_pair_count(None, None, None, None)
    assert total.dtype == torch.int64 and int(total) == 3 * 2**30
    monkeypatch.undo()
    trips, a, b, m = _case(9, 3, 6, 0.5)
    args = [_t(v) for v in (trips, a, b, m)]
    assert int(tile_pair_count(*args, mode="mxu")) == int(
        tile_triple_counts_ref(*args).sum())


def test_wrapper_refuses_bad_modes_and_devices():
    args = [_t(v) for v in _case(1, 2, 2, 0.5)]
    with pytest.raises(ValueError, match="unknown tile mode"):
        tile_triple_counts(*args, mode="vpu")
    with pytest.raises(ValueError, match="no kernel"):
        tile_triple_counts(*[v.to("meta") for v in args])


# ----------------------------------------------------------------------
# tile plans: byte-identical to the JAX package's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_pack_block_tiles_is_byte_identical(name, q):
    g2, _ = tc.preprocess(_graph(name))
    jg2, _ = jc.preprocess(jc.graph_from_spec(FIXTURES[name]))
    mine, theirs = cyclic_blocks(g2, q, q), j_cyclic_blocks(jg2, q, q)
    for x in range(q):
        for y in range(q):
            p, i = pack_block_tiles(mine[x][y])
            jp_, ji = j_pack_block_tiles(theirs[x][y])
            assert p.dtype == jp_.dtype == np.uint32
            assert i.dtype == ji.dtype == np.int32
            np.testing.assert_array_equal(p, jp_)
            np.testing.assert_array_equal(i, ji)


@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_build_tile_plan_is_byte_identical(name, q):
    art = tp.plan_cannon(_graph(name), q, keep_blocks=True,
                         cache=tp.PlanCache())
    jart = jp.plan_cannon(jc.graph_from_spec(FIXTURES[name]), q,
                          keep_blocks=True, cache=jp.PlanCache())
    mine, theirs = build_tile_plan(art), j_build_tile_plan(jart)
    assert art.plan.skew_perm == jart.plan.skew_perm
    if name == "cliques3" and q == 3:
        assert art.plan.skew_perm not in (None, (0, 1, 2))  # σ ≠ identity
    assert (mine.q, mine.nt_pad, mine.trip_pad) == (
        theirs.q, theirs.nt_pad, theirs.trip_pad)
    assert mine.stats == theirs.stats
    m_arr, t_arr = mine.device_arrays(), theirs.device_arrays()
    assert list(m_arr) == list(t_arr)
    for k in m_arr:
        assert m_arr[k].dtype == t_arr[k].dtype, k
        np.testing.assert_array_equal(m_arr[k], t_arr[k])


def test_tile_plan_needs_the_blocks_and_stages_int32():
    art = tp.plan_cannon(_graph("rmat8"), 2, keep_blocks=False,
                         cache=tp.PlanCache())
    with pytest.raises(ValueError, match="keep_blocks=True"):
        build_tile_plan(art)
    art = tp.plan_cannon(_graph("rmat8"), 2, cache=tp.PlanCache())
    tpl = build_tile_plan(art)
    staged = stage_tile_plan(tpl, "cpu")
    assert staged["a_tiles"].dtype == torch.int32
    assert np.array_equal(staged["m_tiles"].numpy().view(np.uint32),
                          tpl.m_tiles)
    assert staged["triples"].shape == (2, 2, 2, tpl.trip_pad, 4)


@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("name", ["karate", "rmat8", "cliques3"])
def test_dense_blocks_are_identical(name, q):
    art = tp.plan_cannon(_graph(name), q, cache=tp.PlanCache())
    jart = jp.plan_cannon(jc.graph_from_spec(FIXTURES[name]), q,
                          cache=jp.PlanCache())
    mine, theirs = art.plan.dense_blocks(), jart.plan.dense_blocks()
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_count_pair_dense_is_exact_past_2_24():
    nb = 300  # all-ones blocks: nb³ = 27,000,000 > 2^24
    ones = torch.ones((nb, nb), dtype=torch.float32)
    total = count_pair_dense(ones, ones, ones)
    assert total.dtype == torch.int64 and int(total) == nb ** 3


# ----------------------------------------------------------------------
# the paths end to end
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_count_matches_oracle(name, q, method):
    r = rt.count_triangles(_graph(name), q=q, method=method, device="cpu")
    assert r.triangles == _oracle(name)
    assert r.method == method and r.grid == (q, q)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["karate", "rmat8", "rmat9", "cliques3"])
def test_matches_reference_in_process_q1(name, method):
    want = jc.count_triangles(
        jc.graph_from_spec(FIXTURES[name]), q=1, method=method
    ).triangles
    got = rt.count_triangles(_graph(name), q=1, method=method, device="cpu")
    assert got.triangles == want == _oracle(name)


@pytest.fixture(scope="module")
def reference_q3(distributed_runner):
    """The JAX package's tile and dense counts at q = 3 (9 host devices),
    one subprocess for all of them."""
    names = ["karate", "rmat8", "cliques3", "star"]
    code = f"""
import json
from repro.core import count_triangles, graph_from_spec
fixtures = {FIXTURES!r}
out = {{}}
for name in {names!r}:
    g = graph_from_spec(fixtures[name])
    for method in ("tile", "dense"):
        out[name + "/" + method] = count_triangles(g, q=3, method=method).triangles
print("RESULT" + json.dumps(out))
"""
    out = distributed_runner(code, ndev=9)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["karate", "rmat8", "cliques3", "star"])
def test_matches_reference_q3(reference_q3, name, method):
    got = rt.count_triangles(_graph(name), q=3, method=method, device="cpu")
    assert got.triangles == reference_q3[f"{name}/{method}"] == _oracle(name)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("compact", [None, False, True])
@pytest.mark.parametrize("use_step_mask", [None, False])
@pytest.mark.parametrize("name", ["rmat8", "cliques3", "star"])
def test_mask_and_compaction_do_not_change_the_count(
    name, use_step_mask, compact, method
):
    r = rt.count_triangles(
        _graph(name), q=3, method=method, use_step_mask=use_step_mask,
        compact=compact, device="cpu", cache=tp.PlanCache(),
    )
    assert r.triangles == _oracle(name)


def test_tile_triples_are_indexed_by_the_original_step():
    """cliques:3,60 at q = 3.  Under the σ the compaction stage picks,
    (0, 2, 1), the one live step is step 0; under σ = (1, 0, 2) it is
    step 1, so a loop that renumbered live steps would select step 0's
    triple list (and mask column) for it and lose the triangles."""
    art = tp.plan_cannon(_graph("cliques3"), 3, keep_blocks=True,
                         cache=tp.PlanCache())
    assert art.plan.compact.n_elided > 0 and art.plan.skew_perm == (0, 2, 1)
    tpl = build_tile_plan(art)
    for mode in MODES:
        fn = build_cannon_tile_fn(art, mode=mode, compact=True)
        assert int(fn(**stage_tile_plan(tpl, "cpu"))) == _oracle("cliques3")

    g2, _ = tc.preprocess(_graph("cliques3"))
    plan = tc.build_plan(g2, 3, skew_perm=(1, 0, 2))
    live = compact_live_steps(plan.step_keep).live_steps
    assert live == (1,)
    staged = stage_tile_plan(build_tile_plan(plan), "cpu")
    meta = dict(n=plan.n, m=plan.m, q=3, nb=plan.nb, nnz_pad=plan.nnz_pad,
                tmax=plan.tmax, dmax=plan.dmax, chunk=plan.chunk,
                skew_perm=plan.skew_perm)
    for steps, mask in ((live, None), (live, False), ((1, 2), False)):
        sched = tc.plan_from_numpy(plan.device_arrays(),
                                   dict(meta, live_steps=steps))
        fn = build_cannon_tile_fn(sched, compact=True, use_step_mask=mask)
        assert int(fn(**staged)) == _oracle("cliques3"), (steps, mask)


@pytest.mark.parametrize("name", ["rmat9", "cliques3"])
def test_mxu_tile_fn_equals_popcount(name):
    art = tp.plan_cannon(_graph(name), 3, keep_blocks=True,
                         cache=tp.PlanCache())
    tpl = build_tile_plan(art)
    staged = stage_tile_plan(tpl, "cpu")
    per = {
        mode: build_cannon_tile_fn(art, mode=mode,
                                   reduce_global=False)(**staged)
        for mode in MODES
    }
    assert per["popcount"].dtype == torch.int64
    assert torch.equal(per["popcount"], per["mxu"])
    assert int(per["mxu"].sum()) == _oracle(name)
    dense = build_cannon_dense_fn(art, reduce_global=False)(
        **{k: torch.from_numpy(v) for k, v in art.plan.dense_blocks().items()})
    assert torch.equal(dense, per["popcount"])


def test_tile_plan_is_preprocessing_and_memoised():
    cache = tp.PlanCache()
    g = _graph("rmat9")
    first = rt.count_triangles(g, q=2, method="tile", device="cpu",
                               cache=cache)
    art = first.artifact
    assert art.plan.blocks is not None
    assert {"tile_plan", "tile_stage"} <= set(art.stage_seconds)
    staged = art.memo(("tile_staged", "cpu"), lambda: None)
    hits = cache.hits
    second = rt.count_triangles(g, q=2, method="tile", device="cpu",
                                cache=cache)
    assert second.artifact is art and cache.hits > hits
    assert art.memo(("tile_staged", "cpu"), lambda: None) is staged
    assert second.triangles == first.triangles == _oracle("rmat9")


def test_cli_counts_with_the_tile_and_dense_methods():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for method in METHODS:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.tc_run", "--graph",
             "rmat:9,8,42", "--grid", "2", "--method", method, "--device",
             "cpu", "--verify", "--json"],
            env=env, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        assert rep["correct"] and rep["method"] == method
        assert rep["triangles"] == _oracle("rmat9")


def test_tile_sizing_reports_the_plan_and_a_correct_count():
    from repro_torch.launch import tile_sizing

    (rec,) = tile_sizing.main(["--scales", "8", "--device", "cpu"])
    g = jc.rmat(8, 16, seed=1)
    assert rec["m"] == g.m
    assert rec["triangles"] == rec["triangles_repeat"] == (
        jc.triangle_count_oracle(g))
    assert rec["store_bytes"] == 3 * 16 * rec["nt_pad"] * TILE * WORDS * 4
    assert rec["triple_array_bytes"] == 64 * rec["trip_pad"] * 16
    assert rec["host_rss_peak_bytes"] >= rec["host_rss_before_bytes"] > 0
    assert rec["peak_device_bytes"] is None


@pytest.mark.gpu
def test_tile_kernels_equal_plain_on_the_gpu():
    """Both CUDA tile kernels against their plain versions, per triple,
    on random cases and the edge cases.  Needs a CUDA device and nvcc;
    ``python3 chip_smoke.py`` runs the same comparison (and more) on a
    machine that has them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile kernels have no CPU build")
    cases = {f"random_{d}": _case(s, 8, 64, d)
             for s, d in ((0, 0.02), (1, 0.3), (2, 0.9))}
    cases.update(_edge_cases(ragged=RAGGED_GPU))
    routes = cases["both_routes"]
    bits = [int(np.unpackbits(routes[3][k].view(np.uint8)).sum())
            for k in routes[0][routes[0][:, 3] > 0, 2]]
    assert min(bits) <= dense_threshold() < max(bits)
    for name, case in cases.items():
        args = [_t(v).cuda() for v in case]
        for mode in MODES:
            before = kmod.launch_count(mode)
            got = tile_triple_counts(*args, mode=mode)
            want = tile_triple_counts_plain(*args, mode=mode)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, mode)
            assert kmod.launch_count(mode) == before + (args[0].shape[0] > 0)
