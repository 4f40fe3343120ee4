"""The fused intersection module against ``repro.kernels.tc_fused``.

The CUDA kernel cannot run without a GPU; what runs here are its plain
PyTorch versions (which the wrappers take for CPU tensors) — per tile
against the reference's Pallas body under the interpreter, in total
against both packages' independently formulated references and a brute
force, and the plain route of the whole device-step against the JAX
dispatcher on ``chip_smoke.fused_trap_cases``.  The same inputs, made
with numpy from a seed, go to both packages; everything is integers, so
parity is ``==``.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro.kernels.tc_fused import count_pair_fused as j_count_pair_fused
from repro.kernels.tc_fused import fused_tile_for as j_fused_tile_for
from repro.kernels.tc_fused.ref import fused_short_ref as j_fused_short_ref
from repro.kernels.tc_fused.tc_fused import fused_short_counts as j_fused_short_counts
from repro_torch.core.cannon import build_cannon_fn
from repro_torch.core.engine import check_fused_split, make_csr_kernel
from repro_torch.kernels.tc_fused import (
    count_pair_fused,
    count_pair_fused_plain,
    fused_short_counts,
    fused_short_counts_plain,
    fused_short_ref,
    fused_split_sizes,
    fused_step_counts,
    fused_step_counts_plain,
    fused_tile_for,
)
from repro_torch.kernels.tc_fused import tc_fused as kmod


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
# chip_smoke.py builds the fused kernel's trap cases; it imports nothing at
# module level but numpy and torch
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
FUSED_TRAPS = chip_smoke.fused_trap_cases()
FALLBACKS = ("global", "search")
# (case, long-bucket function) pairs: each case under the functions it
# declares (the ring's global ids take the padded search only)
TRAP_RUNS = [(name, fb) for name, case in FUSED_TRAPS.items()
             for fb in case["fallbacks"]]


def _random_csr(rng, nrows, maxd, ncols, pad, last_len=None):
    lens = rng.integers(0, maxd + 1, size=nrows)
    if last_len is not None:
        lens[-1] = last_len
    rows = [np.sort(rng.choice(ncols, size=int(k), replace=False)) for k in lens]
    indptr = np.zeros(nrows + 1, np.int32)
    indptr[1:] = np.cumsum(lens)
    idx = np.concatenate(rows + [np.full(pad, ncols)]).astype(np.int32)
    return indptr, idx


def _case(seed, *, nrows=40, maxd=12, ncols=500, pad=7, last_len=None,
          ntask=300):
    rng = np.random.default_rng(seed)
    ap, ai = _random_csr(rng, nrows, maxd, ncols, pad, last_len)
    bp, bi = _random_csr(rng, nrows, maxd, ncols, pad, last_len)
    ti = rng.integers(0, nrows, ntask).astype(np.int32)
    tj = rng.integers(0, nrows, ntask).astype(np.int32)
    ti[0] = tj[0] = 0
    ti[-1] = tj[-1] = nrows - 1  # the last row is a task
    return ap, ai, bp, bi, ti, tj


def _brute_per_task(arrs, d):
    ap, ai, bp, bi, ti, tj = arrs
    return np.array([
        len(set(ai[ap[i]:ap[i + 1]][:d]) & set(bi[bp[j]:bp[j + 1]][:d]))
        for i, j in zip(ti, tj)
    ], dtype=np.int64)


def _brute_tiles(arrs, tcount, tile, d):
    per = _brute_per_task(arrs, d)
    per[tcount:] = 0
    ntile = max(1, -(-per.shape[0] // tile))
    per = np.concatenate([per, np.zeros(ntile * tile - per.shape[0], np.int64)])
    return per.reshape(ntile, tile).sum(axis=1)


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("tcount", [0, 1, 250, 300])
@pytest.mark.parametrize("tile", [8, 32, 256])
def test_plain_matches_pallas_interpret_per_tile(tile, tcount):
    """Rows fit ``d``; row 0 (what padding tasks point at) is a real task
    too, so a padding task that leaked would show."""
    arrs, d = _case(0), 12
    want = np.asarray(j_fused_short_counts(
        *_j(arrs), tcount, tile=tile, d=d, interpret=True))
    got = fused_short_counts_plain(*_t(arrs), tcount, tile=tile, d=d)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), _brute_tiles(arrs, tcount, tile, d))
    total = int(got.sum())
    assert total == int(j_fused_short_ref(*_j(arrs), tcount, d=d, tile=tile))
    assert total == int(fused_short_ref(*_t(arrs), tcount, d=d, tile=tile))


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    arrs = _case(1)
    before = kmod.launch_count()
    a = fused_short_counts(*_t(arrs), 300, tile=32, d=12)
    b = fused_short_counts_plain(*_t(arrs), 300, tile=32, d=12)
    assert torch.equal(a, b)
    assert kmod.launch_count() == before


@pytest.mark.parametrize("tcount", [0, 1, 150, 300])
def test_truncation_contract(tcount):
    """Rows longer than ``d``: kernel semantics are ``row[:d]`` on both
    sides — the plain version, the port's reference and the JAX
    reference all truncate alike (and so undercount the true
    intersection, which is why probe-only plans are refused)."""
    arrs, d, tile = _case(2, maxd=40), 16, 8
    got = fused_short_counts_plain(*_t(arrs), tcount, tile=tile, d=d)
    assert np.array_equal(got.numpy(), _brute_tiles(arrs, tcount, tile, d))
    total = int(got.sum())
    assert total == int(fused_short_ref(*_t(arrs), tcount, d=d, tile=tile))
    assert total == int(j_fused_short_ref(*_j(arrs), tcount, d=d, tile=tile))
    if tcount == 300:
        assert total < int(_brute_per_task(arrs, 10**9).sum())


@pytest.mark.parametrize("tile", [16, 32])
def test_array_end_does_not_leak_neighbours(tile):
    """No padding after the last row and ``npad - start < d`` for it: the
    clipped gather must not pick up ids of the row before."""
    arrs, d = _case(3, pad=0, last_len=9, ntask=257), 12
    assert arrs[1].shape[0] - arrs[0][-2] < d
    for tcount in (1, 100, 257):
        got = fused_short_counts_plain(*_t(arrs), tcount, tile=tile, d=d)
        want = np.asarray(j_fused_short_counts(
            *_j(arrs), tcount, tile=tile, d=d, interpret=True))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), _brute_tiles(arrs, tcount, tile, d))


def test_d_beyond_the_whole_array():
    arrs, d, tile = _case(4, maxd=3, pad=0, last_len=3, ntask=100), 256, 16
    assert d > arrs[1].shape[0] and d > arrs[3].shape[0]
    got = fused_short_counts_plain(*_t(arrs), 100, tile=tile, d=d)
    assert np.array_equal(got.numpy(), _brute_tiles(arrs, 100, tile, d))
    assert int(got.sum()) == int(fused_short_ref(*_t(arrs), 100, d=d, tile=tile))


def test_sentinels_never_match():
    """A-side padding is −1, B-side ``int32.max``: two empty rows, or an
    empty row against a full one, intersect in nothing."""
    ap = np.array([0, 0, 3], np.int32)
    ai = np.array([1, 2, 3], np.int32)
    ti = np.array([0, 0, 1, 1], np.int32)
    tj = np.array([0, 1, 0, 1], np.int32)
    t = _t((ap, ai, ap, ai, ti, tj))
    got = fused_short_counts_plain(*t, 4, tile=8, d=4)
    assert got.tolist() == [3]
    assert int(fused_short_ref(*t, 4, d=4, tile=8)) == 3


def test_empty_task_list_gives_one_zero_tile():
    arrs = _case(5)
    t = _t(arrs)
    empty = torch.zeros(0, dtype=torch.int32)
    got = fused_short_counts(t[0], t[1], t[2], t[3], empty, empty, 0,
                             tile=8, d=12)
    assert got.tolist() == [0]
    with pytest.raises(ValueError):
        fused_short_counts(*t, 3, tile=0, d=12)


@pytest.mark.parametrize("d", [1, 7, 8, 32, 33, 64, 100, 512])
def test_fused_tile_for_matches(d):
    assert fused_tile_for(d) == j_fused_tile_for(d)
    assert 8 <= fused_tile_for(d) <= 256


def test_split_sizes_round_at_64_not_at_chunk():
    assert fused_split_sizes(100000, 0, 4096) == (0, 4096)
    assert fused_split_sizes(100000, 522, 4096) == (576, 576)
    assert fused_split_sizes(100000, 5000, 2048) == (6144, 2048)
    assert fused_split_sizes(300, 522, 4096) == (300, 576)


@pytest.mark.parametrize("long_fallback", ["global", "search"])
@pytest.mark.parametrize("n_long", [0, 10, 70, 400])
@pytest.mark.parametrize("tcount", [0, 5, 300])
def test_count_pair_fused_matches_reference(tcount, n_long, long_fallback):
    """Against the JAX dispatcher on its lax path, over n_long in
    {0, small, past one 64-block, >= tmax}: tasks are sorted long-first as
    the planner leaves them, short ones fit d_small."""
    rng = np.random.default_rng(6)
    nb, d_small, dmax = 48, 6, 14
    ap, ai = _random_csr(rng, nb, dmax, nb, 9)
    bp, bi = _random_csr(rng, nb, dmax, nb, 9)
    ti = rng.integers(0, nb, 300).astype(np.int32)
    tj = rng.integers(0, nb, 300).astype(np.int32)
    need = np.maximum(np.diff(ap)[ti], np.diff(bp)[tj])
    order = np.argsort(~(need > d_small), kind="stable")
    ti, tj = ti[order], tj[order]
    true_long = int((need > d_small).sum())
    n_long = max(n_long, true_long) if n_long else 0
    if n_long == 0:  # panel-only: make every task short
        d_small = dmax
    arrs = (ap, ai, bp, bi, ti, tj)
    kw = dict(n_long=n_long, d_small=d_small, dpad_long=dmax, chunk=128,
              long_fallback=long_fallback)
    want = int(j_count_pair_fused(*_j(arrs), tcount, impl="lax", **kw))
    got = count_pair_fused(*_t(arrs), tcount, **kw)
    assert got.dtype == torch.int64
    brute = int(_brute_per_task(arrs, 10**9)[:tcount].sum())
    assert int(got) == want == brute


def test_count_pair_fused_rejects_unknown_fallback():
    arrs = _case(7)
    with pytest.raises(ValueError, match="long_fallback"):
        count_pair_fused(*_t(arrs), 10, n_long=5, d_small=12, dpad_long=12,
                         chunk=64, long_fallback="nope")


def test_check_fused_split_refuses_probe_only_plans():
    g = tc.rmat(8, 8, seed=5)
    probe_only = tp.plan_cannon(g, 2, autotune=True, cache=tp.PlanCache())
    assert probe_only.plan.autotune["split"] == "probe"
    with pytest.raises(ValueError, match="maxfrag"):
        check_fused_split(probe_only.plan)
    with pytest.raises(ValueError, match="maxfrag"):
        build_cannon_fn(probe_only, method="fused")
    bare = tp.plan_cannon(g, 2, cache=tp.PlanCache())
    with pytest.raises(ValueError, match="maxfrag"):
        build_cannon_fn(bare, method="fused")
    with pytest.raises(ValueError, match="n_long/d_small"):
        make_csr_kernel("fused", dpad=8, chunk=64)
    ok = tp.plan_cannon(g, 2, autotune="fused", cache=tp.PlanCache())
    check_fused_split(ok.plan)
    with pytest.raises(ValueError, match="bucketized plan"):
        make_csr_kernel("search2", dpad=8, chunk=64)
    with pytest.raises(ValueError, match="registered"):
        make_csr_kernel("bogus", dpad=8, chunk=64)


def _trap_split(case, long_fallback):
    """``fused_step_counts``'s keywords for a trap case, and ``n_long_c``."""
    ap, ai, bp, bi, ti, tj = case["arrays"]
    n_long_c, _ = fused_split_sizes(len(ti), case["n_long"], case["chunk"])
    d = max(1, min(case["d_small"], len(ai), len(bi)))
    return dict(n_long=n_long_c, tile=case["tile"], d_long=case["dpad_long"],
                long_b_whole=long_fallback == "global", d_short=d)


def _brute_step_tiles(per, tcount, n_long, tile):
    """Per-tile sums of per-task counts: long tiles from 0, short tiles
    from ``n_long``, as the kernel lays them out."""
    per = per.copy()
    per[tcount:] = 0
    tmax = per.shape[0]
    parts = [per[:n_long], per[n_long:]]
    out = []
    for k, part in enumerate(parts):
        n = -(-part.shape[0] // tile)
        if k == 1 and (part.shape[0] or tmax == 0):
            n = max(1, n)
        pad = np.zeros(n * tile - part.shape[0], np.int64)
        out.append(np.concatenate([part, pad]).reshape(n, tile).sum(axis=1))
    return np.concatenate(out)


@pytest.mark.parametrize("name,long_fallback", TRAP_RUNS)
def test_plain_route_matches_the_jax_dispatcher_on_traps(name, long_fallback):
    """``count_pair_fused_plain`` against the JAX dispatcher on its lax
    path and brute force, on every trap case the chip run holds the
    kernel to, for every ``tcount``."""
    case = FUSED_TRAPS[name]
    per = chip_smoke.fused_brute(case, long_fallback)
    kw = chip_smoke.fused_case_kwargs(case, long_fallback)
    for tcount in case["tcounts"]:
        got = count_pair_fused_plain(*_t(case["arrays"]), tcount, **kw)
        want = int(j_count_pair_fused(*_j(case["arrays"]), tcount,
                                      impl="lax", **kw))
        assert got.dtype == torch.int64
        assert int(got) == want == int(per[:tcount].sum()), tcount


@pytest.mark.parametrize("name,long_fallback", TRAP_RUNS)
def test_step_counts_plain_per_tile_on_traps(name, long_fallback):
    """The plain version of the one launch: per tile against brute force
    (long tiles from task 0, short tiles from ``n_long``), its short tiles
    against ``fused_short_counts_plain``."""
    case = FUSED_TRAPS[name]
    split = _trap_split(case, long_fallback)
    per = chip_smoke.fused_brute(case, long_fallback)
    args = _t(case["arrays"])
    n_long = split["n_long"]
    for tcount in case["tcounts"]:
        got = fused_step_counts_plain(*args, tcount, **split)
        assert got.dtype == torch.int32
        want = _brute_step_tiles(per, tcount, n_long, split["tile"])
        assert np.array_equal(got.numpy(), want), tcount
        if n_long < args[4].shape[0]:
            short = fused_short_counts_plain(
                *args[:4], args[4][n_long:], args[5][n_long:],
                max(tcount - n_long, 0), tile=split["tile"],
                d=split["d_short"])
            ntile_long = -(-n_long // split["tile"])
            assert torch.equal(got[ntile_long:], short), tcount


def test_the_traps_hit_what_they_name():
    """Runs of 1, 31, 32, 33 and 1,000 equal ti; rows longer than the
    kernel's staging limit in A and in B, in both buckets; a B row past
    ``dpad_long`` in the long bucket where the two long-bucket functions
    differ; a long bucket that is no multiple of the tile; one that takes
    every task; a ring-shaped step of global ids; a ``tcount`` inside the
    long bucket."""
    runs = FUSED_TRAPS["runs_by_row"]["arrays"][4]
    lengths = np.diff(np.flatnonzero(np.r_[True, runs[1:] != runs[:-1], True]))
    assert {1, 31, 32, 33, 1000} <= set(lengths.tolist())
    case = FUSED_TRAPS["rows_past_stage_limit"]
    ap, ai, bp, bi, ti, tj = case["arrays"]
    n_long_c = _trap_split(case, "global")["n_long"]
    for bucket in (slice(0, n_long_c), slice(n_long_c, None)):
        assert (np.diff(ap)[ti[bucket]] > kmod.STAGE_LIMIT).any()
        assert (np.diff(bp)[tj[bucket]] > kmod.STAGE_LIMIT).any()
    assert case["d_small"] > kmod.STAGE_LIMIT
    assert (np.diff(bp)[tj[:n_long_c]] > case["dpad_long"]).any()
    for name in ("rows_past_stage_limit", "b_past_dpad_long",
                 "long_takes_all"):
        case = FUSED_TRAPS[name]
        assert (chip_smoke.fused_brute(case, "global").sum()
                != chip_smoke.fused_brute(case, "search").sum()), name
    case = FUSED_TRAPS["b_past_dpad_long"]
    assert _trap_split(case, "global")["n_long"] % case["tile"]
    case = FUSED_TRAPS["long_takes_all"]
    assert _trap_split(case, "global")["n_long"] == len(case["arrays"][4])
    # the ring's step: global ids near 2**20 padded with n + 1, A and B of
    # different row counts and pads, hub rows either side of the staging
    # limit in the long bucket, short tasks within d_small
    case = FUSED_TRAPS["ring_global_ids"]
    ap, ai, bp, bi, ti, tj = case["arrays"]
    n = chip_smoke.RING_N
    assert case["sentinel"] == n + 1 and case["fallbacks"] == ("search",)
    assert ai[ap[-1]:].tolist() == [n + 1] * (len(ai) - ap[-1])
    assert bi[bp[-1]:].tolist() == [n + 1] * (len(bi) - bp[-1])
    assert max(ai[:ap[-1]].max(), bi[:bp[-1]].max()) == n - 1
    assert len(ap) != len(bp) and len(ai) - ap[-1] != len(bi) - bp[-1]
    n_long_c = _trap_split(case, "search")["n_long"]
    hubs = {kmod.STAGE_LIMIT - 1, kmod.STAGE_LIMIT, kmod.STAGE_LIMIT + 1, 700}
    assert hubs <= set(np.diff(ap)[ti[:n_long_c]].tolist())
    assert hubs <= set(np.diff(bp)[tj[:n_long_c]].tolist())
    assert max(np.diff(ap)[ti[n_long_c:]].max(),
               np.diff(bp)[tj[n_long_c:]].max()) <= case["d_small"]
    assert chip_smoke.fused_brute(case, "search")[:n_long_c].sum() > 0
    for case in FUSED_TRAPS.values():
        n_long_c = _trap_split(case, "global")["n_long"]
        if n_long_c:
            assert any(0 < tc < n_long_c for tc in case["tcounts"])


@pytest.mark.parametrize("name", list(FUSED_TRAPS))
def test_count_pair_fused_on_the_cpu_launches_nothing(name):
    """On CPU tensors ``count_pair_fused`` is its plain route, and the
    one-launch entry its plain version: no kernel launch is counted."""
    case = FUSED_TRAPS[name]
    args = _t(case["arrays"])
    before = kmod.launch_count()
    for fb in case["fallbacks"]:
        kw = chip_smoke.fused_case_kwargs(case, fb)
        for tcount in case["tcounts"]:
            assert torch.equal(count_pair_fused(*args, tcount, **kw),
                               count_pair_fused_plain(*args, tcount, **kw))
            split = _trap_split(case, fb)
            assert torch.equal(fused_step_counts(*args, tcount, **split),
                               fused_step_counts_plain(*args, tcount, **split))
    assert kmod.launch_count() == before


def test_step_counts_refuse_bad_splits():
    args = _t(_case(8))
    with pytest.raises(ValueError, match="n_long"):
        fused_step_counts(*args, 10, n_long=301, tile=32, d_long=12,
                          long_b_whole=True, d_short=12)
    with pytest.raises(ValueError, match=">= 1"):
        fused_step_counts(*args, 10, n_long=0, tile=0, d_long=12,
                          long_b_whole=True, d_short=12)


@pytest.mark.parametrize("spec,q", [("rmat:9,8,42", 3), ("cliques:3,60", 3)])
def test_fused_count_makes_one_plan(spec, q):
    """``method="fused"`` plans once (the relabel and one plan in the
    cache, no second plan with row-encoded keys), its plan and store carry
    no ``b_aug``, and it still counts right — also from a plan handed in
    with ``b_aug`` staged."""
    from repro.core import graph_from_spec as j_graph_from_spec
    from repro.core.graph import triangle_count_oracle

    g = tc.graph_from_spec(spec)
    want = triangle_count_oracle(j_graph_from_spec(spec))
    cache = tp.PlanCache()
    r = tc.count_triangles(g, q=q, method="fused", device="cpu", cache=cache)
    assert r.plan.n_long > 0  # the long bucket is live
    assert len(cache) == 2  # relabel + one plan
    assert r.plan.b_aug is None
    assert "b_aug" not in build_cannon_fn(r.plan, method="fused").ordered
    assert r.triangles == want
    staged = tp.plan_cannon(g, q, autotune="fused", aug_keys=True,
                            cache=tp.PlanCache())
    assert staged.plan.b_aug is not None
    assert "b_aug" not in build_cannon_fn(staged, method="fused").ordered
    assert tc.count_triangles(g, plan=staged, method="fused",
                              device="cpu").triangles == want


def test_fused_sweep_edits_apply_to_the_kernel_source():
    """``launch/fused_sweep.py`` builds its variants by editing
    ``csrc/tc_fused.cu``: each edit must still find what it edits, and each
    variant must differ from the kernel unless only its tile differs."""
    from repro_torch.kernels import _build
    from repro_torch.launch import fused_sweep

    src = _build.source_path("tc_fused").read_text()
    table = fused_sweep.variants(src)
    assert table["kernel"] == (src, None, True)
    for name, (text, tile, must_equal) in table.items():
        if name == "kernel":
            continue
        assert (text != src) != (tile is not None), name
        assert must_equal == (name not in ("no_search", "skeleton")), name
    with pytest.raises(ValueError, match="kRatio"):
        fused_sweep.variants(src.replace("kRatio = ", "kRatioX = "))


@pytest.mark.gpu
def test_kernel_equals_plain_on_the_gpu():
    """The CUDA kernel against its plain versions: the short bucket per
    tile on the old trap inputs; both buckets in one launch
    (``count_pair_fused``, ``fused_step_counts``) on ``fused_trap_cases``.
    Needs a CUDA device and nvcc; ``python3 chip_smoke.py`` runs the same
    comparisons (and more) on a machine that has them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    for seed, kw, d, tile in ((0, {}, 12, 32), (2, dict(maxd=40), 16, 8),
                              (3, dict(pad=0, last_len=9), 12, 32)):
        arrs = [a.cuda() for a in _t(_case(seed, **kw))]
        for tcount in (0, 1, 150, 300):
            before = kmod.launch_count()
            got = fused_short_counts(*arrs, tcount, tile=tile, d=d)
            want = fused_short_counts_plain(*arrs, tcount, tile=tile, d=d)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert kmod.launch_count() == before + 1
    assert kmod.stage_limit() == kmod.STAGE_LIMIT
    for name, case in FUSED_TRAPS.items():
        args = [a.cuda() for a in _t(case["arrays"])]
        for fb in case["fallbacks"]:
            kw = chip_smoke.fused_case_kwargs(case, fb)
            split = _trap_split(case, fb)
            for tcount in case["tcounts"]:
                before = kmod.launch_count()
                got = count_pair_fused(*args, tcount, **kw)
                assert kmod.launch_count() == before + 1
                want = count_pair_fused_plain(*args, tcount, **kw)
                assert int(got) == int(want), (name, fb, tcount)
                assert torch.equal(
                    fused_step_counts(*args, tcount, **split),
                    fused_step_counts_plain(*args, tcount, **split)), (
                        name, fb, tcount)
