"""The fused intersection module against ``repro.kernels.tc_fused``.

The CUDA kernel cannot run without a GPU; what runs here is its plain
PyTorch version (which the wrapper takes for CPU tensors) — per tile
against the reference's Pallas body under the interpreter, in total
against both packages' independently formulated references and a brute
force.  The same inputs, made with numpy from a seed, go to both
packages; everything is integers, so parity is ``==``.
"""
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
    fused_short_counts,
    fused_short_counts_plain,
    fused_short_ref,
    fused_split_sizes,
    fused_tile_for,
)
from repro_torch.kernels.tc_fused import tc_fused as kmod


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
    with pytest.raises(ValueError, match="registered"):
        make_csr_kernel("search2", dpad=8, chunk=64)


@pytest.mark.gpu
def test_kernel_equals_plain_on_the_gpu():
    """The CUDA kernel against its plain version, per tile, on the trap
    inputs.  Needs a CUDA device and nvcc; ``python3 chip_smoke.py`` runs
    the same comparison (and more) on a machine that has them."""
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
