"""The plain-PyTorch count paths against ``repro.core.count``.

The same random CSR blocks and task lists, made with numpy from a seed,
go through the JAX functions and through the port's on the CPU.  Results
are integers and integer arrays, so parity is ``==`` with no tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.count as jcount
import repro_torch.core.count as tcount


def _random_csr(rng, nrows, maxd, ncols, pad):
    """A CSR block as the planner packs it: sorted duplicate-free rows,
    padding positions holding the ``ncols`` sentinel."""
    lens = rng.integers(0, maxd + 1, size=nrows)
    rows = [np.sort(rng.choice(ncols, size=int(k), replace=False)) for k in lens]
    indptr = np.zeros(nrows + 1, np.int32)
    indptr[1:] = np.cumsum(lens)
    idx = np.concatenate(rows + [np.full(pad, ncols)]).astype(np.int32)
    return indptr, idx


def _blocks(seed, nb=48, maxd=14, pad=9, ntask=333):
    rng = np.random.default_rng(seed)
    ap, ai = _random_csr(rng, nb, maxd, nb, pad)
    bp, bi = _random_csr(rng, nb, maxd, nb, pad)
    ti = rng.integers(0, nb, ntask).astype(np.int32)
    tj = rng.integers(0, nb, ntask).astype(np.int32)
    return ap, ai, bp, bi, ti, tj


def _brute(ap, ai, bp, bi, ti, tj, tcount):
    return sum(
        len(set(ai[ap[i]:ap[i + 1]]) & set(bi[bp[j]:bp[j + 1]]))
        for i, j in zip(ti[:tcount], tj[:tcount])
    )


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("dpad", [1, 5, 14, 20])
def test_gather_rows_matches(dpad):
    ap, ai, *_ = _blocks(0)
    rows = np.arange(ap.shape[0] - 1, dtype=np.int32)[::-1].copy()
    sentinel = ap.shape[0]
    jv, jl = jcount.gather_rows(jnp.asarray(ap), jnp.asarray(ai),
                                jnp.asarray(rows), dpad, sentinel)
    tv, tl = tcount.gather_rows(torch.from_numpy(ap), torch.from_numpy(ai),
                                torch.from_numpy(rows), dpad, sentinel)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert tv.dtype == torch.int32


@pytest.mark.parametrize("probe_shorter", [True, False])
@pytest.mark.parametrize("chunk", [64, 100, 512])
@pytest.mark.parametrize("tc", [0, 1, 200, 333])
def test_count_pair_search_matches(tc, chunk, probe_shorter):
    arrs = _blocks(1)
    kw = dict(dpad=14, chunk=chunk, probe_shorter=probe_shorter)
    want = int(jcount.count_pair_search(*_j(arrs), tc, **kw))
    got = tcount.count_pair_search(*_t(arrs), tc, **kw)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want == _brute(*arrs, tc)


def test_count_pair_search_default_sentinel_is_nb_plus_one():
    arrs = _blocks(2)
    nb = arrs[0].shape[0] - 1
    a = tcount.count_pair_search(*_t(arrs), 333, dpad=14, chunk=128)
    b = tcount.count_pair_search(*_t(arrs), 333, dpad=14, chunk=128,
                                 sentinel=nb + 1)
    assert int(a) == int(b) == _brute(*arrs, 333)
    vals, _ = tcount.gather_rows(*_t(arrs[:2]), torch.tensor([0]), 20, nb + 1)
    assert int(vals.max()) == nb + 1


def test_build_aug_keys_matches():
    _, _, bp, bi, _, _ = _blocks(3)
    want = np.asarray(jcount.build_aug_keys(jnp.asarray(bp), jnp.asarray(bi)))
    got = tcount.build_aug_keys(torch.from_numpy(bp), torch.from_numpy(bi))
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    assert bool((got[1:] >= got[:-1]).all())  # sorted, padding on top
    from repro_torch.core.plan import host_aug_keys

    assert np.array_equal(host_aug_keys(bp[None, None], bi[None, None])[0, 0],
                          got.numpy())


@pytest.mark.parametrize("staged_keys", [False, True])
@pytest.mark.parametrize("chunk", [64, 512])
@pytest.mark.parametrize("tc", [0, 1, 200, 333])
def test_count_pair_search_global_matches(tc, chunk, staged_keys):
    arrs = _blocks(4)
    kw = dict(dpad=14, chunk=chunk)
    want = int(jcount.count_pair_search_global(*_j(arrs), tc, **kw))
    aug = None
    if staged_keys:
        aug = tcount.build_aug_keys(*_t(arrs[2:4]))
    got = tcount.count_pair_search_global(*_t(arrs), tc, aug_b=aug, **kw)
    assert int(got) == want == _brute(*arrs, tc)


def test_global_sentinel_is_base_minus_one():
    """``global`` pads probes with ``base - 1 = nb``: a padded slot must
    never hit the padding keys of the B block (column ``nb`` as well)."""
    ap = np.array([0, 1, 1], np.int32)
    ai = np.array([0, 2, 2, 2], np.int32)  # row 0 = {0}; padding = nb = 2
    bp = np.array([0, 1, 1], np.int32)
    bi = np.array([0, 2, 2, 2], np.int32)
    ti = np.zeros(4, np.int32)
    tj = np.zeros(4, np.int32)
    arrs = (ap, ai, bp, bi, ti, tj)
    got = tcount.count_pair_search_global(*_t(arrs), 4, dpad=3, chunk=2)
    want = jcount.count_pair_search_global(*_j(arrs), 4, dpad=3, chunk=2)
    assert int(got) == int(want) == 4


def test_aug_key_dtype_boundary():
    """``row * base + col`` fits int32 up to base = 46340 (nb = 46339)
    and needs int64 from base = 46341 on; the port has no overflow error,
    it widens.  Both sides of the boundary are pinned, device and host."""
    for base, want_t, want_n in (
        (46339, torch.int32, np.int32),
        (46340, torch.int32, np.int32),
        (46341, torch.int64, np.int64),
        (262145, torch.int64, np.int64),
    ):
        assert tcount.aug_key_dtype(base) == want_t
        assert tcount.aug_key_numpy_dtype(base) == np.dtype(want_n)
    assert jcount.aug_key_dtype(46340) == jnp.int32
    with pytest.raises(OverflowError):  # the reference under x64-off
        jcount.aug_key_dtype(46341)


def test_wide_keys_count_right_past_the_int32_boundary():
    """A block with nb = 46341: keys are int64 on the device build and the
    host build alike, and the count is still exact."""
    nb = 46341
    rows = {5: [7, 46000, 46340], 46340: [3, 46000, 46340], 100: [46340]}
    lens = np.zeros(nb, np.int64)
    for r, cols in rows.items():
        lens[r] = len(cols)
    ptr = np.zeros(nb + 1, np.int32)
    ptr[1:] = np.cumsum(lens)
    idx = np.concatenate(
        [np.asarray(rows[r]) for r in sorted(rows)] + [np.full(4, nb)]
    ).astype(np.int32)
    ti = np.array([5, 46340, 100, 5], np.int32)
    tj = np.array([46340, 5, 46340, 100], np.int32)
    t = _t((ptr, idx, ptr, idx, ti, tj))
    aug = tcount.build_aug_keys(t[2], t[3])
    assert aug.dtype == torch.int64
    from repro_torch.core.plan import host_aug_keys

    host = host_aug_keys(ptr[None, None], idx[None, None])
    assert host.dtype == np.int64
    assert np.array_equal(host[0, 0], aug.numpy())
    got = tcount.count_pair_search_global(*t, 4, dpad=4, chunk=2, aug_b=aug)
    assert int(got) == 2 + 2 + 1 + 1
    with pytest.raises(TypeError):
        tcount.count_pair_search_global(*t, 4, dpad=4, chunk=2,
                                        aug_b=aug.to(torch.int32))
