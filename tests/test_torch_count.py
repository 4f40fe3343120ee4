"""The plain-PyTorch count paths against ``repro.core.count``.

The same random CSR blocks and task lists, made with numpy from a seed,
go through the JAX functions and through the port's on the CPU.  Results
are integers and integer arrays, so parity is ``==`` with no tolerance.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.count as jcount
import repro_torch.core.count as tcount


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# ----------------------------------------------------------------------
# search2: the two-level search, bucketize_plan, method="search2" | "auto"
# ----------------------------------------------------------------------
TWO_LEVEL = dict(dpad_long=14, chunk=64)


@pytest.mark.parametrize("dpad_short", [3, 8, 14])
@pytest.mark.parametrize("n_long", [0, 10, 100, 333])
@pytest.mark.parametrize("tc", [0, 1, 200, 333])
def test_count_pair_search_two_level_matches(tc, n_long, dpad_short):
    """Both buckets through the global-key search, the short one cut at
    ``dpad_short``: the same function in both packages (int32 keys)."""
    arrs = _blocks(5)
    kw = dict(TWO_LEVEL, dpad_short=dpad_short)
    want = int(jcount.count_pair_search_two_level(*_j(arrs), tc, n_long,
                                                  **kw))
    got = tcount.count_pair_search_two_level(*_t(arrs), tc, n_long, **kw)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    if dpad_short == 14:  # the longest row: nothing cut
        assert want == _brute(*arrs, tc)
    staged = tcount.build_aug_keys(*_t(arrs[2:4]))
    assert int(tcount.count_pair_search_two_level(
        *_t(arrs), tc, n_long, aug_b=staged, **kw)) == want


def _wide_blocks(nb, seed=6, nrows=300, ntask=500):
    """Random CSR blocks of ``nb`` rows, ids drawn up to ``nb - 1`` so the
    row-encoded keys reach ``nb * (nb + 1) - 1``: int32 up to nb = 46339,
    int64 from nb = 46340 on."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(nb, nrows, replace=False))
    lens = np.zeros(nb, np.int64)
    lens[rows] = rng.integers(1, 21, nrows)
    lens[nb - 1] = 5  # the last row: the largest keys
    cols = [np.sort(rng.choice(nb, int(k), replace=False)) for k in lens if k]
    ptr = np.zeros(nb + 1, np.int32)
    ptr[1:] = np.cumsum(lens)
    idx = np.concatenate(cols + [np.full(3, nb)]).astype(np.int32)
    live = np.flatnonzero(lens)
    ti = rng.choice(live, ntask).astype(np.int32)
    tj = rng.choice(live, ntask).astype(np.int32)
    ti[0] = tj[0] = nb - 1
    return ptr, idx, ptr, idx, ti, tj


WIDE_NBS = (46338, 46339, 46340, 46341)
# no row of _wide_blocks is longer than 20 ids: nothing is cut
WIDE_KW = dict(dpad_long=20, dpad_short=20, chunk=64)
WIDE_CASES = [(nb, tc, n_long) for nb in WIDE_NBS for tc in (1, 500)
              for n_long in (0, 200)]


@pytest.fixture(scope="module")
def two_level_wide_reference(distributed_runner):
    """The JAX package's two-level count on blocks either side of the
    int32 key boundary, run as its own tests run wide keys: in a process
    with x64 on."""
    code = f"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
from test_torch_count import _wide_blocks, WIDE_CASES, WIDE_KW
from repro.core.count import count_pair_search_two_level
out = {{}}
blocks = {{}}
for nb, tc, n_long in WIDE_CASES:
    if nb not in blocks:
        blocks[nb] = [jnp.asarray(a) for a in _wide_blocks(nb)]
    out[f"{{nb}}/{{tc}}/{{n_long}}"] = int(count_pair_search_two_level(
        *blocks[nb], tc, n_long, **WIDE_KW))
print("RESULT" + json.dumps(out))
"""
    out = distributed_runner(code, ndev=1)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("nb", WIDE_NBS)
def test_two_level_either_side_of_the_key_boundary(two_level_wide_reference,
                                                   nb):
    """int32 keys up to nb = 46339 (base 46,340), int64 past it: the
    port's count equals the reference's (x64 on) and brute force, with
    keys built on the device and staged by the host alike."""
    from repro_torch.core.plan import host_aug_keys

    arrs = _wide_blocks(nb)
    t = _t(arrs)
    aug = tcount.build_aug_keys(t[2], t[3])
    assert aug.dtype == (torch.int32 if nb <= 46339 else torch.int64)
    host = host_aug_keys(arrs[2][None, None], arrs[3][None, None])[0, 0]
    assert np.array_equal(host, aug.numpy())
    for case in WIDE_CASES:
        if case[0] != nb:
            continue
        _, tc, n_long = case
        want = two_level_wide_reference[f"{nb}/{tc}/{n_long}"]
        for keys in (None, aug):
            got = tcount.count_pair_search_two_level(
                *t, tc, n_long, aug_b=keys, **WIDE_KW)
            assert int(got) == want == _brute(*arrs, tc), case


def test_two_level_warns_once_about_ignored_knobs(monkeypatch):
    import warnings

    monkeypatch.setattr(tcount, "_TWO_LEVEL_KW_WARNED", False)
    arrs = _t(_blocks(5))
    kw = dict(TWO_LEVEL, dpad_short=8)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        tcount.count_pair_search_two_level(*arrs, 10, 5, **kw)
    assert not seen  # defaults: nothing ignored, nothing said
    with pytest.warns(UserWarning, match=r"ignores probe_shorter=False, "
                                         r"sentinel=7"):
        tcount.count_pair_search_two_level(*arrs, 10, 5, probe_shorter=False,
                                           sentinel=7, **kw)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        tcount.count_pair_search_two_level(*arrs, 10, 5, probe_shorter=False,
                                           **kw)
    assert not seen  # once per process


BUCKET_SPECS = ["rmat:9,8,42", "star:64", "cliques:3,60", "named:karate"]


@pytest.mark.parametrize("d_small", [4, 32])
@pytest.mark.parametrize("q", [1, 2, 3])
def test_bucketize_plan_byte_identical(q, d_small):
    """``plan_cannon(bucketize=True)``: the long|short reorder, ``n_long``,
    ``d_small``, ``bucket_stats`` and the cache key as the reference's."""
    import repro.core as jc
    import repro.pipeline as jp
    import repro_torch.core as tc
    import repro_torch.pipeline as tp
    from repro.core.plan import bucketize_plan as j_bucketize
    from repro_torch.core.plan import bucketize_plan as t_bucketize

    for spec in BUCKET_SPECS:
        kw = dict(bucketize=True, d_small=d_small, aug_keys=True,
                  keep_blocks=False)
        a = jp.plan_cannon(jc.graph_from_spec(spec), q, cache=jp.PlanCache(),
                           **kw)
        b = tp.plan_cannon(tc.graph_from_spec(spec), q, cache=tp.PlanCache(),
                           **kw)
        assert a.key == b.key
        for f in ("m_ti", "m_tj", "b_aug", "a_indices", "step_keep"):
            va, vb = getattr(a.plan, f), getattr(b.plan, f)
            assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes(), f
        for f in ("n_long", "d_small", "bucket_stats", "skew_perm", "chunk"):
            assert getattr(a.plan, f) == getattr(b.plan, f), f
        assert b.plan.blocks is not None  # the bucketizer's input
        # the stage alone, on a plan packed without compaction
        ga = jc.preprocess(jc.graph_from_spec(spec))[0]
        gb = tc.preprocess(tc.graph_from_spec(spec))[0]
        pa = j_bucketize(jc.build_plan(ga, q), d_small=d_small)
        pb = t_bucketize(tc.build_plan(gb, q), d_small=d_small)
        assert pa.m_ti.tobytes() == pb.m_ti.tobytes()
        assert pa.m_tj.tobytes() == pb.m_tj.tobytes()
        assert (pa.n_long, pa.bucket_stats) == (pb.n_long, pb.bucket_stats)


def test_bucketize_plan_needs_blocks():
    import repro_torch.core as tc
    from repro_torch.core.plan import bucketize_plan

    g = tc.preprocess(tc.graph_from_spec("named:karate"))[0]
    with pytest.raises(ValueError, match="keep_blocks"):
        bucketize_plan(tc.build_plan(g, 2, keep_blocks=False))


@pytest.mark.parametrize("method", ["search2", "auto"])
@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("spec", BUCKET_SPECS + ["powerlaw:300,2.5,1"])
def test_count_triangles_search2_and_auto(spec, q, method):
    """Cannon with ``search2`` (bucketized plan, staged keys) and ``auto``
    (resolved from the autotune report): the oracle's count; at q = 1
    the reference's count and resolution too."""
    import repro.core as jc
    import repro_torch as rt
    import repro_torch.pipeline as tp

    g = rt.graph_from_spec(spec)
    r = rt.count_triangles(g, q=q, method=method, device="cpu",
                           cache=tp.PlanCache())
    assert r.triangles == rt.triangle_count_oracle(g)
    if method == "search2":
        from repro_torch.core.cannon import build_cannon_fn

        assert r.method == "search2" and r.plan.bucket_stats is not None
        # the staged keys travel with B: nothing rebuilds them per step
        assert r.plan.b_aug is not None
        assert "b_aug" in build_cannon_fn(r.artifact, method="search2").ordered
    else:
        assert r.autotune_mode == "percentile"
        want = "search2" if r.plan.autotune["tail_heavy"] else "search"
        assert r.method == want
    if q == 1:
        ref = jc.count_triangles(jc.graph_from_spec(spec), q=1,
                                 method=method)
        assert (r.triangles, r.method) == (ref.triangles, ref.method)
