"""The port's optimisers, gradient compression, sparse ops and data
pipelines against the JAX package's.

The same numpy params, grads and inputs, made from a seed, go through both
packages.  Tolerances: float32 optimiser states and params within
``rtol=1e-6, atol=1e-7`` over 5 steps (reduction order and the last bit of
a division may differ); segment and bag ops within ``1e-6``; int8 codes,
their scales, the compressed sum, the sampler and every pipeline batch
``==``.  The schedules are ``==`` but for the cosine, which XLA takes in
float32 without correct rounding: there the two differ by one unit in the
last place exactly where XLA's cosine does.  The reference's own guards
(the quadratics fall, the compression error, the normalised softmax, the
dense oracles) run on the port too.
"""
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.data.pipeline as jpipe
import repro.optim as jo
import repro.sparse as jsp
from repro.optim import compress as jcomp
from repro.optim import schedule as jsched
from repro.sparse import sampler as jsampler
import repro_torch.core as tc
import repro_torch.data.pipeline as tpipe
import repro_torch.optim as to
import repro_torch.sparse as tsp
from repro_torch.optim import compress as tcomp
from repro_torch.optim import schedule as tsched
from repro_torch.sparse import sampler as tsampler
from repro_torch.sparse import segment as tseg

# the modules, which the packages' ``embedding_bag`` functions shadow
jbag = importlib.import_module("repro.sparse.embedding_bag")
tbag = importlib.import_module("repro_torch.sparse.embedding_bag")

RTOL, ATOL = 1e-6, 1e-7  # float32 optimiser parity
SPARSE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(33, 17)).astype(np.float32),
        "b": rng.normal(size=(17,)).astype(np.float32),
        "blk": {"t": rng.normal(size=(3, 5, 7)).astype(np.float32)},
    }


def _grads(step, like):
    rng = np.random.default_rng(100 + step)
    return {k: _grads(step, v) if isinstance(v, dict) else
            (rng.normal(size=v.shape) * (1 + step)).astype(np.float32)
            for k, v in like.items()}


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _run_both(name, steps=5, **kw):
    """``steps`` updates of ``name`` in both packages from the same
    params and grads; returns ((params, state) reference, port)."""
    out = []
    for mod, to_t in ((jo, jnp.asarray), (to, torch.from_numpy)):
        init, update = mod.make_optimizer(name, 0.01, **kw)
        params = _tree(to_t, _params())
        state = init(params)
        for i in range(steps):
            params, state, _ = update(_tree(to_t, _grads(i, _params())),
                                      state, params, i)
        out.append((params, state))
    return out


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    return [np.asarray(tree) if not isinstance(tree, torch.Tensor)
            else tree.numpy()]


# ----------------------------------------------------------------------
# optimisers and schedules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_params_and_states_match_the_reference(name):
    (jp, js), (tp, ts) = _run_both(name)
    for ref, got in ((jp, tp), (js, ts)):
        a, b = _leaves_np(ref), _leaves_np(got)
        assert [x.shape for x in a] == [x.shape for x in b]
        assert [x.dtype for x in a] == [x.dtype for x in b]
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)


def test_adafactor_factors_a_matrix_and_keeps_a_vector_whole():
    (_, js), (_, ts) = _run_both("adafactor", steps=1)
    assert set(ts["v"]["w"]) == {"vr", "vc"} == set(js["v"]["w"])
    assert tuple(ts["v"]["w"]["vr"].shape) == (33,)
    assert tuple(ts["v"]["w"]["vc"].shape) == (17,)
    assert tuple(ts["v"]["blk"]["t"]["vr"].shape) == (3, 5)
    assert tuple(ts["v"]["blk"]["t"]["vc"].shape) == (3, 7)
    assert set(ts["v"]["b"]) == {"v"}


def test_adamw_clips_the_global_grad_norm():
    p = {"w": torch.tensor([3.0, -2.0])}
    g = {"w": torch.tensor([30.0, 40.0])}
    _, _, info = to.adamw_update(g, to.adamw_init(p), p, 0, lr=0.1)
    ref = jo.adamw_update({"w": jnp.asarray([30.0, 40.0])},
                          jo.adamw_init({"w": jnp.asarray([3.0, -2.0])}),
                          {"w": jnp.asarray([3.0, -2.0])}, 0, lr=0.1)[2]
    assert float(info["grad_norm"]) == float(ref["grad_norm"]) == 50.0


def test_make_optimizer_refuses_an_unknown_name():
    with pytest.raises(ValueError):
        to.make_optimizer("sgd", 0.1)


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    st = to.adamw_init(params)
    for i in range(200):
        grads = {"w": 2 * params["w"]}
        params, st, _ = to.adamw_update(grads, st, params, i, lr=0.05,
                                        weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1


def test_adafactor_reduces_quadratic_matrix():
    params = {"w": torch.ones((4, 5)) * 2.0}
    st = to.adafactor_init(params)
    for i in range(300):
        grads = {"w": 2 * params["w"]}
        params, st, _ = to.adafactor_update(grads, st, params, i, lr=0.05)
    assert float(params["w"].abs().max()) < 0.2
    assert tuple(st["v"]["w"]["vr"].shape) == (4,)
    assert tuple(st["v"]["w"]["vc"].shape) == (5,)


def test_an_optimizer_with_a_schedule_matches_the_reference():
    out = []
    for mod, sched, to_t in ((jo, jsched, jnp.asarray),
                             (to, tsched, torch.from_numpy)):
        init, update = mod.make_optimizer(
            "adamw", sched.linear_warmup(0.02, 3))
        params = _tree(to_t, _params(1))
        state = init(params)
        for i in range(4):
            params, state, _ = update(_tree(to_t, _grads(i, _params(1))),
                                      state, params, i)
        out.append(_leaves_np(params))
    for x, y in zip(*out):
        np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)


SCHEDULES = [(3e-4, 10, 200, 0.1), (1.0, 20, 150, 0.0), (0.05, 1, 100, 0.1),
             (2e-3, 50, 200, 0.2)]


@pytest.mark.parametrize("peak,warmup", [(3e-4, 10), (1.0, 1), (0.02, 64)])
def test_linear_warmup_equals_the_reference(peak, warmup):
    ref = jsched.linear_warmup(peak, warmup)
    got = tsched.linear_warmup(peak, warmup)
    for s in range(201):
        r, g = np.asarray(ref(s)), got(s).numpy()
        assert r.dtype == g.dtype == np.float32
        assert r == g, s


@pytest.mark.parametrize("cfg", SCHEDULES)
def test_cosine_schedule_equals_the_reference_but_for_xlas_cosine(cfg):
    """``==`` at every step where XLA's float32 cosine is correctly
    rounded; one unit in the last place where it is not."""
    peak, warmup, total, floor = cfg
    ref = jsched.cosine_schedule(peak, warmup, total, floor)
    got = tsched.cosine_schedule(peak, warmup, total, floor)
    differ = 0
    for s in range(201):
        r, g = np.asarray(ref(s)), got(s).numpy()
        assert r.dtype == g.dtype == np.float32
        if r == g:
            continue
        differ += 1
        np.testing.assert_array_max_ulp(g, r, maxulp=1)
        t = np.clip(np.float32(s - warmup) / np.float32(max(1, total - warmup)),
                    0, 1)
        x = np.float32(np.pi) * t
        assert np.asarray(jnp.cos(x)) != np.float32(np.cos(np.float64(x))), s
    assert differ <= 20


# ----------------------------------------------------------------------
# gradient compression
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape,scale", [((333, 7), 0.01), ((1024,), 1.0),
                                         ((5, 5, 41), 3.0), ((1,), 0.5)])
def test_quantize_codes_and_scales_equal_the_reference(shape, scale):
    g = (np.random.default_rng(2).normal(size=shape) * scale).astype(np.float32)
    qj, sj = jcomp._quantize(jnp.asarray(g))
    qt, st = tcomp._quantize(torch.from_numpy(g))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    back_j = jcomp._dequantize(qj, sj, g.shape, g.size)
    back_t = tcomp._dequantize(qt, st, g.shape, g.size)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))


def test_quantize_and_dequantize_grads_trees_equal_the_reference():
    grads = _grads(3, _params())
    jq = jcomp.quantize_grads(_tree(jnp.asarray, grads))
    tq = tcomp.quantize_grads(_tree(torch.from_numpy, grads))
    jb = jcomp.dequantize_grads(jq, _tree(jnp.asarray, grads))
    tb = tcomp.dequantize_grads(tq, _tree(torch.from_numpy, grads))
    for x, y in zip(_leaves_np(jb), _leaves_np(tb)):
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("shape", [(4, 16), (4, 3000), (3, 7, 11)])
def test_compressed_psum_equals_the_reference(shape):
    """The reference's own ``compressed_psum`` under ``jax.vmap`` with a
    named axis (its ``pmax`` and ``psum`` over the replicas), and the
    reference's quantizer against the shared group-max scale summed by
    hand: both ``==`` the port's sum over the leading dimension."""
    x = (np.random.default_rng(3).normal(size=shape) * 0.5).astype(np.float32)
    got = tcomp.compressed_psum({"w": torch.from_numpy(x)})["w"].numpy()
    assert got.shape == shape[1:]
    ref = jax.vmap(lambda v: jcomp.compressed_psum({"w": v}, "d")["w"],
                   axis_name="d")(jnp.asarray(x))
    for r in np.asarray(ref):
        np.testing.assert_array_equal(got, r)
    flat = x.reshape(shape[0], -1)
    pad = (-flat.shape[1]) % jcomp.CHUNK
    ch = np.pad(flat, ((0, 0), (0, pad))).reshape(
        shape[0], -1, jcomp.CHUNK)
    amax = np.abs(ch).max(axis=(0, 2))[:, None]
    scale = np.asarray(jnp.maximum(jnp.asarray(amax), 1e-12) / 127.0)
    codes = np.stack([np.asarray(jnp.clip(jnp.round(
        jnp.asarray(c) / scale), -127, 127).astype(jnp.int8)) for c in ch])
    summed = codes.astype(np.int32).sum(axis=0)
    by_hand = np.asarray(jcomp._dequantize(jnp.asarray(summed),
                                           jnp.asarray(scale), shape[1:],
                                           int(np.prod(shape[1:]))))
    np.testing.assert_array_equal(got, by_hand)


def test_compressed_psum_takes_the_replica_dimension_anywhere():
    x = (np.random.default_rng(4).normal(size=(6, 4, 5))).astype(np.float32)
    t = torch.from_numpy(x)
    a = tcomp.compressed_psum({"w": t}, dim=1)["w"]
    b = tcomp.compressed_psum({"w": t.movedim(1, 0)})["w"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_grad_compression_accuracy():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(333, 7)).astype(np.float32)) * 0.01
    q, s = tcomp._quantize(g)
    back = tcomp._dequantize(q, s, g.shape, g.numel())
    rel = float(torch.linalg.norm(back - g) / torch.linalg.norm(g))
    assert rel < 0.01, rel


def test_compressed_psum_matches_plain():
    x = torch.arange(64, dtype=torch.float32).reshape(4, 16) * 0.01
    got = tcomp.compressed_psum({"w": x})["w"]
    ref = x.sum(dim=0)
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    assert rel < 0.02, rel


# ----------------------------------------------------------------------
# sparse
# ----------------------------------------------------------------------
def _edges(seed=1, n=10, e=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(e,)).astype(np.float32))


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=SPARSE_TOL, atol=SPARSE_TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_edges_matches_the_reference(reduce, weighted):
    src, dst, x, w = _edges(n=12)
    dst = np.minimum(dst, 9)  # segments 10, 11 stay empty (max: -inf)
    kw_j = dict(edge_weight=jnp.asarray(w)) if weighted else {}
    kw_t = dict(edge_weight=torch.from_numpy(w)) if weighted else {}
    ref = jsp.spmm_edges(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                         12, reduce=reduce, **kw_j)
    got = tsp.spmm_edges(torch.from_numpy(x), torch.from_numpy(src),
                         torch.from_numpy(dst), 12, reduce=reduce, **kw_t)
    _close(got, ref)


def test_segment_ops_match_the_reference_and_drop_out_of_range_ids():
    from repro.sparse import segment as jseg

    rng = np.random.default_rng(5)
    data = rng.normal(size=(30, 4)).astype(np.float32)
    ids = rng.integers(-2, 9, 30).astype(np.int32)  # -2, -1, 7, 8 dropped
    _close(tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 7),
           jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 7))
    ok = (ids >= 0) & (ids < 7)
    logits, seg = data[ok, 0], ids[ok]
    _close(tsp.segment_softmax(torch.from_numpy(logits),
                               torch.from_numpy(seg), 9),
           jsp.segment_softmax(jnp.asarray(logits), jnp.asarray(seg), 9))
    _close(tseg.degree(torch.from_numpy(ids), 7),
           jseg.degree(jnp.asarray(ids), 7))


def test_segment_softmax_normalizes():
    logits = torch.tensor([1.0, 2.0, 3.0, 1.0, -1.0])
    seg = torch.tensor([0, 0, 0, 1, 1])
    out = tsp.segment_softmax(logits, seg, 2)
    sums = tsp.segment_sum(out, seg, 2)
    np.testing.assert_allclose(sums.numpy(), [1.0, 1.0], rtol=1e-6)


def test_spmm_edges_matches_matmul():
    rng = np.random.default_rng(1)
    n, e, d = 10, 40, 3
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    x = rng.normal(size=(n, d)).astype(np.float32)
    adj = np.zeros((n, n), np.float32)
    for s, t in zip(src, dst):
        adj[t, s] += 1.0
    out = tsp.spmm_edges(torch.from_numpy(x),
                         torch.from_numpy(src.astype(np.int32)),
                         torch.from_numpy(dst.astype(np.int32)), n)
    np.testing.assert_allclose(out.numpy(), adj @ x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_embedding_bag_matches_the_reference(combiner):
    rng = np.random.default_rng(0)
    sizes = (7, 13, 5)
    offs = tbag.table_offsets(sizes)
    np.testing.assert_array_equal(offs, jbag.table_offsets(sizes))
    assert offs.dtype == jbag.table_offsets(sizes).dtype
    table = rng.normal(size=(sum(sizes), 4)).astype(np.float32)
    ids = np.stack([rng.integers(0, s, size=(6, 2)) for s in sizes],
                   axis=1).astype(np.int32)
    flat_j = jbag.flatten_ids(jnp.asarray(ids), offs)
    flat_t = tbag.flatten_ids(torch.from_numpy(ids), offs)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    assert flat_t.dtype == torch.int32
    _close(tsp.embedding_bag(torch.from_numpy(table), flat_t,
                             combiner=combiner),
           jsp.embedding_bag(jnp.asarray(table), flat_j, combiner=combiner))
    with pytest.raises(ValueError):
        tsp.embedding_bag(torch.from_numpy(table), flat_t, combiner="min")


def test_embedding_bag_matches_dense():
    rng = np.random.default_rng(0)
    sizes = (7, 13, 5)
    offs = tbag.table_offsets(sizes)
    table = torch.from_numpy(rng.normal(size=(sum(sizes), 4)).astype(np.float32))
    ids = torch.from_numpy(np.stack(
        [rng.integers(0, s, size=(6, 2)) for s in sizes], axis=1
    ).astype(np.int32))
    out = tsp.embedding_bag(table, tbag.flatten_ids(ids, offs))
    flat = tbag.flatten_ids(ids, offs).numpy()
    expect = np.zeros((6, 3, 4), np.float32)
    for b in range(6):
        for f in range(3):
            for h in range(2):
                expect[b, f] += table.numpy()[flat[b, f, h]]
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-6)


# ----------------------------------------------------------------------
# sampler and pipelines
# ----------------------------------------------------------------------
def _same_subgraph(a, b):
    for f in ("node_ids", "edge_src", "edge_dst"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert a.seed_count == b.seed_count


@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_equals_the_reference_byte_for_byte(seed):
    gj, gt = jc.rmat(9, 8, seed=0), tc.rmat(9, 8, seed=0)
    aj, at = gj.adjacency_csr(), gt.adjacency_csr()
    seeds = np.arange(16) * 3
    _same_subgraph(
        tsampler.sample_neighbors(at.indptr, at.indices, seeds, (5, 3),
                                  np.random.default_rng(seed)),
        jsampler.sample_neighbors(aj.indptr, aj.indices, seeds, (5, 3),
                                  np.random.default_rng(seed)))


def test_neighbor_sampler_shapes_and_validity():
    g = tc.rmat(9, 8, seed=0)
    adj = g.adjacency_csr()
    rng = np.random.default_rng(0)
    sub = tsampler.sample_neighbors(adj.indptr, adj.indices, np.arange(16),
                                    (5, 3), rng)
    assert sub.n_nodes >= 16
    valid = sub.node_ids >= 0
    assert valid.sum() >= 16
    assert sub.edge_src.max() < valid.sum() + 1
    assert sub.edge_dst.max() < valid.sum() + 1


def _same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_token_pipeline_equals_the_reference_byte_for_byte():
    pj, pt = jpipe.TokenPipeline(1000, 4, 16, seed=3), \
        tpipe.TokenPipeline(1000, 4, 16, seed=3)
    for _ in range(3):
        _same_batch(pt.next_batch(), pj.next_batch())
    assert pt.state_dict() == pj.state_dict()


def test_token_pipeline_deterministic_replay():
    p1 = tpipe.TokenPipeline(1000, 4, 16, seed=3)
    b1 = p1.next_batch()
    st = p1.state_dict()
    b2 = p1.next_batch()
    p2 = tpipe.TokenPipeline(1000, 4, 16, seed=3)
    p2.load_state(st)
    b2r = p2.next_batch()
    np.testing.assert_array_equal(b2["tokens"], b2r["tokens"])
    assert not np.array_equal(b1["tokens"], b2["tokens"])


def test_recsys_pipeline_equals_the_reference_byte_for_byte():
    cfg = types.SimpleNamespace(n_dense=13, multi_hot=3,
                                table_sizes=(50, 7, 1000, 3))
    pj, pt = jpipe.RecsysPipeline(cfg, 8, seed=2), \
        tpipe.RecsysPipeline(cfg, 8, seed=2)
    for _ in range(3):
        _same_batch(pt.next_batch(), pj.next_batch())


def test_graph_pipeline_equals_the_reference_byte_for_byte():
    pj = jpipe.GraphPipeline(jc.rmat(9, 8, seed=0), 16, (5, 3), seed=4)
    pt = tpipe.GraphPipeline(tc.rmat(9, 8, seed=0), 16, (5, 3), seed=4)
    for _ in range(3):
        _same_subgraph(pt.next_batch(), pj.next_batch())


def test_prefetcher_keeps_order_and_ends():
    items = [{"i": np.full(3, i)} for i in range(25)]
    got = list(tpipe.Prefetcher(iter(items), depth=2))
    assert [int(b["i"][0]) for b in got] == list(range(25))


def test_batches_become_tensors_only_where_asked():
    batch = tpipe.TokenPipeline(100, 2, 8, seed=0).next_batch()
    assert all(isinstance(v, np.ndarray) for v in batch.values())
    t = tpipe.as_tensors(batch, "cpu")
    assert t["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(t["labels"].numpy(), batch["labels"])
    sub = tpipe.GraphPipeline(tc.rmat(8, 8, seed=0), 4, (2,), seed=0
                              ).next_batch()
    st = tpipe.as_tensors(sub, "cpu")
    assert set(st) == {"node_ids", "edge_src", "edge_dst"}
    assert st["node_ids"].dtype == torch.int64


def test_as_tensors_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.as_tensors({"x": np.zeros(2)})
