"""The inputs of the model cells that the dry run fits on one card, as
``chip_smoke.py``'s ``fit_cells_path`` builds them, against the JAX
package.

* Each of the 11 cells whose walk fits 80 GB: ``chip_smoke.gnn_cell_batch``
  (the ten GNN cells; ``minibatch_lg`` over a 5,000-node host graph at
  degree 20 with the cell's own 1,024 x (15, 10) draw) and
  ``chip_smoke.decode_cell_inputs`` (qwen2-0.5b ``decode_32k``, on
  ``meta``) give every key the shape and dtype of the reference's input
  specs (``gnn_input_specs``, ``lm_input_specs(step="decode")``).
* The host graph (``sampled_host_graph``: distinct neighbours, no loop,
  every slot) and the sampled batch (endpoints below the padded node
  count, padding edges on a padding node, every real edge an edge of the
  host graph, ``label_mask`` exactly the seeds).
* GAT-smoke's and NequIP-smoke's train steps on a small sampled batch (8
  seeds, fanout (3, 2)) in both packages, held by ``chip_smoke.step_errs``
  at ``chip_smoke.MODEL_STEP_TOL``, the GNN parity tests' bounds.
* qwen2-0.5b-smoke's decode step with per-row ``cache_len`` and junk
  (``±chip_smoke.FIT_JUNK``) past it: the reference's within the LM model
  tests' tolerances (float32 1e-4; bfloat16 2**-5 for logits, 2**-4 for
  caches), bitwise itself with the junk zeroed, and the planted
  longest-row mask past ``chip_smoke.LM_FULL_CPU_TOL``.
"""
import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfg
from repro import compat
from repro.models import gnn_steps as jgs
from repro.models import steps as jsteps
from repro.models import transformer as jtr
import repro_torch.configs as tcfg
from repro_torch.data.pipeline import GraphPipeline
from repro_torch.models import convert
from repro_torch.models import gnn_steps as tgs
from repro_torch.models import transformer as ttr

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CPU = torch.device("cpu")
# the ten GNN cells of the dry run's walks that fit 80 GB (its eleventh
# is qwen2-0.5b's decode_32k)
GNN_FIT = [("gat-cora", "molecule"), ("gat-cora", "full_graph_sm"),
           ("gat-cora", "minibatch_lg"), ("graphcast", "molecule"),
           ("graphcast", "full_graph_sm"), ("nequip", "molecule"),
           ("nequip", "full_graph_sm"), ("nequip", "minibatch_lg"),
           ("equiformer-v2", "molecule"), ("equiformer-v2", "full_graph_sm")]
SMALL_GRAPH = (5000, 100_000)  # nodes, neighbour slots: degree 20
SAMPLED_SMOKE = dict(kind="sampled", n_nodes=200, n_edges=2000,
                     batch_nodes=8, fanout=(3, 2), d_feat=16)
DECODE_SMOKE = dict(kind="decode", seq_len=32, global_batch=4)
TOL = {"float32": 1e-4, "bfloat16": 2 ** -4}  # caches
TOL_LOGITS = {"float32": 1e-4, "bfloat16": 2 ** -5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def small_graph():
    return chip_smoke.sampled_host_graph(*SMALL_GRAPH,
                                         np.random.default_rng(0))


def _small(shape):
    """``shape`` with a sampled cell's host graph cut to ``SMALL_GRAPH``
    (its input specs depend on the seeds and fanout only)."""
    if shape["kind"] != "sampled":
        return shape
    return dict(shape, n_nodes=SMALL_GRAPH[0], n_edges=SMALL_GRAPH[1])


def _batch(name, shape, seed=0, graph=None):
    cfg = tcfg.get_config(name)
    facts = {}
    if shape["kind"] == "sampled" and graph is None:
        graph = small_graph()
    b, d_feat = chip_smoke.gnn_cell_batch(cfg, shape,
                                          np.random.default_rng(seed),
                                          graph=graph, facts=facts)
    return b, d_feat, facts


def _dtype_name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _assert_specs(got, want):
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        if isinstance(spec, dict):
            _assert_specs(got[k], spec)
            continue
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert _dtype_name(got[k].dtype) == _dtype_name(spec.dtype), k


@pytest.mark.parametrize("name,shape_name", GNN_FIT,
                         ids=[f"{n}-{s}" for n, s in GNN_FIT])
def test_cell_batch_has_the_references_specs(name, shape_name):
    shape = tcfg.GNN_SHAPES[shape_name]
    want = jgs.gnn_input_specs(jcfg.get_config(name), shape)
    b, d_feat, facts = _batch(name, _small(shape))
    _assert_specs(b, want)
    assert jgs.gnn_input_specs(jcfg.get_config(name), _small(shape)) == want
    assert d_feat == tgs.gnn_feat_dim(tcfg.get_config(name), shape)
    n_pad = b["species" if "species" in b else "feats"].shape[0]
    assert 0 < facts["nodes"] <= n_pad
    assert 0 < facts["edges"] <= b["edge_src"].shape[0]
    if "positions" in b:  # most edges inside the 5 Å cutoff
        assert facts["within_cutoff"] > 0.7


def test_decode_inputs_have_the_references_specs():
    shape = tcfg.LM_SHAPES["decode_32k"]
    cfg = tcfg.get_config("qwen2-0.5b")
    got = chip_smoke.decode_cell_inputs(cfg, shape, "meta")
    want = jsteps.lm_input_specs(jcfg.get_config("qwen2-0.5b"), shape,
                                 step="decode")
    _assert_specs(got, want)
    assert got["cache"]["k"].shape == (24, 128, 32768, 2, 64)
    lens = chip_smoke.decode_cell_lens(128, 32768)
    assert lens[0] == 32767 and lens[-1] == 16384
    assert (np.diff(lens) <= 0).all()


@pytest.mark.parametrize("n,slots", [(5000, 100_000), (1000, 12_345),
                                     (50, 2400)])
def test_host_graph_has_distinct_neighbours_and_every_slot(n, slots):
    g = chip_smoke.sampled_host_graph(n, slots, np.random.default_rng(1))
    assert g.n == n and g.adjacency_csr() is g
    assert g.indptr[0] == 0 and g.indptr[-1] == slots == g.indices.size
    deg = np.diff(g.indptr)
    assert set(deg.tolist()) <= {slots // n, slots // n + 1}
    assert ((g.indices >= 0) & (g.indices < n)).all()
    for v in range(0, n, max(1, n // 97)):
        nbrs = g.indices[g.indptr[v]:g.indptr[v + 1]]
        assert np.unique(nbrs).size == nbrs.size and v not in nbrs


@pytest.mark.parametrize("name", ["gat-cora", "nequip"])
def test_sampled_batch_invariants(name):
    """The full 1,024 x (15, 10) draw over the small graph: the real nodes
    and edges first, padding edges loops on the first padding node, no
    real loop, GAT's mask exactly the seeds — the destinations of the
    first hop, which takes 15 edges a seed (every degree is 20)."""
    shape = _small(tcfg.GNN_SHAPES["minibatch_lg"])
    b, _, facts = _batch(name, shape)
    n, e = facts["nodes"], facts["edges"]
    n_pad = b["label_mask" if name == "gat-cora" else "graph_id"].shape[0]
    src, dst = b["edge_src"], b["edge_dst"]
    assert n_pad == 170_496 and src.shape == (169_472,)
    assert ((src >= 0) & (src < n_pad)).all()
    assert ((dst >= 0) & (dst < n_pad)).all()
    assert n < n_pad and e <= src.size
    assert (src[e:] == n).all() and (dst[e:] == n).all()
    assert (src[:e] < n).all() and (dst[:e] < n).all()
    assert (src[:e] != dst[:e]).all()
    seeds = np.unique(dst[:1024 * 15])
    assert seeds.size == 1024
    if name == "gat-cora":
        assert np.array_equal(np.flatnonzero(b["label_mask"]), seeds)
        assert (b["feats"][n:] == 0).all()
    else:
        assert (b["graph_id"][:n] == 0).all() and (b["graph_id"][n:] == 1).all()
        assert (b["positions"][n:] == 0).all() and b["energy"].shape == (1,)


def test_sampled_edges_are_edges_of_the_host_graph():
    """``sampled_edges`` draws what ``GraphPipeline.next_batch`` draws
    with the same seed: each real edge runs from a neighbour of its
    destination, and its seeds are the pipeline's."""
    g = small_graph()
    shape = _small(tcfg.GNN_SHAPES["minibatch_lg"])
    src, dst, n, e, seed_rows = chip_smoke.sampled_edges(
        shape, g, 170_496, 169_472, seed=7)
    sub = GraphPipeline(g, 1024, (15, 10), seed=7).next_batch()
    ids = sub.node_ids[:n]
    assert np.array_equal(sub.edge_src[:e], src[:e])
    assert np.array_equal(np.unique(dst[:1024 * 15]), np.sort(seed_rows))
    assert np.array_equal(ids[seed_rows], sub.seeds)
    for s, d in zip(ids[src[:e]][::37], ids[dst[:e]][::37]):
        assert s in g.indices[g.indptr[d]:g.indptr[d + 1]]


def test_the_sampler_returns_its_seeds():
    """``sample_neighbors`` hands back the seeds it drew from, in their
    order: the first hop's destinations, a block of 3 edges a seed."""
    from repro_torch.sparse.sampler import sample_neighbors

    g = small_graph()
    seeds = np.random.default_rng(3).choice(g.n, 16, replace=False)
    sub = sample_neighbors(g.indptr, g.indices, seeds, (3, 2),
                           np.random.default_rng(4))
    assert np.array_equal(sub.seeds, seeds)
    first = sub.node_ids[sub.edge_dst[:16 * 3:3]]
    assert np.array_equal(first, seeds)


def _mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("name", ["gat-cora", "nequip"])
def test_sampled_train_step_matches_the_reference(name):
    """One AdamW step of the smoke config on a sampled batch from the
    reference's parameters: the port's ``build_gnn_train_step`` against
    the reference's, jitted."""
    cj = jcfg.get_config(name + "-smoke")
    ct = tcfg.get_config(name + "-smoke")
    graph = chip_smoke.sampled_host_graph(
        SAMPLED_SMOKE["n_nodes"], SAMPLED_SMOKE["n_edges"],
        np.random.default_rng(0))
    batch, d_feat, _ = _batch(name + "-smoke", SAMPLED_SMOKE, seed=3,
                              graph=graph)
    params = jax.tree.map(np.asarray, jgs.gnn_init(jax.random.key(0), cj,
                                                   d_feat))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    build, info = jgs.build_gnn_train_step(cj, _mesh(), d_feat)
    p = jax.tree.map(jnp.asarray, params)
    ref = jax.tree.map(np.asarray, build(jax.eval_shape(lambda: b))(
        p, info["opt_init"](p), b, 0))
    got = chip_smoke.gnn_train_once(
        ct, convert.params_from_numpy(params, device=CPU),
        {k: torch.from_numpy(v) for k, v in batch.items()}, CPU, d_feat)
    errs, ok = chip_smoke.step_errs(got, ref, chip_smoke.MODEL_STEP_TOL,
                                    lr_t=5e-3, step=0)
    assert ok, errs


def _decode_cfgs(dtype):
    name = "qwen2-0.5b-smoke"
    return (dataclasses.replace(jcfg.get_config(name), dtype=dtype),
            dataclasses.replace(tcfg.get_config(name), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _decode_params(dtype):
    cj, _ = _decode_cfgs("float32")
    p = jax.jit(lambda k: jtr.lm_init(k, cj))(jax.random.key(0))
    return jax.tree.map(lambda a: np.asarray(a.astype(dtype)), p)


def _port_decode(dtype, inputs, planted=False):
    _, ct = _decode_cfgs(dtype)
    params = convert.params_from_numpy(_decode_params(dtype), device=CPU)
    cache = {k: v.clone() for k, v in inputs["cache"].items()}
    with torch.no_grad():
        if planted:
            with chip_smoke._planted_longest_row():
                return ttr.lm_decode_step(params, ct, inputs["token"], cache,
                                          inputs["cache_len"])
        return ttr.lm_decode_step(params, ct, inputs["token"], cache,
                                  inputs["cache_len"])


def _inputs(dtype):
    _, ct = _decode_cfgs(dtype)
    return chip_smoke.decode_cell_inputs(ct, DECODE_SMOKE, "cpu", seed=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_with_junk_matches_the_reference(dtype):
    cj, _ = _decode_cfgs(dtype)
    inputs = _inputs(dtype)
    lens = inputs["cache_len"].numpy()
    for row, n in enumerate(lens):  # the junk is there, past each length
        assert (inputs["cache"]["k"][:, row, n:].abs() == 64).all()
    decode = jax.jit(lambda p, t, c, n: jtr.lm_decode_step(p, cj, t, c, n))
    cache = {k: jnp.asarray(v.float().numpy()).astype(dtype)
             for k, v in inputs["cache"].items()}
    r_tok, r_logits, r_cache = decode(
        jax.tree.map(jnp.asarray, _decode_params(dtype)),
        jnp.asarray(inputs["token"].numpy()), cache, jnp.asarray(lens))
    tok, logits, mine = _port_decode(dtype, inputs)
    assert chip_smoke.lm_err(logits, np.asarray(r_logits)) <= TOL_LOGITS[dtype]
    for k, v in r_cache.items():
        assert chip_smoke.lm_err(mine[k], np.asarray(v, np.float32)) <= TOL[
            dtype], k
    # rows whose margin no difference as small as the one seen can swap
    decided = chip_smoke._lm_margin_decided(
        torch.from_numpy(np.array(r_logits)), logits).numpy()
    assert decided.any()
    assert np.array_equal(tok.numpy()[decided], np.asarray(r_tok)[decided])


def test_decode_reads_no_junk():
    """Bit for bit the same step with every slot past each row's length
    zeroed: the mask leaves the junk out exactly."""
    inputs = _inputs("bfloat16")
    zeroed = dict(inputs, cache={k: v.clone()
                                 for k, v in inputs["cache"].items()})
    for c in zeroed["cache"].values():
        for row, n in enumerate(inputs["cache_len"].tolist()):
            c[:, row, n:] = 0
    tok, logits, cache = _port_decode("bfloat16", inputs)
    tok0, logits0, cache0 = _port_decode("bfloat16", zeroed)
    assert torch.equal(logits, logits0) and torch.equal(tok, tok0)
    at = torch.arange(DECODE_SMOKE["global_batch"])
    lens = inputs["cache_len"].long()
    for k in cache:
        assert torch.equal(cache[k][:, at, lens], cache0[k][:, at, lens])


def test_planted_longest_row_fault_is_caught():
    """Every row's length taken as the longest row's: the shorter rows
    read junk, and their logits move past ``LM_FULL_CPU_TOL``; the
    longest row's do not move."""
    inputs = _inputs("bfloat16")
    _, logits, _ = _port_decode("bfloat16", inputs)
    _, planted, _ = _port_decode("bfloat16", inputs, planted=True)
    assert torch.equal(planted[0], logits[0])
    assert chip_smoke.lm_err(planted[-1:], logits[-1:]) > \
        chip_smoke.LM_FULL_CPU_TOL


def test_rope_frequencies_are_rounded_once_from_float64():
    """``rope_angles`` takes ``theta ** (2i / dim)`` in float64 and rounds
    it once (the same float32 frequencies on every device), else the
    reference's float32 formula; on the CPU that is the float32 ``pow``'s
    own value but for at most one frequency in these.  The frequencies
    are made once a device, so a call adds no work for them."""
    from repro_torch.models.attention import _rope_inv, rope_angles

    for dim, theta in ((16, 10000.0), (64, 1e6), (128, 1e6), (12, 5e5)):
        exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
        want = 1.0 / (theta ** exps.double()).float()
        got = rope_angles(torch.ones(1, dtype=torch.int32), dim, theta)[0]
        assert torch.equal(got, want)
        assert int((got != 1.0 / theta ** exps).sum()) <= 1
        pos = torch.tensor([32767])
        assert torch.equal(rope_angles(pos, dim, theta)[0], 32767.0 * want)
        cpu = torch.device("cpu")
        assert _rope_inv(dim, theta, cpu) is _rope_inv(dim, theta, cpu)


def _adamw_step(p0, g, lr=5e-3):
    """``(params, opt_state)`` of AdamW's first step (no weight decay) from
    ``p0`` on gradient ``g``, in float32, as ``adamw_update`` takes it."""
    m, v = 0.1 * g, 0.05 * g * g
    u = (m / 0.1) / ((v / 0.05).sqrt() + 1e-8)
    return {"w": p0 - lr * u}, {"m": {"w": m}, "v": {"w": v}}


def test_step_errs_holds_a_flipped_noise_gradient_to_its_update():
    """A gradient of rounding noise (|g| far under ``STEP_NEAR_EPS``) that
    flips its sign and rounds larger on the card moves its parameter by
    the two updates' difference, past the flip's bound: held as ``near``.
    A parameter that moved otherwise still fails."""
    p0 = torch.full((4,), 0.5)
    g_ref = torch.tensor([1e-3, -2e-3, 1e-11, 3e-4])
    g_got = torch.tensor([1e-3, -2e-3, -8e-11, 3e-4])
    tol = chip_smoke.MODEL_STEP_TOL
    metrics = {"loss": torch.tensor(1.0)}
    ref = (*_adamw_step(p0, g_ref), metrics)
    got = (*_adamw_step(p0, g_got), metrics)
    errs, ok = chip_smoke.step_errs(got, ref, tol, lr_t=5e-3)
    assert ok and errs["flips"] == 1 and errs["near"] == 1, errs
    assert errs["near_flipped"] == 1
    p, o, _ = got
    moved = ({"w": p["w"] + torch.tensor([0.0, 0.0, 0.0, 1e-3])}, o, metrics)
    errs, ok = chip_smoke.step_errs(moved, ref, tol, lr_t=5e-3)
    assert not ok and errs["params"] > tol["params"]
    assert errs["worst"]["leaf"] == 0 and not errs["worst"]["flipped"]


def test_step_errs_fails_a_flip_whose_gradient_is_not_noise_on_both_sides():
    """A flipped element is held to the two updates' difference only where
    both sides' gradients are rounding noise: a reference gradient of
    noise against a card gradient over ``STEP_NEAR_EPS`` still fails."""
    p0 = torch.full((4,), 0.5)
    g_ref = torch.tensor([1e-3, -2e-3, 1e-11, 3e-4])
    g_got = torch.tensor([1e-3, -2e-3, -8e-6, 3e-4])
    metrics = {"loss": torch.tensor(1.0)}
    ref = (*_adamw_step(p0, g_ref), metrics)
    got = (*_adamw_step(p0, g_got), metrics)
    errs, ok = chip_smoke.step_errs(got, ref, chip_smoke.MODEL_STEP_TOL,
                                    lr_t=5e-3)
    assert not ok and errs["flips"] == 1 and errs["near_flipped"] == 0
    assert errs["worst"]["leaf"] == 0 and errs["worst"]["flipped"]
