"""The port's configs of the GNN and recsys families, and DLRM, against
the JAX package's.

* Every GNN and recsys config (full and ``-smoke``) is field for field the
  reference's; ``ASSIGNED_ARCHS``, the registry and the shape sets are
  ``==``.
* DLRM on the reference's ``dlrm_init`` parameters, carried over: the
  interaction's pairs in ``jnp.triu_indices(F + 1, k=1)``'s row-major
  order, the features zero-padded to the top MLP's width (479 → 1024 at
  the published widths, 52 → 64 smoke), the table's rows padded to a
  multiple of 512; the forward, the loss (the reference's BCE formula op
  by op), one AdamW step, the serve and retrieval steps within ``TOL`` =
  1e-5 of ``1 + |b|`` (float32 sums in another order; seen ≤ 2e-7) or,
  for the step, ``chip_smoke.step_errs`` at ``chip_smoke.MODEL_STEP_TOL``
  (the bounds the card check uses); retrieval's ties break to the lower
  index as ``jax.lax.top_k``'s (a planted tie, ``==``).
* ``train --arch dlrm-mlperf-smoke`` prints the reference's ``main``'s
  lines, losses within ``CLI_TOL`` (both print four decimals, the port's
  init patched to the reference's parameters), and builds its
  ``--ckpt-dir`` manager without saving, as the reference's does.
* The specs: parameters, batches and ``recsys_input_specs`` for every
  shape ``==`` the reference's (meta tensors against ``ShapeDtypeStruct``s,
  full configs allocating nothing).
"""
import contextlib
import dataclasses
import functools
import io
import re
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfg
from repro import compat
from repro.launch import train as jtrain
from repro.models import dlrm as jdlrm
from repro.models import gnn_steps as jgs
import repro_torch.configs as tcfg
from repro_torch.data.pipeline import RecsysPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import gnn_steps as tgs

from test_torch_gnn import _leaves, chip_smoke

FAMILY_NAMES = [n for n in jcfg.base.list_configs()
                if jcfg.get_config(n).family in ("gnn", "recsys")]
SMOKE = "dlrm-mlperf-smoke"
CPU = torch.device("cpu")
TOL = 1e-5
CLI_TOL = 1.5e-4  # one unit in the fourth decimal of either, and rounding
LINE = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})$")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


def _err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


# ----------------------------------------------------------------------
# configs and the registry
# ----------------------------------------------------------------------
def test_registry_arch_list_and_shapes_equal_the_reference():
    assert tcfg.ASSIGNED_ARCHS == jcfg.ASSIGNED_ARCHS
    assert tcfg.list_configs() == jcfg.base.list_configs()
    assert tcfg.GNN_SHAPES == jcfg.GNN_SHAPES
    assert tcfg.RECSYS_SHAPES == jcfg.RECSYS_SHAPES
    assert tcfg.LM_ARCHS + tcfg.GNN_ARCHS == jcfg.ASSIGNED_ARCHS[:-1]
    assert len(FAMILY_NAMES) == 10


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_configs_equal_the_reference(name):
    mine, ref = tcfg.get_config(name), jcfg.get_config(name)
    assert type(mine).__name__ == type(ref).__name__
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.family == ref.family and mine.shapes == ref.shapes
    if ref.family == "recsys":
        assert mine.total_rows == ref.total_rows


# ----------------------------------------------------------------------
# DLRM against the reference
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def ref_params(name=SMOKE, table_sizes=None):
    """The reference's ``dlrm_init`` at key 0 (its tables resized to
    ``table_sizes`` where given), as numpy."""
    cfg = jcfg.get_config(name)
    if table_sizes is not None:
        cfg = dataclasses.replace(cfg, table_sizes=table_sizes)
    return jax.tree.map(np.asarray, jdlrm.dlrm_init(jax.random.key(0), cfg))


def _batch(cfg, b=16, seed=0):
    return RecsysPipeline(cfg, b, seed=seed).next_batch()


@pytest.mark.parametrize("name", ["dlrm-mlperf", SMOKE])
def test_meta_init_and_specs_equal_the_reference(name):
    cj, ct = jcfg.get_config(name), tcfg.get_config(name)
    ref = jax.eval_shape(lambda k: jdlrm.dlrm_init(k, cj), jax.random.key(0))
    mine = tdlrm.dlrm_init(None, ct, device="meta")
    assert ({p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
             for p, t in _leaves(mine).items()}
            == {p: (tuple(s.shape), np.dtype(s.dtype).name)
                for p, s in _leaves(ref).items()})
    rows = mine["emb"]["table"].shape[0]
    assert rows % 512 == 0 and rows - 512 < ct.total_rows <= rows
    assert rows == tdlrm.padded_rows(ct)
    as_tuples = lambda t: {p: tuple(s) for p, s in _leaves(t).items()}  # noqa: E731
    assert _leaves(tgs.dlrm_param_specs(mine)) == as_tuples(
        jgs.dlrm_param_specs(ref))
    _, jinfo = jgs.build_dlrm_train_step(cj, _mesh())
    _, info = tgs.build_dlrm_train_step(ct, device=CPU)
    assert _leaves(info["params"]) == as_tuples(jinfo["params"])
    opt = _leaves(info["opt"])
    assert opt["m/emb/table"] == opt["v/emb/table"] == (
        ("model", None) if rows > 4096 else (None, None))
    assert opt["m/top/l0/b"] == (None,)
    assert info["batch"] == {"dense": ("data", None),
                             "sparse_ids": ("data", None, None),
                             "labels": ("data",)}


@pytest.mark.parametrize("shape", list(jcfg.RECSYS_SHAPES))
@pytest.mark.parametrize("name", ["dlrm-mlperf", SMOKE])
def test_input_specs_equal_the_reference(name, shape):
    entry = jcfg.RECSYS_SHAPES[shape]
    ref = {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in
           jgs.recsys_input_specs(jcfg.get_config(name), entry).items()}
    mine = tgs.recsys_input_specs(tcfg.get_config(name), entry)
    assert all(t.device.type == "meta" for t in mine.values())
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in mine.items()} == ref


def test_interaction_pairs_are_the_upper_triangle_in_row_major_order():
    rng = np.random.default_rng(0)
    dense_v = rng.normal(size=(3, 4)).astype(np.float32)
    sparse_v = rng.normal(size=(3, 5, 4)).astype(np.float32)
    mine = tdlrm._interact_dot(torch.from_numpy(dense_v),
                               torch.from_numpy(sparse_v)).numpy()
    ref = np.asarray(jdlrm._interact_dot(jnp.asarray(dense_v),
                                         jnp.asarray(sparse_v)))
    assert mine.shape == ref.shape == (3, 4 + 15)
    assert _err(mine, ref) <= TOL
    all_v = np.concatenate([dense_v[:, None], sparse_v], axis=1)
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    want = np.stack([np.einsum("bd,bd->b", all_v[:, i], all_v[:, j])
                     for i, j in pairs], axis=1)
    np.testing.assert_allclose(mine[:, 4:], want, rtol=1e-5, atol=1e-6)
    assert pairs[:6] == [(0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (1, 2)]


@pytest.mark.parametrize("name,have,want", [("dlrm-mlperf", 479, 1024),
                                            (SMOKE, 52, 64)])
def test_forward_pads_features_to_the_top_width(name, have, want):
    """The published widths (every table cut to 4 rows so the CPU holds
    it): the padded forward against the reference's on its parameters."""
    cj = dataclasses.replace(jcfg.get_config(name),
                             table_sizes=(4,) * jcfg.get_config(name).n_sparse)
    ct = dataclasses.replace(tcfg.get_config(name), table_sizes=cj.table_sizes)
    params = ref_params(name, cj.table_sizes)
    batch = _batch(ct, 4)
    pads = []
    real_pad = torch.nn.functional.pad
    with mock.patch.object(tdlrm.F, "pad",
                           lambda x, p: pads.append((x.shape[1], p))
                           or real_pad(x, p)):
        with torch.no_grad():
            mine = tdlrm.dlrm_forward(convert.params_from_numpy(
                params, device=CPU), ct, torch.from_numpy(batch["dense"]),
                torch.from_numpy(batch["sparse_ids"]))
    assert pads == [(have, (0, want - have))]
    ref = jax.jit(lambda p, d, s: jdlrm.dlrm_forward(p, cj, d, s))(
        params, batch["dense"], batch["sparse_ids"])
    assert _err(mine, ref) <= TOL


@functools.lru_cache(maxsize=None)
def _ref_smoke():
    """The reference's loss, one train step, the serve step on its
    parameters and the stepped ones, all on one batch of 16."""
    cj = jcfg.get_config(SMOKE)
    batch = {k: jnp.asarray(v) for k, v in _batch(cj).items()}
    p = jax.tree.map(jnp.asarray, ref_params())
    fn, info = jgs.build_dlrm_train_step(cj, _mesh())
    srv, _ = jgs.build_dlrm_serve_step(cj, _mesh())
    logits = jax.jit(lambda q: jdlrm.dlrm_forward(
        q, cj, batch["dense"], batch["sparse_ids"]))(p)
    loss = jax.jit(lambda q: jdlrm.dlrm_loss(
        q, cj, batch["dense"], batch["sparse_ids"], batch["labels"])[0])(p)
    step = fn(p, info["opt_init"](p), batch, 0)
    probs = srv(step[0], batch["dense"], batch["sparse_ids"])
    return jax.tree.map(np.asarray, dict(logits=logits, loss=loss, step=step,
                                         probs=probs))


def _port_smoke():
    ct = tcfg.get_config(SMOKE)
    batch = _batch(ct)
    p = convert.params_from_numpy(ref_params(), device=CPU)
    fn, info = tgs.build_dlrm_train_step(ct, device=CPU)
    srv, _ = tgs.build_dlrm_serve_step(ct, device=CPU)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = tdlrm.dlrm_forward(p, ct, t["dense"], t["sparse_ids"])
        loss, metrics = tdlrm.dlrm_loss(p, ct, t["dense"], t["sparse_ids"],
                                        t["labels"])
    step = fn(p, info["opt_init"](p), batch, 0)
    probs = srv(step[0], batch["dense"], batch["sparse_ids"])
    return dict(logits=logits, loss=loss, metrics=metrics, step=step,
                probs=probs)


def test_forward_loss_step_and_serve_match_the_reference():
    ref, mine = _ref_smoke(), _port_smoke()
    assert _err(mine["logits"], ref["logits"]) <= TOL
    assert _err(mine["loss"], ref["loss"]) <= TOL
    assert mine["metrics"] == {"loss": mine["loss"]}
    errs, ok = chip_smoke.step_errs(mine["step"], ref["step"],
                                    chip_smoke.MODEL_STEP_TOL, lr_t=1e-3,
                                    step=0)
    assert ok, errs
    assert set(mine["step"][2]) == {"loss", "grad_norm"}
    assert _err(mine["probs"], ref["probs"]) <= TOL


def test_loss_is_the_references_formula_at_extreme_logits():
    """``max(x, 0) - x y + log1p(exp(-|x|))``: stable at |x| = 100, and
    its gradient at x = 0 splits ``maximum``'s tie as ``jnp`` does."""
    x = np.array([-100.0, -3.0, 0.0, 0.5, 100.0], np.float32)
    y = np.array([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)

    def ref(v):
        return jnp.mean(jnp.maximum(v, 0) - v * y
                        + jnp.log1p(jnp.exp(-jnp.abs(v))))

    xt = torch.from_numpy(x).requires_grad_(True)
    with mock.patch.object(tdlrm, "dlrm_forward", lambda *a: xt):
        loss, _ = tdlrm.dlrm_loss(None, None, None, None, torch.from_numpy(y))
    g, = torch.autograd.grad(loss, xt)
    assert _err(loss.detach(), ref(jnp.asarray(x))) <= TOL
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(ref)(
        jnp.asarray(x))), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("k", [100, 5])
def test_retrieval_matches_the_reference_with_a_planted_tie(k):
    """Candidates 3, 5 and 7 hold equal rows, so their scores tie; both
    packages rank the lower index first (at k = 5 the tie straddles the
    cut)."""
    cj, ct = jcfg.get_config(SMOKE), tcfg.get_config(SMOKE)
    params = jax.tree.map(np.copy, ref_params())
    q = np.asarray(jax.jit(lambda p, d: jdlrm.nn.mlp(p["bot"], d,
                                                     final_act=True))(
        params, _batch(cj)["dense"][:1]))[0]
    table = params["emb"]["table"]
    best = int(np.argmax(table[:40] @ q))
    table[[3, 5, 7]] = table[best]
    dense = _batch(cj)["dense"][:1]
    cand = np.arange(40, dtype=np.int32)
    vals, idx = jax.jit(lambda p, d, c: jdlrm.dlrm_retrieval(p, cj, d, c,
                                                             k=k))(
        params, dense, cand)
    ret, _ = tgs.build_dlrm_retrieval_step(ct, device=CPU)
    if k == 100:
        got = ret(convert.params_from_numpy(params, device=CPU), dense, cand)
    else:
        with torch.no_grad():
            got = tdlrm.dlrm_retrieval(
                convert.params_from_numpy(params, device=CPU), ct,
                torch.from_numpy(dense), torch.from_numpy(cand), k=k)
    assert got[1].dtype == torch.int32 and got[1].shape == (min(k, 40),)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(idx))
    assert _err(got[0], vals) <= TOL
    assert [i for i in got[1].tolist() if i in (3, 5, 7, best)][:3] == \
        sorted({3, 5, 7, best})[:3]
    row = chip_smoke.retrieval_errs(got[0], got[1],
                                    torch.from_numpy(table[cand] @ q))
    assert row["distinct"] and row["idx_equal"] == min(k, 40)
    assert row["err_rank"] <= TOL and row["err_values"] <= TOL


def test_dlrm_steps():
    """The twin of the reference's ``test_dlrm_steps``, on the port's own
    initialisation."""
    cfg = tcfg.get_config(SMOKE)
    rng = np.random.default_rng(0)
    params = tdlrm.dlrm_init(torch.Generator().manual_seed(0), cfg,
                             device=CPU)
    fn, info = tgs.build_dlrm_train_step(cfg, device=CPU)
    opt = info["opt_init"](params)
    b = 8
    batch = dict(
        dense=rng.normal(size=(b, 13)).astype(np.float32),
        sparse_ids=rng.integers(0, 10, (b, cfg.n_sparse, 1)).astype(np.int32),
        labels=rng.integers(0, 2, b).astype(np.float32),
    )
    p2, o2, m = fn(params, opt, batch, 0)
    assert np.isfinite(float(m["loss"]))
    srv, _ = tgs.build_dlrm_serve_step(cfg, device=CPU)
    probs = srv(p2, batch["dense"], batch["sparse_ids"])
    assert probs.shape == (b,) and bool((probs >= 0).all())
    ret, _ = tgs.build_dlrm_retrieval_step(cfg, device=CPU)
    vals, idx = ret(p2, batch["dense"][:1], np.arange(40, dtype=np.int32))
    assert idx.shape[0] == 40 or idx.shape[0] == 100


def test_steps_run_on_the_gpu_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.get_config(SMOKE)
    for build in (tgs.build_dlrm_train_step, tgs.build_dlrm_serve_step,
                  tgs.build_dlrm_retrieval_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(cfg)
    fn, _ = tgs.build_dlrm_train_step(cfg, device=CPU)
    with pytest.raises(ValueError, match="move them first"):
        fn(tdlrm.dlrm_init(None, cfg, device="meta"), None, {}, 0)


# ----------------------------------------------------------------------
# the train CLI
# ----------------------------------------------------------------------
CLI = ["--arch", SMOKE, "--batch", "4", "--steps", "20"]


def _port_cli(*args):
    out = io.StringIO()
    own = tdlrm.dlrm_init
    with mock.patch.object(tdlrm, "dlrm_init", lambda gen, cfg, device: (
            convert.params_from_numpy(ref_params(), device=device))), \
            contextlib.redirect_stdout(out):
        losses = ttrain.main([*CLI, "--device", "cpu", *args])
    assert tdlrm.dlrm_init is own
    return losses, out.getvalue().splitlines()


def _ref_cli(*args):
    out = io.StringIO()
    with mock.patch.object(sys, "argv", ["train", *CLI, *args]), \
            contextlib.redirect_stdout(out):
        jtrain.main()
    return out.getvalue().splitlines()


def _parsed(lines):
    return {int(m.group(1)): float(m.group(2))
            for m in map(LINE.match, lines) if m}


def test_cli_prints_the_references_losses(tmp_path):
    """On the reference's parameters (its ``main`` draws them from key 0,
    the port's ``main`` is patched to take them), the port's lines are
    the reference's, losses within ``CLI_TOL``.  Both build the
    ``--ckpt-dir`` manager and save nothing (copied, not repaired)."""
    mine, lines = _port_cli("--ckpt-dir", str(tmp_path / "port"))
    ref_lines = _ref_cli("--ckpt-dir", str(tmp_path / "ref"))
    assert all(LINE.match(ln) for ln in lines)
    assert all(LINE.match(ln) for ln in ref_lines)
    got, ref = _parsed(lines), _parsed(ref_lines)
    assert list(got) == list(ref) == [0, 5, 10, 15, 19]
    for step in ref:
        assert abs(got[step] - ref[step]) <= CLI_TOL, (step, got, ref)
        assert abs(mine[step] - ref[step]) <= CLI_TOL
    assert sorted(mine) == list(range(20))
    assert not (tmp_path / "port").exists()
    assert not (tmp_path / "ref").exists()
