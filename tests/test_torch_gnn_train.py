"""The port's GNN train step, its loop and the ``train_gnn`` example
against the JAX package's, and the twins of the reference's GNN smoke
tests (``tests/test_arch_smoke.py``).

* One AdamW step (lr 5e-3, no weight decay) of each smoke config on the
  reference's parameters, carried over, and its test batch: the port's
  ``build_gnn_train_step`` against the reference's (jitted, as it builds
  it), held by ``chip_smoke.step_errs`` at the float32 bounds the card
  check uses too (``chip_smoke.MODEL_STEP_TOL``: the loss and
  ``grad_norm`` 1e-5 of ``1 + |b|``, each state leaf 1e-4 of its norm,
  the parameters 1e-5 elementwise but for AdamW's sign flips, which
  ``step_errs`` explains).  NequIP's step differentiates its force loss
  twice.
* GAT-smoke's loss over 10 steps on carried weights against the
  reference's, each within 1e-5 of ``1 + |b|``.
* The twins, on the port's own initialisation: every smoke config's step
  is finite; GAT's loss falls below 0.8x in 120 steps; NequIP's and
  Equiformer-v2's energies are invariant and NequIP's forces equivariant
  under a scipy rotation within the reference's bounds
  (``chip_smoke.equivariance_checks``, which the card runs too).
* ``repro_torch.examples.train_gnn``: 200 steps of the full ``gat-cora``
  config on the seeded SBM graph reach held-out accuracy over 0.7, with
  its checkpoints.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfg
from repro import compat
from repro.models import gnn_steps as jgs
import repro_torch.configs as tcfg
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.models import convert
from repro_torch.models import gnn_steps as tgs
from repro_torch.optim._tree import tree_leaves

from test_torch_gnn import chip_smoke, port_batch, ref_batch, smoke_case

ARCHS = list(tcfg.GNN_ARCHS)
CPU = torch.device("cpu")
CURVE_STEPS = 10
CURVE_TOL = 1e-5


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


@functools.lru_cache(maxsize=None)
def _ref_step(name, steps=1):
    """The reference's jitted train step from a fresh AdamW state,
    ``steps`` times on the smoke batch: the last ``(params, opt, metrics)``
    as numpy, and each step's loss."""
    cj, _, batch, d_feat, params = smoke_case(name)
    b = ref_batch(batch)
    build, info = jgs.build_gnn_train_step(cj, _mesh(), d_feat)
    fn = build(jax.eval_shape(lambda: b))
    p = jax.tree.map(jnp.asarray, params)
    o = info["opt_init"](p)
    losses = []
    for i in range(steps):
        p, o, m = fn(p, o, b, i)
        losses.append(float(m["loss"]))
    return jax.tree.map(np.asarray, (p, o, m)), losses


def _port_step(name, steps=1):
    _, ct, batch, d_feat, params = smoke_case(name)
    b = port_batch(batch)
    build, info = tgs.build_gnn_train_step(ct, None, d_feat, device=CPU)
    fn = build(b)
    p = convert.params_from_numpy(params, device=CPU)
    o = info["opt_init"](p)
    losses = []
    for i in range(steps):
        p, o, m = fn(p, o, b, i)
        losses.append(float(m["loss"]))
    return (p, o, m), losses


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_the_reference(name):
    ref, _ = _ref_step(name)
    got, _ = _port_step(name)
    errs, ok = chip_smoke.step_errs(got, ref, chip_smoke.MODEL_STEP_TOL,
                                    lr_t=5e-3, step=0)
    assert ok, errs
    assert set(got[2]) == {"loss", "grad_norm"}


def test_gat_curve_matches_the_reference():
    _, ref = _ref_step("gat-cora", CURVE_STEPS)
    _, mine = _port_step("gat-cora", CURVE_STEPS)
    errs = [abs(a - b) / (1 + abs(b)) for a, b in zip(mine, ref)]
    assert max(errs) <= CURVE_TOL, errs
    assert mine[-1] < mine[0]


def test_planted_dropped_forces_are_caught():
    """The check the card runs catches NequIP's force term dropped from
    the loss (only the energy term's gradient left)."""
    ref, _ = _ref_step("nequip")
    with chip_smoke._planted_dropped_forces():
        got, _ = _port_step("nequip")
    errs, ok = chip_smoke.step_errs(got, ref, chip_smoke.MODEL_STEP_TOL,
                                    lr_t=5e-3, step=0)
    assert not ok
    # the smoke batch's forces are small (a loss of 7.6e-5): the gradients
    # and so the moments show the dropped term
    assert errs["states"] > chip_smoke.MODEL_STEP_TOL["states"]


# ----------------------------------------------------------------------
# twins of tests/test_arch_smoke.py
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_gnn_train_step(name):
    cfg = tcfg.get_config(name + "-smoke")
    batch, d_feat = chip_smoke.gnn_smoke_batch(cfg, np.random.default_rng(3))
    b = port_batch(batch)
    params = tgs.gnn_init(torch.Generator().manual_seed(0), cfg, d_feat,
                          device=CPU)
    build, info = tgs.build_gnn_train_step(cfg, None, d_feat, device=CPU)
    p2, _, m = build(b)(params, info["opt_init"](params), b, 0)
    assert np.isfinite(float(m["loss"]))
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(p2), tree_leaves(params)))


def test_gnn_training_reduces_loss():
    """GAT learns a separable synthetic task in 120 steps."""
    cfg = tcfg.get_config("gat-cora-smoke")
    rng = np.random.default_rng(0)
    n, e, d = 60, 240, 8
    labels = rng.integers(0, cfg.d_out, n)
    feats = 0.1 * rng.normal(size=(n, d))
    feats[:, : cfg.d_out] += 4.0 * np.eye(cfg.d_out)[labels]
    # self-loops (standard Cora preprocessing) so nodes see their features
    src = np.concatenate([rng.integers(0, n, e), np.arange(n)])
    dst = np.concatenate([rng.integers(0, n, e), np.arange(n)])
    batch = port_batch(dict(
        feats=feats.astype(np.float32), edge_src=src.astype(np.int32),
        edge_dst=dst.astype(np.int32), labels=labels.astype(np.int32),
        label_mask=np.ones(n, np.float32)))
    params = tgs.gnn_init(torch.Generator().manual_seed(0), cfg, d,
                          device=CPU)
    build, info = tgs.build_gnn_train_step(cfg, None, d, device=CPU)
    fn = build(batch)
    opt = info["opt_init"](params)
    with torch.no_grad():
        loss0 = float(tgs.gnn_loss(params, cfg, batch)[0])
    for i in range(120):
        params, opt, m = fn(params, opt, batch, i)
    loss1 = float(m["loss"])
    assert loss1 < loss0 * 0.8, (loss0, loss1)


@functools.lru_cache(maxsize=None)
def _equivariance():
    return chip_smoke.equivariance_checks(CPU)


def test_equivariance_energy_invariance():
    row, _ = _equivariance()
    for key in ("nequip_energy", "equiformer_energy"):
        assert row[key]["ok"], row[key]
        assert row[key]["diff"] < row[key]["bound"]


def test_nequip_forces_are_equivariant():
    row, ok = _equivariance()
    assert row["nequip_forces"]["ok"] and ok, row["nequip_forces"]


def test_train_gnn_example_learns(tmp_path, capsys):
    from repro_torch.examples import train_gnn

    res = train_gnn.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert res["accuracy"] > 0.7 and res["loss"] < res["loss0"]
    assert [ln.split()[1] for ln in out if ln.startswith("step")] == [
        "0", "50", "100", "150"]
    assert out[-1] == "ok ✓"
    assert tckpt.latest_step(str(tmp_path)) == 150  # keep=2: 100 and 150
    assert len(list(tmp_path.glob("*.npz"))) == 2


def test_train_gnn_example_runs_on_the_gpu_unless_told_otherwise(monkeypatch):
    from repro_torch.examples import train_gnn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_gnn.main([])
