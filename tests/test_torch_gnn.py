"""The port's GNN models and irreps machinery against the JAX package's.

* The irreps host constants (Clebsch-Gordan up to l = 6, the SH norms,
  the so(3) generators, the Schur pairing ``Q`` and its pairs, ``J``) are
  the reference's byte for byte: the same float64 numpy and scipy calls
  in the same order on one machine.
* ``sph_harm``, ``RotationBasis.z_rot`` / ``y_rot`` agree within 1e-6
  (float32 products of unit-norm blocks, d ≤ 13 terms a sum);
  ``align_z`` within ``ALIGN_TOL`` = 4e-6: its angle ``arccos(z)`` differs
  by one float32 unit (2.4e-7) between the two libraries on some inputs,
  and ``D_l`` moves by up to ``m · |dθ|`` with m ≤ 6 (the same angles give
  ≤ 1.8e-7).
* Each smoke config's forward, loss and parameter gradients (GAT,
  GraphCast, NequIP with its forces, Equiformer-v2) on the reference's
  ``gnn_init`` parameters, carried over: ``FWD_TOL`` = 1e-5 of ``1 + |b|``
  elementwise (float32 sums in another order; seen ≤ 3e-7), gradients
  ``GRAD_TOL`` = 1e-5 of each leaf's largest entry (seen ≤ 1e-6).
  NequIP's loss on forces is second order: its gradient goes through
  ``-∂E/∂positions``.
* ``segment_max``'s gradient (``scatter_reduce_("amax")``) against
  ``jax.grad`` of ``jax.ops.segment_max``: ties share the gradient evenly
  in both, an empty segment passes none.
* The init quirks copied from the reference (one key for every
  ``self/l{l}`` and ``post/l{l}`` of a NequIP layer, every ``post/l{l}``
  of an Equiformer layer: equal matrices), the carry-over of every
  family's tree, the meta inits against ``jax.eval_shape``, and
  ``gnn_input_specs`` for every arch and shape.

The reference runs under ``jax.jit`` (its eager dispatch of the
equivariant models takes tens of seconds).
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfg
from repro.models import gnn_steps as jgs
from repro.models.gnn import irreps as jirr
from repro.models.gnn import nequip as jneq
from repro.sparse import segment as jseg
import repro_torch.configs as tcfg
from repro_torch.models import convert
from repro_torch.models import gnn_steps as tgs
from repro_torch.models.gnn import irreps as tirr
from repro_torch.models.gnn import nequip as tneq
from repro_torch.optim._tree import tree_leaves
from repro_torch.sparse import segment as tseg

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCHS = list(tcfg.GNN_ARCHS)
NAMES = ARCHS + [a + "-smoke" for a in ARCHS]
CPU = torch.device("cpu")
L_MAX = 6
ROT_TOL = 1e-6
ALIGN_TOL = 4e-6
FWD_TOL = 1e-5
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


@functools.lru_cache(maxsize=None)
def smoke_case(name):
    """``(cfg_ref, cfg_port, batch (numpy), d_feat, params (numpy, the
    reference's gnn_init at key 0))`` of ``name``'s smoke config on
    ``chip_smoke.gnn_smoke_batch`` (the reference's test batch, seed 3)."""
    cj, ct = jcfg.get_config(name + "-smoke"), tcfg.get_config(name + "-smoke")
    batch, d_feat = chip_smoke.gnn_smoke_batch(ct, np.random.default_rng(3))
    params = jax.tree.map(np.asarray,
                          jgs.gnn_init(jax.random.key(0), cj, d_feat))
    return cj, ct, batch, d_feat, params


def ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


# ----------------------------------------------------------------------
# irreps
# ----------------------------------------------------------------------
def test_clebsch_gordan_and_sh_norms_are_byte_equal():
    for l1 in range(L_MAX + 1):
        for l2 in range(L_MAX + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, L_MAX) + 1):
                mine = tirr.clebsch_gordan(l1, l2, l3)
                ref = jirr.clebsch_gordan(l1, l2, l3)
                assert mine.dtype == ref.dtype == np.float64
                assert mine.tobytes() == ref.tobytes(), (l1, l2, l3)
    assert tirr._sh_norms(L_MAX) == jirr._sh_norms(L_MAX)
    assert tirr.tp_paths([0, 1, 2], 2, 2) == jirr.tp_paths([0, 1, 2], 2, 2)
    for c in [(1, 0, 1, 0, 1, 0), (2, 1, 1, -1, 2, 0), (3, 2, 2, -1, 4, 1)]:
        assert tirr._cg_complex_coeff(*c) == jirr._cg_complex_coeff(*c)


@pytest.mark.parametrize("l", range(L_MAX + 1))
def test_rotation_constants_are_byte_equal(l):
    for axis in range(3):
        assert (tirr._generator(l, axis).tobytes()
                == jirr._generator(l, axis).tobytes())
    q, pairs = tirr._z_pairing(l)
    q_ref, pairs_ref = jirr._z_pairing(l)
    assert q.tobytes() == q_ref.tobytes() and pairs == pairs_ref
    assert tirr._j_matrix(l).tobytes() == jirr._j_matrix(l).tobytes()
    pts = np.random.default_rng(l).normal(size=(5, 3))
    assert tirr._sh_numpy(l, pts).tobytes() == jirr._sh_numpy(l,
                                                              pts).tobytes()


def _unit_vectors(n=64, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[0] = [0, 0, 1]  # the poles: arccos's ends, atan2(0, 0)
    v[1] = [0, 0, -1]
    return v


@pytest.mark.parametrize("l_max", [0, 1, 2, L_MAX])
def test_sph_harm_matches_the_reference(l_max):
    v = _unit_vectors()
    mine = tirr.sph_harm(l_max, torch.from_numpy(v)).numpy()
    ref = np.asarray(jirr.sph_harm(l_max, v))
    # Y_1 is always there (the reference's l_max 0 gives 4 columns too)
    assert mine.shape == ref.shape == (64, (max(l_max, 1) + 1) ** 2)
    assert np.abs(mine - ref).max() <= ROT_TOL


ANGLES = np.linspace(-np.pi, np.pi, 64).astype(np.float32)


@functools.lru_cache(maxsize=None)
def ref_rotations():
    """The reference's ``z_rot`` / ``y_rot`` of ``ANGLES`` and ``align_z``
    of ``_unit_vectors()`` for every l, in one jitted call."""
    ref = jirr.RotationBasis(L_MAX)

    def run(ang, v):
        return {fn: [getattr(ref, fn)(l, x) for l in range(L_MAX + 1)]
                for fn, x in (("z_rot", ang), ("y_rot", ang),
                              ("align_z", v))}

    out = jax.jit(run)(jnp.asarray(ANGLES), jnp.asarray(_unit_vectors()))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("l", range(L_MAX + 1))
def test_rotation_basis_matches_the_reference(l):
    v = _unit_vectors()
    mine, ref = tirr.RotationBasis(L_MAX, device=CPU), ref_rotations()
    t = torch.from_numpy
    for fn in ("z_rot", "y_rot"):
        got = getattr(mine, fn)(l, t(ANGLES)).numpy()
        assert np.abs(got - ref[fn][l]).max() <= ROT_TOL, fn
    got = mine.align_z(l, t(v)).numpy()
    assert np.abs(got - ref["align_z"][l]).max() <= ALIGN_TOL
    # R maps each edge onto +z: D(R) carries Y(v) to Y(z)
    block = slice(l * l, (l + 1) ** 2)
    y = tirr.sph_harm(max(l, 1), t(v))[:, block]
    z = tirr.sph_harm(max(l, 1), t(np.tile([[0, 0, 1]], (64, 1))
                                   .astype(np.float32)))[:, block]
    np.testing.assert_allclose(torch.einsum("eij,ej->ei", t(got), y).numpy(),
                               z.numpy(), atol=1e-5)


# ----------------------------------------------------------------------
# the four models against the reference
# ----------------------------------------------------------------------
def _port_forward(name):
    from repro_torch.models.gnn.equiformer_v2 import equiformer_energy
    from repro_torch.models.gnn.gat import gat_apply
    from repro_torch.models.gnn.graphcast import graphcast_apply

    _, ct, batch, _, params = smoke_case(name)
    p, b = convert.params_from_numpy(params, device=CPU), port_batch(batch)
    with torch.no_grad():
        if ct.arch == "gat":
            return gat_apply(p, ct, b["feats"], b["edge_src"], b["edge_dst"])
        if ct.arch == "graphcast":
            return graphcast_apply(p, ct, b["feats"], b["edge_src"],
                                   b["edge_dst"])
        args = (p, ct, b["species"], b["positions"], b["edge_src"],
                b["edge_dst"], b["graph_id"], 1)
        if ct.arch == "nequip":
            return tneq.nequip_energy_forces(*args)
        return equiformer_energy(*args)


@functools.lru_cache(maxsize=None)
def ref_outputs(name):
    """The reference's forward (NequIP: energies and forces), loss and
    parameter gradients on ``smoke_case(name)``, and for NequIP the
    gradient of a loss on the forces alone: one jitted call (one compile)
    an architecture, as numpy."""
    from repro.models.gnn.equiformer_v2 import equiformer_energy
    from repro.models.gnn.gat import gat_apply
    from repro.models.gnn.graphcast import graphcast_apply

    cj, _, batch, _, params = smoke_case(name)

    def forward(p, b):
        if cj.arch == "gat":
            return gat_apply(p, cj, b["feats"], b["edge_src"], b["edge_dst"])
        if cj.arch == "graphcast":
            return graphcast_apply(p, cj, b["feats"], b["edge_src"],
                                   b["edge_dst"])
        energy = (jneq.nequip_energy_forces if cj.arch == "nequip"
                  else equiformer_energy)
        return energy(p, cj, b["species"], b["positions"], b["edge_src"],
                      b["edge_dst"], b["graph_id"], 1)

    def run(p, b):
        out = dict(forward=forward(p, b))
        out["loss"], out["grads"] = jax.value_and_grad(
            lambda q: jgs.gnn_loss(q, cj, b)[0])(p)
        if cj.arch == "nequip":
            out["force_grads"] = jax.grad(
                lambda q: jnp.sum(forward(q, b)[1] ** 2))(p)
        return out

    out = jax.jit(run)(jax.tree.map(jnp.asarray, params), ref_batch(batch))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_the_reference(name):
    mine, ref = _port_forward(name), ref_outputs(name)["forward"]
    if name == "nequip":  # energies and forces
        assert _err(mine[0], ref[0]) <= FWD_TOL
        assert _err(mine[1], ref[1]) <= FWD_TOL
        assert float(np.abs(np.asarray(ref[1])).max()) > 0
        return
    assert _err(mine, ref) <= FWD_TOL


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_the_reference(name):
    _, ct, batch, _, params = smoke_case(name)
    out = ref_outputs(name)
    loss_ref, grads_ref = out["loss"], out["grads"]
    loss, _, grads = tgs._grads(
        lambda p: tgs.gnn_loss(p, ct, port_batch(batch)),
        convert.params_from_numpy(params, device=CPU))
    assert _err(loss, loss_ref) <= FWD_TOL
    mine, ref = _leaves(grads), _leaves(grads_ref)
    assert mine.keys() == ref.keys()
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-30)
        err = float(np.abs(mine[k].numpy() - ref[k]).max()) / scale
        assert err <= GRAD_TOL, (k, err)


def test_nequip_forces_differentiate_twice_like_the_reference():
    """A loss on the forces alone: its parameter gradient exists only
    through ``-∂E/∂positions`` (second order), in both packages."""
    _, ct, batch, _, params = smoke_case("nequip")
    ref = _leaves(ref_outputs("nequip")["force_grads"])
    tb = port_batch(batch)

    def port_loss(p):
        _, f = tneq.nequip_energy_forces(p, ct, tb["species"],
                                         tb["positions"], tb["edge_src"],
                                         tb["edge_dst"], tb["graph_id"], 1)
        return torch.sum(f ** 2), {}

    _, _, grads = tgs._grads(port_loss,
                             convert.params_from_numpy(params, device=CPU))
    mine = _leaves(grads)
    # the readout's last bias moves the energy, not the forces
    assert float(np.abs(ref["readout/l1/b"]).max()) == 0.0
    assert float(mine["readout/l1/b"].abs().max()) == 0.0
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-30)
        assert float(np.abs(mine[k].numpy() - ref[k]).max()) / scale \
            <= GRAD_TOL, k


def test_zero_length_edges_keep_forces_finite():
    """Self loops (the smoke batch has two) have zero length: the
    ``1e-12`` terms of ``norm(vec + 1e-12)`` and ``vec / (r + 1e-12)``
    keep their length, direction and gradient finite, so the energy and
    forces are finite (and the reference's: the forward test); without
    them the forces are NaN."""
    _, ct, batch, _, params = smoke_case("nequip")
    assert (batch["edge_src"] == batch["edge_dst"]).sum() == 2
    b = port_batch(batch)
    p = convert.params_from_numpy(params, device=CPU)
    args = (p, ct, b["species"], b["positions"], b["edge_src"],
            b["edge_dst"], b["graph_id"], 1)
    with torch.no_grad():
        e, f = tneq.nequip_energy_forces(*args)
    assert torch.isfinite(e).all() and torch.isfinite(f).all()

    def bare(positions, edge_src, edge_dst):
        vec = positions[edge_dst] - positions[edge_src]
        r = torch.linalg.norm(vec, dim=-1)
        return r, vec / r[:, None]

    own = tneq.edge_geometry
    tneq.edge_geometry = bare
    try:
        with torch.no_grad():
            _, f = tneq.nequip_energy_forces(*args)
    finally:
        tneq.edge_geometry = own
    assert not torch.isfinite(f).all()


def test_bessel_rbf_matches_the_reference():
    r = np.array([0.0, 1e-9, 0.3, 1.0, 2.5, 4.999, 5.0, 7.0], np.float32)
    mine = tneq.bessel_rbf(torch.from_numpy(r), 8, 5.0).numpy()
    assert _err(mine, jneq.bessel_rbf(jnp.asarray(r), 8, 5.0)) <= FWD_TOL


# ----------------------------------------------------------------------
# segment_max's gradient
# ----------------------------------------------------------------------
def test_segment_max_gradient_matches_jax_grad():
    """Ties in a segment share its gradient evenly, an empty segment (3)
    and an out-of-range id (7) pass none — in both packages."""
    data = np.array([[1.0, 2.0], [3.0, 2.0], [3.0, -1.0], [0.5, 0.5],
                     [-2.0, 4.0], [9.0, 9.0]], np.float32)
    ids = np.array([0, 0, 0, 1, 2, 7], np.int32)
    w = np.arange(1, 9, dtype=np.float32).reshape(4, 2)

    def ref(x):
        m = jax.ops.segment_max(x, jnp.asarray(ids), num_segments=4)
        return jnp.sum(jnp.where(jnp.isfinite(m), m, 0.0) * w)

    want = np.asarray(jax.grad(ref)(jnp.asarray(data)))
    x = torch.from_numpy(data).requires_grad_(True)
    m = tseg.segment_max(x, torch.from_numpy(ids), 4)
    got, = torch.autograd.grad(
        torch.sum(torch.where(torch.isfinite(m), m, 0.0) * torch.from_numpy(w)),
        x)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 1] == got[1, 1] == w[0, 1] / 2  # the tie at 2.0


def test_segment_softmax_gradient_matches_jax_grad():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(30, 3)).astype(np.float32)
    logits[5] = logits[4]  # a tied maximum
    ids = rng.integers(0, 6, 30).astype(np.int32)
    ids[4] = ids[5] = 2
    w = rng.normal(size=(30, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jseg.segment_softmax(
        x, jnp.asarray(ids), 7) * w))(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    got, = torch.autograd.grad(torch.sum(tseg.segment_softmax(
        x, torch.from_numpy(ids), 7) * torch.from_numpy(w)), x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


# ----------------------------------------------------------------------
# parameters and specs
# ----------------------------------------------------------------------
SHARED = {"nequip": ("self", "post"), "equiformer-v2": ("post",)}


@pytest.mark.parametrize("name", list(SHARED))
def test_shared_init_keys_are_copied(name):
    """One key draws every ``l`` of these leaves in the reference, so its
    matrices are equal across l; the port's own init shares one draw."""
    params = smoke_case(name)[4]
    mine = tgs.gnn_init(torch.Generator().manual_seed(0),
                        tcfg.get_config(name + "-smoke"), 0, device=CPU)
    for layer in (k for k in params if k.startswith("layer")):
        for part in SHARED[name]:
            ref = [params[layer][part][f"l{l}"]["w"] for l in range(3)]
            own = [mine[layer][part][f"l{l}"]["w"] for l in range(3)]
            assert all(np.array_equal(ref[0], r) for r in ref[1:])
            assert all(torch.equal(own[0], o) for o in own[1:])
            assert all(o.data_ptr() != own[0].data_ptr() for o in own[1:])


@pytest.mark.parametrize("name", ARCHS + ["dlrm-mlperf"])
def test_carry_over_of_every_family(name):
    """``params_from_numpy`` carries the reference's tree (every path:
    ``emb/table``, ``bot``/``top`` ``l{i}``, ``layer{i}``, ``proc{i}``,
    ``self/l{l}``, ``post/l{l}``, ``w_m{m}_r`` …) bit for bit."""
    if name == "dlrm-mlperf":
        from repro.models.dlrm import dlrm_init

        ref = jax.tree.map(np.asarray, dlrm_init(
            jax.random.key(0), jcfg.get_config(name + "-smoke")))
    else:
        ref = smoke_case(name)[4]
    mine = _leaves(convert.params_from_numpy(ref, device=CPU))
    ref = _leaves(ref)
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        assert mine[k].dtype == torch.float32
        np.testing.assert_array_equal(mine[k].numpy(), v)


@pytest.mark.parametrize("name", NAMES)
def test_meta_init_equals_the_references_eval_shape(name):
    cj, ct = jcfg.get_config(name), tcfg.get_config(name)
    shape = jcfg.GNN_SHAPES["full_graph_sm"]
    d_feat = jgs.gnn_feat_dim(cj, shape)
    assert tgs.gnn_feat_dim(ct, shape) == d_feat
    ref = jax.eval_shape(lambda k: jgs.gnn_init(k, cj, d_feat),
                         jax.random.key(0))
    mine = tgs.gnn_init(None, ct, d_feat, device="meta")
    ref = {p: (tuple(s.shape), np.dtype(s.dtype).name)
           for p, s in _leaves(ref).items()}
    assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in _leaves(mine).items()} == ref
    _, info = tgs.build_gnn_train_step(ct, None, d_feat, device=CPU)
    assert _leaves(info["params"]) == {p: (None,) * len(s)
                                       for p, (s, _) in ref.items()}


@pytest.mark.parametrize("shape", list(jcfg.GNN_SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_equal_the_reference(name, shape):
    cj, ct = jcfg.get_config(name), tcfg.get_config(name)
    entry = jcfg.GNN_SHAPES[shape]
    assert tcfg.GNN_SHAPES[shape] == entry
    ref = {k: (tuple(v.shape), np.dtype(v.dtype).name)
           for k, v in jgs.gnn_input_specs(cj, entry).items()}
    mine = tgs.gnn_input_specs(ct, entry)
    assert all(t.device.type == "meta" for t in mine.values())
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in mine.items()} == ref
    assert tgs.gnn_feat_dim(ct, entry) == jgs.gnn_feat_dim(cj, entry)


def test_batch_specs_follow_the_references_rule():
    from repro_torch.launch.mesh import LogicalMesh, make_production_mesh

    specs = tgs.gnn_input_specs(tcfg.get_config("nequip"),
                                jcfg.GNN_SHAPES["molecule"])
    one = tgs.gnn_batch_specs(specs, LogicalMesh((1, 1), ("data", "model")))
    assert one["edge_src"] == (("data", "model"),)
    assert one["positions"] == (("data", "model"), None)
    assert one["energy"] == ()
    pods = tgs.gnn_batch_specs(specs, make_production_mesh(multi_pod=True))
    assert pods["species"] == (("pod", "data", "model"),)
