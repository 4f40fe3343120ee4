"""The GNN train step on a device mesh (``build_gnn_train_step(cfg,
DeviceMesh, d_feat)``), the collectives it differentiates through, and
the dry run's bytes.

* **Against the port's one device**, every GNN smoke config on the
  meshes ``(2, 2)``, ``(1, 4)``, ``(4, 1)``, ``(2, 1, 2)`` and the uneven
  ``(1, 7)`` (24 nodes in chunks of 4, the last position none; 72 edges
  in chunks of 11, the last 6), every position on the CPU:
  ``chip_smoke.gnn_mesh_compare``, the card's check too — one AdamW step
  from the same parameters and batch (``chip_smoke.gnn_smoke_batch``) by
  ``step_errs`` at ``chip_smoke.MODEL_STEP_TOL`` on every key in
  float64 and float32 (a float32 parameter whose gradient is within two
  orders of AdamW's eps may move by the two updates' difference:
  ``chip_smoke.STEP_NEAR_EPS``), every replicated parameter and moment
  with the same bits on every position.  NequIP's force loss
  differentiates twice through the mesh, so its grad_norm matching says
  that the second-order gradient reaches the parameters once.
* **Against the reference's own mesh run**: the reference's step jitted
  over a host mesh of the same shape (one subprocess with four host
  devices, started by the fixture, read by the last tests), on the
  reference's ``gnn_init`` parameters and the same batch; one config a
  mesh (the reference's jit refuses shards that do not divide, so the
  uneven mesh has none), NequIP's in float64 (``REF_JOBS`` says why),
  held on every key.
* ``torch.autograd.gradgradcheck`` in float64 of every collective of
  ``models/sharding.py`` on four CPU positions: the adjoint ones
  (all-gather, reduce-scatter, all-reduce) as they are; ``psum`` (whose
  result every member uses alike) through a tie of its replicated
  outputs, ``replicate`` and ``split`` (whose input is replicated) from
  one value spread to every position.
* Position ``(0, ...)``'s bytes in the mesh step of a dry-run cell ``==``
  ``roofline.shard_bytes`` ``==`` the row's ``memory_per_device.args``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import convert, sharding
from repro_torch.models import gnn_steps as tgs

from test_torch_gnn import chip_smoke, smoke_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(tcfg.GNN_ARCHS)
MESHES = [(2, 2), (1, 4), (4, 1), (2, 1, 2), (1, 7)]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
CPU = torch.device("cpu")
# the reference's mesh runs: one config a mesh shape it accepts, NequIP's
# in float64 (in float32 its states are rounding at 1e-3 of their norm
# against float64 even on one device: its force loss's second derivative
# cancels between an edge's two ends, so two orders of summation differ
# by more than MODEL_STEP_TOL's 1e-4)
REF_JOBS = [("nequip", (2, 2), "float64"), ("gat-cora", (1, 4), "float32"),
            ("graphcast", (4, 1), "float32"),
            ("equiformer-v2", (2, 1, 2), "float32")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_of(shape):
    return chip_smoke.lm_mesh_of(shape, [CPU] * int(np.prod(shape)))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def tree_of(arrays, prefix):
    out = {}
    for k, v in arrays.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ----------------------------------------------------------------------
# the reference's mesh runs, in one subprocess
# ----------------------------------------------------------------------
REF_CODE = r"""
import dataclasses, json, math, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.configs as jcfg
from repro.models import gnn_steps as jgs

jobs, d = json.loads(sys.argv[1]), sys.argv[2]

def tree(z, prefix, dtype):
    out = {}
    for k in z.files:
        if k.startswith(prefix + "/"):
            node = out
            parts = k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            v = z[k]
            node[parts[-1]] = jnp.asarray(
                v.astype(dtype) if v.dtype.kind == "f" else v)
    return out

def flat(t, prefix, res):
    for k, v in t.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}/{k}", res)
        else:
            res[f"{prefix}/{k}"] = np.asarray(v)

for name, shape, d_feat, dtype in jobs:
    with jax.enable_x64(dtype == "float64"):
        cfg = dataclasses.replace(jcfg.get_config(name + "-smoke"),
                                  dtype=dtype)
        z = np.load(f"{d}/{name}-in.npz")
        params, batch = tree(z, "params", dtype), tree(z, "batch", dtype)
        axes = (("data", "model") if len(shape) == 2
                else ("pod", "data", "model"))
        mesh = Mesh(np.array(jax.devices()[:math.prod(shape)])
                    .reshape(shape), axes)
        build, info = jgs.build_gnn_train_step(cfg, mesh, d_feat)
        fn = build(jax.eval_shape(lambda: batch))
        p2, o2, m = fn(params, info["opt_init"](params), batch, 0)
    res = {}
    flat(p2, "params", res)
    flat(o2, "opt", res)
    for k, v in m.items():
        res[f"metric/{k}"] = np.asarray(v, np.float64)
    np.savez(f"{d}/{name}-{'x'.join(map(str, shape))}.npz", **res)
print("done")
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's inputs written, its subprocess started; yields
    ``result(name)`` (waits for the subprocess at its first call)."""
    d = tmp_path_factory.mktemp("ref_gnn_mesh")
    jobs = []
    for name, shape, dtype in REF_JOBS:
        _, _, batch, d_feat, params = smoke_case(name)
        np.savez(d / f"{name}-in.npz", **flat(params, "params"),
                 **flat(batch, "batch"))
        jobs.append([name, list(shape), d_feat, dtype])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_CODE), json.dumps(jobs),
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    done = []

    def result(name, shape):
        if not done:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"reference subprocess failed:\n{err}"
            done.append(True)
        with np.load(d / f"{name}-{'x'.join(map(str, shape))}.npz") as z:
            return {k: z[k] for k in z.files}

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ----------------------------------------------------------------------
# the port's mesh against its one device
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_equals_one_device(arch, shape, reference_runs):
    # the reference's subprocess (the fixture) runs meanwhile
    cfg = tcfg.get_config(arch + "-smoke")
    batch, d_feat = chip_smoke.gnn_smoke_batch(cfg, np.random.default_rng(3))
    params = tgs.gnn_init(torch.Generator().manual_seed(0), cfg, d_feat,
                          device=CPU)
    row, ok = chip_smoke.gnn_mesh_compare(cfg.name, params, batch, d_feat,
                                          mesh_of(shape), CPU)
    assert ok, {dt: {k: v for k, v in row[dt].items() if k.startswith("err")}
                for dt in ("float64", "float32")}
    for dt in ("float64", "float32"):
        assert row[dt]["mesh"]["replicas_equal"]
        assert row[dt]["err_grad_norm"] <= chip_smoke.MODEL_STEP_TOL[
            "grad_norm"]
    assert row["float64"]["err_states"] <= chip_smoke.MODEL_STEP_TOL["states"]


def test_uneven_shards_leave_the_last_position_short_or_empty():
    """On (1, 7) the 24 nodes lie in chunks of 4 (the last position none)
    and the 72 edges in chunks of 11 (the last 6), as
    ``sharding.chunk`` cuts them; the step's batch follows them."""
    cfg = tcfg.get_config("gat-cora-smoke")
    batch, d_feat = chip_smoke.gnn_smoke_batch(cfg, np.random.default_rng(3))
    _, info = tgs.build_gnn_train_step(cfg, mesh_of((1, 7)), d_feat)
    sb = info["shard_batch"](batch)
    assert [s.shape[0] for s in sb["feats"].shards] == [4] * 6 + [0]
    assert [s.shape[0] for s in sb["edge_src"].shards] == [11] * 6 + [6]
    assert sb["feats"].spec == (("data", "model"), None)


def test_a_step_on_a_mesh_refuses_what_it_cannot_lay_out():
    """No fallback hides the mesh: unsharded parameters, a batch sharded
    another way and ``device=`` with a mesh each raise."""
    cfg = tcfg.get_config("gat-cora-smoke")
    batch, d_feat = chip_smoke.gnn_smoke_batch(cfg, np.random.default_rng(3))
    mesh = mesh_of((2, 2))
    params = tgs.gnn_init(torch.Generator().manual_seed(0), cfg, d_feat,
                          device=CPU)
    build, info = tgs.build_gnn_train_step(cfg, mesh, d_feat)
    fn = build(batch)
    sp = info["shard"](params)
    with pytest.raises(ValueError, match="not sharded"):
        fn(params, info["opt_init"](sp), batch, 0)
    wrong = dict(batch)
    wrong["feats"] = sharding.shard_tensor(torch.from_numpy(batch["feats"]),
                                           ("data",), mesh)
    with pytest.raises(ValueError, match="laid out"):
        fn(sp, info["opt_init"](sp), wrong, 0)
    with pytest.raises(ValueError, match="not both"):
        tgs.build_gnn_train_step(cfg, mesh, d_feat, device=CPU)


# ----------------------------------------------------------------------
# the port's mesh against the reference's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,shape,dtype", REF_JOBS,
                         ids=[f"{n}-{'x'.join(map(str, s))}"
                              for n, s, _ in REF_JOBS])
def test_mesh_step_equals_the_references_mesh_run(name, shape, dtype,
                                                  reference_runs):
    ref = reference_runs(name, shape)
    _, ct, batch, d_feat, params = smoke_case(name)
    mesh = mesh_of(shape)
    dt = getattr(torch, dtype)
    got = chip_smoke.gnn_mesh_train(
        dataclasses.replace(ct, dtype=dtype),
        chip_smoke._cast_floats(convert.params_from_numpy(params,
                                                          device=CPU), dt),
        chip_smoke._cast_floats(batch, dt), d_feat, mesh=mesh)
    assert got["replicas_equal"]
    want = (tree_of(ref, "params"), tree_of(ref, "opt"),
            {k.split("/")[1]: float(v) for k, v in ref.items()
             if k.startswith("metric/")})
    errs, ok = chip_smoke.step_errs(got["step"], want,
                                    chip_smoke.MODEL_STEP_TOL, lr_t=5e-3,
                                    step=0)
    assert ok, errs


# ----------------------------------------------------------------------
# the collectives, differentiated twice
# ----------------------------------------------------------------------
AXES = [("data", "model"), ("model",)]


class _Tie(torch.autograd.Function):
    """Copies of one replicated value as that value: forward the first
    copy, backward its cotangent to every copy (each member's cotangent
    of a replicated value is the one value's)."""

    @staticmethod
    def forward(ctx, *copies):
        ctx.n = len(copies)
        return copies[0].clone()

    @staticmethod
    def backward(ctx, g):
        return (g,) * ctx.n


class _Spread(torch.autograd.Function):
    """One value as its copies on every position: backward the first
    copy's cotangent (the copies' are equal under the convention)."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.clone() for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        return gs[0], None


def _spread_groups(mesh, axes, values):
    """Each group's one value (along ``axes``) as a copy on each member."""
    lay = sharding.layout(mesh)
    out = [None] * lay.n
    for x, g in zip(values, lay.groups(axes)):
        for p, c in zip(g, _Spread.apply(x, len(g))):
            out[p] = c
    return out


def _cubes(ys):
    return tuple(y ** 3 for y in ys)


def _psum_tied(mesh, axes):
    """``psum`` over ``axes``, each group's sum tied into one value."""
    lay = sharding.layout(mesh)

    def f(*xs):
        ys = sharding.psum(list(xs), mesh, axes, "t")
        return tuple(_Tie.apply(*(ys[p] for p in g)) ** 3
                     for g in lay.groups(axes))

    return f


@pytest.mark.parametrize("axes", AXES, ids=["all", "model"])
@pytest.mark.parametrize("kind", ["all_gather", "reduce_scatter",
                                  "all_reduce", "psum", "replicate",
                                  "split"])
def test_collectives_are_twice_differentiable(kind, axes):
    mesh = mesh_of((2, 2))
    gen = torch.Generator().manual_seed(5)
    xs = tuple(torch.randn(4, 3, dtype=torch.float64, generator=gen,
                           requires_grad=True) for _ in range(4))
    if kind in ("replicate", "split"):
        # one value a group along ``axes``, spread to its members
        op = getattr(sharding, kind)
        extra = (0,) if kind == "split" else ()

        def f(*per_group):
            return _cubes(op(_spread_groups(mesh, axes, per_group), mesh,
                             axes, *extra, "t"))
        args = xs[:len(sharding.layout(mesh).groups(axes))]
    elif kind == "psum":
        f, args = _psum_tied(mesh, axes), xs
    else:
        op = getattr(sharding, kind)

        def f(*x):
            if kind == "all_reduce":
                return _cubes(op(list(x), mesh, axes, "t"))
            return _cubes(op(list(x), mesh, axes, 0, "t"))
        args = xs
    assert torch.autograd.gradcheck(f, args)
    assert torch.autograd.gradgradcheck(f, args)


# ----------------------------------------------------------------------
# the dry run's bytes
# ----------------------------------------------------------------------
def position_bytes(tree, p=0):
    return sum(st.shards[p].numel() * st.shards[p].element_size()
               for st in chip_smoke._lm_leaves(tree))


def test_position_bytes_equal_shard_bytes_and_the_dry_runs_args():
    """gat-cora's ``full_graph_sm`` cell on the pod mesh: the mesh step's
    parameters, AdamW state and batch at position (0, 0) (a 16 x 16
    ``DeviceMesh`` of meta positions) are ``shard_bytes`` of the cell's
    arguments (the int step traced as an int32 scalar) and the dry-run
    row's ``memory_per_device.args``."""
    from repro_torch.launch.mesh import make_production_mesh

    logical = make_production_mesh()
    mesh = DeviceMesh(logical.shape, logical.axis_names,
                      ("meta",) * logical.size)
    cfg = tcfg.get_config("gat-cora")
    shape = cfg.shapes["full_graph_sm"]
    d_feat = tgs.gnn_feat_dim(cfg, shape)
    batch = tgs.gnn_input_specs(cfg, shape)
    build, info = tgs.build_gnn_train_step(cfg, mesh, d_feat)
    sp = info["shard"](info["dummy"])
    mine = (position_bytes(sp) + position_bytes(info["opt_init"](sp))
            + position_bytes(info["shard_batch"](batch)) + 4)
    cell = dryrun.model_cell(cfg, shape, logical)
    assert mine == roofline.shard_bytes(cell.args, cell.arg_specs, logical)
    row = dryrun.run_cell("gat-cora", "full_graph_sm", "pod")
    assert mine == row["memory_per_device"]["args"]

