"""The port's dry run of the model cells against the JAX package's.

The cell list equals the reference's 88 cells in its order.  For every
one of the 70 model cells the reference's arguments are captured where
it would lower: its step builders are replaced by stand-ins that build the
same dummy parameters and optimiser shapes as the real ones and return an
object whose ``.lower(*args)`` raises with what it was handed, so nothing
is compiled; each leaf's path, shape and dtype equals the port's meta
arguments (``==``), and so does each cell's ``model_flops``.  Every LM
walk gives a row on the CPU, and the command line walks deepseek-v3's
train step with no ``jax`` imported and nothing allocated.
"""
import functools
import importlib
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

import repro.compat
import repro.configs as jcfg
import repro.launch.roofline as jroof
import repro_torch.configs as tcfg
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_mesh_for, make_production_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("pod", "multipod")


def _model_cells():
    cells = []
    for arch in tcfg.ASSIGNED_ARCHS:
        cfg = tcfg.get_config(arch)
        for shape_name, shape in cfg.shapes.items():
            if not shape.get("skip_full_attention"):
                cells += [(arch, shape_name, m) for m in MESHES]
    return cells


MODEL_CELLS = _model_cells()
LM_WALKS = [(a, s) for a, s, m in MODEL_CELLS
            if m == "pod" and a in tcfg.LM_ARCHS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are meta
    or tiny, and under pytest-xdist every worker's full-width thread pool
    would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module.  Importing it sets ``XLA_FLAGS``
    to 512 host devices: the backend is brought up first (so the flag is
    not consumed) and the variable is put back."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags


# ----------------------------------------------------------------------
# the reference's arguments, captured where it would lower
# ----------------------------------------------------------------------
class _Lowered(Exception):
    def __init__(self, args):
        super().__init__("lowered")
        self.args = args


class _Fn:
    def lower(self, *args):
        raise _Lowered(args)


@functools.lru_cache(maxsize=None)
def _dummy(family, name, *extra):
    """The reference builders' ``dummy``: ``jax.eval_shape`` of the init,
    as each builder computes it."""
    cfg = jcfg.get_config(name)
    key = jax.random.key(0)
    if family == "lm":
        from repro.models.transformer import lm_init

        return jax.eval_shape(lambda k: lm_init(k, cfg), key)
    if family == "gnn":
        from repro.models.gnn_steps import gnn_init

        return jax.eval_shape(lambda k: gnn_init(k, cfg, extra[0]), key)
    from repro.models.dlrm import dlrm_init

    return jax.eval_shape(lambda k: dlrm_init(k, cfg), key)


def _stand_ins(monkeypatch):
    """Step builders with the reference's ``info`` (``dummy``,
    ``opt_shape``, ``opt_init``, computed as the real builders compute
    them) and a step that raises where it would lower."""
    import repro.models.gnn_steps as jgs
    import repro.models.steps as jsteps
    from repro.optim import cosine_schedule, make_optimizer

    def lm_train(cfg, mesh, **kw):
        dummy = _dummy("lm", cfg.name)
        opt_init, _ = make_optimizer(cfg.optimizer,
                                     cosine_schedule(3e-4, 2000, 100_000))
        return _Fn(), dict(dummy=dummy,
                           opt_shape=jax.eval_shape(opt_init, dummy))

    def lm_serve(cfg, mesh, **kw):
        return _Fn(), dict(dummy=_dummy("lm", cfg.name))

    def gnn_train(cfg, mesh, d_feat):
        opt_init, _ = make_optimizer("adamw", lambda s: 5e-3,
                                     weight_decay=0.0)
        return (lambda batch: _Fn()), dict(
            opt_init=opt_init, dummy=_dummy("gnn", cfg.name, d_feat))

    def dlrm_train(cfg, mesh):
        opt_init, _ = make_optimizer("adamw", lambda s: 1e-3)
        return _Fn(), dict(opt_init=opt_init,
                           dummy=_dummy("recsys", cfg.name))

    def dlrm_serve(cfg, mesh):
        return _Fn(), dict(dummy=_dummy("recsys", cfg.name))

    monkeypatch.setattr(jsteps, "build_lm_train_step", lm_train)
    monkeypatch.setattr(jsteps, "build_lm_prefill_step", lm_serve)
    monkeypatch.setattr(jsteps, "build_lm_decode_step", lm_serve)
    monkeypatch.setattr(jgs, "build_gnn_train_step", gnn_train)
    monkeypatch.setattr(jgs, "build_dlrm_train_step", dlrm_train)
    monkeypatch.setattr(jgs, "build_dlrm_serve_step", dlrm_serve)
    monkeypatch.setattr(jgs, "build_dlrm_retrieval_step", dlrm_serve)
    monkeypatch.setattr(repro.compat, "make_mesh", lambda shape, axes: (
        types.SimpleNamespace(axis_names=tuple(axes),
                              shape=dict(zip(axes, shape)))))


def reference_args(jdry, cell, monkeypatch):
    """The reference's ``run_cell`` up to its ``fn.lower(...)``."""
    _stand_ins(monkeypatch)
    with pytest.raises(_Lowered) as info:
        jdry.run_cell(*cell)
    return info.value.args


def leaves(tree, path=""):
    """``{path: (shape, dtype)}`` of a tree of dicts, lists and tuples
    whose leaves are shape structs, tensors or integers."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{path}/{i}"))
        return out
    if isinstance(tree, int):
        return {path: ("int", tree)}
    return {path: (tuple(tree.shape),
                   str(tree.dtype).replace("torch.", ""))}


def _port_cell(cell):
    arch, shape_name, mesh_name = cell
    cfg = tcfg.get_config(arch)
    return dryrun.model_cell(cfg, cfg.shapes[shape_name],
                             make_production_mesh(
                                 multi_pod=mesh_name == "multipod"))


# ----------------------------------------------------------------------
# cells, arguments and model FLOPs against the reference
# ----------------------------------------------------------------------
def test_all_cells_are_the_references_88_in_its_order(jdry):
    ref = jdry.all_cells()
    assert dryrun.all_cells() == ref
    assert len(ref) == 88
    assert [c for c in ref if c[0] not in jcfg.TC_GRAPHS] == MODEL_CELLS
    assert len(MODEL_CELLS) == 70
    assert not any(s == "long_500k" for _, s, _ in ref)


@pytest.mark.parametrize("cell", MODEL_CELLS, ids=":".join)
def test_cell_arguments_equal_the_references(jdry, cell, monkeypatch):
    ref = reference_args(jdry, cell, monkeypatch)
    mine = _port_cell(cell)
    assert leaves(mine.args) == leaves(ref)
    assert all(t.device.type == "meta"
               for t in roofline.tree_tensors(list(mine.args)))


@pytest.mark.parametrize("cell", MODEL_CELLS, ids=":".join)
def test_model_flops_equal_the_references(jdry, cell):
    arch, shape_name, _ = cell
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    shape = tc.shapes[shape_name]
    assert shape == jc.shapes[shape_name]
    if tc.family == "lm":
        ref = jroof.model_flops_lm(jc, shape)
        assert roofline.model_flops_lm(tc, shape) == ref
    elif tc.family == "gnn":
        ref = jdry._gnn_model_flops(jc, shape)
    else:
        ref = jdry._recsys_model_flops(jc, shape)
    assert _port_cell(cell).model_flops == ref
    assert ref > 0


@pytest.mark.parametrize("axes,shape", [(("data", "model"), (4, 2)),
                                        (("pod", "data", "model"),
                                         (2, 16, 16))])
def test_make_mesh_for_is_a_logical_grid(axes, shape):
    mesh = make_mesh_for(list(shape), list(axes))
    assert mesh.shape == shape and mesh.axis_names == axes
    assert mesh.size == int(np.prod(shape))
    assert mesh == make_mesh_for(shape, axes)


# ----------------------------------------------------------------------
# the rows of the LM cells
# ----------------------------------------------------------------------
REPORT = {f for f in jroof.RooflineReport.__dataclass_fields__}


@pytest.mark.parametrize("arch,shape_name", LM_WALKS,
                         ids=[f"{a}:{s}" for a, s in LM_WALKS])
def test_every_lm_cell_walks(arch, shape_name):
    """One walk a cell serves both meshes; a row differs between them only
    in what is divided by ``chips`` and in the shard bytes."""
    rows = {m: dryrun.run_cell(arch, shape_name, m) for m in MESHES}
    pod, multi = rows["pod"], rows["multipod"]
    for row in rows.values():
        assert set(row) == REPORT | {"grid_bytes", "fits"}
        assert row["coll_bytes_per_device"] == 0.0
        assert row["coll_breakdown"] == {} and row["t_collective"] == 0.0
        assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
        assert row["memory_per_device"]["aliased"] == 0
    assert (pod["chips"], multi["chips"]) == (256, 512)
    assert pod["grid_bytes"] == multi["grid_bytes"]
    assert pod["flops_per_device"] == 2 * multi["flops_per_device"]
    assert pod["model_flops"] == multi["model_flops"]
    assert 0 < pod["useful_fraction"] == multi["useful_fraction"] < 1
    walk = dryrun.walk_model_cell(arch, shape_name)[0]
    cfg = tcfg.get_config(arch)
    dense = cfg.first_dense_layers if cfg.moe else 0
    extra = 2 if dense else 1
    kind = cfg.shapes[shape_name]["kind"]
    assert walk.walks == (1 + extra) * (2 if kind == "train" else 1)
    assert pod["grid_bytes"] == walk.peak_bytes
    assert pod["fits"] == (walk.peak_bytes <= 80e9)


def test_the_lm_cells_that_fit_one_card():
    """Of the fifteen LM walks only qwen2-0.5b's decode at 128 x 32,768
    fits one 80 GB card: its bf16 KV cache alone is 51.5 GB; deepseek-v3's
    weights alone are 1.34 TB."""
    fits = [(a, s) for a, s in LM_WALKS
            if dryrun.run_cell(a, s, "pod")["fits"]]
    assert fits == [("qwen2-0.5b", "decode_32k")]
    cache = 24 * 128 * 32768 * 2 * 2 * 64 * 2
    assert dryrun.walk_model_cell("qwen2-0.5b", "decode_32k")[0] \
        .staged_bytes > cache
    ds = dryrun.walk_model_cell("deepseek-v3-671b", "train_4k")[0]
    assert ds.staged_bytes > 1.34e12


# ----------------------------------------------------------------------
# the command line, standing alone
# ----------------------------------------------------------------------
def test_cli_walks_deepseek_train_without_jax_or_allocation():
    """61 layers x 32 microbatches of 8 x 4,096 would take minutes to
    walk; the six small walks take ≈ 16 s on one core."""
    code = textwrap.dedent("""
        import resource, sys, time
        t0 = time.perf_counter()
        sys.argv = ["dryrun", "--cell", "deepseek-v3-671b:train_4k:multipod"]
        from repro_torch.launch import dryrun
        try:
            dryrun.main()
        except SystemExit as e:
            code = e.code
        bad = sorted(m for m in sys.modules if m in ("jax", "repro")
                     or m.startswith(("jax.", "repro.")))
        print(code, time.perf_counter() - t0,
              resource.getrusage(resource.RUSAGE_SELF).ru_maxrss, bad)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    row = json.loads(lines[0])
    code, seconds, rss_kb, bad = lines[-1].split(" ", 3)
    assert code == "0" and bad == "[]"
    assert float(seconds) < 60
    assert int(rss_kb) < 2_000_000
    assert row["status"] == "ok" and row["fits"] is False
    assert row["chips"] == 512 and row["grid_bytes"] > 1.34e12
    cfg = tcfg.get_config("deepseek-v3-671b")
    assert row["model_flops"] == roofline.model_flops_lm(
        cfg, cfg.shapes["train_4k"])
