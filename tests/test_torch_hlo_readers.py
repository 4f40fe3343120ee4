"""The port's HLO readers and its step walk against the JAX package.

The readers are copies of the reference's: on the collectives test's
hand-written modules, on ten model steps the reference compiles on the
CPU and on a permute/psum program compiled on four host devices, each
returns what the reference's returns (``==``).  On the same ten steps
the walk's product FLOPs equal the reference's ``hlo_cost`` FLOPs but for
named differences, and on a 2 x 2 mesh the port's per-device argument
bytes equal XLA's ``memory_analysis``.
"""
import ast
import json
import os

import jax
import pytest
import torch

import repro.configs as jcfg
import repro.launch.roofline as jroof
import repro_torch.configs as tcfg
from repro_torch.launch import dryrun, hlo, roofline
from repro_torch.launch.mesh import make_mesh_for
from torch.utils._python_dispatch import TorchDispatchMode

HERE = os.path.dirname(os.path.abspath(__file__))

READERS = ("infer_num_devices", "hlo_cost", "collective_bytes",
           "collective_by_source", "collective_phases")


def _port_reader(name):
    return getattr(hlo, "hlo_collective_phases" if name == "collective_phases"
                   else name)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (pytest-xdist)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _collectives_texts():
    """The HLO modules of ``tests/test_collectives.py``: ``_HLO``, it
    without its header, and the loop-aware test's module."""
    tree = ast.parse(open(os.path.join(HERE, "test_collectives.py")).read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value,
                                                        ast.Constant)
                and isinstance(node.value.value, str)
                and "HloModule" in node.value.value):
            out[node.targets[0].id] = node.value.value
    return {"_HLO": out["_HLO"],
            "_HLO_headerless": out["_HLO"].replace(", num_partitions=4", ""),
            "loop": out["hlo"]}


COLLECTIVE_TEXTS = _collectives_texts()


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("text", sorted(COLLECTIVE_TEXTS))
def test_readers_equal_the_references_on_the_collectives_modules(text,
                                                                 reader):
    hlo_text = COLLECTIVE_TEXTS[text]
    ref = getattr(jroof, reader)
    mine = _port_reader(reader)
    assert mine(hlo_text) == ref(hlo_text)
    if reader != "infer_num_devices":
        assert mine(hlo_text, num_devices=8) == ref(hlo_text, num_devices=8)


def test_the_readers_are_exported_by_roofline_and_import_no_jax():
    for name in ("infer_num_devices", "hlo_cost", "collective_bytes",
                 "collective_by_source", "hlo_collective_phases"):
        assert getattr(roofline, name) is getattr(hlo, name)
    # the port's tally-based collective_phases keeps its name and meaning
    assert roofline.collective_phases is not hlo.hlo_collective_phases
    src = open(hlo.__file__).read()
    assert "import jax" not in src and "from jax" not in src


# ----------------------------------------------------------------------
# ten model steps, compiled by the reference on the CPU (1 x 1 mesh)
# ----------------------------------------------------------------------
STEPS = {
    "qwen2-prefill": ("qwen2-0.5b-smoke",
                      dict(kind="prefill", seq_len=64, global_batch=2)),
    "qwen2-train": ("qwen2-0.5b-smoke",
                    dict(kind="train", seq_len=64, global_batch=4)),
    "deepseek-prefill": ("deepseek-v3-671b-smoke",
                         dict(kind="prefill", seq_len=64, global_batch=2)),
    "gat-train": ("gat-cora-smoke", "full_graph_sm"),
    "graphcast-train": ("graphcast-smoke", "full_graph_sm"),
    "equiformer-train": ("equiformer-v2-smoke", "molecule"),
    "nequip-train": ("nequip-smoke", "molecule"),
    "dlrm-serve": ("dlrm-mlperf-smoke", "serve_p99"),
    "dlrm-train": ("dlrm-mlperf-smoke", "train_batch"),
    "dlrm-retrieval": ("dlrm-mlperf-smoke", "retrieval_cand"),
}
# the FLOPs of each step's products of contracted size 1, which the
# reference does not count (``_UnitContractions``)
UNIT = {
    # the gradient of ``h @ a`` by GAT's attention vectors, four
    # (2, 3072, 1) x (2, 1, 3|4) bmms
    "gat-train": 172_032,
    # the top MLP's last layer (256 -> 1): its input's gradient, the
    # (8192, 1) x (1, 256) product
    "dlrm-train": 4_194_304,
    # Equiformer-v2's output head (a d -> 1 layer): its input's gradient
    "equiformer-train": 131_072,
    # NequIP's CG contractions through an l = 0 slice, in the second-order
    # backward of the force term, and its readout's last layer
    "nequip-train": 5_373_952,
}
# the product FLOPs of ``hlo_cost`` that the walk does not have, beyond
# ``UNIT`` (the split is in the test's docstring)
FEWER = {
    "nequip-train": 9_502_720 + 9_502_720,
}


def _shape(cfg, shape):
    return cfg.shapes[shape] if isinstance(shape, str) else shape


def _reference_lowered(name, shape, mesh):
    """The reference's step for ``name`` at ``shape``, lowered as its
    ``run_cell`` lowers it."""
    import repro.models.gnn_steps as jgs
    import repro.models.steps as jsteps

    cfg = jcfg.get_config(name)
    shape = _shape(cfg, shape)
    if cfg.family == "lm":
        kind = shape["kind"]
        if kind == "train":
            fn, info = jsteps.build_lm_train_step(cfg, mesh)
            specs = jsteps.lm_input_specs(cfg, shape, step="train")
            return fn.lower(info["dummy"], info["opt_shape"], specs["batch"],
                            0)
        fn, info = jsteps.build_lm_prefill_step(cfg, mesh)
        specs = jsteps.lm_input_specs(cfg, shape, step="prefill")
        return fn.lower(info["dummy"], specs["tokens"])
    if cfg.family == "gnn":
        d_feat = jgs.gnn_feat_dim(cfg, shape)
        batch = jgs.gnn_input_specs(cfg, shape)
        build, info = jgs.build_gnn_train_step(cfg, mesh, d_feat)
        opt = jax.eval_shape(info["opt_init"], info["dummy"])
        return build(batch).lower(info["dummy"], opt, batch, 0)
    specs = jgs.recsys_input_specs(cfg, shape)
    if shape["kind"] == "train":
        fn, info = jgs.build_dlrm_train_step(cfg, mesh)
        opt = jax.eval_shape(info["opt_init"], info["dummy"])
        return fn.lower(info["dummy"], opt, specs, 0)
    if shape["kind"] == "retrieval":
        fn, info = jgs.build_dlrm_retrieval_step(cfg, mesh)
        return fn.lower(info["dummy"], specs["dense"], specs["cand_ids"])
    fn, info = jgs.build_dlrm_serve_step(cfg, mesh)
    return fn.lower(info["dummy"], specs["dense"], specs["sparse_ids"])


class _UnitContractions(TorchDispatchMode):
    """The FLOPs of products whose contracted dimension is 1 (outer
    products): XLA's algebraic simplifier rewrites such a ``dot`` as a
    multiply, so the reference's ``hlo_cost`` counts none of them."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if name in roofline._PRODUCTS:
            a = args[1] if name in roofline._BIASED else args[0]
            if a.dim() > 1 and a.shape[-1] == 1:
                self.flops += roofline._product_flops(func, args,
                                                      kwargs or {}, out)
        return out


@pytest.fixture(scope="module")
def compiled():
    """Each step's optimized HLO text from the reference on a 1 x 1 mesh,
    and the port's walk of the same step (its FLOPs by dtype, and those
    of its unit contractions)."""
    from repro.launch.mesh import make_mesh_for as jmesh

    jm = jmesh((1, 1), ("data", "model"))
    tm = make_mesh_for((1, 1), ("data", "model"))
    out = {}
    for key, (name, shape) in STEPS.items():
        text = _reference_lowered(name, shape, jm).compile().as_text()
        cfg = tcfg.get_config(name)
        cell = dryrun.model_cell(cfg, _shape(cfg, shape), tm)
        unit = _UnitContractions()
        with unit:  # under the walk's own mode: one call does both
            walk = roofline.walk_step(cell.fn, *cell.args,
                                      segments=cell.segments)
        out[key] = (text, walk.flops, unit.flops)
    return out


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("step", sorted(STEPS))
def test_readers_equal_the_references_on_compiled_steps(compiled, step,
                                                        reader):
    text = compiled[step][0]
    assert _port_reader(reader)(text) == getattr(jroof, reader)(text)


@pytest.mark.parametrize("step", sorted(STEPS))
def test_walk_flops_against_the_references_hlo_cost(compiled, step):
    """The walk's product FLOPs equal ``hlo_cost``'s ``dot`` FLOPs of the
    reference's compiled step, but for the products of contracted size 1
    (``UNIT``), which XLA rewrites as multiplies: 0.12 % of GAT's step,
    0.26 % of DLRM's train step, 0.013 % of Equiformer-v2's, 0.45 % of
    NequIP's.  Nothing else differs: the LM steps' remat recompute, the
    MoE and MLA products, the float32 attention and DLRM retrieval's
    matrix-vector scoring product (``mv``, 2 x 1e6 x 16 FLOPs) are counted
    alike.
    NequIP's walk has 19,005,440 FLOPs fewer (``FEWER``), in two equal
    parts.  9,502,720: the reference takes the backward product of the
    harmonics' half of its CG contraction (``Y_l2 x CG``) once a layer, and
    the port, which makes that half once a forward
    (``nequip._cg_edge_terms``), takes it once for the layers' summed
    gradient.  9,502,720: contractions through an l = 0 slice in the
    force term's second-order backward, which JAX's einsum emits as
    batched matrix-vector products and dots and the port's autograd as
    products of contracted size 1 and broadcast multiplies."""
    text, flops, unit = compiled[step]
    ref = jroof.hlo_cost(text)["flops"]
    mine = sum(flops.values())
    assert unit == UNIT.get(step, 0)
    assert mine - unit + FEWER.get(step, 0) == ref
    assert mine / ref - 1 < 0.003
    if step == "dlrm-retrieval":
        assert flops["torch.float32"] >= 2 * 1_000_000 * 16
    if step.startswith(("qwen2", "deepseek")):
        # bf16 weights; causal_attention's products are float32 by design
        assert set(flops) == {"torch.bfloat16", "torch.float32"}
    else:
        assert set(flops) == {"torch.float32"}


# ----------------------------------------------------------------------
# four host devices: XLA's per-device arguments, and a permute/psum
# program for the readers
# ----------------------------------------------------------------------
ARG_STEPS = {
    "qwen2-train": ("qwen2-0.5b-smoke",
                    dict(kind="train", seq_len=64, global_batch=4)),
    "dlrm-train": ("dlrm-mlperf-smoke", dict(kind="train", batch=64)),
    "gat-train": ("gat-cora-smoke", "full_graph_sm"),
}

_FOUR_DEVICES = """
    import json, sys
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, {tests!r})
    from repro import compat
    from repro.launch.mesh import make_mesh_for
    from test_torch_hlo_readers import ARG_STEPS, _reference_lowered

    mesh = make_mesh_for((2, 2), ("data", "model"))
    out = {{}}
    for key, (name, shape) in ARG_STEPS.items():
        ma = _reference_lowered(name, shape, mesh).compile().memory_analysis()
        out[key] = [ma.argument_size_in_bytes, ma.output_size_in_bytes]
    flat = compat.make_mesh((4,), ("x",))

    def body(v):
        v = compat.ppermute(v, "x", [(i, (i + 1) % 4) for i in range(4)])
        return jax.lax.psum(v * 2.0, "x")

    fn = jax.jit(compat.shard_map(body, mesh=flat, in_specs=P("x"),
                                  out_specs=P()))
    out["permute_psum"] = fn.lower(
        jax.ShapeDtypeStruct((4, 128), jnp.float32)).compile().as_text()
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def four_devices(distributed_runner):
    out = distributed_runner(_FOUR_DEVICES.format(tests=HERE), 4,
                             timeout=300)
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("step", sorted(ARG_STEPS))
def test_args_per_device_equal_xlas_memory_analysis(four_devices, step):
    """``memory_per_device.args``: each leaf's dimensions divided by its
    spec's axes, rounded up, equal XLA's ``argument_size_in_bytes`` on a
    2 x 2 mesh.  XLA's ``output_size_in_bytes`` is the shard bytes of the
    result plus 8 bytes a result leaf: the pointer table of its output
    tuple."""
    name, shape = ARG_STEPS[step]
    cfg = tcfg.get_config(name)
    mesh = make_mesh_for((2, 2), ("data", "model"))
    cell = dryrun.model_cell(cfg, _shape(cfg, shape), mesh)
    xla_args, xla_out = four_devices[step]
    assert roofline.shard_bytes(cell.args, cell.arg_specs, mesh) == xla_args
    walk = roofline.walk_step(cell.fn, *cell.args)
    out = roofline.shard_bytes(walk.result, cell.out_specs(walk.result), mesh)
    n_leaves = len(roofline.tree_tensors(walk.result))
    assert out + 8 * n_leaves == xla_out


@pytest.mark.parametrize("reader", READERS)
def test_readers_equal_the_references_on_a_permute_psum_program(
        four_devices, reader):
    text = four_devices["permute_psum"]
    assert "collective-permute" in text and "all-reduce" in text
    assert _port_reader(reader)(text) == getattr(jroof, reader)(text)
    if reader == "collective_bytes":
        moved = hlo.collective_bytes(text)
        assert moved["collective-permute"] == 128 * 4  # a full rotation
        assert moved["all-reduce"] == 2 * 128 * 4 * 3 / 4
