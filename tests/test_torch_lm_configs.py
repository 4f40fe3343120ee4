"""The port's LM configs and sharding specs against the JAX package's.

Every LM config (the five architectures, full and ``-smoke``) is field
for field the reference's; ``param_count``, ``active_param_count``, the
parameter tree's shapes and dtypes (the port's ``lm_init`` on ``meta``
against the reference's ``jax.eval_shape``) and every ``PartitionSpec``
of ``lm_param_specs`` / ``cache_specs`` are ``==``.  Nothing is
allocated: the full configs are shapes only.
"""
import dataclasses
import math
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.models import steps as jsteps
from repro.models import transformer as jtr
import repro_torch.configs as tcfg
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttr

ARCHS = list(tcfg.LM_ARCHS)
NAMES = ARCHS + [a + "-smoke" for a in ARCHS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are meta
    or tiny, and under pytest-xdist every worker's full-width thread pool
    would oversubscribe the cores."""
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


def _ref_shapes(cfg):
    tree = jax.eval_shape(lambda k: jtr.lm_init(k, cfg), jax.random.key(0))
    return {p: (tuple(s.shape), np.dtype(s.dtype).name)
            for p, s in _leaves(tree).items()}


def _port_shapes(cfg):
    tree = ttr.lm_init(None, cfg, device="meta")
    return {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in _leaves(tree).items()}


def test_the_arch_list_is_the_references_lm_half():
    lm = [a for a in jcfg.ASSIGNED_ARCHS
          if jcfg.get_config(a).family == "lm"]
    assert ARCHS == lm
    assert tcfg.LM_SHAPES == jcfg.LM_SHAPES


@pytest.mark.parametrize("name", NAMES)
def test_lm_configs_equal_the_reference(name):
    mine, ref = tcfg.get_config(name), jcfg.get_config(name)
    assert type(mine).__name__ == type(ref).__name__ == "LMConfig"
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.family == "lm" and mine.shapes == ref.shapes
    # __post_init__ fills d_head only where it is 0
    assert mine.d_head == (ref.d_head or ref.d_model // ref.n_heads)


@pytest.mark.parametrize("name", NAMES)
def test_param_counts_equal_the_reference(name):
    mine, ref = tcfg.get_config(name), jcfg.get_config(name)
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("name", NAMES)
def test_meta_init_equals_the_references_eval_shape(name):
    """Every leaf's path, shape and dtype, so the numel too."""
    mine = _port_shapes(tcfg.get_config(name))
    ref = _ref_shapes(jcfg.get_config(name))
    assert mine == ref
    if name == "qwen2-0.5b":
        numel = sum(math.prod(s) for s, _ in mine.values())
        assert numel == 630_167_424  # the formula says 630,095,872
        assert tcfg.get_config(name).param_count() == 630_095_872


def test_param_counts_match_published():
    """The twin of the reference's guard: the full configs' parameter
    counts are in the right ballpark."""
    cases = {
        "qwen2-0.5b": (0.35e9, 0.8e9),
        "chatglm3-6b": (5e9, 8e9),
        "qwen1.5-110b": (90e9, 130e9),
        "grok-1-314b": (250e9, 360e9),
        "deepseek-v3-671b": (550e9, 750e9),
    }
    for name, (lo, hi) in cases.items():
        n = tcfg.get_config(name).param_count()
        assert lo < n < hi, (name, n)
    ds = tcfg.get_config("deepseek-v3-671b")
    assert 25e9 < ds.active_param_count() < 55e9


MESHES = {
    "none": None,
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
    "ep4": ((2, 4), ("data", "model")),
}


def _meshes(key):
    """The reference reads only ``mesh.shape[axis]``; the port's mesh is a
    :class:`LogicalMesh` of the same shape."""
    if MESHES[key] is None:
        return None, None
    shape, axes = MESHES[key]
    ref = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                axis_names=axes)
    return ref, LogicalMesh(shape, axes)


def _as_tuples(spec_tree):
    return {p: tuple(s) for p, s in _leaves(spec_tree).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_equal_the_reference(name, mesh):
    ref_mesh, my_mesh = _meshes(mesh)
    cfg_j, cfg_t = jcfg.get_config(name), tcfg.get_config(name)
    dummy = jax.eval_shape(lambda k: jtr.lm_init(k, cfg_j),
                           jax.random.key(0))
    ref = _as_tuples(jsteps.lm_param_specs(dummy, cfg_j, mesh=ref_mesh))
    mine = _leaves(tsteps.lm_param_specs(
        ttr.lm_init(None, cfg_t, device="meta"), cfg_t, mesh=my_mesh))
    assert mine == ref


def test_grok_experts_fall_back_to_tp_where_e_does_not_divide_the_axis():
    cfg = tcfg.get_config("grok-1-314b")
    dummy = ttr.lm_init(None, cfg, device="meta")
    pod = tsteps.lm_param_specs(dummy, cfg, mesh=LogicalMesh(
        (16, 16), ("data", "model")))
    ep = tsteps.lm_param_specs(dummy, cfg, mesh=LogicalMesh(
        (2, 4), ("data", "model")))
    ex = "layers", "moe", "experts", "w_in"
    get = lambda t: t[ex[0]][ex[1]][ex[2]][ex[3]]  # noqa: E731
    assert get(pod) == (None, None, "data", "model")
    assert get(ep) == (None, "model", "data", None)


@pytest.mark.parametrize("dp", [("data",), ("pod", "data")])
@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_equal_the_reference(name, dp):
    ref = _as_tuples(jsteps.cache_specs(jcfg.get_config(name), dp=dp))
    mine = _leaves(tsteps.cache_specs(tcfg.get_config(name), dp=dp))
    assert mine == ref


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", ["qwen2-0.5b", "deepseek-v3-671b"])
def test_input_specs_equal_the_reference(name, shape):
    entry = tcfg.LM_SHAPES[shape]
    step = entry["kind"]
    ref = _leaves(jsteps.lm_input_specs(jcfg.get_config(name), entry,
                                        step=step))
    mine = _leaves(tsteps.lm_input_specs(tcfg.get_config(name), entry,
                                         step=step))
    assert sorted(mine) == sorted(ref)
    for path, t in mine.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[path].shape), path
        assert str(t.dtype).removeprefix("torch.") == np.dtype(
            ref[path].dtype).name, path


def test_step_builders_report_the_specs_without_allocating():
    cfg = tcfg.get_config("qwen2-0.5b")
    mesh = LogicalMesh((16, 16), ("data", "model"))
    _, info = tsteps.build_lm_decode_step(cfg, mesh, device="cpu")
    assert info["cache"] == tsteps.cache_specs(cfg, dp=("data",))
    assert info["params"]["lm_head"]["w"] == ("data", "model")
    leaves = _leaves(info["dummy"])
    assert all(t.device.type == "meta" for t in leaves.values())
    _, info = tsteps.build_lm_prefill_step(cfg, mesh, device="cpu")
    assert info["params"]["embed"]["table"] == ("model", None)
