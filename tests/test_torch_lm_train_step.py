"""The port's LM train step against the JAX package's, with carried weights.

For each of the five ``-smoke`` configs in float32 and in the configured
bfloat16, at steps 0 (the warm-up's first rate, 1.5e-7) and 2000 (the
peak): the reference's ``lm_init`` parameters, carried over bit for bit,
a fresh optimiser state, and one batch of 4 x 32 from ``TokenPipeline``
(two microbatches of the configs' ``microbatch_size`` 2) go through the
reference's ``build_lm_train_step`` (jitted, as it builds it) and the
port's.  Held to the reference by ``chip_smoke.lm_step_errs``, which the
card check uses too: the loss and AdamW's ``grad_norm``, every optimiser
state leaf, every parameter.  MoE routing is teacher-forced (the
reference's forward choices handed to the port; under remat the reference
fires its recording callback again in the backward's recompute, in
reverse layer order, and the port's recompute is known by its router
input's bits — see ``chip_smoke.lm_routes``).

Tolerances (``TOL``):

* float32: the loss and ``grad_norm`` 1e-5 (``|a - b| / (1 + |b|)``;
  seen ≤ 3e-7), the states 1e-4 of each leaf's norm (the gradient test's
  bound: m and v are the gradient and its square; seen ≤ 1.3e-6), the
  parameters 1e-5 elementwise (seen ≤ 8.5e-7 at step 2000, 0.6 % of the
  step's move of ``0.447 · lr`` ≈ 1.3e-4: gradients near AdamW's eps of
  1e-8, where the move's size follows the gradient's, not its sign).
* bfloat16: the loss and ``grad_norm`` 2**-5 (the model test's bound for
  a loss; seen ≤ 9e-4), the states 2**-4 of a leaf's norm (the
  gradients' 2**-5, doubled for v, the gradient squared; seen ≤ 0.025),
  the parameters 2**-8 elementwise (seen ≤ 2.4e-4): ``p - lr·u`` moves a
  parameter by about one bfloat16 unit at the peak rate, and the two
  packages may round it either way.

AdamW's first step from a fresh state is sign-like (``m̂ / √v̂`` is ±1 at
step 0, ±0.447 at step 2000), so an element whose gradient is near zero
and rounds to the other sign in one package moves by up to ``2 · lr_t ·
|m̂ / √v̂|`` the other way; such elements (their first moments' signs
differ) are allowed that slack and counted.  The schedule is the port's
(the cosine taken in float64, one float32 unit off XLA's at some steps):
at steps 0 and 2000 the two agree exactly (pinned below).
"""
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfg
from repro import compat
from repro.models import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import cosine_schedule as jcosine
from repro.optim import make_optimizer as jmake
import repro_torch.configs as tcfg
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.models import convert
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttr
from repro_torch.optim import cosine_schedule as tcosine
from repro_torch.optim import make_optimizer as tmake

from test_torch_lm_configs import MESHES, _leaves, _meshes
from test_torch_lm_model import _recording_moe as recording_moe
from test_torch_lm_model import _ref_params, chip_smoke

ARCHS = list(tcfg.LM_ARCHS)
NAMES = [a + "-smoke" for a in ARCHS]
# the MoE configs' steps are in test_torch_lm_train_moe.py, so that the
# reference's compiles spread over two workers
MOE = [n for n in NAMES if tcfg.get_config(n).moe]
DENSE = [n for n in NAMES if n not in MOE]
DTYPES = ["float32", "bfloat16"]
STEPS = [0, 2000]
B, S = 4, 32
TOL = {
    "float32": dict(loss=1e-5, grad_norm=1e-5, states=1e-4, params=1e-5),
    "bfloat16": dict(loss=2 ** -5, grad_norm=2 ** -5, states=2 ** -4,
                     params=2 ** -8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def mesh11():
    return compat.make_mesh((1, 1), ("data", "model"))


def cfgs(name, dtype, optimizer=None):
    """Both packages' config in ``dtype``, with ``optimizer`` where given
    (the smoke configs all train with AdamW; three full ones with
    Adafactor)."""
    kw = dict(dtype=dtype)
    if optimizer:
        kw["optimizer"] = optimizer
    return (dataclasses.replace(jcfg.get_config(name), **kw),
            dataclasses.replace(tcfg.get_config(name), **kw))


@functools.lru_cache(maxsize=None)
def ref_params(name, dtype):
    """The reference's parameters (drawn in float32 by the model test,
    cast), as numpy."""
    return jax.tree.map(lambda a: np.asarray(a.astype(dtype)),
                        _ref_params(name))


def n_moe_layers(cfg):
    return cfg.n_layers - cfg.first_dense_layers if cfg.moe else 0


def forward_records(records, cfg, calls):
    """The forward calls' records among ``calls`` value-and-grad passes:
    each pass records its MoE layers in order, then again in the
    backward's recompute in reverse order (asserted equal)."""
    n = n_moe_layers(cfg)
    assert len(records) == 2 * n * calls
    out = []
    for c in range(calls):
        fwd = records[2 * n * c: 2 * n * c + n]
        rec = records[2 * n * c + n: 2 * n * (c + 1)]
        for (f, _), (r, _) in zip(fwd, reversed(rec)):
            np.testing.assert_array_equal(f, r)
        out += fwd
    return out


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference_step_fn(name, dtype, optimizer=None):
    """The reference's jitted step (one compile a config and dtype: the
    step number is traced) and the list its router callback appends to."""
    cfg, _ = cfgs(name, dtype, optimizer)
    fn, info = jsteps.build_lm_train_step(cfg, mesh11())
    return fn, info, []


@functools.lru_cache(maxsize=None)
def reference_step(name, dtype, step, optimizer=None):
    cfg, _ = cfgs(name, dtype, optimizer)
    batch = TokenPipeline(cfg.vocab, B, S).next_batch()
    fn, info, records = reference_step_fn(name, dtype, optimizer)
    jp = jax.tree.map(jnp.asarray, ref_params(name, dtype))
    opt = info["opt_init"](jp)
    records.clear()
    with mock.patch.object(jtr, "moe_apply", recording_moe(records)):
        p2, o2, m = fn(jp, opt, {k: jnp.asarray(v) for k, v in batch.items()},
                       step)
        jax.block_until_ready(m)
    jax.effects_barrier()
    nm = B // min(cfg.microbatch_size, B)
    return dict(batch=batch, out=(as_numpy(p2), as_numpy(o2),
                                  {k: float(v) for k, v in m.items()}),
                routes=forward_records(records, cfg, nm))


def flat(*trees):
    return [x for t in trees for x in chip_smoke._lm_leaves(t)]


def port_step(name, dtype, step, remat=True, optimizer=None):
    ref = reference_step(name, dtype, step, optimizer)
    _, cfg = cfgs(name, dtype, optimizer)
    cfg = dataclasses.replace(cfg, remat=remat)
    params = convert.params_from_numpy(ref_params(name, dtype), device="cpu")
    fn, info = tsteps.build_lm_train_step(cfg, device="cpu")
    opt = info["opt_init"](params)
    seen = []
    with chip_smoke.lm_routes(list(ref["routes"]), seen):
        p2, o2, m = fn(params, opt, ref["batch"], step)
    return (p2, o2, {k: float(v) for k, v in m.items()}), seen


def check_step(name, dtype, step, optimizer=None):
    ref = reference_step(name, dtype, step, optimizer)
    got, seen = port_step(name, dtype, step, optimizer=optimizer)
    cfg = cfgs(name, dtype, optimizer)[1]
    errs, ok = chip_smoke.lm_step_errs(got, ref["out"], cfg, step, TOL[dtype])
    assert ok, errs
    assert set(got[2]) == set(ref["out"][2])
    assert ("grad_norm" in got[2]) == (cfg.optimizer == "adamw")
    # the port's own router choices: the reference's, or ties
    flips = chip_smoke.lm_flips(ref["routes"], seen,
                                chip_smoke.LM_TIE[dtype])
    assert flips is not None
    assert len(seen) == len(ref["routes"])


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_train_step_matches_the_reference(name, dtype, step):
    check_step(name, dtype, step)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_adafactor_train_step_matches_the_reference(dtype, step):
    """Adafactor, as qwen1.5-110b, grok-1 and deepseek-v3 train at full
    size, on qwen1.5's smoke config: factored ``vr`` / ``vc`` states of
    the stacked (L, d_in, d_out) leaves, full ``v`` of the vectors."""
    check_step("qwen1.5-110b-smoke", dtype, step, optimizer="adafactor")


def check_remat_off(name):
    """``cfg.remat`` changes where activations come from, not a bit of the
    step (an MoE one under teacher-forced routing)."""
    on, _ = port_step(name, "bfloat16", 2000, remat=True)
    off, _ = port_step(name, "bfloat16", 2000, remat=False)
    for a, b in zip(flat(*on[:2]), flat(*off[:2])):
        assert torch.equal(a, b)
    assert on[2] == off[2]


def test_remat_off_gives_the_same_step():
    check_remat_off("qwen2-0.5b-smoke")


def test_an_uneven_batch_raises():
    _, cfg = cfgs("qwen2-0.5b-smoke", "float32")
    params = ttr.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    fn, info = tsteps.build_lm_train_step(cfg, device="cpu")
    batch = TokenPipeline(cfg.vocab, 3, 8).next_batch()
    with pytest.raises(ValueError, match="microbatches of 2"):
        fn(params, info["opt_init"](params), batch, 0)


def test_compress_grads_is_accepted_and_unused():
    """The reference's ``compress_grads`` is never read (copied, not
    repaired): the same step either way."""
    _, cfg = cfgs("qwen2-0.5b-smoke", "float32")
    params = ttr.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = TokenPipeline(cfg.vocab, B, S).next_batch()
    outs = []
    for flag in (False, True):
        fn, info = tsteps.build_lm_train_step(cfg, compress_grads=flag,
                                              device="cpu")
        outs.append(fn(params, info["opt_init"](params), batch, 2000))
    for a, b in zip(flat(*outs[0]), flat(*outs[1])):
        assert torch.equal(a, b)


def test_the_step_leaves_its_inputs_as_they_were():
    _, cfg = cfgs("qwen2-0.5b-smoke", "float32")
    params = ttr.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    fn, info = tsteps.build_lm_train_step(cfg, device="cpu")
    opt = info["opt_init"](params)
    before = [t.clone() for t in flat(params, opt)]
    p2, o2, _ = fn(params, opt, TokenPipeline(cfg.vocab, B, S).next_batch(),
                   2000)
    for a, b in zip(flat(params, opt), before):
        assert torch.equal(a, b) and not a.requires_grad
    assert not any(t.requires_grad for t in flat(p2, o2))


@pytest.mark.parametrize("step", STEPS)
def test_the_schedules_agree_at_the_compared_steps(step):
    """The steps the tests compare are ones where the port's float64
    cosine and XLA's float32 one give the same rate."""
    sched_j = jcosine(3e-4, 2000, 100_000)
    sched_t = tcosine(3e-4, 2000, 100_000)
    assert float(sched_t(step)) == float(sched_j(step))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_opt_specs_equal_the_reference(name, mesh):
    """AdamW's and Adafactor's state specs, factored leaves included, on
    the logical meshes of the parameter-spec test."""
    ref_mesh, my_mesh = _meshes(mesh)
    cfg_j, cfg_t = jcfg.get_config(name), tcfg.get_config(name)
    dummy_j = jax.eval_shape(lambda k: jtr.lm_init(k, cfg_j),
                             jax.random.key(0))
    dummy_t = ttr.lm_init(None, cfg_t, device="meta")
    pspecs_j = jsteps.lm_param_specs(dummy_j, cfg_j, mesh=ref_mesh)
    pspecs_t = tsteps.lm_param_specs(dummy_t, cfg_t, mesh=my_mesh)
    for opt in ("adamw", "adafactor"):
        init_j = jmake(opt, 1e-3)[0]
        init_t = tmake(opt, 1e-3)[0]
        ref = {p: tuple(s) for p, s in _leaves(jsteps._opt_specs(
            jax.eval_shape(init_j, dummy_j), pspecs_j)).items()}
        mine = _leaves(tsteps._opt_specs(init_t(dummy_t), pspecs_t))
        assert mine == ref, opt
        if opt == "adafactor":
            assert any(p.endswith("/vr") for p in mine)


def test_train_step_info_holds_the_references_keys_without_allocating():
    cfg = tcfg.get_config("qwen2-0.5b")
    mesh = LogicalMesh((16, 16), ("data", "model"))
    _, info = tsteps.build_lm_train_step(cfg, mesh, device="cpu")
    assert set(info) == {"params", "opt", "opt_init", "dummy", "opt_shape"}
    assert info["opt"]["m"]["lm_head"]["w"] == ("data", "model")
    assert info["opt"]["v"] == info["params"]
    for t in flat(info["dummy"], info["opt_shape"]):
        assert t.device.type == "meta"
