"""The port's MoE layer against the JAX package's, on the same inputs.

``moe_apply`` — the float32 router, its top k, the sort-based capacity
dispatch with drops into the pad row, the grouped expert SwiGLU, the
``index_add_`` back, a shared expert and the Switch aux loss — and
``swiglu_apply`` with and without an expert dimension.  Inputs and
parameters are drawn by numpy from a seed, in the shapes and ranges of
the reference's inits, and fed to both packages; the reference runs
eagerly, one operation at a time, as the port does.  The router's top-k
choice is checked ``==`` before any output, so a near-tie flip shows as
a flip, not as a tolerance failure.

Tolerances, elementwise ``|mine - ref| <= tol · (1 + |ref|)``: float32
``1e-5`` (another order of summation; ~1e-6 seen), bfloat16 ``2**-7``
(one bfloat16 unit at ``|ref|`` up to 1: every operation is rounded to
bfloat16 in both packages, so only a product's float32 summation order
can move a result by one unit); the aux loss within ``1e-6`` relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import moe as jmoe
from repro.models import nn as jnn
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(a, dtype):
    j = jnp.asarray(a).astype(dtype)
    return j, params_from_numpy(np.asarray(j), device="cpu")


def _tree(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(mine, ref, dtype):
    a, b = _np(mine), _np(ref)
    assert a.shape == b.shape
    err = np.abs(a - b) / (1 + np.abs(b))
    assert err.max() <= TOL[dtype], err.max()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _uniform_tree(shapes, dtype, seed):
    """A parameter dict of ``shapes``, uniform ±1/√(fan-in) as the
    reference's inits draw, as JAX arrays of ``dtype``."""
    rng = _rng(seed)
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _uniform_tree(v, dtype, seed + 1)
        else:
            s = v[-2] ** -0.5 if len(v) > 1 else 1.0
            out[k] = jnp.asarray(rng.uniform(-s, s, v)).astype(dtype)
    return out


def _swiglu_shapes(d, ff, n_experts=0):
    lead = (n_experts,) if n_experts else ()
    return {"w_gate": (*lead, d, ff), "w_in": (*lead, d, ff),
            "w_out": (*lead, ff, d)}


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------
MOE_CASES = {  # name: (tokens, d, experts, top_k, moe_d_ff, shared)
    "decode_b2": (2, 16, 8, 2, 24, 0),  # cap 1: drops
    "decode_b2_shared": (2, 16, 8, 2, 24, 1),
    "prefill": (32, 16, 4, 2, 24, 0),
    "prefill_shared": (32, 16, 8, 2, 12, 1),
    "top1": (24, 8, 4, 1, 16, 0),
    "skewed": (40, 16, 4, 2, 24, 2),
}


def _moe_inputs(case, dtype, seed=13):
    t, d, e, k, ff, shared = MOE_CASES[case]
    shapes = {"router": {"w": (d, e)},
              "experts": _swiglu_shapes(d, ff, e)}
    if shared:
        shapes["shared"] = _swiglu_shapes(d, shared * ff)
    jp = _uniform_tree(shapes, dtype, seed)
    x = _rng(seed).normal(size=(t, d))
    if case == "skewed":  # most tokens prefer one expert: heavy drops
        x = x + 3 * np.asarray(jp["router"]["w"], np.float32)[:, 0]
    xj, xt = _pair(x, dtype)
    return jp, _tree(jp), xj, xt, k


def _ref_top_i(jp, xj, k):
    probs = jax.nn.softmax(jnn.dense(jp["router"], xj.astype(jnp.float32)))
    return np.asarray(jax.lax.top_k(probs, k)[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply(case, dtype):
    jp, tp, xj, xt, k = _moe_inputs(case, dtype)
    _, _, top_i = tmoe.route(tp, xt, k)
    assert np.array_equal(top_i.numpy(), _ref_top_i(jp, xj, k))
    y, aux = tmoe.moe_apply(tp, xt, top_k=k)
    yj, auxj = jmoe.moe_apply(jp, xj, top_k=k)
    assert y.dtype == xt.dtype and aux.dtype == torch.float32
    assert_close(y, yj, dtype)
    assert float(aux) == pytest.approx(float(auxj), rel=1e-6)


@pytest.mark.parametrize("case", ["decode_b2", "skewed"])
def test_moe_drops_tokens_past_capacity(case):
    """A smoke decode (B = 2, k = 2, E = 8) keeps one token an expert."""
    t, _, e, k, _, _ = MOE_CASES[case]
    cap = tmoe.capacity(t, k, e)
    assert cap == max(1, int(1.25 * t * k / e))
    _, tp, _, xt, _ = _moe_inputs(case, "float32")
    _, _, top_i = tmoe.route(tp, xt, k)
    load = torch.bincount(top_i.reshape(-1), minlength=e)
    assert int((load - cap).clamp_min(0).sum()) > 0  # something is dropped
    if case == "decode_b2":
        assert cap == 1


def test_moe_top_k_breaks_ties_toward_the_lower_index():
    """Equal router probabilities: the reference's ``lax.top_k`` picks the
    lower expert index; so does the port (``torch.topk`` does not
    promise it)."""
    p = {"router": {"w": torch.zeros(4, 6)}}
    _, top_p, top_i = tmoe.route(p, torch.ones(3, 4), 3)
    assert top_i.tolist() == [[0, 1, 2]] * 3
    jp = {"router": {"w": jnp.zeros((4, 6))}}
    assert np.array_equal(top_i.numpy(),
                          _ref_top_i(jp, jnp.ones((3, 4)), 3))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_experts", [0, 3])
def test_swiglu(dtype, n_experts):
    jp = _uniform_tree(_swiglu_shapes(12, 20, n_experts), dtype, 14)
    shape = (n_experts, 5, 12) if n_experts else (5, 12)
    xj, xt = _pair(_rng(14).normal(size=shape), dtype)
    assert_close(tmoe.swiglu_apply(_tree(jp), xt),
                 jmoe.swiglu_apply(jp, xj), dtype)
    mine = tmoe.swiglu_init(torch.Generator().manual_seed(0), 12, 20,
                            n_experts=n_experts, device="cpu")
    ref = jax.eval_shape(lambda k: jmoe.swiglu_init(
        k, 12, 20, n_experts=n_experts), jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
