"""The port's LM layers against the JAX package's, on the same inputs.

``nn`` (dense, mlp, rmsnorm, layernorm, embed), RoPE at fractions 1, 0.5
and one that rounds down to an even width, ``causal_attention`` across
chunkings, GQA groups and ``dv != dh``, ``decode_attention`` at every
cache length, ``quantize_kv`` (codes round half to even) and
``moe_apply`` with drops and a shared expert.  Inputs and parameters are
drawn by numpy from a seed, in the shapes and ranges of the reference's
inits, and fed to both packages; the reference runs eagerly, one operation at a
time, as the port does.

Tolerances, elementwise ``|mine - ref| <= tol · (1 + |ref|)``:

* float32, ``1e-5``: the same operations in another order of summation
  (the port's products are torch's, the reference's XLA's); the largest
  error seen is ~1e-6.
* bfloat16, ``2**-7`` — one bfloat16 unit in the last place at ``|ref|``
  up to 1: both packages round every operation to bfloat16 (the port
  takes the reference's float32 products as float32 products of upcast
  operands, and a Python scalar in the tensor's dtype), so only the
  float32 summation order of a product can move a result by one unit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import attention as jatt
from repro.models import nn as jnn
from repro_torch.models import attention as tatt
from repro_torch.models import nn as tnn
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
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    holding the same values."""
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
    if isinstance(mine, torch.Tensor) and not isinstance(ref, np.ndarray):
        assert str(mine.dtype).removeprefix("torch.") == np.dtype(
            ref.dtype).name
    err = np.abs(a - b) / (1 + np.abs(b))
    assert err.max() <= TOL[dtype], err.max()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _uniform_tree(shapes, dtype, seed):
    """A parameter dict of ``shapes``, uniform ±1/√(fan-in) as the
    reference's inits draw (numpy here: ``jax.random`` compiles each
    shape eagerly, seconds apiece), as JAX arrays of ``dtype``."""
    rng = _rng(seed)
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _uniform_tree(v, dtype, seed + 1)
        else:
            s = v[-2] ** -0.5 if len(v) > 1 else 1.0
            out[k] = jnp.asarray(rng.uniform(-s, s, v)).astype(dtype)
    return out


# ----------------------------------------------------------------------
# nn
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [False, True])
def test_dense(dtype, bias):
    rng = _rng(1)
    p = {"w": rng.uniform(-0.2, 0.2, (24, 40)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(size=(40,)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), p)
    xj, xt = _pair(rng.normal(size=(3, 5, 24)), dtype)
    assert_close(tnn.dense(_tree(jp), xt), jnn.dense(jp, xj), dtype)


def test_dense_promotes_a_float32_input_against_bfloat16_weights():
    """The router's case: float32 x against bfloat16 w computes in
    float32, as ``jnp`` promotes (``torch.matmul`` refuses two dtypes)."""
    rng = _rng(2)
    jp = {"w": jnp.asarray(rng.normal(size=(16, 8))).astype(jnp.bfloat16)}
    xj, xt = _pair(rng.normal(size=(4, 16)), "float32")
    mine, ref = tnn.dense(_tree(jp), xt), jnn.dense(jp, xj)
    assert mine.dtype == torch.float32 and ref.dtype == jnp.float32
    assert_close(mine, ref, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    dims = [12, 20, 20, 6]
    jp = _uniform_tree({f"l{i}": {"w": (dims[i], dims[i + 1]),
                                  "b": (dims[i + 1],)} for i in range(3)},
                       dtype, 3)
    xj, xt = _pair(_rng(3).normal(size=(7, 12)), dtype)
    assert_close(tnn.mlp(_tree(jp), xt), jnn.mlp(jp, xj), dtype)
    assert_close(tnn.mlp(_tree(jp), xt, final_act=True),
                 jnn.mlp(jp, xj, final_act=True), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_silu_rounds_as_the_reference(dtype):
    xj, xt = _pair(_rng(4).normal(size=(4096,)) * 4, dtype)
    assert_close(tnn.silu(xt), jax.nn.silu(xj), dtype)
    if dtype == "bfloat16":  # F.silu rounds once and differs
        assert np.array_equal(_np(tnn.silu(xt)), _np(jax.nn.silu(xj)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(dtype, norm):
    rng = _rng(5)
    d = 48
    p = {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.normal(size=d).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), p)
    xj, xt = _pair(rng.normal(size=(3, 6, d)) * 3 + 1, dtype)
    mine = getattr(tnn, norm)(_tree(jp), xt)
    ref = getattr(jnn, norm)(jp, xj)
    assert mine.dtype == xt.dtype
    assert_close(mine, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_lookup_and_init_shapes(dtype):
    jp = jnn.embed_init(jax.random.key(6), 50, 8, dtype)
    ids = _rng(6).integers(0, 50, (3, 5)).astype(np.int32)
    table = _tree(jp)["table"]
    assert_close(table[torch.from_numpy(ids).long()],
                 jp["table"][jnp.asarray(ids)], dtype)
    g = torch.Generator().manual_seed(0)
    mine = tnn.embed_init(g, 50, 8, getattr(torch, dtype), "cpu")["table"]
    assert mine.shape == (50, 8) and mine.dtype == getattr(torch, dtype)
    d = tnn.dense_init(g, 400, 300, bias=True, device="cpu")
    assert d["w"].abs().max() <= 400 ** -0.5 and not d["b"].any()
    assert abs(float(d["w"].std()) - 400 ** -0.5 / 3 ** 0.5) < 2e-3


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fraction,dh", [(1.0, 16), (0.5, 16), (0.3, 16),
                                         (1.0, 8), (0.5, 12), (0.1, 8)])
def test_rope(dtype, fraction, dh):
    """Interleaved pairs on ``int(dh · fraction)`` rounded down to even
    (0.3 · 16 → 4, 0.5 · 12 → 6, 0.1 · 8 → 0: no rotation)."""
    rng = _rng(7)
    xj, xt = _pair(rng.normal(size=(2, 9, 3, dh)), dtype)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    mine = tatt.apply_rope(xt, torch.from_numpy(pos), fraction=fraction)
    ref = jatt.apply_rope(xj, jnp.asarray(pos), fraction=fraction)
    assert_close(mine, ref, dtype)
    rot = int(dh * fraction) // 2 * 2
    assert torch.equal(mine[..., rot:], xt[..., rot:])


def test_rope_is_interleaved_not_rotate_half():
    """Position 1 rotates the pair (x0, x1), not (x0, x_{dh/2})."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    out = tatt.apply_rope(x, torch.ones(1, 1, dtype=torch.long))
    assert out[..., 1].item() == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[..., 4].item() == 0.0


def test_rope_angles():
    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    assert_close(tatt.rope_angles(torch.from_numpy(pos), 12, 500000.0),
                 jatt.rope_angles(jnp.asarray(pos), 12, 500000.0),
                 "float32")


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
CHUNKS = [(512, 1024), (4, 8), (8, 4), (1, 16)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q_chunk,kv_chunk", CHUNKS)
@pytest.mark.parametrize("h,kvh,dh,dv", [(4, 2, 16, 16), (6, 1, 8, 8),
                                         (4, 4, 24, 16)])
def test_causal_attention(dtype, q_chunk, kv_chunk, h, kvh, dh, dv):
    rng = _rng(8)
    b, s = 2, 16
    qj, qt = _pair(rng.normal(size=(b, s, h, dh)), dtype)
    kj, kt = _pair(rng.normal(size=(b, s, kvh, dh)), dtype)
    vj, vt = _pair(rng.normal(size=(b, s, kvh, dv)), dtype)
    kw = dict(q_chunk=q_chunk, kv_chunk=kv_chunk)
    mine = tatt.causal_attention(qt, kt, vt, **kw)
    ref = jatt.causal_attention(qj, kj, vj, **kw)
    assert mine.shape == (b, s, h, dv)
    assert_close(mine, ref, dtype)


def test_causal_attention_nq_multiple():
    rng = _rng(9)
    qj, qt = _pair(rng.normal(size=(1, 24, 4, 8)), "float32")
    kj, kt = _pair(rng.normal(size=(1, 24, 2, 8)), "float32")
    vj, vt = _pair(rng.normal(size=(1, 24, 2, 8)), "float32")
    kw = dict(q_chunk=512, kv_chunk=6, nq_multiple=4)
    assert tatt.chunk_sizes(24, 512, 6, 4) == (6, 6)
    assert_close(tatt.causal_attention(qt, kt, vt, **kw),
                 jatt.causal_attention(qj, kj, vj, **kw), "float32")


@pytest.mark.parametrize("s,q_chunk,kv_chunk", [(12, 8, 4), (12, 4, 8),
                                                (10, 4, 10)])
def test_chunks_that_do_not_divide_raise(s, q_chunk, kv_chunk):
    """The reference asserts (gone under ``-O``); the port raises."""
    x = np.zeros((1, s, 2, 4), np.float32)
    with pytest.raises(AssertionError):
        jatt.causal_attention(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    t = torch.zeros(1, s, 2, 4)
    with pytest.raises(ValueError, match="must both divide"):
        tatt.causal_attention(t, t, t, q_chunk=q_chunk, kv_chunk=kv_chunk)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,kvh", [(4, 2), (4, 4), (6, 1)])
def test_decode_attention_at_every_cache_length(dtype, h, kvh):
    rng = _rng(10)
    b, s, dh = 3, 10, 8
    qj, qt = _pair(rng.normal(size=(b, h, dh)), dtype)
    kj, kt = _pair(rng.normal(size=(b, s, kvh, dh)), dtype)
    vj, vt = _pair(rng.normal(size=(b, s, kvh, dh)), dtype)
    for n in range(1, s + 1):
        lens = np.array([n, max(1, n - 3), s], np.int32)
        mine = tatt.decode_attention(qt, kt, vt, torch.from_numpy(lens))
        ref = jatt.decode_attention(qj, kj, vj, jnp.asarray(lens))
        assert_close(mine, ref, dtype)


def test_decode_attention_ignores_slots_past_the_length():
    rng = _rng(11)
    q = torch.from_numpy(rng.normal(size=(1, 2, 4)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 6, 1, 4)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 6, 1, 4)).astype(np.float32))
    out = tatt.decode_attention(q, k, v, torch.tensor([3]))
    k2, v2 = k.clone(), v.clone()
    k2[:, 3:], v2[:, 3:] = 1e4, -1e4
    assert torch.equal(out, tatt.decode_attention(q, k2, v2,
                                                  torch.tensor([3])))


# ----------------------------------------------------------------------
# the int8 cache codes
# ----------------------------------------------------------------------
def test_quantize_kv_rounds_half_to_even():
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    qt, st = tatt.quantize_kv(torch.from_numpy(x))
    qj, sj = jatt.quantize_kv(jnp.asarray(x))
    assert qt.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert st.dtype == torch.float32 and float(st) == float(sj[0, 0]) == 1.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_kv_and_back(dtype):
    xj, xt = _pair(_rng(12).normal(size=(2, 7, 3, 16)) * 2, dtype)
    qt, st = tatt.quantize_kv(xt)
    qj, sj = jatt.quantize_kv(xj)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    for out in ("bfloat16", "float32"):
        mine = tatt.dequantize_kv(qt, st, getattr(torch, out))
        ref = jatt.dequantize_kv(qj, sj, getattr(jnp, out))
        assert np.array_equal(_np(mine), _np(ref))


def test_quantize_kv_of_a_zero_row():
    q, s = tatt.quantize_kv(torch.zeros(1, 4))
    assert not q.any() and float(s) == pytest.approx(1e-8 / 127.0)
