"""The port's LM gradients against the JAX package's, with carried weights.

For each of the five ``-smoke`` configs in float32 and in the configured
bfloat16: the reference's ``lm_init`` parameters carried over bit for
bit, and one seeded microbatch of 2 x 32 tokens and labels.  The port's
``lm_loss`` gradients (``torch.autograd.grad``, remat on as every config
sets it) are held, leaf by leaf, to ``jax.grad`` of the reference's
``lm_loss`` under ``jax.jit``.  MoE routing is teacher-forced with the
reference's forward choices (``chip_smoke.lm_routes``; the reference's
callback fires again in the backward's recompute, in reverse layer order,
and those records equal the forward's).

The measure is ``‖port - ref‖ / ‖ref‖`` of each leaf:

* float32, ``1e-4`` (the largest seen is 1.1e-6: the same operations
  summed in another order through two or three layers and back);
* bfloat16, ``2**-5`` (the largest seen is 0.019, on a k bias of
  qwen2, whose gradient is near zero: RoPE leaves a k bias almost no
  effect on the scores).  The reference's jitted backward fuses chains of
  bfloat16 operations and rounds fewer intermediates than the port, which
  rounds each as the eager reference does; a gradient goes through every
  layer's forward and backward, a few bfloat16 units (2**-8 relative
  each) on the way.

Remat on and off give ``==`` gradients in the port: the recompute runs
the same operations on the same bits (the stable sort and
``searchsorted`` of the MoE dispatch included, and ``xe[slot] = x[st]``
writes duplicates only into the discarded pad row).
"""
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import transformer as jtr
import repro_torch.configs as tcfg
from repro_torch.models import convert
from repro_torch.models import transformer as ttr
from repro_torch.optim._tree import tree_leaves

from test_torch_lm_train_step import (cfgs, chip_smoke, forward_records,
                                      recording_moe, ref_params)

NAMES = [a + "-smoke" for a in tcfg.LM_ARCHS]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 2 ** -5}
B, S = 2, 32


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
def reference(name, dtype):
    """The inputs, the reference's loss and gradients (numpy leaves in
    sorted key order) and its forward router records."""
    cfg, _ = cfgs(name, dtype)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    records = []
    grad = jax.jit(jax.value_and_grad(
        lambda p, t, lab: jtr.lm_loss(p, cfg, t, lab)[0]))
    with mock.patch.object(jtr, "moe_apply", recording_moe(records)):
        loss, g = grad(jax.tree.map(jnp.asarray, ref_params(name, dtype)),
                       tokens, labels)
        jax.block_until_ready(g)
    jax.effects_barrier()
    fwd = forward_records(records, cfg, 1)
    # jax's leaves of a dict are in sorted key order, as tree_leaves' are
    leaves = [np.asarray(x, np.float64) for x in jax.tree.leaves(g)]
    return dict(tokens=tokens, labels=labels, loss=float(loss),
                grads=leaves, routes=fwd)


def port_grads(name, dtype, remat=True):
    ref = reference(name, dtype)
    _, cfg = cfgs(name, dtype)
    cfg = dataclasses.replace(cfg, remat=remat)
    params = convert.params_from_numpy(ref_params(name, dtype), device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    seen = []
    with chip_smoke.lm_routes(list(ref["routes"]), seen):
        loss, _ = ttr.lm_loss(params, cfg, torch.from_numpy(ref["tokens"]),
                              torch.from_numpy(ref["labels"]))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return float(loss.detach()), grads, seen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_the_reference(name, dtype):
    ref = reference(name, dtype)
    loss, grads, seen = port_grads(name, dtype)
    assert len(grads) == len(ref["grads"])
    worst = 0.0
    for g, r in zip(grads, ref["grads"]):
        assert g.dtype == getattr(torch, dtype)  # the parameters' dtype
        assert tuple(g.shape) == r.shape
        err = np.linalg.norm(g.double().numpy() - r) / max(
            np.linalg.norm(r), 1e-30)
        worst = max(worst, err)
    assert worst <= TOL[dtype], worst
    assert chip_smoke.lm_err(loss, ref["loss"]) <= TOL[dtype]
    assert chip_smoke.lm_flips(ref["routes"], seen,
                               chip_smoke.LM_TIE[dtype]) is not None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_remat_on_and_off_give_equal_gradients(name, dtype):
    on = port_grads(name, dtype, remat=True)
    off = port_grads(name, dtype, remat=False)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a, b)
    # a recompute under remat is its forward's call, not a new one
    assert len(on[2]) == len(off[2]) == len(reference(name, dtype)["routes"])


def test_remat_checkpoints_each_layer_only_under_grad(monkeypatch):
    """Under grad every layer of both stacks runs inside
    ``torch.utils.checkpoint`` and the MTP layer does not; without grad
    (prefill, decode, the serving loss) none does."""
    _, cfg = cfgs("deepseek-v3-671b-smoke", "float32")
    params = ttr.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    calls = []
    own = ttr.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return own(fn, *args, **kw)

    monkeypatch.setattr(ttr, "checkpoint", counted)
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with torch.no_grad():
        ttr.lm_loss(params, cfg, tokens, tokens)
    assert calls == []
    ttr.lm_loss(params, cfg, tokens, tokens)[0].backward()
    assert len(calls) == cfg.n_layers
    calls.clear()
    ttr.lm_loss(params, dataclasses.replace(cfg, remat=False), tokens,
                tokens)
    assert calls == []


def test_stacked_gradients_come_back_through_one_unbind():
    """Each stack is unbound once a forward: its gradient is one stack of
    the layers' gradients, not a sum of per-layer zero-padded selects."""
    _, cfg = cfgs("qwen2-0.5b-smoke", "float32")
    params = ttr.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    w = params["layers"]["attn"]["wq"]["w"].requires_grad_(True)
    loss, _ = ttr.lm_loss(params, cfg, torch.zeros((1, 8), dtype=torch.int32),
                          torch.ones((1, 8), dtype=torch.int32))
    consumers, seen = [], set()

    def walk(fn):
        if fn is None or fn in seen:
            return
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if getattr(nxt, "variable", None) is w:
                consumers.append(type(fn).__name__)
            walk(nxt)

    walk(loss.grad_fn)
    assert consumers == ["UnbindBackward0"]
