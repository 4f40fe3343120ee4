"""The port's transformer against the JAX package's, with carried weights.

For each of the five ``-smoke`` configs — qwen2, qwen1.5, chatglm3
(partial RoPE), grok-1 (MoE) and deepseek-v3 (MLA, MoE, dense-first
layers, MTP) — in float32 and in the configured bfloat16: the
reference's ``lm_init`` parameters, exported to numpy and carried over
by ``params_from_numpy`` (bit for bit in bfloat16), and the same seeded
tokens go through both packages.  Held to the reference: ``lm_forward``'s
hidden states, ``lm_loss`` and its metrics, the prefill step's token, and
eight decode steps — logits, caches and greedy tokens — on a cache of
six slots, so the last two steps write past its end (the reference's
``dynamic_update_slice`` clamps the write into the last slot).  The
parameters are drawn once a config, in float32 (the bfloat16 set is the
same draw cast by JAX: ``ml_dtypes`` arrays).  The reference runs each
function under ``jax.jit``, as its step builders do; the decode steps
feed both packages the reference's own greedy tokens, so a flipped
argmax cannot cascade.

Tolerances, elementwise ``|mine - ref| <= tol · (1 + |ref|)``:

* float32, ``1e-4`` everywhere: the same operations summed in another
  order over two or three layers (the largest error seen is ~2e-6).
* bfloat16, ``2**-4`` for hidden states and caches, ``2**-5`` for logits,
  the loss and its metrics: the reference's jitted layer fuses chains of
  bfloat16 operations and rounds fewer intermediates than the port,
  which rounds every operation as the reference does eagerly (the layer
  tests hold that to one unit); over two or three residual layers the
  differences grow to a few bfloat16 units (2**-7 relative each).  The
  largest seen: hidden states 0.021 and caches 0.025 (deepseek), logits
  0.016, the loss and metrics 2.1e-4.

Greedy tokens are compared ``==`` wherever the reference's top-two
logit margin exceeds twice the logits' tolerance; below it a tie within
rounding may break either way.

MoE routing is teacher-forced the same way.  The reference's router
choice in every MoE layer of every call is recorded (a
``jax.debug.callback`` around its ``moe_apply``, the module's own code
unchanged) and the port's ``moe.route`` is handed it, so a near-tie flip
— one bfloat16 unit in a router input can swap two experts whose
probabilities differ by less — cannot cascade through the shared
expert capacity into every later token.  The port's own choice is held
to the reference's separately: equal, or a tie within ``TIE`` of the
reference's own probabilities.  The error, margin and routing helpers
are ``chip_smoke.py``'s, which holds the card to the CPU the same way.
"""
import dataclasses
import functools
import importlib.util
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfg
from repro.models import nn as jnn
from repro.models import transformer as jtr
import repro_torch.configs as tcfg
from repro_torch.models import convert, steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import nn as tnn
from repro_torch.models import transformer as ttr

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
_err = chip_smoke.lm_err
forced_routes = chip_smoke.lm_routes

NAMES = [a + "-smoke" for a in tcfg.LM_ARCHS]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 2 ** -4}  # hidden states, caches
TOL_LOGITS = {"float32": 1e-4, "bfloat16": 2 ** -5}  # logits, loss, metrics
# a router flip: the two experts' reference probabilities within this
# fraction of each other
TIE = {"float32": 1e-5, "bfloat16": 2 ** -7}
B, S, MAX_LEN, STEPS = 2, 16, 6, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(name, dtype):
    return (dataclasses.replace(jcfg.get_config(name), dtype=dtype),
            dataclasses.replace(tcfg.get_config(name), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    cfg, _ = _cfgs(name, "float32")
    return jax.jit(lambda k: jtr.lm_init(k, cfg))(jax.random.key(0))


def _recording_moe(records):
    """The reference's ``moe_apply``, recording each call's router choice
    and probabilities (in call order) on the host."""
    orig = jtr.moe_apply

    def moe_apply(p, x, *, top_k, **kw):
        probs = jax.nn.softmax(jnn.dense(p["router"], x.astype(jnp.float32)))
        _, top_i = jax.lax.top_k(probs, top_k)
        jax.debug.callback(
            lambda i, pr: records.append((np.array(i), np.array(pr))),
            top_i, probs, ordered=True)
        return orig(p, x, top_k=top_k, **kw)

    return moe_apply


@functools.lru_cache(maxsize=None)
def reference(name, dtype):
    """The reference's parameters (numpy), inputs and outputs, once per
    config and dtype; ``routes`` holds the router records of the forward
    pass and of each decode step."""
    cfg, _ = _cfgs(name, dtype)
    params = jax.tree.map(lambda a: a.astype(dtype), _ref_params(name))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    routes = {"forward": [], "loss": [], "decode": []}
    records = []  # appended by the traced callbacks, call after call
    patch = mock.patch.object(jtr, "moe_apply", _recording_moe(records))

    def recorded(key, fn, *args):
        with patch:
            out = jax.block_until_ready(fn(*args))
        jax.effects_barrier()
        routes[key].append(records[:])
        records.clear()
        return out

    @jax.jit
    def forward(p, t):
        h, aux = jtr.lm_forward(p, cfg, t)
        return h, aux, jnn.dense(p["lm_head"], h[:, -1])  # prefill logits

    loss_fn = jax.jit(lambda p, t, lab: jtr.lm_loss(p, cfg, t, lab))
    decode = jax.jit(lambda p, t, c, n: jtr.lm_decode_step(p, cfg, t, c, n))
    h, aux, last = recorded("forward", forward, params, tokens)
    loss, metrics = recorded("loss", loss_fn, params, tokens, labels)
    cache = jtr.init_kv_cache(cfg, B, MAX_LEN)
    tok, feed, logits, caches, greedy = tokens[:, 0], [], [], [], []
    for i in range(STEPS):
        feed.append(np.array(tok))
        nt, lg, cache = recorded("decode", decode, params, jnp.asarray(tok),
                                 cache, jnp.full((B,), i, jnp.int32))
        logits.append(np.asarray(lg))
        caches.append(jax.tree.map(np.asarray, cache))
        greedy.append(np.asarray(nt))
        tok = nt
    return dict(
        params=jax.tree.map(np.asarray, params), tokens=tokens,
        labels=labels, hidden=np.asarray(h), aux=float(aux),
        last=np.asarray(last), loss=float(loss),
        metrics={k: float(v) for k, v in metrics.items()},
        feed=feed, logits=logits, caches=caches, greedy=greedy,
        routes=routes)


@functools.lru_cache(maxsize=None)
def port(name, dtype):
    """The port's outputs on the reference's parameters, inputs and router
    choices; ``seen`` holds the port's own router choices in the order of
    the reference's records."""
    ref = reference(name, dtype)
    _, cfg = _cfgs(name, dtype)
    routes = ref["routes"]
    seen = {"forward": [], "loss": [], "decode": []}
    params = convert.params_from_numpy(ref["params"], device="cpu")
    tokens = torch.from_numpy(ref["tokens"])
    labels = torch.from_numpy(ref["labels"])
    prefill, _ = tsteps.build_lm_prefill_step(cfg, device="cpu")
    decode, _ = tsteps.build_lm_decode_step(cfg, device="cpu")
    with torch.no_grad():
        with forced_routes(routes["forward"][0], seen["forward"]):
            h, aux = ttr.lm_forward(params, cfg, tokens)
        with forced_routes(routes["forward"][0], []):
            first = prefill(params, tokens)
        with forced_routes(routes["loss"][0], seen["loss"]):
            loss, metrics = ttr.lm_loss(params, cfg, tokens, labels)
    cache = ttr.init_kv_cache(cfg, B, MAX_LEN, device="cpu")
    # the serving step on a second cache, teacher-forced the same way
    step_cache = ttr.init_kv_cache(cfg, B, MAX_LEN, device="cpu")
    logits, caches, greedy, step_tokens = [], [], [], []
    for i, tok in enumerate(ref["feed"]):
        n = torch.full((B,), i, dtype=torch.int32)
        mine = []
        with torch.no_grad(), forced_routes(routes["decode"][i], mine):
            nt, lg, cache = ttr.lm_decode_step(
                params, cfg, torch.from_numpy(tok), cache, n)
        seen["decode"].append(mine)
        with forced_routes(routes["decode"][i], []):
            st, step_cache = decode(params, step_cache,
                                    torch.from_numpy(tok), n)
        logits.append(lg)
        caches.append({k: v.clone() for k, v in cache.items()})
        greedy.append(nt)
        step_tokens.append(st)
    return dict(params=params, hidden=h, aux=aux, loss=loss,
                metrics=metrics, prefill=first, seen=seen,
                logits=logits, caches=caches, greedy=greedy,
                step_tokens=step_tokens, step_cache=step_cache)


def _decided(ref_logits, tol):
    return chip_smoke.lm_decided(ref_logits, tol).numpy()


CASES = [(n, d) for n in NAMES for d in DTYPES]
IDS = [f"{n}-{d}" for n, d in CASES]


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_forward_hidden_states(name, dtype):
    ref, mine = reference(name, dtype), port(name, dtype)
    assert mine["hidden"].dtype == getattr(torch, dtype)
    assert _err(mine["hidden"], ref["hidden"]) <= TOL[dtype]
    assert _err(mine["aux"], ref["aux"]) <= TOL[dtype]


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_loss_and_metrics(name, dtype):
    ref, mine = reference(name, dtype), port(name, dtype)
    want = {"ce", "moe_aux"} | ({"mtp_ce"} if "deepseek" in name else set())
    assert set(mine["metrics"]) == set(ref["metrics"]) == want
    assert _err(mine["loss"], ref["loss"]) <= TOL_LOGITS[dtype]
    for k, v in ref["metrics"].items():
        assert mine["metrics"][k].dtype == torch.float32
        assert _err(mine["metrics"][k], v) <= TOL_LOGITS[dtype], k
    if "grok" in name or "deepseek" in name:
        assert ref["metrics"]["moe_aux"] > 0


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_prefill_token(name, dtype):
    ref, mine = reference(name, dtype), port(name, dtype)
    tok = mine["prefill"]
    assert tok.dtype == torch.int32 and tok.shape == (B,)
    decided = _decided(ref["last"].astype(np.float32), TOL_LOGITS[dtype])
    want = ref["last"].astype(np.float32).argmax(-1)
    assert np.array_equal(tok.numpy()[decided], want[decided])


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_decode_logits_and_tokens(name, dtype):
    ref, mine = reference(name, dtype), port(name, dtype)
    compared = 0
    for i in range(STEPS):
        lg = mine["logits"][i]
        assert lg.dtype == torch.float32
        assert _err(lg, ref["logits"][i]) <= TOL_LOGITS[dtype], i
        decided = _decided(ref["logits"][i], TOL_LOGITS[dtype])
        for got in (mine["greedy"][i], mine["step_tokens"][i]):
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy()[decided],
                                  ref["greedy"][i][decided]), i
        compared += int(decided.sum())
    # float32 decides nearly every token; bfloat16's wider tolerance on
    # a random model's close logits fewer, but not none
    assert compared >= (STEPS * B // 2 if dtype == "float32" else 1)


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_decode_caches(name, dtype):
    ref, mine = reference(name, dtype), port(name, dtype)
    for i in range(STEPS):
        assert sorted(mine["caches"][i]) == sorted(ref["caches"][i])
        for k, want in ref["caches"][i].items():
            got = mine["caches"][i][k]
            assert got.dtype == getattr(torch, dtype)
            assert _err(got, want) <= TOL[dtype], (i, k)
    for k, v in mine["step_cache"].items():  # the step builder's, in place
        assert torch.equal(v, mine["caches"][-1][k])


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_decode_write_past_the_end_lands_in_the_last_slot(name, dtype):
    """Steps at ``pos >= max_len`` overwrite slot ``max_len - 1`` and leave
    the others as they were — the reference's clamp, not an error."""
    ref, mine = reference(name, dtype), port(name, dtype)
    for i in range(MAX_LEN, STEPS):
        for k in ref["caches"][i]:
            before_r, after_r = ref["caches"][i - 1][k], ref["caches"][i][k]
            before, after = mine["caches"][i - 1][k], mine["caches"][i][k]
            assert np.array_equal(after_r[:, :, :-1], before_r[:, :, :-1])
            assert not np.array_equal(after_r[:, :, -1], before_r[:, :, -1])
            assert torch.equal(after[:, :, :-1], before[:, :, :-1])
            assert not torch.equal(after[:, :, -1], before[:, :, -1])


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_router_choices_equal_the_reference_but_for_ties(name, dtype):
    """The port's own top-k in every MoE layer of every call equals the
    reference's, or the two differ where the reference's probabilities of
    the two experts are within ``TIE`` of each other."""
    ref, mine = reference(name, dtype), port(name, dtype)
    cfg, _ = _cfgs(name, dtype)
    n_moe = (cfg.n_layers - cfg.first_dense_layers) if cfg.moe else 0
    pairs = [(r, m) for key in ("forward", "loss")
             for r, m in zip(ref["routes"][key][0], mine["seen"][key])]
    for r_step, m_step in zip(ref["routes"]["decode"],
                              mine["seen"]["decode"]):
        assert len(r_step) == len(m_step) == n_moe
        pairs += list(zip(r_step, m_step))
    assert len(pairs) == n_moe * (2 + STEPS)
    records, seen = [r for r, _ in pairs], [m for _, m in pairs]
    assert chip_smoke.lm_flips(records, seen, TIE[dtype]) is not None


@pytest.mark.parametrize("name", NAMES)
def test_bf16_parameters_carry_over_bit_for_bit(name):
    ref = reference(name, "bfloat16")["params"]
    mine = convert.params_from_numpy(ref, device="cpu")

    def bits(tree):  # the tensors' bit patterns back on the host
        if isinstance(tree, dict):
            return {k: bits(v) for k, v in tree.items()}
        return tree.view(torch.uint16).numpy()

    back = bits(mine)

    def walk(r, m, b):
        if isinstance(r, dict):
            assert sorted(r) == sorted(m) == sorted(b)
            for k in r:
                walk(r[k], m[k], b[k])
            return
        assert r.dtype.name == "bfloat16" and m.dtype == torch.bfloat16
        assert np.array_equal(r.view(np.uint16), b)
        assert np.array_equal(r.astype(np.float32), m.float().numpy())

    walk(ref, mine, back)


@pytest.mark.parametrize("name", ["qwen2-0.5b-smoke", "chatglm3-6b-smoke"])
def test_decode_matches_the_ports_own_forward(name):
    """Teacher-forced decode over a prompt gives, at each position, the
    logits of the full forward pass at that position (float32).  Only a
    dense model: an MoE layer's capacity follows the tokens of the call
    (16 in this forward, 2 in a decode step), so decode drops tokens the
    forward keeps — in the reference as in the port."""
    _, cfg = _cfgs(name, "float32")
    params = ttr.lm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, 8)).astype(np.int32))
    with torch.no_grad():
        h, _ = ttr.lm_forward(params, cfg, tokens)
        full = ttr.lm_logits(params, h)
        cache = ttr.init_kv_cache(cfg, B, 8, device="cpu")
        for i in range(8):
            _, lg, cache = ttr.lm_decode_step(
                params, cfg, tokens[:, i], cache,
                torch.full((B,), i, dtype=torch.int32))
            assert _err(lg, full[:, i]) <= TOL_LOGITS["float32"], i


def test_params_from_numpy_copies_and_casts():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = convert.params_from_numpy({"x": {"w": a}}, device="cpu",
                                  dtype=torch.bfloat16)["x"]["w"]
    assert t.dtype == torch.bfloat16 and t.float().numpy().tolist() == \
        a.tolist()
    t32 = convert.params_from_numpy({"w": a}, device="cpu")["w"]
    t32 += 1  # the tensor never aliases the caller's array
    assert a[0, 0] == 0.0


INITS = {
    "lm_init": lambda g: ttr.lm_init(g, tcfg.get_config("qwen2-0.5b-smoke")),
    "init_kv_cache": lambda g: ttr.init_kv_cache(
        tcfg.get_config("qwen2-0.5b-smoke"), B, MAX_LEN),
    "dense_init": lambda g: tnn.dense_init(g, 4, 3, bias=True),
    "mlp_init": lambda g: tnn.mlp_init(g, (4, 3, 2)),
    "rmsnorm_init": lambda g: tnn.rmsnorm_init(4),
    "layernorm_init": lambda g: tnn.layernorm_init(4),
    "embed_init": lambda g: tnn.embed_init(g, 10, 4),
    "swiglu_init": lambda g: tmoe.swiglu_init(g, 4, 6),
    "moe_init": lambda g: tmoe.moe_init(g, 4, 3, 6, n_shared=1),
}


@pytest.mark.parametrize("init", sorted(INITS))
def test_inits_run_on_the_gpu_unless_told_otherwise(init):
    """``device=None`` is the GPU, as everywhere in the package: without
    one an init raises and allocates nothing on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        INITS[init](torch.Generator().manual_seed(0))


def test_steps_refuse_parameters_on_another_device():
    cfg = tcfg.get_config("qwen2-0.5b-smoke")
    decode, _ = tsteps.build_lm_decode_step(cfg, device="cpu")
    params = ttr.lm_init(None, cfg, device="meta")
    with pytest.raises(ValueError, match="move them first"):
        decode(params, {}, torch.zeros(2, dtype=torch.int32),
               torch.zeros(2, dtype=torch.int32))
