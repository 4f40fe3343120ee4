"""The LM family's steps on a device mesh (``build_lm_{train,prefill,
decode}_step(mesh=DeviceMesh)``), dense configs: qwen2-0.5b, chatglm3-6b,
qwen1.5-110b (the MoE ones are in ``test_torch_lm_mesh_moe.py``, so the
reference's compiles spread over two workers).

Two comparisons, on CPU meshes whose positions all lie on the CPU:

* **the port's sharded steps against its one-device steps**, every config
  in float32 and bfloat16 on the meshes ``(2, 2)``, ``(1, 4)`` (the two KV
  heads do not divide the model axis), ``(4, 1)`` (pure FSDP), ``(1, 3)``
  (uneven shards of d_model 64 and of the vocabulary) and ``(2, 1, 2)``
  (a pod axis): ``chip_smoke.lm_mesh_compare``, the card's check too —
  one train step (8 x 24 tokens, two microbatches of 4, step 2000) by
  ``lm_step_errs`` at the train-step tests' tolerances (``TOL`` of
  ``test_torch_lm_train_step.py``: float32 1e-5 for the loss and
  ``grad_norm``, 1e-4 of each state leaf's norm, 1e-5 elementwise for the
  parameters; bfloat16 2**-5, 2**-4, 2**-8), the prefill's last-position
  logits and its token where one device's margin decides it, and 8
  decode steps teacher-forced on a
  12-slot cache: logits within the LM model tests' bounds (1e-4, bfloat16
  2**-5), tokens where decided, the cache within 1e-4 (bfloat16 2**-4);
* **the port's sharded steps against the reference's own mesh run**: the
  reference's steps jitted over a host mesh of the same shape in one
  subprocess with four host devices (started by the first test, read by
  the last ones), on the reference's ``lm_init`` parameters carried over;
  this file's jobs and ``test_torch_lm_mesh_ref.py``'s together run a
  dense config's train, prefill and decode steps in both dtypes on every
  mesh but ``(1, 3)`` (the reference's jit refuses shards that do not
  divide a dimension);
  the train step at the same tolerances, the prefill and decode tokens
  where the port's one-device logits decide them, the final cache.  The
  reference's mesh chunks its attention with ``nq_multiple = tp``, which
  the port's mesh follows (the one-device step does not).

Also pinned: position ``(0, ...)``'s bytes ``==`` ``shard_bytes`` for the
parameters, the optimiser state and the cache; a train step's parameter
and gradient traffic ``==`` its closed form (``chip_smoke.
lm_mesh_train_bytes``: the remat recompute gathers each layer's FSDP
weights a second time, and the tally counts it); a replicated leaf
counted once in ``grad_norm``; decode shards wholly past ``cache_len`` make
no NaN; the vocabulary-sharded argmax's ties; the int8 cache's combine;
``train --mesh`` and checkpoints across meshes.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import roofline
from repro_torch.models import attention, convert, sharding
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttr

from test_torch_lm_model import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [a + "-smoke" for a in tcfg.LM_ARCHS]
MOE = [n for n in NAMES if tcfg.get_config(n).moe]
DENSE = [n for n in NAMES if n not in MOE]
DTYPES = ["float32", "bfloat16"]
MESHES = [(2, 2), (1, 4), (4, 1), (1, 3), (2, 1, 2)]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
B, S, MB = chip_smoke.LM_MESH_B, chip_smoke.LM_MESH_S, chip_smoke.LM_MESH_MB
LEN, STEPS = chip_smoke.LM_MESH_LEN, chip_smoke.LM_MESH_STEPS
STEP = chip_smoke.LM_TRAIN_STEP
TOL = chip_smoke.LM_TRAIN_TOL
CPU = torch.device("cpu")
FULL = ("train", "prefill", "decode")
# the reference's mesh runs of this file: (config, dtype, mesh, steps);
# test_torch_lm_mesh_ref.py has the rest, so that a dense config runs all
# three steps in both dtypes on every mesh the reference accepts.  Its
# jit refuses an input sharding that does not divide a dimension, so the
# (1, 3) mesh (d_model 64, vocabularies of 256 and 512) has no reference
# run: the port's uneven shards are held to its one device.
REF_JOBS = [
    ("qwen2-0.5b-smoke", "bfloat16", (2, 2), FULL),
    ("chatglm3-6b-smoke", "float32", (1, 4), FULL),
    ("qwen1.5-110b-smoke", "bfloat16", (1, 4), FULL),
    ("qwen2-0.5b-smoke", "float32", (4, 1), FULL),
]


def ref_ids(jobs):
    return [f"{n}-{d}-{'x'.join(map(str, m))}" for n, d, m, _ in jobs]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_of(shape):
    return chip_smoke.lm_mesh_of(shape, [CPU] * math.prod(shape))


def cfg_of(name, dtype, **kw):
    return dataclasses.replace(tcfg.get_config(name), dtype=dtype,
                               microbatch_size=MB, **kw)


@functools.lru_cache(maxsize=None)
def port_params(name, dtype):
    return ttr.lm_init(torch.Generator().manual_seed(0), cfg_of(name, dtype),
                       device="cpu")


def batch_of(cfg):
    return TokenPipeline(cfg.vocab, B, S).next_batch()


def check_against_one_device(name, dtype, shape):
    cfg = cfg_of(name, dtype)
    row, ok = chip_smoke.lm_mesh_compare(cfg, port_params(name, dtype),
                                         batch_of(cfg), mesh_of(shape), CPU)
    assert ok, row
    assert row["serve"]["tokens_compared"] >= (
        STEPS * B // 2 if dtype == "float32" else 1)
    return row


# ----------------------------------------------------------------------
# the reference's mesh runs, in one subprocess a file
# ----------------------------------------------------------------------
REF_CODE = r"""
import dataclasses, json, math, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.configs as jcfg
from repro.models import steps as js, transformer as jtr

jobs, out, sizes = json.loads(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
B, S, MB, LEN, STEPS, STEP = (sizes[k] for k in
                               ("B", "S", "MB", "LEN", "STEPS", "STEP"))

def flat(tree, prefix, res):
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            flat(v, key, res)
        else:
            res[key] = np.asarray(jnp.asarray(v, jnp.float32))

params = {}
for name, dtype, shape, kinds in jobs:
    cfg = dataclasses.replace(jcfg.get_config(name), dtype=dtype,
                              microbatch_size=MB)
    if name not in params:
        f32 = dataclasses.replace(cfg, dtype="float32")
        params[name] = jax.tree.map(np.asarray, jax.jit(
            lambda k: jtr.lm_init(k, f32))(jax.random.key(0)))
    host = jax.tree.map(lambda a: a.astype(dtype), params[name])
    fresh = lambda: jax.tree.map(jnp.asarray, host)
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(shape),
                axes)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    res = {"tokens": tokens, "labels": labels}
    flat(host, "params", res)
    if "train" in kinds:
        fn, info = js.build_lm_train_step(cfg, mesh)
        p = fresh()
        p2, o2, m = fn(p, info["opt_init"](p), {"tokens": jnp.asarray(tokens),
                       "labels": jnp.asarray(labels)}, STEP)
        flat(p2, "train_params", res)
        flat(o2, "train_opt", res)
        for k, v in m.items():
            res[f"metric/{k}"] = np.asarray(v, np.float64)
    if "prefill" in kinds:
        pf, _ = js.build_lm_prefill_step(cfg, mesh)
        res["prefill"] = np.asarray(pf(fresh(), jnp.asarray(tokens)))
    if "decode" in kinds:
        dc, _ = js.build_lm_decode_step(cfg, mesh)
        p, cache = fresh(), jtr.init_kv_cache(cfg, B, LEN)
        for i in range(STEPS):
            nt, cache = dc(p, cache, jnp.asarray(tokens[:, i]),
                           jnp.full((B,), i, jnp.int32))
            res[f"decode/{i}"] = np.asarray(nt)
        flat(cache, "cache", res)
    key = f"{name}-{dtype}-{'x'.join(map(str, shape))}"
    np.savez(f"{out}/{key}.npz", **res)
print("done")
"""


class ReferenceRuns:
    """The reference's mesh runs of ``jobs`` in a subprocess with four
    host devices, started at once and read when first asked for."""

    def __init__(self, jobs, directory, ndev=4):
        self.jobs, self.dir = jobs, str(directory)
        env = dict(os.environ)
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ndev}"
        env["PYTHONPATH"] = os.path.join(REPO, "src")
        env["JAX_PLATFORMS"] = "cpu"
        sizes = dict(B=B, S=S, MB=MB, LEN=LEN, STEPS=STEPS, STEP=STEP)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REF_CODE),
             json.dumps([[n, d, list(m), list(k)] for n, d, m, k in jobs]),
             self.dir, json.dumps(sizes)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self.out = None

    def wait(self):
        if self.out is None:
            out, err = self.proc.communicate(timeout=600)
            if self.proc.returncode != 0:
                raise AssertionError(f"reference subprocess failed:\n{err}")
            self.out = out
        return self.out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()

    @functools.lru_cache(maxsize=None)
    def result(self, name, dtype, shape):
        self.wait()
        key = f"{name}-{dtype}-{'x'.join(map(str, shape))}"
        with np.load(os.path.join(self.dir, key + ".npz")) as z:
            flat = {k: z[k] for k in z.files}
        return flat


def tree_of(flat, prefix):
    """The nested dict under ``prefix/`` of a flat ``{path: array}``."""
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def ref_fixture(jobs, ndev=4):
    @pytest.fixture(scope="module")
    def reference_runs(tmp_path_factory):
        runs = ReferenceRuns(jobs, tmp_path_factory.mktemp("ref_mesh"), ndev)
        yield runs
        runs.close()

    return reference_runs


reference_runs = ref_fixture(REF_JOBS)


def check_against_reference(runs, name, dtype, shape, kinds, *,
                            full_train=True):
    """The port's mesh steps on the reference's parameters against the
    reference's mesh run of the same shape."""
    ref = runs.result(name, dtype, tuple(shape))
    cfg = cfg_of(name, dtype)
    mesh = mesh_of(shape)
    params = convert.params_from_numpy(
        tree_of(ref, "params"), device="cpu", dtype=getattr(torch, dtype))
    batch = {"tokens": ref["tokens"], "labels": ref["labels"]}
    tol_c, tol_l = chip_smoke.LM_TOL[dtype]
    if "train" in kinds:
        got, _, _ = chip_smoke.lm_mesh_train(cfg, params, batch, STEP,
                                             mesh=mesh)
        want = (tree_of(ref, "train_params"), tree_of(ref, "train_opt"),
                {k.split("/")[1]: float(v) for k, v in ref.items()
                 if k.startswith("metric/")})
        if full_train:
            errs, ok = chip_smoke.lm_step_errs(got, want, cfg, STEP,
                                               TOL[dtype])
            assert ok, errs
        for k in ("loss", "grad_norm"):
            assert chip_smoke.lm_err(got[2][k], want[2][k]) <= TOL[dtype][k]
    if "prefill" in kinds or "decode" in kinds:
        toks = torch.from_numpy(ref["tokens"])
        one = chip_smoke.lm_mesh_serve(cfg, params, toks, STEPS, LEN, dev=CPU)
        got = chip_smoke.lm_mesh_serve(cfg, params, toks, STEPS, LEN,
                                       mesh=mesh)
        if "prefill" in kinds:
            dec = chip_smoke.lm_decided(one["prefill_logits"], tol_l)
            assert dec.sum() >= 1
            assert np.array_equal(got["prefill"].numpy()[dec.numpy()],
                                  ref["prefill"][dec.numpy()])
        if "decode" in kinds:
            compared = 0
            for i in range(STEPS):
                dec = chip_smoke.lm_decided(one["logits"][i], tol_l).numpy()
                assert np.array_equal(got["next"][i].numpy()[dec],
                                      ref[f"decode/{i}"][dec]), i
                compared += int(dec.sum())
            assert compared >= 1
            for k, v in tree_of(ref, "cache").items():
                assert chip_smoke.lm_err(got["cache"][k], v) <= tol_c, k


# ----------------------------------------------------------------------
# the port's mesh against its one device
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_mesh_steps_equal_one_device(name, dtype, shape, reference_runs):
    # the reference's subprocess (the fixture) runs meanwhile
    check_against_one_device(name, dtype, shape)


def test_params_opt_and_cache_shards_are_shard_bytes():
    """Every position holds exactly its shard: position (0, ...)'s bytes
    are ``roofline.shard_bytes`` of the global trees, for the parameters,
    AdamW's and Adafactor's states and the cache, on an uneven mesh."""
    for shape in ((1, 3), (2, 1, 2)):
        mesh = mesh_of(shape)
        for optimizer in ("adamw", "adafactor"):
            cfg = cfg_of("qwen2-0.5b-smoke", "bfloat16", optimizer=optimizer)
            fn, info = tsteps.build_lm_train_step(cfg, mesh)
            params = info["shard"](port_params("qwen2-0.5b-smoke",
                                               "bfloat16"))
            opt = info["opt_init"](params)
            first = lambda t: sum(  # noqa: E731
                x.shards[0].numel() * x.shards[0].element_size()
                for x in _leaves(t))
            assert first(params) == roofline.shard_bytes(
                info["dummy"], info["params"], mesh)
            assert first(opt) == roofline.shard_bytes(
                info["opt_shape"], info["opt"], mesh)
            for p in range(mesh.size):
                for x in _leaves(params) + _leaves(opt):
                    assert x.shards[p].device == mesh.devices[p]
        dc, dinfo = tsteps.build_lm_decode_step(cfg, mesh)
        cache = dinfo["init_cache"](B, LEN)
        meta = ttr.init_kv_cache(cfg, B, LEN, device="meta")
        assert first(cache) == roofline.shard_bytes(meta, dinfo["cache"],
                                                    mesh)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_shards_round_trip_and_reference_specs_lay_them_out():
    """``shard_tree`` / ``unshard_tree`` are exact inverses; the step's
    info specs are what the shards follow (uneven: d_model 64 over 3 is
    22, 22, 20; the vocabulary 512 over 3 is 171, 171, 170)."""
    mesh = mesh_of((1, 3))
    cfg = cfg_of("qwen2-0.5b-smoke", "float32")
    params = port_params("qwen2-0.5b-smoke", "float32")
    fn, info = tsteps.build_lm_train_step(cfg, mesh)
    sp = info["shard"](params)
    back = sharding.unshard_tree(sp)
    for a, b in zip(_leaves(back), _leaves(params)):
        assert torch.equal(a, b)
    wq = sp["layers"]["attn"]["wq"]["w"]
    assert wq.spec == (None, "data", "model")
    assert [s.shape[-1] for s in wq.shards] == [22, 22, 20]
    table = sp["embed"]["table"]
    assert [s.shape[0] for s in table.shards] == [171, 171, 170]
    # the numpy carry-over goes straight to shards, and back
    np_tree = convert.numpy_from_params(sp)
    again = convert.params_from_numpy(np_tree, mesh=mesh, specs=info["params"])
    for a, b in zip(_leaves(again), _leaves(sp)):
        assert all(torch.equal(x, y) for x, y in zip(a.shards, b.shards))


def test_train_traffic_equals_its_closed_form():
    """One AdamW step's parameter and gradient bytes on a (2, 2) mesh
    equal ``lm_mesh_train_bytes``: with remat each layer's FSDP weights
    are gathered twice a microbatch (the recompute in the backward gathers
    again and holds no gathered weight across the layer), the head and
    the embedding-free leaves once; without remat once."""
    mesh = mesh_of((2, 2))
    for remat in (True, False):
        cfg = cfg_of("qwen2-0.5b-smoke", "float32", remat=remat)
        _, tally, _ = chip_smoke.lm_mesh_train(
            cfg, port_params("qwen2-0.5b-smoke", "float32"), batch_of(cfg),
            STEP, mesh=mesh)
        want = chip_smoke.lm_mesh_train_bytes(cfg, mesh, B // MB)
        assert {k: tally[k] for k in want} == want
        assert want["all_gather:params"] > want["reduce_scatter:params"] \
            if remat else want["all_gather:params"] == \
            want["reduce_scatter:params"]


def test_a_replicated_leaf_counts_once_in_grad_norm():
    """``global_sq_sum`` adds each distinct shard once: a leaf replicated
    over every axis (a norm's scale on all four positions) counts once,
    a (data, model)-sharded one once a shard."""
    from repro_torch.optim.adamw import global_sq_sum

    mesh = mesh_of((2, 2))
    g_rep = torch.arange(4.0)
    g_shard = torch.arange(8.0).reshape(2, 4)
    grads = {"a": sharding.shard_tensor(g_rep, (None,), mesh).shards,
             "b": sharding.shard_tensor(g_shard, ("data", "model"),
                                        mesh).shards}
    specs = {"a": (None,), "b": ("data", "model")}
    got = global_sq_sum(mesh, grads, specs)
    want = float((g_rep ** 2).sum() + (g_shard ** 2).sum())
    assert all(float(x) == want for x in got)


def test_decode_shards_past_cache_len_make_no_nan():
    """On (1, 4) a 12-slot cache lies 3 slots a position; at the first
    steps three of the four hold no valid slot (their max is -inf, and
    ``exp(-inf - (-inf))`` would be NaN): the combine adds nothing from
    them.  A position holding no slot at all (a cache of 3 over 4) too."""
    mesh = mesh_of((1, 4))
    rng = torch.Generator().manual_seed(1)
    for s_total in (12, 3):
        k = torch.randn(2, s_total, 2, 8, generator=rng)
        v = torch.randn(2, s_total, 2, 8, generator=rng)
        q = torch.randn(2, 4, 8, generator=rng)
        for n_valid in (1, 2, s_total):
            cl = torch.full((2,), n_valid)
            want = attention.decode_attention(q, k, v, cl)
            got = _sharded_decode(mesh, q, k, v, cl)
            assert torch.isfinite(got).all()
            assert chip_smoke.lm_err(got, want) <= 1e-6


def _sharded_decode(mesh, q, k, v, cl, k_scale=None, v_scale=None):
    """``decode_attention`` through ``decode_combine`` with k and v (and
    their int8 scales) sharded by sequence over ``model``."""
    lay = sharding.layout(mesh)
    s_total = k.shape[1]
    b, h, dh = q.shape
    kvh = k.shape[2]
    scores, vals = [], []
    for p in range(lay.n):
        lo, hi = sharding.chunk(s_total, lay.size("model"),
                                lay.index(p, "model"))
        kp, vp = k[:, lo:hi], v[:, lo:hi]
        if k_scale is not None:
            kp = attention.dequantize_kv(kp, k_scale[:, lo:hi], torch.float32)
            vp = attention.dequantize_kv(vp, v_scale[:, lo:hi], torch.float32)
        qg = (q.reshape(b, kvh, h // kvh, dh) * dh ** -0.5).float()
        sc = torch.einsum("bkgd,bskd->bkgs", qg, kp.float())
        slot = lo + torch.arange(hi - lo)
        mask = (slot[None, :] < cl[:, None])[:, None, None, :]
        scores.append(torch.where(mask, sc, -torch.inf))
        vals.append(vp.float())
    out = attention.decode_combine(mesh, "model", scores, lambda p, w:
                                   torch.einsum("bkgs,bskd->bkgd", w,
                                                vals[p]))
    for o in out[1:]:
        assert torch.equal(o, out[0])  # the psum's sum is every member's
    return out[0].reshape(b, h, dh)


def test_int8_cache_shards_with_its_scales():
    """An int8 cache (``quantize_kv``'s codes and per-token scales) cut by
    sequence, each shard's scales with its tokens: the combined attention
    equals one device's over the dequantized cache."""
    mesh = mesh_of((1, 3))
    rng = torch.Generator().manual_seed(2)
    k = torch.randn(2, 12, 2, 8, generator=rng)
    v = torch.randn(2, 12, 2, 8, generator=rng)
    q = torch.randn(2, 4, 8, generator=rng)
    kq, ks = attention.quantize_kv(k)
    vq, vs = attention.quantize_kv(v)
    cl = torch.tensor([5, 12])
    want = attention.decode_attention(
        q, attention.dequantize_kv(kq, ks, torch.float32),
        attention.dequantize_kv(vq, vs, torch.float32), cl)
    got = _sharded_decode(mesh, q, kq, vq, cl, ks, vs)
    assert chip_smoke.lm_err(got, want) <= 1e-6


def test_vocab_sharded_argmax_ties_go_to_the_lower_index():
    """Across the vocabulary shards the largest logit wins and equal
    maxima go to the lower global index, as ``torch.argmax`` over the whole
    row; uneven shards (10 over 3: 4, 4, 2) too."""
    mesh = mesh_of((1, 3))
    cfg = cfg_of("qwen2-0.5b-smoke", "float32")
    plan = ttr.MeshPlan(mesh, cfg)
    rows = torch.tensor([[0., 5, 1, 5, 0, 0, 0, 0, 5, 0],   # ties in shards 0, 2
                         [0., 0, 0, 0, 0, 0, 0, 0, 0, 7],   # the last shard
                         [3., 3, 3, 3, 3, 3, 3, 3, 3, 3],   # all equal
                         [0., 0, 0, 0, 0, 9, 9, 0, 0, 0]])  # within shard 1
    shards = sharding.shard_tensor(rows, (None, "model"), mesh).shards
    got = ttr.argmax_mesh(plan, shards, 10)
    for g in got:
        assert g.tolist() == torch.argmax(rows, dim=-1).tolist() == \
            [1, 9, 0, 5]


def test_collectives_backward_are_their_duals():
    """The FSDP x TP pattern of a layer on (2, 2), by hand: rows of ``x``
    over ``data`` (``replicate``d into the model group), ``w`` (data,
    model) all-gathered over ``data`` (backward: reduce-scatter), a
    replicated bias ``split`` over ``model`` (backward: all-gather), the
    loss a psum over both axes (backward: identity).  Each position's
    gradients are its pieces of one device's: ``x``'s rows exactly as they
    are, ``w``'s shard summed by the reduce-scatter, the bias's once a
    psum over ``data`` adds the data positions' partials."""
    mesh = mesh_of((2, 2))
    lay = sharding.layout(mesh)
    gen = torch.Generator().manual_seed(3)
    x, w, b = (torch.randn(*s, generator=gen, dtype=torch.float64)
               for s in ((4, 6), (6, 5), (5,)))
    wx, ww, wb = (t.clone().requires_grad_(True) for t in (x, w, b))
    (torch.sin(wx @ ww + wb) ** 2).sum().backward()
    lx = [t.requires_grad_(True) for t in
          sharding.shard_tensor(x, ("data",), mesh).shards]
    lw = [t.requires_grad_(True) for t in
          sharding.shard_tensor(w, ("data", "model"), mesh).shards]
    lb = [t.requires_grad_(True) for t in
          sharding.shard_tensor(b, (None,), mesh).shards]
    with sharding.tally_collective_bytes() as tally:
        full_w = sharding.all_gather(lw, mesh, "data", 0, "params")
        xr = sharding.replicate(lx, mesh, "model")
        bm = sharding.split(lb, mesh, "model", 0, "bias")
        parts = [(torch.sin(a @ c + d) ** 2).sum()
                 for a, c, d in zip(xr, full_w, bm)]
        loss = sharding.psum(parts, mesh, ("data", "model"), "loss")
        gx = torch.autograd.grad(loss, lx + lw + lb,
                                 grad_outputs=[torch.ones(()) for _ in loss])
    assert all(torch.equal(t, loss[0]) for t in loss)
    assert abs(float(loss[0].detach())
               - float((torch.sin(x @ w + b) ** 2).sum())) < 1e-12
    gx, gw, gb = gx[:4], gx[4:8], gx[8:]
    want_w = sharding.shard_tensor(ww.grad, ("data", "model"), mesh)
    for p in range(4):
        d = lay.index(p, "data")
        assert torch.allclose(gx[p], wx.grad[2 * d:2 * d + 2], atol=1e-12)
        assert torch.allclose(gw[p], want_w.shards[p], atol=1e-12)
    gb = sharding.psum(list(gb), mesh, "data")
    assert all(torch.allclose(g, wb.grad, atol=1e-12) for g in gb)
    # each collective moved what it must: the gather (each data position
    # receives the other's 3 rows x 3 or 2 columns) and its reduce-scatter
    # alike
    assert tally["all_gather:params"] == tally["reduce_scatter:params"] \
        == 2 * 3 * (3 + 2) * 8


def test_reduce_scatter_and_its_all_gather_backward():
    """``reduce_scatter`` sums a group's tensors and leaves member ``i``
    chunk ``i`` (ceil chunks: 5 rows over 2 are 3 and 2); its backward
    all-gathers, so each member's input gets the whole gradient."""
    mesh = mesh_of((2, 2))
    gen = torch.Generator().manual_seed(6)
    xs = [torch.randn(5, 3, generator=gen, dtype=torch.float64,
                      requires_grad=True) for _ in range(4)]
    out = sharding.reduce_scatter(xs, mesh, "data", 0)
    lay = sharding.layout(mesh)
    for p, o in enumerate(out):
        g = next(g for g in lay.groups("data") if p in g)
        lo, hi = sharding.chunk(5, 2, lay.index(p, "data"))
        want = (xs[g[0]] + xs[g[1]])[lo:hi]
        assert torch.allclose(o, want, atol=0, rtol=0)
    seeds = [torch.full(o.shape, float(p + 1)) for p, o in enumerate(out)]
    grads = torch.autograd.grad(out, xs, grad_outputs=seeds)
    for p, g in enumerate(grads):
        grp = next(g_ for g_ in lay.groups("data") if p in g_)
        want = torch.cat([seeds[j] for j in grp]).double()
        assert torch.equal(g, want)


def test_a_mesh_step_refuses_what_it_cannot_lay_out():
    """No fallback hides the mesh: global parameters, a device with a
    mesh, a mesh without the specs' axes all raise."""
    mesh = mesh_of((2, 2))
    cfg = cfg_of("qwen2-0.5b-smoke", "float32")
    fn, info = tsteps.build_lm_train_step(cfg, mesh)
    params = port_params("qwen2-0.5b-smoke", "float32")
    with pytest.raises(ValueError, match="not sharded"):
        fn(params, {}, batch_of(cfg), 0)
    with pytest.raises(ValueError, match="not both"):
        tsteps.build_lm_prefill_step(cfg, mesh, device="cpu")
    other = chip_smoke.lm_mesh_of((1, 4), [CPU] * 4)
    sp = tsteps.build_lm_train_step(cfg, other)[1]["shard"](params)
    with pytest.raises(ValueError, match="laid out"):
        fn(sp, info["opt_init"](info["shard"](params)), batch_of(cfg), 0)
    from repro_torch.launch.mesh import make_mesh_for

    flat = make_mesh_for((4,), ("data",), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="no 'model'"):
        tsteps.build_lm_train_step(cfg, flat)[1]["shard"](params)


# ----------------------------------------------------------------------
# train --mesh and checkpoints
# ----------------------------------------------------------------------
def _train(argv):
    from repro_torch.launch import train

    return train.main(argv)


def test_train_cli_on_a_mesh_resumes_to_the_uninterrupted_run(tmp_path):
    """``train --mesh 4 --device cpu``: 10 steps into a checkpoint
    directory, then on to 20 from it, equal the uninterrupted 20 steps
    (the same shards, the same order of every operation: bit for bit),
    and the one-device run's losses within the bfloat16 loss bound."""
    base = ["--arch", "qwen2-0.5b-smoke", "--device", "cpu", "--mesh", "4",
            "--seq", "32"]
    d = str(tmp_path / "ck")
    head = _train(base + ["--steps", "10", "--ckpt-dir", d])
    tail = _train(base + ["--steps", "20", "--ckpt-dir", d])
    whole = _train(base + ["--steps", "20"])
    assert sorted(head) == list(range(10)) and sorted(tail) == list(
        range(10, 20))
    for s in range(20):
        assert (head.get(s) if s < 10 else tail[s]) == whole[s], s
    one = _train(["--arch", "qwen2-0.5b-smoke", "--device", "cpu", "--seq",
                  "32", "--steps", "20"])
    for s in range(20):
        assert chip_smoke.lm_err(whole[s], one[s]) <= TOL["bfloat16"]["loss"]


def test_checkpoints_move_between_one_device_and_meshes(tmp_path):
    """A mesh checkpoint holds the global arrays (the one-device bytes): it
    restores on one device and on another mesh shape, and a one-device
    checkpoint restores onto a mesh, each leaf equal bit for bit."""
    from repro_torch.ckpt import CheckpointManager

    cfg = cfg_of("qwen2-0.5b-smoke", "bfloat16")
    params = port_params("qwen2-0.5b-smoke", "bfloat16")
    m22, m13 = mesh_of((2, 2)), mesh_of((1, 3))
    _, i22 = tsteps.build_lm_train_step(cfg, m22)
    _, i13 = tsteps.build_lm_train_step(cfg, m13)
    sp = i22["shard"](params)
    mgr = CheckpointManager(str(tmp_path / "a"), async_save=False)
    mgr.save(1, {"params": sp, "opt": i22["opt_init"](sp)})
    _, one, _ = mgr.restore_latest({"params": params})
    for a, b in zip(_leaves(one["params"]), _leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    like = i13["shard"](params)
    _, other, _ = mgr.restore_latest({"params": like})
    for a, b in zip(_leaves(other["params"]), _leaves(like)):
        assert a.mesh == m13 and a.spec == b.spec
        assert all(torch.equal(x, y) for x, y in zip(a.shards, b.shards))
    mgr2 = CheckpointManager(str(tmp_path / "b"), async_save=False)
    mgr2.save(1, {"params": params})
    _, back, _ = mgr2.restore_latest({"params": i22["shard"](params)})
    for a, b in zip(_leaves(back["params"]), _leaves(sp)):
        assert all(torch.equal(x, y) for x, y in zip(a.shards, b.shards))


def test_the_reference_checkpoint_restores_onto_a_mesh(tmp_path):
    """The reference's float32 parameters, written by its own checkpoint
    code in its format, restore straight into shards (bit for bit), and
    the shards' checkpoint restores in the reference."""
    from repro.ckpt import CheckpointManager as JManager
    from repro_torch.ckpt import CheckpointManager

    import jax
    from test_torch_lm_model import _ref_params

    ref = jax.tree.map(np.asarray, _ref_params("qwen2-0.5b-smoke"))
    JManager(str(tmp_path), async_save=False).save(3, {"params": ref})
    cfg = cfg_of("qwen2-0.5b-smoke", "float32")
    _, info = tsteps.build_lm_train_step(cfg, mesh_of((2, 1, 2)))
    like = info["shard"](port_params("qwen2-0.5b-smoke", "float32"))
    step, got, _ = CheckpointManager(str(tmp_path)).restore_latest(
        {"params": like})
    assert step == 3
    want = convert.params_from_numpy(ref, mesh=mesh_of((2, 1, 2)),
                                     specs=info["params"])
    for a, b in zip(_leaves(got["params"]), _leaves(want)):
        assert all(torch.equal(x, y) for x, y in zip(a.shards, b.shards))
    # and the other way: the mesh's checkpoint, restored by the reference
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        4, {"params": got["params"]})
    step, back, _ = JManager(str(tmp_path / "port")).restore_latest(
        {"params": ref})
    assert step == 4
    for a, b in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(ref)):
        assert np.array_equal(np.asarray(a), b)


def test_train_mesh_refuses_recsys_and_a_short_host(monkeypatch):
    """DLRM's sharded step is not ported: a recsys ``--arch`` with
    ``--mesh`` exits naming the next slice; ``--mesh`` without N on the
    CPU, or with more cards than the host has, exits too."""
    with pytest.raises(SystemExit, match="GNN and DLRM sharded steps"):
        _train(["--arch", "dlrm-mlperf-smoke", "--mesh", "2", "--device",
                "cpu"])
    with pytest.raises(SystemExit, match="needs N"):
        _train(["--arch", "qwen2-0.5b-smoke", "--mesh", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 2 CUDA cards"):
        _train(["--arch", "qwen2-0.5b-smoke", "--mesh", "2"])


# ----------------------------------------------------------------------
# the reference's mesh runs (the subprocess has been running meanwhile)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,dtype,shape,kinds", REF_JOBS,
                         ids=ref_ids(REF_JOBS))
def test_mesh_steps_equal_the_references_mesh_run(reference_runs, name,
                                                  dtype, shape, kinds):
    check_against_reference(reference_runs, name, dtype, shape, kinds)
