"""The LM family's train and serving steps, and the reference's sharding
specs (the JAX package's ``models/steps.py``).

The reference compiles each step with ``jax.jit`` over a device mesh; on
one card a step is an eager function over the whole batch.  Training is
the reference's gradient-accumulation microbatching (``lax.scan`` there,
a loop here): each microbatch's gradients, in the parameters' dtype, are
added into float32 accumulators, averaged, and handed to AdamW or
Adafactor.  :func:`lm_param_specs` and :func:`cache_specs` give the
reference's ``PartitionSpec`` of every leaf as a tuple of axis names
(``None`` for a replicated dimension), and :func:`_opt_specs` the
optimiser state's; the dry run sizes its cells by them.

Given a :class:`~repro_torch.launch.mesh.DeviceMesh`, a step runs
sharded by those specs (:mod:`.sharding`): every parameter, optimiser
state leaf and KV cache is held as :class:`~.sharding.ShardedTensor`
shards, the batch goes over ``(pod, data)``, and the collectives GSPMD
inserts in the reference are written by hand — FSDP weights all-gathered
over ``data`` inside each layer (their gradients reduce-scattered back),
TP products column- and row-parallel over ``model``, the reference's
sequence-parallel attention (q chunks over ``model``, k and v
replicated, ``nq_multiple = tp``), the vocabulary-sharded embedding,
loss and argmax, expert parallelism where the expert count divides
``model``, and a decode cache sharded by sequence over ``model`` whose
one-token attention is a psum-combined partial softmax.  ``mesh=None`` or
a :class:`~repro_torch.launch.mesh.LogicalMesh` runs on one device, as
before.
"""
from __future__ import annotations

import re
from typing import Tuple

import torch

from ..configs.base import LMConfig
from ..device import resolve_device
from ..launch.mesh import DeviceMesh
from ..optim import cosine_schedule, make_optimizer
from ..optim._tree import tree_leaves, tree_map
from . import nn, sharding
from .transformer import (MeshPlan, init_kv_cache, lm_decode_step,
                          lm_decode_step_mesh, lm_forward, lm_forward_mesh,
                          lm_init, lm_loss, lm_loss_mesh)

__all__ = [
    "lm_param_specs",
    "cache_specs",
    "spec",
    "build_lm_train_step",
    "build_lm_prefill_step",
    "build_lm_decode_step",
    "lm_input_specs",
]


def spec(*dims) -> Tuple:
    """A ``PartitionSpec`` as a tuple, normalised as the reference's is: a
    one-axis tuple becomes the axis name, an empty tuple ``None``."""
    out = []
    for d in dims:
        if isinstance(d, tuple):
            d = None if not d else d[0] if len(d) == 1 else d
        out.append(d)
    return tuple(out)


def _axis_size(mesh, name: str) -> int:
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[mesh.axis_names.index(name)]


def _walk(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def lm_param_specs(params, cfg: LMConfig, *, fsdp="data", tp="model",
                   mesh=None):
    """The reference's spec of every parameter, matched on path names, as
    a tree of tuples.

    Expert tensors shard E over ``tp`` (EP) when the expert count divides
    the axis; otherwise (grok's 8 experts on a 16-wide axis) they fall
    back to TP within each expert.  ``params`` may be meta tensors.
    """
    tp_size = _axis_size(mesh, tp)
    ep_ok = cfg.n_experts == 0 or tp_size <= 1 or cfg.n_experts % tp_size == 0

    def spec_for(path: str, leaf) -> Tuple:
        ndim = leaf.ndim
        stacked = path.startswith(("layers/", "dense_layers/"))
        lead = (None,) if stacked else ()
        base_ndim = ndim - (1 if stacked else 0)

        def mk(*dims):
            if len(dims) != base_ndim:
                raise ValueError(f"{path}: spec {dims} for {ndim} dims")
            return spec(*lead, *dims)

        if "embed/table" in path:
            return spec(tp, None)
        if path == "lm_head/w":
            return spec(fsdp, tp)
        if base_ndim <= 1:
            return lead + (None,) * base_ndim
        if "experts/" in path:  # (E, d, ff) / (E, ff, d)
            if ep_ok:
                if path.endswith("w_out"):
                    return mk(tp, None, fsdp)
                return mk(tp, fsdp, None)
            if path.endswith("w_out"):
                return mk(None, tp, fsdp)
            return mk(None, fsdp, tp)
        if re.search(r"attn/(wq|wk|wv)/w$", path):
            return mk(fsdp, tp)
        if path.endswith("attn/wo/w"):
            return mk(tp, fsdp)
        if re.search(r"(q_up|k_up|v_up)/w$", path):
            return mk(None, tp)
        if re.search(r"(q_down|kv_down)/w$", path):
            return mk(fsdp, None)
        if path.endswith("router/w"):
            return mk(fsdp, None)
        if re.search(r"(w_gate|w_in)$", path):
            return mk(fsdp, tp)
        if path.endswith("w_out"):
            return mk(tp, fsdp)
        if path.endswith("proj/w"):  # the MTP projection
            return mk(fsdp, None)
        if path.endswith("/w") and base_ndim == 2:
            return mk(fsdp, None)
        return lead + (None,) * base_ndim

    return _walk(params, spec_for)


def _opt_specs(opt_state, param_specs):
    """The optimiser state's specs from the parameters' (a state leaf's
    path is ``m/<param path>``, ``v/<param path>``, or Adafactor's
    ``v/<param path>/{vr,vc,v}``): a factored ``vr`` drops the last
    dimension's axis, ``vc`` the one before it."""

    def leaf_spec(path: str, _leaf) -> Tuple:
        parts = path.split("/")
        tail = parts[-1]
        found = _lookup(param_specs, "/".join(parts[1:]))
        if found is not None:
            return found
        # the factored Adafactor leaves: strip the trailing vr / vc / v
        found = _lookup(param_specs, "/".join(parts[1:-1]))
        if found is None:
            return ()
        if tail == "vr":
            return spec(*found[:-1])
        if tail == "vc":
            return spec(*(found[:-2] + found[-1:]))
        if tail == "v":
            return found
        return ()

    return _walk(opt_state, leaf_spec)


def _lookup(spec_tree, path: str):
    node = spec_tree
    for part in path.split("/"):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return None
    return node if isinstance(node, tuple) else None


def _dp_spec(mesh) -> Tuple:
    names = tuple(mesh.axis_names) if mesh is not None else ("data",)
    return tuple(a for a in ("pod", "data") if a in names)


def cache_specs(cfg: LMConfig, *, dp, tp="model"):
    """KV cache specs: batch over ``dp``, sequence over ``tp``."""
    if cfg.mla:
        return {"ckv": spec(None, dp, tp, None),
                "k_rope": spec(None, dp, tp, None)}
    return {"k": spec(None, dp, tp, None, None),
            "v": spec(None, dp, tp, None, None)}


def _on(dev: torch.device, t) -> torch.Tensor:
    return torch.as_tensor(t, device=dev)


def _check_params(params, dev: torch.device):
    got = params["embed"]["table"].device
    if got != dev:
        raise ValueError(f"the parameters lie on {got}, the step runs on "
                         f"{dev}: move them first")


def _microbatch_grads(live, acc, cfg: LMConfig, tokens, labels):
    """One microbatch of the train step: ``lm_loss``'s gradients with
    respect to ``live`` added into the float32 accumulators ``acc``.
    Returns the loss, detached.  A function of its own so that the dry
    run's walk (:mod:`repro_torch.launch.dryrun`) can see where each
    microbatch begins and ends."""
    loss, _ = lm_loss(live, cfg, tokens, labels)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    for a, g in zip(tree_leaves(acc), grads):
        if g is not None:
            a.add_(g)
    return loss.detach()


def build_lm_train_step(cfg: LMConfig, mesh=None, *,
                        compress_grads: bool = False, device=None):
    """One optimiser step over a batch in microbatches.  Returns
    ``(fn, info)``; ``fn(params, opt_state, batch, step) -> (params,
    opt_state, metrics)`` runs on ``device`` (default: the CUDA device)
    and returns new tensors (the reference donates its inputs: drop yours).

    ``batch`` holds ``tokens`` and ``labels`` (B, S); with ``mb =
    min(cfg.microbatch_size, B)``, a batch that ``mb`` does not divide
    raises ``ValueError`` (the reference's reshape fails).  Each
    microbatch's ``lm_loss`` gradients (``torch.autograd.grad``, in the
    parameters' dtype) are added into float32 accumulators that start at
    zero — never ``.backward()``, which would accumulate bfloat16 ``.grad``
    — then divided by the microbatch count and handed to
    ``cfg.optimizer`` on ``cosine_schedule(3e-4, 2000, 100_000)``.
    ``metrics`` holds ``loss``, the mean of the microbatch losses, and the
    optimiser's own (AdamW's ``grad_norm``; Adafactor reports none), as the
    reference's; the per-microbatch ``ce`` / ``moe_aux`` are dropped.

    ``compress_grads`` is accepted and unused, as in the reference.  The
    info dict carries the reference's keys: ``params`` and ``opt`` (spec
    trees), ``opt_init``, and ``dummy`` / ``opt_shape`` (meta tensors).
    """
    del compress_grads  # the reference never reads it either
    if isinstance(mesh, DeviceMesh):
        _no_device(device)
        return _train_step_mesh(cfg, mesh)
    dev = resolve_device(device)
    opt_init, opt_update = make_optimizer(
        cfg.optimizer, cosine_schedule(3e-4, 2000, 100_000))

    def step_fn(params, opt_state, batch, step):
        _check_params(params, dev)
        tokens = _on(dev, batch["tokens"])
        labels = _on(dev, batch["labels"])
        b = tokens.shape[0]
        mb = min(cfg.microbatch_size, b)
        if b % mb:
            raise ValueError(f"a batch of {b} does not split into "
                             f"microbatches of {mb}")
        nm = b // mb
        tok_m = tokens.reshape(nm, mb, tokens.shape[1])
        lab_m = labels.reshape(nm, mb, labels.shape[1])
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=dev), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.enable_grad():
            for j in range(nm):
                loss_sum = loss_sum + _microbatch_grads(live, acc, cfg,
                                                        tok_m[j], lab_m[j])
        del live
        grads = tree_map(lambda a: a / nm, acc)
        del acc
        with torch.no_grad():
            new_params, new_opt, stats = opt_update(grads, opt_state, params,
                                                    int(step))
        return new_params, new_opt, {"loss": loss_sum / nm, **stats}

    dummy = lm_init(None, cfg, device="meta")
    pspecs = lm_param_specs(dummy, cfg, mesh=mesh)
    opt_shape = opt_init(dummy)
    return step_fn, dict(params=pspecs, opt=_opt_specs(opt_shape, pspecs),
                         opt_init=opt_init, dummy=dummy, opt_shape=opt_shape)


def build_lm_prefill_step(cfg: LMConfig, mesh=None, *, device=None):
    """Prefill: the full forward over (B, S) and the last position's
    greedy token, int32.  Returns ``(fn, info)``; ``fn(params, tokens)``
    runs on ``device`` (default: the CUDA device), or sharded on a
    :class:`DeviceMesh` ``mesh`` (:func:`_prefill_step_mesh`)."""
    if isinstance(mesh, DeviceMesh):
        _no_device(device)
        return _prefill_step_mesh(cfg, mesh)
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params, tokens):
        _check_params(params, dev)
        h, _ = lm_forward(params, cfg, _on(dev, tokens))
        # the reference takes this argmax in the parameters' dtype
        logits = nn.dense(params["lm_head"], h[:, -1])
        return torch.argmax(logits, dim=-1).to(torch.int32)

    dummy = lm_init(None, cfg, device="meta")
    return prefill, dict(params=lm_param_specs(dummy, cfg, mesh=mesh),
                         dummy=dummy)


def build_lm_decode_step(cfg: LMConfig, mesh=None, *, device=None):
    """One-token decode.  Returns ``(fn, info)``;
    ``fn(params, cache, token, cache_len) -> (next_token, cache)`` writes
    the token's keys and values into ``cache`` in place (the reference
    donates it) and returns it.  On a :class:`DeviceMesh` ``mesh`` the
    cache is sharded (:func:`_decode_step_mesh`)."""
    if isinstance(mesh, DeviceMesh):
        _no_device(device)
        return _decode_step_mesh(cfg, mesh)
    dev = resolve_device(device)
    dp = _dp_spec(mesh)

    @torch.no_grad()
    def decode(params, cache, token, cache_len):
        _check_params(params, dev)
        nt, _, cache = lm_decode_step(params, cfg, _on(dev, token), cache,
                                      _on(dev, cache_len))
        return nt, cache

    dummy = lm_init(None, cfg, device="meta")
    return decode, dict(params=lm_param_specs(dummy, cfg, mesh=mesh),
                        cache=cache_specs(cfg, dp=dp), dummy=dummy)


def lm_input_specs(cfg: LMConfig, shape: dict, *, step: str):
    """Meta tensors standing for each input of a step, per shape-set
    entry (the reference's ``ShapeDtypeStruct``s)."""
    b = shape["global_batch"]
    s = shape["seq_len"]
    meta = lambda *sh: torch.empty(sh, dtype=torch.int32,  # noqa: E731
                                   device="meta")
    if step == "train":
        return dict(batch={"tokens": meta(b, s), "labels": meta(b, s)})
    if step == "prefill":
        return dict(tokens=meta(b, s))
    if step == "decode":
        return dict(cache=init_kv_cache(cfg, b, s, device="meta"),
                    token=meta(b), cache_len=meta(b))
    raise ValueError(step)


# ----------------------------------------------------------------------
# the steps on a device mesh
# ----------------------------------------------------------------------
def _no_device(device):
    if device is not None:
        raise ValueError("a step on a DeviceMesh runs on the mesh's "
                         "devices: pass mesh= or device=, not both")


def _check_sharded(tree, specs, mesh, what: str, path=""):
    """Every leaf of ``tree`` a :class:`~.sharding.ShardedTensor` on
    ``mesh`` laid out by its spec in ``specs``; raises otherwise."""
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            raise ValueError(f"{what}: the tree at {path or '/'} does not "
                             f"match the step's")
        for k in specs:
            _check_sharded(tree[k], specs[k], mesh, what,
                           f"{path}/{k}" if path else k)
        return
    if not sharding.is_sharded(tree):
        raise ValueError(f"{what} {path}: not sharded on the step's mesh "
                         f"(shard them with info['shard'] first)")
    want = sharding._full_spec(specs, tree.ndim)
    if tree.mesh != mesh or tuple(tree.spec) != want:
        raise ValueError(f"{what} {path}: laid out as {tree.spec} on "
                         f"{tree.mesh.shape}, the step wants {want} on "
                         f"{mesh.shape}")


def _shards(tree):
    return tree_map(lambda st: st.shards, tree)


def _rows(plan: MeshPlan, x, n: int, offset: int = 0):
    """Each position's rows of ``n`` host rows of ``x`` from ``offset``:
    the ceil chunk of its index along ``dp`` (a batch that ``|dp|`` does
    not divide leaves the last positions fewer rows, or none, as XLA
    pads an uneven shard)."""
    x = torch.as_tensor(x)
    out = []
    for p, dev in enumerate(plan.lay.devices):
        lo, hi = sharding.chunk(n, plan.dp_size, plan.lay.index(p, plan.dp))
        out.append(x[offset + lo:offset + hi].to(dev))
    return out


def _gather_rows(plan: MeshPlan, xs):
    """The global rows of per-position rows: an all-gather over ``dp``;
    position ``(0, ...)``'s copy."""
    return sharding.all_gather(xs, plan.mesh, plan.dp, 0, "out")[0]


def _sync_grads(plan: MeshPlan, grads, specs):
    """Each gradient shard summed over the positions that hold the same
    shard but saw other data: a leaf without an FSDP dimension over
    ``data`` (its FSDP gradient was reduce-scattered by the gather's
    backward) and every leaf over ``pod`` (parameters are replicated
    across pods)."""
    def leaf(g, spec):
        named = {a for e in spec for a in sharding._axes(e)}
        axes = tuple(a for a in plan.dp if a == "pod" or a not in named)
        return sharding.psum(g, plan.mesh, axes, "grads")

    return tree_map(leaf, grads, specs)


def _train_step_mesh(cfg: LMConfig, mesh):
    """:func:`build_lm_train_step` on a :class:`DeviceMesh`.  ``fn(params,
    opt_state, batch, step)`` takes the parameters and the optimiser
    state as shards (``info["shard"]`` and ``info["opt_init"]`` make
    them) and the host batch; each microbatch (the reference's reshape
    of the global batch) is spread over ``dp``, its ``mb`` rows in ceil
    chunks.  Gradients are
    added into float32 shards (FSDP ones reduce-scattered over ``data``
    by each layer's gather), summed over ``pod`` (and ``data`` for
    leaves without an FSDP dimension), averaged and handed to the
    optimiser shard by shard (AdamW's clip from the global norm,
    :func:`~repro_torch.optim.adamw.global_sq_sum`; Adafactor's means as
    psums).  Returns new shards; ``metrics`` as on one device, on
    position ``(0, ...)``'s device."""
    from ..optim.adafactor import adafactor_update_mesh
    from ..optim.adamw import adamw_update, global_sq_sum

    plan = MeshPlan(mesh, cfg)
    lr = cosine_schedule(3e-4, 2000, 100_000)
    opt_init, _ = make_optimizer(cfg.optimizer, lr)
    dummy = lm_init(None, cfg, device="meta")
    pspecs = lm_param_specs(dummy, cfg, mesh=mesh)
    opt_shape = opt_init(dummy)
    ospecs = _opt_specs(opt_shape, pspecs)

    def init(params):
        _check_sharded(params, pspecs, mesh, "parameters")
        return sharding.zeros_like_specs(opt_shape, ospecs, mesh)

    def step_fn(params, opt_state, batch, step):
        _check_sharded(params, pspecs, mesh, "parameters")
        _check_sharded(opt_state, ospecs, mesh, "optimiser state")
        tokens = torch.as_tensor(batch["tokens"])
        labels = torch.as_tensor(batch["labels"])
        b = tokens.shape[0]
        mb = min(cfg.microbatch_size, b)
        if b % mb:
            raise ValueError(f"a batch of {b} does not split into "
                             f"microbatches of {mb}")
        nm = b // mb
        live = tree_map(lambda st: [x.detach().requires_grad_(True)
                                    for x in st.shards], params)
        acc = tree_map(lambda st: [torch.zeros(x.shape, dtype=torch.float32,
                                               device=x.device)
                                   for x in st.shards], params)
        flat = [x for leaf in tree_leaves(live) for x in leaf]
        flat_acc = [x for leaf in tree_leaves(acc) for x in leaf]
        loss_sum = torch.zeros((), dtype=torch.float32, device=mesh.first)
        with torch.enable_grad():
            for j in range(nm):
                tok = _rows(plan, tokens, mb, j * mb)
                lab = _rows(plan, labels, mb, j * mb)
                loss_sum = loss_sum + _microbatch_grads_mesh(
                    plan, live, pspecs, cfg, tok, lab, mb, flat, flat_acc)
        del live, flat
        grads = _sync_grads(plan, tree_map(
            lambda a: [x / nm for x in a], acc), pspecs)
        del acc, flat_acc
        with torch.no_grad():
            if cfg.optimizer == "adamw":
                gsq = global_sq_sum(mesh, grads, pspecs)
                outs = []
                for p in range(plan.lay.n):
                    pick = lambda t: tree_map(  # noqa: E731
                        lambda x: x.shards[p] if sharding.is_sharded(x)
                        else x[p], t)
                    outs.append(adamw_update(
                        pick(grads), pick(opt_state), pick(params),
                        int(step), lr=lr, gsq=gsq[p]))
                new_params = _assemble(params, [o[0] for o in outs])
                new_opt = _assemble(opt_state, [o[1] for o in outs])
                stats = outs[0][2]
            else:
                new_params, new_opt, stats = adafactor_update_mesh(
                    mesh, grads, opt_state, params, int(step), lr=lr)
        return new_params, new_opt, {"loss": loss_sum / nm, **stats}

    return step_fn, dict(params=pspecs, opt=ospecs, opt_init=init,
                         dummy=dummy, opt_shape=opt_shape, plan=plan,
                         shard=lambda t: sharding.shard_tree(t, pspecs, mesh))


def _microbatch_grads_mesh(plan, live, specs, cfg, tokens, labels, rows,
                           flat, flat_acc):
    """One microbatch on the mesh: :func:`lm_loss_mesh`'s gradients with
    respect to every position's shards (``flat``), each position's loss
    seeded with one, added into the float32 shards ``flat_acc``.
    Returns the microbatch's loss, detached, on position ``(0, ...)``."""
    loss, _ = lm_loss_mesh(plan, live, specs, cfg, tokens, labels, rows)
    grads = torch.autograd.grad(loss, flat,
                                grad_outputs=[torch.ones_like(x)
                                              for x in loss],
                                allow_unused=True)
    for a, g in zip(flat_acc, grads):
        if g is not None:
            a.add_(g)
    return loss[0].detach()


def _assemble(like, per_position):
    """The tree of :class:`~.sharding.ShardedTensor` ``like`` with the
    shards of ``per_position`` (one tree of tensors a position)."""
    def walk(node, trees):
        if isinstance(node, dict):
            return {k: walk(node[k], [t[k] for t in trees]) for k in node}
        return node.with_shards(trees)

    return walk(like, per_position)


def _prefill_step_mesh(cfg: LMConfig, mesh):
    """:func:`build_lm_prefill_step` on a :class:`DeviceMesh`:
    ``fn(params, tokens)`` takes sharded parameters and the host (B, S)
    tokens, B over ``dp`` in ceil chunks; the forward runs sharded and the last
    position's greedy token is an argmax across the vocabulary shards.
    Returns the (B,) int32 tokens on position ``(0, ...)``'s device."""
    plan = MeshPlan(mesh, cfg)
    dummy = lm_init(None, cfg, device="meta")
    pspecs = lm_param_specs(dummy, cfg, mesh=mesh)
    from .transformer import _head_mesh, argmax_mesh

    @torch.no_grad()
    def prefill(params, tokens):
        _check_sharded(params, pspecs, mesh, "parameters")
        tokens = torch.as_tensor(tokens)
        toks = _rows(plan, tokens, tokens.shape[0])
        lists = _shards(params)
        hs, _ = lm_forward_mesh(plan, lists, pspecs, cfg, toks)
        heads = _head_mesh(plan, lists, pspecs)
        # the reference takes this argmax in the parameters' dtype
        logits = [nn.matmul(h[:, -1], w) for h, w in zip(hs, heads)]
        return _gather_rows(plan, argmax_mesh(plan, logits, cfg.vocab)
                            ).to(torch.int32)

    return prefill, dict(params=pspecs, dummy=dummy, plan=plan,
                         shard=lambda t: sharding.shard_tree(t, pspecs, mesh))


def _decode_step_mesh(cfg: LMConfig, mesh):
    """:func:`build_lm_decode_step` on a :class:`DeviceMesh`:
    ``fn(params, cache, token, cache_len)`` takes sharded parameters, a
    cache sharded by :func:`cache_specs` (``info["init_cache"](batch,
    max_len)`` makes one) and the host (B,) tokens and lengths, B over
    ``dp`` in ceil chunks; it writes the cache shards in place and
    returns ``(next tokens (B,) on position (0, ...)'s device, cache)``."""
    plan = MeshPlan(mesh, cfg)
    dummy = lm_init(None, cfg, device="meta")
    pspecs = lm_param_specs(dummy, cfg, mesh=mesh)
    cspecs = cache_specs(cfg, dp=_dp_spec(mesh))

    def init_cache(batch: int, max_len: int, dtype=None):
        meta = init_kv_cache(cfg, batch, max_len, dtype, device="meta")
        return sharding.zeros_like_specs(meta, cspecs, mesh)

    @torch.no_grad()
    def decode(params, cache, token, cache_len):
        _check_sharded(params, pspecs, mesh, "parameters")
        _check_sharded(cache, cspecs, mesh, "cache")
        token = torch.as_tensor(token)
        b = token.shape[0]
        s_total = next(iter(cache.values())).shape[2]
        nt, _, _ = lm_decode_step_mesh(
            plan, _shards(params), pspecs, cfg, _rows(plan, token, b),
            _shards(cache), _rows(plan, cache_len, b), s_total)
        return _gather_rows(plan, nt), cache

    return decode, dict(params=pspecs, cache=cspecs, dummy=dummy, plan=plan,
                        init_cache=init_cache,
                        shard=lambda t: sharding.shard_tree(t, pspecs, mesh))
