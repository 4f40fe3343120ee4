"""Transformer LM covering the five LM architectures (the JAX package's
``models/transformer.py``).

Features: GQA with optional QKV bias, full/partial RoPE, SwiGLU FFN, MoE
(top-k, shared experts, capacity dispatch), MLA (DeepSeek low-rank
attention, absorbed-matmul decode), the MTP auxiliary head, bfloat16
parameters as configured.

Parameter tree layout (the reference's; stacked layers carry a leading L
dimension):

    {"embed": .., "layers": {...}, ["dense_layers": {...}],
     "final_norm": .., "lm_head": .., ["mtp": {...}]}

A Python loop over L replaces the reference's ``lax.scan``.  The forward
pass and the loss are differentiable with ``torch.autograd``: each stack
is unbound once a forward (one ``UnbindBackward`` stacks the layers'
gradients, where indexing layer by layer would build a zero ``(L, ...)``
gradient per layer), and under ``cfg.remat`` — while grad is enabled —
each layer runs inside ``torch.utils.checkpoint`` (non-reentrant), the
reference's ``jax.checkpoint`` of the scan body: its activations are
recomputed in the backward.  The MTP layer is not rematerialised, as in
the reference; prefill and decode run without grad and are untouched.
Decode writes each new key and value into the cache in place — the
reference donates the cache — and clamps the write position to the last
slot, as ``lax.dynamic_update_slice_in_dim`` clamps its start.

The ``*_mesh`` half runs the same model over a device mesh, in lockstep
over lists with one tensor a position (:mod:`.sharding`), laid out by
``steps.lm_param_specs`` (:class:`MeshPlan`): each layer all-gathers its
FSDP weights over ``data`` first, then its products are column- and
row-parallel over ``model``, its attention the reference's
sequence-parallel layout, its MoE expert-parallel; the embedding, the
loss and the greedy token are sharded by vocabulary.  A layer under remat
runs inside :class:`_Remat` (by hand, not ``torch.utils.checkpoint``:
see there), whose backward gathers the weights again.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ..device import resolve_device
from . import nn, sharding
from .attention import (_scalar, apply_rope, causal_attention,
                        causal_attention_rows, chunk_sizes, decode_attention,
                        decode_combine)
from .moe import (moe_apply, moe_apply_mesh, moe_init, swiglu_apply,
                  swiglu_init)

__all__ = ["lm_init", "lm_loss", "lm_forward", "lm_decode_step",
           "init_kv_cache", "lm_logits"]


def _torch_dtype(name) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, …)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _stack_sizes(cfg: LMConfig):
    """``(dense_layers, layers)``: the layers of the dense stack (0 where
    the tree has none) and of the main stack."""
    if cfg.moe:
        return cfg.first_dense_layers, cfg.n_layers - cfg.first_dense_layers
    return 0, cfg.n_layers


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def _attn_init(gen, cfg: LMConfig, dtype, device, lead):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kw = dict(dtype=dtype, device=device, lead=lead)
    if cfg.mla:
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return {
            "q_down": nn.dense_init(gen, d, qr, **kw),
            "q_up": nn.dense_init(gen, qr, h * (nope + rope), **kw),
            "kv_down": nn.dense_init(gen, d, kvr + rope, **kw),
            "k_up": nn.dense_init(gen, kvr, h * nope, **kw),
            "v_up": nn.dense_init(gen, kvr, h * vd, **kw),
            "wo": nn.dense_init(gen, h * vd, d, **kw),
            "ln_q": nn.rmsnorm_init(qr, dtype, device, lead),
            "ln_kv": nn.rmsnorm_init(kvr, dtype, device, lead),
        }
    return {
        "wq": nn.dense_init(gen, d, h * dh, bias=cfg.qkv_bias, **kw),
        "wk": nn.dense_init(gen, d, kv * dh, bias=cfg.qkv_bias, **kw),
        "wv": nn.dense_init(gen, d, kv * dh, bias=cfg.qkv_bias, **kw),
        "wo": nn.dense_init(gen, h * dh, d, **kw),
    }


def _layer_init(gen, cfg: LMConfig, *, moe_layer: bool, dtype, device,
                lead=()):
    p = {
        "ln1": nn.rmsnorm_init(cfg.d_model, dtype, device, lead),
        "ln2": nn.rmsnorm_init(cfg.d_model, dtype, device, lead),
        "attn": _attn_init(gen, cfg, dtype, device, lead),
    }
    if moe_layer:
        p["moe"] = moe_init(gen, cfg.d_model, cfg.n_experts, cfg.moe_d_ff,
                            n_shared=cfg.n_shared_experts, dtype=dtype,
                            device=device, lead=lead)
    else:
        p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                               device=device, lead=lead)
    return p


def lm_init(gen: Optional[torch.Generator], cfg: LMConfig, *,
            device=None) -> Dict[str, Any]:
    """Random parameters in the reference's tree and the config's dtype,
    drawn from ``gen`` on ``device`` (``None`` is the GPU; ``"meta"``
    allocates nothing: shapes and dtypes only)."""
    dtype = _torch_dtype(cfg.dtype)
    device = resolve_device(device)
    n_dense, n_main = _stack_sizes(cfg)
    params: Dict[str, Any] = {
        "embed": nn.embed_init(gen, cfg.vocab, cfg.d_model, dtype, device),
        "final_norm": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "lm_head": nn.dense_init(gen, cfg.d_model, cfg.vocab, dtype=dtype,
                                 device=device),
    }
    if n_dense:
        params["dense_layers"] = _layer_init(
            gen, cfg, moe_layer=False, dtype=dtype, device=device,
            lead=(n_dense,))
    params["layers"] = _layer_init(gen, cfg, moe_layer=cfg.moe, dtype=dtype,
                                   device=device, lead=(n_main,))
    if cfg.mtp:
        params["mtp"] = {
            "proj": nn.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                  dtype=dtype, device=device),
            "layer": _layer_init(gen, cfg, moe_layer=False, dtype=dtype,
                                 device=device),
            "norm_h": nn.rmsnorm_init(cfg.d_model, dtype, device),
            "norm_e": nn.rmsnorm_init(cfg.d_model, dtype, device),
        }
    return params


def _layer(stack, i: int):
    """Layer ``i`` of a stacked subtree (views, nothing copied)."""
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def _unbound(stack, n: int):
    """The ``n`` layers of a stacked subtree, each leaf unbound once (views,
    nothing copied; their gradients stack back in one operation)."""
    if isinstance(stack, dict):
        per_key = {k: _unbound(v, n) for k, v in stack.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return torch.unbind(stack, 0)


def _stacks(params, cfg: LMConfig):
    """``(stack, moe_layer, first cache layer, n)`` in the order the
    layers run: the dense stack first, then the main one."""
    n_dense, n_main = _stack_sizes(cfg)
    out = []
    if n_dense:
        out.append((params["dense_layers"], False, 0, n_dense))
    out.append((params["layers"], cfg.moe, n_dense, n_main))
    return out


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
def _attn_train(p, cfg: LMConfig, x, positions):
    """GQA or MLA attention over the whole sequence."""
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    chunks = dict(q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    if cfg.mla:
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kvr = cfg.kv_lora_rank
        cq = nn.rmsnorm(p["ln_q"], nn.dense(p["q_down"], x))
        q = nn.dense(p["q_up"], cq).reshape(b, s, h, nope + rope)
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        q_rope = apply_rope(q_rope, positions, theta=cfg.rope_theta)
        ckv_full = nn.dense(p["kv_down"], x)
        ckv = nn.rmsnorm(p["ln_kv"], ckv_full[..., :kvr])
        k_rope = ckv_full[..., kvr:].reshape(b, s, 1, rope)
        k_rope = apply_rope(k_rope, positions, theta=cfg.rope_theta)
        k_nope = nn.dense(p["k_up"], ckv).reshape(b, s, h, nope)
        v = nn.dense(p["v_up"], ckv).reshape(b, s, h, vd)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
        out = causal_attention(q_full, k_full, v, **chunks)
        return nn.dense(p["wo"], out.reshape(b, s, h * vd))
    q = nn.dense(p["wq"], x).reshape(b, s, h, dh)
    k = nn.dense(p["wk"], x).reshape(b, s, kv, dh)
    v = nn.dense(p["wv"], x).reshape(b, s, kv, dh)
    rope_kw = dict(fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    q = apply_rope(q, positions, **rope_kw)
    k = apply_rope(k, positions, **rope_kw)
    out = causal_attention(q, k, v, **chunks)
    return nn.dense(p["wo"], out.reshape(b, s, h * dh))


def _layer_apply(p, cfg: LMConfig, x, positions, *, moe_layer: bool):
    h = x + _attn_train(p["attn"], cfg, nn.rmsnorm(p["ln1"], x), positions)
    z = nn.rmsnorm(p["ln2"], h)
    if moe_layer:
        b, s, d = z.shape
        y, aux = moe_apply(p["moe"], z.reshape(b * s, d), top_k=cfg.top_k)
        return h + y.reshape(b, s, d), aux
    return h + swiglu_apply(p["ffn"], z), torch.zeros((), device=x.device)


def _positions(tokens):
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None, :].expand(b, s)


def lm_forward(params, cfg: LMConfig, tokens):
    """tokens (B, S) -> hidden states (B, S, d) + the MoE aux loss."""
    x = params["embed"]["table"][tokens.long()]
    positions = _positions(tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), device=x.device)
    for stack, moe_layer, _, n in _stacks(params, cfg):
        aux = torch.zeros((), device=x.device)
        for lp in _unbound(stack, n):
            if remat:
                x, a = checkpoint(_layer_apply, lp, cfg, x, positions,
                                  moe_layer=moe_layer, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = _layer_apply(lp, cfg, x, positions,
                                    moe_layer=moe_layer)
            aux = aux + a
        aux_total = aux_total + aux
    return nn.rmsnorm(params["final_norm"], x), aux_total


def lm_logits(params, h):
    """The LM head's float32 logits: the product in the parameters' dtype,
    cast after it, as the reference casts."""
    return nn.dense(params["lm_head"], h).to(torch.float32)


def _ce(logits, labels):
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def lm_loss(params, cfg: LMConfig, tokens, labels):
    """Next-token CE (+ MoE aux + MTP aux).  tokens/labels: (B, S).
    Returns ``(total, {"ce", "moe_aux"[, "mtp_ce"]})``."""
    h, aux = lm_forward(params, cfg, tokens)
    ce = _ce(lm_logits(params, h), labels)
    total = ce + 0.01 * aux
    metrics = {"ce": ce, "moe_aux": aux}
    if cfg.mtp:
        # MTP: predict token t+2 from (h_t, emb(label_t)) through one extra
        # layer (DeepSeek-V3 §2.2), on a shifted slice
        p = params["mtp"]
        emb_next = params["embed"]["table"][labels.long()]
        cat = torch.cat([nn.rmsnorm(p["norm_h"], h),
                         nn.rmsnorm(p["norm_e"], emb_next)], dim=-1)
        h2 = nn.dense(p["proj"], cat)
        h2, _ = _layer_apply(p["layer"], cfg, h2, _positions(tokens),
                             moe_layer=False)
        mtp_ce = _ce(lm_logits(params, h2[:, :-1]), labels[:, 1:])
        total = total + 0.3 * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return total, metrics


# ----------------------------------------------------------------------
# decode (serving)
# ----------------------------------------------------------------------
def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
                  device=None):
    """The per-layer stacked KV cache: ``k``/``v`` of (L, B, S, KV, dh),
    or MLA's latent ``ckv`` (L, B, S, kv_lora) and ``k_rope``
    (L, B, S, rope), zeros, on ``device`` (``None`` is the GPU)."""
    kw = dict(dtype=_torch_dtype(dtype or cfg.dtype),
              device=resolve_device(device))
    n = cfg.n_layers
    if cfg.mla:
        return {
            "ckv": torch.zeros((n, batch, max_len, cfg.kv_lora_rank), **kw),
            "k_rope": torch.zeros((n, batch, max_len, cfg.qk_rope_dim), **kw),
        }
    shape = (n, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def _write(cache, new, pos):
    """``cache[b, pos[b]] = new[b]`` in place, the position clamped to the
    cache as ``lax.dynamic_update_slice_in_dim`` clamps its start: a write
    at ``pos >= max_len`` lands in the last slot."""
    b, s = cache.shape[:2]
    idx = torch.clamp(pos.long(), 0, s - 1)
    cache[torch.arange(b, device=cache.device), idx] = new.to(cache.dtype)
    return cache


def _attn_decode(p, cfg: LMConfig, x, cache_layer, cache_len):
    """x: (B, d) one token a row; writes its keys and values into
    ``cache_layer`` (views of the stacked cache) and returns (B, d)."""
    b, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pos = cache_len  # (B,) the current position
    if cfg.mla:
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kvr = cfg.kv_lora_rank
        cq = nn.rmsnorm(p["ln_q"], nn.dense(p["q_down"], x))
        q = nn.dense(p["q_up"], cq).reshape(b, h, nope + rope)
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        q_rope = apply_rope(q_rope[:, None], pos[:, None],
                            theta=cfg.rope_theta)[:, 0]
        ckv_full = nn.dense(p["kv_down"], x)
        ckv_new = nn.rmsnorm(p["ln_kv"], ckv_full[..., :kvr])
        kr_new = apply_rope(ckv_full[..., kvr:][:, None, None], pos[:, None],
                            theta=cfg.rope_theta)[:, 0, 0]
        ckv_c = _write(cache_layer["ckv"], ckv_new, pos)
        kr_c = _write(cache_layer["k_rope"], kr_new, pos)
        # absorbed decode: q_eff[b,h,r] = sum_n q_nope[b,h,n] * k_up[r,h,n],
        # a product in the parameters' dtype (no preferred type there)
        k_up = p["k_up"]["w"].reshape(kvr, h, nope)
        q_eff = torch.einsum("bhn,rhn->bhr", q_nope, k_up)
        s_len = ckv_c.shape[1]
        ckv_f = ckv_c.float()
        sc = torch.einsum("bhr,bsr->bhs", q_eff.float(), ckv_f)
        sc = sc + torch.einsum("bhr,bsr->bhs", q_rope.float(), kr_c.float())
        sc = sc * ((nope + rope) ** -0.5)
        mask = torch.arange(s_len, device=x.device)[None, :] <= pos[:, None]
        sc = torch.where(mask[:, None, :], sc, -torch.inf)
        w = torch.softmax(sc, dim=-1)
        ctx = torch.einsum("bhs,bsr->bhr", w, ckv_f)
        v_up = p["v_up"]["w"].reshape(kvr, h, vd)
        out = torch.einsum("bhr,rhv->bhv", ctx, v_up.float()).to(x.dtype)
        return nn.dense(p["wo"], out.reshape(b, h * vd))
    q = nn.dense(p["wq"], x).reshape(b, h, dh)
    k_new = nn.dense(p["wk"], x).reshape(b, kv, dh)
    v_new = nn.dense(p["wv"], x).reshape(b, kv, dh)
    rope_kw = dict(fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    q = apply_rope(q[:, None], pos[:, None], **rope_kw)[:, 0]
    k_new = apply_rope(k_new[:, None], pos[:, None], **rope_kw)[:, 0]
    k_c = _write(cache_layer["k"], k_new, pos)
    v_c = _write(cache_layer["v"], v_new, pos)
    out = decode_attention(q, k_c, v_c, pos + 1)
    return nn.dense(p["wo"], out.reshape(b, h * dh))


def lm_decode_step(params, cfg: LMConfig, token, cache, cache_len):
    """One greedy decode step.

    token: (B,) integer; cache: the stacked per-layer dict, updated in
    place; cache_len: (B,).  Returns (next_token (B,) in ``token``'s dtype,
    logits (B, V) float32, the same cache).
    """
    x = params["embed"]["table"][token.long()]
    for stack, moe_layer, first, n in _stacks(params, cfg):
        for i in range(n):
            lp = _layer(stack, i)
            cache_layer = {k: c[first + i] for k, c in cache.items()}
            z = nn.rmsnorm(lp["ln1"], x)
            h = x + _attn_decode(lp["attn"], cfg, z, cache_layer, cache_len)
            z2 = nn.rmsnorm(lp["ln2"], h)
            if moe_layer:
                y, _ = moe_apply(lp["moe"], z2, top_k=cfg.top_k)
                x = h + y
            else:
                x = h + swiglu_apply(lp["ffn"], z2)
    logits = lm_logits(params, nn.rmsnorm(params["final_norm"], x))
    next_token = torch.argmax(logits, dim=-1).to(token.dtype)
    return next_token, logits, cache


# ----------------------------------------------------------------------
# on a device mesh (lists with one tensor a position; see .sharding)
# ----------------------------------------------------------------------
class MeshPlan:
    """The layout a mesh step runs under: the mesh, its tensor-parallel
    axis ``tp`` (``model``), the batch's axes ``dp`` (``pod``, ``data``,
    those the mesh has), the FSDP axis ``fsdp`` (``data``) and whether
    the experts lie over ``tp`` (``ep``, the specs' ``ep_ok``); an axis
    the mesh lacks is ``()``."""

    def __init__(self, mesh, cfg: LMConfig):
        self.mesh = mesh
        self.lay = sharding.layout(mesh)
        names = self.lay.names
        self.tp = "model" if "model" in names else ()
        self.fsdp = "data" if "data" in names else ()
        self.dp = tuple(a for a in ("pod", "data") if a in names)
        self.tp_size = self.lay.size(self.tp)
        self.dp_size = self.lay.size(self.dp)
        self.ep = (cfg.n_experts == 0 or self.tp_size <= 1
                   or cfg.n_experts % self.tp_size == 0)

    def tp_chunk(self, n: int, p: int):
        """Position ``p``'s ``[lo, hi)`` of a dimension of ``n`` over
        ``tp``."""
        return sharding.chunk(n, self.tp_size, self.lay.index(p, self.tp))


def _gather_fsdp(plan: MeshPlan, tree, specs):
    """Every leaf's FSDP dimensions all-gathered over ``data`` (their TP
    dimensions stay sharded): a tree of lists."""
    if isinstance(tree, dict):
        return {k: _gather_fsdp(plan, v, specs[k]) for k, v in tree.items()}
    for d, e in enumerate(specs):
        if plan.fsdp and plan.fsdp in sharding._axes(e):
            tree = sharding.all_gather(tree, plan.mesh, plan.fsdp, d,
                                       "params")
    return tree


def _unstacked_specs(specs):
    """A stacked subtree's specs without their leading layer dimension."""
    if isinstance(specs, dict):
        return {k: _unstacked_specs(v) for k, v in specs.items()}
    return tuple(specs[1:])


def _unbound_mesh(stack, n: int):
    """The ``n`` layers of a stacked subtree of lists, each position's
    shard unbound once."""
    if isinstance(stack, dict):
        per_key = {k: _unbound_mesh(v, n) for k, v in stack.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    per_pos = [torch.unbind(x, 0) for x in stack]
    return [[u[i] for u in per_pos] for i in range(n)]


def _pm(fn, *lists):
    return [fn(*args) for args in zip(*lists)]


def _attn_train_mesh(plan: MeshPlan, p, cfg: LMConfig, zs, positions):
    """:func:`_attn_train` on the mesh, in the reference's
    sequence-parallel layout: the projections column-parallel over ``tp``
    and all-gathered (k and v replicated over ``tp``), each position
    attending for its share of the q chunks (``nq_multiple = tp``), the
    output all-gathered along the sequence and ``wo`` row-parallel."""
    mesh, tp = plan.mesh, plan.tp
    s = zs[0].shape[1]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gather = lambda ys: sharding.all_gather(ys, mesh, tp, -1)  # noqa: E731
    if cfg.mla:
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kvr = cfg.kv_lora_rank
        cq = _pm(lambda z, w, ln: nn.rmsnorm(ln, nn.dense({"w": w}, z)), zs,
                 p["q_down"]["w"], _leaf_list(p["ln_q"]))
        q = gather(nn.dense_col(mesh, p["q_up"],
                                sharding.replicate(cq, mesh, tp), tp=tp))
        q = [x.reshape(x.shape[0], s, h, nope + rope) for x in q]
        ckv_full = _pm(lambda z, w: nn.dense({"w": w}, z), zs,
                       p["kv_down"]["w"])
        ckv = _pm(lambda c, ln: nn.rmsnorm(ln, c[..., :kvr]), ckv_full,
                  _leaf_list(p["ln_kv"]))
        k_rope = _pm(lambda c, pos: apply_rope(
            c[..., kvr:].reshape(c.shape[0], s, 1, rope), pos,
            theta=cfg.rope_theta),
            ckv_full, positions)
        k_rope = sharding.replicate(k_rope, mesh, tp)
        ckv = sharding.replicate(ckv, mesh, tp)
        k_nope = gather(nn.dense_col(mesh, p["k_up"], ckv, tp=tp))
        v = gather(nn.dense_col(mesh, p["v_up"], ckv, tp=tp))
        qs, ks, vs = [], [], []
        for i in range(plan.lay.n):
            b = zs[i].shape[0]
            q_nope, q_rope = q[i][..., :nope], q[i][..., nope:]
            q_rope = apply_rope(q_rope, positions[i], theta=cfg.rope_theta)
            qs.append(torch.cat([q_nope, q_rope], dim=-1))
            ks.append(torch.cat([k_nope[i].reshape(b, s, h, nope),
                                 k_rope[i].expand(b, s, h, rope)], dim=-1))
            vs.append(v[i].reshape(b, s, h, vd))
        width = h * vd
    else:
        zr = sharding.replicate(zs, mesh, tp)
        rope_kw = dict(fraction=cfg.rope_fraction, theta=cfg.rope_theta)
        q = gather(nn.dense_col(mesh, p["wq"], zr, tp=tp))
        k = gather(nn.dense_col(mesh, p["wk"], zr, tp=tp))
        v = gather(nn.dense_col(mesh, p["wv"], zr, tp=tp))
        qs = _pm(lambda x, pos: apply_rope(
            x.reshape(x.shape[0], s, h, dh), pos, **rope_kw), q, positions)
        ks = _pm(lambda x, pos: apply_rope(
            x.reshape(x.shape[0], s, kv, dh), pos, **rope_kw), k, positions)
        vs = [x.reshape(x.shape[0], s, kv, dh) for x in v]
        width = h * dh
    qc, kc = chunk_sizes(s, cfg.attn_q_chunk, cfg.attn_kv_chunk,
                         nq_multiple=max(plan.tp_size, 1))
    outs = []
    for i in range(plan.lay.n):
        c0, c1 = plan.tp_chunk(s // qc, i)
        o = causal_attention_rows(qs[i][:, c0 * qc:c1 * qc], ks[i], vs[i],
                                  qc=qc, kc=kc, q0=c0 * qc)
        outs.append(o.reshape(o.shape[0], (c1 - c0) * qc, width))
    outs = sharding.all_gather(outs, mesh, tp, 1)  # back to the sequence
    cols = []
    for i, o in enumerate(outs):
        lo, hi = plan.tp_chunk(width, i)
        cols.append(o[..., lo:hi])
    return nn.dense_row(mesh, p["wo"], cols, tp=tp)


def _leaf_list(p):
    """A norm's ``scale`` list."""
    return [{"scale": s} for s in p["scale"]]


def _ffn_mesh(plan: MeshPlan, p, zs):
    """:func:`swiglu_apply` column-parallel (``w_gate``, ``w_in``) then
    row-parallel (``w_out``) over ``tp``."""
    zr = sharding.replicate(zs, plan.mesh, plan.tp)
    hid = [nn.silu(nn.matmul(z, wg)) * nn.matmul(z, wi)
           for z, wg, wi in zip(zr, p["w_gate"], p["w_in"])]
    return nn.dense_row(plan.mesh, {"w": p["w_out"]}, hid, tp=plan.tp)


def _flatten(tree):
    """The tensors of a nested dict / list / tuple, in order, and a
    function that rebuilds the structure from such a list."""
    if isinstance(tree, dict):
        parts = [_flatten(tree[k]) for k in tree]
        keys = list(tree)
    elif isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        keys = None
    else:
        return [tree], lambda flat: flat[0]
    sizes = [len(p[0]) for p in parts]

    def rebuild(flat):
        out, i = [], 0
        for (_, re), n in zip(parts, sizes):
            out.append(re(flat[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [x for p in parts for x in p[0]], rebuild


class _Remat(torch.autograd.Function):
    """A layer on the mesh rematerialised by hand: the forward runs it
    without grad and keeps only its inputs; the backward runs it again
    with grad (its FSDP weights gathered again) and differentiates that.
    ``torch.utils.checkpoint``'s non-reentrant recompute starts from
    whichever autograd thread first unpacks a saved tensor, and with
    positions on several cards two device threads start it at once; this
    node's backward runs once, on one thread."""

    @staticmethod
    def forward(ctx, fn, rebuild, out_box, *flat):
        ctx.fn, ctx.rebuild = fn, rebuild
        ctx.save_for_backward(*flat)
        leaves, out_box[0] = _flatten(fn(*rebuild(flat)))
        return tuple(leaves)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [x.detach().requires_grad_(x.requires_grad)
                  for x in ctx.saved_tensors]
        with torch.enable_grad():
            outs, _ = _flatten(ctx.fn(*ctx.rebuild(inputs)))
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        want = [i for i, x in enumerate(inputs) if x.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [inputs[i] for i in want],
                                  [g for _, g in pairs], allow_unused=True)
        out = [None] * len(inputs)
        for i, g in zip(want, got):
            out[i] = g
        return (None, None, None, *out)


def _remat(fn, *args):
    """``fn(*args)`` (tensors in nested dicts and lists) under
    :class:`_Remat`."""
    flat, rebuild = _flatten(list(args))
    box = [None]
    out = _Remat.apply(fn, rebuild, box, *flat)
    return box[0](list(out))


def _layer_apply_mesh(plan: MeshPlan, lp, xs, *, specs, cfg: LMConfig,
                      positions, moe_layer: bool):
    """One layer at every position: its FSDP dimensions all-gathered
    over ``data`` first (inside the remat boundary, so a recompute
    gathers again), then :func:`_layer_apply`'s computation."""
    lp = _gather_fsdp(plan, lp, specs)
    zs = _pm(lambda x, s: nn.rmsnorm({"scale": s}, x), xs,
             lp["ln1"]["scale"])
    att = _attn_train_mesh(plan, lp["attn"], cfg, zs, positions)
    hs = [x + a for x, a in zip(xs, att)]
    z2 = _pm(lambda h, s: nn.rmsnorm({"scale": s}, h), hs,
             lp["ln2"]["scale"])
    if moe_layer:
        mp = dict(lp["moe"])
        mp["router"] = [{"w": w} for w in lp["moe"]["router"]["w"]]
        ys, aux = moe_apply_mesh(plan.mesh, mp, [z.flatten(0, 1)
                                                 for z in z2],
                                 top_k=cfg.top_k, ep=plan.ep, tp=plan.tp,
                                 dp=plan.dp)
        return ([h + y.reshape(h.shape) for h, y in zip(hs, ys)], aux)
    ys = _ffn_mesh(plan, lp["ffn"], z2)
    return ([h + y for h, y in zip(hs, ys)],
            [torch.zeros((), device=x.device) for x in xs])


def _embed_mesh(plan: MeshPlan, params, tokens, vocab: int):
    return nn.embed_mesh(plan.mesh, params["embed"]["table"], tokens, vocab,
                         tp=plan.tp)


def lm_forward_mesh(plan: MeshPlan, params, specs, cfg: LMConfig, tokens):
    """:func:`lm_forward` on the mesh: ``params`` a tree of lists (each
    position's shards), ``specs`` their specs, ``tokens`` each
    position's (B/|dp|, S) rows.  Returns the hidden states and each
    position's share of the MoE aux loss, lists."""
    xs = _embed_mesh(plan, params, tokens, cfg.vocab)
    positions = [_positions(t) for t in tokens]
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = [torch.zeros((), device=x.device) for x in xs]
    n_dense, n_main = _stack_sizes(cfg)
    stacks = ([("dense_layers", False, n_dense)] if n_dense else []) + [
        ("layers", cfg.moe, n_main)]
    for key, moe_layer, n in stacks:
        lspecs = _unstacked_specs(specs[key])
        for lp in _unbound_mesh(params[key], n):
            if remat:
                xs, a = _remat(functools.partial(
                    _layer_apply_mesh, plan, specs=lspecs, cfg=cfg,
                    positions=positions, moe_layer=moe_layer), lp, xs)
            else:
                xs, a = _layer_apply_mesh(plan, lp, xs, specs=lspecs, cfg=cfg,
                                          positions=positions,
                                          moe_layer=moe_layer)
            aux_total = [t + x for t, x in zip(aux_total, a)]
    hs = _pm(lambda x, s: nn.rmsnorm({"scale": s}, x), xs,
             params["final_norm"]["scale"])
    return hs, aux_total


def _head_mesh(plan: MeshPlan, params, specs):
    return _gather_fsdp(plan, params["lm_head"]["w"], specs["lm_head"]["w"])


def _vocab_ce(plan: MeshPlan, heads, hs, labels, vocab: int, n: int):
    """Each position's share of the mean CE over ``n`` global tokens,
    from logits sharded by vocabulary over ``tp``: the max a pmax, the
    exponent sum and the gold logit psums; the float32 logits are never
    gathered whole."""
    mesh, tp = plan.mesh, plan.tp
    hr = sharding.replicate(hs, mesh, tp)
    logits = [nn.matmul(h, w).to(torch.float32) for h, w in zip(hr, heads)]
    gmax = sharding.pmax([lg.amax(dim=-1) for lg in logits], mesh, tp)
    sums = sharding.psum([torch.exp(lg - g[..., None]).sum(dim=-1)
                          for lg, g in zip(logits, gmax)], mesh, tp)
    golds = []
    for i, (lg, lab) in enumerate(zip(logits, labels)):
        lo, hi = plan.tp_chunk(vocab, i)
        lab = lab.long()
        got = torch.gather(lg, -1, torch.clamp(lab - lo, 0, hi - lo - 1)
                           [..., None])[..., 0]
        golds.append(torch.where((lab >= lo) & (lab < hi), got, 0.0))
    golds = sharding.psum(golds, mesh, tp)
    return [(torch.log(s_) + g - gd).sum() / n
            for s_, g, gd in zip(sums, gmax, golds)]


def lm_loss_mesh(plan: MeshPlan, params, specs, cfg: LMConfig, tokens,
                 labels, n_rows: int):
    """:func:`lm_loss` on the mesh for a microbatch of ``n_rows`` global
    rows (each position holds its rows of it).  Returns ``(total,
    metrics)``: ``total`` the microbatch's loss on every position (a psum
    over ``dp`` of each position's share; its backward hands every share
    the loss's gradient), ``metrics`` the reference's ``ce``, ``moe_aux``
    (and ``mtp_ce``) as the same psums, detached."""
    mesh = plan.mesh
    s = tokens[0].shape[1]
    hs, aux = lm_forward_mesh(plan, params, specs, cfg, tokens)
    heads = _head_mesh(plan, params, specs)
    ce = _vocab_ce(plan, heads, hs, labels, cfg.vocab, n_rows * s)
    total = [c + 0.01 * a for c, a in zip(ce, aux)]
    parts = {"ce": ce, "moe_aux": aux}
    if cfg.mtp:
        p = params["mtp"]
        pspecs = specs["mtp"]
        emb_next = _embed_mesh(plan, params, labels, cfg.vocab)
        proj = _gather_fsdp(plan, p["proj"]["w"], pspecs["proj"]["w"])
        cat = [torch.cat([nn.rmsnorm({"scale": a}, h),
                          nn.rmsnorm({"scale": c}, e)], dim=-1)
               for h, e, a, c in zip(hs, emb_next, p["norm_h"]["scale"],
                                     p["norm_e"]["scale"])]
        h2 = [nn.dense({"w": w}, c) for w, c in zip(proj, cat)]
        h2, _ = _layer_apply_mesh(plan, p["layer"], h2,
                                  specs=pspecs["layer"], cfg=cfg,
                                  positions=[_positions(t) for t in tokens],
                                  moe_layer=False)
        mtp_ce = _vocab_ce(plan, heads, [h[:, :-1] for h in h2],
                           [lab[:, 1:] for lab in labels], cfg.vocab,
                           n_rows * (s - 1))
        total = [t + 0.3 * m for t, m in zip(total, mtp_ce)]
        parts["mtp_ce"] = mtp_ce
    total = sharding.psum(total, mesh, plan.dp, "loss")
    metrics = {k: sharding.psum([x.detach() for x in v], mesh, plan.dp,
                                "loss") for k, v in parts.items()}
    return total, metrics


def argmax_mesh(plan: MeshPlan, logits, vocab: int):
    """The greedy token of logits sharded by vocabulary over ``tp``: each
    position's first maximum, then across the shards the largest value,
    ties to the lower global index (``torch.argmax``'s rule over the
    whole row).  A list of int64 (rows,) tensors, the same on every
    position of a ``tp`` group."""
    vals, idx = [], []
    for i, lg in enumerate(logits):
        lo, _ = plan.tp_chunk(vocab, i)
        vals.append(lg.amax(dim=-1, keepdim=True))
        idx.append(torch.argmax(lg, dim=-1, keepdim=True) + lo)
    vals = sharding.all_gather(vals, plan.mesh, plan.tp, -1, "out")
    idx = sharding.all_gather(idx, plan.mesh, plan.tp, -1, "out")
    out = []
    for v, j in zip(vals, idx):
        best = v.amax(dim=-1, keepdim=True)
        out.append(torch.where(v == best, j, vocab).amin(dim=-1))
    return out


def _write_owned(cache, new, pos, lo: int, s_total: int):
    """:func:`_write` into a cache shard holding the global slots ``[lo,
    lo + S_pos)``: the rows whose (clamped) position falls in it."""
    idx = torch.clamp(pos.long(), 0, s_total - 1) - lo
    mine = (idx >= 0) & (idx < cache.shape[1])
    rows = torch.nonzero(mine).flatten()
    cache[rows, idx[rows]] = new[rows].to(cache.dtype)


def _attn_decode_mesh(plan: MeshPlan, p, cfg: LMConfig, xs, cache_layers,
                      cache_len, s_total: int):
    """:func:`_attn_decode` over a cache sharded by sequence over
    ``tp``: the new token's keys and values written by the position whose
    slots hold its place, one-token attention as a psum-combined partial
    softmax (:func:`~repro_torch.models.attention.decode_combine`)."""
    mesh, tp = plan.mesh, plan.tp
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gather = lambda ys: sharding.all_gather(ys, mesh, tp, -1)  # noqa: E731
    los = [plan.tp_chunk(s_total, i)[0] for i in range(plan.lay.n)]
    if cfg.mla:
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kvr = cfg.kv_lora_rank
        cq = _pm(lambda x, w, ln: nn.rmsnorm(ln, nn.dense({"w": w}, x)), xs,
                 p["q_down"]["w"], _leaf_list(p["ln_q"]))
        q = gather(nn.dense_col(mesh, p["q_up"], cq, tp=tp))
        k_up = sharding.all_gather(p["k_up"]["w"], mesh, tp, -1, "params")
        v_up = sharding.all_gather(p["v_up"]["w"], mesh, tp, -1, "params")
        scores, lat = [], []
        for i in range(plan.lay.n):
            pos, b = cache_len[i], xs[i].shape[0]
            qi = q[i].reshape(b, h, nope + rope)
            q_nope, q_rope = qi[..., :nope], qi[..., nope:]
            q_rope = apply_rope(q_rope[:, None], pos[:, None],
                                theta=cfg.rope_theta)[:, 0]
            ckv_full = nn.dense({"w": p["kv_down"]["w"][i]}, xs[i])
            ckv_new = nn.rmsnorm({"scale": p["ln_kv"]["scale"][i]},
                                 ckv_full[..., :kvr])
            kr_new = apply_rope(ckv_full[..., kvr:][:, None, None],
                                pos[:, None], theta=cfg.rope_theta)[:, 0, 0]
            ckv_c, kr_c = cache_layers["ckv"][i], cache_layers["k_rope"][i]
            _write_owned(ckv_c, ckv_new, pos, los[i], s_total)
            _write_owned(kr_c, kr_new, pos, los[i], s_total)
            q_eff = torch.einsum("bhn,rhn->bhr", q_nope,
                                 k_up[i].reshape(kvr, h, nope))
            ckv_f = ckv_c.float()
            sc = torch.einsum("bhr,bsr->bhs", q_eff.float(), ckv_f)
            sc = sc + torch.einsum("bhr,bsr->bhs", q_rope.float(),
                                   kr_c.float())
            sc = sc * ((nope + rope) ** -0.5)
            slot = los[i] + torch.arange(ckv_c.shape[1], device=sc.device)
            mask = slot[None, :] <= pos[:, None]
            scores.append(torch.where(mask[:, None, :], sc, -torch.inf))
            lat.append(ckv_f)
        ctx = decode_combine(mesh, tp, scores, lambda i, w: torch.einsum(
            "bhs,bsr->bhr", w, lat[i]))
        outs = [torch.einsum("bhr,rhv->bhv", c,
                             v_up[i].reshape(kvr, h, vd).float())
                .to(xs[i].dtype).reshape(c.shape[0], h * vd)
                for i, c in enumerate(ctx)]
        width = h * vd
    else:
        rope_kw = dict(fraction=cfg.rope_fraction, theta=cfg.rope_theta)
        q = gather(nn.dense_col(mesh, p["wq"], xs, tp=tp))
        k = gather(nn.dense_col(mesh, p["wk"], xs, tp=tp))
        v = gather(nn.dense_col(mesh, p["wv"], xs, tp=tp))
        scores, vals = [], []
        g = h // kv
        for i in range(plan.lay.n):
            pos, b = cache_len[i], xs[i].shape[0]
            qi = apply_rope(q[i].reshape(b, h, dh)[:, None], pos[:, None],
                            **rope_kw)[:, 0]
            k_new = apply_rope(k[i].reshape(b, kv, dh)[:, None],
                               pos[:, None], **rope_kw)[:, 0]
            k_c, v_c = cache_layers["k"][i], cache_layers["v"][i]
            _write_owned(k_c, k_new, pos, los[i], s_total)
            _write_owned(v_c, v[i].reshape(b, kv, dh), pos, los[i], s_total)
            qg = (qi.reshape(b, kv, g, dh) * _scalar(dh ** -0.5, qi)).float()
            sc = torch.einsum("bkgd,bskd->bkgs", qg, k_c.float())
            slot = los[i] + torch.arange(k_c.shape[1], device=sc.device)
            mask = (slot[None, :] < (pos + 1)[:, None])[:, None, None, :]
            scores.append(torch.where(mask, sc, -torch.inf))
            vals.append(v_c.float())
        out = decode_combine(mesh, tp, scores, lambda i, w: torch.einsum(
            "bkgs,bskd->bkgd", w, vals[i]))
        outs = [o.reshape(o.shape[0], h * dh).to(xs[i].dtype)
                for i, o in enumerate(out)]
        width = h * dh
    cols = []
    for i, o in enumerate(outs):
        lo, hi = plan.tp_chunk(width, i)
        cols.append(o[..., lo:hi])
    return nn.dense_row(mesh, p["wo"], cols, tp=tp)


def lm_decode_step_mesh(plan: MeshPlan, params, specs, cfg: LMConfig,
                        tokens, cache, cache_len, s_total: int):
    """:func:`lm_decode_step` on the mesh: ``tokens`` and ``cache_len``
    each position's (B/|dp|,) rows, ``cache`` a dict of lists of its
    shards (written in place), ``s_total`` the cache's global length.
    Returns ``(next tokens, logits sharded by vocabulary, cache)``,
    lists."""
    xs = _embed_mesh(plan, params, tokens, cfg.vocab)
    n_dense, n_main = _stack_sizes(cfg)
    stacks = ([("dense_layers", False, 0, n_dense)] if n_dense else []) + [
        ("layers", cfg.moe, n_dense, n_main)]
    for key, moe_layer, first, n in stacks:
        lspecs = _unstacked_specs(specs[key])
        for i, lp in enumerate(_unbound_mesh(params[key], n)):
            lp = _gather_fsdp(plan, lp, lspecs)
            layer_cache = {k: [c[first + i] for c in cs]
                           for k, cs in cache.items()}
            zs = _pm(lambda x, s: nn.rmsnorm({"scale": s}, x), xs,
                     lp["ln1"]["scale"])
            att = _attn_decode_mesh(plan, lp["attn"], cfg, zs, layer_cache,
                                    cache_len, s_total)
            hs = [x + a for x, a in zip(xs, att)]
            z2 = _pm(lambda h, s: nn.rmsnorm({"scale": s}, h), hs,
                     lp["ln2"]["scale"])
            if moe_layer:
                mp = dict(lp["moe"])
                mp["router"] = [{"w": w} for w in lp["moe"]["router"]["w"]]
                ys, _ = moe_apply_mesh(plan.mesh, mp, z2, top_k=cfg.top_k,
                                       ep=plan.ep, tp=plan.tp, dp=plan.dp)
            else:
                ys = _ffn_mesh(plan, lp["ffn"], z2)
            xs = [h + y for h, y in zip(hs, ys)]
    hs = _pm(lambda x, s: nn.rmsnorm({"scale": s}, x), xs,
             params["final_norm"]["scale"])
    heads = _head_mesh(plan, params, specs)
    logits = [nn.matmul(h, w).to(torch.float32) for h, w in zip(hs, heads)]
    nxt = argmax_mesh(plan, logits, cfg.vocab)
    return ([n.to(t.dtype) for n, t in zip(nxt, tokens)], logits, cache)
