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
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ..device import resolve_device
from . import nn
from .attention import apply_rope, causal_attention, decode_attention
from .moe import moe_apply, moe_init, swiglu_apply, swiglu_init

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
