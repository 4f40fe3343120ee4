"""Attention: RoPE (full and partial), causal GQA attention for prefill and
training in the reference's chunked online-softmax schedule, and
KV-cached decode attention (the JAX package's ``models/attention.py``).

The port computes what the reference computes, eagerly and in the same
order of chunks.  On one card the reference's sharding constraints have no
counterpart; on a device mesh its q-sequence-parallel layout is
:func:`causal_attention_rows` (each position's share of the q chunks) and
its sequence-sharded decode cache :func:`decode_combine`.  Its
``preferred_element_type=float32`` products become float32 products of
upcast operands (a bfloat16 ``einsum`` would round its output to
bfloat16), and a Python scalar times a bfloat16 tensor is taken in the
tensor's dtype, as ``jnp``'s weak scalars are.
"""
from __future__ import annotations

import numpy as np
import torch

from . import sharding

__all__ = [
    "apply_rope",
    "rope_angles",
    "causal_attention",
    "causal_attention_rows",
    "decode_combine",
    "decode_attention",
    "quantize_kv",
    "dequantize_kv",
]


def _scalar(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype, as a ``jnp`` weak scalar is
    rounded before the operation; a Python float, so nothing is copied to
    the device (torch computes a scalar operand in float32, where the
    rounded value is exact)."""
    return float(torch.tensor(value, dtype=like.dtype))


_ROPE_INV: dict = {}  # (dim, theta, device) -> the frequencies there


def _rope_inv(dim: int, theta: float, device: torch.device):
    """``1 / theta ** (2i / dim)`` in float32, made once a device: the
    power is taken on the host in float64 and rounded once, so every
    device holds the same frequencies (a float32 ``pow`` may differ in
    its last bit between the CPU and a GPU, and at position 32,767 one
    bit of a frequency turns the angle by up to 0.004 rad).  On ``meta``
    (a dry run's walk) they are made at each call, so that every walk of
    a step makes the same tensors, the first in a process too."""
    key = (dim, float(theta), device)
    inv = _ROPE_INV.get(key)
    if inv is None:
        exps = np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim)
        power = (np.float64(theta) ** exps.astype(np.float64))
        inv = np.float32(1.0) / power.astype(np.float32)
        inv = torch.from_numpy(inv).to(device)
        if device.type != "meta":
            _ROPE_INV[key] = inv
    return inv


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """(..., dim/2) angles for rotary embedding, in float32 as the
    reference takes them, the frequencies from :func:`_rope_inv`."""
    inv = _rope_inv(dim, theta, positions.device)
    return positions[..., None].to(torch.float32) * inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               fraction: float = 1.0, theta: float = 10000.0):
    """Rotary embedding on the first ``fraction`` of head dims.

    Pairs are interleaved — ``(x[..., 0::2], x[..., 1::2])`` rotated and
    stacked back — as in the reference (not the ``rotate_half`` layout).
    The rotated width is ``int(dh · fraction)`` rounded down to even;
    ``fraction=0.5`` is ChatGLM's partial RoPE.
    x: (B, S, H, dh); positions: (B, S).
    """
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = rope_angles(positions, rot, theta)  # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    out = out.reshape(xr.shape)
    return torch.cat([out, xp], dim=-1)


def chunk_sizes(s: int, q_chunk: int, kv_chunk: int, nq_multiple: int = 1):
    """The reference's q and kv chunk lengths for a sequence of ``s``;
    ``ValueError`` where either does not divide ``s`` (the reference
    asserts, and asserts vanish under ``-O``)."""
    qc = min(q_chunk, max(1, s // max(nq_multiple, 1)))
    kc = min(kv_chunk, s)
    if s % qc or s % kc:
        raise ValueError(
            f"causal_attention: q chunk {qc} and kv chunk {kc} must both "
            f"divide the sequence length {s}")
    return qc, kc


def causal_attention(q, k, v, *, q_chunk: int = 512, kv_chunk: int = 1024,
                     nq_multiple: int = 1):
    """Memory-bounded causal GQA attention (flash-style online softmax).

    q: (B, S, H, dh); k, v: (B, S, KV, dh) with H = KV * G; ``v``'s last
    dimension may differ from ``dh`` (MLA).  Every q chunk (the
    reference's ``vmap`` axis) runs at once; the kv chunks are the
    reference's sequential online-softmax scan, every chunk visited, the
    masked future ones included.
    """
    qc, kc = chunk_sizes(q.shape[1], q_chunk, kv_chunk, nq_multiple)
    return causal_attention_rows(q, k, v, qc=qc, kc=kc)


def causal_attention_rows(q, k, v, *, qc: int, kc: int, q0: int = 0):
    """:func:`causal_attention` for the query rows ``[q0, q0 + R)`` of the
    sequence that ``k`` and ``v`` cover: q (B, R, H, dh) with R a whole
    number of ``qc``-row chunks, each chunk computed exactly as the full
    call computes it (the sequence-parallel attention of a mesh, where
    each position takes its share of the q chunks)."""
    b, r, h, dh = q.shape
    s = k.shape[1]
    kvh = k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    scale = _scalar(dh ** -0.5, q)
    nq, nk = r // qc, s // kc
    dev = q.device
    if r == 0:
        return q.new_zeros((b, 0, h, dv))

    qb = (q * scale).reshape(b, nq, qc, kvh, g, dh).float()
    k = k.reshape(b, nk, kc, kvh, dh)
    v = v.reshape(b, nk, kc, kvh, dv)
    pos_q = torch.arange(q0, q0 + r, device=dev).reshape(nq, qc)
    pos_k = torch.arange(s, device=dev).reshape(nk, kc)

    m = torch.full((b, nq, qc, kvh, g), -torch.inf, device=dev)
    l = torch.zeros((b, nq, qc, kvh, g), device=dev)
    o = torch.zeros((b, nq, qc, kvh, g, dv), device=dev)
    for ki in range(nk):
        kb, vb = k[:, ki].float(), v[:, ki].float()
        sc = torch.einsum("bnqkgd,bckd->bnqkgc", qb, kb)
        mask = (pos_q[:, :, None] >= pos_k[ki][None, None, :])[
            None, :, :, None, None, :]  # (1, nq, qc, 1, 1, kc)
        sc = torch.where(mask, sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(sc - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bnqkgc,bckd->bnqkgd", p, vb)
        o = o * corr[..., None] + pv
        m = m_safe
    out = (o / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)
    return out.reshape(b, r, h, dv)


# ----------------------------------------------------------------------
# decode path (KV cache, optionally int8-quantized)
# ----------------------------------------------------------------------
def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of a cache tensor.

    The codes round half to even, as ``jnp.round`` does, and saturate as
    XLA's float-to-int8 conversion does: in bfloat16, ``amax / scale`` can
    round up to 128, which the reference stores as 127 (a plain
    ``.to(torch.int8)`` would wrap it to -128)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, _scalar(1e-8, amax)) / 127.0
    q = torch.round(x / scale).clamp(-128, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16):
    return (q.to(torch.float32) * scale).to(dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """One-token GQA attention against a cache.

    q: (B, H, dh); k_cache, v_cache: (B, S, KV, dh); cache_len: (B,).
    Slots ``>= cache_len`` are masked.
    """
    b, h, dh = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qg = (q.reshape(b, kvh, g, dh) * _scalar(dh ** -0.5, q)).float()
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    mask = (torch.arange(s, device=q.device)[None, :]
            < cache_len[:, None])[:, None, None, :]  # (B, 1, 1, S)
    sc = torch.where(mask, sc, -torch.inf)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / torch.clamp_min(l, 1e-30),
                       v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)


def _rescale(m_pos, m_global):
    """``exp(m_pos - m_global)``: a position's share of the softmax
    brought to the global maximum (0 where it saw no valid slot)."""
    return torch.where(torch.isfinite(m_pos), torch.exp(m_pos - m_global),
                       0.0)


def decode_combine(mesh, axes, scores, values):
    """One-token attention over a cache sharded by sequence over
    ``axes``: per position, ``scores`` (..., S_pos) float32 with its
    masked slots at ``-inf`` and ``values(p, w)`` its weighted values for
    the weights ``w``; each position takes the max, the exponent sum and
    the weighted values of its own slots, and a psum combines them
    rescaled by ``exp(m_pos - m_global)``.  A position whose slots are
    all masked (or that holds none) adds nothing and makes no NaN."""
    ms, ls, os_ = [], [], []
    for p, sc in enumerate(scores):
        if sc.shape[-1]:
            m = sc.amax(dim=-1, keepdim=True)
        else:
            m = torch.full((*sc.shape[:-1], 1), -torch.inf, device=sc.device)
        w = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0))
        ms.append(m)
        ls.append(w.sum(dim=-1, keepdim=True))
        os_.append(values(p, w))
    mg = sharding.pmax(ms, mesh, axes, "act")
    scale = [_rescale(m, g) for m, g in zip(ms, mg)]
    ls = sharding.psum([l_ * c for l_, c in zip(ls, scale)], mesh, axes,
                       "act")
    os_ = sharding.psum([o * c for o, c in zip(os_, scale)], mesh, axes,
                        "act")
    return [o / torch.clamp_min(l_, 1e-30) for o, l_ in zip(os_, ls)]
