"""int8 chunk-quantized gradient sum (beyond-paper optimization).

The JAX package quantizes each data-parallel shard's gradients to int8
with per-chunk scales, ``psum``s the int32 codes over the mesh axis and
dequantizes.  With the whole grid on one card the replicas are a leading
dimension of one tensor: the group-max scale (the ``pmax``) is an amax
over that dimension and the int32 ``psum`` a sum over it.  Every division
here is tensor by tensor, so the codes do not depend on the device (a CUDA
division by a host scalar multiplies by its reciprocal).
"""
from __future__ import annotations

import torch

from ._tree import tree_map

__all__ = ["quantize_grads", "dequantize_grads", "compressed_psum"]

CHUNK = 1024


def _chunks(x: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """``x`` as float32 ``(*lead dims, n_chunks, CHUNK)``, zero-padded."""
    flat = x.reshape(*x.shape[:lead], -1).to(torch.float32)
    pad = (-flat.shape[-1]) % CHUNK
    flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(*flat.shape[:-1], -1, CHUNK)


def _codes(ch: torch.Tensor, amax: torch.Tensor):
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(ch / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize(x):
    ch = _chunks(x)
    return _codes(ch, torch.amax(torch.abs(ch), dim=1, keepdim=True))


def _dequantize(q, scale, shape, size):
    flat = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def quantize_grads(grads):
    return tree_map(_quantize, grads)


def dequantize_grads(qgrads, grads_like):
    return tree_map(
        lambda g, qs: _dequantize(qs[0], qs[1], g.shape, g.numel()),
        grads_like,
        qgrads,
    )


def compressed_psum(grads, dim: int = 0):
    """Sum a gradient tree in int8 (int32 accumulation) over the replica
    dimension ``dim`` of every leaf.

    Every replica quantizes against the *group-max* per-chunk scale (the
    amax over the replicas first) so the int payloads are commensurable;
    the int8 sum is then exact up to one quantization step per replica.
    Each leaf comes back without its replica dimension, as every replica
    of the JAX package's holds the same sum.
    """

    def one(g):
        g = torch.movedim(g, dim, 0)
        ch = _chunks(g, lead=1)
        local = torch.amax(torch.abs(ch), dim=2, keepdim=True)
        q, scale = _codes(ch, torch.amax(local, dim=0))
        qs = torch.sum(q.to(torch.int32), dim=0, dtype=torch.int32)
        return _dequantize(qs, scale, g.shape[1:], g[0].numel())

    return tree_map(one, grads)
