"""Edge-index message passing via segment reductions.

``spmm_edges`` is the GNN SpMM primitive: gather source-node features along
edges, optionally weight per edge, scatter-add into destination nodes.
The sums are ``index_add_`` and the maxima ``scatter_reduce``; a segment
id outside ``[0, num_segments)`` is dropped, as the JAX package's
``segment_sum`` / ``segment_max`` drop it (it lands in a spare segment
that is cut off, so no id is read back to the host).  An empty segment's
maximum is ``-inf``, as the JAX package's is.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["segment_sum", "segment_max", "segment_softmax",
           "softmax_numerator", "softmax_normalise", "spmm_edges", "degree"]


def _spare(segment_ids, num_segments: int):
    """Ids with every one out of range sent to the spare segment
    ``num_segments``."""
    ids = segment_ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    return torch.where(valid, ids, ids.new_full((), num_segments))


def segment_sum(data, segment_ids, num_segments: int):
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add_(0, _spare(segment_ids, num_segments), data)[
        :num_segments]


def segment_max(data, segment_ids, num_segments: int):
    ids = _spare(segment_ids, num_segments)
    ids = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]),
                        float("-inf"))
    return out.scatter_reduce_(0, ids, data, "amax")[:num_segments]


def segment_softmax(logits, segment_ids, num_segments: int):
    """Numerically-stable softmax over variable-size segments (edge->dst).
    On a device mesh the same three steps run on each position's edges,
    the maxima and the denominators combined over the mesh between them
    (:class:`repro_torch.models.lockstep.SegmentSoftmax`)."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    ex = softmax_numerator(logits, segment_ids, seg_max)
    denom = segment_sum(ex, segment_ids, num_segments)
    return softmax_normalise(ex, denom, segment_ids)


def softmax_numerator(logits, segment_ids, seg_max):
    """``exp(logit - max)`` of each edge, an empty segment's max taken as
    zero."""
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          seg_max.new_zeros(()))
    return torch.exp(logits - seg_max[segment_ids.long()])


def softmax_normalise(ex, denom, segment_ids):
    """Each edge's numerator over its segment's denominator."""
    return ex / torch.clamp(denom[segment_ids.long()], min=1e-16)


def degree(segment_ids, num_segments: int, dtype=torch.float32):
    ones = torch.ones(segment_ids.shape[0], dtype=dtype,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def spmm_edges(
    x_src,
    edge_src,
    edge_dst,
    num_dst: int,
    *,
    edge_weight: Optional[torch.Tensor] = None,
    reduce: str = "sum",
):
    """y[dst] = reduce_{(s,d) in E} w_e * x_src[s].

    x_src: (N_src, ...); edge_src/edge_dst: (E,) int32.
    """
    msg = x_src[edge_src.long()]
    if edge_weight is not None:
        msg = msg * edge_weight.reshape((-1,) + (1,) * (msg.dim() - 1))
    if reduce == "sum":
        return segment_sum(msg, edge_dst, num_dst)
    if reduce == "mean":
        s = segment_sum(msg, edge_dst, num_dst)
        d = degree(edge_dst, num_dst, msg.dtype)
        return s / torch.clamp(d, min=1.0).reshape(
            (-1,) + (1,) * (msg.dim() - 1))
    if reduce == "max":
        return segment_max(msg, edge_dst, num_dst)
    raise ValueError(reduce)
