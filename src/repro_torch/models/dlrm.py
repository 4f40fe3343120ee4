"""DLRM (arXiv:1906.00091), MLPerf Criteo-TB config (the JAX package's
``models/dlrm.py``).

Bottom MLP on 13 dense features; 26 embedding bags out of ONE concatenated
table (the EmbeddingBag substrate); dot-product feature interaction
(pairwise dots of the 27 feature vectors, the upper triangle in row-major
order); top MLP -> CTR logit.  :func:`dlrm_retrieval` scores one query
against N candidate item embeddings as a single matmul + top-k.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import RecsysConfig
from ..sparse.embedding_bag import flatten_ids, table_offsets
from . import lockstep, nn
from .lockstep import Bag, Mean, TableRows, TopK

__all__ = ["dlrm_init", "dlrm_forward", "dlrm_loss", "dlrm_retrieval",
           "padded_rows"]


def padded_rows(cfg: RecsysConfig) -> int:
    """The concatenated table's rows, padded to a multiple of 512 (so
    row-sharding divides evenly on both production meshes; the padding
    rows are never addressed)."""
    return ((cfg.total_rows + 511) // 512) * 512


def dlrm_init(gen, cfg: RecsysConfig, *, device=None):
    """The reference's tree, drawn from ``gen`` on ``device`` (``"meta"``
    draws nothing): ``emb/table`` normal · 0.01, ``bot`` and ``top`` MLPs."""
    dtype = getattr(torch, cfg.dtype)
    return {
        "emb": {"table": nn.normal(gen, (padded_rows(cfg), cfg.embed_dim),
                                   0.01, dtype=dtype, device=device)},
        "bot": nn.mlp_init(gen, cfg.bot_mlp, dtype=dtype, device=device),
        "top": nn.mlp_init(gen, cfg.top_mlp, dtype=dtype, device=device),
    }


def _interact_dot(dense_v, sparse_v):
    """dense_v (B, d); sparse_v (B, F, d) -> (B, d + (F+1) F / 2): the
    dense vector, then the dots of every pair i < j of the F + 1 vectors
    in row-major order (``jnp.triu_indices(F + 1, k=1)``'s)."""
    b, f, d = sparse_v.shape
    all_v = torch.cat([dense_v[:, None, :], sparse_v], dim=1)  # (B, F+1, d)
    z = torch.bmm(all_v, all_v.transpose(1, 2))
    iu = torch.triu_indices(f + 1, f + 1, offset=1, device=z.device)
    pairs = z[:, iu[0], iu[1]]  # (B, (F+1)F/2)
    return torch.cat([dense_v, pairs], dim=1)


@lockstep.body
def dlrm_forward(params, cfg: RecsysConfig, dense, sparse_ids):
    """dense (B, 13); sparse_ids (B, F, H) local per-table ids -> (B,) logit.
    On a mesh the batch is each position's rows and the table its shard
    of rows (:class:`~repro_torch.models.lockstep.Bag`)."""
    offs = table_offsets(cfg.table_sizes)
    flat = flatten_ids(sparse_ids, offs)
    emb = yield Bag(params["emb"]["table"], flat)  # (B, F, d)
    dv = nn.mlp(params["bot"], dense, final_act=True)  # (B, d)
    feats = _interact_dot(dv, emb)
    # pad/crop interaction features to the top MLP's input width
    want = params["top"]["l0"]["w"].shape[0]
    have = feats.shape[1]
    if have < want:
        feats = F.pad(feats, (0, want - have))
    elif have > want:
        feats = feats[:, :want]
    return nn.mlp(params["top"], feats)[:, 0]


@lockstep.body
def dlrm_loss(params, cfg: RecsysConfig, dense, sparse_ids, labels):
    """BCE with logits, the reference's formula op by op, its mean over
    the global batch.  At a logit of exactly 0 its gradient is ``jnp``'s
    too: ``maximum`` splits the tie, and ``|x|`` takes the ``x >= 0``
    branch (``torch.abs``'s gradient there is 0, ``jnp.abs``'s is 1)."""
    logits = yield from lockstep.call(dlrm_forward, params, cfg, dense,
                                      sparse_ids)
    absolute = torch.where(logits >= 0, logits, -logits)
    loss = yield Mean(
        torch.maximum(logits, logits.new_zeros(()))
        - logits * labels
        + torch.log1p(torch.exp(-absolute))
    )
    return loss, {"loss": loss}


@lockstep.body
def dlrm_retrieval(params, cfg: RecsysConfig, dense, cand_ids, k: int = 100):
    """Score 1 query against N candidates: one matmul, then the top k.

    dense (1, 13) query features; cand_ids (N,) candidate rows of table 0.
    Returns ``(values, indices)``, indices int32; equal scores keep the
    lower index first, as ``jax.lax.top_k`` does (a stable descending
    sort: ``torch.topk`` promises no order among ties).  On a mesh the
    candidates are sharded and the indices global
    (:class:`~repro_torch.models.lockstep.TopK`).
    """
    q = nn.mlp(params["bot"], dense, final_act=True)  # (1, d)
    cand = yield TableRows(params["emb"]["table"], cand_ids)  # (N, d)
    scores = (cand @ q[0]).to(torch.float32)  # (N,)
    return (yield TopK(scores, k))
