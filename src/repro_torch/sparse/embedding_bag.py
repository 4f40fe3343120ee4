"""EmbeddingBag: ragged multi-hot lookup + per-bag reduce.

The DLRM hot path.  Tables are stored as ONE concatenated (total_rows, d)
matrix with per-table row offsets so a batch of 26 sparse fields is a
single ``torch.nn.functional.embedding_bag`` over fixed-size bags (one
bag per sample and field).

On a device mesh the table is row-sharded (over ``model``): each shard
looks up only the ids in its rows ``[lo, hi)`` and gives zeros for the
rest (:func:`embedding_bag_shard`, :func:`table_rows_shard`), so the sum
of the shards' parts is the lookup, and a shard's gradient lands in its
own rows only; :func:`check_ids` refuses an id outside the table.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["embedding_bag", "embedding_bag_shard", "table_rows_shard",
           "check_ids", "table_offsets", "flatten_ids"]


def table_offsets(table_sizes: Sequence[int]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(table_sizes)[:-1]]).astype(np.int64)


def flatten_ids(ids, offsets):
    """ids: (B, F, H) per-table local ids -> global row ids (B, F, H)."""
    off = torch.as_tensor(np.asarray(offsets), device=ids.device)
    return ids + off.to(ids.dtype)[None, :, None]


def embedding_bag(table, flat_ids, *, combiner: str = "sum"):
    """table: (rows, d); flat_ids: (B, F, H) global ids (H = bag size).

    Returns (B, F, d) — one reduced embedding per (sample, field).
    """
    if combiner not in ("sum", "mean", "max"):
        raise ValueError(combiner)
    b, f, h = flat_ids.shape
    out = torch.nn.functional.embedding_bag(
        flat_ids.reshape(b * f, h).long(), table, mode=combiner)
    return out.reshape(b, f, table.shape[1])


def check_ids(ids, rows: int):
    """Raise ``IndexError`` where an id of any tensor of ``ids`` lies
    outside the ``rows`` rows of a table, as ``embedding_bag`` on one
    device raises for it: one host sync for them all (the shard lookups
    below check nothing, so a mesh checks a request's ids once)."""
    flags = [((i < 0) | (i >= rows)).any() for i in ids]
    if flags and bool(torch.stack([f.to(flags[0].device)
                                   for f in flags]).any()):
        raise IndexError(f"an id outside the table's {rows} rows")


def embedding_bag_shard(shard, flat_ids, lo: int):
    """The part of each sum bag that ``shard``, rows ``[lo, lo +
    len(shard))`` of a table, holds: (B, F, d), its own ids' rows summed,
    every other id adding zero.  The parts of all shards sum to
    :func:`embedding_bag`'s ``sum``."""
    b, f, h = flat_ids.shape
    if shard.shape[0] == 0:
        return shard.new_zeros((b, f, shard.shape[1]))
    mine = (flat_ids >= lo) & (flat_ids < lo + shard.shape[0])
    local = torch.where(mine, flat_ids - lo, torch.zeros_like(flat_ids))
    out = torch.nn.functional.embedding_bag(
        local.reshape(b * f, h).long(), shard, mode="sum",
        per_sample_weights=mine.reshape(b * f, h).to(shard.dtype))
    return out.reshape(b, f, shard.shape[1])


def table_rows_shard(shard, ids, lo: int):
    """The rows of ``ids`` (N,) that ``shard`` (rows ``[lo, lo +
    len(shard))`` of a table) holds, zeros for the rest: (N, d)."""
    if shard.shape[0] == 0:
        return shard.new_zeros((ids.shape[0], shard.shape[1]))
    mine = (ids >= lo) & (ids < lo + shard.shape[0])
    local = torch.where(mine, ids - lo, torch.zeros_like(ids)).long()
    return torch.where(mine[:, None], shard[local], shard.new_zeros(()))
