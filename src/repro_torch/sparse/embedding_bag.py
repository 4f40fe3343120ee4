"""EmbeddingBag: ragged multi-hot lookup + per-bag reduce.

The DLRM hot path.  Tables are stored as ONE concatenated (total_rows, d)
matrix with per-table row offsets so a batch of 26 sparse fields is a
single ``torch.nn.functional.embedding_bag`` over fixed-size bags (one
bag per sample and field).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["embedding_bag", "table_offsets", "flatten_ids"]


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
