"""Public wrapper for the tc_tile kernels."""
from __future__ import annotations

import torch

from .tc_tile import tile_triple_counts

__all__ = ["tile_pair_count"]


def tile_pair_count(triples, a_tiles, b_tiles, m_tiles, *, mode="popcount"):
    """Total masked-intersection count for one block pair: the per-triple
    partials of :func:`~.tc_tile.tile_triple_counts`, summed in int64
    (the partials are int32; their sum over a block pair need not be).
    Returns a 0-dim int64 tensor on the inputs' device."""
    per = tile_triple_counts(triples, a_tiles, b_tiles, m_tiles, mode=mode)
    return per.sum(dtype=torch.int64)
