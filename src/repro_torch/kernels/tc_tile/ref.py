"""Reference for the tile kernels, formulated independently of both plain
versions: bits tested against one-hot words into dense 0/1 int64 tiles,
and the masked product summed by one ``einsum``.  For small inputs (the
tests); it materialises ``(G, 128, 128)`` int64 tiles three times."""
from __future__ import annotations

import torch

__all__ = ["tile_triple_counts_ref"]


def _dense(words):
    """(N, T, W) int32 bit patterns -> (N, T, 32·W) int64 0/1."""
    onehot = torch.ones(32, dtype=torch.int64).bitwise_left_shift(
        torch.arange(32, dtype=torch.int64)
    )
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] & onehot.to(w.device)) != 0
    return bits.flatten(-2).to(torch.int64)


def tile_triple_counts_ref(triples, a_tiles, b_tiles, m_tiles):
    """``(G,)`` int64: ``valid · Σ_{i,j,k} A[i,k] B[j,k] M[i,j]``."""
    trip = triples.to(torch.int64)
    a = _dense(a_tiles[trip[:, 0]])
    b = _dense(b_tiles[trip[:, 1]])
    m = _dense(m_tiles[trip[:, 2]])
    return torch.einsum("gik,gjk,gij->g", a, b, m) * (trip[:, 3] > 0)
