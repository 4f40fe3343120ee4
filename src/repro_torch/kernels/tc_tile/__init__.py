"""Bit-packed tile intersection kernels.

``tc_tile`` — per active tile triple, ``Σ M[i,j]·popcount(A[i]&B[j])`` in
two hand-written CUDA kernels (``csrc/tc_tile.cu``: ``popcount`` on the
integer units, ``mxu`` on the tensor cores), with a plain PyTorch version
of each backing the CPU.
"""
from .ops import tile_pair_count  # noqa: F401
from .ref import tile_triple_counts_ref  # noqa: F401
from .tc_tile import (  # noqa: F401
    MODES,
    TILE,
    WORDS,
    tile_triple_counts,
    tile_triple_counts_plain,
    unpack_bits_tile,
)
