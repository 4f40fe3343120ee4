"""Bit-packed tile set-intersection: the CUDA kernels' wrapper and their
plain PyTorch versions.

The adjacency fragments of 128 consecutive local rows are packed into a
128x128-bit tile, 4 words a row.  For an active triple (A-tile (ti, tk),
B-tile (tj, tk), mask tile (ti, tj)) the contribution is::

    out[g] = valid_g · Σ_{i, j} M[i, j] · popcount(A[i, :] & B[j, :])

``triples[g] = (a_slot, b_slot, m_slot, valid)``.  Padding triples are
``(0, 0, 0, 0)`` and slot 0 is a real tile, so ``valid`` decides, not the
slot.  Tiles travel as **int32 bit patterns** of the uint32 words (torch
has no uint32 shift or roll on the CPU): bit 31 is the sign bit, and every
unpack masks with ``& 1`` after the shift, which is arithmetic.

:func:`tile_triple_counts` is the entry point, with the JAX package's
signature minus ``interpret``.  For tensors on a CUDA device it launches
the hand-written kernel of ``mode`` from ``csrc/tc_tile.cu`` (or raises —
nothing stands in for it on the GPU); for tensors on the CPU it takes the
plain version of that mode.  The two modes compute the same integer.

What bounds both on an H100 is bytes: the function needs only the pairs
``(i, j)`` whose mask bit is set (on the tile path about 4.6 of a triple's
16,384), so the least time is the tiles it names, each read once, over
the memory rate.  Both kernels are built to visit only those pairs: one
warp per triple, as many blocks as fit on the card at once, each warp
looping over its share of the triples; lane ``l`` holds mask rows ``l +
32 r`` in registers.  On the tile path the time follows that mask scan,
2 KiB a triple (``PERF.md``).

* ``mode="popcount"`` replaces the TPU kernel ``_kernel_popcount`` of
  ``src/repro/kernels/tc_tile/tc_tile.py``.  Up to a fixed number of set
  mask bits (:func:`dense_threshold`) each lane walks its own set bits and
  reads only rows ``A[i]`` and ``B[j]`` for each (sparse route); above it
  the warp stages the B tile in shared memory and each lane takes its
  rows against every ``j``, selecting by the mask bit (dense route).
* ``mode="mxu"`` replaces ``_kernel_mxu`` (with ``unpack_bits_tile``).  The
  name is kept so a reader finds the counterpart; on this card it means
  tensor cores: ``mma.sync`` m16n8k128 on packed bits (``.b1``, AND +
  popcount), one instruction per 16x8 output block that holds a set mask
  bit, the mask applied to the accumulators in registers.  No unpack.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = [
    "TILE",
    "WORDS",
    "MODES",
    "unpack_bits_tile",
    "popcount32",
    "dense_threshold",
    "tile_triple_counts",
    "tile_triple_counts_plain",
    "launch_count",
    "reset_launch_count",
]

TILE = 128
WORDS = TILE // 32
MODES = ("popcount", "mxu")

# number of times the wrapper has launched each mode's CUDA kernel
LAUNCHES = {mode: 0 for mode in MODES}

# triples per host-loop iteration of the plain versions: the mxu chunk
# holds three (chunk, 128, 128) float32 tensors, the popcount chunk one
# (chunk, 128, 128) mask before its set bits are gathered
_PLAIN_CHUNK = {"popcount": 1024, "mxu": 512}


def launch_count(mode: str) -> int:
    return LAUNCHES[mode]


def reset_launch_count() -> None:
    for mode in MODES:
        LAUNCHES[mode] = 0


def unpack_bits_tile(words, dtype=torch.bfloat16):
    """``(..., T, W)`` int32 bit patterns -> ``(..., T, 32·W)`` 0/1 matrix;
    column ``c`` is bit ``c % 32`` of word ``c // 32``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1  # & 1: the shift sign-extends
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).to(dtype)


def popcount32(words):
    """Set bits of each int32 bit pattern, as int64 (the SWAR identity,
    taken on int64 so no step overflows)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _popcount_chunk(trip, a_tiles, b_tiles, m_tiles):
    """Popcount formulation: gather the set mask bits ``(g, i, j)`` of the
    valid triples, AND rows ``A[i]`` and ``B[j]`` word by word, count."""
    mask = unpack_bits_tile(m_tiles[trip[:, 2]], torch.bool)
    mask &= (trip[:, 3] > 0)[:, None, None]
    g, i, j = mask.nonzero(as_tuple=True)
    words = a_tiles[trip[g, 0], i] & b_tiles[trip[g, 1], j]  # (P, W)
    out = torch.zeros(trip.shape[0], dtype=torch.int64, device=trip.device)
    out.index_add_(0, g, popcount32(words).sum(dim=1))
    return out.to(torch.int32)


def _mxu_chunk(trip, a_tiles, b_tiles, m_tiles):
    """Unpack-and-multiply formulation in float32: ``A·Bᵀ`` per triple,
    masked and summed (every partial sum is an integer below 2^24)."""
    a = unpack_bits_tile(a_tiles[trip[:, 0]], torch.float32)
    b = unpack_bits_tile(b_tiles[trip[:, 1]], torch.float32)
    m = unpack_bits_tile(m_tiles[trip[:, 2]], torch.float32)
    total = (torch.bmm(a, b.transpose(1, 2)) * m).sum(dim=(1, 2))
    return torch.where(trip[:, 3] > 0, total.to(torch.int32), 0)


def tile_triple_counts_plain(triples, a_tiles, b_tiles, m_tiles, *,
                             mode="popcount"):
    """The plain version of ``mode``: ``(G,)`` int32, what the kernel of
    that mode returns.  Chunked over triples so device memory stays
    bounded at any ``G``."""
    body = {"popcount": _popcount_chunk, "mxu": _mxu_chunk}[mode]
    step = _PLAIN_CHUNK[mode]
    parts = [
        body(triples[g0:g0 + step], a_tiles, b_tiles, m_tiles)
        for g0 in range(0, triples.shape[0], step)
    ]
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=triples.device)
    return torch.cat(parts)


def _check(name, t, dev, shape_tail):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 1 + len(shape_tail) or tuple(t.shape[1:]) != shape_tail:
        raise ValueError(
            f"{name} must have shape (N, {', '.join(map(str, shape_tail))}), "
            f"got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                         "read a triple and a tile row as one 16-byte word)")


_FN = None


def _kernel_fns():
    global _FN
    if _FN is None:
        from .._build import load_library

        lib = load_library("tc_tile")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fns = {}
        for mode in MODES:
            fn = getattr(lib, f"tc_tile_{mode}")
            fn.argtypes = [p, p, p, p, ll, p, p, i]
            fn.restype = i
            fns[mode] = fn
        lib.tc_tile_dense_threshold.argtypes = []
        lib.tc_tile_dense_threshold.restype = i
        lib.tc_tile_error_string.argtypes = [i]
        lib.tc_tile_error_string.restype = ctypes.c_char_p
        _FN = (fns, lib)
    return _FN


def dense_threshold() -> int:
    """Set mask bits of a triple above which the popcount kernel takes its
    dense route (a constant of ``csrc/tc_tile.cu``; builds the library)."""
    return int(_kernel_fns()[1].tc_tile_dense_threshold())


def tile_triple_counts(triples, a_tiles, b_tiles, m_tiles, *, mode="popcount"):
    """Per-triple masked intersection counts.

    Args:
      triples: (G, 4) int32 — (a_slot, b_slot, m_slot, valid); every slot
        must index its store (the planner's joins guarantee it).
      a_tiles/b_tiles/m_tiles: (N*, 128, 4) int32 bit patterns of the
        packed uint32 tile stores.
      mode: "popcount" or "mxu" (same result).

    Returns: (G,) int32 per-triple counts; the caller sums them in int64.
    On a CUDA device the launch is asynchronous on the current stream.
    """
    if mode not in MODES:
        raise ValueError(f"unknown tile mode {mode!r}; expected one of {MODES}")
    dev = triples.device
    if dev.type == "cpu":
        return tile_triple_counts_plain(
            triples, a_tiles, b_tiles, m_tiles, mode=mode
        )
    if dev.type != "cuda":
        raise ValueError(f"tile_triple_counts has no kernel for device {dev}")
    _check("triples", triples, dev, (4,))
    for name, t in (("a_tiles", a_tiles), ("b_tiles", b_tiles),
                    ("m_tiles", m_tiles)):
        _check(name, t, dev, (TILE, WORDS))
    g = triples.shape[0]
    out = torch.empty(g, dtype=torch.int32, device=dev)
    if g == 0:
        return out
    fns, lib = _kernel_fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fns[mode](
            triples.data_ptr(), a_tiles.data_ptr(), b_tiles.data_ptr(),
            m_tiles.data_ptr(), g, out.data_ptr(), stream, dev.index,
        )
    if rc != 0:
        raise RuntimeError(
            f"tc_tile_{mode} launch failed: CUDA error {rc} "
            f"({lib.tc_tile_error_string(rc).decode()})"
        )
    LAUNCHES[mode] += 1
    return out
