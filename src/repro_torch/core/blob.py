"""Single-buffer ("blob") packing of a shifted payload.

The paper stores each block's arrays inside one contiguous allocation and
sends that blob, so a shift moves one buffer instead of one per array.
The JAX package concatenates the per-block arrays into one flat int32
buffer so a shift is one ``ppermute`` per operand.  Here every plan tensor
is stacked over the logical grid, so a blob keeps the leading grid
dimensions (``(q, q, L)`` on Cannon, ``(npods, q, q, L)`` on a pod grid,
``(p, L)`` on the ring) and concatenates the flattened trailing ones: a
shift is one ``torch.roll`` per operand, and logical device ``(x, y)``'s
blob ``blob[x, y]`` is contiguous, so the arrays unpacked from it are
contiguous views the kernels read in place.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["pack_blob", "unpack_blob", "blob_layout"]


def blob_layout(shapes: Sequence[Tuple[int, ...]]):
    """Static ``(offset, size, shape)`` triples for a list of array shapes
    (the trailing, per-device shapes), and the blob's length."""
    layout = []
    off = 0
    for shp in shapes:
        size = 1
        for d in shp:
            size *= d
        layout.append((off, size, tuple(shp)))
        off += size
    return layout, off


def pack_blob(arrays, lead: int = 0) -> torch.Tensor:
    """Concatenate int32 tensors into one buffer: their first ``lead``
    dimensions (the grid's, equal in every tensor) are kept, the rest of
    each is flattened and the flat parts are joined along the last
    dimension."""
    return torch.cat([a.flatten(lead) for a in arrays], dim=-1)


def unpack_blob(blob: torch.Tensor, layout):
    """The arrays of ``blob`` (a blob of :func:`pack_blob`, or one device's
    slice of it) as views: each keeps the blob's leading dimensions and
    takes its trailing shape from ``layout``."""
    return [blob[..., off:off + size].unflatten(-1, shape)
            for off, size, shape in layout]
