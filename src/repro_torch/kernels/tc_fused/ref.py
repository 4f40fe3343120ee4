"""Plain-PyTorch reference for the fused short-task intersection.

Same gather-and-mask semantics as the kernel in ``tc_fused.py``: both
fragments of every short task are taken at most ``d`` long and padded
with sentinels that can never collide with a real column id (−1 on the A
side, ``int32.max`` on the B side).  The *intersection* step is
formulated independently of both the kernel and its plain panel version:
sorted membership — CSR rows hold strictly increasing column ids (and the
high B-side sentinel keeps the padded row sorted), so a row-wise
``searchsorted`` of the A panel into the B panel finds every common id.

Rows are duplicate-free, so every formulation counts exactly
|row_A ∩ row_B| on raw column ids.
"""
from __future__ import annotations

import torch

SENTINEL_A = -1
# high sentinel keeps the padded B row sorted (CSR rows are strictly
# increasing), which searchsorted needs; the equality panel only needs it
# distinct from ids and from SENTINEL_A
SENTINEL_B = 2**31 - 1

__all__ = ["fused_short_ref", "gather_panel", "SENTINEL_A", "SENTINEL_B"]

# elements of one gathered panel per host-loop iteration
_GROUP_ELEMS = 1 << 22


def gather_panel(indptr, indices, rows, d: int, sentinel: int, ok=None):
    """``(T, d)`` int32 fragments of ``rows``, truncated at ``d`` and padded
    with ``sentinel``; rows where ``ok`` is False are all sentinel.  The
    clipped gather index never leaks a neighbouring row's ids: everything
    at or past the row's length is masked."""
    rows = rows.long()
    start = indptr[rows].long()
    length = indptr[rows + 1].long() - start
    offs = torch.arange(d, dtype=torch.int64, device=indptr.device)
    idx = start[:, None] + offs[None, :]
    valid = offs[None, :] < length[:, None]
    if ok is not None:
        valid &= ok[:, None]
    vals = indices[idx.clamp_(0, indices.shape[0] - 1)].to(torch.int32)
    return torch.where(valid, vals, vals.new_full((), sentinel))


def fused_short_ref(
    a_indptr,
    a_indices,
    b_indptr,
    b_indices,
    ti,
    tj,
    tcount: int,
    *,
    d: int,
    tile: int,
):
    """Sum of |row_A(ti)[:d] ∩ row_B(tj)[:d]| over the first ``tcount``
    tasks, as a 0-dim int64 tensor.

    Every task's fragments are expected to fit in ``d`` (the maxfrag-split
    contract); longer rows are silently truncated, which is why the fused
    dispatcher refuses plans without a two-sided split.  ``tile`` only
    sizes the host loop here.
    """
    live = min(int(tcount), ti.shape[0])
    total = torch.zeros((), dtype=torch.int64, device=a_indptr.device)
    group = tile * max(1, _GROUP_ELEMS // max(1, tile * d))
    for lo in range(0, live, group):
        hi = min(lo + group, live)
        pa = gather_panel(a_indptr, a_indices, ti[lo:hi], d, SENTINEL_A)
        pb = gather_panel(b_indptr, b_indices, tj[lo:hi], d, SENTINEL_B)
        # pos is the first slot with pb >= query, so a hit can only sit
        # exactly there; A-side sentinels (-1) search to slot 0 and never
        # equal a real id or the high B pad
        pos = torch.searchsorted(pb, pa)
        hit = torch.gather(pb, 1, pos.clamp_(max=d - 1)) == pa
        total += hit.sum()
    return total
