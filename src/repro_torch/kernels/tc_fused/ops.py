"""Fused device-step dispatcher: one kernel launch for both buckets.

``count_pair_fused`` implements the :mod:`repro_torch.core.engine`
CSR-kernel contract on top of the planner's two-sided maxfrag split: the
first ``n_long`` tasks (either fragment > ``d_small``) are the long
bucket, counted at ``dpad_long``; everything after is the short bucket,
counted at ``d_small``.  On the GPU both buckets go through one launch of
the fused kernel (:func:`.tc_fused.fused_step_counts`): the kernel stages
at most one A row a warp and searches longer rows where they lie, so it
needs no on-chip-memory admission gate and no host fallback.

:func:`count_pair_fused_plain` is the same function by another route —
the chunked search paths of :mod:`repro_torch.core.count` for the long
bucket and :func:`.tc_fused.fused_short_counts_plain` for the short one —
and is what a CPU tensor takes.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.count import count_pair_search, count_pair_search_global
from .tc_fused import fused_short_counts_plain, fused_step_counts

__all__ = ["count_pair_fused", "count_pair_fused_plain", "fused_split_sizes",
           "fused_tile_for"]

# tile * d * d cap: keeps tile sizes equal to the JAX package's for a given d
_PANEL_BUDGET_ELEMS = 1 << 20
_TILE_MIN, _TILE_MAX = 8, 256


def fused_tile_for(d: int, budget_elems: int = _PANEL_BUDGET_ELEMS) -> int:
    """Largest power-of-two tile with ``tile * d * d`` within budget,
    clamped to [8, 256]."""
    cap = budget_elems // max(1, d * d)
    t = _TILE_MIN
    while t * 2 <= min(cap, _TILE_MAX):
        t <<= 1
    return t


def fused_split_sizes(tmax: int, n_long: int, chunk: int):
    """``(n_long_c, chunk_l)``: the long bucket rounded up at fine
    granularity, and the plain route's chunk for it.

    The long bucket is NOT rounded at the search path's autotuned chunk:
    with e.g. chunk=4096 and n_long=522, chunk-rounding would shove 4096
    tasks into the long bucket and starve the short one.  The plain
    route's internal chunk shrinks to match so its padding stays aligned.
    The kernel takes the same ``n_long_c``, so both routes split alike."""
    n_long, chunk_l = int(n_long), int(chunk)
    if n_long <= 0:
        return 0, chunk_l
    chunk_l = min(chunk_l, max(64, -(-n_long // 64) * 64))
    return min(-(-n_long // chunk_l) * chunk_l, tmax), chunk_l


def _check_fallback(long_fallback: str) -> None:
    if long_fallback not in ("global", "search"):
        raise ValueError(
            f"unknown long_fallback {long_fallback!r}: expected global | search"
        )


def _short_d(d_small, a_indices, b_indices) -> int:
    return int(max(1, min(d_small, a_indices.shape[0], b_indices.shape[0])))


def count_pair_fused(
    a_indptr,
    a_indices,
    b_indptr,
    b_indices,
    ti,
    tj,
    tcount: int,
    *,
    n_long: int,
    d_small: int,
    dpad_long: int,
    chunk: int,
    tile: Optional[int] = None,
    long_fallback: str = "global",
    probe_shorter: bool = True,
    sentinel: Optional[int] = None,
):
    """Device-step count under the maxfrag split, as a 0-dim int64 tensor.

    ``long_fallback`` names the long bucket's function after the route
    that computes it in plain ops: ``"global"`` (the row-encoded key
    search: A cut at ``dpad_long``, B whole; block-local ids) or
    ``"search"`` (padded binary search: both cut at ``dpad_long``).  The
    short bucket takes both fragments at most ``d_small`` long.

    On a CUDA device this is one launch of the fused kernel over both
    buckets (plus the int64 sum of its per-tile counts); on the CPU it is
    :func:`count_pair_fused_plain`.  ``chunk``, ``probe_shorter`` and
    ``sentinel`` shape only the plain route.
    """
    _check_fallback(long_fallback)
    if a_indptr.device.type == "cpu":
        return count_pair_fused_plain(
            a_indptr, a_indices, b_indptr, b_indices, ti, tj, tcount,
            n_long=n_long, d_small=d_small, dpad_long=dpad_long, chunk=chunk,
            tile=tile, long_fallback=long_fallback,
            probe_shorter=probe_shorter, sentinel=sentinel,
        )
    n_long_c, _ = fused_split_sizes(ti.shape[0], n_long, chunk)
    d = _short_d(d_small, a_indices, b_indices)
    per_tile = fused_step_counts(
        a_indptr, a_indices, b_indptr, b_indices, ti, tj, tcount,
        n_long=n_long_c, tile=int(tile) if tile else fused_tile_for(d),
        d_long=dpad_long, long_b_whole=long_fallback == "global", d_short=d,
    )
    return per_tile.sum(dtype=torch.int64)


def count_pair_fused_plain(
    a_indptr,
    a_indices,
    b_indptr,
    b_indices,
    ti,
    tj,
    tcount: int,
    *,
    n_long: int,
    d_small: int,
    dpad_long: int,
    chunk: int,
    tile: Optional[int] = None,
    long_fallback: str = "global",
    probe_shorter: bool = True,
    sentinel: Optional[int] = None,
):
    """The plain route of :func:`count_pair_fused`: the long bucket through
    :func:`~repro_torch.core.count.count_pair_search_global` (which builds
    its row-encoded keys itself) or
    :func:`~repro_torch.core.count.count_pair_search`, the short bucket
    through :func:`.tc_fused.fused_short_counts_plain`.  Ordinary tensor
    ops on whatever device the inputs live on; a 0-dim int64 tensor."""
    _check_fallback(long_fallback)
    tmax = ti.shape[0]
    tcount = int(tcount)
    n_long_c, chunk_l = fused_split_sizes(tmax, n_long, chunk)
    d = _short_d(d_small, a_indices, b_indices)
    tile = int(tile) if tile else fused_tile_for(d)

    acc = torch.zeros((), dtype=torch.int64, device=a_indptr.device)
    long_count = min(tcount, n_long_c)
    if long_count > 0 and long_fallback == "global":
        acc = acc + count_pair_search_global(
            a_indptr, a_indices, b_indptr, b_indices,
            ti[:n_long_c], tj[:n_long_c], long_count,
            dpad=dpad_long, chunk=chunk_l,
        )
    elif long_count > 0:
        acc = acc + count_pair_search(
            a_indptr, a_indices, b_indptr, b_indices,
            ti[:n_long_c], tj[:n_long_c], long_count,
            dpad=dpad_long, chunk=chunk_l, probe_shorter=probe_shorter,
            sentinel=sentinel,
        )

    if n_long_c >= tmax:
        return acc

    short_count = max(tcount - n_long_c, 0)
    per_tile = fused_short_counts_plain(
        a_indptr, a_indices, b_indptr, b_indices,
        ti[n_long_c:], tj[n_long_c:], short_count, tile=tile, d=d,
    )
    return acc + per_tile.sum(dtype=torch.int64)
