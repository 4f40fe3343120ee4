"""Fused device-step dispatcher: short-task kernel + long-row fallback.

``count_pair_fused`` implements the :mod:`repro_torch.core.engine`
CSR-kernel contract on top of the planner's two-sided maxfrag split: the
first ``n_long`` tasks (either fragment > ``d_small``) run the chunked
search path at ``dpad_long``; everything after runs the fused
intersection kernel at ``d_small``.  The long bucket is *skipped entirely*
when ``n_long == 0`` — no always-on long chunk, no aug-key traffic on
kernel-only steps.

The kernel reads CSR rows straight from device memory and stages
nothing, so there is no on-chip-memory admission gate here: any block
size the device can hold is taken.  Which implementation runs is decided
by where the tensors live (:func:`.tc_fused.fused_short_counts`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.count import count_pair_search, count_pair_search_global
from .tc_fused import fused_short_counts

__all__ = ["count_pair_fused", "fused_split_sizes", "fused_tile_for"]

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
    granularity, and the fallback's chunk.

    The long bucket is NOT rounded at the search path's autotuned chunk:
    with e.g. chunk=4096 and n_long=522, chunk-rounding would shove 4096
    tasks through the fallback and starve the kernel of the very tasks it
    exists for.  The fallback's internal chunk shrinks to match so its
    padding stays aligned."""
    n_long, chunk_l = int(n_long), int(chunk)
    if n_long <= 0:
        return 0, chunk_l
    chunk_l = min(chunk_l, max(64, -(-n_long // 64) * 64))
    return min(-(-n_long // chunk_l) * chunk_l, tmax), chunk_l


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
    aug_b=None,
):
    """Device-step count under the maxfrag split, as a 0-dim int64 tensor.

    ``long_fallback`` picks the long-bucket path: ``"global"`` (the
    row-encoded key search; block-local ids) or ``"search"`` (padded
    binary search).  The short bucket always runs the fused kernel — raw
    column ids, valid on every schedule.
    """
    if long_fallback not in ("global", "search"):
        raise ValueError(
            f"unknown long_fallback {long_fallback!r}: expected global | search"
        )
    tmax = ti.shape[0]
    tcount = int(tcount)
    n_long_c, chunk_l = fused_split_sizes(tmax, n_long, chunk)
    d = int(max(1, min(d_small, a_indices.shape[0], b_indices.shape[0])))
    tile = int(tile) if tile else fused_tile_for(d)

    acc = torch.zeros((), dtype=torch.int64, device=a_indptr.device)
    long_count = min(tcount, n_long_c)
    if long_count > 0 and long_fallback == "global":
        # builds the row-encoded keys itself when none were staged
        acc = acc + count_pair_search_global(
            a_indptr, a_indices, b_indptr, b_indices,
            ti[:n_long_c], tj[:n_long_c], long_count,
            dpad=dpad_long, chunk=chunk_l, aug_b=aug_b,
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
    per_tile = fused_short_counts(
        a_indptr, a_indices, b_indptr, b_indices,
        ti[n_long_c:], tj[n_long_c:], short_count, tile=tile, d=d,
    )
    return acc + per_tile.sum(dtype=torch.int64)
