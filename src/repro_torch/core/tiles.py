"""Host-side bit-packed tile stores + active-triple joins for the tile path.

The doubly-compressed sparsity structure of the paper, promoted to tile
granularity: each block of U keeps only its *nonempty* 128x128-bit tiles
(``packed`` store + ``(tile_row, tile_col)`` ids), and for every Cannon
pairing the planner precomputes the join

    {(a_slot, b_slot, m_slot) : A-tile (ti,tk), B-tile (tj,tk), M-tile (ti,tj)}

which is the list of triples the tile kernels run over — empty tiles are
never touched.  The outputs are byte-identical to the JAX package's module
of the same name; its two per-element Python loops (the slot lookup of
every edge and the join) are vectorised here with the same output order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..kernels.tc_tile.tc_tile import TILE, WORDS
from .decomp import BlockCSR
from .plan import INT, TCPlan, as_plan

__all__ = ["TilePlan", "build_tile_plan", "pack_block_tiles", "stage_tile_plan"]


def pack_block_tiles(blk: BlockCSR):
    """Pack one block's entries into bit tiles.

    Returns (packed (nt, TILE, WORDS) uint32, ids (nt, 2) int32) where
    ``ids[t] = (tile_row, tile_col)`` sorted lexicographically.
    """
    rows = np.repeat(np.arange(blk.n_rows, dtype=np.int64), np.diff(blk.indptr))
    cols = np.asarray(blk.indices, dtype=np.int64)
    if rows.size == 0:
        return (
            np.zeros((0, TILE, WORDS), dtype=np.uint32),
            np.zeros((0, 2), dtype=INT),
        )
    width = blk.n_cols // TILE + 2
    key = (rows // TILE) * width + cols // TILE
    uniq = np.unique(key)
    slots = np.searchsorted(uniq, key)
    packed = np.zeros((uniq.shape[0], TILE, WORDS), dtype=np.uint32)
    c_in = cols % TILE
    np.bitwise_or.at(
        packed,
        (slots, rows % TILE, c_in // 32),
        np.uint32(1) << (c_in % 32).astype(np.uint32),
    )
    ids = np.stack([uniq // width, uniq % width], axis=1).astype(INT)
    return packed, ids


def _join(a_ids: np.ndarray, b_ids: np.ndarray, m_ids: np.ndarray) -> np.ndarray:
    """Triples ``(a_slot, b_slot, m_slot, 1)`` of one (device, shift): every
    A tile ``(ti, tk)`` with every B tile ``(tj, tk)``, kept when ``(ti, tj)``
    is a mask tile.  Order: A slot ascending, then B slot ascending."""
    if not (len(a_ids) and len(b_ids) and len(m_ids)):
        return np.zeros((0, 4), dtype=INT)
    b_order = np.argsort(b_ids[:, 1], kind="stable")  # by tk, then slot
    b_tk = b_ids[b_order, 1]
    lo = np.searchsorted(b_tk, a_ids[:, 1], side="left")
    cnt = np.searchsorted(b_tk, a_ids[:, 1], side="right") - lo
    a_slot = np.repeat(np.arange(a_ids.shape[0], dtype=np.int64), cnt)
    run_start = np.cumsum(cnt) - cnt
    pos = np.arange(a_slot.shape[0], dtype=np.int64) + np.repeat(lo - run_start, cnt)
    b_slot = b_order[pos]
    # mask ids are lexicographically sorted, so row * width + col is too
    width = int(max(m_ids[:, 1].max(), b_ids[:, 0].max())) + 1
    m_key = m_ids[:, 0].astype(np.int64) * width + m_ids[:, 1]
    want = a_ids[a_slot, 0].astype(np.int64) * width + b_ids[b_slot, 0]
    m_slot = np.minimum(np.searchsorted(m_key, want), m_key.shape[0] - 1)
    hit = m_key[m_slot] == want
    out = np.ones((int(hit.sum()), 4), dtype=INT)
    out[:, 0] = a_slot[hit]
    out[:, 1] = b_slot[hit]
    out[:, 2] = m_slot[hit]
    return out


@dataclasses.dataclass
class TilePlan:
    """Stacked tile stores + per-shift triple joins for a TCPlan."""

    q: int
    nt_pad: int  # padded tiles per block store
    trip_pad: int  # padded triples per (device, shift)

    # pre-skewed stores matching the Cannon placement of the parent plan
    a_tiles: np.ndarray  # (q, q, nt_pad, TILE, WORDS) uint32
    b_tiles: np.ndarray  # (q, q, nt_pad, TILE, WORDS) uint32
    m_tiles: np.ndarray  # (q, q, nt_pad, TILE, WORDS) uint32
    triples: np.ndarray  # (q, q, q, trip_pad, 4) int32  [x, y, shift]

    stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    # propagated from the parent TCPlan so the tile path stages the same
    # (q, q, q) skip mask as the CSR paths
    step_keep: "np.ndarray | None" = None

    def device_arrays(self) -> Dict[str, np.ndarray]:
        out = dict(
            a_tiles=self.a_tiles,
            b_tiles=self.b_tiles,
            m_tiles=self.m_tiles,
            triples=self.triples,
        )
        if self.step_keep is not None:
            out["step_keep"] = self.step_keep
        return out


def stage_tile_plan(tp: TilePlan, device) -> Dict[str, torch.Tensor]:
    """The tile plan's arrays as tensors on ``device`` (or spread over a
    ``(q, q)`` :class:`~repro_torch.launch.mesh.DeviceMesh`, position by
    position); the uint32 stores travel as int32 bit patterns (torch
    cannot roll or shift uint32 on the CPU), which is what the tile
    kernels take."""
    from ..pipeline.artifact import stage_arrays

    return stage_arrays(
        {k: v.view(np.int32) if v.dtype == np.uint32 else v
         for k, v in tp.device_arrays().items()}, device)


def build_tile_plan(plan: TCPlan) -> TilePlan:
    """Build tile stores + joins from a planned graph (needs plan.blocks).

    Accepts a raw :class:`TCPlan` or a pipeline ``PlanArtifact``."""
    plan = as_plan(plan)
    if plan.blocks is None:
        raise ValueError(
            "the tile plan needs the plan's blocks: plan with keep_blocks=True"
        )
    q = plan.q
    blocks = plan.blocks
    # σ visit order of the parent plan's Cannon alignment: tile stores and
    # per-shift joins must see the same panel z = σ[(x+y+s) % q] as the CSR
    # placement
    sp = list(plan.skew_perm) if plan.skew_perm is not None else list(range(q))

    packed: List[List[np.ndarray]] = [[None] * q for _ in range(q)]
    ids: List[List[np.ndarray]] = [[None] * q for _ in range(q)]
    for x in range(q):
        for y in range(q):
            packed[x][y], ids[x][y] = pack_block_tiles(blocks[x][y])
    nt_pad = max(1, max(ids[x][y].shape[0] for x in range(q) for y in range(q)))

    joins = [
        [[_join(ids[x][sp[(x + y + s) % q]], ids[y][sp[(x + y + s) % q]],
                ids[x][y]) for s in range(q)] for y in range(q)]
        for x in range(q)
    ]
    trip_pad = max(1, max(j.shape[0] for jx in joins for jy in jx for j in jy))
    triples = np.zeros((q, q, q, trip_pad, 4), dtype=INT)
    ntrips = 0
    for x in range(q):
        for y in range(q):
            for s in range(q):
                arr = joins[x][y][s]
                triples[x, y, s, : arr.shape[0]] = arr
                ntrips += arr.shape[0]

    def stores(place):
        out = np.zeros((q, q, nt_pad, TILE, WORDS), dtype=np.uint32)
        for x in range(q):
            for y in range(q):
                bx, by = place(x, y)
                out[x, y, : packed[bx][by].shape[0]] = packed[bx][by]
        return out

    total_tiles = sum(ids[x][y].shape[0] for x in range(q) for y in range(q))
    return TilePlan(
        q=q,
        nt_pad=nt_pad,
        trip_pad=trip_pad,
        a_tiles=stores(lambda x, y: (x, sp[(x + y) % q])),
        b_tiles=stores(lambda x, y: (y, sp[(x + y) % q])),
        m_tiles=stores(lambda x, y: (x, y)),
        triples=triples,
        step_keep=plan.step_keep,
        stats=dict(
            total_active_tiles=float(total_tiles),
            triples_total=float(ntrips),
            tile_fill=float(plan.m / max(1, total_tiles * TILE * TILE)),
            trip_padding_fraction=float(
                1.0 - ntrips / max(1, q * q * q * trip_pad)
            ),
        ),
    )
