"""Fused device-step intersection: the CUDA kernel's wrappers and their
plain PyTorch versions.

The function, for a tile size ``tile`` and fragment caps::

    out[g] = Σ_{t in tile g, t < tcount}
                 |row_A(ti[t])[:a_cap] ∩ row_B(tj[t])[:b_cap]|

with sorted, duplicate-free CSR rows.  One kernel, ``csrc/tc_fused.cu``,
computes it for a whole device-step: tasks ``[0, n_long)`` are the long
bucket (A cut at ``d_long``, B at ``d_long`` or whole), tasks
``[n_long, tmax)`` the short bucket (both cut at ``d_short``); tiles start
at 0 and again at ``n_long``.  Two entry points launch it:

* :func:`fused_short_counts` — the short bucket alone (``n_long = 0``,
  both caps ``d``), with the signature of the JAX package's
  ``fused_short_counts`` minus ``interpret``; it replaces that TPU kernel
  (``_fused_panel_kernel``).  Its plain version is
  :func:`fused_short_counts_plain`, the panel formulation.
* :func:`fused_step_counts` — both buckets in one launch, which is what
  ``ops.count_pair_fused`` runs on the GPU; its plain version is
  :func:`fused_step_counts_plain`, sorted membership task by task.

For tensors on a CUDA device each launches the hand-written kernel (or
raises — nothing stands in for it on the GPU); for tensors on the CPU each
takes its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import SENTINEL_A, SENTINEL_B, gather_panel

__all__ = ["STAGE_LIMIT", "fused_short_counts", "fused_short_counts_plain",
           "fused_step_counts", "fused_step_counts_plain", "fused_tiles",
           "launch_count", "reset_launch_count", "stage_limit"]

# number of times a wrapper has launched the CUDA kernel
LAUNCHES = 0

# ids of an A row the kernel stages in shared memory (kStage of
# csrc/tc_fused.cu); longer rows are searched in global memory
STAGE_LIMIT = 512

# (tile, d, d) compare elements per host-loop iteration of the plain version
_PLAIN_GROUP_ELEMS = 1 << 26
# gathered B ids per host-loop iteration of the per-task plain version
_TASK_GROUP_ELEMS = 1 << 22


def launch_count() -> int:
    return LAUNCHES


def reset_launch_count() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _ntile(tmax: int, tile: int) -> int:
    return max(1, -(-tmax // tile))


def fused_tiles(tmax: int, n_long: int, tile: int):
    """``(ntile_long, ntile)`` of a step: ``ceil(n_long / tile)`` long
    tiles, then the short bucket's ``_ntile(tmax - n_long)`` (none when
    the long bucket takes every task of a non-empty list)."""
    ntile_long = -(-n_long // tile)
    if n_long < tmax or tmax == 0:
        return ntile_long, ntile_long + _ntile(tmax - n_long, tile)
    return ntile_long, ntile_long


def fused_short_counts_plain(
    a_indptr, a_indices, b_indptr, b_indices, ti, tj, tcount: int, *,
    tile: int, d: int,
):
    """The plain version: gather two ``(tile, d)`` panels per tile, padded
    with −1 (A) / ``int32.max`` (B), compare all against all, sum per
    tile.  Returns ``(ntile,)`` int32 — what the kernel returns."""
    dev = a_indptr.device
    tmax = ti.shape[0]
    ntile = _ntile(tmax, tile)
    pad = ntile * tile - tmax
    if pad:
        ti = torch.cat([ti, ti.new_zeros(pad)])
        tj = torch.cat([tj, tj.new_zeros(pad)])
    live = min(int(tcount), tmax)
    out = torch.zeros(ntile, dtype=torch.int32, device=dev)
    ngroup = max(1, _PLAIN_GROUP_ELEMS // max(1, tile * d * d))
    # tiles wholly past the live tasks stay 0
    for g0 in range(0, -(-live // tile), ngroup):
        g1 = min(g0 + ngroup, ntile)
        lo, hi = g0 * tile, g1 * tile
        ok = torch.arange(lo, hi, device=dev) < live
        pa = gather_panel(a_indptr, a_indices, ti[lo:hi], d, SENTINEL_A, ok)
        pb = gather_panel(b_indptr, b_indices, tj[lo:hi], d, SENTINEL_B, ok)
        eq = pa[:, :, None] == pb[:, None, :]
        out[g0:g1] = eq.sum(dim=(1, 2)).reshape(g1 - g0, tile).sum(dim=1)
    return out


def _task_counts(a_indptr, a_indices, b_indptr, b_indices, ti, tj,
                 a_cap: int, b_cap=None):
    """``(T,)`` int64: |row_A(ti)[:a_cap] ∩ row_B(tj)[:b_cap]| task by task
    (``b_cap=None``: the whole B row), by sorted membership — each A id
    searched in its task's B row, padded high so it stays sorted."""
    dev = a_indptr.device
    out = torch.zeros(ti.shape[0], dtype=torch.int64, device=dev)
    if ti.shape[0] == 0:
        return out
    len_a = (a_indptr[ti.long() + 1] - a_indptr[ti.long()]).clamp(max=a_cap)
    len_b = b_indptr[tj.long() + 1] - b_indptr[tj.long()]
    if b_cap is not None:
        len_b = len_b.clamp(max=b_cap)
    wa = max(1, int(len_a.max()))
    wb = max(1, int(len_b.max()))
    group = max(1, _TASK_GROUP_ELEMS // max(wa, wb))
    for lo in range(0, ti.shape[0], group):
        hi = min(lo + group, ti.shape[0])
        pa = gather_panel(a_indptr, a_indices, ti[lo:hi], wa, SENTINEL_A)
        pb = gather_panel(b_indptr, b_indices, tj[lo:hi], wb, SENTINEL_B)
        pos = torch.searchsorted(pb, pa)
        hit = torch.gather(pb, 1, pos.clamp_(max=wb - 1)) == pa
        out[lo:hi] = hit.sum(dim=1)
    return out


def fused_step_counts_plain(
    a_indptr, a_indices, b_indptr, b_indices, ti, tj, tcount: int, *,
    n_long: int, tile: int, d_long: int, long_b_whole: bool, d_short: int,
):
    """The plain version of :func:`fused_step_counts`: every live task's
    count by sorted membership at its bucket's caps, summed per tile.
    Returns ``(ntile,)`` int32 — what the kernel returns."""
    tmax = ti.shape[0]
    live = min(int(tcount), tmax)
    ntile_long, ntile = fused_tiles(tmax, n_long, tile)
    per = torch.zeros(tmax, dtype=torch.int64, device=a_indptr.device)
    nl = min(live, n_long)
    per[:nl] = _task_counts(a_indptr, a_indices, b_indptr, b_indices,
                            ti[:nl], tj[:nl], d_long,
                            None if long_b_whole else d_long)
    if live > n_long:
        per[n_long:live] = _task_counts(
            a_indptr, a_indices, b_indptr, b_indices, ti[n_long:live],
            tj[n_long:live], d_short, d_short)
    long_part = torch.zeros(ntile_long * tile, dtype=torch.int64,
                            device=per.device)
    long_part[:n_long] = per[:n_long]
    short_part = torch.zeros((ntile - ntile_long) * tile, dtype=torch.int64,
                             device=per.device)
    short_part[:tmax - n_long] = per[n_long:]
    return torch.cat([long_part.reshape(-1, tile).sum(dim=1),
                      short_part.reshape(-1, tile).sum(dim=1)]).to(torch.int32)


def _check(name, t, dev, ndim=1):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .._build import load_library

        lib = load_library("tc_fused")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tc_fused_counts.argtypes = [p, p, p, p, p, p, ll, ll, ll, i, i, i,
                                        i, i, p, p, i]
        lib.tc_fused_counts.restype = ctypes.c_int
        lib.tc_fused_stage_limit.argtypes = []
        lib.tc_fused_stage_limit.restype = ctypes.c_int
        lib.tc_fused_error_string.argtypes = [ctypes.c_int]
        lib.tc_fused_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def stage_limit() -> int:
    """The built kernel's staging limit (builds it): ``STAGE_LIMIT``."""
    return int(_lib().tc_fused_stage_limit())


def _launch(name, a_indptr, a_indices, b_indptr, b_indices, ti, tj,
            tcount: int, *, n_long: int, tile: int, a_cap_long: int,
            b_cap_long: int, d_short: int):
    """One launch of the kernel on CUDA tensors; ``(ntile,)`` int32."""
    global LAUNCHES
    dev = a_indptr.device
    if dev.type != "cuda":
        raise ValueError(f"{name} has no kernel for device {dev}")
    for arg, t in (("a_indptr", a_indptr), ("a_indices", a_indices),
                   ("b_indptr", b_indptr), ("b_indices", b_indices),
                   ("ti", ti), ("tj", tj)):
        _check(arg, t, dev)
    if ti.shape != tj.shape:
        raise ValueError(f"ti {tuple(ti.shape)} and tj {tuple(tj.shape)} differ")
    if a_indptr.shape[0] < 2 or b_indptr.shape[0] < 2:
        raise ValueError("indptr needs at least one row")
    tmax = ti.shape[0]
    ntile = fused_tiles(tmax, n_long, tile)[1]
    out = torch.empty(ntile, dtype=torch.int32, device=dev)
    # The launch is asynchronous, on the current (compute) stream.  Inputs
    # that the caller drops right after this call (task-list slices) stay
    # valid for it: PyTorch's allocator hands freed memory only to later
    # allocations on the stream that allocated it, here this one, even
    # while this launch is queued.  Across streams that does not hold by
    # itself: a mesh's shift copies run on copy streams, so a mesh run
    # allocates the buffers they write before its entry event, which they
    # wait for, every block they read or write is marked with
    # ``record_stream``, and a count reads a received block only after the
    # event of the copy that wrote it (core/lanes.py).
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tc_fused_counts(
            a_indptr.data_ptr(), a_indices.data_ptr(),
            b_indptr.data_ptr(), b_indices.data_ptr(),
            ti.data_ptr(), tj.data_ptr(), tcount, tmax, n_long, tile,
            a_cap_long, b_cap_long, d_short, ntile, out.data_ptr(), stream,
            dev.index,
        )
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} "
            f"({lib.tc_fused_error_string(rc).decode()})"
        )
    LAUNCHES += 1
    return out


def fused_short_counts(
    a_indptr, a_indices, b_indptr, b_indices, ti, tj, tcount: int, *,
    tile: int, d: int,
):
    """Per-tile fused intersection counts for the short-task list.

    Args:
      a_indptr/b_indptr: (nb+1,) int32 CSR row pointers.
      a_indices/b_indices: (npad,) int32 CSR column ids.
      ti, tj: (tmax,) int32 short-task row ids; first ``tcount`` are real.
      tcount: host integer.
      tile: tasks per tile (``ops.fused_tile_for`` sizes this).
      d: fragment cap — every real fragment should fit (maxfrag contract);
        longer rows are truncated at ``d`` by kernel and plain version alike.

    Returns: (ntile,) int32 per-tile counts; the caller sums them in int64.
    On a CUDA device the launch is asynchronous on the current stream.
    """
    tile, d, tcount = int(tile), int(d), int(tcount)
    if tile < 1 or d < 1:
        raise ValueError(f"tile and d must be >= 1, got tile={tile} d={d}")
    if a_indptr.device.type == "cpu":
        return fused_short_counts_plain(
            a_indptr, a_indices, b_indptr, b_indices, ti, tj, tcount,
            tile=tile, d=d,
        )
    return _launch("fused_short_counts", a_indptr, a_indices, b_indptr,
                   b_indices, ti, tj, tcount, n_long=0, tile=tile,
                   a_cap_long=d, b_cap_long=d, d_short=d)


def fused_step_counts(
    a_indptr, a_indices, b_indptr, b_indices, ti, tj, tcount: int, *,
    n_long: int, tile: int, d_long: int, long_b_whole: bool, d_short: int,
):
    """Per-tile counts of a whole device-step, both buckets, one launch.

    Tasks ``[0, n_long)`` take A cut at ``d_long`` and B whole
    (``long_b_whole``, the row-encoded key search's function) or cut at
    ``d_long`` (the padded search's); tasks ``[n_long, tmax)`` take both
    cut at ``d_short``.  Returns ``(ntile,)`` int32: ``ceil(n_long /
    tile)`` long tiles, then the short bucket's tiles exactly as
    :func:`fused_short_counts` gives them for ``ti[n_long:]``.
    """
    tile, tcount, n_long = int(tile), int(tcount), int(n_long)
    d_long, d_short = int(d_long), int(d_short)
    if tile < 1 or d_long < 1 or d_short < 1:
        raise ValueError(f"tile, d_long and d_short must be >= 1, got "
                         f"{tile}, {d_long}, {d_short}")
    if not 0 <= n_long <= ti.shape[0]:
        raise ValueError(f"n_long={n_long} is outside [0, {ti.shape[0]}]")
    kw = dict(n_long=n_long, tile=tile, d_short=d_short)
    if a_indptr.device.type == "cpu":
        return fused_step_counts_plain(
            a_indptr, a_indices, b_indptr, b_indices, ti, tj, tcount,
            d_long=d_long, long_b_whole=long_b_whole, **kw,
        )
    return _launch("fused_step_counts", a_indptr, a_indices, b_indptr,
                   b_indices, ti, tj, tcount, a_cap_long=d_long,
                   b_cap_long=-1 if long_b_whole else d_long, **kw)
