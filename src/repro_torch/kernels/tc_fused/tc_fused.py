"""Fused device-step intersection for short tasks: the CUDA kernel's
wrapper and its plain PyTorch version.

The function, for a tile size ``tile`` and a fragment cap ``d``::

    out[g] = Σ_{t in tile g, t < tcount} |row_A(ti[t])[:d] ∩ row_B(tj[t])[:d]|

with sorted, duplicate-free CSR rows.  :func:`fused_short_counts` is the
entry point: for tensors on a CUDA device it launches the hand-written
kernel ``csrc/tc_fused.cu`` (or raises — nothing stands in for it on the
GPU), for tensors on the CPU it takes :func:`fused_short_counts_plain`,
the panel formulation of the same function in ordinary tensor ops.  The
kernel replaces the TPU kernel ``fused_short_counts`` /
``_fused_panel_kernel`` of the JAX package and keeps its signature minus
``interpret``.

Only *short* tasks (both fragments ≤ ``d`` under the planner's maxfrag
split) come here; long rows take the chunked fallback in
``ops.count_pair_fused``.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import SENTINEL_A, SENTINEL_B, gather_panel

__all__ = ["fused_short_counts", "fused_short_counts_plain", "launch_count",
           "reset_launch_count"]

# number of times the wrapper has launched the CUDA kernel
LAUNCHES = 0

# (tile, d, d) compare elements per host-loop iteration of the plain version
_PLAIN_GROUP_ELEMS = 1 << 26


def launch_count() -> int:
    return LAUNCHES


def reset_launch_count() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _ntile(tmax: int, tile: int) -> int:
    return max(1, -(-tmax // tile))


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


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from .._build import load_library

        lib = load_library("tc_fused")
        fn = lib.tc_fused_short_counts
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ll, ll, i, i, i, p, p]
        fn.restype = ctypes.c_int
        lib.tc_fused_error_string.argtypes = [ctypes.c_int]
        lib.tc_fused_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.tc_fused_error_string)
    return _FN


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
      tile: tasks per block (``ops.fused_tile_for`` sizes this).
      d: fragment cap — every real fragment should fit (maxfrag contract);
        longer rows are truncated at ``d`` by kernel and plain version alike.

    Returns: (ntile,) int32 per-tile counts; the caller sums them in int64.
    On a CUDA device the launch is asynchronous on the current stream.
    """
    global LAUNCHES
    tile, d, tcount = int(tile), int(d), int(tcount)
    if tile < 1 or d < 1:
        raise ValueError(f"tile and d must be >= 1, got tile={tile} d={d}")
    dev = a_indptr.device
    if dev.type == "cpu":
        return fused_short_counts_plain(
            a_indptr, a_indices, b_indptr, b_indices, ti, tj, tcount,
            tile=tile, d=d,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_short_counts has no kernel for device {dev}")
    for name, t in (("a_indptr", a_indptr), ("a_indices", a_indices),
                    ("b_indptr", b_indptr), ("b_indices", b_indices),
                    ("ti", ti), ("tj", tj)):
        _check(name, t, dev)
    if ti.shape != tj.shape:
        raise ValueError(f"ti {tuple(ti.shape)} and tj {tuple(tj.shape)} differ")
    if a_indptr.shape[0] < 2 or b_indptr.shape[0] < 2:
        raise ValueError("indptr needs at least one row")
    tmax = ti.shape[0]
    ntile = _ntile(tmax, tile)
    out = torch.empty(ntile, dtype=torch.int32, device=dev)
    # The launch is asynchronous.  Inputs that the caller drops right after
    # this call (task-list slices) stay valid for it: PyTorch's allocator
    # reuses freed memory only for later work on the same stream.
    fn, err_str = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            a_indptr.data_ptr(), a_indices.data_ptr(),
            b_indptr.data_ptr(), b_indices.data_ptr(),
            ti.data_ptr(), tj.data_ptr(),
            tcount, tmax, tile, d, ntile, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"tc_fused_short_counts launch failed: CUDA error {rc} "
            f"({err_str(rc).decode()})"
        )
    LAUNCHES += 1
    return out
