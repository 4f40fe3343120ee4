"""Per-shift block-pair counting in plain PyTorch — the tensor-op paths.

All paths compute, for a static task list ``(ti, tj)`` (the nonzeros of the
device's mask block), ``sum_t |row_A(ti_t)  ∩  row_B(tj_t)|`` where A and B
are the two CSR blocks a logical device holds at the current Cannon step.

* ``search``  — vectorized binary-search intersection, chunked over tasks.
  ``probe_shorter=True`` probes the shorter fragment into the longer (the
  tensor re-expression of the paper's ⟨j,i,k⟩ hash-the-longer-list rule).
* ``global``  — probe A fragments into one row-encoded sorted key array of
  the whole B block; only the probe side is gathered and padded.
* ``search2`` — ``global`` in two length buckets
  (:func:`count_pair_search_two_level`): long tasks at ``dmax`` probe
  padding, the rest at ``d_small``.
* ``fused``   — the hand-written CUDA intersection kernel
  (:mod:`repro_torch.kernels.tc_fused`); its plain route
  (``count_pair_fused_plain``, what the CPU runs) counts the long bucket
  with :func:`count_pair_search` / :func:`count_pair_search_global`.
* ``dense``   — the oracle path: ``sum((A @ Bᵀ) ⊙ M)`` over dense 0/1
  blocks (:func:`count_pair_dense`).

Everything here is ordinary tensor code that runs on whatever device its
inputs live on.  ``tcount`` is a host integer (the engine reads it from
the plan's numpy ``m_cnt``), chunks wholly past it are never launched, and
each function returns a 0-dim ``int64`` tensor on the inputs' device
without synchronising.
"""
from __future__ import annotations

import contextlib
import contextvars
import warnings
from typing import Optional

import numpy as np
import torch

__all__ = [
    "aug_key_dtype",
    "aug_key_numpy_dtype",
    "build_aug_keys",
    "count_pair_dense",
    "count_pair_search",
    "count_pair_search_global",
    "count_pair_search_two_level",
    "gather_rows",
    "sample_task_chunks",
]

_INT32_MAX = int(np.iinfo(np.int32).max)


def aug_key_dtype(base: int) -> torch.dtype:
    """Dtype wide enough for row-encoded keys ``row * base + col``.

    Rows and cols are block-local (``< base``), so the largest key is
    ``base**2 - 1``.  int32 covers ``base <= 46340`` (byte parity with the
    planner-staged ``b_aug``); beyond that the key is int64.
    """
    return torch.int32 if base * base - 1 <= _INT32_MAX else torch.int64


def aug_key_numpy_dtype(base: int) -> np.dtype:
    """:func:`aug_key_dtype` for the host planner's numpy arrays."""
    return np.dtype(np.int32 if base * base - 1 <= _INT32_MAX else np.int64)


def gather_rows(indptr, indices, rows, dpad: int, sentinel: int):
    """Gather padded adjacency fragments ``(T, dpad)`` for ``rows`` (T,).

    Padding positions are filled with ``sentinel`` (greater than any valid
    local column id) so each returned row stays sorted — required by the
    binary-search probe.  Returns ``(values, lengths)``.
    """
    rows = rows.long()
    start = indptr[rows].long()
    length = indptr[rows + 1].long() - start
    offs = torch.arange(dpad, dtype=torch.int64, device=indptr.device)
    idx = start[:, None] + offs[None, :]
    valid = offs[None, :] < length[:, None]
    vals = indices[idx.clamp_(0, indices.shape[0] - 1)]
    return torch.where(valid, vals, vals.new_full((), sentinel)), length


# the dry run's chunk sampler (``repro_torch.launch.roofline``): when
# set, :func:`_task_chunks` hands the chunks out through it
_CHUNK_SAMPLER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_chunk_sampler", default=None)


@contextlib.contextmanager
def sample_task_chunks(sampler):
    """While the block runs, every task-chunk loop of this module yields
    ``sampler(n_live, chunk)``'s chunks in place of all of them.  The dry
    run's walk passes a sampler that yields the first two full chunks and
    the ragged last one, each weighted by how many chunks it stands
    for."""
    token = _CHUNK_SAMPLER.set(sampler)
    try:
        yield
    finally:
        _CHUNK_SAMPLER.reset(token)


def _task_chunks(tmax: int, tcount: int, chunk: int):
    """``(lo, n_valid)`` for every chunk that holds a real task."""
    live = min(int(tcount), tmax)
    sampler = _CHUNK_SAMPLER.get()
    if sampler is not None:
        yield from sampler(live, chunk)
        return
    for lo in range(0, live, chunk):
        yield lo, min(lo + chunk, live) - lo


def count_pair_search(
    a_indptr,
    a_indices,
    b_indptr,
    b_indices,
    ti,
    tj,
    tcount: int,
    *,
    dpad: int,
    chunk: int,
    probe_shorter: bool = True,
    sentinel: Optional[int] = None,
):
    """Chunked vectorized set-intersection over the device's task list.

    ``ti, tj: (tmax,)`` local row ids into A / B; only the first ``tcount``
    are real.  Tasks are processed ``chunk`` at a time in a host loop so
    the working set stays at ``O(chunk * dpad)`` regardless of block size.
    """
    dev = a_indptr.device
    total = torch.zeros((), dtype=torch.int64, device=dev)
    if sentinel is None:
        sentinel = a_indptr.shape[0]  # nb + 1 > any local col id
    offs = torch.arange(dpad, device=dev)
    for lo, nvalid in _task_chunks(ti.shape[0], tcount, chunk):
        rows_i, rows_j = ti[lo : lo + nvalid], tj[lo : lo + nvalid]
        a_vals, a_len = gather_rows(a_indptr, a_indices, rows_i, dpad, sentinel)
        b_vals, b_len = gather_rows(b_indptr, b_indices, rows_j, dpad, sentinel)
        if probe_shorter:
            swap = (a_len > b_len)[:, None]
            probe = torch.where(swap, b_vals, a_vals)
            keys = torch.where(swap, a_vals, b_vals)
            probe_len = torch.minimum(a_len, b_len)
        else:
            probe, keys, probe_len = a_vals, b_vals, a_len
        pos = torch.searchsorted(keys, probe)
        hit = torch.gather(keys, 1, pos.clamp_(max=dpad - 1)) == probe
        hit &= offs[None, :] < probe_len[:, None]
        total += hit.sum()
    return total


def build_aug_keys(b_indptr, b_indices, base: Optional[int] = None):
    """Row-encoded global key array for :func:`count_pair_search_global`:
    ``aug[e] = row(e) * base + col(e)`` with ``base = nb + 1`` by default,
    sorted because rows are sorted and the padding (column ``base - 1`` in
    a row past the last) lands on the maximal key."""
    nb = b_indptr.shape[0] - 1
    base = nb + 1 if base is None else int(base)
    key_dtype = aug_key_dtype(base)
    nnz = b_indices.shape[0]
    e = torch.arange(nnz, dtype=b_indptr.dtype, device=b_indptr.device)
    row_of = torch.searchsorted(b_indptr, e, right=True) - 1
    return row_of.to(key_dtype) * base + b_indices.to(key_dtype)


def count_pair_search_global(
    a_indptr,
    a_indices,
    b_indptr,
    b_indices,
    ti,
    tj,
    tcount: int,
    *,
    dpad: int,
    chunk: int,
    aug_b=None,
    base: Optional[int] = None,
):
    """Gather-free-keys intersection: probe A fragments into a row-encoded
    *global* sorted view of B (``aug_b[e] = row(e) * base + col(e)``).

    Only the probe side is gathered (padded to ``dpad``); the keys side is
    searched in place regardless of row length — so probe padding can be
    sized to the PROBE distribution alone, and truncation bugs on long key
    rows are structurally impossible.

    ``base`` must exceed every column id, padding included: ``nb + 1``
    (the default) for block-local ids; the 1D ring, whose ids are global
    vertex ids padded with ``n + 1``, passes ``n + 2``.  With a base at or
    below a column id, keys of neighbouring rows overlap and the count is
    wrong.
    """
    dev = a_indptr.device
    nb = b_indptr.shape[0] - 1
    base = nb + 1 if base is None else int(base)
    if aug_b is None:
        aug_b = build_aug_keys(b_indptr, b_indices, base)
    key_dtype = aug_key_dtype(base)
    if aug_b.dtype != key_dtype:
        raise TypeError(
            f"aug_b is {aug_b.dtype} but keys for base={base} are {key_dtype}"
        )
    sentinel = base - 1  # never a valid column id
    total = torch.zeros((), dtype=torch.int64, device=dev)
    offs = torch.arange(dpad, device=dev)
    last = aug_b.shape[0] - 1
    for lo, nvalid in _task_chunks(ti.shape[0], tcount, chunk):
        rows_i, rows_j = ti[lo : lo + nvalid], tj[lo : lo + nvalid]
        a_vals, a_len = gather_rows(a_indptr, a_indices, rows_i, dpad, sentinel)
        keys = rows_j[:, None].to(key_dtype) * base + a_vals.to(key_dtype)
        pos = torch.searchsorted(aug_b, keys.reshape(-1)).reshape(keys.shape)
        hit = aug_b[pos.clamp_(max=last)] == keys
        hit &= offs[None, :] < a_len[:, None]
        total += hit.sum()
    return total


_TWO_LEVEL_KW_WARNED = False


def _warn_two_level_kwargs(probe_shorter, sentinel) -> None:
    """One-time notice that the two-level path ignores search-only knobs.

    The global-key formulation *always* probes the A side into the
    row-encoded B keys and needs no padding sentinel, so
    ``probe_shorter``/``sentinel`` are accepted for signature
    compatibility with :func:`count_pair_search` but have no effect —
    callers porting from ``search`` must not believe the flags are
    honored.
    """
    global _TWO_LEVEL_KW_WARNED
    if _TWO_LEVEL_KW_WARNED:
        return
    ignored = []
    if probe_shorter is not True:
        ignored.append(f"probe_shorter={probe_shorter!r}")
    if sentinel is not None:
        ignored.append(f"sentinel={sentinel!r}")
    if ignored:
        _TWO_LEVEL_KW_WARNED = True
        warnings.warn(
            "count_pair_search_two_level ignores "
            + ", ".join(ignored)
            + ": the global-key path always probes the A side and needs "
            "no sentinel (this notice is emitted once per process)",
            UserWarning,
            stacklevel=3,
        )


def count_pair_search_two_level(
    a_indptr,
    a_indices,
    b_indptr,
    b_indices,
    ti,
    tj,
    tcount: int,
    n_long: int,
    *,
    dpad_long: int,
    dpad_short: int,
    chunk: int,
    probe_shorter: bool = True,
    sentinel: Optional[int] = None,
    aug_b=None,
):
    """Length-bucketed intersection: two calls of
    :func:`count_pair_search_global`.

    The planner (``bucketize_plan`` or the autotune stage) reorders each
    device's task list so the ``n_long`` tasks whose *probe* fragment can
    exceed ``dpad_short`` come first; the long bucket — ``n_long`` rounded
    up to a whole ``chunk`` — runs at ``dpad_long`` probe padding, the
    rest at ``dpad_short``.  Both buckets search the same row-encoded B
    keys (``aug_b``, planner-staged, or built here once), so the keys
    side needs no padding at all.

    ``probe_shorter``/``sentinel`` are search-path knobs the global-key
    formulation ignores — passing non-defaults warns once per process.
    """
    _warn_two_level_kwargs(probe_shorter, sentinel)
    tmax = ti.shape[0]
    tcount = int(tcount)
    n_long_c = min(-(-max(1, int(n_long)) // chunk) * chunk, tmax)
    if aug_b is None:
        aug_b = build_aug_keys(b_indptr, b_indices)
    total = count_pair_search_global(
        a_indptr, a_indices, b_indptr, b_indices,
        ti[:n_long_c], tj[:n_long_c], min(tcount, n_long_c),
        dpad=dpad_long, chunk=chunk, aug_b=aug_b,
    )
    if n_long_c >= tmax:
        return total
    return total + count_pair_search_global(
        a_indptr, a_indices, b_indptr, b_indices,
        ti[n_long_c:], tj[n_long_c:], max(tcount - n_long_c, 0),
        dpad=dpad_short, chunk=chunk, aug_b=aug_b,
    )


def count_pair_dense(a_dense, b_dense, m_dense):
    """``sum((A @ Bᵀ) ⊙ M)`` — exact for 0/1 blocks.

    ``A: (nb, nb)`` rows=i cols=k; ``B: (nb, nb)`` rows=j cols=k;
    ``M: (nb, nb)`` mask at (i_local, j_local), all float32.  Every entry
    of the product is an integer ≤ nb, exact in float32; the masked sum is
    taken in float64, so the count stays exact past 2^24.  Returns a 0-dim
    int64 tensor.
    """
    prod = a_dense @ b_dense.T
    return (prod * m_dense).sum(dtype=torch.float64).to(torch.int64)
