"""Measured autotune table for the fused kernel.

The percentile autotune stage is *analytic*: it derives shapes from the
probe-length distribution without running a kernel.  The measured mode
times a few candidate ``(tile, chunk, d_small)`` shapes of the fused
kernel against the baseline (``search2`` on Cannon and SUMMA, ``search``
on the ring) on the plan's busiest device block, sets the verdict beside
a roofline prediction from the card's data-sheet rates
(:data:`repro_torch.launch.roofline.HW`), and persists it, so every later
run with the same (backend, dtype, shape bucket) resolves
``method="auto"`` from the table.

The key is the JAX package's: a blake2b over the table version, the
backend, the index dtype, power-of-two buckets of the block shapes and
the split parameters, so the same inputs give the same key.  The backend
is ``"cpu"`` for CPU tensors and ``"cuda:<device name>"`` on the card.
Bucketing (rather than exact shapes) makes the table reusable across
graphs of the same size class.

Entries are single JSON files, written atomically, under
:func:`default_table_dir` — the port's own directory
(``$REPRO_TORCH_TC_MEASURED_DIR`` overrides it), so neither package reads
the other's tables.  On the card the kernel and the baseline are timed by
CUDA events (one warm-up, then the least of 3 runs); on the CPU the same
calls take the plain versions and are timed by the host clock.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ...core.count import (
    build_aug_keys,
    count_pair_search,
    count_pair_search_two_level,
)
from ...device import resolve_device
from ...launch.roofline import HW
from .ops import count_pair_fused, fused_tile_for

__all__ = [
    "TABLE_VERSION",
    "default_table_dir",
    "measured_entry",
    "measured_table_key",
    "predict_fused_wins",
    "roofline_predict",
    "table_backend",
]

TABLE_VERSION = 1
_REPS = 3  # min-of-k timing


def default_table_dir() -> str:
    env = os.environ.get("REPRO_TORCH_TC_MEASURED_DIR")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "tc_measured"
    )


def table_backend(device) -> str:
    """The backend a table entry is keyed with: ``"cpu"``, or ``"cuda:"``
    and the card's name."""
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(device)
    return device.type


def _bucket(x: int) -> int:
    """Next power of two — the shape-bucket that makes entries reusable
    across graphs of the same size class."""
    return 1 << max(0, int(math.ceil(math.log2(max(1, int(x))))))


def measured_table_key(
    *,
    kind: str,
    backend: str,
    dtype: str,
    nb: int,
    nnz_pad: int,
    tmax: int,
    dmax: int,
    d_small: int,
    tail_heavy: bool,
) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(
        repr(
            (
                TABLE_VERSION,
                kind,
                backend,
                dtype,
                _bucket(nb),
                _bucket(nnz_pad),
                _bucket(tmax),
                _bucket(dmax),
                int(d_small),
                bool(tail_heavy),
            )
        ).encode()
    )
    return h.hexdigest()


def roofline_predict(
    *, tshort: int, d_small: int, dpad: int, nnz: int,
    hw: Optional[dict] = None,
) -> dict:
    """Roofline time model for the short-task bucket (the long bucket
    runs the same function on both paths and cancels out), the JAX
    package's model with the card's rates (``hw``, default :data:`HW`).

    The baseline's short bucket gathers the probe panel (``dpad`` ids per
    task) and then runs a binary search whose ~log2(nnz) dependent levels
    each touch device memory — all charged to ``hw["hbm_bw"]``.  The fused
    kernel's device-memory traffic is the two fragment gathers only; its
    ``d_small²`` compares a task are 32-bit integer work on the CUDA
    cores, charged to ``hw["fp32_ops"]`` (the JAX package charged them to
    its chip's matrix-unit peak), and its time is the larger of the two
    terms.  The model ranks the paths; the measured table is the ground
    truth it is set beside.
    """
    hw = HW if hw is None else hw
    lg = max(1.0, math.log2(max(2, nnz)))
    bytes_search = tshort * dpad * 4.0 * (2.0 + lg)
    bytes_fused = tshort * 2.0 * d_small * 4.0
    ops_fused = tshort * float(d_small) ** 2
    t_fused = max(bytes_fused / hw["hbm_bw"], ops_fused / hw["fp32_ops"])
    t_search = bytes_search / hw["hbm_bw"]
    return dict(
        t_search=t_search,
        t_fused=t_fused,
        hbm_bw=hw["hbm_bw"],
        fp32_ops=hw["fp32_ops"],
        predicted_winner="fused" if t_fused < t_search else "search2",
    )


def predict_fused_wins(entry: dict) -> bool:
    """The table's verdict: does the measured fused best beat the
    measured baseline on this shape bucket?"""
    return bool(entry.get("winner") == "fused")


def _time_once(fn, device: torch.device) -> float:
    """Least seconds of ``fn()`` over ``_REPS`` runs after one warm-up
    (which also builds and loads a kernel on its first use): CUDA events
    on the card, the host clock on the CPU (where the calls are
    synchronous)."""
    int(fn())
    best = float("inf")
    for _ in range(_REPS):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            t = e0.elapsed_time(e1) * 1e-3
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def _busiest_arrays(plan) -> Tuple:
    """(a_ptr, a_idx, b_ptr, b_idx, ti, tj, cnt, sentinel, kind) of the
    device with the most tasks — the block the measurement represents
    (host numpy)."""
    if hasattr(plan, "t_cnt"):  # OneDPlan
        p = plan.p
        flat = int(np.argmax(np.asarray(plan.t_cnt)))
        d0, o = flat // p, flat % p
        return (
            plan.indptr[d0], plan.indices[d0],
            plan.indptr[o], plan.indices[o],
            plan.t_i[d0, o], plan.t_j[d0, o],
            int(plan.t_cnt[d0, o]), plan.n + 1, "oned",
        )
    cnts = np.asarray(plan.m_cnt)
    flat = int(np.argmax(cnts))
    x, y = flat // cnts.shape[1], flat % cnts.shape[1]
    if plan.b_indptr.ndim == 4:  # SummaPlan: measure against panel 0
        return (
            plan.a_indptr[x, y], plan.a_indices[x, y],
            plan.b_indptr[x, y, 0], plan.b_indices[x, y, 0],
            plan.m_ti[x, y], plan.m_tj[x, y],
            int(cnts[x, y]), plan.nb_c + 1, "summa",
        )
    return (
        plan.a_indptr[x, y], plan.a_indices[x, y],
        plan.b_indptr[x, y], plan.b_indices[x, y],
        plan.m_ti[x, y], plan.m_tj[x, y],
        int(cnts[x, y]), plan.nb + 1, "cannon",
    )


def _candidates(d_small: int, chunk: int, dmax: int):
    """Candidate (tile, chunk, d_small) shapes: the analytic pick, a
    half-size tile, and a widened panel that pulls borderline-long tasks
    out of the long bucket's route."""
    t0 = fused_tile_for(d_small)
    cands = [(t0, chunk, d_small)]
    if t0 > 8:
        cands.append((t0 // 2, chunk, d_small))
    d2 = min(-(-d_small * 2 // 8) * 8, dmax)
    if d2 > d_small:
        cands.append((fused_tile_for(d2), chunk, d2))
    return cands


def measured_entry(
    plan,
    *,
    device=None,
    table_dir: Optional[str] = None,
) -> Tuple[dict, bool]:
    """Measured verdict for ``plan``'s shape bucket: ``(entry, hit)``.

    ``hit`` is True when the entry came off disk.  Requires a
    maxfrag-split plan (``n_long``/``d_small`` set by the two-sided
    autotune stage) — measuring the fused kernel under a probe-only
    split would time a kernel that miscounts.  ``device`` is where the
    busiest block is timed (default the current CUDA device, as every
    entry point); the entry is keyed with that device's backend
    (:func:`table_backend`), so a timing is only ever served to the
    backend that took it.  ``table_dir`` overrides
    :func:`default_table_dir`.
    """
    n_long = getattr(plan, "n_long", None)
    d_small = getattr(plan, "d_small", None)
    if n_long is None or d_small is None:
        raise ValueError(
            "measured autotune needs a maxfrag-split plan: re-plan with "
            "autotune='fused' (two-sided split) first"
        )
    report = getattr(plan, "autotune", None) or {}
    device = resolve_device(device)
    backend = table_backend(device)
    a_ptr, a_idx, b_ptr, b_idx, ti, tj, cnt, sentinel, kind = (
        _busiest_arrays(plan)
    )
    key = measured_table_key(
        kind=kind,
        backend=backend,
        dtype=str(np.asarray(a_idx).dtype),
        nb=a_ptr.shape[0] - 1,
        nnz_pad=a_idx.shape[0],
        tmax=ti.shape[0],
        dmax=plan.dmax,
        d_small=d_small,
        tail_heavy=bool(report.get("tail_heavy", False)),
    )
    table_dir = table_dir or default_table_dir()
    path = os.path.join(table_dir, key + ".json")
    if os.path.exists(path):
        with open(path) as fh:
            return json.load(fh), True

    arrs = tuple(
        torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for v in (a_ptr, a_idx, b_ptr, b_idx, ti, tj)
    )
    chunk = int(plan.chunk)
    long_fallback = "search" if kind == "oned" else "global"
    if kind == "oned":
        baseline_name = "search"

        def baseline():
            return count_pair_search(
                *arrs, cnt, dpad=plan.dmax, chunk=chunk, sentinel=sentinel)
    else:
        baseline_name = "search2"
        aug = build_aug_keys(arrs[2], arrs[3])

        def baseline():
            return count_pair_search_two_level(
                *arrs, cnt, n_long, dpad_long=plan.dmax, dpad_short=d_small,
                chunk=chunk, aug_b=aug)

    t_base = _time_once(baseline, device)
    cands = []
    for tile, ch, d in _candidates(d_small, chunk, plan.dmax):
        def fused(tile=tile, ch=ch, d=d):
            return count_pair_fused(
                *arrs, cnt, n_long=n_long, d_small=d, dpad_long=plan.dmax,
                chunk=ch, tile=tile, long_fallback=long_fallback,
                sentinel=sentinel)

        cands.append(dict(tile=tile, chunk=ch, d_small=d,
                          seconds=_time_once(fused, device)))
    best = min(cands, key=lambda c: c["seconds"])

    tshort = max(0, cnt - n_long)
    # the baseline's short bucket runs at d_small padding too (search2's
    # dpad_short) — the paths differ in traffic pattern, not padding
    predict = roofline_predict(
        tshort=max(1, tshort), d_small=d_small, dpad=d_small,
        nnz=int(b_idx.shape[0]),
    )
    entry = dict(
        version=TABLE_VERSION,
        key=key,
        kind=kind,
        backend=backend,
        impl="cuda" if device.type == "cuda" else "plain",
        baseline=baseline_name,
        t_baseline=t_base,
        t_fused=best["seconds"],
        best=dict(tile=best["tile"], chunk=best["chunk"],
                  d_small=best["d_small"]),
        candidates=cands,
        winner="fused" if best["seconds"] < t_base else baseline_name,
        roofline=predict,
        created=time.time(),
    )
    os.makedirs(table_dir, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(entry, fh, indent=1)
    os.replace(tmp, path)
    return entry, False
