"""The card's roofline constants, from the data sheet and as measured.

``HW`` holds the published rates of the card the port targets, an NVIDIA
H100 SXM (NVIDIA's H100 data sheet, dense rates without sparsity, at the
full 700 W power limit).  A least-time bound is the larger of the bytes a
function must move over ``hbm_bw`` and the operations it does over the
peak rate of their type.  :func:`measure_hw` times what one card reaches
in practice — a device-to-device copy and a bf16 matrix product — so a
bound can be read against both.

The JAX package reads the bytes its collectives move from the compiled
XLA program (``collective_phases`` over the HLO's named scopes).  The
port has no compiled program to read: it counts its bytes where it moves
them (:func:`repro_torch.core.engine.tally_moved_bytes`), and
:func:`collective_phases` reads that tally over one call of an engine
function.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["HW", "measure_hw", "collective_phases"]

HW = dict(
    # H100 SXM, device memory (HBM3): 3.35 TB/s (data sheet)
    hbm_bw=3.35e12,
    # H100 SXM, bf16 dense tensor-core peak: 989 TFLOP/s (data sheet)
    peak_flops=989e12,
    # H100 SXM, 32-bit rate outside the tensor cores: 67 TFLOP/s (data
    # sheet, fp32); the bound of 32-bit integer compares and searches
    fp32_ops=67e12,
)

_COPY_BYTES = 1 << 30  # a 1 GiB device-to-device copy
_MATMUL_N = 8192  # a bf16 8192 x 8192 x 8192 product
_REPS = 5


def _best_seconds(fn, reps: int = _REPS) -> float:
    """Least device seconds of ``fn()`` over ``reps`` runs after one
    warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) * 1e-3)
    return best


def measure_hw(device=None) -> dict:
    """Time the card's memory and bf16 rates on ``device`` (a CUDA
    device; default the current one).

    ``hbm_bw``: a copy of a 1 GiB buffer into another, counted as the
    bytes read plus the bytes written, over the least of 5 timed copies.
    ``peak_flops``: a bf16 ``torch.matmul`` of two 8192 x 8192 matrices,
    ``2 * 8192**3`` FLOP over the least of 5 timed products.  Refuses a
    device that is not a CUDA device: no rate of the card is measured
    anywhere else.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"measure_hw times a CUDA device, got {device}")
    with torch.cuda.device(device):
        src = torch.empty(_COPY_BYTES, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        copy_s = _best_seconds(lambda: dst.copy_(src))
        del src, dst
        n = _MATMUL_N
        gen = torch.Generator(device=device).manual_seed(0)
        a = torch.randn(n, n, device=device, dtype=torch.bfloat16,
                        generator=gen)
        b = torch.randn(n, n, device=device, dtype=torch.bfloat16,
                        generator=gen)
        mm_s = _best_seconds(lambda: torch.matmul(a, b))
        del a, b
    return dict(
        device_name=torch.cuda.get_device_name(device),
        hbm_bw=2 * _COPY_BYTES / copy_s,
        copy_bytes=_COPY_BYTES,
        copy_seconds=copy_s,
        peak_flops=2.0 * n**3 / mm_s,
        matmul_n=n,
        matmul_seconds=mm_s,
        reps=_REPS,
        datasheet=dict(HW),
    )


def collective_phases(fn, arrays) -> Dict[str, int]:
    """Bytes one call ``fn(**arrays)`` of an engine function moves, by
    engine phase: always the four keys ``shift`` (every tensor a shift
    rolls), ``broadcast`` (0: a SUMMA panel broadcast is a view),
    ``reduce`` (the partials the final sum reads) and ``other`` (the
    blobs packed before the count).  Each is the whole logical grid's
    bytes on the one card that holds it; the JAX package charges a
    permute ``size * npairs / ndev``, one device's share."""
    from ..core.engine import tally_moved_bytes

    with tally_moved_bytes() as moved:
        fn(**arrays)
    return dict(moved)
