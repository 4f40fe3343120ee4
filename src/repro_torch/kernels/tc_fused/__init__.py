"""Fused device-step intersection kernel.

``tc_fused`` — gather + sorted-intersection + count for a whole
device-step, both buckets of the autotuner's ``d_small``/``n_long``
maxfrag split, in one launch of a hand-written CUDA kernel.  Plain
PyTorch versions of the same function back the CPU.  (The
measured-autotune table of the JAX package is not carried over yet.)
"""
from .ops import (  # noqa: F401
    count_pair_fused,
    count_pair_fused_plain,
    fused_split_sizes,
    fused_tile_for,
)
from .ref import fused_short_ref  # noqa: F401
from .tc_fused import (  # noqa: F401
    STAGE_LIMIT,
    fused_short_counts,
    fused_short_counts_plain,
    fused_step_counts,
    fused_step_counts_plain,
)
