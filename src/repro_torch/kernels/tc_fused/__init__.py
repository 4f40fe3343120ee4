"""Fused device-step intersection kernel.

``tc_fused`` — gather + sorted-intersection + count for the short tasks of
a whole device-step in one hand-written CUDA kernel, tiled over the
autotuner's ``d_small``/``n_long`` maxfrag split; long rows fall back to
the chunked search paths.  A plain PyTorch version of the same function
backs the CPU.  (The measured-autotune table of the JAX package is not
carried over yet.)
"""
from .ops import count_pair_fused, fused_split_sizes, fused_tile_for  # noqa: F401
from .ref import fused_short_ref  # noqa: F401
from .tc_fused import (  # noqa: F401
    fused_short_counts,
    fused_short_counts_plain,
)
