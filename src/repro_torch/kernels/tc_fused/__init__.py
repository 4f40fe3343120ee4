"""Fused device-step intersection kernel.

``tc_fused`` — gather + sorted-intersection + count for a whole
device-step, both buckets of the autotuner's ``d_small``/``n_long``
maxfrag split, in one launch of a hand-written CUDA kernel.  Plain
PyTorch versions of the same function back the CPU.

``autotune`` — the measured table: time candidate (tile, chunk, d_small)
shapes against the baseline once per (backend, dtype, shape bucket), set
them beside the card's roofline rates, and persist the verdict so
``method="auto"`` resolves to the fused kernel only where measurement
says it wins.
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
from .autotune import (  # noqa: F401
    default_table_dir,
    measured_entry,
    measured_table_key,
    predict_fused_wins,
    roofline_predict,
)
