"""Hand-written GPU kernels for the compute hot spots.

``tc_fused`` — the fused short-task set-intersection kernel (CUDA C++ in
``csrc/tc_fused.cu``); ``tc_tile`` — the bit-packed tile intersection
kernels, popcount and tensor-core modes (``csrc/tc_tile.cu``).  Both are
built on first use by :mod:`._build`.
"""
