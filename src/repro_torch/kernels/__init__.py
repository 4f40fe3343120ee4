"""Hand-written GPU kernels for the compute hot spots.

``tc_fused`` — the fused short-task set-intersection kernel (CUDA C++ in
``csrc/tc_fused.cu``, built on first use by :mod:`._build`).
"""
