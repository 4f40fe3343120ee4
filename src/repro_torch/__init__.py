"""PyTorch/CUDA port of the 2D parallel triangle-counting system.

The JAX package ``repro`` beside this one is the reference; this package
imports ``torch`` and ``numpy`` only and mirrors the reference's layout
(``core/``, ``pipeline/``, ``kernels/tc_fused/``, ``launch/``) so the
counterpart of a module is found by path.  Entry points run on the GPU
unless the caller passes ``device="cpu"`` (:mod:`repro_torch.device`).
"""
from .core import (  # noqa: F401
    Graph,
    TCResult,
    available_schedules,
    count_triangles,
    count_triangles_delta,
    count_triangles_many,
    graph_from_spec,
    make_grid_mesh,
    named_graph,
    rmat,
    triangle_count_oracle,
)
from .device import resolve_device  # noqa: F401
