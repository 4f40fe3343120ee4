"""Production grid shapes, as logical grids on one card.

The JAX package builds device meshes of the production shapes: one pod of
16 x 16 = 256 chips with axes ``("data", "model")``, and two pods,
2 x 16 x 16 = 512 chips, with a leading ``"pod"`` axis.  The port holds a
whole grid as the leading dimensions of its tensors on one card, so a
"mesh" here is only a shape and its axis names: the dry run
(:mod:`repro_torch.launch.dryrun`) sizes its cells by them, and the
model steps' sharding specs name its axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

__all__ = ["LogicalMesh", "make_production_mesh", "make_mesh_for"]


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """A grid shape and its axis names; ``size`` logical devices."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(
                f"mesh shape {self.shape} and axis names "
                f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def make_mesh_for(shape, axes) -> LogicalMesh:
    """A logical grid of any ``shape`` with the axis names ``axes``."""
    return LogicalMesh(tuple(shape), tuple(axes))
