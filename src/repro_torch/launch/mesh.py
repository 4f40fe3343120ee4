"""Grid shapes and device meshes.

The JAX package builds device meshes of the production shapes: one pod of
16 x 16 = 256 chips with axes ``("data", "model")``, and two pods,
2 x 16 x 16 = 512 chips, with a leading ``"pod"`` axis.  A
:class:`LogicalMesh` is only such a shape and its axis names: the dry run
(:mod:`repro_torch.launch.dryrun`) sizes its cells by them, and the model
steps' sharding specs name its axes.  A :class:`DeviceMesh` adds a device
to every position, in row-major order: the counting engine then keeps each
grid position's blocks on its device and moves them between positions
with copies (:mod:`repro_torch.core.engine`).  A device may stand at
several positions (a CPU mesh in the tests, or a 4 x 4 grid on one card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["LogicalMesh", "DeviceMesh", "make_production_mesh",
           "make_mesh_for"]


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


@dataclasses.dataclass(frozen=True)
class DeviceMesh(LogicalMesh):
    """A :class:`LogicalMesh` with a ``torch.device`` at every position:
    ``devices[i]`` stands at the ``i``-th position in row-major order.
    Two meshes are equal when their shapes, axis names and devices are."""

    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        devs = tuple(torch.device(d) for d in self.devices)
        if len(devs) != self.size:
            raise ValueError(
                f"a {self.shape} mesh needs {self.size} devices, got "
                f"{len(devs)}")
        object.__setattr__(self, "devices", devs)

    def device_at(self, pos) -> torch.device:
        """The device at grid position ``pos`` (an index tuple)."""
        return self.devices[int(np.ravel_multi_index(tuple(pos), self.shape))]

    @property
    def first(self) -> torch.device:
        """The device of position ``(0, ...)``: where reductions land."""
        return self.devices[0]

    def reshaped(self, shape, axis_names) -> "DeviceMesh":
        """The same devices in the same order on another grid shape (the
        ring's ``("flat",)`` mesh over a grid's devices)."""
        return DeviceMesh(tuple(shape), tuple(axis_names), self.devices)

    def pod(self, t: int) -> "DeviceMesh":
        """Pod ``t``'s ``(q, q)`` grid of a ``(pod, row, col)`` mesh."""
        n = math.prod(self.shape[1:])
        return DeviceMesh(self.shape[1:], self.axis_names[1:],
                          self.devices[t * n:(t + 1) * n])


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def make_mesh_for(shape, axes, devices: Sequence = None) -> LogicalMesh:
    """A grid of any ``shape`` with the axis names ``axes``: a
    :class:`LogicalMesh`, or with ``devices`` (at least ``prod(shape)``
    of them; the first are used) a :class:`DeviceMesh`."""
    shape, axes = tuple(shape), tuple(axes)
    if devices is None:
        return LogicalMesh(shape, axes)
    devices = list(devices)
    n = math.prod(shape)
    if len(devices) < n:
        raise ValueError(
            f"a {shape} mesh needs {n} devices, have {len(devices)}")
    return DeviceMesh(shape, axes, tuple(devices[:n]))
