"""Learning-rate schedules: a step's rate as a float32 0-dim tensor, as the
JAX package's are float32 arrays.

The JAX package takes the cosine in float32 (XLA's, within one unit in the
last place); here it is taken in float64 and rounded to float32, the
correctly rounded value, so the two differ by one unit in the last place
where XLA's is not correctly rounded.
"""
import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def linear_warmup(peak, warmup_steps):
    def fn(step):
        return peak * torch.clamp(_f32((step + 1) / warmup_steps), max=1.0)

    return fn


def cosine_schedule(peak, warmup_steps, total_steps, floor=0.1):
    def fn(step):
        warm = torch.clamp(_f32((step + 1) / warmup_steps), max=1.0)
        t = torch.clamp(
            _f32(step - warmup_steps) / _f32(max(1, total_steps - warmup_steps)),
            0.0,
            1.0,
        )
        c = torch.cos((math.pi * t).double()).to(_F32)
        cos = floor + (1 - floor) * 0.5 * (1 + c)
        return peak * warm * cos

    return fn
