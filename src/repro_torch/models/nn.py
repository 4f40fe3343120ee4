"""Minimal module substrate on plain tensors (the JAX package's
``models/nn.py``).

Convention: a layer is a pair of plain functions —
``init(generator, ..., dtype, device) -> params`` (a nested dict of
tensors) and ``apply(params, x, ...) -> y``.  Models compose these;
parameters are nested dicts so sharding rules can match on path names.
The inits draw from the reference's distributions (uniform ±1/√d_in,
``normal · 0.02``, ones, zeros), not its values: parity carries the
reference's parameters over (:mod:`repro_torch.models.convert`).

Every init allocates on ``device``, resolved as the package resolves it
(:func:`repro_torch.device.resolve_device`: ``None`` is the GPU, and
raises without one); ``"meta"`` allocates nothing and draws nothing.

Mixed dtypes promote as ``jnp`` promotes them: a float32 input against a
bfloat16 weight computes in float32 (``torch.matmul`` itself refuses two
dtypes).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..device import resolve_device

__all__ = [
    "dense_init",
    "dense",
    "mlp_init",
    "mlp",
    "rmsnorm_init",
    "rmsnorm",
    "layernorm_init",
    "layernorm",
    "embed_init",
    "matmul",
    "silu",
    "uniform",
    "normal",
]


def uniform(gen: Optional[torch.Generator], shape, lo: float, hi: float, *,
            dtype=torch.float32, device=None) -> torch.Tensor:
    """``shape`` values uniform in ``[lo, hi)``, drawn in float32 from
    ``gen`` and cast to ``dtype``; nothing is drawn on a ``meta`` device."""
    device = resolve_device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return (u * (hi - lo) + lo).to(dtype)


def normal(gen: Optional[torch.Generator], shape, std: float, *,
           dtype=torch.float32, device=None) -> torch.Tensor:
    """``shape`` values normal with deviation ``std``, drawn in float32
    from ``gen`` and cast to ``dtype``; nothing is drawn on ``meta``."""
    device = resolve_device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (z * std).to(dtype)


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, device=None, lead=()):
    """``{"w": (d_in, d_out)[, "b": (d_out,)]}``; ``lead`` prepends stacked
    dimensions (the layers of a stack) to every tensor."""
    scale = 1.0 / math.sqrt(d_in)
    device = resolve_device(device)
    p = {"w": uniform(gen, (*lead, d_in, d_out), -scale, scale, dtype=dtype,
                      device=device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def dense(p, x):
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_init(gen, dims: Sequence[int], *, bias: bool = True,
             dtype=torch.float32, device=None):
    return {
        f"l{i}": dense_init(gen, dims[i], dims[i + 1], bias=bias, dtype=dtype,
                            device=device)
        for i in range(len(dims) - 1)
    }


class _Silu(torch.autograd.Function):
    """The forward op by op; the backward ``jax.nn.silu``'s, through the
    logistic's own derivative ``t (1 - t)``.  Autograd of the forward's
    ``exp(-x)`` would give ``inf · 0 = NaN`` where ``exp(-x)`` overflows
    (x < -88 in float32 and bfloat16); ``torch.sigmoid``'s backward does
    not, and stays differentiable for a second order."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * (1 / (1 + torch.exp(-x)))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        t = torch.sigmoid(x)
        return g * t + (g * x) * (t * (1 - t))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · 1 / (1 + exp(-x))``, each operation rounded to ``x``'s dtype as
    the reference's ``jax.nn.silu`` lowers it (``F.silu`` rounds once, and
    differs from it in a third of bfloat16 elements); its gradient is
    finite for every finite ``x``, as ``jax.nn.silu``'s is."""
    return _Silu.apply(x)


def mlp(p, x, *, act=silu, final_act=False):
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def rmsnorm_init(d: int, dtype=torch.float32, device=None, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype,
                                device=resolve_device(device))}


def rmsnorm(p, x, eps: float = 1e-6):
    """The reference's promotion: a bfloat16 ``x`` times the float32
    ``rsqrt`` is float32, times the bfloat16 scale still float32, then
    cast back to ``x``'s dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None, lead=()):
    device = resolve_device(device)
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.float32, device=None):
    return {"table": normal(gen, (vocab, d), 0.02, dtype=dtype,
                            device=device)}
