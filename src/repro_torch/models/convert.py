"""The carry-over of parameters exported from the JAX package.

The reference's parameters, exported as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), become the port's tree of tensors
under the same keys.  bfloat16 arrays are ``ml_dtypes.bfloat16`` numpy
arrays, which ``torch.from_numpy`` refuses; they are viewed as
``uint16`` and then as ``torch.bfloat16``, bit for bit, without importing
``ml_dtypes``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a, *, device=None, dtype=None) -> torch.Tensor:
    """One array as a tensor on ``device`` (a copy: the tensor never
    aliases the caller's array); bfloat16 bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def params_from_numpy(tree, *, device=None,
                      dtype: Optional[torch.dtype] = None):
    """A nested dict of numpy arrays as the same dict of tensors on
    ``device`` (default: the CUDA device; ``"cpu"`` on request), cast to
    ``dtype`` where one is given."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return tensor_from_numpy(node, device=dev, dtype=dtype)

    return walk(tree)

