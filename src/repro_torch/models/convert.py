"""The carry-over of parameters exported from the JAX package.

The reference's parameters, exported as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), become the port's tree of tensors
under the same keys.  bfloat16 arrays are ``ml_dtypes.bfloat16`` numpy
arrays, which ``torch.from_numpy`` refuses; they are viewed as
``uint16`` and then as ``torch.bfloat16``, bit for bit, without importing
``ml_dtypes``.  With a device mesh the tree becomes its shards straight
away (:mod:`.sharding`), and a sharded tree goes back to one global
numpy tree (:func:`numpy_from_params`), as the reference's ``np.asarray``
gathers a sharded array.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import sharding

__all__ = ["params_from_numpy", "tensor_from_numpy", "numpy_from_params"]


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
                      dtype: Optional[torch.dtype] = None, mesh=None,
                      specs=None):
    """A nested dict of numpy arrays as the same dict of tensors on
    ``device`` (default: the CUDA device; ``"cpu"`` on request), cast to
    ``dtype`` where one is given.  With a
    :class:`~repro_torch.launch.mesh.DeviceMesh` ``mesh`` (no ``device``)
    each leaf becomes its shards under ``specs`` (a tree of spec tuples
    of the same structure, e.g. ``steps.lm_param_specs``'), each cut from
    the host array and copied to its position's device."""
    if mesh is not None:
        if device is not None or specs is None:
            raise ValueError("params_from_numpy(mesh=) takes specs= and no "
                             "device=")
        return sharding.shard_tree(
            params_from_numpy(tree, device="cpu", dtype=dtype), specs, mesh)
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return tensor_from_numpy(node, device=dev, dtype=dtype)

    return walk(tree)


def numpy_from_params(tree):
    """A tree of tensors or shards as one global tree of numpy arrays on
    the host (a bfloat16 leaf as float32, which holds it exactly)."""
    def leaf(t):
        t = sharding.unshard(t) if sharding.is_sharded(t) else t
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)

