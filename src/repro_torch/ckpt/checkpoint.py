"""Atomic checkpoint save/restore of nested trees of tensors.

The on-disk format is the JAX package's: one ``step_{step:010d}.npz``
payload whose entries are the tree's leaves keyed by their path (``a/b/0``
stored as ``a__b__0``), and a ``step_{step:010d}.json`` manifest with
``step``, ``payload``, ``sha256`` (of the payload's bytes), ``keys`` and
``extra``; both written atomically (``mkstemp`` + ``fsync`` +
``os.replace``).  A checkpoint written by either package loads in the
other.

A tree is a nest of dicts, lists and tuples whose leaves are tensors or
numpy arrays.  The port flattens it itself, in the order the JAX package's
``tree_util`` does (dict keys sorted, sequences by index; ``None`` holds
no leaf).  A restored leaf goes to the device of its ``like`` tensor, with
the payload's dtype.

A leaf may be a :class:`~repro_torch.core.engine.MeshArray`: it is saved
as its global array, every position's block stacked in the mesh's
row-major order under the mesh's shape, which is the stacked tensor the
one-device engine holds for the same state.  So a checkpoint is the same
bytes whether its state was on one device or on a mesh, and either loads
into the other: a ``MeshArray`` ``like`` leaf restores each position's
block onto its device, a tensor ``like`` the whole array onto its
device.  ``load_checkpoint(..., mesh=, specs=)`` places leaves on a mesh
as the JAX package's re-sharding restore does, ``specs`` naming the mesh
axes each leaf's leading dimensions are split over
(:func:`~repro_torch.pipeline.artifact.mesh_layout`'s specs).

bfloat16 has no numpy dtype without ``ml_dtypes``.  The JAX package's
``np.asarray`` of a bfloat16 leaf writes it as a raw two-byte void
(``|V2``) entry; the port writes the tensor's bits as the same entry, and
restores a ``|V2`` entry as a bfloat16 tensor where the ``like`` leaf is
one (bit for bit), and raises ``TypeError`` elsewhere.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
    "quarantine_step",
]


def _leaf_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs of ``tree`` in ``tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    return [pair for k, sub in items
            for pair in _leaf_paths(sub, prefix + (k,))]


def _flatten(tree) -> List[Tuple[str, Any]]:
    """``(path key, leaf)`` pairs of ``tree`` in ``tree_util`` order."""
    return [("/".join(str(p) for p in path), leaf)
            for path, leaf in _leaf_paths(tree)]


def _unflatten(like, leaves: Dict[str, Any], prefix: Tuple = ()):
    """``like``'s structure with each leaf replaced by ``leaves[path]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, prefix + (k,)) for k in like}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, prefix + (i,)) for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, list) else tuple(out)
    return leaves["/".join(str(p) for p in prefix)]


_BF16_ENTRY = np.dtype("V2")  # how a bfloat16 leaf lies in the payload


def _is_mesh_array(leaf) -> bool:
    from ..core.engine import MeshArray

    return isinstance(leaf, MeshArray)


def host_array(leaf, *, copy: bool = False) -> np.ndarray:
    """``leaf`` as the array the payload holds: a tensor's host array (a
    bfloat16 tensor's bits as a ``|V2`` array, as the JAX package writes
    it), a copy that shares no memory with the tensor where ``copy``.  A
    mesh array's is its global array: the blocks, each copied to the
    host, stacked in row-major position order under the mesh's shape; a
    model's sharded tensor (``models.sharding.ShardedTensor``) its global
    tensor, the one-device bytes."""
    from ..models import sharding

    if sharding.is_sharded(leaf):
        return host_array(sharding.unshard(leaf), copy=copy)
    if _is_mesh_array(leaf):
        shape = tuple(leaf.mesh.shape)
        blocks = [host_array(leaf.blocks[pos], copy=True)
                  for pos in np.ndindex(*shape)]
        return np.stack(blocks).reshape(shape + blocks[0].shape)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(_BF16_ENTRY)
        return t.numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _restored(key: str, arr: np.ndarray, like, mesh=None, spec=None):
    """The payload's ``arr`` at ``key`` as ``like``'s kind of leaf: with a
    mesh (``mesh``, else a mesh array ``like``'s) split over its axes
    ``spec`` (``None``: all of them, in order), each position's block on
    its device.  A sharded-tensor ``like`` restores as the same shards of
    the payload's global array (its dtype, bfloat16 included, checked as
    for a tensor)."""
    from ..models import sharding

    if sharding.is_sharded(like):
        glob = _restored(key, arr, torch.empty((), dtype=like.dtype))
        if tuple(glob.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint entry {key!r} is "
                             f"{tuple(glob.shape)}, the sharded leaf "
                             f"{tuple(like.shape)}")
        return sharding.shard_tensor(glob, like.spec, like.mesh)
    if mesh is None and _is_mesh_array(like):
        mesh = like.mesh
    if mesh is not None:
        from ..pipeline.artifact import stage_on_mesh

        if arr.dtype == _BF16_ENTRY:
            raise TypeError(f"checkpoint entry {key!r} holds bfloat16 bits "
                            "(|V2), which are not restored onto a mesh")
        return stage_on_mesh(arr, mesh, spec)
    if arr.dtype == _BF16_ENTRY:
        if not (isinstance(like, torch.Tensor)
                and like.dtype == torch.bfloat16):
            got = like.dtype if hasattr(like, "dtype") else type(like)
            raise TypeError(
                f"checkpoint entry {key!r} holds bfloat16 bits (|V2), which "
                f"restore only into a bfloat16 tensor, not {got}")
        # ascontiguousarray makes a 0-d array 1-d: reshape it back
        bits = np.ascontiguousarray(arr).view(np.int16).reshape(arr.shape)
        bits = torch.from_numpy(bits)
        return bits.view(torch.bfloat16).to(like.device)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    return arr


def save_checkpoint(directory: str, step: int, tree, *,
                    extra: Optional[dict] = None) -> str:
    """Atomically save a tree: npz payload + manifest with its sha256.
    Returns the manifest's path."""
    os.makedirs(directory, exist_ok=True)
    flat = {k: host_array(v) for k, v in _flatten(tree)}
    payload_name = f"step_{step:010d}.npz"
    manifest_name = f"step_{step:010d}.json"

    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **{k.replace("/", "__"): v for k, v in flat.items()})
        f.flush()
        os.fsync(f.fileno())
    with open(tmp, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    os.replace(tmp, os.path.join(directory, payload_name))

    manifest = {
        "step": step,
        "payload": payload_name,
        "sha256": digest,
        "keys": sorted(flat.keys()),
        "extra": extra or {},
    }
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, manifest_name))
    return os.path.join(directory, manifest_name)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(f[len("step_"):-len(".json")])
        for f in os.listdir(directory)
        if f.startswith("step_") and f.endswith(".json")
    ]
    return max(steps) if steps else None


def quarantine_step(directory: str, step: int) -> list:
    """Rename a damaged step's files to ``*.corrupt`` so it stops being
    the latest checkpoint (``latest_step`` matches the ``.json`` suffix)
    while keeping the bytes on disk for post-mortems.  Returns the
    quarantined paths."""
    moved = []
    for suffix in (".json", ".npz"):
        p = os.path.join(directory, f"step_{step:010d}{suffix}")
        if os.path.exists(p):
            os.replace(p, p + ".corrupt")
            moved.append(p + ".corrupt")
    return moved


def _spec_at(specs, path: Tuple):
    """The spec of the leaf at ``path`` in a specs tree: ``specs``
    followed down ``path`` until a node that is a spec (``None`` or a tuple
    of axis names), which then holds for the whole subtree."""
    node = specs
    for part in path:
        if node is None or (isinstance(node, tuple)
                            and all(isinstance(a, str) for a in node)):
            break
        node = node[part]
    return node


def load_checkpoint(directory: str, step: int, like, *, mesh=None,
                    specs=None, verify: bool = True):
    """Restore a tree saved by :func:`save_checkpoint`; returns
    ``(tree, extra)``.

    ``like`` gives the structure: the result has its nesting, and each
    leaf is the payload's array at that path — a tensor on the device of
    ``like``'s leaf where that is a tensor, else a numpy array — in the
    payload's dtype (an int64 accumulator stays int64, int32 keys stay
    int32); a ``|V2`` entry (bfloat16 bits) restores into a bfloat16
    ``like`` tensor only, and raises ``TypeError`` elsewhere.  A mesh
    array ``like`` leaf restores as a mesh array on its mesh.  With
    ``mesh`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`) every leaf
    is placed on it, split over the mesh axes ``specs`` names for it
    (``specs`` has ``like``'s structure, or a prefix of it, with a tuple
    of axis names or ``None`` — every axis, in order — at each leaf),
    as the JAX package's ``mesh=``/``specs=`` re-shard.  A path ``like``
    has and the payload lacks raises ``KeyError``; ``verify`` checks the
    payload's sha256 first and raises ``IOError`` on a mismatch.
    """
    with open(os.path.join(directory, f"step_{step:010d}.json")) as f:
        manifest = json.load(f)
    path = os.path.join(directory, manifest["payload"])
    if verify:
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != manifest["sha256"]:
            raise IOError(
                f"checkpoint corruption detected: {path} sha mismatch"
            )
    out = {}
    with np.load(path) as data:
        for path_, leaf in _leaf_paths(like):
            key = "/".join(str(p) for p in path_)
            out[key] = _restored(
                key, data[key.replace("/", "__")], leaf, mesh,
                None if mesh is None else _spec_at(specs, path_))
    return _unflatten(like, out), manifest["extra"]
