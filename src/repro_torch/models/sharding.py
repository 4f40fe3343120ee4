"""Shards and collectives on a device mesh, for the model steps.

The JAX package lays every parameter, optimiser state, batch and cache
out over a device mesh with ``PartitionSpec``s and lets GSPMD insert the
collectives.  The port holds the same layout by hand: a
:class:`ShardedTensor` is one global tensor as the per-position shards of
a spec tuple (the ones :func:`repro_torch.models.steps.lm_param_specs`,
``_opt_specs`` and ``cache_specs`` return: an axis name, a tuple of them,
or ``None`` for a replicated dimension; a missing tail is replicated) on a
:class:`~repro_torch.launch.mesh.DeviceMesh`.  A dimension that its axes
do not divide is cut into ceil-sized chunks, the last one shorter (and
any past the end empty), so position ``(0, ...)`` holds
``launch.roofline.shard_bytes`` of it.

One host thread drives every position, as in the counting engine
(:mod:`repro_torch.core.engine`): a position's tensors live on its device,
and the model code runs in lockstep over lists with one tensor a position
(row-major order).  The collectives along named axes —
:func:`all_gather`, :func:`reduce_scatter`, :func:`psum`, :func:`pmax`,
and the two halves of a tensor-parallel region, :func:`replicate`
(identity forward, psum backward) and :func:`split` (the position's chunk
of a replicated value forward, all-gather backward) — are
``torch.autograd.Function``\\ s whose backward is the dual collective,
given by hand: all-gather ↔ reduce-scatter, psum ↔ identity, and
:func:`all_reduce` (a sum that each member goes on to use in its own
way) ↔ itself.  The backwards are made of differentiable ops (copies,
slices, sums) or of the dual Function's ``apply``, so a graph built
under ``create_graph`` (NequIP's forces) is differentiated again through
them.  :func:`psum`'s identity backward holds where every member uses
the sum alike (a loss, a replicated energy): each member's cotangent is
then the one value's.  Every
crossing between positions is an explicit copy (``_send``), counted in
bytes under ``"<collective>:<what>"`` by :func:`tally_collective_bytes`;
a group of one position moves nothing.  A psum sums on the group's first
position, in position order, and sends the sum back, so every member
holds the same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "ShardedTensor",
    "MeshLayout",
    "layout",
    "chunk",
    "shard_tensor",
    "shard_tree",
    "unshard",
    "unshard_tree",
    "zeros_like_specs",
    "all_gather",
    "reduce_scatter",
    "psum",
    "all_reduce",
    "pmax",
    "replicate",
    "split",
    "tally_collective_bytes",
    "is_sharded",
]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def chunk(n: int, parts: int, i: int) -> Tuple[int, int]:
    """``[lo, hi)`` of chunk ``i`` when ``n`` is cut into ``parts``
    ceil-sized chunks (the last shorter, any past the end empty)."""
    c = -(-n // parts) if parts else n
    return min(i * c, n), min((i + 1) * c, n)


class MeshLayout:
    """A :class:`DeviceMesh`'s positions: coordinates, groups along axes
    and each position's index within its group."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = tuple(mesh.shape)
        self.names = tuple(mesh.axis_names)
        self.devices = tuple(mesh.devices)
        self.n = len(self.devices)
        self.coords = [tuple(int(c) for c in np.unravel_index(p, self.shape))
                       for p in range(self.n)]

    def size(self, axes) -> int:
        return math.prod(self.shape[self._dim(a)] for a in _axes(axes))

    def _dim(self, a: str) -> int:
        if a not in self.names:
            raise ValueError(f"mesh axes {self.names} have no {a!r}")
        return self.names.index(a)

    def index(self, p: int, axes) -> int:
        """Position ``p``'s row-major index along ``axes`` (in the order
        given: ``("pod", "data")`` is pod-major)."""
        i = 0
        for a in _axes(axes):
            d = self._dim(a)
            i = i * self.shape[d] + self.coords[p][d]
        return i

    @functools.lru_cache(maxsize=None)
    def groups(self, axes) -> Tuple[Tuple[int, ...], ...]:
        """The positions that differ only along ``axes``, grouped, each
        group in index order along ``axes``."""
        dims = [self._dim(a) for a in _axes(axes)]
        out = {}
        for p, c in enumerate(self.coords):
            key = tuple(x for d, x in enumerate(c) if d not in dims)
            out.setdefault(key, []).append(p)
        return tuple(tuple(sorted(g, key=lambda p: self.index(p, axes)))
                     for g in out.values())

    def owners(self, spec, ndim: int) -> List[int]:
        """The positions at index 0 along every axis ``spec`` does not
        name: each distinct shard once."""
        named = {a for e in _full_spec(spec, ndim) for a in _axes(e)}
        rest = [self._dim(a) for a in self.names if a not in named]
        return [p for p, c in enumerate(self.coords)
                if all(c[d] == 0 for d in rest)]

    def slices(self, p: int, spec, shape) -> Tuple[slice, ...]:
        """Position ``p``'s slice of a global tensor of ``shape``."""
        out = []
        for n, e in zip(shape, _full_spec(spec, len(shape))):
            lo, hi = chunk(n, self.size(e), self.index(p, e))
            out.append(slice(lo, hi))
        return tuple(out)


@functools.lru_cache(maxsize=None)
def _layout_of(mesh) -> MeshLayout:
    return MeshLayout(mesh)


def layout(mesh) -> MeshLayout:
    """The (memoised) :class:`MeshLayout` of a :class:`DeviceMesh`."""
    return _layout_of(mesh)


def _full_spec(spec, ndim: int) -> Tuple:
    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} names {len(spec)} dimensions of a "
                         f"{ndim}-dimensional tensor")
    return spec + (None,) * (ndim - len(spec))


@dataclasses.dataclass
class ShardedTensor:
    """A global tensor of ``shape`` as ``shards[p]``, position ``p``'s
    chunk under ``spec`` on ``mesh.devices[p]``."""

    shards: List[torch.Tensor]
    spec: Tuple
    shape: Tuple[int, ...]
    mesh: Any

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def with_shards(self, shards) -> "ShardedTensor":
        return ShardedTensor(list(shards), self.spec, self.shape, self.mesh)


def is_sharded(x) -> bool:
    return isinstance(x, ShardedTensor)


def shard_tensor(t: torch.Tensor, spec, mesh) -> ShardedTensor:
    """Each position's chunk of ``t`` under ``spec``, copied onto its
    device (a position never aliases ``t`` or another position)."""
    lay = layout(mesh)
    spec = _full_spec(spec, t.dim())
    for e in spec:
        for a in _axes(e):
            lay._dim(a)
    shards = [t[lay.slices(p, spec, t.shape)].to(lay.devices[p], copy=True)
              .contiguous() for p in range(lay.n)]
    return ShardedTensor(shards, spec, tuple(t.shape), mesh)


def _walk2(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _walk2(v, specs[k], fn) for k, v in tree.items()}
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """A tree of global tensors as the same tree of
    :class:`ShardedTensor` under ``specs`` (a tree of the same structure
    whose leaves are spec tuples)."""
    return _walk2(tree, specs, lambda t, s: shard_tensor(t, s, mesh))


def unshard(st: ShardedTensor, device="cpu") -> torch.Tensor:
    """The global tensor of ``st`` on ``device``: each distinct shard
    copied into its place once."""
    lay = layout(st.mesh)
    out = torch.empty(st.shape, dtype=st.dtype, device=device)
    for p in lay.owners(st.spec, st.ndim):
        out[lay.slices(p, st.spec, st.shape)] = st.shards[p].to(device)
    return out


def unshard_tree(tree, device="cpu"):
    """A tree with :class:`ShardedTensor` leaves as global tensors on
    ``device``; other leaves are kept."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v, device) for k, v in tree.items()}
    return unshard(tree, device) if is_sharded(tree) else tree


def zeros_like_specs(meta_tree, specs, mesh, dtype=None):
    """Zeros of every leaf of ``meta_tree`` (shapes and dtypes, e.g. meta
    tensors) as shards under ``specs``, allocated shard by shard."""
    lay = layout(mesh)

    def leaf(t, spec):
        spec = _full_spec(spec, t.dim())
        shards = []
        for p in range(lay.n):
            sl = lay.slices(p, spec, t.shape)
            shape = tuple(s.stop - s.start for s in sl)
            shards.append(torch.zeros(shape, dtype=dtype or t.dtype,
                                      device=lay.devices[p]))
        return ShardedTensor(shards, spec, tuple(t.shape), mesh)

    return _walk2(meta_tree, specs, leaf)


# ----------------------------------------------------------------------
# the byte tally
# ----------------------------------------------------------------------
_TALLIES: List[dict] = []  # the open tallies, innermost last
_TALLY_LOCK = threading.Lock()


@contextlib.contextmanager
def tally_collective_bytes():
    """Count the bytes the collectives copy between positions while the
    block runs: a dict ``"<collective>:<what>" -> bytes`` (``what`` is the
    caller's tag: ``params``, ``grads``, ``act``, ...).  A copy is counted
    once, as ``numel * element_size`` of the tensor received.  The tally
    is the process's, not the thread's: on a CUDA device autograd runs the
    backward — the gradients' reduce-scatters, a remat layer's second
    gather — on a thread of its own, and those copies count too.  The
    counting engine's tally (``core.engine.tally_moved_bytes``) is a
    separate one and sees none of these."""
    tally = {}
    with _TALLY_LOCK:
        _TALLIES.append(tally)
    try:
        yield tally
    finally:
        with _TALLY_LOCK:
            _TALLIES.remove(tally)


def _send(x: torch.Tensor, device, key: str) -> torch.Tensor:
    """A copy of ``x`` received on ``device``: one crossing of positions,
    tallied under ``key`` in every open tally."""
    buf = torch.empty_like(x, device=device,
                           memory_format=torch.contiguous_format)
    buf.copy_(x)
    if _TALLIES:
        n = buf.numel() * buf.element_size()
        with _TALLY_LOCK:
            for tally in _TALLIES:
                tally[key] = tally.get(key, 0) + n
    return buf


def _trivial(lay: MeshLayout, axes) -> bool:
    return lay.size(axes) == 1


# ----------------------------------------------------------------------
# the collectives' bodies (no autograd)
# ----------------------------------------------------------------------
def _gather_impl(lay, axes, dim, xs, key):
    out = [None] * lay.n
    for g in lay.groups(axes):
        for m in g:
            dev = lay.devices[m]
            parts = [xs[j] if j == m else _send(xs[j], dev, key) for j in g]
            out[m] = torch.cat(parts, dim)
    return out


def _reduce_scatter_impl(lay, axes, dim, xs, key, sizes=None):
    """Member ``i`` of each group gets chunk ``i`` (of ``sizes``, or the
    ceil chunks) of the group's sum, summed in position order."""
    out = [None] * lay.n
    for g in lay.groups(axes):
        n = xs[g[0]].shape[dim]
        bounds, lo = [], 0
        for i in range(len(g)):
            if sizes is None:
                bounds.append(chunk(n, len(g), i))
            else:
                bounds.append((lo, lo + sizes[g[i]]))
                lo += sizes[g[i]]
        for i, m in enumerate(g):
            a, b = bounds[i]
            dev = lay.devices[m]
            acc = None
            for j in g:
                part = xs[j].narrow(dim, a, b - a)
                part = part if j == m else _send(part, dev, key)
                acc = part if acc is None else acc + part
            out[m] = acc
    return out


def _psum_impl(lay, axes, xs, key):
    out = [None] * lay.n
    for g in lay.groups(axes):
        root = g[0]
        dev = lay.devices[root]
        acc = xs[root]
        for j in g[1:]:
            acc = acc + _send(xs[j], dev, key)
        out[root] = acc
        for j in g[1:]:
            out[j] = _send(acc, lay.devices[j], key)
    return out


def _zeros_for(gs, like):
    """``gs`` with every missing gradient zeros of ``like``'s (shape,
    dtype, device)."""
    return [g if g is not None else torch.zeros(sh, dtype=dt, device=dev)
            for g, (sh, dt, dev) in zip(gs, like)]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, axes, dim, tag, *xs):
        ctx.meta = (lay, axes, dim, tag, [x.shape[dim] for x in xs])
        ctx.shapes = [x.shape for x in xs]
        return tuple(_gather_impl(lay, axes, dim, xs, f"all_gather:{tag}"))

    @staticmethod
    def backward(ctx, *gs):
        lay, axes, dim, tag, sizes = ctx.meta
        gs = [g if g is not None else torch.zeros(
            _gathered_shape(ctx.shapes, lay, axes, dim, p),
            dtype=_first(gs).dtype, device=lay.devices[p])
            for p, g in enumerate(gs)]
        out = _reduce_scatter(lay, axes, dim, gs, f"reduce_scatter:{tag}",
                              sizes)
        return (None, None, None, None, *out)


def _first(gs):
    return next(g for g in gs if g is not None)


def _gathered_shape(shapes, lay, axes, dim, p):
    g = next(g for g in lay.groups(axes) if p in g)
    shape = list(shapes[p])
    shape[dim] = sum(shapes[j][dim] for j in g)
    return shape


def _reduce_scatter(lay, axes, dim, xs, key, sizes=None):
    """The reduce-scatter that an all-gather's backward runs; a module
    function so a check can plant a fault in it."""
    return _reduce_scatter_impl(lay, axes, dim, xs, key, sizes)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, axes, dim, tag, sizes, *xs):
        out = _reduce_scatter_impl(lay, axes, dim, xs,
                                   f"reduce_scatter:{tag}", sizes)
        ctx.meta = (lay, axes, dim, tag)
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        lay, axes, dim, tag = ctx.meta
        return (None, None, None, None, None,
                *_gather_impl(lay, axes, dim, gs, f"all_gather:{tag}"))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, axes, tag, *xs):
        return tuple(_psum_impl(lay, axes, xs, f"psum:{tag}"))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *gs)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, axes, tag, *xs):
        ctx.meta = (lay, axes, tag)
        return tuple(_psum_impl(lay, axes, xs, f"psum:{tag}"))

    @staticmethod
    def backward(ctx, *gs):
        lay, axes, tag = ctx.meta
        gs = [g if g is not None else torch.zeros_like(_first(gs),
                                                       device=lay.devices[p])
              for p, g in enumerate(gs)]
        return (None, None, None,
                *_AllReduce.apply(lay, axes, f"{tag}-grad", *gs))


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, axes, tag, *xs):
        ctx.meta = (lay, axes, tag)
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        lay, axes, tag = ctx.meta
        gs = _zeros_for(gs, ctx.like)
        return (None, None, None,
                *_psum_impl(lay, axes, gs, f"psum:{tag}-grad"))


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, axes, dim, tag, *xs):
        out = []
        for p, x in enumerate(xs):
            lo, hi = chunk(x.shape[dim], lay.size(axes), lay.index(p, axes))
            out.append(x.narrow(dim, lo, hi - lo).contiguous())
        ctx.meta = (lay, axes, dim, tag, [x.shape for x in xs])
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        lay, axes, dim, tag, shapes = ctx.meta
        gs = [g if g is not None else torch.zeros(
            _chunk_shape(shapes[p], lay, axes, dim, p), device=lay.devices[p],
            dtype=_first(gs).dtype) for p, g in enumerate(gs)]
        return (None, None, None, None,
                *_gather_impl(lay, axes, dim, gs, f"all_gather:{tag}-grad"))


def _chunk_shape(shape, lay, axes, dim, p):
    shape = list(shape)
    lo, hi = chunk(shape[dim], lay.size(axes), lay.index(p, axes))
    shape[dim] = hi - lo
    return shape


# ----------------------------------------------------------------------
# the collectives
# ----------------------------------------------------------------------
def _norm_axes(lay, axes) -> Tuple[str, ...]:
    return tuple(a for a in _axes(axes) if a in lay.names)


def all_gather(xs: Sequence[torch.Tensor], mesh, axes, dim: int,
               tag: str = "act") -> List[torch.Tensor]:
    """Each position's shard concatenated with its group's along ``dim``
    (the group's order along ``axes``); backward: reduce-scatter."""
    lay = layout(mesh)
    axes = _norm_axes(lay, axes)
    if _trivial(lay, axes):
        return list(xs)
    return list(_AllGather.apply(lay, axes, dim % xs[0].dim(), tag, *xs))


def reduce_scatter(xs, mesh, axes, dim: int, tag: str = "act", sizes=None):
    """The group's sum, cut into ceil chunks along ``dim`` (or chunks of
    ``sizes[p]`` for position ``p``, in the group's order): member ``i``
    keeps chunk ``i``; backward: all-gather."""
    lay = layout(mesh)
    axes = _norm_axes(lay, axes)
    if _trivial(lay, axes):
        return list(xs)
    sizes = None if sizes is None else tuple(sizes)
    return list(_ReduceScatter.apply(lay, axes, dim % xs[0].dim(), tag,
                                     sizes, *xs))


def psum(xs, mesh, axes, tag: str = "act"):
    """The group's sum on every member; backward: identity."""
    lay = layout(mesh)
    axes = _norm_axes(lay, axes)
    if _trivial(lay, axes):
        return list(xs)
    return list(_Psum.apply(lay, axes, tag, *xs))


def all_reduce(xs, mesh, axes, tag: str = "act"):
    """The group's sum on every member, where each member goes on to use
    it in its own way (a softmax's denominators over each member's own
    edges); backward: the sum of the members' cotangents (itself)."""
    lay = layout(mesh)
    axes = _norm_axes(lay, axes)
    if _trivial(lay, axes):
        return list(xs)
    return list(_AllReduce.apply(lay, axes, tag, *xs))


def pmax(xs, mesh, axes, tag: str = "act"):
    """The group's elementwise maximum on every member (no gradient:
    every use in the models is a softmax's shift — the vocabulary CE,
    the decode combine, the segment softmax — whose gradient the softmax
    cancels)."""
    lay = layout(mesh)
    axes = _norm_axes(lay, axes)
    xs = [x.detach() for x in xs]
    if _trivial(lay, axes):
        return xs
    out = [None] * lay.n
    key = f"pmax:{tag}"
    for g in lay.groups(axes):
        root = g[0]
        acc = xs[root]
        for j in g[1:]:
            acc = torch.maximum(acc, _send(xs[j], lay.devices[root], key))
        out[root] = acc
        for j in g[1:]:
            out[j] = _send(acc, lay.devices[j], key)
    return out


def replicate(xs, mesh, axes, tag: str = "act"):
    """A value replicated over ``axes`` entering a computation that each
    member does a part of: identity forward, psum of the members' partial
    gradients backward."""
    lay = layout(mesh)
    axes = _norm_axes(lay, axes)
    if _trivial(lay, axes):
        return list(xs)
    return list(_Replicate.apply(lay, axes, tag, *xs))


def split(xs, mesh, axes, dim: int, tag: str = "act"):
    """Each member's ceil chunk along ``dim`` of a value replicated over
    ``axes``; backward: all-gather (every member gets the whole
    gradient)."""
    lay = layout(mesh)
    axes = _norm_axes(lay, axes)
    if _trivial(lay, axes):
        return list(xs)
    return list(_Split.apply(lay, axes, dim % xs[0].dim(), tag, *xs))
