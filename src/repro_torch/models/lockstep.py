"""One model body for one device and for a device mesh.

The GNN and recsys bodies (``models/gnn/``, :mod:`.dlrm` and the losses
of :mod:`.gnn_steps`) are generators.  Where a body needs what other
positions of a mesh hold, it yields a request and goes on with the
answer:

* :class:`Gather` — a node array's rows for the edges (each position
  holds a ceil chunk of the nodes and of the edges, edge ids global);
* :class:`ScatterSum` — edge messages summed into the nodes, back in the
  node shards;
* :class:`SegmentSoftmax` — a softmax over each node's incoming edges;
* :class:`Psum` — a sum over the positions that every position goes on
  to use alike (a graph's energy; ``Psum(torch.sum(x))``, the sum of a
  row-sharded array);
* :class:`Mean` — over every element of a row-sharded array (the
  losses);
* :class:`Rows` — a row-sharded array's global row count;
* :class:`Grad` — a gradient through every position (NequIP's forces);
* :class:`Bag` / :class:`TableRows` — lookups in a row-sharded table;
* :class:`TopK` — the top k of row-sharded scores, ties to the lower
  global index.

``yield from`` composes bodies (:func:`call` also takes a plain function:
a body without a crossing).

:func:`run_one` drives one generator on one device: every request is
answered by the op the body ran before it had a mesh (``segment_sum``,
``torch.mean``, ``embedding_bag``, a stable sort, ...) and a crossing is
an identity, so one device runs the same ops in the same order.
:func:`run` drives one generator a position of a :class:`MeshRun` in
lockstep on the one host thread: each is advanced to its next request,
the requests must be of one kind, and the kind's ``mesh`` answer runs
over every position's tensors with the collectives of :mod:`.sharding`
(every crossing an explicit copy, tallied).  This is the combine GSPMD
inserts in the reference, written out: gathers are all-gathers (backward
reduce-scatter), scatters reduce-scatters (backward all-gather), the
softmax a ``pmax`` of the local maxima and an :func:`~.sharding.
all_reduce` of the local denominators, the table lookups a ``psum`` of
each shard's part.  A generator's grad mode is its own across the
others' turns (a ``with torch.enable_grad()`` spans a request).
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from ..sparse.embedding_bag import (check_ids, embedding_bag,
                                    embedding_bag_shard, table_rows_shard)
from ..sparse.segment import (segment_max, segment_softmax, segment_sum,
                              softmax_normalise, softmax_numerator)
from . import sharding

__all__ = [
    "MeshRun",
    "run",
    "run_one",
    "body",
    "call",
    "Gather",
    "ScatterSum",
    "SegmentSoftmax",
    "Psum",
    "Mean",
    "Rows",
    "Grad",
    "Bag",
    "TableRows",
    "TopK",
]


class MeshRun:
    """A :class:`~repro_torch.launch.mesh.DeviceMesh`, the axes its data
    rows are sharded over (``rows``: every axis for a GNN's nodes and
    edges, ``(pod, data)`` for a recsys batch) and, for a lookup, the
    embedding table's spec and row count."""

    def __init__(self, mesh, rows: Sequence[str], *, table_spec=None,
                 table_rows: int = 0):
        self.mesh = mesh
        self.lay = sharding.layout(mesh)
        self.rows = tuple(a for a in rows if a in self.lay.names)
        spec = sharding._full_spec(table_spec, 2) if table_spec else (None,)
        self.table_axes = tuple(a for a in sharding._axes(spec[0])
                                if a in self.lay.names)
        self.table_rows = table_rows

    def table_lo(self, p: int) -> int:
        """The first table row position ``p`` holds."""
        return sharding.chunk(self.table_rows, self.lay.size(self.table_axes),
                              self.lay.index(p, self.table_axes))[0]

    def check_ids(self, ids):
        """Each table group's ids (``ids`` one tensor a position, equal
        within a group) checked once, by its first member's."""
        check_ids([i for p, i in enumerate(ids)
                   if self.lay.index(p, self.table_axes) == 0],
                  self.table_rows)

    def group_of(self, p: int, axes) -> Tuple[int, ...]:
        return next(g for g in self.lay.groups(axes) if p in g)


class _Done:
    pass


def run(mesh_run: MeshRun, gens) -> list:
    """Drive one generator a position of ``mesh_run``'s mesh (row-major
    order) in lockstep; returns each position's result."""
    gens = list(gens)
    n = len(gens)
    if n != mesh_run.lay.n:
        raise ValueError(f"{n} bodies for a mesh of {mesh_run.lay.n} "
                         f"positions")
    outer = torch.is_grad_enabled()
    modes = [outer] * n
    answers = [None] * n
    results = [None] * n
    try:
        while True:
            reqs = []
            for p, g in enumerate(gens):
                torch.set_grad_enabled(modes[p])
                try:
                    reqs.append(g.send(answers[p]))
                except StopIteration as stop:
                    results[p] = stop.value
                    reqs.append(_Done())
                modes[p] = torch.is_grad_enabled()
            kinds = {type(r) for r in reqs}
            if kinds == {_Done}:
                return results
            if len(kinds) != 1 or len(set(modes)) != 1:
                raise RuntimeError(
                    "the positions' bodies are out of step: "
                    f"{[type(r).__name__ for r in reqs]}")
            torch.set_grad_enabled(modes[0])
            answers = type(reqs[0]).mesh(mesh_run, reqs)
    finally:
        for g in gens:
            g.close()
        torch.set_grad_enabled(outer)


def run_one(gen):
    """Drive one body on one device: each request answered in place."""
    answer = None
    while True:
        try:
            req = gen.send(answer)
        except StopIteration as stop:
            return stop.value
        answer = req.one()


def body(steps):
    """A body: ``steps`` is its generator function.  The function returned
    runs it on one device (:func:`run_one`) and carries it as ``.steps``,
    for other bodies and for :func:`run`."""
    @functools.wraps(steps)
    def one_device(*args, **kwargs):
        return run_one(steps(*args, **kwargs))

    one_device.steps = steps
    return one_device


def call(fn, *args, **kwargs):
    """``yield from call(fn, ...)``: a body's steps inside another body, or
    a plain function (no crossing) called as it is."""
    steps = getattr(fn, "steps", None)
    if steps is None:
        return fn(*args, **kwargs)
    return (yield from steps(*args, **kwargs))


def _same(reqs, attr):
    vals = {getattr(r, attr) for r in reqs}
    if len(vals) != 1:
        raise ValueError(f"the positions ask with different {attr}: {vals}")
    return vals.pop()


class Request:
    """A crossing: ``one()`` is its one-device answer, ``mesh(run, reqs)``
    every position's answer on a mesh."""

    def one(self):
        raise NotImplementedError

    @staticmethod
    def mesh(mesh_run: MeshRun, reqs) -> list:
        raise NotImplementedError


class Gather(Request):
    """The global rows of a row-sharded array (all-gather along dim 0;
    backward: reduce-scatter of every position's cotangent)."""

    def __init__(self, x):
        self.x = x

    def one(self):
        return self.x

    @staticmethod
    def mesh(mesh_run, reqs):
        return sharding.all_gather([r.x for r in reqs], mesh_run.mesh,
                                   mesh_run.rows, 0, "nodes")


class ScatterSum(Request):
    """``segment_sum(data, ids, n)`` of each position's edges into the
    ``n`` global nodes, the partials summed and cut back into the node
    shards (reduce-scatter; backward: all-gather)."""

    def __init__(self, data, ids, n: int):
        self.data, self.ids, self.n = data, ids, n

    def one(self):
        return segment_sum(self.data, self.ids, self.n)

    @staticmethod
    def mesh(mesh_run, reqs):
        n = _same(reqs, "n")
        parts = [segment_sum(r.data, r.ids, n) for r in reqs]
        return sharding.reduce_scatter(parts, mesh_run.mesh, mesh_run.rows,
                                       0, "messages")


class SegmentSoftmax(Request):
    """``segment_softmax`` over each position's edges: the local segment
    maxima ``pmax``-ed (no gradient: the softmax cancels its shift's), the
    local denominators all-reduced; each position keeps its edges'."""

    def __init__(self, logits, ids, n: int):
        self.logits, self.ids, self.n = logits, ids, n

    def one(self):
        return segment_softmax(self.logits, self.ids, self.n)

    @staticmethod
    def mesh(mesh_run, reqs):
        n = _same(reqs, "n")
        mesh, axes = mesh_run.mesh, mesh_run.rows
        top = sharding.pmax([segment_max(r.logits, r.ids, n) for r in reqs],
                            mesh, axes, "softmax")
        ex = [softmax_numerator(r.logits, r.ids, m)
              for r, m in zip(reqs, top)]
        den = sharding.all_reduce([segment_sum(e, r.ids, n)
                                   for r, e in zip(reqs, ex)], mesh, axes,
                                  "softmax")
        return [softmax_normalise(e, d, r.ids)
                for r, e, d in zip(reqs, ex, den)]


class Psum(Request):
    """A sum over the row axes that every position uses alike afterwards
    (backward: identity, each position's cotangent being the one
    value's); ``tag`` names it in the collective tally."""

    def __init__(self, x, tag: str):
        self.x, self.tag = x, tag

    def one(self):
        return self.x

    @staticmethod
    def mesh(mesh_run, reqs):
        return sharding.psum([r.x for r in reqs], mesh_run.mesh,
                             mesh_run.rows, _same(reqs, "tag"))


class Mean(Request):
    """``torch.mean`` of a row-sharded array: each position's sum,
    psum-ed, over the global element count."""

    def __init__(self, x):
        self.x = x

    def one(self):
        return torch.mean(self.x)

    @staticmethod
    def mesh(mesh_run, reqs):
        sums = sharding.psum([torch.sum(r.x) for r in reqs], mesh_run.mesh,
                             mesh_run.rows, "loss")
        out = []
        for p, s in enumerate(sums):
            count = sum(reqs[j].x.numel()
                        for j in mesh_run.group_of(p, mesh_run.rows))
            out.append(s / count)
        return out


class Rows(Request):
    """The global row count of a row-sharded array."""

    def __init__(self, x):
        self.x = x

    def one(self):
        return self.x.shape[0]

    @staticmethod
    def mesh(mesh_run, reqs):
        return [sum(reqs[j].x.shape[0]
                    for j in mesh_run.group_of(p, mesh_run.rows))
                for p in range(len(reqs))]


def _grad_seeds(mesh_run, outs):
    """The cotangent each position's copy of a replicated output is
    seeded with: one, the one value's (a psum's backward is the identity,
    so the copies are not summed, and the value counts once).  A module
    function so a check can plant a fault in it."""
    del mesh_run
    return [torch.ones_like(o) for o in outs]


class Grad(Request):
    """``torch.autograd.grad(out, inputs, create_graph=)`` where ``out``
    is replicated over the mesh and ``inputs`` are each position's own
    leaves: one backward over every position at once."""

    def __init__(self, out, inputs, create_graph: bool):
        self.out, self.inputs = out, tuple(inputs)
        self.create_graph = create_graph

    def one(self):
        return torch.autograd.grad(self.out, self.inputs,
                                   create_graph=self.create_graph)

    @staticmethod
    def mesh(mesh_run, reqs):
        outs = [r.out for r in reqs]
        ins = [x for r in reqs for x in r.inputs]
        gs = torch.autograd.grad(outs, ins,
                                 grad_outputs=_grad_seeds(mesh_run, outs),
                                 create_graph=_same(reqs, "create_graph"))
        out, i = [], 0
        for r in reqs:
            out.append(tuple(gs[i:i + len(r.inputs)]))
            i += len(r.inputs)
        return out


class Bag(Request):
    """``embedding_bag(table, flat_ids)`` (sum bags) with each position
    holding its table shard: each shard's part (its own rows, zeros for
    the rest) psum-ed over the table's axes (the bag is used alike by
    every member; backward: each shard's rows get the upstream gradient
    of their own ids only)."""

    def __init__(self, table, flat_ids):
        self.table, self.flat_ids = table, flat_ids

    def one(self):
        return embedding_bag(self.table, self.flat_ids)

    @staticmethod
    def mesh(mesh_run, reqs):
        if not mesh_run.table_axes:
            return [embedding_bag(r.table, r.flat_ids) for r in reqs]
        mesh_run.check_ids([r.flat_ids for r in reqs])
        parts = [embedding_bag_shard(r.table, r.flat_ids,
                                     mesh_run.table_lo(p))
                 for p, r in enumerate(reqs)]
        return sharding.psum(parts, mesh_run.mesh, mesh_run.table_axes,
                             "lookup")


class TableRows(Request):
    """``table[ids]`` of each position's ids (sharded over the row axes)
    with the table row-sharded: the ids all-gathered over the table's
    axes, each shard's rows of all of them (zeros for the rest), summed
    and cut back to each position's ids (a reduce-scatter)."""

    def __init__(self, table, ids):
        self.table, self.ids = table, ids

    def one(self):
        return self.table[self.ids.long()]

    @staticmethod
    def mesh(mesh_run, reqs):
        if not mesh_run.table_axes:
            return [r.table[r.ids.long()] for r in reqs]
        mesh, axes = mesh_run.mesh, mesh_run.table_axes
        ids = sharding.all_gather([r.ids for r in reqs], mesh, axes, 0,
                                  "ids")
        mesh_run.check_ids(ids)
        parts = [table_rows_shard(r.table, i, mesh_run.table_lo(p))
                 for p, (r, i) in enumerate(zip(reqs, ids))]
        return sharding.reduce_scatter(parts, mesh, axes, 0, "rows",
                                       sizes=[r.ids.shape[0] for r in reqs])


class TopK(Request):
    """The top ``k`` of row-sharded scores, ``(values, indices int32)``,
    global indices; equal scores keep the lower index first (a stable
    descending sort, as ``jax.lax.top_k``).  On a mesh each position ranks
    its own, and their tops, gathered in global order, are ranked again:
    on every position."""

    def __init__(self, scores, k: int):
        self.scores, self.k = scores, k

    def one(self):
        vals, idx = torch.sort(self.scores, descending=True, stable=True)
        k = min(self.k, self.scores.shape[0])
        return vals[:k], idx[:k].to(torch.int32)

    @staticmethod
    def mesh(mesh_run, reqs):
        k = _same(reqs, "k")
        vals, idx = [], []
        for p, r in enumerate(reqs):
            v, i = torch.sort(r.scores, descending=True, stable=True)
            group = mesh_run.group_of(p, mesh_run.rows)
            off = sum(reqs[j].scores.shape[0] for j in group[:group.index(p)])
            vals.append(v[:k])
            idx.append(i[:k] + off)
        vals = sharding.all_gather(vals, mesh_run.mesh, mesh_run.rows, 0,
                                   "top")
        idx = sharding.all_gather(idx, mesh_run.mesh, mesh_run.rows, 0,
                                  "top")
        out = []
        for v, i in zip(vals, idx):
            v, order = torch.sort(v, descending=True, stable=True)
            out.append((v[:k], i[order[:k]].to(torch.int32)))
        return out

