"""Schedule engine: one pluggable runtime for the distributed count, with
the logical processor grid held on a single device or spread over a
device mesh.

A distributed triangle count is expressed as the composition

    (OperandStore, ShiftSchedule, CountKernel, Reduction)

exactly as in the JAX package's module of the same name; what changes is
how the grid is realised.  There the grid is a device mesh and each device
sees its own block.  Here the grid is the leading dimensions of every
stacked plan tensor on ONE device — ``(q, q)`` for Cannon, ``(r, c)`` for
SUMMA, ``(p,)`` for the 1D ring — so

* logical device ``(x, y)`` (or ``d``) is the slice ``tensor[x, y]``
  (``tensor[d]``);
* a Cannon shift (A left along the column axis, B up along the row axis,
  by ``k`` positions) is ``torch.roll`` of the A tensors by ``-k`` on dim 1
  and of the B tensors by ``-k`` on dim 0 — logical device ``(x, y)``
  then holds what ``(x, y+k)`` resp. ``(x+k, y)`` held, which is what
  :func:`shift_perm` prescribes; a ring rotation is the same roll of the
  rotating row blocks on dim 0;
* a SUMMA panel broadcast is a view: device ``(x, y)`` reads round
  ``z``'s panels where their owners store them, nothing is copied;
* the global sum is a sum over the grid dimensions;
* a 2.5D pod is one more leading grid dimension: Cannon's staged A and B
  tensors are ``(npods, q, q, ...)`` (pod ``t`` holds them rolled to skew
  offset ``t``, :func:`~repro_torch.core.cannon.pod_stack_arrays`), its
  task lists stay ``(q, q, ...)``, and pod ``t``'s local step ``s`` is
  the global step ``t + s * npods``;
* the scan over schedule steps is a host loop, and the per-(device, step)
  skip is a host ``if`` on the plan's *numpy* ``step_keep`` / task counts
  (reading a device bool per step would synchronise once per
  device-step).  Only the final total crosses back to the host, once per
  count.

The second realisation spreads the grid over a
:class:`~repro_torch.launch.mesh.DeviceMesh`, as the JAX package's
``shard_map`` does: every staged array is a :class:`MeshArray` holding
position ``(x, y)``'s block on that position's device, and the same
schedule loop (:meth:`ShiftSchedule.run`) runs over it.  What changes: the
payload's container (a :class:`MeshArray` in place of a stacked tensor,
packed position by position), the shift (:func:`tree_ppermute`: each
block is ``copy_``'d into a receive buffer on its destination's device,
the buffers a ring the run allocates at its entry), the order of the
loop's body and the reduction (every partial is copied to the mesh's
first device and summed there; the pod tree sends per-pod sums between
the pods' devices).  The bodies are the JAX package's: the shift that
feeds a later step is issued before the current step counts, so the copy
and the count touch disjoint buffers — with Cannon's ``double_buffer``
(the default) step ``s + 2``'s shift before step ``s``'s count, after a
prologue shift of step 1's blocks; single-buffered, on the ring and on a
compacted schedule the shift to the next counted step.  The copies run on
a copy stream of each CUDA device, ordered against the counts by events
alone (:mod:`repro_torch.core.lanes`), and every run ends with each
compute stream waiting for its copy stream, so no step synchronises and
the caller sees finished copies.  A SUMMA round copies the owner's panels
along its row and column (:func:`chain_broadcast`, or the owner sending
to each in turn for ``onehot``) on the current streams, whose peer
``copy_`` is a two-way barrier between the two devices' current streams,
as are the reduction's copies.

Carried over here: the CSR-kernel registry (``search``, ``search2``,
``global``, ``fused``), :class:`CSRStore` (with ``with_aug``),
:class:`SummaCSRStore`, :class:`OneDCSRStore`, :class:`DenseStore`,
:class:`TileStore`, :func:`masked_count`, :class:`CannonSchedule`,
:class:`SummaSchedule` and :class:`RingSchedule` (plain and compacted),
Cannon's 2.5D pods, :class:`Reduction` (``flat``, and ``tree``: the
binomial tree over the pods of :func:`pod_tree_allreduce`), the hub-split
partial (:class:`HubCount`), :func:`build_engine_fn`, batched or not, the
delta path's :func:`restage_device_arrays`, and the shift-at-a-time
stepper of checkpointed runs (:func:`build_engine_stepper`).  Where the JAX package maps
the schedule over a batch of graphs with ``lax.map``, the batched
function here loops over the staged tensors' leading batch dimension,
each graph with its own host task counts and skip mask.
The shifted CSR payload travels as blobs (:mod:`repro_torch.core.blob`:
one stacked buffer an operand, so a shift is one roll per operand),
optionally with uint16 row-length pairs in place of the indptr
(``CSRStore(compress_lengths=True)``).  The timing probes of the JAX
package's ``--time-split`` are here too: ``elide_shifts`` on
:class:`CannonSchedule` and :class:`RingSchedule`, ``elide_broadcast`` on
:class:`SummaCSRStore` (counts are wrong past one device).  Where the JAX
package reads the bytes its collectives move from the compiled program,
the port counts them where it moves them: every rolled tensor under
``shift``, the blob packing under ``other`` and the final sum's reads
under ``reduce``, into the tally of :func:`tally_moved_bytes` (a SUMMA
broadcast is a view and moves nothing).  On a mesh the tally counts the
bytes that cross positions, which for shifts and the global sum are the
one-device tally's; a SUMMA broadcast's copies count under
``broadcast``, and ``Reduction(global_sum=False)``'s gather under
``reduce``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.tc_tile import tile_pair_count
from ..launch.mesh import DeviceMesh
from . import count as count_mod
from . import lanes as lanes_mod
from .blob import blob_layout, pack_blob, unpack_blob

__all__ = [
    "GridAxes",
    "RingAxes",
    "MASK_NAME",
    "MeshArray",
    "OperandStore",
    "CSRStore",
    "DenseStore",
    "TileStore",
    "ShiftSchedule",
    "CannonSchedule",
    "SummaCSRStore",
    "SummaSchedule",
    "OneDCSRStore",
    "RingSchedule",
    "Reduction",
    "pod_tree_allreduce",
    "chain_broadcast",
    "tree_ppermute",
    "HubCount",
    "CSR_KERNELS",
    "register_csr_kernel",
    "make_csr_kernel",
    "check_fused_split",
    "masked_count",
    "build_engine_fn",
    "build_engine_stepper",
    "restage_device_arrays",
    "shift_perm",
    "tally_moved_bytes",
    "placed_at",
    "current_place",
]


# ======================================================================
# mesh axes and the mesh's container
# ======================================================================
MASK_NAME = "step_keep"


@dataclasses.dataclass(frozen=True)
class GridAxes:
    """Named mesh axes of a 2D (optionally 2.5D) grid; ``all`` is their
    order, which is the order of the grid dimensions: ``all[i]`` names
    grid dimension ``i``."""

    row: str = "data"
    col: str = "model"
    pod: Optional[str] = None

    @property
    def all(self) -> Tuple[str, ...]:
        return (self.pod, self.row, self.col) if self.pod else (self.row, self.col)

    @classmethod
    def of(cls, mesh) -> "GridAxes":
        """The axes of a ``(row, col)`` or ``(pod, row, col)`` mesh."""
        names = tuple(mesh.axis_names)
        if len(names) == 2:
            return cls(row=names[0], col=names[1])
        if len(names) == 3:
            return cls(row=names[1], col=names[2], pod=names[0])
        raise ValueError(f"a grid mesh has 2 or 3 axes, got {names}")


@dataclasses.dataclass(frozen=True)
class RingAxes:
    """A single mesh axis forming the 1D ring."""

    axis: str = "flat"

    @property
    def all(self) -> Tuple[str, ...]:
        return (self.axis,)


class MeshArray:
    """One stacked plan array spread over a
    :class:`~repro_torch.launch.mesh.DeviceMesh`: ``blocks[pos]`` is grid
    position ``pos``'s block, on that position's device.

    It is indexed as the stacked tensor it stands for: ``t[pos]`` is the
    block and ``t[pos + rest]`` is ``block[rest]``, so the stores read a
    position's operands alike on one device and on a mesh; ``shape`` is
    the grid's shape followed by a block's.  A shifted payload's arrays
    carry ``ring``, the receive buffers a run allocated at its entry
    (:func:`_ringed`), and ``gen``, the shifts since that entry: the next
    shift writes ``ring[gen % len(ring)]`` (:func:`tree_ppermute`).  No
    other block is ever written by a shift.
    """

    __slots__ = ("mesh", "blocks", "ring", "gen")

    def __init__(self, mesh, blocks: Dict[tuple, torch.Tensor], *,
                 ring: Tuple[Dict, ...] = (), gen: int = 0):
        self.mesh = mesh
        self.blocks = blocks
        self.ring = ring
        self.gen = gen

    def _split(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        g = len(self.mesh.shape)
        if len(idx) < g:
            raise IndexError(
                f"a mesh array is indexed by a whole grid position "
                f"({g} indices) first, got {idx}")
        return tuple(int(i) for i in idx[:g]), idx[g:]

    def __getitem__(self, idx):
        pos, rest = self._split(idx)
        block = self.blocks[pos]
        return block[rest] if rest else block

    def __setitem__(self, pos, value):
        """Replace a whole position's block (``out[pos] += c`` lands here)."""
        pos, rest = self._split(pos)
        if rest:
            raise IndexError("a mesh array replaces whole blocks only")
        self.blocks[pos] = value

    def _any(self) -> torch.Tensor:
        return next(iter(self.blocks.values()))

    @property
    def shape(self) -> torch.Size:
        return torch.Size(tuple(self.mesh.shape) + tuple(self._any().shape))

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return sum(b.numel() for b in self.blocks.values())

    def element_size(self) -> int:
        return self._any().element_size()

    def map(self, fn, *others: "MeshArray") -> "MeshArray":
        """``fn`` of each position's blocks (this array's, then each of
        ``others``'), on that position: a new array the engine owns."""
        return MeshArray(self.mesh, {
            pos: fn(b, *(o.blocks[pos] for o in others))
            for pos, b in self.blocks.items()})


def _on_mesh(t) -> bool:
    return isinstance(t, MeshArray)


_PLACE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_place", default=None)


@contextlib.contextmanager
def placed_at(pos):
    """The tensors the engine makes while the block runs belong to grid
    position ``pos``.  Several positions of a mesh may share a device, so
    the device alone does not say whose a tensor is; the memory walk
    (:func:`~repro_torch.launch.roofline.walk_engine`) reads this to
    charge each tensor to its position's card."""
    token = _PLACE.set(tuple(int(i) for i in pos))
    try:
        yield
    finally:
        _PLACE.reset(token)


def current_place():
    """The grid position of :func:`placed_at` in force, or ``None``."""
    return _PLACE.get()


def _send(x: torch.Tensor, mesh, pos, phase: str) -> torch.Tensor:
    """A copy of ``x`` received at grid position ``pos`` of ``mesh``: one
    crossing of positions, tallied under ``phase``."""
    with placed_at(pos):
        buf = torch.empty_like(x, device=mesh.device_at(pos))
    buf.copy_(x)
    _tally(phase, buf)
    return buf


# ======================================================================
# shared shift helpers
# ======================================================================
def shift_perm(size: int, k: int):
    """(source, destination) pairs shifting *towards lower index* by ``k``
    (left/up): position ``s`` sends its block to ``(s - k) % size``."""
    return [(s, (s - k) % size) for s in range(size)]


_PHASES = ("shift", "broadcast", "reduce", "other")
_MOVED: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moved_bytes", default=None)


@contextlib.contextmanager
def tally_moved_bytes():
    """Count the bytes the engine moves while the block runs.

    Yields a dict of bytes (``numel * element_size``) under ``shift``,
    ``broadcast``, ``reduce`` and ``other``: every tensor a shift rolls
    under ``shift`` (read and written once, counted once, as a
    collective's payload is), the blobs the CSR stores pack before a
    count under ``other``, and the per-device partials the final sum
    reads under ``reduce`` (with each tree round's sent partials).  A
    SUMMA panel broadcast is a view of the owner's slice and moves
    nothing, so ``broadcast`` stays 0.  Outside the block nothing is
    counted."""
    tally = dict.fromkeys(_PHASES, 0)
    token = _MOVED.set(tally)
    try:
        yield tally
    finally:
        _MOVED.reset(token)


def _tally(phase: str, *tensors) -> None:
    tally = _MOVED.get()
    if tally is not None:
        tally[phase] += sum(t.numel() * t.element_size() for t in tensors)


def _roll_tree(tree, k: int, dim: int):
    """Apply a :func:`shift_perm` of distance ``k`` to every stacked
    tensor of a payload along grid dimension ``dim``: a roll on one
    device, :func:`tree_ppermute` on a mesh."""
    if tree and _on_mesh(tree[0]):
        return tree_ppermute(tree, dim, shift_perm(tree[0].mesh.shape[dim], k))
    _tally("shift", *tree)
    return tuple(torch.roll(t, shifts=-k, dims=dim) for t in tree)


def tree_ppermute(tree, dim: int, perm):
    """Permute every :class:`MeshArray` of a payload along grid dimension
    ``dim`` by the ``(source, destination)`` pairs ``perm``: each block is
    ``copy_``'d into a receive buffer on its destination's device.

    The receive buffers are the payload's ring, allocated at the run's
    entry (:func:`_ringed`): generation ``g`` of a ring of ``n`` lands in
    ``ring[(g - 1) % n]``, so a run keeping ``n`` generations alive (2,
    or 3 with Cannon's double buffer) writes the buffers of the generation
    ``n`` behind, whose last count was issued before.  Staged blocks are
    only read.  The copies run on the devices' copy streams
    (:meth:`~repro_torch.core.lanes.Lanes.shift`), after the last count
    that read the buffer's earlier generation; a call outside a run
    allocates its own buffers and joins its copies before it returns.
    Nothing synchronises."""
    dest = dict(perm)
    mesh = tree[0].mesh
    if lanes_mod.active() is None:
        tree = _ringed(tree, 1)
    (gen, n), = {(t.gen, len(t.ring)) for t in tree}
    if not n:
        raise ValueError("a shift inside a run writes the receive buffers "
                         "the run allocated at its entry: the payload has "
                         "none")
    slot, out, moves = gen % n, [], []
    with lanes_mod.lanes(mesh) as ln:
        for t in tree:
            recv = t.ring[slot]
            for pos, block in t.blocks.items():
                to = pos[:dim] + (dest[pos[dim]],) + pos[dim + 1:]
                moves.append((block, pos, recv[to], to))
                _tally("shift", recv[to])
            out.append(MeshArray(t.mesh, recv, ring=t.ring, gen=gen + 1))
        ln.shift(moves, gen + 1, slot, n)
    return tuple(out)


def _ringed(tree, n: int):
    """``tree``'s mesh arrays, each with a ring of ``n`` receive buffers
    like its blocks, on each position's device, and its generation 0; on
    one device ``tree`` as it is.  A run calls it before its entry
    (:func:`~repro_torch.core.lanes.lanes`), so every copy of the run
    waits for the allocation."""
    if isinstance(tree, tuple):
        return tuple(_ringed(t, n) for t in tree)
    if not _on_mesh(tree):
        return tree
    ring = tuple({pos: torch.empty_like(b) for pos, b in tree.blocks.items()}
                 for _ in range(n))
    return MeshArray(tree.mesh, tree.blocks, ring=ring)


def _onehot_broadcast(x, mesh, line, owner: int):
    """``owner``'s ``x`` at every position of ``line`` (a list of
    ``mesh``'s positions): the owner sends it to each other position in
    turn (the JAX package's masked psum moves the same panel with an
    all-reduce)."""
    return [x if t == owner else _send(x, mesh, pos, "broadcast")
            for t, pos in enumerate(line)]


def chain_broadcast(x, mesh, line, owner: int):
    """``owner``'s ``x`` at every position of ``line`` (``n`` positions of
    ``mesh``), by the JAX package's doubling chain: in each round every
    position already covered sends to the one ``cover`` ahead (mod n, never
    past the owner), so ``n - 1`` copies in ``ceil(log2 n)`` rounds, a
    relay sending what it received."""
    n = len(line)
    held = {owner % n: x}
    cover = 1
    while cover < n:
        for t in range(n):
            rel = (t - owner) % n
            if rel < cover and rel + cover < n:
                held[(t + cover) % n] = _send(held[t], mesh,
                                              line[(t + cover) % n],
                                              "broadcast")
        cover *= 2
    return [held[t] for t in range(n)]


def restage_device_arrays(
    prev_host: Dict[str, np.ndarray],
    prev_staged: Dict[str, torch.Tensor],
    new_host: Dict[str, np.ndarray],
    device,
    specs: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Stage ``new_host`` arrays on ``device``, reusing the parent's
    tensors (``prev_staged``, staged there from ``prev_host``) for every
    array an edge delta left unchanged.

    The splice in ``apply_delta`` copies only the arrays it touches, so a
    clean array is often the *same object* as the parent's (identity
    fast path); otherwise a value comparison against the parent's host
    array decides — e.g. ``step_keep`` frequently survives a delta
    byte-identical even though it was recomputed.  Returns the staged
    dict and how many tensors were reused (skipped uploads).

    ``device`` may be a :class:`~repro_torch.launch.mesh.DeviceMesh` (the
    host arrays then laid out as the mesh stages them, ``specs`` naming
    each array's mesh axes): an array that changed is restaged position
    by position, each position keeping the parent's block where its slice
    of the host array is unchanged.
    """
    from ..pipeline.artifact import stage_arrays

    out: Dict[str, torch.Tensor] = {}
    fresh: Dict[str, np.ndarray] = {}
    for name, host in new_host.items():
        prev = prev_host.get(name)
        staged = prev_staged.get(name)
        same = (
            staged is not None
            and prev is not None
            and prev.shape == host.shape
            and prev.dtype == host.dtype
            and (prev is host or np.array_equal(prev, host))
        )
        if same:
            out[name] = staged
        else:
            fresh[name] = host
    reused = len(out)
    if fresh and isinstance(device, DeviceMesh):
        from ..pipeline.artifact import stage_on_mesh

        for name, host in fresh.items():
            prev = prev_staged.get(name)
            out[name] = stage_on_mesh(
                host, device, (specs or {}).get(name),
                reuse=(prev_host[name], prev) if _on_mesh(prev) else None)
    else:
        out.update(stage_arrays(fresh, device))
    return {name: out[name] for name in new_host}, reused


# ======================================================================
# CSR count-kernel registry — "behind one signature"
# ======================================================================
# Every CSR kernel factory returns
#   kernel(a_ptr, a_idx, b_ptr, b_idx, ti, tj, cnt) -> 0-dim int64 tensor
# with all plan-derived padding/chunk parameters bound at build time;
# ``cnt`` is a host integer.
CSR_KERNELS: Dict[str, Callable] = {}


def register_csr_kernel(name: str, factory: Callable) -> None:
    """Register a CSR count-kernel factory under ``name``.

    ``factory(dpad=..., chunk=..., probe_shorter=..., sentinel=...,
    n_long=..., d_small=..., **extra) -> kernel``.
    ``extra`` carries method-specific knobs (the fused kernel's
    ``fused_tile``/``fused_long_fallback``, the global kernel's
    ``key_base``); factories must tolerate and ignore keys they don't
    own.
    """
    CSR_KERNELS[name] = factory


def _search_factory(*, dpad, chunk, probe_shorter, sentinel, n_long, d_small,
                    **extra):
    del n_long, d_small, extra
    return functools.partial(
        count_mod.count_pair_search,
        dpad=dpad,
        chunk=chunk,
        probe_shorter=probe_shorter,
        sentinel=sentinel,
    )


def _search2_factory(*, dpad, chunk, probe_shorter, sentinel, n_long,
                     d_small, **extra):
    # sentinel is plan-derived: the build_*_fn functions pass it
    # unconditionally with no user intent behind it, so drop it here and
    # spare engine users the one-time ignored-kwarg warning inside
    # count_pair_search_two_level.
    # probe_shorter is forwarded: a non-default value only ever comes
    # from an explicit user request, the porting mistake the warning
    # exists to surface.
    del sentinel, extra
    if n_long is None or d_small is None:
        raise ValueError(
            "method 'search2' needs a bucketized plan (bucketize_plan) "
            "providing n_long/d_small"
        )

    def kernel(a_ptr, a_idx, b_ptr, b_idx, ti, tj, cnt, aug_b=None):
        return count_mod.count_pair_search_two_level(
            a_ptr, a_idx, b_ptr, b_idx, ti, tj, cnt, n_long,
            dpad_long=dpad,
            dpad_short=d_small,
            chunk=chunk,
            probe_shorter=probe_shorter,
            aug_b=aug_b,
        )

    return kernel


def _global_factory(*, dpad, chunk, probe_shorter, sentinel, n_long, d_small,
                    **extra):
    del probe_shorter, sentinel, n_long, d_small
    return functools.partial(
        count_mod.count_pair_search_global, dpad=dpad, chunk=chunk,
        base=extra.get("key_base"),
    )


def _fused_factory(*, dpad, chunk, probe_shorter, sentinel, n_long, d_small,
                   **extra):
    """The fused intersection kernel over both buckets of the split.

    Needs the *two-sided* (maxfrag) split: under the probe-only split a
    B fragment longer than ``d_small`` would be silently truncated.
    ``build_cannon_fn`` enforces the split provenance
    (:func:`check_fused_split`); this factory only enforces that a split
    exists at all.
    """
    if n_long is None or d_small is None:
        raise ValueError(
            "method 'fused' needs a maxfrag-split plan: re-plan with "
            "autotune='fused' providing n_long/d_small"
        )
    from ..kernels.tc_fused import count_pair_fused
    from ..runtime import faultinject

    faultinject.fire("fused")
    return functools.partial(
        count_pair_fused,
        n_long=n_long,
        d_small=d_small,
        dpad_long=dpad,
        chunk=chunk,
        tile=extra.get("fused_tile"),
        long_fallback=extra.get("fused_long_fallback", "global"),
        probe_shorter=probe_shorter,
        sentinel=sentinel,
    )


register_csr_kernel("search", _search_factory)
register_csr_kernel("search2", _search2_factory)
register_csr_kernel("global", _global_factory)
register_csr_kernel("fused", _fused_factory)


def check_fused_split(plan) -> None:
    """Refuse ``method='fused'`` on plans without the two-sided split.

    The default autotune stage classifies tasks by the PROBE fragment
    only — sound for the global-search path (keys are searched unpadded)
    but NOT for the fused kernel, which takes both fragments at most
    ``d_small`` long and would silently truncate a long B row into a
    wrong count.  Only plans whose autotune report carries
    ``split='maxfrag'`` (planner ``autotune='fused'``) are accepted.
    """
    report = getattr(plan, "autotune", None) or {}
    if report.get("split") != "maxfrag":
        raise ValueError(
            "method 'fused' requires a plan with the two-sided maxfrag "
            "split (plan with autotune='fused'); got "
            f"split={report.get('split')!r} — a probe-only split would "
            "truncate long B fragments and miscount"
        )


def make_csr_kernel(
    method: str,
    *,
    dpad: int,
    chunk: int,
    probe_shorter: bool = True,
    sentinel: Optional[int] = None,
    n_long: Optional[int] = None,
    d_small: Optional[int] = None,
    **extra,
) -> Callable:
    """Build a registered CSR kernel with plan parameters bound."""
    try:
        factory = CSR_KERNELS[method]
    except KeyError:
        raise ValueError(
            f"unknown CSR count method {method!r}; "
            f"registered: {sorted(CSR_KERNELS)}"
        ) from None
    return factory(
        dpad=dpad,
        chunk=chunk,
        probe_shorter=probe_shorter,
        sentinel=sentinel,
        n_long=n_long,
        d_small=d_small,
        **extra,
    )


# ======================================================================
# operand stores
# ======================================================================
class OperandStore:
    """Payload representation: which stacked tensors travel, and how one
    logical device's slice of them becomes count-kernel arguments.

    * ``operand_names`` / ``static_names`` — plan array names, in call
      order (operands travel; statics stay put).
    * ``payload(arrays)`` — the shiftable state: for Cannon two tuples
      ``(a_state, b_state)`` of stacked ``(q, q, ...)`` tensors, for the
      ring one tuple of ``(p, ...)`` tensors, for SUMMA nothing;
      schedules treat it opaquely and roll it along the grid dimensions.
    * ``select(state, arrays, step)`` — the state the whole grid counts
      at schedule step ``step``: the state itself, but for SUMMA on a mesh,
      whose round broadcasts its panels here.
    * ``count(state, arrays, dev, step, cnt)`` — run the bound count
      kernel for logical device ``dev`` (an index tuple into the grid) on
      the current state at schedule step ``step`` (the ORIGINAL step
      index, also under compaction) over ``cnt`` tasks.

    The arrays are stacked tensors on one device or :class:`MeshArray`
    s over a mesh; both index alike, so a store reads a position's
    operands the same way on either.
    """

    operand_names: Sequence[str] = ()
    static_names: Sequence[str] = ()

    @property
    def names(self):
        return tuple(self.operand_names) + tuple(self.static_names)

    def payload(self, arrays: Dict):
        raise NotImplementedError

    def select(self, state, arrays: Dict, step: int):
        del arrays, step
        return state

    def count(self, state, arrays: Dict, dev: Tuple[int, ...], step: int,
              cnt: int):
        raise NotImplementedError


class CSRStore(OperandStore):
    """CSR-block operands.

    With ``use_blob=True`` (the default, as in the JAX package) each
    operand's ``indptr`` and ``indices`` travel as one blob
    (:func:`~repro_torch.core.blob.pack_blob`, packed from the staged
    tensors at every count), so a shift is one roll an operand; with
    ``compress_lengths=True`` the blob carries the rows' lengths as uint16
    pairs in place of the int32 indptr, and each count rebuilds the
    indptr with one cumsum.  ``with_aug=True`` adds the planner-staged
    row-encoded intersection keys (``b_aug``) as an extra payload leaf
    travelling with the B operand: the keys shift with the blocks, so the
    ``global`` and ``search2`` kernels never rebuild them on the device.
    The aug leaf stays outside the int32 blob (its dtype may be int64).
    The fused kernel reads no keys.

    The store holds no per-call state: the blob layout follows from the
    shapes of the staged arrays each count is given, so a delta path's
    rebound function packs its blobs from the spliced plan's tensors.
    """

    operand_names = ("a_indptr", "a_indices", "b_indptr", "b_indices")
    static_names = ("m_ti", "m_tj", "m_cnt")

    def __init__(self, kernel, *, use_blob: bool = True,
                 compress_lengths: bool = False, dmax: Optional[int] = None,
                 with_aug: bool = False):
        if compress_lengths:
            if not use_blob:
                raise ValueError(
                    "length compression only applies to blob shifts")
            if dmax is None or dmax >= 65536:
                raise ValueError("uint16 length compression needs d < 2^16")
        self.kernel = kernel
        self.use_blob = use_blob
        self.compress_lengths = compress_lengths
        self.with_aug = with_aug
        if with_aug:
            self.operand_names = self.operand_names + ("b_aug",)

    # -- uint16 length compression ------------------------------------
    @staticmethod
    def _pack_lengths(ptr):
        """``(..., nb + 1)`` indptr -> ``(..., ceil(nb / 2))`` int32 of
        uint16 length pairs ``lo | hi << 16`` (an odd ``nb`` padded with a
        zero length)."""
        lens = torch.diff(ptr, dim=-1).to(torch.int32)
        if lens.shape[-1] % 2:
            lens = torch.nn.functional.pad(lens, (0, 1))
        return lens[..., 0::2] | (lens[..., 1::2] << 16)

    @staticmethod
    def _unpack_lengths(packed, nb: int):
        """The indptr of :meth:`_pack_lengths`'s pairs: a pair with a
        length of 2^15 or more is a negative int32, and ``>>`` is
        arithmetic, so the mask after it is what recovers ``hi``."""
        lo = packed & 0xFFFF
        hi = (packed >> 16) & 0xFFFF
        lens = torch.stack([lo, hi], dim=-1).flatten(-2)[..., :nb]
        return torch.nn.functional.pad(
            torch.cumsum(lens, dim=-1, dtype=torch.int32), (1, 0))

    # -- pack / unpack -------------------------------------------------
    def _layout(self, arrays, side):
        """``(layout, nb)`` of one side's blob from the staged shapes."""
        nb = arrays[f"{side}_indptr"].shape[-1] - 1
        head = (nb + 1) // 2 if self.compress_lengths else nb + 1
        layout, _ = blob_layout(
            [(head,), (arrays[f"{side}_indices"].shape[-1],)])
        return layout, nb

    def _pack_one(self, ptr, idx):
        head = self._pack_lengths(ptr) if self.compress_lengths else ptr
        return pack_blob([head, idx], lead=ptr.dim() - 1)

    def _pack(self, arrays, side):
        """One blob of the side's stacked operands, or on a mesh one a
        position, packed on its device."""
        ptr, idx = arrays[f"{side}_indptr"], arrays[f"{side}_indices"]
        blob = (ptr.map(self._pack_one, idx) if _on_mesh(ptr)
                else self._pack_one(ptr, idx))
        _tally("other", blob)
        return blob

    def _unpack(self, blob, arrays, side):
        layout, nb = self._layout(arrays, side)
        head, idx = unpack_blob(blob, layout)
        if self.compress_lengths:
            head = self._unpack_lengths(head, nb)
        return head, idx

    def payload(self, arrays):
        """``(a_state, b_state)``: each a tuple, ``(blob,)`` or ``(indptr,
        indices)``, the B side with ``b_aug`` last when staged."""
        aug = (arrays["b_aug"],) if self.with_aug else ()
        if self.use_blob:
            return ((self._pack(arrays, "a"),),
                    (self._pack(arrays, "b"),) + aug)
        return ((arrays["a_indptr"], arrays["a_indices"]),
                (arrays["b_indptr"], arrays["b_indices"]) + aug)

    def count(self, state, arrays, dev, step, cnt):
        del step  # the task list is the same at every step
        # ``dev`` is ``(x, y)``, or ``(t, x, y)`` on a pod grid: the
        # operands are pod t's, the task list is (x, y)'s in every pod —
        # on one device the one stacked list, on a mesh pod t's replica
        home = dev if _on_mesh(arrays["m_ti"]) else dev[-2:]
        a_state, b_state = state
        extra = {}
        if self.with_aug:
            *b_state, aug = b_state
            extra = dict(aug_b=aug[dev])
        if self.use_blob:
            a_ptr, a_idx = self._unpack(a_state[0][dev], arrays, "a")
            b_ptr, b_idx = self._unpack(b_state[0][dev], arrays, "b")
        else:
            a_ptr, a_idx = (t[dev] for t in a_state)
            b_ptr, b_idx = (t[dev] for t in b_state)
        return self.kernel(
            a_ptr, a_idx, b_ptr, b_idx,
            arrays["m_ti"][home], arrays["m_tj"][home], cnt,
            **extra,
        )


class DenseStore(OperandStore):
    """Dense 0/1 block operands (oracle path): count = sum((A@Bᵀ)⊙M)."""

    operand_names = ("a_dense", "b_dense")
    static_names = ("m_dense",)

    def payload(self, arrays):
        return ((arrays["a_dense"],), (arrays["b_dense"],))

    def count(self, state, arrays, dev, step, cnt):
        del step, cnt
        x, y = dev
        (a,), (b,) = state
        return count_mod.count_pair_dense(
            a[x, y], b[x, y], arrays["m_dense"][x, y]
        )


class TileStore(OperandStore):
    """Bit-packed 128x128 tile operands driving the tile kernels.

    Tile stores shift exactly like the CSR blocks; the per-(device, shift)
    active-triple lists are static (planner-joined) and selected by the
    schedule's ORIGINAL step index.
    """

    operand_names = ("a_tiles", "b_tiles")
    static_names = ("m_tiles", "triples")

    def __init__(self, *, mode: str = "popcount"):
        self.mode = mode

    def payload(self, arrays):
        return ((arrays["a_tiles"],), (arrays["b_tiles"],))

    def count(self, state, arrays, dev, step, cnt):
        del cnt
        x, y = dev
        (a,), (b,) = state
        return tile_pair_count(
            arrays["triples"][x, y, step], a[x, y], b[x, y],
            arrays["m_tiles"][x, y], mode=self.mode,
        )


class SummaCSRStore(OperandStore):
    """CSR operands for SUMMA broadcast rounds on an ``(r, c)`` grid.

    Nothing is carried between rounds: A is stored ``(r, c, nb_r + ...)``
    (panel ``(x, z)`` at grid position ``(x, z)``) and B ``(r, c, npan,
    ...)`` (panel ``(y, z)`` at grid row ``z % r``, slot ``z // r``).  In
    round ``z`` device ``(x, y)`` counts the A panel ``a[x, z % c]`` and
    the B panel ``b[z % r, y, z // r]`` — the broadcasts along the grid
    row and the grid column, realised as views of the owners' tensors.

    ``broadcast`` names the JAX package's strategy (``"onehot"``: masked
    psums; ``"chain"``: masked ppermute doubling chains).  Both move the
    owner's panel to every device of its row or column; with the grid on
    one device both come down to the same read of the owner's slice, so
    the count is the same and only the name is checked and kept.  On a
    mesh a round copies the panels (:meth:`select`): ``"onehot"`` has the
    owner send to each position of its line, ``"chain"`` relays along
    :func:`chain_broadcast`'s doubling chain.

    ``elide_broadcast=True`` is the count-only timing probe (mirroring
    Cannon's ``elide_shifts``): every device counts its *local* panel
    pair, ``a[x, y]`` against ``b[x, y, z // r]`` — counts are wrong for
    grids past 1 x 1.
    """

    operand_names = ("a_indptr", "a_indices", "b_indptr", "b_indices")
    static_names = ("m_ti", "m_tj", "m_cnt")

    def __init__(self, kernel, *, r: int, c: int, broadcast: str = "onehot",
                 elide_broadcast: bool = False):
        if broadcast not in ("onehot", "chain"):
            raise ValueError(
                f"unknown broadcast strategy {broadcast!r}; "
                "expected 'onehot' or 'chain'"
            )
        self.kernel = kernel
        self.r = r
        self.c = c
        self.broadcast = broadcast
        self.elide_broadcast = elide_broadcast

    def payload(self, arrays):  # SUMMA carries no shift state
        del arrays
        return ()

    def select(self, state, arrays, step):
        """On a mesh, round ``step``'s broadcasts: the A panel of owner
        ``(x, z % c)`` along every grid row ``x``, the B panel (slot
        ``z // r``) of owner ``(z % r, y)`` down every grid column ``y``.
        Returns each position's received ``(a_indptr, a_indices,
        b_indptr, b_indices)``; on one device nothing (views)."""
        a = arrays["a_indptr"]
        if not _on_mesh(a) or self.elide_broadcast:
            return state
        z, mesh = step, a.mesh
        send = chain_broadcast if self.broadcast == "chain" else _onehot_broadcast
        got = {k: {} for k in self.operand_names}
        for x in range(self.r):
            line = [(x, y) for y in range(self.c)]
            for k in ("a_indptr", "a_indices"):
                got[k].update(zip(line, send(
                    arrays[k][x, z % self.c], mesh, line, z % self.c)))
        for y in range(self.c):
            line = [(x, y) for x in range(self.r)]
            for k in ("b_indptr", "b_indices"):
                got[k].update(zip(line, send(
                    arrays[k][z % self.r, y, z // self.r], mesh, line,
                    z % self.r)))
        return tuple(MeshArray(mesh, got[k])
                     for k in self.operand_names)

    def count(self, state, arrays, dev, step, cnt):
        x, y = dev
        if state:  # the panels this position received (a mesh)
            return self.kernel(*(t[dev] for t in state),
                               arrays["m_ti"][x, y], arrays["m_tj"][x, y],
                               cnt)
        z = step
        ax, bx, slot = z % self.c, z % self.r, z // self.r
        if self.elide_broadcast:
            ax, bx = y, x
        return self.kernel(
            arrays["a_indptr"][x, ax],
            arrays["a_indices"][x, ax],
            arrays["b_indptr"][bx, y, slot],
            arrays["b_indices"][bx, y, slot],
            arrays["m_ti"][x, y], arrays["m_tj"][x, y], cnt,
        )


class OneDCSRStore(OperandStore):
    """1D-ring operands: each device's own row-block CSR stays put (the A
    side) while a copy of every block rotates around the ring as one blob
    (the B side, as in the JAX package); tasks are grouped by owner-of-j,
    and device ``d`` at ring step ``t`` counts its group ``(d, (d + t) %
    p)`` against the block it then holds."""

    operand_names = ("indptr", "indices")
    static_names = ("t_i", "t_j", "t_cnt")

    def __init__(self, kernel, *, p: int):
        self.kernel = kernel
        self.p = p

    def payload(self, arrays):
        ptr, idx = arrays["indptr"], arrays["indices"]
        blob = (ptr.map(lambda p, i: pack_blob([p, i]), idx) if _on_mesh(ptr)
                else pack_blob([ptr, idx], lead=1))
        _tally("other", blob)
        return (blob,)

    def count(self, state, arrays, dev, step, cnt):
        (d,) = dev
        o = (d + step) % self.p
        layout, _ = blob_layout([arrays["indptr"].shape[1:],
                                 arrays["indices"].shape[1:]])
        b_ptr, b_idx = unpack_blob(state[0][d], layout)
        return self.kernel(
            arrays["indptr"][d], arrays["indices"][d], b_ptr, b_idx,
            arrays["t_i"][d, o], arrays["t_j"][d, o], cnt,
        )


# ======================================================================
# shift schedules
# ======================================================================
def masked_count(store, state, arrays, dev, step, cnt, step_keep, home=None):
    """One logical device's count for one schedule step, short-circuited
    on the host by the planner's mask.

    ``dev`` is the device's index tuple into the grid; ``step_keep`` is
    the plan's numpy ``(*grid, nsteps)`` bool array (True = this step's
    incoming operands can contribute) or ``None``, read at ``home`` (the
    index of the device's task list; ``dev`` itself unless it is a pod's
    device) and the ORIGINAL step; returns ``None`` when the step is
    masked off or the device has no tasks that step, so no kernel is
    launched at all.  Shifts stay outside — the whole grid rolls together
    whether or not a device counts.  Inside a mesh run the count goes
    through the run's lanes (:meth:`~repro_torch.core.lanes.Lanes.count`):
    after the shifts that wrote ``state``'s blocks.
    """
    home = dev if home is None else home
    if step_keep is not None and not step_keep[home + (step,)]:
        return None
    if cnt <= 0:
        return None
    ln = lanes_mod.active()
    gens = {t.gen for t in _leaves(state) if _on_mesh(t)}
    with placed_at(dev):
        if ln is None or not gens:
            return store.count(state, arrays, dev, step, cnt)
        return ln.count(dev, step, gens,
                        lambda: store.count(state, arrays, dev, step, cnt))


class ShiftSchedule:
    """Permutation structure for the host loop.

    ``grid`` is the logical device grid; ``task_count(m_cnt, dev, step)``
    reads a device's task count for a step from the plan's host array.
    ``run`` executes the whole schedule and returns the ``grid``-shaped
    int64 tensor of per-device totals: the plain loop over all steps
    normally, or — when ``live_steps`` is set (a compacted schedule) —
    only the globally-live steps, with the elided unit shifts fused into
    multi-hop rolls.  Step indices stay in the ORIGINAL numbering either
    way, so the staged ``step_keep`` mask (and the ring's task groups) are
    indexed unremapped.

    On one device a step counts, then rolls the payload on.  On a mesh
    the body is the JAX package's: the shift that feeds the next counted
    step is issued before the current step counts (its copies then run on
    the copy streams beside the count, :mod:`repro_torch.core.lanes`),
    and no shift is issued that no count reads.
    """

    live_steps: Optional[Tuple[int, ...]] = None

    @property
    def grid(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def nsteps(self) -> int:
        raise NotImplementedError

    def task_count(self, m_cnt, dev, step) -> int:
        del step  # the task list is the same at every step
        return int(m_cnt[dev])

    def locate(self, dev, step):
        """``(home, original step)`` of grid position ``dev`` at loop step
        ``step``: the index of its task list and skip-mask row, and the
        schedule step it counts.  Only a pod's device differs from
        ``(dev, step)`` (:class:`CannonSchedule`)."""
        return dev, step

    def _shift_k(self, payload, hop: int):
        raise NotImplementedError

    def _count_grid(self, store, payload, arrays, step, m_cnt, step_keep, out):
        payload = store.select(payload, arrays, step)
        for dev in np.ndindex(*self.grid):
            home, s = self.locate(dev, step)
            c = masked_count(
                store, payload, arrays, dev, s,
                self.task_count(m_cnt, home, s), step_keep, home=home,
            )
            if c is not None:
                out[dev] += c

    def _walk(self):
        """``(prologue hop, [(step, hop to the next counted step), ...])``
        of the loop: every step one hop apart, or the live steps of a
        compacted schedule, reached by one fused multi-hop shift each (the
        prologue hop ``live[0]``, then differences of ORIGINAL step
        indices); the last step's hop is 0."""
        live = self.live_steps
        if live is None:
            n = self.nsteps
            return 0, [(s, int(s + 1 < n)) for s in range(n)]
        if not live:
            return 0, []  # everything elided: no shifts, no counts
        return live[0], [(s, live[i + 1] - s if i + 1 < len(live) else 0)
                         for i, s in enumerate(live)]

    def run(self, store, arrays, *, m_cnt, step_keep=None):
        out = _zero_partials(arrays[store.static_names[0]], self.grid)
        payload = store.payload(arrays)
        hop0, walk = self._walk()
        if not (_on_mesh(out) and payload):  # one device, or SUMMA's rounds
            if walk and hop0:
                payload = self._shift_k(payload, hop0)
            for s, hop in walk:
                self._count_grid(store, payload, arrays, s, m_cnt, step_keep,
                                 out)
                if hop:
                    payload = self._shift_k(payload, hop)
            return out
        double = (getattr(self, "double_buffer", False)
                  and self.live_steps is None)
        shifts = int(bool(walk) and hop0 > 0) + sum(1 for _, h in walk if h)
        payload = _ringed(payload, min(3 if double else 2, shifts))
        with lanes_mod.lanes(out.mesh):
            if double:
                self._run_double(store, payload, arrays, m_cnt, step_keep, out)
                return out
            if walk and hop0:
                payload = self._shift_k(payload, hop0)
            for s, hop in walk:
                nxt = self._shift_k(payload, hop) if hop else None
                self._count_grid(store, payload, arrays, s, m_cnt, step_keep,
                                 out)
                payload = nxt
        return out

    def _run_double(self, store, payload, arrays, m_cnt, step_keep, out):
        """The double-buffered body on a mesh: a prologue shift puts step
        1's blocks in flight, and at step ``s`` the shift feeding step
        ``s + 2`` is issued from them before step ``s`` counts, so three
        generations are alive: the one counted, the one the copy reads and
        the one it writes."""
        n = self.nsteps
        cur = payload
        inflight = self._shift_k(cur, 1) if n > 1 else None
        for s in range(n):
            nxt = self._shift_k(inflight, 1) if s + 2 < n else None
            self._count_grid(store, cur, arrays, s, m_cnt, step_keep, out)
            cur, inflight = inflight, nxt


def _zero_partials(like, grid):
    """The grid-shaped int64 zeros the schedule adds each position's
    counts into: one tensor on ``like``'s device, or on a mesh one 0-dim
    tensor a position, on its device."""
    if not _on_mesh(like):
        return torch.zeros(grid, dtype=torch.int64, device=like.device)
    mesh = like.mesh
    if tuple(mesh.shape) != tuple(grid):
        raise ValueError(
            f"the schedule's grid {tuple(grid)} is not the mesh's "
            f"{tuple(mesh.shape)}")
    blocks = {}
    for pos in np.ndindex(*grid):
        with placed_at(pos):
            blocks[pos] = torch.zeros((), dtype=torch.int64,
                                      device=mesh.device_at(pos))
    return MeshArray(mesh, blocks)


@dataclasses.dataclass
class CannonSchedule(ShiftSchedule):
    """Cannon's q-step {count, shift-A-left, shift-B-up} rotation.

    ``double_buffer=True`` (the default) runs the JAX package's
    communication-overlapped body on a mesh: the loop carries two payload
    generations ``(cur, inflight)``, a prologue shift puts step 1's
    blocks in flight, and at step ``s`` the shift feeding step ``s + 2``
    is issued from ``inflight`` before ``cur`` counts, into a third
    receive buffer, so the copies on the copy streams and the count
    touch disjoint buffers.  With ``double_buffer=False`` step ``s + 1``'s
    shift is issued before step ``s`` counts, from the generation that
    count reads.  A compacted schedule issues the hop to the next live
    step before the current one counts, single-buffered as in the JAX
    package.  No shift is issued that no count reads (the JAX package's
    body shifts once more at the end and discards it).  On one device a
    roll is an ordinary kernel on the same stream, with no collective to
    overlap: :meth:`run` counts, then rolls, whatever the knob.  The
    stepper (:func:`build_engine_stepper`) carries both generations on
    either realisation, so a checkpoint holds what the JAX package's
    holds.

    ``elide_shifts=True`` is a timing probe: every shift is left out, so
    each device counts the blocks it started with (counts are wrong for
    q > 1; ``tc_run --time-split``'s count-only run).

    2.5D pods (``npods > 1``): the grid is ``(npods, q, q)``, the A and B
    payload tensors carry the pod as their leading dimension, pod ``t``
    starts at skew offset ``t`` (staged by
    :func:`~repro_torch.core.cannon.pod_stack_arrays`) and runs every
    ``npods``-th shift: ``q // npods`` loop steps, each a roll by
    ``npods`` positions.  Pod ``t``'s loop step ``s`` is the global step
    ``t + s * npods``: the skip mask is read there, and the task counts
    and lists at ``(x, y)`` (:meth:`locate`).  Memory ×npods for A and B,
    shifts ÷npods — the communication-avoiding trade.
    """

    q: int
    double_buffer: bool = True
    # compacted schedule: original indices of the globally-live steps
    # (strictly increasing); ``run`` then visits only them
    live_steps: Optional[Tuple[int, ...]] = None
    npods: int = 1
    elide_shifts: bool = False

    def __post_init__(self):
        if self.npods < 1 or self.q % self.npods:
            raise ValueError(
                f"pods must divide the grid dimension: q={self.q}, "
                f"npods={self.npods}"
            )

    @property
    def grid(self) -> Tuple[int, ...]:
        if self.npods > 1:
            return (self.npods, self.q, self.q)
        return (self.q, self.q)

    @property
    def nsteps(self) -> int:
        return self.q // self.npods

    def locate(self, dev, step):
        if self.npods == 1:
            return dev, step
        t, x, y = dev
        return (x, y), t + step * self.npods

    def _shift_k(self, payload, hop: int):
        """Fused shift of ``hop`` schedule steps (one roll per tensor
        regardless of hop — the multi-hop fusion); a pod's step is
        ``npods`` Cannon shifts."""
        k = (hop * self.npods) % self.q
        if k == 0 or self.elide_shifts:
            return payload
        lead = 1 if self.npods > 1 else 0  # the pod dimension
        a_state, b_state = payload
        return (_roll_tree(a_state, k, 1 + lead),
                _roll_tree(b_state, k, 0 + lead))


@dataclasses.dataclass
class SummaSchedule(ShiftSchedule):
    """SUMMA broadcast rounds on an ``(r, c)`` grid: ``c`` rounds, each a
    panel broadcast that the store realises as a view
    (:class:`SummaCSRStore`).  Rounds carry no state, so a compacted
    schedule simply leaves the dead rounds out — no hop fusion needed."""

    r: int
    c: int
    live_steps: Optional[Tuple[int, ...]] = None

    @property
    def grid(self) -> Tuple[int, ...]:
        return (self.r, self.c)

    @property
    def nsteps(self) -> int:
        return self.c

    def _shift_k(self, payload, hop: int):
        del hop  # broadcast rounds carry no shift state
        return payload


@dataclasses.dataclass
class RingSchedule(ShiftSchedule):
    """1D ring rotation over ``p`` devices: the rotating row blocks pass
    through every device once.  A rotation by ``k`` is ``torch.roll`` by
    ``-k`` on dim 0 (the sign of :class:`CannonSchedule`'s shifts), so at
    step ``t`` device ``d`` holds owner ``(d + t) % p``'s block; the task
    count is that of its group ``(d, (d + t) % p)``.  ``elide_shifts=True``
    is the timing probe of :class:`CannonSchedule` (counts are wrong for
    p > 1)."""

    p: int
    live_steps: Optional[Tuple[int, ...]] = None
    elide_shifts: bool = False

    @property
    def grid(self) -> Tuple[int, ...]:
        return (self.p,)

    @property
    def nsteps(self) -> int:
        return self.p

    def task_count(self, m_cnt, dev, step) -> int:
        (d,) = dev
        return int(m_cnt[d, (d + step) % self.p])

    def _shift_k(self, payload, hop: int):
        k = hop % self.p
        if k == 0 or self.elide_shifts:
            return payload
        return _roll_tree(payload, k, 0)


# ======================================================================
# reductions
# ======================================================================
def pod_tree_allreduce(x, n: int, mesh=None, firsts=None):
    """Binomial-tree all-reduce over the pod dimension: dim 0 of ``x``,
    of size ``n`` (a power of two).

    The JAX package's collective of the same name, as index arithmetic on
    one tensor: log2(n) reduce rounds funnel the partials to position 0
    (in round ``k`` every position ``t`` with ``t % 2k == k`` sends to
    ``t - k``, and a position that receives nothing adds zero, as a
    ``ppermute`` delivers), then log2(n) broadcast rounds in reverse send
    the sum back (``t % 2k == 0`` sends to ``t + k``, which replaces its
    stale partial).  Every position ends holding the sum.

    On a mesh ``x`` is a list of the pods' partials, pod ``t``'s at
    position ``firsts[t]`` of ``mesh``, and every send is a copy to the
    receiver's position; the result is that list with the sum at every
    pod.
    """
    if n == 1:
        return x
    if n & (n - 1):
        raise ValueError("tree reduce needs a power-of-two axis size")
    rounds = []
    k = 1
    while k < n:
        rounds.append(k)
        k *= 2
    if isinstance(x, list):
        x = list(x)
        for k in rounds:
            for t in range(k, n, 2 * k):
                x[t - k] = x[t - k] + _send(x[t], mesh, firsts[t - k],
                                            "reduce")
        for k in reversed(rounds):
            for t in range(0, n, 2 * k):
                x[t + k] = _send(x[t], mesh, firsts[t + k], "reduce")
        return x
    pos = torch.arange(n, device=x.device).view(-1, *([1] * (x.dim() - 1)))
    for k in rounds:
        src = [t for t in range(n) if t % (2 * k) == k]
        recv = torch.zeros_like(x)
        recv[[t - k for t in src]] = sent = x[src]
        _tally("reduce", sent)
        x = x + recv
    for k in reversed(rounds):
        src = [t for t in range(n) if t % (2 * k) == 0]
        recv = torch.zeros_like(x)
        recv[[t + k for t in src]] = sent = x[src]
        _tally("reduce", sent)
        x = torch.where(pos % (2 * k) == k, recv, x)
    return x


@dataclasses.dataclass(frozen=True)
class Reduction:
    """Global sum of the per-device partials, or per-device outputs.

    ``strategy`` selects how the global sum is formed:

    * ``"flat"`` — one sum over every grid dimension;
    * ``"tree"`` — the 2.5D staged reduce: one joint sum over each pod's
      ``(q, q)`` grid, then the binomial tree over the pods
      (:func:`pod_tree_allreduce`).  Needs a power-of-two pod count > 1
      — :meth:`resolve` enforces this;
    * ``"auto"`` — ``tree`` whenever it is applicable, else ``flat``.

    The build functions pass the unresolved knob;
    :func:`build_engine_fn` binds it against the schedule's pod count via
    :meth:`resolve`.

    On a mesh (the partials a :class:`MeshArray`) every partial is copied
    to the mesh's first device and summed there (``flat``), or each pod's
    to its first device, summed, and the pods' sums sent along the tree
    (``tree``): one 0-dim tensor on the mesh's first device.
    ``global_sum=False`` gathers the grid-shaped partials there.
    """

    global_sum: bool = True
    strategy: str = "auto"  # "flat" | "tree" | "auto"
    npods: int = 1  # pod count, bound by resolve()

    def resolve(self, npods: int = 1) -> "Reduction":
        """Bind ``strategy`` and the pod count (1: no pod dimension)."""
        pow2 = npods > 1 and (npods & (npods - 1)) == 0
        strategy = self.strategy
        if strategy == "auto":
            strategy = "tree" if pow2 else "flat"
        elif strategy == "tree":
            if npods <= 1:
                raise ValueError(
                    "reduce strategy 'tree' needs a pod axis with "
                    "npods > 1; use 'flat' (or 'auto') on single-pod "
                    "grids and rings"
                )
            if not pow2:
                raise ValueError(
                    f"reduce strategy 'tree' needs a power-of-two pod "
                    f"count, got npods={npods}"
                )
        elif strategy != "flat":
            raise ValueError(
                f"unknown reduce strategy {strategy!r}; "
                "expected 'flat', 'tree', or 'auto'"
            )
        return dataclasses.replace(self, strategy=strategy, npods=npods)

    def apply(self, per_device):
        if _on_mesh(per_device):
            return self._apply_mesh(per_device)
        if not self.global_sum:
            return per_device
        _tally("reduce", per_device)
        if self.strategy == "tree":
            per_pod = per_device.flatten(1).sum(dim=1)
            return pod_tree_allreduce(per_pod, self.npods)[0]
        return per_device.sum()

    def _apply_mesh(self, per):
        mesh = per.mesh
        every = list(np.ndindex(*mesh.shape))
        if not self.global_sum:
            return _gather(per, every, every[0]).view(tuple(mesh.shape))
        if self.strategy == "tree":
            firsts = [(t,) + (0,) * (len(mesh.shape) - 1)
                      for t in range(self.npods)]
            pods = [_gather(per, [p for p in every if p[0] == t], first).sum()
                    for t, first in enumerate(firsts)]
            return pod_tree_allreduce(pods, self.npods, mesh, firsts)[0]
        return _gather(per, every, every[0]).sum()


def _gather(per, positions, at):
    """The partials of ``positions`` copied into one int64 vector at
    position ``at`` (tallied under ``reduce``)."""
    with placed_at(at):
        buf = torch.empty(len(positions), dtype=torch.int64,
                          device=per.mesh.device_at(at))
    for i, pos in enumerate(positions):
        buf[i].copy_(per.blocks[pos])
    _tally("reduce", buf)
    return buf


# ======================================================================
# hub-split partial count
# ======================================================================
class HubCount:
    """The hub-fragment partial sum of a hub-split plan.

    Runs *outside* the schedule loop, once a count: the planner's
    hub-split stage (:mod:`repro_torch.pipeline.hubsplit`) stages
    column-strided fragment CSRs + task lists per logical device, each
    device's slice is counted with the plain pair-search
    (:func:`~repro_torch.core.count.count_pair_search`, whatever the
    schedule's ``method``: fragments are intersected against each other,
    A and B alike), and the per-device partials are added to the
    schedule's before the :class:`Reduction` — so skip masks and schedule
    compaction compose untouched (hub work never revives an elided step).
    On a pod grid the hub side is pod 0's alone (the JAX package replicates
    it over the pods and zeroes it on every other): counted once, added to
    pod 0's partials, so the global sum holds it once.
    The work sits inside ``torch.profiler.record_function("tc_hub")``, so
    a profile splits it from the schedule.  ``hub_cnt`` is the hub side's
    *host* task counts, read like the plan's ``m_cnt``.
    """

    names = ("hub_indptr", "hub_indices", "hub_ti", "hub_tj", "hub_cnt")

    def __init__(self, *, dpad: int, chunk: int, sentinel: int,
                 hub_cnt: np.ndarray, probe_shorter: bool = True):
        self.dpad = int(dpad)
        self.chunk = int(chunk)
        self.sentinel = int(sentinel)
        self.hub_cnt = np.asarray(hub_cnt)
        self.probe_shorter = probe_shorter

    @classmethod
    def from_plan(cls, plan, *, probe_shorter: bool = True):
        h = getattr(plan, "hub", None)
        if h is None:
            return None
        return cls(
            dpad=h.dpad, chunk=h.chunk, sentinel=h.sentinel,
            hub_cnt=h.hub_cnt, probe_shorter=probe_shorter,
        )

    def count(self, arrays, out):
        """Add every logical device's hub partial to ``out`` (the
        grid-shaped int64 per-device counts; on a pod grid pod 0's) in
        place."""
        ptr, idx = arrays["hub_indptr"], arrays["hub_indices"]
        # pod 0's positions: on one device the pod dimension leads the
        # partials only; on a mesh every array is indexed by position
        pod0 = () if out.dim() == self.hub_cnt.ndim else (0,)
        mesh = _on_mesh(ptr)
        with torch.profiler.record_function("tc_hub"):
            for dev in np.ndindex(*self.hub_cnt.shape):
                cnt = int(self.hub_cnt[dev])
                if cnt <= 0:
                    continue
                at = pod0 + dev if mesh else dev
                with placed_at(pod0 + dev):
                    out[pod0 + dev] += count_mod.count_pair_search(
                        ptr[at], idx[at], ptr[at], idx[at],
                        arrays["hub_ti"][at], arrays["hub_tj"][at], cnt,
                        dpad=self.dpad, chunk=self.chunk,
                        probe_shorter=self.probe_shorter,
                        sentinel=self.sentinel,
                    )
        return out


# ======================================================================
# building the counting function
# ======================================================================
def build_engine_fn(
    store: OperandStore,
    schedule: ShiftSchedule,
    *,
    m_cnt: np.ndarray,
    step_keep: Optional[np.ndarray] = None,
    reduction: Optional[Reduction] = None,
    batched: bool = False,
    hub: Optional[HubCount] = None,
    mesh: Optional[DeviceMesh] = None,
):
    """Generate the counting function for one composition.

    Returns ``call(**arrays)`` over the staged plan tensors (stacked over
    the schedule's grid, all on one device) yielding the global count as a
    0-dim int64 tensor on that device — or the grid-shaped per-device
    counts with ``Reduction(global_sum=False)``.  The call does not
    synchronise; ``int(result)`` does, once.

    The same call runs over :class:`MeshArray` s staged on a
    :class:`~repro_torch.launch.mesh.DeviceMesh` whose shape is the
    schedule's grid (``PlanArtifact.staged(mesh)``); the result then lies
    on the mesh's first device.  With ``mesh`` the call takes arrays
    staged on that mesh only.

    ``m_cnt`` and ``step_keep`` are the plan's *host* arrays: the loop
    reads task counts and the skip mask from them, never from the
    device.  ``m_cnt`` is indexed as the schedule reads it
    (:meth:`ShiftSchedule.task_count`: per device for Cannon and SUMMA,
    per (device, owner group) for the ring).  ``step_keep=None`` runs
    every (device, step) pair.  ``hub`` adds the hub-split partial
    (:class:`HubCount`) and the ``hub_*`` arrays to the call.

    ``batched=True`` builds the multi-graph variant: every staged tensor,
    ``m_cnt`` and ``step_keep`` carry a leading batch dimension (graphs
    padded to shared maxima and stacked by
    :mod:`repro_torch.pipeline.batch`), the schedule runs graph by graph,
    each with its own task counts and mask, and the call returns the
    ``(batch,)`` int64 vector of global counts.

    The host arrays are bound into the call; ``call.rebind(m_cnt=...,
    step_keep=..., hub=...)`` returns the same composition over other
    host arrays (a spliced plan's, in the delta path).
    """
    reduction = (reduction or Reduction()).resolve(
        getattr(schedule, "npods", 1))
    if batched:
        if hub is not None:
            raise ValueError(
                "batched engines do not take hub-split plans (per-graph hub "
                "sides differ; plan with hub_split=False)"
            )
        if not reduction.global_sum:
            raise ValueError("batched engine returns per-graph global counts")
        if schedule.live_steps is not None:
            raise ValueError(
                "batched engines use the scan body (per-graph masks differ; "
                "compaction would need their union)"
            )
    if mesh is not None and tuple(mesh.shape) != tuple(schedule.grid):
        raise ValueError(
            f"the schedule's grid {tuple(schedule.grid)} needs a mesh of that "
            f"shape, got {tuple(mesh.shape)}")
    return _bind_engine_fn(store, schedule, reduction, batched, m_cnt,
                           step_keep, hub, mesh)


def _graph_of(array, b: int):
    """Graph ``b`` of a batched staged array: the leading dimension of a
    tensor, or of every block of a :class:`MeshArray`."""
    return array.map(lambda t: t[b]) if _on_mesh(array) else array[b]


def _bind_engine_fn(store, schedule, reduction, batched, m_cnt, step_keep,
                    hub, mesh=None):
    """The counting function of :func:`build_engine_fn` over one set of
    host arrays (task counts, skip mask, hub side)."""
    m_cnt = np.asarray(m_cnt)
    keep = None if step_keep is None else np.asarray(step_keep, dtype=bool)
    ordered = list(store.names)
    if hub is not None:
        ordered += list(hub.names)

    def check(arrays):
        missing = [k for k in ordered if k not in arrays]
        if missing:
            raise KeyError(f"engine call is missing plan arrays {missing}")
        placed = [_on_mesh(arrays[k]) for k in ordered]
        if any(placed):
            meshes = {arrays[k].mesh for k, on in zip(ordered, placed) if on}
            if not all(placed) or len(meshes) != 1:
                raise ValueError("plan arrays are not all on one mesh")
            if mesh is not None and meshes != {mesh}:
                raise ValueError("plan arrays are staged on another mesh "
                                 "than the one this function was built for")
            return
        if mesh is not None:
            raise ValueError("this function was built for a mesh: stage the "
                             "plan arrays on it (PlanArtifact.staged(mesh))")
        devices = {arrays[k].device for k in ordered}
        if len(devices) != 1:
            raise ValueError(f"plan arrays live on several devices: {devices}")

    def core(arrays, cnt, mask):
        per_device = schedule.run(store, arrays, m_cnt=cnt, step_keep=mask)
        if hub is not None:
            hub.count(arrays, per_device)
        return reduction.apply(per_device)

    if batched:

        def call(**arrays):
            check(arrays)
            return torch.stack([
                core({k: _graph_of(arrays[k], b) for k in ordered}, m_cnt[b],
                     None if keep is None else keep[b])
                for b in range(m_cnt.shape[0])
            ])
    else:

        def call(**arrays):
            check(arrays)
            return core(arrays, m_cnt, keep)

    def rebind(*, m_cnt, step_keep=None, hub=None):
        """This function over other host arrays: a new callable with the
        same store (and so the same bound kernel), schedule (the same
        compacted live list) and reduction that reads ``m_cnt``, the skip
        mask ``step_keep`` and the hub side ``hub`` (a :class:`HubCount`
        or ``None``).  A function built without the skip mask stays
        without it, whatever ``step_keep`` is.  The delta path hands a
        parent artifact's functions to a spliced plan this way."""
        return _bind_engine_fn(
            store, schedule, reduction, batched, m_cnt,
            None if keep is None else step_keep, hub, mesh,
        )

    call.ordered = ordered
    call.mesh = mesh
    call.store, call.schedule = store, schedule
    call.m_cnt, call.step_keep, call.hub = m_cnt, keep, hub
    call.rebind = rebind
    return call


# ======================================================================
# the shift-at-a-time stepper (checkpointed runs)
# ======================================================================
def _leaves(tree) -> list:
    """The tensors of a payload (nested tuples), depth first."""
    if isinstance(tree, tuple):
        return [t for part in tree for t in _leaves(part)]
    return [tree]


def _unleaves(template, leaves) -> tuple:
    """``template``'s nesting over ``leaves`` (consumed in order)."""
    if isinstance(template, tuple):
        return tuple(_unleaves(part, leaves) for part in template)
    return leaves.pop(0)


def _bare(t):
    """A mesh leaf of a stepper's state without the call's receive ring
    and generation: the next call allocates its own ring, so no call
    writes into a state the caller still holds (on one device every roll
    is a new tensor)."""
    return MeshArray(t.mesh, t.blocks) if _on_mesh(t) else t


def build_engine_stepper(
    store: OperandStore,
    schedule: ShiftSchedule,
    *,
    m_cnt: np.ndarray,
    step_keep: Optional[np.ndarray] = None,
    mesh: Optional[DeviceMesh] = None,
):
    """One-schedule-step-at-a-time variant for fault-tolerant runs.

    Executes one step of ``schedule`` a call with the loop's carry held
    by the caller as explicit tensors, so the host loop owns the shift
    index and can checkpoint state between shifts (a restarted job
    resumes mid-loop).  Returns ``one_shift(state, statics, step=s) ->
    state`` where ``state = (*carry, acc)``: ``acc`` is the grid-shaped
    per-device partial counts (int64 ``(q, q)`` on Cannon; the result
    keeps the caller's dtype) and ``carry`` the payload tensors, stacked
    over the grid as the engine stages them.  ``statics`` holds the
    store's static tensors (``m_ti``, ``m_tj``, ...) on the device;
    ``m_cnt`` and ``step_keep`` are the plan's *host* arrays, bound here
    and read on the host as :func:`build_engine_fn` reads them.

    With ``mesh`` (a :class:`~repro_torch.launch.mesh.DeviceMesh` of the
    schedule's grid) the state and the statics are :class:`MeshArray` s
    staged on it (``PlanArtifact.staged(mesh)``): every carry leaf holds
    each position's block on its device and a shift copies them between
    positions (:func:`tree_ppermute`), and ``acc`` holds each position's
    0-dim int64 partial on its device.  Position for position the state
    is the one-device stepper's, so a checkpoint of either is the same
    bytes (:mod:`repro_torch.ckpt`).  No call reads a count back to the
    host: the caller sums ``acc`` once, at the end.

    With a ``double_buffer`` schedule (and no compaction) the carry is
    two payload generations, as in the JAX package's scan body: the
    current one, counted at step ``s``, and the next one, already shifted
    for step ``s + 1``; each call issues the second's shift on, then
    counts the first.  Both round-trip through a checkpoint like any other
    state.  On a mesh a call's copies run on the copy streams beside its
    count (:mod:`repro_torch.core.lanes`), and every compute stream waits
    for them before the call returns: a checkpoint of the state it
    returns reads finished copies.

    ``one_shift.prime(operands) -> carry`` builds the step-0 carry from
    the staged operand tensors (issuing the prologue shift);
    ``one_shift.n_carry`` is the number of carry tensors.  With a
    *compacted* schedule (``schedule.live_steps`` set) the host loop
    iterates ``one_shift.live_steps`` only, still passing the
    **original** step index — mask lookups need no remapping, and a
    checkpointed step index round-trips unchanged — and each call shifts
    by the fused hop to the *next* live step (none after the last).
    """
    m_cnt = np.asarray(m_cnt)
    keep = None if step_keep is None else np.asarray(step_keep, dtype=bool)
    live = schedule.live_steps
    double = getattr(schedule, "double_buffer", False)
    if double and live is not None:
        raise ValueError("the compacted stepper runs single-buffered")
    if mesh is not None and tuple(mesh.shape) != tuple(schedule.grid):
        raise ValueError(
            f"the schedule's grid {tuple(schedule.grid)} needs a mesh of that "
            f"shape, got {tuple(mesh.shape)}")
    op_names = list(store.operand_names)
    payload0 = store.payload({k: k for k in op_names})
    template = (payload0, payload0) if double else payload0
    n_carry = len(_leaves(template))

    def placed(arrays):
        """Refuse arrays staged elsewhere than the stepper was built for."""
        if {t.mesh if _on_mesh(t) else None for t in arrays} != {mesh}:
            where = "one device" if mesh is None else "a mesh"
            raise ValueError(
                f"the stepper was built for {where}: stage its state and "
                "statics there (PlanArtifact.staged)")

    def prime(operands):
        placed([operands[k] for k in op_names])
        payload = store.payload({k: operands[k] for k in op_names})
        # the prologue: step 1's blocks in flight before step 0, or the
        # hop to the first live step
        hop = live[0] if live else int(double)
        payload = _ringed(payload, int(hop > 0))
        with lanes_mod.lanes(mesh):
            if hop:
                shifted = schedule._shift_k(payload, hop)
                payload = (payload, shifted) if double else shifted
        return tuple(_bare(t) for t in _leaves(payload))

    def one_shift(state, statics, step=0):
        *carry, acc = state
        if len(carry) != n_carry:
            raise ValueError(
                f"stepper state holds {len(carry)} carry tensors, "
                f"expected {n_carry}"
            )
        placed(list(carry) + [acc] + list(statics.values()))
        step = int(step)
        hop = 1
        if live is not None:
            i = live.index(step)  # the host loop must pass a live step
            hop = live[i + 1] - live[i] if i + 1 < len(live) else 0
        carry = _unleaves(template, list(carry))
        acc = acc.map(torch.clone) if _on_mesh(acc) else acc.clone()
        # double-buffered, step s + 2's shift is issued before step s
        # counts; single-buffered, step s + 1's
        cur, moving = carry if double else (carry, carry)
        moving = _ringed(moving, int(hop > 0))
        with lanes_mod.lanes(mesh):  # joined before the state is returned
            shifted = schedule._shift_k(moving, hop)
            schedule._count_grid(store, cur, statics, step, m_cnt, keep, acc)
        nxt = (moving, shifted) if double else shifted
        return tuple(_bare(t) for t in _leaves(nxt)) + (_bare(acc),)

    one_shift.prime = prime
    one_shift.n_carry = n_carry
    one_shift.live_steps = live
    return one_shift
