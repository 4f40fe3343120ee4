"""The card's roofline constants, from the data sheet and as measured.

``HW`` holds the published rates of the card the port targets, an NVIDIA
H100 SXM (NVIDIA's H100 data sheet, dense rates without sparsity, at the
full 700 W power limit).  A least-time bound is the larger of the bytes a
function must move over ``hbm_bw`` and the operations it does over the
peak rate of their type.  :func:`measure_hw` times what one card reaches
in practice — a device-to-device copy and a bf16 matrix product — so a
bound can be read against both.

The JAX package reads the bytes its collectives move from the compiled
XLA program (``collective_phases`` over the HLO's named scopes).  The
port has no compiled program to read: it counts its bytes where it moves
them (:func:`repro_torch.core.engine.tally_moved_bytes`), and
:func:`collective_phases` reads that tally over one call of an engine
function.

The JAX package's dry run fills a :class:`RooflineReport` from a compiled
program (``roofline_from_compiled``: XLA's cost and memory analyses and a
loop-aware walk of the HLO).  The port compiles no program.  Its
counterpart is :func:`walk_engine`: one call of an engine function over
``meta`` tensors, run through the engine's real stores, schedules, kernels
and reduction, with every aten op counted as it is dispatched —
operations, bytes, the engine's byte tally and the live bytes of every
tensor it makes — and :func:`roofline_from_walk` fills the report from
that.  A meta tensor has a shape and a dtype and no data, so the walk
allocates nothing and reads no value; it is on ``meta`` by design, never
in place of a card.

A model step (the LM, GNN and recsys steps of ``models/``) is walked the
same way by :func:`walk_step`, which also counts the products' FLOPs by
operand dtype; :func:`combine_walks` carries walks of a few small
depths and microbatch counts to a config's own, and
:func:`roofline_from_step` fills the report.  The JAX package's readers
of HLO text (``hlo_cost``, ``collective_bytes``, ``collective_by_source``
and its text-reading ``collective_phases``, here
``hlo_collective_phases``) are copied in :mod:`.hlo` and exported here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import sys
import weakref
from collections import Counter
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .hlo import (collective_by_source, collective_bytes,  # noqa: F401
                  hlo_collective_phases, hlo_cost, infer_num_devices)

__all__ = ["HW", "measure_hw", "collective_phases", "RooflineReport",
           "EngineWalk", "CardWalk", "walk_engine", "roofline_from_walk",
           "card_memory_bytes", "StepWalk", "walk_step", "combine_walks",
           "tree_tensors", "shard_bytes", "roofline_from_step", "model_flops_lm",
           "infer_num_devices", "hlo_cost", "collective_bytes",
           "collective_by_source", "hlo_collective_phases"]

HW = dict(
    # H100 SXM, device memory (HBM3): 3.35 TB/s (data sheet)
    hbm_bw=3.35e12,
    # H100 SXM, bf16 dense tensor-core peak: 989 TFLOP/s (data sheet)
    peak_flops=989e12,
    # H100 SXM, 32-bit rate outside the tensor cores: 67 TFLOP/s (data
    # sheet, fp32); the bound of 32-bit integer compares and searches
    fp32_ops=67e12,
    # H100 SXM, device memory: 80 GB of HBM3 (data sheet); what the dry
    # run holds a grid against where no card is present
    hbm_bytes=80e9,
)

_COPY_BYTES = 1 << 30  # a 1 GiB device-to-device copy
_MATMUL_N = 8192  # a bf16 8192 x 8192 x 8192 product
_REPS = 5


def _best_seconds(fn, reps: int = _REPS) -> float:
    """Least device seconds of ``fn()`` over ``reps`` runs after one
    warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) * 1e-3)
    return best


def measure_hw(device=None) -> dict:
    """Time the card's memory and bf16 rates on ``device`` (a CUDA
    device; default the current one).

    ``hbm_bw``: a copy of a 1 GiB buffer into another, counted as the
    bytes read plus the bytes written, over the least of 5 timed copies.
    ``peak_flops``: a bf16 ``torch.matmul`` of two 8192 x 8192 matrices,
    ``2 * 8192**3`` FLOP over the least of 5 timed products.  Refuses a
    device that is not a CUDA device: no rate of the card is measured
    anywhere else.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"measure_hw times a CUDA device, got {device}")
    with torch.cuda.device(device):
        src = torch.empty(_COPY_BYTES, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        copy_s = _best_seconds(lambda: dst.copy_(src))
        del src, dst
        n = _MATMUL_N
        gen = torch.Generator(device=device).manual_seed(0)
        a = torch.randn(n, n, device=device, dtype=torch.bfloat16,
                        generator=gen)
        b = torch.randn(n, n, device=device, dtype=torch.bfloat16,
                        generator=gen)
        mm_s = _best_seconds(lambda: torch.matmul(a, b))
        del a, b
    return dict(
        device_name=torch.cuda.get_device_name(device),
        hbm_bw=2 * _COPY_BYTES / copy_s,
        copy_bytes=_COPY_BYTES,
        copy_seconds=copy_s,
        peak_flops=2.0 * n**3 / mm_s,
        matmul_n=n,
        matmul_seconds=mm_s,
        reps=_REPS,
        datasheet=dict(HW),
    )


def collective_phases(fn, arrays) -> Dict[str, int]:
    """Bytes one call ``fn(**arrays)`` of an engine function moves, by
    engine phase: always the four keys ``shift`` (every tensor a shift
    rolls), ``broadcast`` (0: a SUMMA panel broadcast is a view),
    ``reduce`` (the partials the final sum reads) and ``other`` (the
    blobs packed before the count).  Each is the whole logical grid's
    bytes on the one card that holds it; the JAX package charges a
    permute ``size * npairs / ndev``, one device's share."""
    from ..core.engine import tally_moved_bytes

    with tally_moved_bytes() as moved:
        fn(**arrays)
    return dict(moved)


# ======================================================================
# the dry run: a walk of an engine function on meta tensors
# ======================================================================
@dataclasses.dataclass
class RooflineReport:
    """The JAX package's dry-run row, field for field, plus the two keys
    that holding the whole logical grid on one card makes necessary:
    ``grid_bytes`` (the walk's peak live bytes on the card) and ``fits``
    (``grid_bytes`` against the card's memory)."""

    name: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float = 0.0
    useful_fraction: float = 0.0
    memory_per_device: Optional[dict] = None
    grid_bytes: int = 0
    fits: bool = False

    def row(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class EngineWalk:
    """What one walked call of an engine function did, for its whole
    logical grid.

    ``ops``: one operation per output element of every aten op that is
    not a view, and ``ceil(log2 width)`` per element of a
    ``searchsorted`` over rows of ``width``.  ``bytes``: what those ops
    read and write, each tensor argument and result once, except that a
    gather reads only the elements it gathers and a search only the
    ``ceil(log2 width)`` keys a query probes.  ``moved``: the engine's own
    byte tally (:func:`~repro_torch.core.engine.tally_moved_bytes`:
    ``shift``, ``broadcast``, ``reduce``, ``other``).  ``staged_bytes``:
    every argument tensor's bytes; ``args_per_device``: one logical
    device's share of them.  ``step_temps``: the most bytes live during one
    device-step above those live when it began.  ``peak_bytes``: the most
    bytes live at once during the call, arguments included.
    ``device_steps``: device-steps counted.  ``searched``: searches by
    the dtype of the keys searched.  ``cards``: on a device mesh, what
    each card held (:class:`CardWalk`), by card; ``None`` on one device.
    On a mesh ``args_per_device`` is the largest grid position's staged
    bytes, and ``step_temps`` and ``peak_bytes`` are the whole mesh's.
    """

    grid: Tuple[int, ...]
    ops: float
    bytes: float
    moved: Dict[str, int]
    staged_bytes: int
    args_per_device: int
    step_temps: int
    peak_bytes: int
    output_bytes: int
    device_steps: int
    searched: Dict[str, float]
    sampled: bool
    cards: Optional[Dict[Hashable, "CardWalk"]] = None


@dataclasses.dataclass
class CardWalk:
    """What one card of a device mesh held during a walked call, in bytes.

    ``positions``: the grid positions on the card.  ``staged_bytes``:
    their staged blocks.  ``payload_bytes``: the payload the store packed
    there for the run (the blobs).  ``ring_bytes``: the receive buffers
    the run allocated there before its entry.  ``step_temps``: the most
    bytes one device-step there made above those live when it began.
    ``peak_bytes``: the most bytes live there at once, the staged blocks
    included; it holds whatever else the call made there too (the
    partials, a SUMMA round's received panels, the gathered partials on
    the card the sum lands on)."""

    positions: Tuple[Tuple[int, ...], ...]
    staged_bytes: int
    payload_bytes: int
    ring_bytes: int
    step_temps: int
    peak_bytes: int


# ops that read a tensor's values: a meta tensor has none
_VALUE_READS = frozenset({
    "_local_scalar_dense", "item", "nonzero", "is_nonzero", "equal",
    "masked_select", "_unique2", "unique_dim", "unique_consecutive",
    "_assert_async",
})
# the products whose FLOPs a step's walk counts, as the JAX package's
# ``hlo_cost`` counts its ``dot``s: the matrix products, and the
# matrix-vector and vector products that ``matmul`` gives a 1-D operand
_PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "mv", "addmv",
                       "dot", "vdot"})
# the products whose first operand is the bias they add to
_BIASED = frozenset({"addmm", "baddbmm", "addmv"})
# ops that read only the elements they gather from their first argument
_GATHERS = frozenset({"index", "gather", "index_select", "take",
                      "embedding"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_flops(func, args, kwargs, out) -> int:
    """A product's FLOPs: ``torch.utils.flop_counter``'s formula for a
    matrix product (``2 * m * n * k``, batched for ``bmm``), and
    ``2 * n * k`` for ``mv`` / ``addmv`` and ``2 * k`` for ``dot`` /
    ``vdot``, which the registry lacks."""
    base = func._overloadpacket.__name__
    if base in ("mv", "addmv", "dot", "vdot"):
        return 2 * args[1 if base == "addmv" else 0].numel()
    from torch.utils.flop_counter import flop_registry

    return int(flop_registry[func._overloadpacket](*args, **kwargs,
                                                   out_val=out))


@functools.lru_cache(maxsize=None)
def _op_kind(func) -> Tuple[str, bool]:
    """An aten op's base name, and whether it only makes a view (its
    result aliases an argument it does not write)."""
    schema = func._schema
    writes = any(a.alias_info is not None and a.alias_info.is_write
                 for a in schema.arguments)
    view = not writes and any(r.alias_info is not None
                              for r in schema.returns)
    return func._overloadpacket.__name__, view


def _tensors(items, out=None) -> list:
    """The tensors among ``items`` and in the lists and tuples among them
    (an aten op's arguments nest one level: ``Tensor?[]``)."""
    out = [] if out is None else out
    for o in items:
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (list, tuple)):
            out.extend(t for t in o if isinstance(t, torch.Tensor))
    return out


class _Walk(TorchDispatchMode):
    """Counts every aten op with a result on ``device`` (ops and bytes, at
    the current ``weight``) and the live bytes of every storage there.

    With ``card_of`` (a device mesh: grid position to card) the devices
    are the mesh's, and every storage is also charged to the card of the
    grid position it belongs to: the engine's :func:`placed_at` where it
    says, else the one position of the storages the op read."""

    def __init__(self, device: Optional[torch.device], *, mesh=None,
                 card_of: Optional[Dict[tuple, Hashable]] = None):
        super().__init__()
        self.device = device
        self.devices = ({device} if mesh is None else set(mesh.devices))
        self.mesh = mesh
        self.card_of = card_of
        self.card_live: Counter = Counter()
        self.card_peak: Counter = Counter()
        self.card_temps: Counter = Counter()
        self._places: Dict[int, tuple] = {}
        self.step_card: Optional[Hashable] = None
        self.step_peak = 0
        self.last_step_temps = 0
        self.weight = 1
        self.ops = 0.0
        self.bytes = 0.0
        self.device_steps = 0
        self.searched: Counter = Counter()
        self.live = 0
        self.peak = 0
        self.step_temps = 0
        self.counting = True
        self.flops: Counter = Counter()
        self.segment = ""
        self.points: Optional[Dict[tuple, list]] = None
        self._storages: Dict[int, Tuple[int, Optional[Hashable]]] = {}

    # -- memory --------------------------------------------------------
    def track(self, t: torch.Tensor, place: Optional[tuple] = None,
              read=(), op: str = "") -> None:
        """Count ``t``'s storage live from now until it is freed; on a mesh
        charge it to the card of grid position ``place``, or of the
        position :func:`placed_at` names, or of the one position of the
        storages of ``read`` (the op's inputs)."""
        if t.device not in self.devices:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        card = None
        if self.card_of is not None:
            pos = self._place(t, place, read, op)
            self._places[key] = pos
            card = self.card_of[pos]
            self.card_live[card] += n
            self.card_peak[card] = max(self.card_peak[card],
                                       self.card_live[card])
            if card == self.step_card:
                self.step_peak = max(self.step_peak, self.card_live[card])
        self._storages[key] = (n, card)
        self.live += n
        self.peak = max(self.peak, self.live)
        if self.points is not None:
            self.points.setdefault(self._point(), []).append(self.live)
        weakref.finalize(st, self._free, key, n)

    def _place(self, t, place, read, op) -> tuple:
        """The grid position ``t`` belongs to (see :meth:`track`), checked
        against the device it lies on."""
        from ..core.engine import current_place

        pos = place if place is not None else current_place()
        if pos is None:
            seen = {self._places.get(id(r.untyped_storage())) for r in read
                    if r.device in self.devices} - {None}
            if len(seen) != 1:
                raise ValueError(
                    f"the walk cannot tell which grid position a tensor made "
                    f"by aten.{op} belongs to: it read "
                    f"{sorted(seen) or 'no placed tensor'} outside "
                    "engine.placed_at")
            (pos,) = seen
        pos = tuple(int(i) for i in pos)
        if self.mesh.device_at(pos) != t.device:
            raise ValueError(
                f"a tensor of grid position {pos} lies on {t.device}, not on "
                f"the position's {self.mesh.device_at(pos)}")
        return pos

    def touch(self, temps: int) -> None:
        """What a device-step that made ``temps`` bytes above those live
        would add to the peaks, without making them: a replayed step of a
        sampled walk, on the card of the position :func:`placed_at`
        names."""
        from ..core.engine import current_place

        card = self.card_of[current_place()]
        self.card_peak[card] = max(self.card_peak[card],
                                   self.card_live[card] + temps)
        self.card_temps[card] = max(self.card_temps[card], temps)
        self.peak = max(self.peak, self.live + temps)

    def _point(self) -> tuple:
        """Where in the program a tensor is being made: the segment, the
        autograd node running (``""`` outside the backward) and the chain
        of the port's frames on the stack, innermost first, each its
        function and line, up to the walked step.  Every layer of a stack
        and every microbatch runs the same code, so a point is the same at
        every depth."""
        node = torch._C._current_autograd_node()
        chain = []
        f = sys._getframe(1)
        while f is not None and f.f_code is not walk_step.__code__:
            if (f.f_code.co_filename != __file__
                    and f.f_globals.get("__name__", "").startswith(
                        "repro_torch.")):
                chain.append((f.f_code.co_qualname, f.f_lineno))
            f = f.f_back
        return (self.segment, node.name() if node is not None else "",
                tuple(chain))

    def _free(self, key: int, n: int) -> None:
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live -= n
            if entry[1] is not None:
                self.card_live[entry[1]] -= n
                self._places.pop(key, None)

    # -- cost ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        base, view = _op_kind(func)
        ins = _tensors(kwargs.values(), _tensors(args))
        if base in _VALUE_READS and any(t.device.type == "meta" for t in ins):
            raise RuntimeError(
                f"the dry run's walk reached aten.{base}, which reads a "
                "tensor's values; a meta tensor has none")
        out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        for t in outs:
            self.track(t, read=ins, op=base)
        if self.counting and outs and not view and any(
                t.device in self.devices for t in outs):
            self._cost(base, args, ins, outs)
            if base in _PRODUCTS:
                operand = args[1] if base in _BIASED else args[0]
                self.flops[str(operand.dtype)] += self.weight * \
                    _product_flops(func, args, kwargs, out)
        return out

    def _cost(self, base, args, ins, outs) -> None:
        n_out = sum(t.numel() for t in outs)
        wrote = sum(_nbytes(t) for t in outs)
        if base == "searchsorted":
            seq = args[0]
            depth = max(1, math.ceil(math.log2(max(seq.shape[-1], 1))))
            ops = n_out * depth
            read = min(_nbytes(seq), n_out * depth * seq.element_size())
            read += sum(_nbytes(t) for t in ins if t is not seq)
            self.searched[str(seq.dtype)] += self.weight * n_out
        elif base in _GATHERS:
            src = args[0]
            ops = n_out
            read = wrote + sum(_nbytes(t) for t in ins if t is not src)
        else:
            ops = n_out
            read = sum(_nbytes(t) for t in ins)
        self.ops += self.weight * ops
        self.bytes += self.weight * (read + wrote)

    # -- sampling ------------------------------------------------------
    def sample_chunks(self, live: int, chunk: int):
        """The first full chunk, weighted by all full chunks but one, the
        second, and the ragged last one
        (:func:`repro_torch.core.count.sample_task_chunks`).  Every full
        chunk has the same shapes, and a chunk's peak holds what the one
        before it left live, so the two full chunks and the ragged one
        give the ops, bytes and peak of them all."""
        full, ragged = divmod(live, chunk)
        outer = self.weight
        try:
            if full:
                self.weight = outer * (full - 1) if full > 1 else outer
                yield 0, chunk
            if full > 1:
                self.weight = outer
                yield chunk, chunk
            if ragged:
                self.weight = outer
                yield full * chunk, ragged
        finally:
            self.weight = outer

    def _totals(self, moved):
        return (self.ops, self.bytes, self.device_steps,
                dict(moved), Counter(self.searched))

    def replayed(self, method, moved, fresh: bool = False,
                 real: int = 1):
        """``method`` run for real on its first ``real`` calls; every later
        call adds what the last real one added to the counts and the tally
        and, without running it, returns that call's result — or with
        ``fresh`` a new uncounted tensor like it, live while the caller
        holds it, as a per-device count's result is (the shapes are the
        same).  A second real call sees what the first left live, as every
        later call would."""
        rec = None
        calls = 0

        def wrapper(*args, **kw):
            nonlocal rec, calls
            calls += 1
            if calls <= real:
                ops, byts, steps, mv, srch = self._totals(moved)
                out = method(*args, **kw)
                like = out
                if fresh:  # hold its shape, not the tensor
                    like = (tuple(out.shape), out.dtype, out.device)
                rec = (self.ops - ops, self.bytes - byts,
                       self.device_steps - steps,
                       {k: moved[k] - mv[k] for k in moved},
                       self.searched - srch, like, self.last_step_temps)
                return out
            self.ops += rec[0]
            self.bytes += rec[1]
            self.device_steps += rec[2]
            for k, v in rec[3].items():
                moved[k] += v
            self.searched.update(rec[4])
            if fresh and self.card_of is not None:
                self.touch(rec[6])  # a count: the card sees its temps
            if fresh:
                shape, dtype, device = rec[5]
                self.counting = False
                try:
                    return torch.empty(shape, dtype=dtype, device=device)
                finally:
                    self.counting = True
            return rec[5]

        return wrapper

    def in_segment(self, name: str, fn):
        """``fn`` with the tensors made during its calls kept under the
        segment ``name`` in ``points`` (``""``: outside every segment)."""

        def wrapper(*args, **kw):
            outer, self.segment = self.segment, name
            try:
                return fn(*args, **kw)
            finally:
                self.segment = outer

        return wrapper

    def device_step(self, count):
        """``count`` (a store's per-device count) counted as one
        device-step, with its own peak live bytes."""

        def wrapper(*args, **kw):
            self.device_steps += self.weight
            live0, peak0 = self.live, self.peak
            self.peak = self.live
            if self.card_of is not None:
                from ..core.engine import current_place

                self.step_card = self.card_of[current_place()]
                card0 = self.step_peak = self.card_live[self.step_card]
            try:
                return count(*args, **kw)
            finally:
                self.step_temps = max(self.step_temps, self.peak - live0)
                self.peak = max(peak0, self.peak)
                if self.card_of is not None:
                    self.last_step_temps = self.step_peak - card0
                    self.card_temps[self.step_card] = max(
                        self.card_temps[self.step_card], self.last_step_temps)
                    self.step_card = None

        return wrapper


@contextlib.contextmanager
def _on_instance(obj, name, value):
    """``obj.name`` is ``value`` while the block runs (an instance
    attribute shadowing the class's method)."""
    missing = object()
    old = obj.__dict__.get(name, missing)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if old is missing:
            delattr(obj, name)
        else:
            setattr(obj, name, old)


def _device_share(t: torch.Tensor, grid: Tuple[int, ...]) -> int:
    """One logical device's bytes of a staged tensor: its slice over the
    grid, or on a pod grid over the ``(q, q)`` grid the pods share (the
    task lists are not stacked over the pods)."""
    n = len(grid)
    if tuple(t.shape[:n]) == tuple(grid):
        return _nbytes(t) // math.prod(grid)
    if n > 1 and tuple(t.shape[:n - 1]) == tuple(grid[1:]):
        return _nbytes(t) // math.prod(grid[1:])
    raise ValueError(
        f"a staged tensor of shape {tuple(t.shape)} does not lead with "
        f"the grid {grid}")


def _check_uniform(fn) -> None:
    """A sampled walk stands one device-step for all of them: refuse a
    function whose device-steps can differ."""
    cnt = np.asarray(fn.m_cnt)
    if (fn.step_keep is not None or fn.schedule.live_steps is not None
            or getattr(fn, "hub", None) is not None
            or (cnt.size and (cnt != cnt.flat[0]).any())):
        raise ValueError(
            "a sampled walk is exact only when every device-step has the "
            "same shapes (equal task counts, no skip mask, no compacted "
            "schedule, no hub side); walk this function with sample=False")


def walk_engine(fn, arrays: Dict[str, torch.Tensor], *,
                sample: bool = False,
                cards: Optional[Callable[[tuple], Hashable]] = None
                ) -> EngineWalk:
    """One call ``fn(**arrays)`` of an engine function
    (:func:`~repro_torch.core.engine.build_engine_fn`) walked op by op:
    its ops, bytes, the engine's byte tally and its live bytes
    (:class:`EngineWalk`).

    The call runs the function's own store, schedule, kernel and
    reduction, so a change to the engine changes the walk.  The dry run
    passes ``meta`` tensors (a plan's ``shape_structs()``): nothing is
    allocated, and an op that would read a value raises.  Tensors of a
    small plan on another device walk the same way, which is how the
    walk is checked against a real count.  The task counts and skip mask
    are the function's host arrays, so a function bound to an analytic
    plan's all-zero ``m_cnt`` counts nothing and is refused: rebind it
    first (``fn.rebind(m_cnt=...)``).

    ``arrays`` may be a mesh count's staged arrays, every one a
    :class:`~repro_torch.core.engine.MeshArray` over one
    :class:`~repro_torch.launch.mesh.DeviceMesh` (on any devices, ``meta``
    too).  The walk then also keeps each card's books
    (``EngineWalk.cards``, a :class:`CardWalk` a card): ``cards(pos)``
    names the card of grid position ``pos``, by default the device it
    lies on; ``cards=lambda pos: pos`` puts each position on a card of
    its own, as the JAX package's mesh places them.

    ``sample=True`` walks what repeats once and adds it again for every
    repeat: one device-step (its first two full task chunks and its
    ragged last one, the first weighted by the full chunks it stands
    for), the first schedule step over the whole grid, and the first
    shift.  On a mesh every later device-step of the first schedule step
    adds the walked one's temps to its card's peak.  It is exact where
    every device-step has the same shapes (an analytic plan), and refused
    anywhere else.
    """
    from ..core import count as count_mod
    from ..core import engine as engine_mod

    on_mesh = [isinstance(v, engine_mod.MeshArray) for v in arrays.values()]
    mesh = None
    if any(on_mesh):
        meshes = {v.mesh for v in arrays.values()
                  if isinstance(v, engine_mod.MeshArray)}
        if not all(on_mesh) or len(meshes) != 1:
            raise ValueError("the walk takes a mesh count's arrays all on one "
                             "mesh, or tensors on one device")
        (mesh,) = meshes
        walk = _Walk(None, mesh=mesh, card_of={
            pos: (str(mesh.device_at(pos)) if cards is None else cards(pos))
            for pos in np.ndindex(*mesh.shape)})
    else:
        if cards is not None:
            raise ValueError("cards= places a mesh's positions; these tensors "
                             "lie on one device")
        devices = {v.device for v in arrays.values()}
        if len(devices) != 1:
            raise ValueError(f"the walk takes tensors on one device, got "
                             f"{sorted(map(str, devices))}")
        walk = _Walk(devices.pop())
    if sample:
        _check_uniform(fn)
    grid = tuple(fn.schedule.grid)
    booked = {k: Counter() for k in ("staged", "payload", "ring")}
    seen = set()  # _ringed recurses through the payload's tuples
    for t in arrays.values():
        if mesh is None:
            walk.track(t)
        else:
            for pos, block in t.blocks.items():
                walk.track(block, place=pos)
                booked["staged"][walk.card_of[pos]] += _nbytes(block)
    staged = walk.live
    store, schedule = fn.store, fn.schedule

    def book(kind, method):
        """``method`` whose result's mesh blocks (and their receive
        buffers) are booked to their cards under ``kind``."""

        def wrapper(*args, **kw):
            out = method(*args, **kw)
            for t in engine_mod._leaves(out):
                if isinstance(t, engine_mod.MeshArray):
                    for part in (t.blocks,) if kind == "payload" else t.ring:
                        for pos, block in part.items():
                            if id(block) not in seen:
                                seen.add(id(block))
                                booked[kind][walk.card_of[pos]] += _nbytes(
                                    block)
            return out

        return wrapper

    with contextlib.ExitStack() as stack:
        moved = stack.enter_context(engine_mod.tally_moved_bytes())
        count = walk.device_step(store.count)
        if sample:
            count = walk.replayed(count, moved, fresh=True, real=2)
            stack.enter_context(count_mod.sample_task_chunks(
                walk.sample_chunks))
            for name in ("_count_grid", "_shift_k"):
                stack.enter_context(_on_instance(
                    schedule, name,
                    walk.replayed(getattr(schedule, name), moved)))
        stack.enter_context(_on_instance(store, "count", count))
        if mesh is not None:
            stack.enter_context(_on_instance(
                store, "payload", book("payload", store.payload)))
            stack.enter_context(_on_instance(
                engine_mod, "_ringed", book("ring", engine_mod._ringed)))
        stack.enter_context(walk)
        out = fn(**arrays)
    if walk.device_steps == 0:
        raise ValueError(
            "the walk counted no device-step: every task count is 0 (an "
            "analytic plan's m_cnt is all zeros; rebind it to tmax) or "
            "every step is masked off")
    if mesh is None:
        args = sum(_device_share(t, grid) for t in arrays.values())
        by_card = None
    else:
        args = max(sum(_nbytes(t.blocks[pos]) for t in arrays.values())
                   for pos in np.ndindex(*mesh.shape))
        by_card = {}
        for pos, card in walk.card_of.items():
            by_card.setdefault(card, []).append(pos)
        by_card = {card: CardWalk(
            positions=tuple(ps), staged_bytes=booked["staged"][card],
            payload_bytes=booked["payload"][card],
            ring_bytes=booked["ring"][card],
            step_temps=walk.card_temps[card], peak_bytes=walk.card_peak[card])
            for card, ps in by_card.items()}
    return EngineWalk(
        grid=grid,
        ops=walk.ops,
        bytes=walk.bytes,
        moved=dict(moved),
        staged_bytes=staged,
        args_per_device=args,
        step_temps=walk.step_temps,
        peak_bytes=walk.peak,
        output_bytes=sum(_nbytes(t) for t in _tensors((out,))),
        device_steps=walk.device_steps,
        searched=dict(walk.searched),
        sampled=sample,
        cards=by_card,
    )


def card_memory_bytes() -> int:
    """The current card's memory where one is present
    (``torch.cuda.get_device_properties``), else the data sheet's
    (``HW["hbm_bytes"]``)."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory)
    return int(HW["hbm_bytes"])


def roofline_from_walk(name: str, walk: EngineWalk, *, mesh_name: str,
                       chips: int, model_flops: float = 0.0
                       ) -> RooflineReport:
    """The dry-run row of one walked call, in place of the JAX package's
    ``roofline_from_compiled``.

    Per device is the whole grid's count over its logical devices.
    ``flops_per_device`` / ``bytes_per_device``: the walk's ``ops`` /
    ``bytes``, every op eager and unfused as the port runs it.
    ``coll_bytes_per_device`` and ``coll_breakdown``: the engine's byte
    tally.  ``t_compute``: ops over the 32-bit rate outside the tensor
    cores (``HW["fp32_ops"]``: the walk's ops are integer compares,
    gathers and index arithmetic); ``t_memory``: bytes over
    ``HW["hbm_bw"]``; ``t_collective``: on one card a roll is a copy
    through device memory, each rolled byte read and written, so twice
    the tally over ``HW["hbm_bw"]``.  ``memory_per_device``: ``args`` one
    logical device's staged bytes, ``outputs`` the result's, ``temps``
    the peak live bytes of one device-step's count, ``aliased`` 0.
    ``grid_bytes``: the walk's peak live bytes on the card — every
    logical device's staged bytes, the engine's own buffers (the packed
    blobs and a shift's rolled copy) and one device-step's temps, as the
    port counts device-steps one at a time; ``fits``: ``grid_bytes``
    within :func:`card_memory_bytes`.
    """
    ndev = math.prod(walk.grid)
    flops = walk.ops / ndev
    byts = walk.bytes / ndev
    coll = {k: v / ndev for k, v in walk.moved.items()}
    cbytes = sum(coll.values())
    t_c = flops / HW["fp32_ops"]
    t_m = byts / HW["hbm_bw"]
    t_l = 2 * cbytes / HW["hbm_bw"]
    bottleneck = max(
        [("compute", t_c), ("memory", t_m), ("collective", t_l)],
        key=lambda kv: kv[1],
    )[0]
    useful = (
        model_flops / (flops * chips) if flops > 0 and model_flops else 0.0
    )
    return RooflineReport(
        name=name,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=flops,
        bytes_per_device=byts,
        coll_bytes_per_device=cbytes,
        coll_breakdown=coll,
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_l,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_fraction=useful,
        memory_per_device=dict(args=walk.args_per_device,
                               outputs=walk.output_bytes,
                               temps=walk.step_temps, aliased=0),
        grid_bytes=walk.peak_bytes,
        fits=walk.peak_bytes <= card_memory_bytes(),
    )


# ======================================================================
# the dry run of a model step: a walk on meta tensors, and its report
# ======================================================================
# the rate of a product by its operands' dtype; TF32 stays off, so a
# float32 product runs at the 32-bit rate outside the tensor cores
_PRODUCT_RATE = {"torch.bfloat16": "peak_flops", "torch.float32": "fp32_ops"}


@dataclasses.dataclass
class StepWalk:
    """What one walked call of a model step did, on one card.

    ``flops``: the products' FLOPs (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, ``mv``, ``addmv``, ``dot``, ``vdot`` — what ``einsum``
    and ``matmul`` dispatch to — by :func:`_product_flops`) by operand
    dtype.  ``ops`` and
    ``bytes``: every aten op that is not a view, counted as
    :class:`EngineWalk` counts them (one op an output element; each tensor
    argument and result once).  ``staged_bytes``: the arguments' storages;
    ``output_bytes``: the result's.  ``point_live``: at each point of the
    program where tensors are made (:meth:`_Walk._point`: its segment, the
    autograd node and the chain of the port's frames), the bytes live just
    after each, in order.  ``segment_peaks``: the most of each segment's
    points (``""``: outside every segment, at least the staged bytes);
    ``peak_bytes``: the most of all.  ``walks``: the walks it was made
    of (:func:`combine_walks`).  ``result``: the step's result, meta
    tensors (not compared)."""

    flops: Dict[str, int]
    ops: int
    bytes: int
    staged_bytes: int
    output_bytes: int
    point_live: Dict[tuple, Tuple[int, ...]]
    walks: int = 1
    result: object = dataclasses.field(default=None, compare=False,
                                       repr=False)

    @property
    def segment_peaks(self) -> Dict[str, int]:
        out = {"": self.staged_bytes}
        for (seg, _, _), live in self.point_live.items():
            out[seg] = max(out.get(seg, 0), *live)
        return out

    @property
    def peak_bytes(self) -> int:
        return max(self.segment_peaks.values())


def tree_tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return []


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def walk_step(fn, *args, segments: Optional[Dict[str, Tuple]] = None
              ) -> StepWalk:
    """One call ``fn(*args)`` of a model step walked op by op
    (:class:`StepWalk`).

    The arguments are trees of tensors on one device — ``meta`` in the
    dry run: nothing is allocated, and an op that reads a value raises, so
    no op is dropped.  Autograd's backward and ``torch.utils.checkpoint``'s
    recompute run through the same walk.  ``segments`` maps a name to
    ``(owner, attribute)``, a function the step calls by that name
    (``(models.steps, "_microbatch_grads")``): while the walk runs it is
    wrapped so that the points where its calls make tensors are kept
    apart (``segment_peaks``)."""
    leaves = tree_tensors(list(args))
    devices = {t.device for t in leaves}
    if len(devices) != 1:
        raise ValueError(f"the walk takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    walk = _Walk(devices.pop())
    for t in leaves:
        walk.track(t)
    staged = walk.live
    walk.points = {}
    with contextlib.ExitStack() as stack:
        for name, (owner, attr) in (segments or {}).items():
            stack.enter_context(_on_instance(
                owner, attr, walk.in_segment(name, getattr(owner, attr))))
        stack.enter_context(walk)
        out = fn(*args)
    return StepWalk(
        flops={k: int(v) for k, v in sorted(walk.flops.items())},
        ops=int(walk.ops),
        bytes=int(walk.bytes),
        staged_bytes=staged,
        output_bytes=_storage_bytes(t for t in tree_tensors(out)
                                    if t.device == walk.device),
        point_live={k: tuple(v) for k, v in walk.points.items()},
        result=out,
    )


def combine_walks(terms) -> StepWalk:
    """``Σ c · walk`` over ``terms``, pairs ``(c, walk)`` of an integer and
    a :class:`StepWalk`: every count and byte total combined field by
    field.  The dry run extrapolates a config's step from walks at a few
    small depths and microbatch counts this way; it is exact for what is
    affine in them (:mod:`repro_torch.launch.dryrun`).

    The live bytes are combined point by point.  A point that makes as
    many tensors in every walk (once a parameter leaf, say, in the
    optimiser) is combined tensor by tensor: each is the same leaf at
    every depth.  A point that makes more in a deeper walk (once a layer
    or a microbatch) keeps one value, its walks' most live combined: exact
    while that most is made at the same place at every depth (the last
    layer of a forward, the first of a backward).  Walks that make tensors
    at different points are refused: a point's bytes cannot be carried to
    a depth where it is missing or new."""
    terms = [(int(c), w) for c, w in terms if c]
    points = {frozenset(w.point_live) for _, w in terms}
    if len(points) > 1:
        raise ValueError(
            "the walks make tensors at different points of the program; "
            "their peaks cannot be combined")

    def lin(get):
        return sum(c * get(w) for c, w in terms)

    def lin_dict(get):
        keys = sorted({k for _, w in terms for k in get(w)})
        out = {k: lin(lambda w, k=k: get(w).get(k, 0)) for k in keys}
        return {k: v for k, v in out.items() if v}

    return StepWalk(
        flops=lin_dict(lambda w: w.flops),
        ops=lin(lambda w: w.ops),
        bytes=lin(lambda w: w.bytes),
        staged_bytes=lin(lambda w: w.staged_bytes),
        output_bytes=lin(lambda w: w.output_bytes),
        point_live={k: _combine_point(terms, k)
                    for k in terms[0][1].point_live},
        walks=sum(w.walks for _, w in terms),
    )


def _combine_point(terms, point) -> Tuple[int, ...]:
    runs = [(c, w.point_live[point]) for c, w in terms]
    if len({len(r) for _, r in runs}) == 1:
        return tuple(sum(c * r[i] for c, r in runs)
                     for i in range(len(runs[0][1])))
    return (sum(c * max(r) for c, r in runs),)


def _axis_product(entry, mesh) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return math.prod(sizes[a] for a in names)


def shard_bytes(tree, specs, mesh) -> int:
    """One device's bytes of a tree of tensors laid out by ``specs`` (a
    tree of the same structure whose leaves are spec tuples, ``None`` a
    replicated dimension and a missing tail replicated) on ``mesh``: each
    dimension divided by the product of its axes' sizes, rounded up, as
    XLA pads an uneven shard.  A leaf that is not a tensor (an integer
    step) is an int32 scalar, as the JAX package traces it."""
    if isinstance(tree, dict):
        return sum(shard_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(shard_bytes(v, sp, mesh) for v, sp in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return 4
    spec = tuple(specs or ())
    spec = spec + (None,) * (tree.dim() - len(spec))
    n = 1
    for d, entry in zip(tree.shape, spec):
        n *= -(-d // _axis_product(entry, mesh))
    return n * tree.element_size()


def roofline_from_step(name: str, walk: StepWalk, *, mesh_name: str,
                       chips: int, model_flops: float = 0.0,
                       args_per_device: int, outputs_per_device: int
                       ) -> RooflineReport:
    """The dry-run row of a walked model step, in place of the JAX
    package's ``roofline_from_compiled``.

    ``flops_per_device`` / ``bytes_per_device``: the walk's product FLOPs
    (every dtype) / bytes over ``chips``, an even split.
    ``coll_bytes_per_device`` 0 and ``coll_breakdown`` ``{}``: one card
    moves nothing between devices, and the port has no partitioner to
    model.  ``t_compute``: each dtype's FLOPs over its rate (bfloat16 over
    ``HW["peak_flops"]``, float32 over ``HW["fp32_ops"]``: TF32 stays off)
    over ``chips``; ``t_memory``: bytes over ``HW["hbm_bw"]``.
    ``memory_per_device``: ``args`` / ``outputs`` the caller's shard bytes
    of the arguments and the result (:func:`shard_bytes` over the JAX
    package's specs), ``temps`` the walk's peak less its staged bytes over
    ``chips``, rounded up, ``aliased`` 0.  ``grid_bytes``: the walk's peak
    for the whole step on one card; ``fits``: within
    :func:`card_memory_bytes`."""
    total = sum(walk.flops.values())
    t_c = 0.0
    for dtype, f in walk.flops.items():
        if dtype not in _PRODUCT_RATE:
            raise ValueError(f"no rate for products of {dtype}")
        t_c += f / chips / HW[_PRODUCT_RATE[dtype]]
    flops = total / chips
    byts = walk.bytes / chips
    t_m = byts / HW["hbm_bw"]
    bottleneck = max(
        [("compute", t_c), ("memory", t_m), ("collective", 0.0)],
        key=lambda kv: kv[1],
    )[0]
    useful = model_flops / total if total > 0 and model_flops else 0.0
    return RooflineReport(
        name=name,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=flops,
        bytes_per_device=byts,
        coll_bytes_per_device=0.0,
        coll_breakdown={},
        t_compute=t_c,
        t_memory=t_m,
        t_collective=0.0,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_fraction=useful,
        memory_per_device=dict(
            args=int(args_per_device), outputs=int(outputs_per_device),
            temps=-(-(walk.peak_bytes - walk.staged_bytes) // chips),
            aliased=0),
        grid_bytes=walk.peak_bytes,
        fits=walk.peak_bytes <= card_memory_bytes(),
    )


def model_flops_lm(cfg, shape: dict) -> float:
    """Useful model FLOPs: 6·N·D (dense) / 6·N_active·D (MoE) per step
    (the JAX package's formula)."""
    n = cfg.active_param_count() if cfg.moe else cfg.param_count()
    if shape["kind"] == "train":
        tokens = shape["global_batch"] * shape["seq_len"]
        return 6.0 * n * tokens
    if shape["kind"] == "prefill":
        tokens = shape["global_batch"] * shape["seq_len"]
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape["global_batch"]
