"""Copy lanes: the streams a device mesh's shifts run on, and the events
that order them against the counts.

On a :class:`~repro_torch.launch.mesh.DeviceMesh` a Cannon or ring shift
copies every position's block into a receive buffer on its destination's
device (:func:`~repro_torch.core.engine.tree_ppermute`).  PyTorch runs a
cross-device ``copy_`` on the source's current stream behind a two-way
barrier with the destination's current stream, so a copy issued on the
devices' current streams waits for every count queued on both cards, and
the next counts on both wait for it.  Here each CUDA device of a mesh has
a copy stream of its own (made once per mesh and device), every shift
copy runs with both endpoints' current streams set to their copy streams,
and events alone order the copies against the counts on the compute
streams (the devices' current streams when the run began):

* at the run's entry every copy stream waits for its device's compute
  stream: what the caller queued before (the staging, the blob packing)
  and the receive buffers, all allocated before the entry, are written
  and free of earlier work as of that event;
* a copy into a buffer that an earlier generation used waits for the
  event after the last count that read that generation on the
  destination's device;
* a count waits for the event after the shift that wrote its blocks.

Nothing else waits.  The copy streams order themselves: a copy's barrier
orders it after the work queued on both endpoints' copy streams, so a
block is read by a copy only after the copy that received it, and written
only after every copy that read it.  :meth:`Lanes.join` ends every run:
each compute stream waits for its copy stream, after which the caller
sees finished copies.  Nothing in between synchronises or reads anything
back to the host.

The receive buffers of a run are allocated on the compute streams before
its entry (:func:`~repro_torch.core.engine.tree_ppermute` refuses a shift
inside a run whose payload has none), so no memory that a queued count
still uses is handed to a copy.  The reverse, memory that a copy still
uses being freed on a compute stream (a packed blob dropped mid-run), is
covered by ``Tensor.record_stream`` on every block a copy reads or writes.

On the CPU the layer is inert: copies run in order and nothing waits.  It
keeps the same books, and :func:`issue_log` collects, in issue order,
every event record, wait, copy, count and join of the runs inside it (the
tests check the ordering against that log).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Mark", "Lanes", "lanes", "active", "issue_log", "copy_stream"]

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_lanes", default=None)
_LOG: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_lanes_log", default=None)
_COPY_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}


@dataclasses.dataclass(frozen=True)
class Mark:
    """An event: the stream it was recorded on (``("compute" | "copy",
    device)``), its place in the run's order of records, and on a CUDA
    device the ``torch.cuda.Event`` itself."""

    stream: Tuple[str, str]
    seq: int
    event: Optional[object] = dataclasses.field(default=None, compare=False,
                                                repr=False)


def copy_stream(mesh, device) -> "torch.cuda.Stream":
    """The copy stream of ``device`` in ``mesh``: made at the first call,
    the same stream after."""
    key = (mesh, torch.device(device))
    stream = _COPY_STREAMS.get(key)
    if stream is None:
        stream = _COPY_STREAMS[key] = torch.cuda.Stream(device=key[1])
    return stream


@contextlib.contextmanager
def issue_log():
    """Collect the issue log of every run inside the block: a list of
    dicts, each with ``op`` one of ``record``, ``wait``, ``copy``,
    ``count`` and ``join``, in issue order."""
    log: List[dict] = []
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def active() -> Optional["Lanes"]:
    """The lanes of the run in progress, if any."""
    return _ACTIVE.get()


@contextlib.contextmanager
def lanes(mesh):
    """The lanes of ``mesh`` while the block runs: those of the run in
    progress on that mesh, or new ones that join when the block ends.
    ``mesh=None`` yields ``None``."""
    cur = _ACTIVE.get()
    if mesh is None or (cur is not None and cur.mesh == mesh):
        yield None if mesh is None else cur
        return
    ln = Lanes(mesh, _LOG.get())
    token = _ACTIVE.set(ln)
    try:
        yield ln
    finally:
        _ACTIVE.reset(token)
        ln.join()


class Lanes:
    """One run's copy streams and events over ``mesh``.

    The books are one event a device and payload generation (shifts since
    the run's entry): after the shift that wrote it on the device's copy
    stream, and after the last count that read it on its compute stream.
    """

    def __init__(self, mesh, log: Optional[list] = None):
        self.mesh = mesh
        self.log = log
        self._seq = itertools.count()
        self._written: Dict[tuple, Mark] = {}
        self._read: Dict[tuple, Mark] = {}
        self._waited = set()
        self._used = set()
        self.devices = list(dict.fromkeys(mesh.devices))
        # each position's device and the names of its two lanes
        self._at = dict(zip(np.ndindex(*mesh.shape), mesh.devices))
        self._lanes = {d: (("compute", str(d)), ("copy", str(d)))
                       for d in self.devices}
        self._streams: Dict[tuple, "torch.cuda.Stream"] = {}
        for d in self.devices:
            if d.type != "cuda":
                continue
            compute, copy = torch.cuda.current_stream(d), copy_stream(mesh, d)
            if copy == compute:
                raise ValueError(
                    f"the current stream of {d} is the mesh's copy stream: "
                    "run the count on another stream")
            self._streams[self._lanes[d][0]] = compute
            self._streams[self._lanes[d][1]] = copy
        # the run's entry: staging, packing and the receive buffers
        for d in self.devices:
            compute, copy = self._lanes[d]
            self._wait(copy, self._record(compute, "entry", (0,)))

    def _note(self, **entry) -> None:
        if self.log is not None:
            self.log.append(entry)

    def _record(self, stream, what: str, gens: Tuple[int, ...] = ()) -> Mark:
        cuda = self._streams.get(stream)
        event = None
        if cuda is not None:
            event = torch.cuda.Event()
            event.record(cuda)
        mark = Mark(stream, next(self._seq), event)
        self._note(op="record", stream=stream, mark=mark, what=what,
                   gens=tuple(gens))
        return mark

    def _wait(self, stream, mark: Optional[Mark]) -> None:
        """``stream`` waits for ``mark`` (once)."""
        if mark is None or (stream, mark.seq) in self._waited:
            return
        cuda = self._streams.get(stream)
        if cuda is not None:
            cuda.wait_event(mark.event)
        self._waited.add((stream, mark.seq))
        self._note(op="wait", stream=stream, on=mark)

    @contextlib.contextmanager
    def _on_copy_streams(self):
        """Every CUDA device's current stream is its copy stream while the
        block runs (a cross-device ``copy_`` then brings in no compute
        stream)."""
        copies = [s for (kind, _), s in self._streams.items()
                  if kind == "copy"]
        if not copies:
            yield
            return
        device = torch.cuda.current_device()
        prev = [torch.cuda.current_stream(s.device) for s in copies]
        for s in copies:
            torch.cuda.set_stream(s)
        try:
            yield
        finally:
            for s in prev:
                torch.cuda.set_stream(s)
            torch.cuda.set_device(device)

    def shift(self, moves, gen: int, slot: int, ring: int) -> None:
        """One shift's copies, writing generation ``gen`` into receive
        buffer ``slot`` of a ring of ``ring``: ``moves`` holds ``(source
        block, source position, buffer, destination position)`` tuples.
        A buffer that generation ``gen - ring`` used is written after the
        last count that read that generation on its device."""
        dsts = []
        with self._on_copy_streams():
            for src, src_pos, dst, dst_pos in moves:
                sd, dd = self._at[src_pos], self._at[dst_pos]
                s_lane, d_lane = self._lanes[sd][1], self._lanes[dd][1]
                if gen > ring:
                    self._wait(d_lane, self._read.get((dd, gen - ring)))
                dst.copy_(src)
                if sd.type == "cuda":
                    src.record_stream(self._streams[s_lane])
                if dd.type == "cuda":
                    dst.record_stream(self._streams[d_lane])
                if dd not in dsts:
                    dsts.append(dd)
                self._used.update((sd, dd))
                self._note(op="copy", src_stream=s_lane, dst_stream=d_lane,
                           pos=tuple(dst_pos), src_pos=tuple(src_pos),
                           gen=gen, slot=slot,
                           bytes=dst.numel() * dst.element_size())
        for d in dsts:
            self._written[(d, gen)] = self._record(self._lanes[d][1],
                                                   "written", (gen,))

    def count(self, pos, step: int, gens, run):
        """``run()``, one position's count at schedule step ``step`` of
        blocks of the generations ``gens``: its compute stream first waits
        for the shifts that wrote them, and the event after it becomes
        their last reader's.  Returns what ``run`` returns."""
        device = self._at[pos]
        lane = self._lanes[device][0]
        gens = sorted(gens)
        for g in gens:
            self._wait(lane, self._written.get((device, g)))
        self._note(op="count", stream=lane, pos=tuple(pos), step=int(step),
                   gens=tuple(gens))
        out = run()
        mark = self._record(lane, "read", gens)
        for g in gens:
            self._read[(device, g)] = mark
        return out

    def join(self) -> None:
        """Every compute stream waits for its copy stream's last work."""
        for d in self.devices:
            compute, copy = self._lanes[d]
            if d in self._used:
                self._wait(compute, self._record(copy, "join"))
            self._note(op="join", stream=compute)
