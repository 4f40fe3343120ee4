"""Deterministic fault injection for the supervised execution layer.

A :class:`FaultPlan` is a seeded, declarative list of faults to raise at
named injection points threaded through the hot paths (the JAX package's
module of the same name, copied: the same grammar, sites, log and seeds,
so one spec and one seed give the same faults in both packages):

========================  ====================================================
point                     where it fires
========================  ====================================================
``plan_stage``            :func:`repro_torch.pipeline.planner._drive` (host
                          planning, before the cache probe) and
                          :func:`repro_torch.pipeline.count_triangles_many`
``device_stage``          runner ``mark_counting`` — host→device staging done
                          (and before the batched engine call)
``step``                  each schedule step, by **original** step index, all
                          fired at ``mark_counting`` before the first
                          dispatch (so a fault registered at an elided step
                          composes with schedule compaction and simply never
                          fires), and once a shift in the checkpointed loop
``fused``                 the fused-kernel factory, where a count binds it
``delta_splice``          :func:`repro_torch.pipeline.delta.apply_delta`,
                          just before the splice
``ckpt_save``             :meth:`repro_torch.ckpt.CheckpointManager.save` —
                          raising faults fire *before* the write;
                          ``CkptCorrupt`` sites instead flip a byte of the
                          just-written payload (exercising the restore
                          quarantine path)
========================  ====================================================

Faults are *typed* (:class:`DeviceLost`, :class:`StepFault`,
:class:`StageFault`, :class:`CkptCorrupt`) so the supervisor can route
each to its recovery path.  Sites fire a bounded number of ``times``
(default once), which is what makes recovery deterministic: the retry of
a one-shot fault succeeds.

Arming is ambient: ``with plan.armed(): ...`` (or the module-level
:func:`armed`) sets the process-wide active plan consulted by
:func:`fire`; ``count_triangles(fault_plan=)`` and ``tc_run
--inject-faults SPEC`` arm through the same mechanism.  ``fire`` is a
cheap no-op when nothing is armed, so instrumented hot paths cost one
global read in production.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import random
from typing import List, Optional, Tuple

__all__ = [
    "InjectedFault",
    "DeviceLost",
    "StepFault",
    "StageFault",
    "CkptCorrupt",
    "FaultSite",
    "FaultPlan",
    "POINTS",
    "armed",
    "active_plan",
    "is_armed",
    "fire",
    "live_step_indices",
]


class InjectedFault(RuntimeError):
    """Base class of all typed injected faults."""


class DeviceLost(InjectedFault):
    """Simulated loss of ``lost`` devices — the supervisor answers with
    an elastic regrid (re-factorize via ``best_grid``, re-plan, re-count
    from the last globally consistent boundary)."""

    def __init__(self, message: str = "injected device loss", *, lost: int = 1):
        super().__init__(message)
        self.lost = int(lost)


class StepFault(InjectedFault):
    """A schedule step failed mid-count (transient kernel/dispatch
    error) — restartable in place."""


class StageFault(InjectedFault):
    """Host planning or host→device staging failed — restartable in
    place (planning is deterministic and cached)."""


class CkptCorrupt(InjectedFault):
    """Checkpoint payload corruption.  At the ``ckpt_save`` point this
    does not raise: the just-written payload gets a byte flipped so the
    *restore* path exercises digest verification + quarantine."""


_FAULT_TYPES = {
    "devicelost": DeviceLost,
    "device_lost": DeviceLost,
    "stepfault": StepFault,
    "step_fault": StepFault,
    "stagefault": StageFault,
    "stage_fault": StageFault,
    "ckptcorrupt": CkptCorrupt,
    "ckpt_corrupt": CkptCorrupt,
}

POINTS = (
    "plan_stage",
    "device_stage",
    "step",
    "fused",
    "delta_splice",
    "ckpt_save",
)

# default fault type per point when the spec names only the point
_DEFAULT_FAULT = {
    "plan_stage": StageFault,
    "device_stage": StageFault,
    "step": StepFault,
    "fused": StepFault,
    "delta_splice": StageFault,
    "ckpt_save": CkptCorrupt,
}


@dataclasses.dataclass
class FaultSite:
    """One armed fault: fire ``fault`` at ``point`` (optionally only at
    original step index ``step``) up to ``times`` times (-1 = always)."""

    point: str
    fault: type = StepFault
    step: Optional[int] = None
    times: int = 1
    lost: int = 1  # DeviceLost payload
    fired: int = 0

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r}; known: {POINTS}"
            )
        if not (isinstance(self.fault, type)
                and issubclass(self.fault, InjectedFault)):
            raise ValueError(f"fault must be an InjectedFault subclass, "
                             f"got {self.fault!r}")

    def matches(self, point: str, step: Optional[int]) -> bool:
        if point != self.point:
            return False
        if self.times != -1 and self.fired >= self.times:
            return False
        if self.step is not None and step != self.step:
            return False
        return True

    def describe(self) -> str:
        s = self.point
        if self.step is not None:
            s += f"@{self.step}"
        s += f"={self.fault.__name__}"
        if self.fault is DeviceLost and self.lost != 1:
            s += f":{self.lost}"
        if self.times != 1:
            s += f"*{self.times}"
        return s


def _parse_site(token: str) -> FaultSite:
    """``point[@STEP][=FAULT[:LOST]][*TIMES]`` — e.g. ``step@2``,
    ``step@1=devicelost:5``, ``fused=stepfault*-1``, ``ckpt_save``."""
    times = 1
    if "*" in token:
        token, times_s = token.rsplit("*", 1)
        times = int(times_s)
    fault_s = None
    if "=" in token:
        token, fault_s = token.split("=", 1)
    step = None
    if "@" in token:
        token, step_s = token.split("@", 1)
        step = int(step_s)
    point = token.strip()
    lost = 1
    if fault_s is None:
        fault = _DEFAULT_FAULT.get(point, StepFault)
    else:
        fault_s = fault_s.strip().lower()
        if ":" in fault_s:
            fault_s, lost_s = fault_s.split(":", 1)
            lost = int(lost_s)
        try:
            fault = _FAULT_TYPES[fault_s]
        except KeyError:
            raise ValueError(
                f"unknown fault type {fault_s!r}; known: "
                f"{sorted(set(_FAULT_TYPES))}"
            ) from None
    return FaultSite(point=point, fault=fault, step=step, times=times,
                     lost=lost)


class FaultPlan:
    """A deterministic set of :class:`FaultSite`\\ s plus a firing log.

    ``seed`` drives :meth:`random` site generation and nothing else —
    firing itself is fully determined by the sites and the execution
    order of the instrumented points.
    """

    def __init__(self, sites, *, seed: int = 0):
        self.sites: List[FaultSite] = list(sites)
        self.seed = int(seed)
        self.log: List[dict] = []

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, spec: str, *, seed: int = 0) -> "FaultPlan":
        """Parse a ``tc_run --inject-faults`` spec: ``';'``-separated
        site tokens (see :func:`_parse_site` for the grammar)."""
        tokens = [t.strip() for t in spec.split(";") if t.strip()]
        if not tokens:
            raise ValueError(f"empty fault spec {spec!r}")
        return cls([_parse_site(t) for t in tokens], seed=seed)

    @classmethod
    def random(cls, *, n_steps: int, k: int = 1, seed: int = 0,
               points: Tuple[str, ...] = ("step",)) -> "FaultPlan":
        """``k`` seeded one-shot faults at random points/steps — the
        property-test front door."""
        rng = random.Random(seed)
        sites = []
        for _ in range(k):
            point = rng.choice(points)
            step = rng.randrange(n_steps) if point == "step" else None
            sites.append(FaultSite(point=point,
                                   fault=_DEFAULT_FAULT[point], step=step))
        return cls(sites, seed=seed)

    # ------------------------------------------------------------------
    def spent(self) -> bool:
        """True when every bounded site has fired its quota."""
        return all(
            s.times != -1 and s.fired >= s.times for s in self.sites
        )

    def fire(self, point: str, *, step: Optional[int] = None,
             path: Optional[str] = None, **info) -> None:
        for site in self.sites:
            if not site.matches(point, step):
                continue
            # CkptCorrupt at ckpt_save corrupts the written payload, so
            # it only fires on the post-write call (which passes `path`);
            # every raising fault fires on the pre-write/point call.
            corrupting = site.fault is CkptCorrupt and point == "ckpt_save"
            if corrupting != (path is not None):
                continue
            site.fired += 1
            entry = dict(point=point, step=step,
                         fault=site.fault.__name__, **info)
            self.log.append(entry)
            if corrupting:
                _flip_byte(path)
                return
            if site.fault is DeviceLost:
                raise DeviceLost(
                    f"injected device loss at {point}"
                    + (f" step {step}" if step is not None else ""),
                    lost=site.lost,
                )
            raise site.fault(
                f"injected {site.fault.__name__} at {point}"
                + (f" step {step}" if step is not None else "")
            )

    @contextlib.contextmanager
    def armed(self):
        """Arm this plan process-wide for the duration of the block."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev

    def describe(self) -> str:
        return ";".join(s.describe() for s in self.sites)


def _flip_byte(path: str) -> None:
    """Flip one payload byte in place (deterministic: mid-file)."""
    size = os.path.getsize(path)
    pos = max(0, size // 2)
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1) or b"\x00"
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
        f.flush()
        os.fsync(f.fileno())


# ----------------------------------------------------------------------
# ambient arming
# ----------------------------------------------------------------------
_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def is_armed() -> bool:
    return _ACTIVE is not None


def armed(plan: Optional[FaultPlan]):
    """Module-level arming helper; ``armed(None)`` is a no-op block."""
    if plan is None:
        return contextlib.nullcontext()
    return plan.armed()


def fire(point: str, *, step: Optional[int] = None,
         path: Optional[str] = None, **info) -> None:
    """Fire any armed fault matching ``point``/``step``.  No-op (one
    global read) when no plan is armed."""
    plan = _ACTIVE
    if plan is None:
        return
    plan.fire(point, step=step, path=path, **info)


# ----------------------------------------------------------------------
# helpers shared by the instrumented call sites and the test suite
# ----------------------------------------------------------------------
def live_step_indices(plan, compact_enabled: bool = True) -> List[int]:
    """Original step indices the engine will actually execute.

    Under a compacted schedule only the globally-live steps run, so a
    ``step@s`` fault registered at an elided ``s`` never fires — the
    injection point composes with compaction by construction.
    """
    cs = getattr(plan, "compact", None)
    if compact_enabled and cs is not None and cs.n_elided > 0:
        return list(cs.live_steps)
    if cs is not None:
        return list(range(cs.n_total))
    sk = getattr(plan, "step_keep", None)
    if sk is not None:
        return list(range(int(sk.shape[-1])))
    for attr in ("q", "c", "p"):
        v = getattr(plan, attr, None)
        if v:
            return list(range(int(v)))
    return []
