"""Supervised fault-tolerant execution.

:class:`Supervisor` is the one retry loop in the system: exponential
backoff + deterministic jitter, a restart budget, cooperative
per-attempt deadlines, and structured :class:`Attempt` records.  Clock,
sleep and RNG are injectable so the backoff/deadline/budget logic is
unit-testable with a fake clock; the RNG is the stdlib's
``random.Random(seed)``, so one seed gives the JAX package's delays.

:func:`supervised_count` wraps :func:`repro_torch.core.count_triangles`
with the full recovery policy:

* **transient faults** (``StepFault`` / ``StageFault`` / ``CkptCorrupt``)
  retry in place under backoff; the retry re-plans through the plan
  cache and counts from the artifact's memoised staged tensors, so it
  stages nothing twice;
* **persistent faults** (the same site keeps firing) demote one rung of
  the graceful degradation ladder per repeat —
  fused → search2 → search (on the ring fused → search), compacted →
  full loop, tree → flat reduction, hub-split → off — each demotion
  recorded with its reason before the budget gives up;
* **``DeviceLost``** triggers an elastic regrid: re-factorize the
  remaining devices via :func:`repro_torch.runtime.best_grid`, re-plan
  on the smaller grid through the pipeline planner, and re-count from
  the last *globally consistent* boundary.  Mid-schedule per-device
  partials are decomposition-specific and are **refused** across grids
  (:func:`check_partials_portable`); only completed-graph / stream-round
  boundaries transfer.

**The regrid.**  The JAX package shrinks a mesh of real devices and
counts the survivors as ``len(jax.devices()) - lost``.  Here the
survivors are counted on the grid supervision *started* with, less the
event's ``lost``: on a ``mesh`` its positions (a device that stands at
several positions counts at each), else the logical grid on one device —
``q²`` for ``q=``, ``r·c`` for ``grid=(r, c)``, ``p`` for a caller's ring
plan, times ``npods``.  The two agree where the mesh covers every device,
as in the JAX package's own tests.  As there, ``lost`` is per event, not
cumulative (each event counts from the same starting size); a square
survivor count keeps the schedule, a rectangular one turns Cannon into
SUMMA (:func:`best_grid`) and keeps the ring.  On a mesh the retry runs
on a new mesh over the first surviving positions' devices, in row-major
order (the JAX package's ``make_grid_mesh`` takes the first devices):
``make_grid_mesh(r)`` for a square count, ``(r, c)`` with the axes
``("data", "model")`` for SUMMA, a ``("flat",)`` mesh of ``r·c``
positions for the ring.  Off a mesh the retry passes ``grid=(r, c)``.
Either way it drops ``q``, ``grid`` and ``npods``.

Every recovered count is identical to the fault-free run: recovery
re-executes the deterministic pipeline, it never patches partial state.

The demotion collector (:func:`note_demotion`, :func:`collecting_demotions`)
is kept for parity, but nothing in this package feeds it: the JAX
package's one automatic demotion is the fused kernel's VMEM gate, which
has no counterpart here (the CUDA kernel stages rows in shared memory
per tile and has no such gate), so only the ladder's rungs are recorded.

:func:`supervise_loop` is the generic checkpointed step-loop driver that
``run_with_restarts`` delegates to.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, List, Optional

from .elastic import best_grid
from .faultinject import DeviceLost, FaultPlan, InjectedFault, armed

log = logging.getLogger(__name__)

__all__ = [
    "AttemptDeadlineExceeded",
    "GridTransferRefused",
    "BackoffPolicy",
    "Attempt",
    "SupervisionReport",
    "Supervisor",
    "next_demotion",
    "note_demotion",
    "collecting_demotions",
    "check_partials_portable",
    "supervised_count",
    "supervise_loop",
]


class AttemptDeadlineExceeded(RuntimeError):
    """Cooperative per-attempt deadline fired (checked at step/attempt
    boundaries — the host loop cannot preempt a running dispatch)."""


class GridTransferRefused(RuntimeError):
    """Mid-schedule per-device partial counts were asked to move across
    grids.  Partials are decomposition-specific (each device's
    accumulator sums a grid-dependent set of block pairs), so the only
    portable boundaries are a completed graph count or a completed
    stream round; the supervisor restarts the count on the new grid
    instead."""


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with bounded deterministic jitter."""

    base: float = 0.05
    factor: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.1  # fraction of the delay, uniform [0, jitter)

    def delay(self, restart_index: int, rng: random.Random) -> float:
        """Delay before restart ``restart_index`` (1-based)."""
        d = min(self.max_delay, self.base * self.factor ** (restart_index - 1))
        return d * (1.0 + self.jitter * rng.random())


@dataclasses.dataclass
class Attempt:
    """One attempt record: outcome is ``ok`` | ``fault`` | ``deadline``."""

    index: int
    outcome: str
    seconds: float
    fault: Optional[str] = None  # exception class name
    point: Optional[str] = None  # injection point, when typed
    step: Optional[int] = None
    backoff: float = 0.0  # sleep before the *next* attempt
    note: Optional[str] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass
class SupervisionReport:
    attempts: List[Attempt] = dataclasses.field(default_factory=list)
    demotions: List[dict] = dataclasses.field(default_factory=list)
    regrids: List[dict] = dataclasses.field(default_factory=list)
    gave_up: bool = False
    total_backoff_seconds: float = 0.0

    @property
    def restarts(self) -> int:
        return sum(1 for a in self.attempts if a.outcome != "ok")

    def to_dict(self) -> dict:
        return dict(
            attempts=[a.to_dict() for a in self.attempts],
            restarts=self.restarts,
            demotions=list(self.demotions),
            regrids=list(self.regrids),
            gave_up=self.gave_up,
            total_backoff_seconds=round(self.total_backoff_seconds, 4),
        )


class Supervisor:
    """Retry loop with backoff, budget, and cooperative deadlines.

    ``clock``/``sleep``/``seed`` are injectable for fake-clock tests.
    ``retry_on`` bounds which exceptions are restartable (default: the
    typed injected faults plus :class:`AttemptDeadlineExceeded`);
    anything else propagates immediately.
    """

    def __init__(
        self,
        *,
        max_restarts: int = 5,
        backoff: Optional[BackoffPolicy] = None,
        attempt_deadline: Optional[float] = None,
        retry_on: tuple = (InjectedFault, AttemptDeadlineExceeded),
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        seed: int = 0,
    ):
        self.max_restarts = int(max_restarts)
        self.backoff = backoff or BackoffPolicy()
        self.attempt_deadline = attempt_deadline
        self.retry_on = retry_on
        self.clock = clock
        self.sleep = sleep
        self.rng = random.Random(seed)
        self.report = SupervisionReport()

    # ------------------------------------------------------------------
    def deadline_guard(self, t0: float) -> Callable[[], None]:
        """A zero-arg callable the attempt invokes at step boundaries;
        raises :class:`AttemptDeadlineExceeded` past the deadline."""
        deadline = self.attempt_deadline

        def guard():
            if deadline is not None and self.clock() - t0 > deadline:
                raise AttemptDeadlineExceeded(
                    f"attempt exceeded its {deadline}s deadline"
                )

        return guard

    def run(self, attempt_fn: Callable, *, on_fault: Optional[Callable] = None):
        """Run ``attempt_fn(attempt_index, deadline_guard)`` until it
        returns, retrying restartable failures under backoff within the
        budget.  ``on_fault(exc, attempt_record)`` (optional) runs
        before each backoff — it may mutate state for the retry (regrid,
        demote, restore a checkpoint) or raise to abort."""
        attempt = 0
        while True:
            t0 = self.clock()
            try:
                out = attempt_fn(attempt, self.deadline_guard(t0))
            except self.retry_on as e:
                rec = Attempt(
                    index=attempt,
                    outcome=("deadline"
                             if isinstance(e, AttemptDeadlineExceeded)
                             else "fault"),
                    seconds=self.clock() - t0,
                    fault=type(e).__name__,
                )
                self.report.attempts.append(rec)
                attempt += 1
                if attempt > self.max_restarts:
                    self.report.gave_up = True
                    raise
                if on_fault is not None:
                    rec.note = on_fault(e, rec)
                delay = self.backoff.delay(attempt, self.rng)
                rec.backoff = round(delay, 4)
                self.report.total_backoff_seconds += delay
                log.warning(
                    "attempt %d failed (%s: %s); restarting in %.3fs "
                    "(%d/%d restarts used)",
                    attempt - 1, type(e).__name__, e, delay, attempt,
                    self.max_restarts,
                )
                self.sleep(delay)
                continue
            self.report.attempts.append(
                Attempt(index=attempt, outcome="ok",
                        seconds=self.clock() - t0)
            )
            return out


# ----------------------------------------------------------------------
# graceful degradation ladder
# ----------------------------------------------------------------------
def next_demotion(cfg: dict) -> Optional[dict]:
    """Mutate ``cfg`` one rung down the ladder; returns the demotion
    record, or ``None`` when the ladder is exhausted.

    Order (first applicable wins): fused → search2, search2 → search
    (the plain PyTorch path; on the 1-D ring fused demotes straight to
    search — its global-id columns rule out the two-level kernel),
    compacted → the full step loop, tree → flat reduction, hub-split →
    off.
    """
    method = cfg.get("method", "search")
    if method == "fused":
        to = "search" if cfg.get("schedule") == "oned" else "search2"
        cfg["method"] = to
        return dict(rung="method", frm="fused", to=to)
    if method == "search2":
        cfg["method"] = "search"
        return dict(rung="method", frm="search2", to="search")
    if cfg.get("compact") is not False:
        cfg["compact"] = False
        return dict(rung="compact", frm="auto", to="off")
    if cfg.get("reduce_strategy", "auto") != "flat":
        frm = cfg.get("reduce_strategy", "auto")
        cfg["reduce_strategy"] = "flat"
        return dict(rung="reduce", frm=frm, to="flat")
    if cfg.get("hub_split"):
        cfg["hub_split"] = False
        return dict(rung="hub_split", frm="on", to="off")
    return None


# Ambient demotion collector: one audited stream for every demotion —
# the ladder rungs above and any automatic demotion inside a count (the
# JAX package's fused VMEM gate; none in this package, see the module
# docstring).
_DEMOTIONS: Optional[List[dict]] = None


def note_demotion(rung: str, frm: str, to: str, *, reason: str) -> None:
    """Record a demotion into the ambient collector (no-op outside a
    supervised run — callers keep their warnings for unsupervised
    use)."""
    if _DEMOTIONS is not None:
        _DEMOTIONS.append(dict(rung=rung, frm=frm, to=to, reason=reason))


class collecting_demotions:
    """Context manager exposing the demotion list collected inside."""

    def __enter__(self) -> List[dict]:
        global _DEMOTIONS
        self._prev = _DEMOTIONS
        _DEMOTIONS = []
        return _DEMOTIONS

    def __exit__(self, *exc):
        global _DEMOTIONS
        _DEMOTIONS = self._prev
        return False


# ----------------------------------------------------------------------
# cross-grid state portability
# ----------------------------------------------------------------------
def check_partials_portable(extra: dict, grid_sig: str) -> None:
    """Refuse (loudly) to resume mid-schedule partial counts written
    under a different grid.  ``extra`` is a checkpoint manifest's extra
    dict; ``grid_sig`` the current ``"{r}x{c}"`` signature."""
    saved = (extra or {}).get("grid")
    if saved is not None and saved != grid_sig:
        raise GridTransferRefused(
            f"refusing to transfer mid-schedule per-device partial "
            f"counts from grid {saved} to {grid_sig}: partials are "
            "decomposition-specific (each accumulator sums a "
            "grid-dependent set of block pairs); only completed-graph / "
            "stream-round boundaries are portable — the count restarts "
            "from step 0 on the new grid"
        )


def _logical_devices(cfg: dict) -> int:
    """Positions of the logical grid a ``count_triangles`` call with
    ``cfg`` runs on: ``npods * r * c`` for ``grid=(r, c)``, ``npods * q²``
    for ``q=``, a caller plan's own grid, else one device."""
    from ..core.api import _plan_grid

    grid = cfg.get("grid")
    if grid is None and cfg.get("q") is not None:
        grid = (cfg["q"], cfg["q"])
    if grid is None:
        grid = _plan_grid(getattr(cfg.get("plan"), "plan", cfg.get("plan")))
    n = 1
    for v in grid or (1,):
        n *= int(v)
    return n * int(cfg.get("npods", 1))


def _regrid(schedule: str, remaining: int) -> tuple:
    """Re-factorize the surviving logical devices: (schedule, (r, c)).

    Square survivors keep the schedule family; rectangular survivors
    force SUMMA (Cannon needs a square grid — the paper's §8 fallback);
    the ring runs over ``r * c`` either way.
    """
    if remaining < 1:
        raise RuntimeError(
            f"cannot regrid: {remaining} logical devices remaining"
        )
    r, c = best_grid(remaining)
    if r == c or schedule == "oned":
        return schedule, (r, c)
    return "summa", (r, c)


def _survivor_mesh(schedule: str, devices, r: int, c: int):
    """The mesh a regridded count runs on: the first ``r * c`` of the
    surviving positions' ``devices``, in row-major order, as the ring's
    ``("flat",)`` mesh, a square grid mesh, or SUMMA's ``(r, c)``."""
    from ..core.api import make_grid_mesh
    from ..launch.mesh import make_mesh_for

    if schedule == "oned":
        return make_mesh_for((r * c,), ("flat",), devices=devices)
    if r == c:
        return make_grid_mesh(r, devices=devices)
    return make_mesh_for((r, c), ("data", "model"), devices=devices)


# ----------------------------------------------------------------------
# supervised full-engine count
# ----------------------------------------------------------------------
def supervised_count(
    graph,
    mesh=None,
    *,
    supervisor: Optional[Supervisor] = None,
    fault_plan: Optional[FaultPlan] = None,
    ladder: bool = True,
    regrid: bool = True,
    demote_after: int = 2,
    **kwargs,
):
    """``count_triangles`` under supervision; returns a ``TCResult``
    whose ``supervision`` field carries the full attempt/demotion/regrid
    record (plus the fault plan's ``fault_log``).  ``demote_after`` is
    how many consecutive identical faults it takes to call a fault
    persistent and demote a ladder rung.  ``mesh`` (a
    :class:`~repro_torch.launch.mesh.DeviceMesh`) and ``kwargs`` go to
    ``count_triangles`` on every attempt; without a mesh the grid is
    ``q=`` / ``grid=`` on one device."""
    from ..core.api import count_triangles

    sup = supervisor or Supervisor()
    cfg = dict(kwargs)
    state = {"mesh": mesh, "schedule": cfg.get("schedule", "cannon"),
             "devices": (_logical_devices(cfg) if mesh is None
                         else mesh.size),
             "last_sig": None, "repeats": 0}

    def on_fault(e, rec):
        if isinstance(e, InjectedFault) and fault_plan is not None:
            last = fault_plan.log[-1] if fault_plan.log else {}
            rec.point, rec.step = last.get("point"), last.get("step")
        if isinstance(e, DeviceLost) and regrid:
            sched, (r, c) = _regrid(state["schedule"],
                                    state["devices"] - int(e.lost))
            state["schedule"] = sched
            cfg["schedule"] = sched
            # grid-shape knobs don't survive re-factorization
            for knob in ("q", "grid", "npods"):
                cfg.pop(knob, None)
            if mesh is None:
                cfg["grid"] = (r, c)
            else:  # lost counts from the starting mesh, like its devices
                state["mesh"] = _survivor_mesh(sched, mesh.devices, r, c)
            ev = dict(lost=e.lost, grid=[r, c], schedule=sched)
            sup.report.regrids.append(ev)
            state["last_sig"], state["repeats"] = None, 0
            return f"regrid to {r}x{c} ({sched})"
        sig = (type(e).__name__, rec.point, rec.step)
        state["repeats"] = (
            state["repeats"] + 1 if sig == state["last_sig"] else 1
        )
        state["last_sig"] = sig
        if ladder and state["repeats"] >= demote_after:
            demo = next_demotion(cfg)
            state["repeats"] = 0
            if demo is not None:
                demo["reason"] = (
                    f"persistent {sig[0]}"
                    + (f" at {sig[1]}" if sig[1] else "")
                )
                sup.report.demotions.append(demo)
                return f"demoted {demo['rung']}: {demo['frm']}→{demo['to']}"
        return None

    def attempt(i, guard):
        guard()
        with collecting_demotions() as demos:
            res = count_triangles(graph, state["mesh"],
                                  fault_plan=fault_plan, **cfg)
        sup.report.demotions.extend(demos)
        return res

    with armed(fault_plan):
        res = sup.run(attempt, on_fault=on_fault)
    res.supervision = sup.report.to_dict()
    if fault_plan is not None:
        res.supervision["fault_log"] = list(fault_plan.log)
    return res


# ----------------------------------------------------------------------
# generic checkpointed step loop (run_with_restarts / stepper substrate)
# ----------------------------------------------------------------------
def supervise_loop(
    init_state: Callable[[], dict],
    step_fn: Callable[[dict, int], dict],
    *,
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 50,
    supervisor: Optional[Supervisor] = None,
    state_like=None,
    fault_injector: Optional[Callable[[int], None]] = None,
):
    """Drive ``step_fn`` for ``n_steps`` with periodic checkpoints under
    a :class:`Supervisor`: every failure restores the latest intact
    checkpoint (corrupt steps are quarantined by the manager) and
    resumes under backoff.  Returns ``(final_state, report)``."""
    from ..ckpt import CheckpointManager

    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=False)
    sup = supervisor or Supervisor(
        max_restarts=3,
        backoff=BackoffPolicy(base=0.01, max_delay=0.05),
        retry_on=(Exception,),
    )
    like = state_like or init_state()

    def attempt(i, guard):
        got_step, restored, extra = mgr.restore_latest(like)
        if restored is not None:
            state, step = restored, int(extra["next_step"])
            if i == 0:
                log.info("resumed from step %d", step)
        else:
            state, step = init_state(), 0
        while step < n_steps:
            guard()
            if fault_injector is not None:
                fault_injector(step)
            state = step_fn(state, step)
            step += 1
            if step % ckpt_every == 0 or step == n_steps:
                mgr.save(step, state, extra={"next_step": step})
        return state

    state = sup.run(attempt)
    mgr.close()
    return state, sup.report
