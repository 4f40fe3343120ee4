"""Schedule engine: one pluggable runtime for the distributed count, with
the whole logical processor grid held on a single device.

A distributed triangle count is expressed as the composition

    (OperandStore, ShiftSchedule, CountKernel, Reduction)

exactly as in the JAX package's module of the same name; what changes is
how the grid is realised.  There the ``q x q`` grid is a device mesh and
each device sees its own block.  Here the grid is the leading ``(q, q)``
dimensions of every stacked plan tensor on ONE device, so

* logical device ``(x, y)`` is the slice ``tensor[x, y]``;
* a Cannon shift (A left along the column axis, B up along the row axis,
  by ``k`` positions) is ``torch.roll`` of the A tensors by ``-k`` on dim 1
  and of the B tensors by ``-k`` on dim 0 — logical device ``(x, y)``
  then holds what ``(x, y+k)`` resp. ``(x+k, y)`` held, which is what
  :func:`shift_perm` prescribes;
* the global sum is a sum over the two grid dimensions;
* the scan over schedule steps is a host loop, and the per-(device, step)
  skip is a host ``if`` on the plan's *numpy* ``step_keep`` / ``m_cnt``
  (reading a device bool per step would synchronise q³ times per count).
  Only the final total crosses back to the host, once per count.

Carried over here: the CSR-kernel registry (``search``, ``global``,
``fused``), :class:`CSRStore` (with ``with_aug``), :func:`masked_count`,
:class:`CannonSchedule` (plain and compacted), :class:`Reduction`
(``flat``) and :func:`build_engine_fn`.  Not carried over yet: blob
packing and uint16 length compression of the shifted payload (a
communication optimisation with nothing to serialise on one device), the
dense/tile/SUMMA/ring stores and schedules, the 2.5D pod axis, the tree
reduction, the hub-split partial, batching and the stepper.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import count as count_mod

__all__ = [
    "OperandStore",
    "CSRStore",
    "ShiftSchedule",
    "CannonSchedule",
    "Reduction",
    "CSR_KERNELS",
    "register_csr_kernel",
    "make_csr_kernel",
    "check_fused_split",
    "masked_count",
    "build_engine_fn",
    "shift_perm",
]


# ======================================================================
# shared shift helpers
# ======================================================================
def shift_perm(size: int, k: int):
    """(source, destination) pairs shifting *towards lower index* by ``k``
    (left/up): position ``s`` sends its block to ``(s - k) % size``."""
    return [(s, (s - k) % size) for s in range(size)]


def _roll_tree(tree, k: int, dim: int):
    """Apply a :func:`shift_perm` of distance ``k`` to every stacked
    tensor of a payload along grid dimension ``dim``."""
    return tuple(torch.roll(t, shifts=-k, dims=dim) for t in tree)


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
    ``fused_tile``/``fused_long_fallback``); factories must tolerate and
    ignore keys they don't own.
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


def _global_factory(*, dpad, chunk, probe_shorter, sentinel, n_long, d_small,
                    **extra):
    del probe_shorter, sentinel, n_long, d_small, extra
    return functools.partial(
        count_mod.count_pair_search_global, dpad=dpad, chunk=chunk
    )


def _fused_factory(*, dpad, chunk, probe_shorter, sentinel, n_long, d_small,
                   **extra):
    """Fused intersection kernel + long-row fallback.

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

    tile = extra.get("fused_tile")
    long_fallback = extra.get("fused_long_fallback", "global")

    def kernel(a_ptr, a_idx, b_ptr, b_idx, ti, tj, cnt, aug_b=None):
        return count_pair_fused(
            a_ptr, a_idx, b_ptr, b_idx, ti, tj, cnt,
            n_long=n_long,
            d_small=d_small,
            dpad_long=dpad,
            chunk=chunk,
            tile=tile,
            long_fallback=long_fallback,
            probe_shorter=probe_shorter,
            sentinel=sentinel,
            aug_b=aug_b,
        )

    return kernel


register_csr_kernel("search", _search_factory)
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
    * ``payload(arrays)`` — the shiftable state ``(a_state, b_state)``:
      two tuples of stacked ``(q, q, ...)`` tensors; schedules treat them
      opaquely and roll them along the grid dimensions.
    * ``count(state, arrays, x, y, cnt)`` — run the bound count kernel for
      logical device ``(x, y)`` on the current state.
    """

    operand_names: Sequence[str] = ()
    static_names: Sequence[str] = ()

    @property
    def names(self):
        return tuple(self.operand_names) + tuple(self.static_names)

    def payload(self, arrays: Dict):
        raise NotImplementedError

    def count(self, state, arrays: Dict, x: int, y: int, cnt: int):
        raise NotImplementedError


class CSRStore(OperandStore):
    """CSR-block operands, shifted as the stacked tensors they are.

    ``with_aug=True`` adds the planner-staged row-encoded intersection
    keys (``b_aug``) as an extra payload leaf travelling with the B
    operand: the keys shift with the blocks, so the ``global`` kernel
    (and the fused kernel's long-row fallback) never rebuild them on the
    device.
    """

    operand_names = ("a_indptr", "a_indices", "b_indptr", "b_indices")
    static_names = ("m_ti", "m_tj", "m_cnt")

    def __init__(self, kernel, *, with_aug: bool = False):
        self.kernel = kernel
        self.with_aug = with_aug
        if with_aug:
            self.operand_names = self.operand_names + ("b_aug",)

    def payload(self, arrays):
        a_state = (arrays["a_indptr"], arrays["a_indices"])
        b_state = (arrays["b_indptr"], arrays["b_indices"])
        if self.with_aug:
            b_state = b_state + (arrays["b_aug"],)
        return (a_state, b_state)

    def count(self, state, arrays, x, y, cnt):
        (a_ptr, a_idx), b_state = state
        extra = {}
        if self.with_aug:
            b_ptr, b_idx, aug = b_state
            extra = dict(aug_b=aug[x, y])
        else:
            b_ptr, b_idx = b_state
        return self.kernel(
            a_ptr[x, y], a_idx[x, y], b_ptr[x, y], b_idx[x, y],
            arrays["m_ti"][x, y], arrays["m_tj"][x, y], cnt,
            **extra,
        )


# ======================================================================
# shift schedules
# ======================================================================
def masked_count(store, state, arrays, x, y, step, cnt, step_keep):
    """One logical device's count for one schedule step, short-circuited
    on the host by the planner's mask.

    ``step_keep`` is the plan's numpy ``(q, q, nsteps)`` bool array (True
    = this step's incoming block pair can contribute) or ``None``;
    returns ``None`` when the step is masked off or the device has no
    tasks, so no kernel is launched at all.  Shifts stay outside — the
    whole grid rolls together whether or not a device counts.
    """
    if step_keep is not None and not step_keep[x, y, step]:
        return None
    if cnt <= 0:
        return None
    return store.count(state, arrays, x, y, cnt)


class ShiftSchedule:
    """Permutation structure for the host loop.

    ``run`` executes the whole schedule and returns the ``(q, q)`` int64
    tensor of per-device totals: the plain loop over all steps normally,
    or — when ``live_steps`` is set (a compacted schedule) — only the
    globally-live steps, with the elided unit shifts fused into multi-hop
    rolls.  Step indices stay in the ORIGINAL numbering either way, so
    the staged ``step_keep`` mask is indexed unremapped.
    """

    live_steps: Optional[Tuple[int, ...]] = None

    def run(self, store: OperandStore, arrays: Dict, *, m_cnt, step_keep=None):
        raise NotImplementedError


@dataclasses.dataclass
class CannonSchedule(ShiftSchedule):
    """Cannon's q-step {count, shift-A-left, shift-B-up} rotation.

    ``double_buffer`` is accepted for signature parity and gives the same
    count: the JAX package overlaps the next shift's collective with the
    current count by carrying two payload generations; in an eager loop
    on one device there is no collective to overlap (a roll is an
    ordinary kernel on the same stream), so one generation is carried.
    """

    q: int
    double_buffer: bool = True
    # compacted schedule: original indices of the globally-live steps
    # (strictly increasing); ``run`` then visits only them
    live_steps: Optional[Tuple[int, ...]] = None

    @property
    def nsteps(self) -> int:
        return self.q

    def _shift_k(self, payload, hop: int):
        """Fused shift of ``hop`` schedule steps (one roll per tensor
        regardless of hop — the multi-hop fusion)."""
        k = hop % self.q
        if k == 0:
            return payload
        a_state, b_state = payload
        return (_roll_tree(a_state, k, 1), _roll_tree(b_state, k, 0))

    def _count_grid(self, store, payload, arrays, step, m_cnt, step_keep, out):
        for x in range(self.q):
            for y in range(self.q):
                c = masked_count(
                    store, payload, arrays, x, y, step, int(m_cnt[x, y]),
                    step_keep,
                )
                if c is not None:
                    out[x, y] += c

    def run(self, store, arrays, *, m_cnt, step_keep=None):
        dev = arrays["m_ti"].device
        out = torch.zeros((self.q, self.q), dtype=torch.int64, device=dev)
        payload = store.payload(arrays)
        if self.live_steps is not None:
            return self._run_compacted(
                store, payload, arrays, m_cnt, step_keep, out
            )
        for s in range(self.nsteps):
            self._count_grid(store, payload, arrays, s, m_cnt, step_keep, out)
            if s + 1 < self.nsteps:
                payload = self._shift_k(payload, 1)
        return out

    def _run_compacted(self, store, payload, arrays, m_cnt, step_keep, out):
        """Kept-step loop: count only the live steps, reach each via one
        fused multi-hop roll — the prologue hop is ``live[0]``, later hops
        are differences of ORIGINAL step indices."""
        live = self.live_steps
        if not live:
            return out  # everything elided: no shifts, no counts
        payload = self._shift_k(payload, live[0])
        for i, s in enumerate(live):
            self._count_grid(store, payload, arrays, s, m_cnt, step_keep, out)
            if i + 1 < len(live):
                payload = self._shift_k(payload, live[i + 1] - s)
        return out


# ======================================================================
# reductions
# ======================================================================
@dataclasses.dataclass(frozen=True)
class Reduction:
    """Global sum of the per-device partials, or per-device outputs.

    Only the ``"flat"`` strategy exists here (``"auto"`` resolves to it):
    a sum over both grid dimensions.  The 2.5D ``"tree"`` reduction needs
    a pod axis, which this package does not have yet.
    """

    global_sum: bool = True
    strategy: str = "auto"  # "flat" | "auto"

    def resolve(self) -> "Reduction":
        if self.strategy == "tree":
            raise ValueError(
                "reduce strategy 'tree' needs a pod axis with npods > 1; "
                "use 'flat' (or 'auto') on single-pod grids"
            )
        if self.strategy not in ("flat", "auto"):
            raise ValueError(
                f"unknown reduce strategy {self.strategy!r}; "
                "expected 'flat' or 'auto'"
            )
        return dataclasses.replace(self, strategy="flat")

    def apply(self, per_device):
        return per_device.sum() if self.global_sum else per_device


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
):
    """Generate the counting function for one composition.

    Returns ``call(**arrays)`` over the staged plan tensors (stacked
    ``(q, q, ...)``, all on one device) yielding the global count as a
    0-dim int64 tensor on that device — or the ``(q, q)`` per-device
    counts with ``Reduction(global_sum=False)``.  The call does not
    synchronise; ``int(result)`` does, once.

    ``m_cnt`` and ``step_keep`` are the plan's *host* arrays: the loop
    reads task counts and the skip mask from them, never from the
    device.  ``step_keep=None`` runs every (device, step) pair.
    """
    reduction = (reduction or Reduction()).resolve()
    m_cnt = np.asarray(m_cnt)
    keep = None if step_keep is None else np.asarray(step_keep, dtype=bool)
    ordered = list(store.names)

    def call(**arrays):
        missing = [k for k in ordered if k not in arrays]
        if missing:
            raise KeyError(f"engine call is missing plan arrays {missing}")
        devices = {arrays[k].device for k in ordered}
        if len(devices) != 1:
            raise ValueError(f"plan arrays live on several devices: {devices}")
        per_device = schedule.run(store, arrays, m_cnt=m_cnt, step_keep=keep)
        return reduction.apply(per_device)

    call.ordered = ordered
    return call
