"""The single product of the host planning pipeline.

A :class:`PlanArtifact` bundles everything one planned graph needs to be
counted repeatedly: the relabeled host graph, the composed relabeling
permutation, the plan (host numpy), per-stage wall times, and
a memo space where the runners park derived state (the plan's tensors
staged on a device, built engine fns) so a cache hit skips *all*
per-call host work — planning and host→device staging.

Artifacts are what the schedule runners and ``build_*_fn`` functions consume;
``repro_torch.core.plan.as_plan`` coerces an artifact (or a raw plan) to
its plan object, so each of them accepts either.  Artifacts derived by
:func:`~repro_torch.pipeline.delta.apply_delta` carry their delta
``lineage`` (which keys their cache entry), the ``delta_report`` and a
re-stage handoff (``restage_from``) through which unchanged device
tensors of the parent are reused instead of uploaded again.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.graph import Graph

__all__ = ["PlanArtifact", "stage_arrays"]


def stage_arrays(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host numpy plan arrays → tensors on ``device`` (dtypes unchanged)."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in arrays.items()
    }


@dataclasses.dataclass
class PlanArtifact:
    """One planned graph, ready for repeated counting.

    ``kind`` names the plan family (``"cannon"``, ``"summa"`` or
    ``"oned"``); ``digest`` is the
    content digest of the *input* graph (pre-relabel), ``key`` the full
    cache key this artifact is stored under.
    """

    kind: str
    digest: str
    key: Tuple
    graph: Graph  # relabeled graph (the full one for a hub-split plan)
    perm: Optional[np.ndarray]  # composed relabeling, old id -> new id
    plan: Any  # TCPlan, SummaPlan or OneDPlan
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    cache_hit: bool = False
    # skip-aware rebalance search report: trial history, winning seed,
    # baseline/best masked critical path, skipped steps; None when the
    # plan was not rebalanced.  The trials knob is part of ``key``, so
    # rebalanced and plain artifacts never collide.
    rebalance: Optional[dict] = None
    # planner knobs this artifact was built with, recorded so the delta
    # path can re-pack stages or rebase with identical flags
    config: Optional[dict] = None
    # delta lineage: dict(root_digest, chain, depth) joining the cache
    # key of incrementally-derived artifacts; None for cold plans
    lineage: Optional[dict] = None
    # per-delta report (level, dirty blocks/cells, replanned stages,
    # rebased, fn_inherited) attached by ``apply_delta``; None for cold
    # plans
    delta_report: Optional[dict] = None
    # re-stage handoff from the parent artifact: (its host arrays, {str
    # device: its staged tensors on that device}), consumed lazily by
    # ``staged(device)`` so unchanged tensors are reused, not re-uploaded
    restage_from: Optional[Tuple[Dict, Dict]] = dataclasses.field(
        default=None, repr=False
    )
    _memo: Dict = dataclasses.field(default_factory=dict, repr=False)
    _memo_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False
    )

    # ------------------------------------------------------------------
    def device_arrays(self) -> Dict[str, np.ndarray]:
        return self.plan.device_arrays()

    @property
    def compact(self):
        """The plan's staged :class:`~repro_torch.core.plan.CompactSchedule`
        (globally-live steps + fused hop vector), or ``None`` when the
        compaction stage was off or had no mask to work from."""
        return getattr(self.plan, "compact", None)

    @property
    def autotune(self) -> Optional[dict]:
        """The deterministic kernel-shape autotune report (chunk,
        ``d_small``/``n_long`` split, ``tail_heavy``), or ``None``."""
        return getattr(self.plan, "autotune", None)

    @property
    def hubsplit(self) -> Optional[dict]:
        """The hub-split stage report (``h0``, ``hub_rows``,
        ``hub_nnz_frac``, …), or ``None`` when the stage was off or no row
        crossed the threshold."""
        hub = getattr(self.plan, "hub", None)
        return None if hub is None else hub.report()

    def memo(self, key, build: Callable):
        """Build-once storage for derived per-artifact state (staged
        tensors per device, engine fns keyed by method and knobs).
        Locked, so serving threads sharing a cached artifact build each
        entry once."""
        with self._memo_lock:
            if key not in self._memo:
                self._memo[key] = build()
            return self._memo[key]

    def staged(self, device) -> Dict[str, torch.Tensor]:
        """The plan arrays as ``torch`` tensors on ``device``, memoized per
        device (the pipeline's ``stage`` step); records its first-call
        wall time.  The numpy arrays stay on the plan: the engine reads
        ``m_cnt`` and ``step_keep`` from them on the host.

        A delta-derived artifact whose parent was staged on ``device``
        goes through the engine's re-stage path: every array the delta
        left unchanged keeps the parent's tensor, and the number of
        reused tensors lands in ``stage_seconds["stage_reused_buffers"]``.
        """
        device = torch.device(device)

        def build():
            t0 = time.perf_counter()
            handoff = self.restage_from
            prev = None if handoff is None else handoff[1].get(str(device))
            if prev is not None:
                from ..core.engine import restage_device_arrays

                out, reused = restage_device_arrays(
                    handoff[0], prev, self.device_arrays(), device
                )
                self.stage_seconds["stage_reused_buffers"] = float(reused)
            else:
                out = stage_arrays(self.device_arrays(), device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self.stage_seconds["stage"] = time.perf_counter() - t0
            return out

        return self.memo(("staged_arrays", str(device)), build)

    def staged_if_any(self, device) -> Optional[Dict[str, torch.Tensor]]:
        """The tensors :meth:`staged` memoised on ``device``, or ``None``
        when nothing was staged there yet; stages nothing itself."""
        with self._memo_lock:
            return self._memo.get(("staged_arrays", str(torch.device(device))))

    def release(self) -> None:
        """Drop memoized device state (staged tensors, engine fns) and the
        re-stage handoff.  Called by ``PlanCache`` on LRU eviction so
        pinned device memory does not outlive the cache entry while
        serving threads still hold the artifact; the next use simply
        rebuilds the memo entries."""
        with self._memo_lock:
            self._memo.clear()
            self.restage_from = None
