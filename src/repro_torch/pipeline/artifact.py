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
from ..launch.mesh import DeviceMesh

__all__ = ["PlanArtifact", "stage_arrays", "stage_on_mesh", "mesh_slice",
           "mesh_layout"]


def stage_arrays(arrays: Dict[str, np.ndarray], device, *,
                 specs: Optional[Dict[str, Tuple[str, ...]]] = None,
                 batched: bool = False):
    """Host numpy plan arrays → tensors on ``device`` (dtypes unchanged).

    ``device`` may be a :class:`~repro_torch.launch.mesh.DeviceMesh`: each
    array then becomes a :class:`~repro_torch.core.engine.MeshArray`
    (:func:`stage_on_mesh`), its leading dimensions split over the mesh
    axes ``specs[name]`` names (all the mesh's axes, in order, for a name
    ``specs`` lacks), and with ``batched`` after a leading batch dimension
    that every block keeps."""
    if isinstance(device, DeviceMesh):
        specs = specs or {}
        return {k: stage_on_mesh(v, device, specs.get(k), batched=batched)
                for k, v in arrays.items()}
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in arrays.items()
    }


def mesh_slice(host: np.ndarray, mesh: DeviceMesh, pos, axes=None, *,
               batched: bool = False) -> np.ndarray:
    """Grid position ``pos``'s block of a host array whose leading
    dimensions are split over the mesh axes ``axes`` (``None``: every axis
    of the mesh, in order); an axis the array is not split over
    replicates it (Cannon's task lists over the pods)."""
    axes = tuple(mesh.axis_names) if axes is None else tuple(axes)
    sel = tuple(pos[mesh.axis_names.index(a)] for a in axes)
    return host[(slice(None),) + sel] if batched else host[sel]


def stage_on_mesh(host: np.ndarray, mesh: DeviceMesh, axes=None, *,
                  batched: bool = False, reuse=None):
    """One host array as a :class:`~repro_torch.core.engine.MeshArray`:
    position ``pos`` gets :func:`mesh_slice` on its own device.  ``reuse``
    is ``(parent host array, parent MeshArray)`` staged the same way: a
    position whose slice is unchanged keeps the parent's block."""
    from ..core.engine import MeshArray

    blocks = {}
    for pos in np.ndindex(*mesh.shape):
        part = mesh_slice(host, mesh, pos, axes, batched=batched)
        if reuse is not None:
            old_host, old = reuse
            prev = mesh_slice(old_host, mesh, pos, axes, batched=batched)
            if prev.shape == part.shape and np.array_equal(prev, part):
                blocks[pos] = old.blocks[pos]
                continue
        # a position's scalar stays 0-dim (ascontiguousarray makes it 1-d)
        part = np.ascontiguousarray(part).reshape(np.shape(part))
        blocks[pos] = torch.from_numpy(part).to(mesh.device_at(pos))
    return MeshArray(mesh, blocks)


def mesh_layout(kind: str, arrays: Dict[str, np.ndarray], mesh: DeviceMesh):
    """``(arrays, specs)`` of a plan staged on ``mesh``: a Cannon plan on a
    ``(pod, row, col)`` mesh is first stacked over the pods as
    :func:`~repro_torch.core.cannon.pod_stack_arrays` lays it out, with
    :func:`~repro_torch.core.cannon.cannon_in_specs`; every other array
    splits over all the mesh's axes."""
    if kind == "cannon" and len(mesh.shape) == 3:
        from ..core.cannon import cannon_in_specs, pod_stack_arrays
        from ..core.engine import GridAxes

        axes = GridAxes.of(mesh)
        return (pod_stack_arrays(arrays, mesh.shape[0], mesh.shape[-1]),
                cannon_in_specs(axes.row, axes.col, axes.pod))
    return arrays, {}


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

        ``device`` may be a :class:`~repro_torch.launch.mesh.DeviceMesh`
        (memoized per mesh): position ``(x, y)``'s slice of each stacked
        array then lies on that position's device (:func:`mesh_layout`:
        a Cannon plan on a pod mesh stacked over the pods first).

        A delta-derived artifact whose parent was staged on ``device``
        goes through the engine's re-stage path: every array the delta
        left unchanged keeps the parent's tensor, and the number of
        reused tensors lands in ``stage_seconds["stage_reused_buffers"]``.
        """
        mesh = device if isinstance(device, DeviceMesh) else None
        key = mesh if mesh is not None else str(torch.device(device))

        def layout(arrays):
            return (mesh_layout(self.kind, arrays, mesh) if mesh is not None
                    else (arrays, {}))

        def build():
            t0 = time.perf_counter()
            handoff = self.restage_from
            prev = None if handoff is None else handoff[1].get(key)
            host, specs = layout(self.device_arrays())
            target = mesh if mesh is not None else torch.device(device)
            if prev is not None:
                from ..core.engine import restage_device_arrays

                out, reused = restage_device_arrays(
                    layout(handoff[0])[0], prev, host, target, specs=specs
                )
                self.stage_seconds["stage_reused_buffers"] = float(reused)
            elif mesh is None:
                out = stage_arrays(host, target)
            else:
                out = stage_arrays(host, mesh, specs=specs)
            for dev in set(mesh.devices if mesh is not None else [target]):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self.stage_seconds["stage"] = time.perf_counter() - t0
            return out

        return self.memo(("staged_arrays", key), build)

    def staged_if_any(self, device) -> Optional[Dict[str, torch.Tensor]]:
        """The tensors :meth:`staged` memoised on ``device``, or ``None``
        when nothing was staged there yet; stages nothing itself."""
        key = (device if isinstance(device, DeviceMesh)
               else str(torch.device(device)))
        with self._memo_lock:
            return self._memo.get(("staged_arrays", key))

    def release(self) -> None:
        """Drop memoized device state (staged tensors, engine fns) and the
        re-stage handoff.  Called by ``PlanCache`` on LRU eviction so
        pinned device memory does not outlive the cache entry while
        serving threads still hold the artifact; the next use simply
        rebuilds the memo entries."""
        with self._memo_lock:
            self._memo.clear()
            self.restage_from = None
