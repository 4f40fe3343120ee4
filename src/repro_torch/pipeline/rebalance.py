"""Skip-aware load rebalancing — a composable planning stage.

The paper's degree-ordered cyclic distribution bounds *task-count*
imbalance (Table 3), but with sparsity-aware step skipping the SPMD
critical path is the max **kept** probe work per schedule step — what the
engine actually executes.  This stage searches randomized relabelings
that perturb the vertex order only *within equal-degree runs* (preserving
the non-decreasing-degree property the algorithm's correctness and
locality arguments rely on) and keeps the seed minimizing:

1. **masked critical path** — per-step max over devices of probe work on
   kept steps only (``step_keep ⊙ probe_work_per_device_shift``), summed
   over steps;
2. tie-break: the fewest kept (device, step) pairs, i.e. the most
   skippable all-empty steps.

Trial seed 0 is always the *identity* on the degree-ordered graph — the
unrebalanced baseline — so the search can never return a plan worse than
the default pipeline's.

The stage slots between *relabel* and *decompose*: every trial reuses the
cached ingest digest and degree ordering, re-running only the
decompose+pack mask emission.  All three plan families participate —
Cannon ``(q, q, q)``, SUMMA ``(r, c, c)``, 1D ring ``(p, p)`` — through
their packers' probe-work stats (:class:`repro_torch.core.plan.StepStats`
/ ``PlanStats``).  Host numpy only, the same search as the JAX package's
module of the same name: the same seeds give the same permutations,
reports and winning plans.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..core.graph import Graph

__all__ = [
    "rebalance_trial_perm",
    "masked_critical_path",
    "plan_cost",
    "rebalance_stage",
]


def rebalance_trial_perm(degrees: np.ndarray, seed: int) -> np.ndarray:
    """Trial permutation for one rebalance seed (current id → new id).

    ``degrees`` are the degrees of an already degree-ordered graph
    (non-decreasing).  Seed 0 is the identity — the deterministic
    baseline; seeds ≥ 1 shuffle positions uniformly within each
    equal-degree run, so every trial keeps degrees non-decreasing.
    """
    n = int(degrees.shape[0])
    if seed == 0:
        return np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    jitter = rng.random(n)
    order = np.lexsort((jitter, degrees))  # degree blocks kept, ties shuffled
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n, dtype=np.int64)
    return perm


def masked_critical_path(
    probe: np.ndarray, step_keep: Optional[np.ndarray] = None
) -> float:
    """Sum over steps of the max per-device probe work on kept steps.

    ``probe`` is any ``(..., nsteps)`` per-(device, step) work array;
    ``step_keep`` (same shape, bool) zeroes skipped steps first.  With no
    mask this degenerates to the unmasked critical path.
    """
    probe = np.asarray(probe, dtype=np.int64)
    kept = probe if step_keep is None else np.where(step_keep, probe, 0)
    flat = kept.reshape(-1, kept.shape[-1]) if kept.ndim else kept
    if flat.size == 0:
        return 0.0
    return float(flat.max(axis=0).sum())


def plan_cost(plan) -> Tuple[float, int]:
    """Rebalance objective of a packed plan: ``(masked critical path,
    kept device-steps)``, minimized lexicographically.

    Requires the plan to carry probe stats (``with_stats``); the skip
    mask may be absent (then nothing is masked and every step counts as
    kept).
    """
    stats = plan.stats
    assert stats is not None, "rebalance needs a plan packed with_stats"
    probe = stats.probe_work_per_device_shift
    keep = getattr(plan, "step_keep", None)
    kept = int(keep.sum()) if keep is not None else int(probe.size)
    return masked_critical_path(probe, keep), kept


def rebalance_stage(
    graph: Graph,
    perm: Optional[np.ndarray],
    trials: int,
    pack_trial: Callable[[Graph], object],
) -> Tuple[Graph, Optional[np.ndarray], object, dict]:
    """Search ``trials`` relabeling seeds; return the winner.

    ``graph`` is the relabel stage's output (degree-ordered) and ``perm``
    the composed permutation so far; ``pack_trial(graph) -> plan`` must
    pack with probe stats and skip masks.  Returns the winning relabeled
    graph, the re-composed total permutation, the winning trial's packed
    plan (reusable by callers whose pack flags match the trial flags),
    and the search report (consumed verbatim by ``tc_run --rebalance``).
    """
    deg = graph.degrees()
    history = []
    best = None  # (cost tuple, seed, trial perm, trial graph, trial plan)
    for seed in range(int(trials)):
        tp = rebalance_trial_perm(deg, seed)
        gt = graph if seed == 0 else graph.relabel(
            tp, name=graph.name + f"+rb{seed}"
        )
        plan = pack_trial(gt)
        mcp, kept = plan_cost(plan)
        keep = getattr(plan, "step_keep", None)
        nsteps = int(keep.size) if keep is not None else kept
        history.append(
            dict(
                seed=seed,
                masked_critical_path=mcp,
                unmasked_critical_path=masked_critical_path(
                    plan.stats.probe_work_per_device_shift
                ),
                skipped_steps=nsteps - kept,
            )
        )
        if best is None or (mcp, kept) < best[0]:
            best = ((mcp, kept), seed, tp, gt, plan)
    (best_mcp, _), best_seed, best_tp, best_graph, best_plan = best
    baseline = history[0]["masked_critical_path"]
    # improvement = baseline / best, guarded only against a literal zero
    # denominator (an all-skippable best plan; inf is JSON-unsafe, so
    # report emitters serialize non-finite values as null)
    if best_mcp > 0:
        improvement = baseline / best_mcp
    else:
        improvement = 1.0 if baseline == 0 else float("inf")
    report = dict(
        trials=history,
        best_seed=best_seed,
        baseline_masked_critical_path=baseline,
        best_masked_critical_path=best_mcp,
        improvement=improvement,
        skipped_steps=history[best_seed]["skipped_steps"],
        baseline_skipped_steps=history[0]["skipped_steps"],
    )
    total = best_tp if perm is None else best_tp[perm]
    return best_graph, total, best_plan, report
