"""The port's 2.5D pods, tree reduction and distributed degree rank against
the JAX package.

Pods are a further leading grid dimension of the port's staged tensors
(Cannon's A and B replicated at per-pod skew offsets, pod ``t`` running
the global steps ``t, t + npods, ...``); the reference runs them on a
``(pod, row, col)`` mesh of host devices.  Staging must be byte-identical,
counts and per-device partials equal (three subprocesses of the
reference: 8 devices for q = 2 with 2 pods, 32 for q = 4 with 2, 64 for
q = 4 with 4), every refusal the reference's, and every count ``==`` the
oracle.  Where the reference has no pod dimension (SUMMA, the tile and
dense paths) or runs the ring over every device, the port does the same.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.pipeline as jp
import repro_torch as rt
import repro_torch.core as tc
import repro_torch.pipeline as tp
from repro_torch.core.cannon import build_cannon_fn, pod_stack_arrays
from repro_torch.core.engine import (
    CannonSchedule,
    Reduction,
    pod_tree_allreduce,
)
from repro_torch.core.plan import resolve_compact_steps
from repro_torch.core.preprocess import distributed_degree_rank
from repro_torch.launch import tc_run
from repro_torch.pipeline.artifact import stage_arrays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIXTURES = {
    "karate": "named:karate",
    "cliques3": "cliques:3,60",
    "rmat8": "rmat:8,8,5",
    # block-diagonal at q = 4: the mask keeps global steps 0 and 3 only
    # (cliques4) or 1 and 3 on half the devices (cliques2), so a pod that
    # read its mask at its LOCAL step would skip live work
    "cliques4": "cliques:4,60",
    "cliques2": "cliques:2,40",
    "er": "er:200,6,3",
}
CSR_METHODS = ("search", "global", "search2", "fused")
STRATEGIES = ("flat", "tree", "auto")
REF8_NAMES = ("karate", "cliques3", "rmat8")  # q = 2, 2 pods
REF_Q4_NAMES = ("cliques3", "cliques4", "rmat8")  # q = 4, 2 and 4 pods
HUB_C = 2.0  # a hub-split threshold that cuts hub rows off karate and rmat8

_ORACLE = {}


def _graph(name):
    return tc.graph_from_spec(FIXTURES[name])


def _oracle(name):
    if name not in _ORACLE:
        _ORACLE[name] = tc.triangle_count_oracle(_graph(name))
    return _ORACLE[name]


def _count(name, cache=None, **kw):
    return rt.count_triangles(_graph(name), device="cpu",
                              cache=cache or tp.PlanCache(), **kw)


# one cache for the oracle sweep: its counts share plans, staged pods and
# engine fns (memoised per pod count, method and strategy)
_SWEEP_CACHE = tp.PlanCache(maxsize=256)


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return f"ERR ValueError: {e}"
    raise AssertionError("expected a ValueError")


def _result(out):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


# ----------------------------------------------------------------------
# the reference on host meshes
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_8(distributed_runner):
    """The JAX package on 8 host devices: q = 2 with 2 pods — counts of
    every CSR method x reduce strategy x compaction, hub-split counts,
    dense / tile / SUMMA / ring counts or refusals, ``TCResult.grid``,
    delta counts, per-device partials with and without a hub side; and
    its ``distributed_degree_rank`` over 4 of the devices."""
    names = {k: FIXTURES[k] for k in REF8_NAMES}
    code = f"""
import json
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import count_triangles, count_triangles_delta, graph_from_spec, rmat
from repro.core.cannon import build_cannon_fn, pod_stack_arrays
from repro.core.preprocess import distributed_degree_rank
import repro.pipeline as jp
Q, NPODS = 2, 2
HUB_C = {HUB_C!r}
out = {{}}
def run(key, fn):
    try:
        out[key] = fn()
    except ValueError as e:
        out[key] = f"ERR ValueError: {{e}}"
mesh = compat.make_mesh((NPODS, Q, Q), ("pod", "data", "model"))
for name, spec in {names!r}.items():
    g = graph_from_spec(spec)
    for m in {CSR_METHODS!r}:
        for strat in {STRATEGIES!r}:
            for compact in (None, False):
                run(f"{{name}}/cannon/{{m}}/{{strat}}/{{compact}}",
                    lambda: count_triangles(g, q=Q, npods=NPODS, method=m,
                        reduce_strategy=strat, compact=compact).triangles)
    for m in ("search", "fused"):
        for strat in ("flat", "tree"):
            run(f"{{name}}/hub/{{m}}/{{strat}}", lambda: count_triangles(
                g, q=Q, npods=NPODS, method=m, reduce_strategy=strat,
                hub_split=HUB_C).triangles)
    for strat in {STRATEGIES!r}:
        for m in ("dense", "tile"):
            run(f"{{name}}/{{m}}/{{strat}}", lambda: count_triangles(
                g, q=Q, npods=NPODS, method=m, reduce_strategy=strat).triangles)
        for sched in ("summa", "oned"):
            run(f"{{name}}/{{sched}}/{{strat}}", lambda: count_triangles(
                g, q=Q, npods=NPODS, schedule=sched,
                reduce_strategy=strat).triangles)
    out[f"{{name}}/oned/global"] = count_triangles(
        g, q=Q, npods=NPODS, schedule="oned", method="global").triangles
    for sched in ("cannon", "summa", "oned"):
        out[f"{{name}}/{{sched}}/grid"] = list(count_triangles(
            g, q=Q, npods=NPODS, schedule=sched).grid)
        d = jp.EdgeDelta.random_flips(g, 5, seed=2)
        out[f"{{name}}/{{sched}}/delta"] = count_triangles_delta(
            g, d, q=Q, npods=NPODS, schedule=sched, method="fused").triangles
    for hub in (False, True):
        art = jp.plan_cannon(g, Q, hub_split=HUB_C if hub else False,
                             cache=jp.PlanCache())
        fn = build_cannon_fn(art.plan, mesh, pod_axis="pod",
                             reduce_global=False)
        st = {{k: jnp.asarray(v) for k, v in
              pod_stack_arrays(art.plan.device_arrays(), NPODS, Q).items()}}
        out[f"{{name}}/per/{{hub}}"] = np.asarray(fn(**st)).reshape(
            NPODS, Q, Q).tolist()
g = rmat(6, 6, seed=9)
mesh4 = compat.make_mesh((4,), ("x",), devices=jax.devices()[:4])
fn = jax.jit(compat.shard_map(
    lambda d: distributed_degree_rank(d, "x"),
    mesh=mesh4, in_specs=P("x"), out_specs=P("x"), check_vma=False))
out["rank"] = np.asarray(fn(jnp.asarray(g.degrees(), dtype=jnp.int32))).tolist()
print("RESULT" + json.dumps(out))
"""
    return _result(distributed_runner(code, ndev=8))


def _reference_q4(distributed_runner, npods):
    names = {k: FIXTURES[k] for k in REF_Q4_NAMES}
    code = f"""
import json
import jax.numpy as jnp
import numpy as np
from repro import compat
from repro.core import count_triangles, graph_from_spec
from repro.core.cannon import build_cannon_fn, pod_stack_arrays
import repro.pipeline as jp
Q, NPODS = 4, {npods}
out = {{}}
mesh = compat.make_mesh((NPODS, Q, Q), ("pod", "data", "model"))
for name, spec in {names!r}.items():
    g = graph_from_spec(spec)
    for m in ("search", "fused"):
        for strat in {STRATEGIES!r}:
            out[f"{{name}}/{{m}}/{{strat}}"] = count_triangles(
                g, q=Q, npods=NPODS, method=m, reduce_strategy=strat).triangles
    art = jp.plan_cannon(g, Q, cache=jp.PlanCache())
    fn = build_cannon_fn(art.plan, mesh, pod_axis="pod", reduce_global=False)
    st = {{k: jnp.asarray(v) for k, v in
          pod_stack_arrays(art.plan.device_arrays(), NPODS, Q).items()}}
    out[f"{{name}}/per"] = np.asarray(fn(**st)).reshape(NPODS, Q, Q).tolist()
print("RESULT" + json.dumps(out))
"""
    return _result(distributed_runner(code, ndev=Q4 * Q4 * npods))


Q4 = 4


@pytest.fixture(scope="module")
def reference_q4(distributed_runner):
    """The JAX package at q = 4 with 2 pods (32 host devices) and with 4
    pods (64): counts and per-device partials, keyed by pod count."""
    return {n: _reference_q4(distributed_runner, n) for n in (2, 4)}


# ----------------------------------------------------------------------
# staging
# ----------------------------------------------------------------------
@pytest.mark.parametrize("q,npods", [(2, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("kw", [dict(), dict(aug_keys=True),
                                dict(hub_split=True)],
                         ids=["plain", "aug", "hub"])
def test_pod_stack_arrays_byte_identical(q, npods, kw):
    from repro.core.cannon import pod_stack_arrays as j_stack

    ga = jc.graph_from_spec("rmat:8,8,5")
    gb = tc.graph_from_spec("rmat:8,8,5")
    pa = jp.plan_cannon(ga, q, cache=jp.PlanCache(), **kw).plan
    pb = tp.plan_cannon(gb, q, cache=tp.PlanCache(), **kw).plan
    want = j_stack({k: np.asarray(v) for k, v in pa.device_arrays().items()},
                   npods, q)
    got = pod_stack_arrays(pb.device_arrays(), npods, q)
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    # replicated: A/B gain the pod dimension; task lists and the hub
    # side (the stationary mask block) do not
    assert got["a_indices"].shape == (npods,) + pb.a_indices.shape
    assert got["step_keep"].shape == (npods, q, q, q // npods)
    assert got["m_ti"] is pb.m_ti


def test_pod_staging_is_memoised_per_pod_count():
    g = _graph("rmat8")
    cache = tp.PlanCache()
    r1 = rt.count_triangles(g, q=4, npods=2, device="cpu", cache=cache)
    art = r1.artifact
    st = art._memo[("pod_staged", 2, "cpu")]
    assert "pod_stage_2" in art.stage_seconds
    r2 = rt.count_triangles(g, q=4, npods=2, device="cpu", cache=cache)
    assert r2.artifact is art and art._memo[("pod_staged", 2, "cpu")] is st
    # once the single pod is staged, a pod count uploads only A and B: the
    # task lists are the single-pod tensors themselves
    rt.count_triangles(g, q=4, npods=1, device="cpu", cache=cache)
    one = art.staged("cpu")
    r4 = rt.count_triangles(g, q=4, npods=4, device="cpu", cache=cache)
    st4 = art._memo[("pod_staged", 4, "cpu")]
    for k in ("m_ti", "m_tj", "m_cnt"):
        assert st4[k] is one[k]
    for k in ("a_indptr", "a_indices", "b_indptr", "b_indices"):
        assert st4[k] is not one[k] and st4[k].shape[0] == 4
    assert r1.triangles == r2.triangles == r4.triangles == _oracle("rmat8")
    assert tuple(st["a_indices"].shape[:3]) == (2, 4, 4)


@pytest.mark.parametrize("hub", [False, True])
def test_first_pod_count_stages_no_single_pod_tensor(hub):
    """A first count with pods holds A and B ``npods`` times, not
    ``npods + 1``: the single pod is not staged for it, and the stacked
    mask stays on the host."""
    g = _graph("karate" if hub else "rmat8")
    r = rt.count_triangles(g, q=2, npods=2, device="cpu",
                           cache=tp.PlanCache(),
                           hub_split=HUB_C if hub else False)
    art = r.artifact
    assert r.triangles == _oracle("karate" if hub else "rmat8")
    assert art.staged_if_any("cpu") is None
    assert not any(k[0] == "staged_arrays" for k in art._memo)
    st = art._memo[("pod_staged", 2, "cpu")]
    assert "step_keep" not in st
    host = art.plan.device_arrays()
    for k, v in st.items():
        if k.startswith(("a_", "b_")):
            assert tuple(v.shape) == (2,) + host[k].shape, k
        else:
            assert tuple(v.shape) == host[k].shape, k
    assert (art.plan.hub is not None) == hub


# ----------------------------------------------------------------------
# the schedule and the tree
# ----------------------------------------------------------------------
def test_pod_schedule_strides_the_global_steps():
    s = CannonSchedule(q=4, npods=2)
    assert s.grid == (2, 4, 4) and s.nsteps == 2
    # pod t's loop step s is global step t + s * npods, its tasks (x, y)'s
    assert s.locate((1, 2, 3), 1) == ((2, 3), 3)
    assert s.locate((0, 2, 3), 1) == ((2, 3), 2)
    assert CannonSchedule(q=4).locate((2, 3), 1) == ((2, 3), 1)
    a = torch.arange(2 * 4 * 4).view(2, 4, 4)
    (a2,), (b2,) = s._shift_k(((a,), (a,)), 1)  # one loop step = 2 shifts
    assert torch.equal(a2, torch.roll(a, -2, dims=2))
    assert torch.equal(b2, torch.roll(a, -2, dims=1))
    assert s._shift_k(((a,), (a,)), 2)[0][0] is a  # a full turn


@pytest.mark.parametrize("q,npods", [(2, 4), (3, 2), (4, 3)])
def test_pods_must_divide_the_grid(q, npods):
    """The reference refuses a pod count that does not divide q with the
    ValueError of stacking a ragged strided mask; the port refuses the
    same input before staging anything, naming the cause."""
    from repro.core.cannon import pod_stack_arrays as j_stack

    pa = jp.plan_cannon(jc.graph_from_spec("named:karate"), q,
                        cache=jp.PlanCache()).plan
    with pytest.raises(ValueError):
        j_stack({k: np.asarray(v) for k, v in pa.device_arrays().items()},
                npods, q)
    with pytest.raises(ValueError, match="pods must divide the grid"):
        _count("karate", q=q, npods=npods)
    with pytest.raises(ValueError, match="pods must divide the grid"):
        CannonSchedule(q=q, npods=npods)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(), (3,), (2, 5)], ids=str)
def test_pod_tree_allreduce_is_the_sum_everywhere(n, shape):
    x = torch.arange(n * int(np.prod(shape)), dtype=torch.int64).view(
        n, *shape) * 7 + 1
    got = pod_tree_allreduce(x, n)
    assert got.shape == x.shape
    for t in range(n):
        assert torch.equal(got[t], x.sum(dim=0))


def test_pod_tree_allreduce_refuses_a_non_power_of_two():
    from repro.core.engine import pod_tree_allreduce as j_tree

    with pytest.raises(AssertionError) as want:
        j_tree(0.0, "pod", 3)
    with pytest.raises(ValueError) as got:
        pod_tree_allreduce(torch.zeros(3), 3)
    assert str(got.value) == str(want.value)


def _reference_resolve(strategy, npods):
    from repro.core.engine import GridAxes
    from repro.core.engine import Reduction as JReduction

    pod = "pod" if npods > 1 else None
    mesh = types.SimpleNamespace(shape={"pod": npods})
    r = JReduction(strategy=strategy).resolve(
        mesh, GridAxes("data", "model", pod))
    return r.strategy, r.npods


@pytest.mark.parametrize("npods", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("strategy", ["flat", "tree", "auto", "bogus"])
def test_reduction_resolves_and_refuses_as_the_reference(strategy, npods):
    try:
        want = _reference_resolve(strategy, npods)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            Reduction(strategy=strategy).resolve(npods)
        assert str(got.value) == str(e)
        return
    r = Reduction(strategy=strategy).resolve(npods)
    assert (r.strategy, r.npods) == want


def test_compact_true_with_pods_is_refused_as_the_reference():
    from repro.core.plan import resolve_compact_steps as j_resolve

    pa = jp.plan_cannon(jc.graph_from_spec("cliques:3,60"), 3,
                        cache=jp.PlanCache()).plan
    pb = tp.plan_cannon(tc.graph_from_spec("cliques:3,60"), 3,
                        cache=tp.PlanCache()).plan
    with pytest.raises(ValueError) as want:
        j_resolve(pa, True, npods=3)
    with pytest.raises(ValueError) as got:
        resolve_compact_steps(pb, True, npods=3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="multi-pod"):
        _count("cliques3", q=3, npods=3, compact=True)
    assert resolve_compact_steps(pb, None, npods=3) is None
    assert resolve_compact_steps(pb, None) == j_resolve(pa, None)


def test_tree_without_pods_is_refused_as_the_reference():
    g = jc.graph_from_spec("named:karate")
    for kw in (dict(), dict(schedule="oned"), dict(method="dense")):
        with pytest.raises(ValueError) as want:
            jc.count_triangles(g, q=1, reduce_strategy="tree", **kw)
        with pytest.raises(ValueError) as got:
            _count("karate", q=1, reduce_strategy="tree", **kw)
        assert str(got.value) == str(want.value)
    # the reference's SUMMA and tile runners never pass the strategy on:
    # both count, as in the JAX package
    for kw in (dict(schedule="summa"), dict(method="tile")):
        want = jc.count_triangles(g, q=1, reduce_strategy="tree", **kw)
        got = _count("karate", q=1, reduce_strategy="tree", **kw)
        assert got.triangles == want.triangles == 45


# ----------------------------------------------------------------------
# counts against the oracle (port only) and the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compact", [None, False])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("method", CSR_METHODS)
@pytest.mark.parametrize("q,npods", [(2, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("name", ["cliques3", "cliques4", "cliques2", "er"])
def test_pod_counts_match_the_oracle(name, q, npods, method, strategy,
                                     compact):
    r = _count(name, q=q, npods=npods, method=method,
               reduce_strategy=strategy, compact=compact,
               cache=_SWEEP_CACHE)
    assert r.triangles == _oracle(name)
    assert r.grid == (npods, q, q)


@pytest.mark.parametrize("strategy", ["flat", "auto"])
def test_three_pods_count_flat(strategy):
    r = _count("cliques3", q=3, npods=3, method="fused",
               reduce_strategy=strategy)
    assert r.triangles == _oracle("cliques3") and r.grid == (3, 3, 3)
    with pytest.raises(ValueError, match="power-of-two pod count, got npods=3"):
        _count("cliques3", q=3, npods=3, reduce_strategy="tree")


@pytest.mark.parametrize("compact", [None, False])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("method", CSR_METHODS)
@pytest.mark.parametrize("name", REF8_NAMES)
def test_cannon_pods_match_the_reference(reference_8, name, method, strategy,
                                         compact):
    r = _count(name, q=2, npods=2, method=method, reduce_strategy=strategy,
               compact=compact)
    want = reference_8[f"{name}/cannon/{method}/{strategy}/{compact}"]
    assert r.triangles == want == _oracle(name)


@pytest.mark.parametrize("strategy", ["flat", "tree"])
@pytest.mark.parametrize("method", ["search", "fused"])
@pytest.mark.parametrize("name", REF8_NAMES)
def test_hub_split_pods_match_the_reference(reference_8, name, method,
                                            strategy):
    r = _count(name, q=2, npods=2, method=method, reduce_strategy=strategy,
               hub_split=HUB_C)
    want = reference_8[f"{name}/hub/{method}/{strategy}"]
    assert r.triangles == want == _oracle(name)


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("name", REF8_NAMES)
def test_per_device_partials_match_the_reference(reference_8, name, hub):
    """Per (pod, x, y) partials: the pod striding, and the hub side counted
    on pod 0 only (the reference zeroes it on every other pod)."""
    art = tp.plan_cannon(_graph(name), 2, hub_split=HUB_C if hub else False,
                         cache=tp.PlanCache())
    if hub and name != "cliques3":  # equal degrees: no hub row
        assert art.plan.hub is not None
    fn = build_cannon_fn(art.plan, npods=2, reduce_global=False)
    st = stage_arrays(pod_stack_arrays(art.plan.device_arrays(), 2, 2),
                         "cpu")
    per = fn(**st)
    assert tuple(per.shape) == (2, 2, 2)
    assert per.tolist() == reference_8[f"{name}/per/{hub}"]
    assert int(per.sum()) == _oracle(name)
    if art.plan.hub is not None:  # the hub partial lands on pod 0 alone
        residual = build_cannon_fn(dataclasses.replace(art.plan, hub=None),
                                   npods=2, reduce_global=False)(**st)
        hub_part = per - residual
        assert not hub_part[1].any() and int(hub_part[0].sum()) > 0


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", ["dense", "tile", "summa", "oned"])
@pytest.mark.parametrize("name", REF8_NAMES)
def test_paths_without_a_pod_dimension_match_the_reference(
        reference_8, name, kind, strategy):
    """dense, tile and SUMMA have no pod dimension in the reference (it
    replicates whole rounds); the ring runs over every device of the
    (pod, row, col) grid.  The same count, or the same refusal."""
    if kind in ("dense", "tile"):
        kw = dict(method=kind)
    else:
        kw = dict(schedule=kind, method="search")
    want = reference_8[f"{name}/{kind}/{strategy}"]

    def run():
        return _count(name, q=2, npods=2, reduce_strategy=strategy,
                      **kw).triangles

    if isinstance(want, str):
        assert _error(run) == want
    else:
        assert run() == want == _oracle(name)


@pytest.mark.parametrize("kind", ["cannon", "summa", "oned"])
@pytest.mark.parametrize("name", REF8_NAMES)
def test_grid_and_delta_with_pods_match_the_reference(reference_8, name,
                                                      kind):
    r = _count(name, q=2, npods=2, schedule=kind)
    assert list(r.grid) == reference_8[f"{name}/{kind}/grid"]
    if kind == "oned":
        assert r.plan.p == 8  # the ring spans every device, pods included
    g = _graph(name)
    d = tp.EdgeDelta.random_flips(g, 5, seed=2)
    res = rt.count_triangles_delta(g, d, q=2, npods=2, schedule=kind,
                                   method="fused", device="cpu",
                                   cache=tp.PlanCache())
    assert res.triangles == reference_8[f"{name}/{kind}/delta"]
    assert res.triangles == tc.triangle_count_oracle(d.apply_to(g))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("method", ["search", "fused"])
@pytest.mark.parametrize("npods", [2, 4])
@pytest.mark.parametrize("name", REF_Q4_NAMES)
def test_q4_pods_match_the_reference(reference_q4, name, npods, method,
                                     strategy):
    r = _count(name, q=4, npods=npods, method=method,
               reduce_strategy=strategy)
    want = reference_q4[npods][f"{name}/{method}/{strategy}"]
    assert r.triangles == want == _oracle(name)


@pytest.mark.parametrize("npods", [2, 4])
@pytest.mark.parametrize("name", REF_Q4_NAMES)
def test_strided_step_keep_per_device(reference_q4, name, npods):
    """The trap of the strided mask: pod t's local step s is global step
    t + s * npods, and the skip mask must be read there.  On cliques4
    the mask keeps global steps 0 and 3 only, so a pod reading it at its
    local step skips live work; every (pod, x, y) partial must be the
    reference's."""
    art = tp.plan_cannon(_graph(name), 4, cache=tp.PlanCache())
    sk = art.plan.step_keep
    fn = build_cannon_fn(art.plan, npods=npods, reduce_global=False)
    st = stage_arrays(pod_stack_arrays(art.plan.device_arrays(), npods,
                                          4), "cpu")
    per = fn(**st)
    assert per.tolist() == reference_q4[npods][f"{name}/per"]
    assert int(per.sum()) == _oracle(name)
    if name == "cliques4":
        assert not sk.all() and sk[..., 3].any() and not sk[..., 1].any()


# ----------------------------------------------------------------------
# the distributed degree rank
# ----------------------------------------------------------------------
def test_distributed_degree_rank_matches_the_reference(reference_8):
    g = tc.rmat(6, 6, seed=9)
    deg = torch.from_numpy(g.degrees()).view(4, -1)
    got = distributed_degree_rank(deg)
    assert tuple(got.shape) == (4, g.n // 4)
    assert got.reshape(-1).tolist() == reference_8["rank"]
    assert np.array_equal(got.reshape(-1).numpy(), tc.degree_order(g))


@pytest.mark.parametrize("p", [1, 2, 8, 16])
@pytest.mark.parametrize("spec", ["rmat:7,8,3", "cliques:2,16", "star:64"])
def test_distributed_degree_rank_is_the_degree_order(spec, p):
    g = tc.graph_from_spec(spec)
    n = -(-g.n // p) * p
    deg = np.zeros(n, dtype=np.int64)
    deg[: g.n] = g.degrees()
    got = distributed_degree_rank(torch.from_numpy(deg).view(p, -1))
    order = np.argsort(deg, kind="stable")
    want = np.empty(n, dtype=np.int64)
    want[order] = np.arange(n)
    assert np.array_equal(got.reshape(-1).numpy(), want)


def test_distributed_degree_rank_wants_shards():
    with pytest.raises(ValueError, match=r"\(p, chunk\)"):
        distributed_degree_rank(torch.zeros(8, dtype=torch.int64))


# ----------------------------------------------------------------------
# tc_run
# ----------------------------------------------------------------------
@pytest.mark.parametrize("argv,grid", [
    (["--pods", "2", "--reduce-strategy", "tree"], [2, 2, 2]),
    (["--pods", "2", "--reduce-strategy", "flat", "--method", "fused"],
     [2, 2, 2]),
    (["--pods", "2", "--schedule", "oned"], [2, 2, 2]),
])
def test_tc_run_pods(capsys, argv, grid):
    tc_run.main(["--graph", "rmat:9", "--grid", "2", "--verify", "--json",
                 "--device", "cpu", *argv])
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["correct"] and report["triangles"] == report["expected"]
    assert report["grid"] == grid


def test_tc_run_refuses_tree_without_pods():
    with pytest.raises(ValueError, match="pod axis"):
        tc_run.main(["--graph", "named:karate", "--reduce-strategy", "tree",
                     "--device", "cpu"])


@pytest.mark.parametrize("name", REF8_NAMES)
def test_ring_global_with_pods_counts_right(reference_8, name):
    """With pods the reference's ring spans npods * q² = 8 devices, where
    its row-encoded ``global`` keys miscount (ROADMAP.md, Queue C); the
    port's count the oracle's number."""
    got = _count(name, q=2, npods=2, schedule="oned", method="global")
    assert got.triangles == _oracle(name)
    assert got.plan.p == 8
    if name == "cliques3":  # both numbers, for the record
        assert (reference_8[f"{name}/oned/global"], got.triangles) == (
            70801, 102660)
