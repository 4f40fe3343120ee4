"""The model walk's extrapolation against a full walk, and the GNN and
recsys cells.

An LM cell is walked at one and two layers of each stack and, to train,
at one and two microbatches, and its counts combined to the config's own
depth and microbatch count (``dryrun.lm_walk_plan``).  On the smoke
configs stretched to four or five layers (deepseek-v3's two dense, two MoE
and MTP layers among them) and three microbatches, the combined products, ops,
bytes, staged and result bytes equal a full walk's (``==``); a train
step's peak equals it too, a serving step's is over by its stated bound.
Two cells are held to a full walk at their config's own depth.  Every GNN
and DLRM cell is walked whole and gives a row.
"""
import dataclasses

import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh

MESH = make_production_mesh()
STRETCHED = {  # config: (layers, dense layers)
    "qwen2-0.5b-smoke": (5, 0),
    "chatglm3-6b-smoke": (4, 0),
    "grok-1-314b-smoke": (4, 0),
    "deepseek-v3-671b-smoke": (4, 2),
}
KINDS = ("train", "prefill", "decode")
# how far a serving step's combined peak may be over a full walk's: see
# test_the_extrapolated_walk_equals_a_full_walk
PEAK_OVER = 0.005


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (pytest-xdist)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stretched(name):
    layers, dense = STRETCHED[name]
    base = tcfg.get_config(name)
    return dataclasses.replace(
        base, n_layers=layers,
        first_dense_layers=dense if base.moe else base.first_dense_layers)


def _shape(cfg, kind):
    b = 3 * cfg.microbatch_size if kind == "train" else 2
    return dict(kind=kind, seq_len=16, global_batch=b)


def _walk(cfg, shape):
    cell = dryrun.model_cell(cfg, shape, MESH)
    return roofline.walk_step(cell.fn, *cell.args, segments=cell.segments)


def _numbers(walk):
    d = dataclasses.asdict(walk)
    for k in ("walks", "result", "point_live"):
        d.pop(k)
    return d


def _held_to(combined, full, slack):
    """The combined peak, each segment's and each point's most against a
    full walk's: never under, and over by at most ``slack`` bytes."""
    assert full.peak_bytes <= combined.peak_bytes <= full.peak_bytes + slack
    assert set(combined.segment_peaks) == set(full.segment_peaks)
    for seg, peak in full.segment_peaks.items():
        assert peak <= combined.segment_peaks[seg] <= peak + slack, seg
    assert set(combined.point_live) == set(full.point_live)
    for point, live in full.point_live.items():
        most = max(combined.point_live[point])
        assert max(live) <= most <= max(live) + slack, point


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(STRETCHED))
def test_the_extrapolated_walk_equals_a_full_walk(name, kind):
    """Products, ops, bytes, staged and result bytes: ``==``.  The live
    bytes are combined point by point (``combine_walks``): the
    optimiser's points, made once a leaf, leaf by leaf, so that its
    per-leaf float32 temporaries peak at the head's leaf at one layer and
    at a stack's leaf deeper down as a full walk has them; a point made
    once a layer or a microbatch by its most, which stays at the same
    place as depth grows (the head's logits, the end of the backward).
    A train step's peak, each segment's and each point's: ``==``.  A
    serving step's: never under, and over by at most 0.5 % of the peak
    (the peak by up to 1,544 bytes, 0.29 %, grok-1-smoke's decode; a
    point by up to 2,304 bytes, 0.43 %, qwen2-smoke's): a layer's points
    hold the leftovers of the layer before, which the first layer has
    not, so the one-layer walk is below the line through the deeper
    ones."""
    cfg = _stretched(name)
    shape = _shape(cfg, kind)
    full = _walk(cfg, shape)
    plan = dryrun.lm_walk_plan(cfg, shape)
    terms = [(c, _walk(wcfg, wshape)) for c, wcfg, wshape in plan]
    combined = roofline.combine_walks(terms)
    assert _numbers(combined) == _numbers(full)
    assert combined.walks == len(plan) == (
        (3 if cfg.moe and cfg.first_dense_layers else 2)
        * (2 if kind == "train" else 1))
    if kind == "train":
        assert combined.segment_peaks == full.segment_peaks
        assert combined.peak_bytes == full.peak_bytes
    _held_to(combined, full, 0 if name.startswith("deepseek")
             else PEAK_OVER * full.peak_bytes)
    # every walk of the plan is smaller than the config
    for _, wcfg, wshape in plan:
        assert wcfg.n_layers <= 3 and wshape["global_batch"] <= \
            2 * cfg.microbatch_size


@pytest.mark.parametrize("cell", ["chatglm3-6b:train_4k",
                                  "qwen2-0.5b:decode_32k"])
def test_the_extrapolated_walk_equals_a_full_walk_at_full_depth(cell):
    """The same check at a config's own depth, as the dry run walks it
    (``dryrun.walk_cell``), a train step at one microbatch to keep the
    full walk of chatglm3-6b's 28 layers within seconds.  That step's
    optimiser peaks at its stacked MLP leaf (12.6 GB a float32
    temporary, against the head's 1.07 GB at one layer), which a peak
    combined per segment put below the full walk's: point by point, the
    segment peaks are ``==`` and a layer's points over by at most 104
    bytes.  The decode step's peak is over by 10,092,544 bytes of 57.8 GB
    (0.017 %), a point by at most 15,138,816 bytes."""
    arch, shape_name = cell.split(":")
    cfg = tcfg.get_config(arch)
    shape = dict(cfg.shapes[shape_name])
    if shape["kind"] == "train":
        shape["global_batch"] = cfg.microbatch_size
    full = _walk(cfg, shape)
    combined, _ = dryrun.walk_cell(cfg, shape)
    assert combined.walks == 2
    assert _numbers(combined) == _numbers(full)
    if shape["kind"] == "train":
        assert combined.segment_peaks == full.segment_peaks
        assert set(full.segment_peaks) == {"", "microbatch"}
        _held_to(combined, full, 104)
        excess = [max(combined.point_live[k]) - max(v)
                  for k, v in full.point_live.items()]
        assert max(excess) == 104
    else:
        assert combined.peak_bytes - full.peak_bytes == 10_092_544
        _held_to(combined, full, 15_138_816)


def test_walks_that_make_tensors_elsewhere_are_not_combined():
    cfg = tcfg.get_config("qwen2-0.5b-smoke")
    shape = _shape(cfg, "prefill")
    with pytest.raises(ValueError, match="different points"):
        roofline.combine_walks([
            (1, _walk(cfg, shape)),
            (1, _walk(tcfg.get_config("deepseek-v3-671b-smoke"), shape))])


def test_the_walk_plan_refuses_where_the_affine_rule_cannot_hold():
    cfg = tcfg.get_config("deepseek-v3-671b-smoke")
    with pytest.raises(ValueError, match="does not split"):
        dryrun.lm_walk_plan(cfg, dict(kind="train", seq_len=32,
                                      global_batch=3))
    empty = dataclasses.replace(cfg, n_layers=1, first_dense_layers=1)
    with pytest.raises(ValueError, match="main stack empty"):
        dryrun.lm_walk_plan(empty, _shape(cfg, "prefill"))
    with pytest.raises(ValueError, match="no LM walk"):
        dryrun.lm_walk_plan(cfg, dict(kind="sampled", seq_len=32,
                                      global_batch=2))
    # one microbatch: no second walk along the batch
    one = dryrun.lm_walk_plan(cfg, dict(kind="train", seq_len=32,
                                        global_batch=1))
    assert sum(c for c, _, _ in one) == 1
    assert all(shape["global_batch"] == 1 for _, _, shape in one)
    assert [(c, w.n_layers) for c, w, _ in one] == [(1, 3)]


def test_a_walk_that_reads_a_value_raises():
    """No op is dropped: a step that reads a meta tensor's value is
    refused by name, as the engine's walk refuses it."""
    cell = dryrun.model_cell(tcfg.get_config("dlrm-mlperf-smoke"),
                             dict(kind="serve", batch=8), MESH)

    def reads(*args):
        out = cell.fn(*args)
        float(out.sum())
        return out

    with pytest.raises(RuntimeError, match="reads a tensor's values"):
        roofline.walk_step(reads, *cell.args)
    with pytest.raises(ValueError, match="one device"):
        roofline.walk_step(cell.fn, cell.args[0], torch.zeros(8, 13),
                           cell.args[2])


# ----------------------------------------------------------------------
# the GNN and recsys cells, walked whole
# ----------------------------------------------------------------------
WHOLE = [(a, s) for a in (*tcfg.GNN_ARCHS, "dlrm-mlperf")
         for s in tcfg.get_config(a).shapes]
# the most useful_fraction (the reference's model FLOPs over the walk's
# products) may be, where the reference's formula counts more than the
# step's products; 1 for every other arch:
USEFUL_MOST = {
    # three passes of every layer, but the bottom MLP's first layer makes
    # no input gradient: 2 * 13 * 512 FLOPs a sample fewer (1.0011)
    "dlrm-mlperf": 1.002,
    # both MLPs taken as two (2d x d) layers; each second layer is d x d
    "graphcast": 4 / 3,
    # 6 e d heads a layer for the edges, which the step does as
    # elementwise ops and scatters: 1.33 on ogb_products' 25 edges a node
    "gat-cora": 1.5,
}


@pytest.mark.parametrize("arch,shape_name", WHOLE,
                         ids=[f"{a}:{s}" for a, s in WHOLE])
def test_every_gnn_and_recsys_cell_walks(arch, shape_name):
    rows = {m: dryrun.run_cell(arch, shape_name, m)
            for m in ("pod", "multipod")}
    walk = dryrun.walk_model_cell(arch, shape_name)[0]
    assert walk.walks == 1
    pod, multi = rows["pod"], rows["multipod"]
    for row in rows.values():
        assert row["coll_bytes_per_device"] == 0.0
        assert row["coll_breakdown"] == {}
        assert row["grid_bytes"] == walk.peak_bytes
        assert row["flops_per_device"] > 0
        assert 0 < row["useful_fraction"] <= USEFUL_MOST.get(arch, 1)
        mem = row["memory_per_device"]
        assert mem["temps"] == -(-(walk.peak_bytes - walk.staged_bytes)
                                 // row["chips"])
    assert pod["flops_per_device"] == 2 * multi["flops_per_device"]
    # every GNN and DLRM product is float32: t_compute at the 32-bit rate
    assert set(walk.flops) == {"torch.float32"}
    assert pod["t_compute"] == pytest.approx(
        sum(walk.flops.values()) / 256 / roofline.HW["fp32_ops"])
    if arch == "dlrm-mlperf":
        # the uncapped tables: 177.9 M rows x 128 float32 = 91.1 GB
        table = tcfg.get_config(arch).total_rows * 128 * 4
        assert walk.staged_bytes > table > 91e9
        assert pod["fits"] is False
    # the equivariant molecule steps fit; the full products graph does not
    if shape_name == "molecule":
        assert pod["fits"] is True
    if shape_name == "ogb_products" and arch != "gat-cora":
        assert pod["fits"] is False
