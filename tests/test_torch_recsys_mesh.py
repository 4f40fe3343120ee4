"""DLRM's train, serve and retrieval steps on a device mesh
(``build_dlrm_{train,serve,retrieval}_step(cfg, DeviceMesh)``), the
row-sharded lookups, ``train --mesh`` for DLRM, the collectives' bytes
and the dry run's.

The smoke widths with the tables resized to ``chip_smoke.
MODEL_MESH_TABLES`` (7,168 rows after padding, past the 4,096 rows over
which ``dlrm_param_specs`` row-shards the table over ``model``; the
smoke config's own 1,024 rows would stay replicated), a batch of 16 and
400 candidates of table 0 with a tie planted across two positions'
shards (``chip_smoke.dlrm_tie_candidates``).

* **Against the port's one device** on ``(2, 2)``, ``(1, 4)``,
  ``(4, 1)``, ``(2, 1, 2)`` and the uneven ``(1, 3)`` (the table's rows
  2,390, 2,390, 2,388): ``chip_smoke.dlrm_mesh_compare``, the card's
  check too — the first train step by ``step_errs`` at
  ``MODEL_STEP_TOL`` on every key in both dtypes, the serve probabilities and the retrieval's values at
  ``MODEL_OUT_TOL``, its indices ``==`` (the tie in order), every replica
  with the same bits.
* **Against the reference's own mesh run** on the four meshes it
  accepts (one subprocess with four host devices): the same parameters
  (the reference's ``dlrm_init``, the tie planted), batch and
  candidates; and the reference's ``train`` CLI on four host devices
  against ``train --mesh 4 --device cpu``.
* One train step's collective bytes on ``(2, 2)`` ``==`` their closed
  form (``chip_smoke.dlrm_mesh_train_bytes``: the lookup's psum over
  ``model``, the loss's and the gradients' psum over ``data``).
* Position ``(0, 0)``'s bytes in the mesh step of the dry run's
  ``dlrm-mlperf:train_batch:pod`` cell ``==`` ``roofline.shard_bytes``
  ``==`` the row's ``memory_per_device.args``.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.data.pipeline import RecsysPipeline
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.models import convert, sharding
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import gnn_steps as tgs
from repro_torch.sparse.embedding_bag import (check_ids, embedding_bag,
                                              embedding_bag_shard,
                                              table_rows_shard)

from test_torch_gnn import chip_smoke
from test_torch_gnn_mesh import flat, position_bytes, tree_of
from test_torch_recsys import CLI, CLI_TOL, LINE, SMOKE, ref_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MESHES = [(2, 2), (1, 4), (4, 1), (2, 1, 2), (1, 3)]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
REF_MESHES = MESHES[:4]  # the reference's jit refuses uneven shards
TABLES = chip_smoke.MODEL_MESH_TABLES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_of(shape):
    return chip_smoke.lm_mesh_of(shape, [CPU] * int(np.prod(shape)))


def cfg_of():
    return chip_smoke.model_mesh_dlrm_cfg(SMOKE, TABLES)


def inputs(shape):
    """The reference's parameters with the tie planted for ``shape``'s
    candidate shards (numpy), the batch and the candidates."""
    cfg = cfg_of()
    params = convert.params_from_numpy(ref_params(SMOKE, TABLES), device=CPU)
    batch = RecsysPipeline(cfg, chip_smoke.MODEL_MESH_BATCH).next_batch()
    params, cand, tie = chip_smoke.dlrm_tie_candidates(
        params, cfg, batch["dense"], chip_smoke.MODEL_MESH_CANDS,
        mesh_of(shape))
    return params, batch, cand, tie


# ----------------------------------------------------------------------
# the reference's mesh runs and CLI, in one subprocess
# ----------------------------------------------------------------------
REF_CODE = r"""
import contextlib, dataclasses, io, json, math, sys
from unittest import mock
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.configs as jcfg
from repro.launch import train as jtrain
from repro.models import gnn_steps as jgs

jobs, d, tables, cli = json.loads(sys.argv[1]), sys.argv[2], \
    tuple(json.loads(sys.argv[3])), json.loads(sys.argv[4])
cfg = dataclasses.replace(jcfg.get_config("dlrm-mlperf-smoke"),
                          table_sizes=tables)

def tree(z, prefix):
    out = {}
    for k in z.files:
        if k.startswith(prefix + "/"):
            node = out
            parts = k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(z[k])
    return out

def flat(t, prefix, res):
    for k, v in t.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}/{k}", res)
        else:
            res[f"{prefix}/{k}"] = np.asarray(v)

for shape in jobs:
    key = "x".join(map(str, shape))
    z = np.load(f"{d}/in-{key}.npz")
    params, batch = tree(z, "params"), tree(z, "batch")
    cand = jnp.asarray(z["cand"])
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(shape),
                axes)
    fn, info = jgs.build_dlrm_train_step(cfg, mesh)
    srv, _ = jgs.build_dlrm_serve_step(cfg, mesh)
    ret, _ = jgs.build_dlrm_retrieval_step(cfg, mesh)
    res = {"probs": np.asarray(srv(params, batch["dense"],
                                   batch["sparse_ids"]))}
    vals, idx = ret(params, batch["dense"][:1], cand)
    res["top_values"], res["top_idx"] = np.asarray(vals), np.asarray(idx)
    p2, o2, m = fn(params, info["opt_init"](params), batch, 0)
    flat(p2, "params", res)
    flat(o2, "opt", res)
    for k, v in m.items():
        res[f"metric/{k}"] = np.asarray(v, np.float64)
    np.savez(f"{d}/out-{key}.npz", **res)

out = io.StringIO()
with mock.patch.object(sys, "argv", ["train", *cli]), \
        contextlib.redirect_stdout(out):
    jtrain.main()
open(f"{d}/cli.txt", "w").write(out.getvalue())
print("done")
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_recsys_mesh")
    for shape in REF_MESHES:
        params, batch, cand, _ = inputs(shape)
        np.savez(d / f"in-{'x'.join(map(str, shape))}.npz",
                 **flat(convert.numpy_from_params(params), "params"),
                 **flat(batch, "batch"), cand=cand)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_CODE),
         json.dumps([list(s) for s in REF_MESHES]), str(d),
         json.dumps(list(TABLES)), json.dumps(CLI)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = []

    def result(name):
        if not done:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"reference subprocess failed:\n{err}"
            done.append(True)
        if name == "cli":
            return (d / "cli.txt").read_text().splitlines()
        with np.load(d / f"out-{name}.npz") as z:
            return {k: z[k] for k in z.files}

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ----------------------------------------------------------------------
# the port's mesh against its one device
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_mesh_steps_equal_one_device(shape, reference_runs):
    # the reference's subprocess (the fixture) runs meanwhile
    params, batch, cand, tie = inputs(shape)
    mesh = mesh_of(shape)
    row, ok = chip_smoke.dlrm_mesh_compare(cfg_of(), params, batch, cand, tie,
                                           mesh, CPU)
    errs = {dt: {k: v for k, v in row[dt].items()
                 if k.startswith(("err", "idx", "tie"))}
            for dt in ("float64", "float32")}
    assert ok, errs
    for dt in ("float64", "float32"):
        assert row[dt]["idx_equal"] and row[dt]["tie_kept"]
        assert row[dt]["mesh"]["replicas_equal"]
    # the tie straddles two positions' candidate shards
    n = mesh.size
    shards = [sharding.chunk(len(cand), n, p) for p in range(n)]
    owner = [next(p for p, (lo, hi) in enumerate(shards) if lo <= i < hi)
             for i in tie]
    assert owner[0] != owner[1]


def test_the_table_is_row_sharded_over_model_with_its_moments():
    mesh = mesh_of((2, 2))
    fn, info = tgs.build_dlrm_train_step(cfg_of(), mesh)
    params = inputs((2, 2))[0]
    sp = info["shard"](params)
    table = sp["emb"]["table"]
    assert table.shape == (7168, 16) and table.spec == ("model", None)
    assert [s.shape[0] for s in table.shards] == [3584] * 4
    assert sp["bot"]["l0"]["w"].spec == (None, None)
    opt = info["opt_init"](sp)
    assert opt["m"]["emb"]["table"].spec == opt["v"]["emb"]["table"].spec \
        == ("model", None)
    # the smoke config's own table stays replicated
    _, small = tgs.build_dlrm_train_step(tcfg.get_config(SMOKE), mesh)
    assert small["params"]["emb"]["table"] == (None, None)


def test_train_traffic_equals_its_closed_form():
    """One train step on (2, 2): the lookup's psum over ``model`` (each
    data group's bags), the loss's psum over ``data``, and the gradients'
    psum over ``data`` (the table's shard and every MLP leaf, never over
    ``model``) with the global norm's psum over every axis."""
    mesh = mesh_of((2, 2))
    params, batch, cand, _ = inputs((2, 2))
    cfg = cfg_of()
    fn, info = tgs.build_dlrm_train_step(cfg, mesh)
    sp = info["shard"](params)
    opt = info["opt_init"](sp)
    with sharding.tally_collective_bytes() as tally:
        fn(sp, opt, batch, 0)
    want = chip_smoke.dlrm_mesh_train_bytes(cfg, mesh, len(batch["labels"]))
    assert dict(tally) == want
    assert want["psum:lookup"] == 2 * 1 * 16 * 8 * 16 * 4


@pytest.mark.parametrize("rows", [64, 1024])
def test_the_logit_bias_moments_are_a_cancelling_sum(rows):
    """Why ``chip_smoke.DLRM_FULL_F32_TOL`` does not bound the full-width
    float32 states: at dlrm-mlperf's widths (tables capped at 256 rows)
    the logit bias's gradient, mean(p - y) over balanced labels, is a
    cancelling sum (|g| under 1e-5), and its float32 moments on (2, 2)
    move by more than ``MODEL_STEP_TOL["states"]`` against one device;
    every other moment leaf holds it, and so does float64."""
    cfg = chip_smoke.capped_recsys(cap=256)
    batch = RecsysPipeline(cfg, rows).next_batch()
    served = {k: batch[k][:16] for k in ("dense", "sparse_ids")}
    cand = np.arange(100, dtype=np.int32)
    tol = chip_smoke.MODEL_STEP_TOL["states"]
    for dt in (torch.float32, torch.float64):
        params = chip_smoke._cast_floats(
            tdlrm.dlrm_init(torch.Generator().manual_seed(0), cfg,
                            device=CPU), dt)
        c = dataclasses.replace(cfg, dtype=str(dt).split(".")[1])
        b = chip_smoke._cast_floats(batch, dt)
        one = chip_smoke.dlrm_mesh_run(c, params, b, served, cand,
                                       dev=CPU)["step"][1]
        got = chip_smoke.dlrm_mesh_run(c, params, b, served, cand,
                                       mesh=mesh_of((2, 2)))["step"][1]
        errs = {}
        for k in ("m", "v"):
            a, w = flat(got[k]), flat(one[k])
            for leaf in w:
                ref = w[leaf].astype(np.float64)
                errs[f"{k}/{leaf}"] = float(
                    np.linalg.norm(a[leaf] - ref) / np.linalg.norm(ref))
        bias = {k: v for k, v in errs.items() if k.endswith("top/l3/b")}
        rest = {k: v for k, v in errs.items() if k not in bias}
        assert max(rest.values()) <= tol, rest
        if dt == torch.float32:
            assert min(bias.values()) > tol, bias
            assert abs(float(flat(one["m"])["top/l3/b"][0])) / 0.1 < 1e-5
        else:
            assert max(bias.values()) <= tol, bias


def test_shard_lookups_sum_to_the_whole_tables():
    """Each shard's part of a sum bag (its rows, zeros elsewhere) sums
    over uneven shards (10 rows over 3: 4, 4, 2) to the whole table's
    bag; ``table_rows_shard`` likewise to ``table[ids]``; an id outside
    the table raises."""
    gen = torch.Generator().manual_seed(7)
    table = torch.randn(10, 3, generator=gen, dtype=torch.float64)
    ids = torch.randint(0, 10, (5, 2, 3), generator=gen)
    parts, rows = [], []
    for p in range(3):
        lo, hi = sharding.chunk(10, 3, p)
        parts.append(embedding_bag_shard(table[lo:hi], ids, lo))
        rows.append(table_rows_shard(table[lo:hi], ids[:, 0, 0], lo))
    assert torch.allclose(sum(parts), embedding_bag(table, ids), rtol=0,
                          atol=1e-15)
    assert torch.equal(sum(rows), table[ids[:, 0, 0]])
    check_ids([ids, ids[:, 0, 0]], 10)
    with pytest.raises(IndexError, match="outside the table"):
        check_ids([ids, ids + 10], 10)


def test_an_id_outside_the_table_raises_on_the_mesh():
    mesh = mesh_of((1, 4))
    params, batch, _, _ = inputs((1, 4))
    serve, info = tgs.build_dlrm_serve_step(cfg_of(), mesh)
    bad = batch["sparse_ids"].copy()
    bad[0, -1, 0] = 10 ** 6
    with pytest.raises(IndexError, match="outside the table"):
        serve(info["shard"](params), batch["dense"], bad)


# ----------------------------------------------------------------------
# the port's mesh against the reference's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", REF_MESHES, ids=MESH_IDS[:4])
def test_mesh_steps_equal_the_references_mesh_run(shape, reference_runs):
    ref = reference_runs("x".join(map(str, shape)))
    params, batch, cand, tie = inputs(shape)
    got = chip_smoke.dlrm_mesh_run(cfg_of(), params, batch, batch, cand,
                                   mesh=mesh_of(shape))
    want = (tree_of(ref, "params"), tree_of(ref, "opt"),
            {k.split("/")[1]: float(v) for k, v in ref.items()
             if k.startswith("metric/")})
    errs, ok = chip_smoke.step_errs(got["step"], want,
                                    chip_smoke.MODEL_STEP_TOL, lr_t=1e-3,
                                    step=0)
    assert ok, errs
    assert chip_smoke.lm_err(got["probs"], ref["probs"]) <= \
        chip_smoke.MODEL_OUT_TOL
    vals, idx = got["top"]
    assert np.array_equal(idx.numpy(), ref["top_idx"])
    ranked = idx.tolist()
    assert ranked.index(min(tie)) < ranked.index(max(tie))
    assert chip_smoke.lm_err(vals, ref["top_values"]) <= \
        chip_smoke.MODEL_OUT_TOL


def test_train_cli_on_a_mesh_prints_the_references_losses(reference_runs):
    """``train --mesh 4 --device cpu`` on the reference's parameters (its
    ``main`` draws them from key 0; the port's ``dlrm_init`` is patched to
    take them) against the reference's ``train`` on four host devices,
    which trains on its ``(1, 4)`` mesh: the same lines, losses within
    ``CLI_TOL``."""
    out = io.StringIO()
    with mock.patch.object(tdlrm, "dlrm_init", lambda gen, cfg, device: (
            convert.params_from_numpy(ref_params(), device=device))), \
            contextlib.redirect_stdout(out):
        losses = ttrain.main([*CLI, "--mesh", "4", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    ref = reference_runs("cli")
    parse = lambda ls: {int(m.group(1)): float(m.group(2))  # noqa: E731
                        for m in map(LINE.match, ls) if m}
    got, want = parse(lines), parse(ref)
    assert all(LINE.match(ln) for ln in lines)
    assert list(got) == list(want) == [0, 5, 10, 15, 19]
    for step in want:
        assert abs(got[step] - want[step]) <= CLI_TOL, (step, got, want)
        assert abs(losses[step] - want[step]) <= CLI_TOL


# ----------------------------------------------------------------------
# the dry run's bytes
# ----------------------------------------------------------------------
def test_position_bytes_equal_shard_bytes_and_the_dry_runs_args():
    """``dlrm-mlperf:train_batch:pod``: the mesh step's parameters (the
    177,944,576-row table over ``model``'s 16), AdamW's moments and the
    65,536-row batch at position (0, 0) of a 16 x 16 ``DeviceMesh`` of
    meta positions are ``shard_bytes`` of the cell's arguments (the int
    step an int32 scalar) and the dry-run row's
    ``memory_per_device.args``."""
    logical = make_production_mesh()
    mesh = DeviceMesh(logical.shape, logical.axis_names,
                      ("meta",) * logical.size)
    cfg = tcfg.get_config("dlrm-mlperf")
    shape = cfg.shapes["train_batch"]
    fn, info = tgs.build_dlrm_train_step(cfg, mesh)
    sp = info["shard"](info["dummy"])
    batch = tgs.recsys_input_specs(cfg, shape)
    mine = (position_bytes(sp) + position_bytes(info["opt_init"](sp))
            + position_bytes(info["shard_batch"](batch)) + 4)
    cell = dryrun.model_cell(cfg, shape, logical)
    assert mine == roofline.shard_bytes(cell.args, cell.arg_specs, logical)
    row = dryrun.run_cell("dlrm-mlperf", "train_batch", "pod")
    assert mine == row["memory_per_device"]["args"]
    assert sp["emb"]["table"].shards[0].shape[0] == 177_944_576 // 16


def test_steps_on_a_mesh_take_no_device():
    cfg = cfg_of()
    for build in (tgs.build_dlrm_train_step, tgs.build_dlrm_serve_step,
                  tgs.build_dlrm_retrieval_step):
        with pytest.raises(ValueError, match="not both"):
            build(cfg, mesh_of((2, 2)), device=CPU)



@pytest.mark.parametrize("name", ["dlrm"] + list(tcfg.GNN_ARCHS))
def test_numpy_trees_go_straight_to_shards_and_back(name):
    """``convert.params_from_numpy(tree, mesh=, specs=)`` lays a numpy
    GNN or DLRM tree (the reference's DLRM one, the GNN ones exported
    from the port's inits) out by the mesh step's specs (the
    DLRM table row-sharded, everything else replicated), and
    ``numpy_from_params`` gathers them back into the global arrays, as
    the reference's ``np.asarray`` does."""
    mesh = mesh_of((2, 2))
    if name == "dlrm":
        tree = ref_params(SMOKE, TABLES)
        _, info = tgs.build_dlrm_train_step(cfg_of(), mesh)
    else:
        cfg = tcfg.get_config(name + "-smoke")
        _, d_feat = chip_smoke.gnn_smoke_batch(cfg, np.random.default_rng(3))
        tree = convert.numpy_from_params(tgs.gnn_init(
            torch.Generator().manual_seed(0), cfg, d_feat, device=CPU))
        _, info = tgs.build_gnn_train_step(cfg, mesh, d_feat)
    sp = convert.params_from_numpy(tree, mesh=mesh, specs=info["params"])
    assert all(st.mesh == mesh for st in chip_smoke._lm_leaves(sp))
    back = convert.numpy_from_params(sp)
    assert flat(back).keys() == flat(tree).keys()
    for k, v in flat(tree).items():
        assert np.array_equal(flat(back)[k], v), k
    assert chip_smoke.mesh_replicas_equal(sp)
