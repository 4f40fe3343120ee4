"""The port's LM training loop, ``train`` CLI and bfloat16 checkpoints
against the JAX package's.

* The loss curve: ``qwen2-0.5b-smoke`` in float32, the reference's
  parameters carried over, 20 steps at 2000–2019 (the peak rate) of
  ``TokenPipeline(512, 4, 32)``, the port's step against the reference's
  at every step within ``CURVE_TOL`` (``|a - b| / (1 + |b|)``; the largest
  seen is 1.4e-7: float32 rounding carried through 20 AdamW updates), and
  both falling as the reference's does (6.351 → 5.135).
* ``repro_torch.launch.train`` (``--device cpu``): the reference's line
  format; a ``--steps 10`` run then a ``--steps 20`` run in one
  ``--ckpt-dir`` resume at 10 with losses ``==`` an uninterrupted run's;
  a checkpoint the reference's ``train`` wrote at step 10 (bfloat16
  parameters as ``|V2`` entries) resumes in the port's, whose losses for
  steps 10–19 match the reference's uninterrupted run within
  ``RESUME_TOL``, 1e-3 of ``1 + |loss|`` (both continue from the same
  state; the reference prints four decimals at steps 10, 15 and 19, and
  its jitted bfloat16 forward rounds otherwise than the port's eager one:
  the largest difference seen is 6e-5);
  ``--compress-grads`` changes nothing; a name the port lacks exits.  The
  two packages seed ``lm_init`` differently, so a fresh run's values are
  not compared: the step tests hold the values on carried weights.
* Checkpoints: a bfloat16 tree's payload entries are the reference's byte
  for byte (``|V2``); the port restores its own and the reference's bit
  for bit, refuses a ``|V2`` entry under a non-bfloat16 ``like``, and its
  manager round-trips bfloat16 (the async writer on a copy); the
  reference's own restore of such a checkpoint raises (pinned: the port
  repairs it).
"""
import contextlib
import dataclasses
import functools
import io
import re
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfg
from repro import compat
from repro.ckpt import checkpoint as jckpt
from repro.launch import train as jtrain
from repro.models import steps as jsteps
import repro_torch.configs as tcfg
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models import steps as tsteps

from test_torch_lm_train_step import ref_params

NAME = "qwen2-0.5b-smoke"
CURVE_FROM, CURVE_STEPS = 2000, 20
CURVE_TOL = 1e-5
RESUME_TOL = 1e-3
LINE = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})$")
CLI = ["--arch", NAME, "--batch", "4", "--seq", "32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_loss_curve_matches_the_reference_and_falls():
    jcfg_ = dataclasses.replace(jcfg.get_config(NAME), dtype="float32")
    tcfg_ = dataclasses.replace(tcfg.get_config(NAME), dtype="float32")
    params = ref_params(NAME, "float32")
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.params_from_numpy(params, device="cpu")
    jfn, jinfo = jsteps.build_lm_train_step(
        jcfg_, compat.make_mesh((1, 1), ("data", "model")))
    tfn, tinfo = tsteps.build_lm_train_step(tcfg_, device="cpu")
    jo, to = jinfo["opt_init"](jp), tinfo["opt_init"](tp)
    pipe = TokenPipeline(jcfg_.vocab, 4, 32)
    ref, mine = [], []
    for step in range(CURVE_FROM, CURVE_FROM + CURVE_STEPS):
        batch = pipe.next_batch()
        jp, jo, jm = jfn(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()},
                         step)
        tp, to, tm = tfn(tp, to, batch, step)
        ref.append(float(jm["loss"]))
        mine.append(float(tm["loss"]))
    errs = [abs(a - b) / (1 + abs(b)) for a, b in zip(mine, ref)]
    assert max(errs) <= CURVE_TOL, errs
    assert round(ref[0], 3) == 6.351 and round(ref[-1], 3) == 5.135
    for curve in (ref, mine):
        assert np.mean(curve[-5:]) <= np.mean(curve[:5]) - 0.5


@functools.lru_cache(maxsize=None)
def _port_cli(*args):
    """The port's ``train`` in this process (once for each argument list:
    a ``--ckpt-dir`` is a fresh ``tmp_path``)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = ttrain.main([*CLI, "--device", "cpu", *args])
    return losses, out.getvalue().splitlines()


@functools.lru_cache(maxsize=None)
def _ref_cli(*args):
    """The reference's ``train`` in this process, as ``_port_cli``."""
    out = io.StringIO()
    argv = ["train", *CLI, *args]
    with mock.patch.object(sys, "argv", argv), \
            contextlib.redirect_stdout(out):
        jtrain.main()
    return out.getvalue().splitlines()


def _parsed(lines):
    return {int(m.group(1)): float(m.group(2))
            for m in map(LINE.match, lines) if m}


def test_cli_prints_the_references_lines():
    _, mine = _port_cli("--steps", "20")
    ref = _ref_cli("--steps", "20")
    assert all(LINE.match(ln) for ln in mine)
    assert all(LINE.match(ln) for ln in ref)
    assert list(_parsed(mine)) == list(_parsed(ref)) == [0, 5, 10, 15, 19]


def test_cli_resumes_from_its_own_checkpoint(tmp_path):
    whole, _ = _port_cli("--steps", "20")
    first, lines = _port_cli("--steps", "10", "--ckpt-dir", str(tmp_path))
    assert not any(ln.startswith("resumed") for ln in lines)
    second, lines = _port_cli("--steps", "20", "--ckpt-dir", str(tmp_path))
    assert lines[0] == "resumed at step 10"
    assert sorted(first) == list(range(10))
    assert sorted(second) == list(range(10, 20))
    assert {**first, **second} == whole
    # keep=2: the checkpoints at 10 and 20 stay
    assert tckpt.latest_step(str(tmp_path)) == 20


def test_cli_resumes_from_the_references_checkpoint(tmp_path):
    ref_lines = _ref_cli("--steps", "10", "--ckpt-dir", str(tmp_path))
    assert tckpt.latest_step(str(tmp_path)) == 10
    with np.load(tmp_path / "step_0000000010.npz") as data:
        assert data["params__embed__table"].dtype == np.dtype("V2")
    ref = _parsed(_ref_cli("--steps", "20"))
    first = _parsed(ref_lines)  # steps 0, 5 and 9, the last of that run
    assert {k: ref[k] for k in (0, 5)} == {k: first[k] for k in (0, 5)}
    mine, lines = _port_cli("--steps", "20", "--ckpt-dir", str(tmp_path))
    assert lines[0] == "resumed at step 10"
    assert sorted(mine) == list(range(10, 20))
    for step in (10, 15, 19):
        assert abs(mine[step] - ref[step]) <= RESUME_TOL * (1 + ref[step])


def test_compress_grads_changes_nothing():
    plain, _ = _port_cli("--steps", "6")
    flagged, _ = _port_cli("--steps", "6", "--compress-grads")
    assert plain == flagged


@pytest.mark.parametrize("arch", ["nequip", "dlrm-mlperf", "tc-twitter"])
def test_cli_refuses_what_the_port_does_not_train(arch):
    """The reference's choices: DLRM trains (its smoke config here: the
    full one's table is 91 GB), a GNN or a graph exits with the
    reference's message naming the GNN example and ``tc_run``."""
    if arch == "dlrm-mlperf":
        losses = ttrain.main(["--arch", arch + "-smoke", "--steps", "2",
                              "--device", "cpu"])
        assert sorted(losses) == [0, 1]
        assert all(np.isfinite(v) for v in losses.values())
        return
    with pytest.raises(SystemExit) as info:
        ttrain.main(["--arch", arch, "--device", "cpu"])
    family = tcfg.get_config(arch).family
    assert str(info.value.code) == (
        f"family {family}: use examples/train_gnn.py or tc_run")


def test_cli_runs_on_the_gpu_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main([*CLI, "--steps", "1"])


# ----------------------------------------------------------------------
# bfloat16 checkpoints
# ----------------------------------------------------------------------
def _bf16_trees():
    """A bfloat16 tree as the reference holds it (jax arrays) and as the
    port does (the same bits), with a float32 and an int32 leaf."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    ref = {"w": jnp.asarray(f32).astype(jnp.bfloat16),
           "s": jnp.asarray(np.float32(1.5)).astype(jnp.bfloat16),
           "m": jnp.asarray(f32), "n": jnp.arange(4, dtype=jnp.int32)}
    mine = convert.params_from_numpy(jax.tree.map(np.asarray, ref),
                                     device="cpu")
    return ref, mine


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_bf16_payload_entries_equal_the_references(tmp_path):
    ref, mine = _bf16_trees()
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, ref)
    tckpt.save_checkpoint(str(tmp_path / "mine"), 1, mine)
    with np.load(tmp_path / "ref" / "step_0000000001.npz") as a, \
            np.load(tmp_path / "mine" / "step_0000000001.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        assert b["w"].dtype == np.dtype("V2") and b["s"].shape == ()


@pytest.mark.parametrize("writer", ["ref", "mine"])
def test_bf16_checkpoints_restore_bit_for_bit(tmp_path, writer):
    ref, mine = _bf16_trees()
    if writer == "ref":
        jckpt.save_checkpoint(str(tmp_path), 3, ref)
    else:
        tckpt.save_checkpoint(str(tmp_path), 3, mine)
    like = {k: torch.zeros_like(v) for k, v in mine.items()}
    got, _ = tckpt.load_checkpoint(str(tmp_path), 3, like)
    for k, v in mine.items():
        assert got[k].dtype == v.dtype and got[k].device == v.device, k
        assert torch.equal(_bits(got[k]), _bits(v)), k


def test_a_bf16_entry_under_another_like_raises(tmp_path):
    _, mine = _bf16_trees()
    tckpt.save_checkpoint(str(tmp_path), 1, mine)
    like = {k: torch.zeros_like(v) for k, v in mine.items()}
    like["w"] = torch.zeros((3, 5), dtype=torch.float32)
    with pytest.raises(TypeError, match="'w'"):
        tckpt.load_checkpoint(str(tmp_path), 1, like)
    like["w"] = np.zeros((3, 5), np.float32)
    with pytest.raises(TypeError, match="'w'"):
        tckpt.load_checkpoint(str(tmp_path), 1, like)


def test_bf16_checkpoint_restores_where_the_reference_cannot(tmp_path):
    """The reference writes bfloat16 as ``|V2`` and its own restore of it
    raises (``jnp.asarray`` of a void array): its ``train --ckpt-dir``
    saves a checkpoint it cannot resume.  The port restores it."""
    ref, mine = _bf16_trees()
    jckpt.save_checkpoint(str(tmp_path), 1, ref)
    with pytest.raises(TypeError, match="V2"):
        jckpt.load_checkpoint(str(tmp_path), 1, ref)
    like = {k: torch.zeros_like(v) for k, v in mine.items()}
    got, _ = tckpt.load_checkpoint(str(tmp_path), 1, like)
    assert torch.equal(_bits(got["w"]), _bits(mine["w"]))


@pytest.mark.parametrize("async_save", [False, True])
def test_the_manager_round_trips_bf16(tmp_path, async_save):
    _, mine = _bf16_trees()
    keep = {k: v.clone() for k, v in mine.items()}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    mgr.save(7, mine, extra={"next_step": 7})
    for v in mine.values():  # the snapshot is a copy, never a view
        v.add_(1)
    mgr.wait()
    mgr.close()
    step, got, extra = CheckpointManager(
        str(tmp_path), async_save=False).restore_latest(
        {k: torch.zeros_like(v) for k, v in keep.items()})
    assert step == 7 and extra == {"next_step": 7}
    for k, v in keep.items():
        assert torch.equal(_bits(got[k]), _bits(v)), k
