"""The port's checkpoints against the JAX package's: the same on-disk
format (npz payload keyed by leaf path, sha256 manifest, atomic writes),
so a checkpoint written by either package loads in the other to equal
arrays (the npz bytes carry zip timestamps, so the digests themselves are
not compared); rotation, the async writer and its error surfacing,
quarantine of a damaged step, and the port's own traps: a queued async
save is a copy (``tensor.numpy()`` on the CPU is a view), and a restored
leaf lands on its ``like`` tensor's device in the payload's dtype.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt as jck
import repro_torch.ckpt as tck
import repro_torch.ckpt.manager as M
from repro_torch.runtime.faultinject import FaultPlan, armed


def _tree():
    return {
        "a": torch.arange(12.0).reshape(3, 4),
        "b": {"c": torch.ones(5, dtype=torch.int32),
              "d": [torch.tensor([7, 8], dtype=torch.int64),
                    (torch.zeros(2, 2, dtype=torch.bool),)]},
        "acc": torch.full((2, 2), 2**40, dtype=torch.int64),
    }


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        x = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_checkpoint_roundtrip_keeps_structure_device_and_dtype(tmp_path):
    tree = _tree()
    tck.save_checkpoint(str(tmp_path), 7, tree, extra={"x": 1})
    like = {"a": torch.zeros(3, 4), "b": {
        "c": torch.zeros(5), "d": [torch.zeros(2), (torch.zeros(2, 2),)]},
        "acc": torch.zeros(2, 2)}
    out, extra = tck.load_checkpoint(str(tmp_path), 7, like)
    assert extra == {"x": 1}
    _equal(out, tree)  # the payload's dtypes, not like's
    assert out["acc"].dtype == torch.int64 and int(out["acc"][0, 0]) == 2**40
    assert out["b"]["c"].dtype == torch.int32
    assert all(t.device == torch.device("cpu") for t in (out["a"], out["acc"]))
    # numpy leaves of like restore as numpy arrays
    out, _ = tck.load_checkpoint(str(tmp_path), 7, {"a": np.zeros(1)})
    assert isinstance(out["a"], np.ndarray)


def test_on_disk_format_is_the_reference_s(tmp_path):
    tck.save_checkpoint(str(tmp_path / "mine"), 3, _tree(), extra={"k": [1]})
    ref_tree = {k: jnp.asarray(v.numpy()) for k, v in
                {"a": _tree()["a"], "acc": _tree()["acc"]}.items()}
    jck.save_checkpoint(str(tmp_path / "ref"), 3, ref_tree, extra={"k": [1]})
    mine = json.loads((tmp_path / "mine" / "step_0000000003.json").read_text())
    ref = json.loads((tmp_path / "ref" / "step_0000000003.json").read_text())
    assert sorted(mine) == sorted(ref)
    assert mine["payload"] == ref["payload"] == "step_0000000003.npz"
    assert mine["keys"] == ["a", "acc", "b/c", "b/d/0", "b/d/1/0"]
    with np.load(tmp_path / "mine" / "step_0000000003.npz") as data:
        assert sorted(data.files) == ["a", "acc", "b__c", "b__d__0",
                                      "b__d__1__0"]


def test_a_reference_checkpoint_loads_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {f"carry{i}": rng.integers(0, 1000, (2, 2, 5)).astype(np.int32)
              for i in range(8)}
    arrays["acc"] = rng.integers(0, 2**40, (2, 2)).astype(np.int64)
    ref = {"state": {k: jnp.asarray(v) for k, v in arrays.items()},
           "log": [jnp.asarray(np.arange(3, dtype=np.int32))]}
    mgr = jck.CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(4, ref, extra={"shift": 4})
    like = {"state": {k: torch.zeros(1) for k in arrays},
            "log": [torch.zeros(1)]}
    step, out, extra = tck.CheckpointManager(
        str(tmp_path), async_save=False).restore_latest(like)
    assert step == 4 and extra == {"shift": 4}
    for k, v in arrays.items():
        got = out["state"][k].numpy()
        # the reference runs without x64 here, so its int64 leaves were
        # stored as int32: compare values, and the port keeps that width
        assert got.dtype == np.asarray(ref["state"][k]).dtype
        np.testing.assert_array_equal(got, np.asarray(ref["state"][k]))
    np.testing.assert_array_equal(out["log"][0].numpy(), np.arange(3))


def test_a_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = {"carry0": torch.arange(10, dtype=torch.int32).reshape(2, 5),
            "acc": torch.tensor([[5, 6], [7, 8]], dtype=torch.int64),
            "w": torch.linspace(0, 1, 4)}
    mgr = tck.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(2, tree, extra={"shift": 2, "grid": "2x2"})
    mgr.close()
    like = {k: jnp.zeros(1) for k in tree}
    step, out, extra = jck.CheckpointManager(
        str(tmp_path), async_save=False).restore_latest(like)
    assert step == 2 and extra == {"shift": 2, "grid": "2x2"}
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(out[k]), v.numpy())


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"a": torch.ones(4)}
    tck.save_checkpoint(str(tmp_path), 1, tree)
    with open(tmp_path / "step_0000000001.npz", "r+b") as f:
        f.seek(30)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError, match="corruption"):
        tck.load_checkpoint(str(tmp_path), 1, tree)
    tck.load_checkpoint(str(tmp_path), 1, {}, verify=False)


def test_manager_rotation_and_restore(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in range(5):
        mgr.save(s, {"w": torch.full((3,), float(s))},
                 extra={"next_step": s})
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".json")]) == 2
    step, tree, extra = mgr.restore_latest({"w": torch.zeros(3)})
    assert step == 4 and float(tree["w"][0]) == 4.0
    assert tck.latest_step(str(tmp_path)) == 4
    assert tck.latest_step(str(tmp_path / "none")) is None
    empty = tck.CheckpointManager(str(tmp_path / "e"), async_save=False)
    assert empty.restore_latest({"w": torch.zeros(3)}) == (None, None, None)


def test_async_manager(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=3, async_save=True)
    for s in range(3):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    mgr.wait()
    mgr.close()
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npz")]) == 3


def test_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """The trap: on the CPU ``tensor.numpy()`` shares memory with the
    tensor, so a save queued as a view would write whatever the tensor
    holds when the writer gets to it.  The save is a copy: mutate in
    place after ``save`` and before ``wait``, restore the old value."""
    import threading

    gate = threading.Event()
    plain = M.save_checkpoint

    def held(*a, **k):
        gate.wait(timeout=30)
        return plain(*a, **k)

    monkeypatch.setattr(M, "save_checkpoint", held)
    mgr = tck.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    w = torch.arange(4, dtype=torch.int64)
    arr = np.arange(3, dtype=np.int32)
    mgr.save(1, {"w": w, "n": arr})
    w.add_(100)
    arr += 50
    gate.set()
    mgr.wait()
    mgr.close()
    step, out, _ = mgr.restore_latest({"w": torch.zeros(1), "n": np.zeros(1)})
    assert step == 1
    assert out["w"].tolist() == [0, 1, 2, 3]
    assert out["n"].tolist() == [0, 1, 2]


def test_restore_latest_quarantines_bitflipped_step(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=3, async_save=False)
    for s in (1, 2):
        mgr.save(s, {"w": torch.full((3,), float(s))},
                 extra={"next_step": s})
    payload = tmp_path / "step_0000000002.npz"
    size = os.path.getsize(payload)
    with open(payload, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    step, tree, _ = mgr.restore_latest({"w": torch.zeros(3)})
    assert step == 1 and float(tree["w"][0]) == 1.0
    assert len([f for f in os.listdir(tmp_path)
                if f.endswith(".corrupt")]) == 2
    mgr.save(3, {"w": torch.full((3,), 3.0)}, extra={"next_step": 3})
    with open(tmp_path / "step_0000000003.npz", "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xfe")
    with pytest.raises(IOError, match="corruption"):
        mgr.restore_latest({"w": torch.zeros(3)}, quarantine=False)
    assert tck.quarantine_step(str(tmp_path), 3) == [
        str(tmp_path / "step_0000000003.json.corrupt"),
        str(tmp_path / "step_0000000003.npz.corrupt")]


def test_ckpt_save_fault_corrupts_payload_post_write(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, {"w": torch.full((2,), 1.0)}, extra={"next_step": 1})
    plan = FaultPlan.parse("ckpt_save=ckptcorrupt")
    with armed(plan):
        mgr.save(2, {"w": torch.full((2,), 2.0)}, extra={"next_step": 2})
    assert plan.spent()
    step, tree, _ = mgr.restore_latest({"w": torch.zeros(2)})
    assert step == 1 and float(tree["w"][0]) == 1.0


def test_ckpt_save_raising_fault_fires_before_the_write(tmp_path):
    from repro_torch.runtime import StepFault

    mgr = tck.CheckpointManager(str(tmp_path), keep=3, async_save=False)
    with armed(FaultPlan.parse("ckpt_save@5=stepfault")):
        mgr.save(4, {"w": torch.zeros(1)})
        with pytest.raises(StepFault):
            mgr.save(5, {"w": torch.zeros(1)})
    assert tck.latest_step(str(tmp_path)) == 4


def test_restore_arity_mismatch_is_not_swallowed(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        mgr.restore_latest({"a": torch.zeros(2), "b": torch.zeros(2)})
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".corrupt")]


def test_async_writer_error_surfaces_on_next_save(tmp_path, monkeypatch):
    mgr = M.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(0, {"w": torch.zeros(2)})
    mgr.wait()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(M, "save_checkpoint", boom)
    mgr.save(1, {"w": torch.zeros(2)})
    mgr._q.join()
    with pytest.raises(RuntimeError, match="writer failed"):
        mgr.save(2, {"w": torch.zeros(2)})
    monkeypatch.undo()
    mgr.save(3, {"w": torch.zeros(2)})
    mgr.close()
    assert tck.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("where", ["wait", "close"])
def test_async_writer_error_surfaces_on_wait_and_close(tmp_path, monkeypatch,
                                                       where):
    monkeypatch.setattr(
        M, "save_checkpoint",
        lambda *a, **k: (_ for _ in ()).throw(OSError("enospc")),
    )
    mgr = M.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(0, {"w": torch.zeros(2)})
    mgr._q.join()
    with pytest.raises(RuntimeError, match="writer failed"):
        getattr(mgr, where)()
    if where == "wait":
        mgr.close()
