"""The port as a package: it stands alone, it runs on the GPU unless told
otherwise, and its command line works."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import repro_torch as rt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores (the counts do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run(
        [sys.executable, *args], env=env, capture_output=True, text=True,
        timeout=300, **kw
    )


def test_port_imports_neither_jax_nor_the_jax_package():
    code = """
    import sys
    import repro_torch as rt
    import repro_torch.launch.tc_run, repro_torch.kernels._build
    import repro_torch.kernels.tc_fused, repro_torch.pipeline
    import repro_torch.kernels.tc_tile, repro_torch.core.tiles
    import repro_torch.launch.train, repro_torch.models.steps
    import repro_torch.models.gnn_steps, repro_torch.examples.train_gnn
    g = rt.graph_from_spec("rmat:8,8,5")
    r = rt.count_triangles(g, q=2, method="fused", device="cpu")
    assert r.triangles == rt.triangle_count_oracle(g), r.triangles
    t = rt.count_triangles(g, q=2, method="tile", device="cpu")
    assert t.triangles == r.triangles, t.triangles
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                 or m == "repro" or m.startswith("repro."))
    assert not bad, bad
    print("CLEAN", r.triangles)
    """
    proc = _run(["-c", textwrap.dedent(code)])
    assert proc.returncode == 0, proc.stderr
    assert "CLEAN" in proc.stdout


def test_no_source_file_of_the_port_names_jax_imports():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    roots = [os.path.join(REPO, "src", "repro_torch")]
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root in roots:
        for d, _, names in os.walk(root):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_default_device_is_the_gpu_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    g = rt.named_graph("karate")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.count_triangles(g)
    with pytest.raises(RuntimeError, match="is_available"):
        rt.count_triangles(g, device="cuda")
    with pytest.raises(RuntimeError):
        rt.resolve_device(None)
    assert rt.resolve_device("cpu") == torch.device("cpu")
    assert rt.count_triangles(g, device="cpu").triangles == 45


def test_cuda_tensor_path_never_falls_back():
    """Without nvcc the loader raises; nothing stands in for the kernel."""
    import shutil

    from repro_torch.kernels import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present on this machine")
    for name in ("tc_fused", "tc_tile"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load_library(name)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.build_dir() == type(_build.build_dir())(REPO) / "build"
    with pytest.raises(FileNotFoundError):
        _build.load_library("no_such_kernel")
    assert _build.kernel_names() == ["tc_fused", "tc_tile"]


def test_cli_counts_karate_on_the_cpu():
    proc = _run(["-m", "repro_torch.launch.tc_run", "--graph", "named:karate",
                 "--grid", "2", "--method", "fused", "--device", "cpu",
                 "--verify", "--json"])
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["triangles"] == 45 and rep["expected"] == 45 and rep["correct"]
    assert rep["grid"] == [2, 2] and rep["method"] == "fused"
    assert rep["device"] == "cpu"
    for key in ("graph", "n", "m", "ppt_seconds", "tct_seconds",
                "total_seconds", "schedule_steps", "skipped_steps",
                "autotuned_chunk", "autotuned_d_small", "plan_cache"):
        assert key in rep, key


def test_cli_without_device_fails_where_there_is_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _run(["-m", "repro_torch.launch.tc_run", "--graph", "named:karate"])
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _run([os.path.join(REPO, "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
