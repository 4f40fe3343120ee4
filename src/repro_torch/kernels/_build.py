"""Build and load the package's CUDA kernels.

Every ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, which is loaded with ``ctypes``
(no PyTorch headers: a build takes seconds).  Libraries are built from the
sources in this package and nothing else, at first use, into ``build/`` at
the repository root, under a name that carries a hash of the source and the flags — so an edit rebuilds and
a stale library is never loaded.

There is no fallback: a missing ``nvcc`` or a failed compile raises with
the compiler's output.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["NVCC_FLAGS", "build_dir", "build_all", "load_library", "source_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build"


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME and in "
        "/usr/local/cuda): the CUDA kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    src = source_path(name)
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.blake2b(digest_size=8)
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()}.so"


def _compile(name: str) -> None:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    lib = _lib_path(name)
    if lib.exists():
        return
    nvcc = _find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        check=False,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"$ {' '.join(cmd)}\n{proc.stdout}"
        )
    os.replace(tmp, lib)


def build_all() -> float:
    """Build every kernel library that is not built yet; returns seconds."""
    t0 = time.perf_counter()
    with _LOCK:
        for name in kernel_names():
            _compile(name)
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on demand)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _compile(name)
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib
