"""Build and load the package's hand-written CUDA kernels.

``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``.
Libraries are cached by a hash of the source and the flags in
``build/kernels/`` beside the package (override with
``S2SR_TORCH_BUILD_DIR``), so the first use builds and later uses load.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def build_dir() -> Path:
    env = os.environ.get("S2SR_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> tuple:
    """Compile ``csrc/<name>.cu`` unless it is cached. Returns
    ``(seconds, compiler output)``, ``(0.0, "")`` on a cache hit; the
    output holds ptxas's ``-v`` report. Raises with the output if
    ``nvcc`` fails."""
    lib = lib_path(name)
    if lib.exists():
        return 0.0, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0, proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]
