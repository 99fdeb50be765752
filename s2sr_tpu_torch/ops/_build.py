"""Build and load the package's hand-written CUDA kernels.

``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``.
Libraries are cached by a hash of the source and the flags in
``build/kernels/`` beside the package (override with
``S2SR_TORCH_BUILD_DIR``), so the first use builds and later uses load.
Host libraries (C++ for the CPU, such as ``native/pngenc.cc``) are built
the same way with ``g++`` (:func:`build_host`) into the same directory,
never beside their source. :func:`build_all` builds or loads every one of
them (``cli.warmup`` runs it before a server takes traffic). Nothing here
runs at import time.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall")

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


def lib_path(name: str, defines=()) -> Path:
    """The cached library of ``csrc/<name>.cu`` built with ``defines``
    (``-D`` flags, none for the library the package loads)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        [*NVCC_FLAGS, *defines]).encode()).hexdigest()
    return build_dir() / f"lib{name}_{digest[:16]}.so"


def build(name: str, defines=()) -> tuple:
    """Compile ``csrc/<name>.cu`` (with ``defines``, ``-D`` flags) unless
    it is cached. Returns ``(seconds, compiler output)``, ``(0.0, "")`` on
    a cache hit; the output holds ptxas's ``-v`` report. Raises with the
    output if ``nvcc`` fails."""
    return _compile([_nvcc(), *NVCC_FLAGS, *defines], CSRC / f"{name}.cu",
                    lib_path(name, defines), ())


def _compile(compiler: list, src: Path, lib: Path, libs) -> tuple:
    if lib.exists():
        return 0.0, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*compiler, "-o", str(tmp), str(src), *libs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler[0]).name} failed for "
                           f"{src.name}:\n{proc.stdout}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0, proc.stdout


def host_lib_path(src: Path, flags=()) -> Path:
    """The cached library of a host source built with ``flags`` (defines
    and libraries)."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        [*GXX_FLAGS, *flags]).encode()).hexdigest()
    return build_dir() / f"lib{src.stem}_{digest[:16]}.so"


def build_host(src: Path, flags=()) -> Path:
    """Compile the C++ host source ``src`` with ``g++`` and ``flags``
    (``-D`` defines, then ``-l`` libraries) into the build directory
    unless it is cached; the library's path. Raises with the compiler's
    output if the build fails."""
    lib = host_lib_path(src, flags)
    if lib.exists():
        return lib
    gxx = shutil.which(os.environ.get("CXX", "g++"))
    if gxx is None:
        raise RuntimeError("no C++ compiler: put g++ on PATH or set CXX")
    defines = [f for f in flags if not f.startswith("-l")]
    _compile([gxx, *GXX_FLAGS, *defines], src, lib,
             [f for f in flags if f.startswith("-l")])
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]


def build_all() -> dict:
    """Build, or find in the cache, every library of ``csrc/`` (one
    ``nvcc`` per source, all started together; only where CUDA is
    available) and of ``native/`` (``g++``). Returns ``{name:
    {"seconds": s, "cached": bool}}``; the native PNG encoder's entry
    adds ``"encoder"`` ("native" or "pure": a failed host build leaves
    the pure encoder, as at run time). Raises if an ``nvcc`` build
    fails."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from .. import native

    def kernel(name):
        cached = lib_path(name).exists()
        t0 = time.perf_counter()
        build(name)
        return name, {"seconds": time.perf_counter() - t0, "cached": cached}

    def host():
        cached = any(host_lib_path(native.SOURCE, flags).exists()
                     for flags in native.FLAG_SETS)
        t0 = time.perf_counter()
        encoder = native.png_encoder()["png_encoder"]
        return native.SOURCE.stem, {"seconds": time.perf_counter() - t0,
                                    "cached": cached, "encoder": encoder}

    names = (sorted(p.stem for p in CSRC.glob("*.cu"))
             if torch.cuda.is_available() else [])
    with ThreadPoolExecutor(len(names) + 1) as pool:
        futures = [pool.submit(kernel, n) for n in names]
        futures.append(pool.submit(host))
        return dict(f.result() for f in futures)
