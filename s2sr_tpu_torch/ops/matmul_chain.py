"""Chained bf16 matrix products on the tensor cores: the hand-written
Hopper kernels, their plain PyTorch versions and the cuBLAS yardstick.

Replaces the TPU kernels of the matrix-unit microbenchmark
``scripts/bench_mxu.py``: ``_pallas_chain`` (:func:`matmul_chain`) and
``_pair_chain`` (:func:`pair_chain`). Both carry a bf16 activation
``x (M, K)`` through ``repeat`` steps, each product computed in float32
and rounded to bf16::

    chain:  acc = bf16(acc @ W)                  W (K, K)
    pair:   acc = bf16(bf16(acc @ w1) @ w2)      w1 (K, N), w2 (N, K)

``stage=True`` stores each step's operands through a stage buffer first,
as the TPU kernels do; it costs stores and changes no value.

- :func:`matmul_chain` / :func:`pair_chain` are the wrappers. On a CUDA
  tensor they launch the kernel in ``csrc/matmul_chain.cu`` or raise:
  ``wgmma`` with the carry in registers and W in shared memory
  (:func:`pack_wgmma`) where the source has an instance and W fits,
  else ``mma.sync`` with W fragment-packed (:func:`pack_fragments`), both
  bf16 with float32 accumulators; on a CPU tensor they run the
  plain version (:func:`matmul_chain_reference` /
  :func:`pair_chain_reference`). Shapes and types are checked first, on
  either device: bf16, contiguous, any M ≥ 1, K and N multiples of 16 in
  [16, 512], ``repeat`` ≥ 0.
- :data:`LAUNCHES` counts kernel launches per kernel, nothing else.
- :func:`matmul_chain_library` / :func:`pair_chain_library` compute the
  same function with one ``torch.matmul`` (cuBLAS) per product, captured
  in a CUDA graph on the card. They are the yardstick the benchmark and
  ``chip_smoke.py`` time beside the kernels; no path of the port calls
  them.
"""

from __future__ import annotations

import ctypes

import torch

KERNELS = ("matmul_chain", "pair_chain")
LAUNCHES = {name: 0 for name in KERNELS}
MAX_WIDTH = 512

_QUERY = {"rows_per_block": 0, "smem_bytes": 1, "w_in_smem": 2, "warps": 3,
          "kmax": 4, "copies": 5, "wgmma": 6}


# --- plain versions ----------------------------------------------------------

def _stage(v: torch.Tensor, copies: int) -> torch.Tensor:
    """``v`` stored into ``copies`` side-by-side slots of a stage buffer,
    read back from slot 0."""
    k = v.shape[1]
    buf = v.new_empty(v.shape[0], copies * k)
    for s in range(copies):
        buf[:, s * k:(s + 1) * k] = v
    return buf[:, :k]


def _product(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (v.float() @ w.float()).to(torch.bfloat16)


def matmul_chain_reference(x: torch.Tensor, w: torch.Tensor, repeat: int,
                           stage: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``_pallas_chain``: ``repeat`` times
    ``acc = bf16(float32(acc) @ float32(W))``; staged, ``acc`` first goes
    through three slots, as ``_dot_kernel`` stages it."""
    acc = x
    for _ in range(repeat):
        acc = _product(_stage(acc, 3) if stage else acc, w)
    return acc


def pair_chain_reference(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                         repeat: int, stage: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``_pair_chain``: ``repeat`` times
    ``acc = bf16(bf16(acc @ w1) @ w2)`` in float32 products; staged, each
    operand first goes through slot 0, as ``_pair_kernel`` stages it."""
    acc = x
    for _ in range(repeat):
        mid = _product(_stage(acc, 1) if stage else acc, w1)
        acc = _product(_stage(mid, 1) if stage else mid, w2)
    return acc


REFERENCES = {"matmul_chain": matmul_chain_reference,
              "pair_chain": pair_chain_reference}


# --- the cuBLAS yardstick ----------------------------------------------------

_GRAPHS: dict = {}


def _library(x: torch.Tensor, ws, repeat: int) -> torch.Tensor:
    def run():
        acc = x
        for _ in range(repeat):
            for w in ws:
                acc = torch.matmul(acc, w)
        return acc

    if x.device.type != "cuda":
        return run()
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        key = (x.device.index, x.data_ptr(), tuple(x.shape), repeat,
               tuple((w.data_ptr(), tuple(w.shape)) for w in ws))
        entry = _GRAPHS.get(key)
        if entry is None:
            side = torch.cuda.Stream(x.device)          # warm up off the
            side.wait_stream(torch.cuda.current_stream(x.device))  # capture
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream(x.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = run()
            # the inputs are held so that their memory is not reused
            entry = _GRAPHS[key] = (graph, out, x, tuple(ws))
        entry[0].replay()
        return entry[1]
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def matmul_chain_library(x: torch.Tensor, w: torch.Tensor,
                         repeat: int) -> torch.Tensor:
    """The chain as ``repeat`` bf16 ``torch.matmul`` calls (cuBLAS, float32
    accumulation, no reduced-precision reduction). On the card the calls
    are captured once per input and repeat count in a CUDA graph, so that
    the time is cuBLAS's and not the launch queue's; the result is the
    graph's output buffer, overwritten by the next call with the same
    inputs."""
    return _library(x, (w,), repeat)


def pair_chain_library(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                       repeat: int) -> torch.Tensor:
    """The pair chain as ``2·repeat`` ``torch.matmul`` calls; as
    :func:`matmul_chain_library`."""
    return _library(x, (w1, w2), repeat)


# --- the kernels -------------------------------------------------------------

def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """``w (K, N)`` in the kernel's B-fragment order of ``mma.m16n8k16``:
    ``[K/16][N/16][lane][8]``, where lane ``4g + t`` holds, for the two n8
    halves j of the 16-column slab, rows ``2t, 2t+1`` then ``2t+8, 2t+9``
    of column ``8j + g``."""
    k, n = w.shape
    return (w.reshape(k // 16, 2, 4, 2, n // 16, 2, 8)
             .permute(0, 4, 6, 2, 5, 1, 3).contiguous())


def pack_wgmma(w: torch.Tensor) -> torch.Tensor:
    """``w (K, N)`` as the kernel's shared-memory image of ``wgmma``'s
    K-major B operand with the 128-byte swizzle: K zero-padded to a
    multiple of 64, then ``[K/64][N][64]`` (row ``n`` holds column ``n`` of
    ``w``, 64 K values in 128 bytes), the 16-byte chunk ``c`` of row ``n``
    stored at chunk ``c ^ (n % 8)``."""
    k, n = w.shape
    kp = -(-k // 64) * 64
    wt = torch.zeros(n, kp, dtype=w.dtype, device=w.device)
    wt[:, :k] = w.t()
    blocks = wt.reshape(n, kp // 64, 8, 8).permute(1, 0, 2, 3)   # [kb][n][c][e]
    rows = torch.arange(n, device=w.device)
    chunk = torch.arange(8, device=w.device)[None, :] ^ (rows[:, None] % 8)
    # chunk j of row n holds logical chunk j ^ (n % 8)
    idx = chunk[None, :, :, None].expand(kp // 64, n, 8, 8)
    return torch.gather(blocks, 2, idx).contiguous()


def _lib():
    from ._build import load

    lib = load("matmul_chain")
    if not getattr(lib, "_s2sr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.s2sr_matmul_chain_forward.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                                  ci, ci, ci, vp]
        lib.s2sr_matmul_chain_forward.restype = ci
        lib.s2sr_matmul_chain_query.argtypes = [ci, ci, ci, ci, ci]
        lib.s2sr_matmul_chain_query.restype = ctypes.c_longlong
        lib._s2sr_typed = True
    return lib


def kernel_tiling(name: str, k: int, n: int, stage: bool) -> dict:
    """The kernel's launch plan at width ``k`` (and ``n`` for the pair), as
    the kernel source computes it: rows per block, dynamic shared bytes,
    whether the weights sit in shared memory, warps per block, the
    register class of A and the copies stored per product."""
    lib = _lib()
    pair = int(name == "pair_chain")
    return {key: int(lib.s2sr_matmul_chain_query(k, n if pair else k, pair,
                                                  int(stage), what))
            for key, what in _QUERY.items()}


def _check(name: str, x: torch.Tensor, ws, repeat: int) -> None:
    if x.dim() != 2 or any(w.dim() != 2 for w in ws):
        raise ValueError(f"{name} wants x (M, K) and 2-D weights")
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16 for w in ws):
        raise TypeError(f"{name} takes bfloat16 only, got {x.dtype} and "
                        f"{[w.dtype for w in ws]}")
    m, k = x.shape
    n = ws[0].shape[1]
    want = [(k, k)] if len(ws) == 1 else [(k, n), (n, k)]
    if [tuple(w.shape) for w in ws] != want:
        raise ValueError(f"{name}: x {tuple(x.shape)} with weights "
                         f"{[tuple(w.shape) for w in ws]}, want {want}")
    if m < 1 or any(d % 16 or not 16 <= d <= MAX_WIDTH for d in (k, n)):
        raise ValueError(f"{name}: M ≥ 1 and K, N multiples of 16 in "
                         f"[16, {MAX_WIDTH}], got M {m}, K {k}, N {n}")
    if not isinstance(repeat, int) or repeat < 0:
        raise ValueError(f"{name}: repeat must be an int ≥ 0, got {repeat!r}")
    if not x.is_contiguous() or any(not w.is_contiguous() for w in ws):
        raise ValueError(f"{name} wants contiguous tensors")
    if any(w.device != x.device for w in ws):
        raise ValueError(f"{name}: weights must be on {x.device}")


def _launch(name: str, x: torch.Tensor, ws, repeat: int,
            stage: bool) -> torch.Tensor:
    _check(name, x, ws, repeat)
    if x.device.type == "cpu":
        return REFERENCES[name](x, *ws, repeat, stage)
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} wants a 16-byte aligned x")
    m, k = x.shape
    n = ws[0].shape[1]
    lib = _lib()
    wgmma = lib.s2sr_matmul_chain_query(k, n, int(len(ws) == 2), int(stage),
                                        _QUERY["wgmma"]) == 1
    packed = [(pack_wgmma if wgmma else pack_fragments)(w) for w in ws]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.s2sr_matmul_chain_forward(
            x.data_ptr(), out.data_ptr(), packed[0].data_ptr(),
            packed[-1].data_ptr(), m, k, n, repeat, int(len(ws) == 2),
            int(stage), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def matmul_chain(x: torch.Tensor, w: torch.Tensor, repeat: int,
                 stage: bool = False) -> torch.Tensor:
    """``repeat`` chained products ``acc = bf16(acc @ w)`` of ``x (M, K)``
    with ``w (K, K)``, bf16. CPU tensors run :func:`matmul_chain_reference`;
    CUDA tensors launch the kernel or raise."""
    return _launch("matmul_chain", x, (w,), repeat, stage)


def pair_chain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               repeat: int, stage: bool = False) -> torch.Tensor:
    """``repeat`` product pairs ``acc = bf16(bf16(acc @ w1) @ w2)`` of
    ``x (M, K)`` with ``w1 (K, N)``, ``w2 (N, K)``, bf16; as
    :func:`matmul_chain`."""
    return _launch("pair_chain", x, (w1, w2), repeat, stage)


WRAPPERS = {"matmul_chain": matmul_chain, "pair_chain": pair_chain}
