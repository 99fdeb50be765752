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
  tensor they launch a kernel of ``csrc/matmul_chain.cu`` or raise, all
  bf16 with float32 accumulators and the carry in registers or shared
  memory: ``wgmma`` with W resident in shared memory (:func:`pack_wgmma`)
  where the source has an instance and W fits; at the unstaged chain's
  K 512 and the unstaged 384×192 pair (:data:`RING_SHAPES`), whose W does
  not fit, ``wgmma`` with W streamed through a ring of slabs
  (:func:`pack_wgmma_slabs`); else ``mma.sync`` with W fragment-packed
  (:func:`pack_fragments`). On a CPU tensor they run the plain version
  (:func:`matmul_chain_reference` / :func:`pair_chain_reference`).
  Shapes, types and ``design`` are checked first, on either device:
  bf16, contiguous, any M ≥ 1, K and N multiples of 16 in [16, 512],
  ``repeat`` ≥ 0.
- ``design`` (nothing in the port passes it; ``chip_smoke.py`` times the
  designs in one call): ``"served"`` the route above, ``"multicast"`` the
  ring kernel's instance that multicasts each slab to both blocks of a
  2-block cluster (the ring shapes only, unstaged; slower on the card,
  so not served), ``"mma"`` the ``mma.sync`` kernel at any shape.
- :data:`LAUNCHES` counts the served launches per kernel, nothing else;
  :data:`LAUNCHES_RING` those of them that took the ring;
  :data:`LAUNCHES_MULTICAST` and :data:`LAUNCHES_MMA` the launches of the
  two other designs.
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
LAUNCHES_RING = {name: 0 for name in KERNELS}
LAUNCHES_MULTICAST = {name: 0 for name in KERNELS}
LAUNCHES_MMA = {name: 0 for name in KERNELS}
DESIGNS = ("served", "multicast", "mma")
MAX_WIDTH = 512
# the (K, N) each wrapper runs on the ring kernel, unstaged
RING_SHAPES = {"matmul_chain": (512, 512), "pair_chain": (384, 192)}

_QUERY = {"rows_per_block": 0, "smem_bytes": 1, "w_in_smem": 2, "warps": 3,
          "kmax": 4, "copies": 5, "wgmma": 6, "path": 7, "threads": 8,
          "ring_slots": 9, "cluster": 10, "slab_cols": 11}
ROUTES = {0: "mma.sync", 1: "wgmma", 2: "wgmma_ring"}


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


def pack_wgmma_slabs(w: torch.Tensor, cols: int) -> torch.Tensor:
    """``w (K, N)`` as the ring kernel's slab stream: for each block of
    ``cols`` output columns in order, its ``K/64`` slabs of 64 K values ×
    ``cols`` columns, each :func:`pack_wgmma`'s image of that block (K
    padded to 64): ``[N/cols · K/64][cols][64]``, one slab a bulk copy, in
    the order the kernel's consumers read them."""
    k, n = w.shape
    if n % cols:
        raise ValueError(f"pack_wgmma_slabs: N {n} is not a multiple of {cols}")
    return torch.cat([pack_wgmma(w[:, c:c + cols]) for c in range(0, n, cols)])


def ring_smem_plan(name: str) -> dict:
    """The ring kernel's shared memory at its shape, as
    ``csrc/matmul_chain.cu::RingShape`` computes it: 1,024 bytes to align
    the slots, the slots (as many slabs as fit, at most 8), the chain's two
    stage tiles (64 rows of K − 128 + 8 bf16: chunks 0–2 of a step) and,
    a slot, its full mbarrier and its block and cluster release counts."""
    k, n = RING_SHAPES[name]
    pair = name == "pair_chain"
    cols = n if pair else 128
    slab = cols * 128
    stage = 0 if pair else 2 * 64 * (k - 128 + 8)
    slots = min(8, (232448 - 1024 - 2 * stage) // (slab + 16))
    steps = k // 64 + (n // 64) * (k // n) if pair else (k // 128) * (k // 64)
    return {"slab_cols": cols, "slab_bytes": slab, "slabs_a_step": steps,
            "ring_slots": slots, "stage_bytes": stage,
            "smem_bytes": 1024 + slots * slab + 2 * stage + 16 * slots}


def _lib():
    from ._build import load

    lib = load("matmul_chain")
    if not getattr(lib, "_s2sr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.s2sr_matmul_chain_forward.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                                  ci, ci, ci, ci, vp]
        lib.s2sr_matmul_chain_forward.restype = ci
        lib.s2sr_matmul_chain_query.argtypes = [ci, ci, ci, ci, ci, ci]
        lib.s2sr_matmul_chain_ring_groups.argtypes = [ci, ci, ci]
        lib.s2sr_matmul_chain_ring_groups.restype = ci
        lib.s2sr_matmul_chain_query.restype = ctypes.c_longlong
        lib._s2sr_typed = True
    return lib


def kernel_tiling(name: str, k: int, n: int, stage: bool,
                  design: str = "served") -> dict:
    """The launch plan of ``design`` at width ``k`` (and ``n`` for the
    pair), as the kernel source computes it: rows per block, dynamic
    shared bytes, whether the weights sit in shared memory, warps per block
    (the ring: consumer warps), the register class of A, the copies stored
    per product, the path and its ``route`` (:data:`ROUTES`), threads per
    block, the B ring's slots, blocks a cluster and a B slab's columns."""
    lib = _lib()
    pair = int(name == "pair_chain")
    plan = {key: int(lib.s2sr_matmul_chain_query(
                k, n if pair else k, pair, int(stage), DESIGNS.index(design),
                what))
            for key, what in _QUERY.items()}
    if plan["path"] < 0:
        raise ValueError(f"{name}: no plan for K {k}, N {n}, stage {stage}, "
                         f"design {design!r}")
    return {**plan, "route": ROUTES[plan["path"]]}


def ring_groups(name: str, design: str, m: int) -> int:
    """The groups the ring kernel of ``design`` ("served": blocks,
    "multicast": clusters of 2 blocks) runs at ``m`` rows on the current
    card: as many as can be resident at once, at most one a tile. Needs
    the card."""
    got = _lib().s2sr_matmul_chain_ring_groups(int(name == "pair_chain"),
                                               DESIGNS.index(design), m)
    if got < 1:
        raise RuntimeError(f"{name} {design}: ring occupancy query failed "
                           f"(CUDA error {-got})")
    return got


def on_ring(name: str, k: int, n: int, stage: bool) -> bool:
    """Whether the served call at this shape runs the ring kernel."""
    return not stage and RING_SHAPES[name] == (k, n)


def _check(name: str, x: torch.Tensor, ws, repeat: int, stage: bool,
           design: str) -> None:
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
    if design not in DESIGNS:
        raise ValueError(f"{name}: design {design!r} not in {DESIGNS}")
    if design == "multicast" and not on_ring(name, k, n if len(ws) == 2 else k,
                                             stage):
        raise ValueError(f"{name}: design 'multicast' exists at "
                         f"{RING_SHAPES[name]} unstaged only")


def _launch(name: str, x: torch.Tensor, ws, repeat: int, stage: bool,
            design: str) -> torch.Tensor:
    _check(name, x, ws, repeat, stage, design)
    if x.device.type == "cpu":
        return REFERENCES[name](x, *ws, repeat, stage)
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} wants a 16-byte aligned x")
    m, k = x.shape
    n = ws[0].shape[1]
    plan = kernel_tiling(name, k, n, stage, design)
    if plan["path"] == 2:       # one stream of slabs: w1's, then w2's
        packed = [torch.cat([pack_wgmma_slabs(w, plan["slab_cols"])
                             for w in ws])]
    else:
        packed = [(pack_wgmma if plan["path"] == 1 else pack_fragments)(w)
                  for w in ws]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().s2sr_matmul_chain_forward(
            x.data_ptr(), out.data_ptr(), packed[0].data_ptr(),
            packed[-1].data_ptr(), m, k, n, repeat, int(len(ws) == 2),
            int(stage), DESIGNS.index(design), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    {"served": LAUNCHES, "multicast": LAUNCHES_MULTICAST,
     "mma": LAUNCHES_MMA}[design][name] += 1
    if design == "served" and plan["path"] == 2:
        LAUNCHES_RING[name] += 1
    return out


def matmul_chain(x: torch.Tensor, w: torch.Tensor, repeat: int,
                 stage: bool = False, design: str = "served") -> torch.Tensor:
    """``repeat`` chained products ``acc = bf16(acc @ w)`` of ``x (M, K)``
    with ``w (K, K)``, bf16. CPU tensors run :func:`matmul_chain_reference`
    (whatever the ``design``); CUDA tensors launch ``design``'s kernel or
    raise."""
    return _launch("matmul_chain", x, (w,), repeat, stage, design)


def pair_chain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               repeat: int, stage: bool = False,
               design: str = "served") -> torch.Tensor:
    """``repeat`` product pairs ``acc = bf16(bf16(acc @ w1) @ w2)`` of
    ``x (M, K)`` with ``w1 (K, N)``, ``w2 (N, K)``, bf16; as
    :func:`matmul_chain`."""
    return _launch("pair_chain", x, (w1, w2), repeat, stage, design)


WRAPPERS = {"matmul_chain": matmul_chain, "pair_chain": pair_chain}
