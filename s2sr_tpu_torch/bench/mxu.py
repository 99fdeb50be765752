"""Matrix-unit microbenchmark: the tensor cores' rate at the RDB's shapes,
with the operands kept on chip.

Port of ``scripts/bench_mxu.py``. Variants, each beside the TPU variant
it stands for:

- ``cuda_dot`` (``pallas_dot``): ``repeat`` chained (M, K)×(K, K) bf16
  products with float32 accumulation in one launch of the hand-written
  kernel ``csrc/matmul_chain.cu`` (``ops/matmul_chain.py::matmul_chain``):
  the tensor cores' rate with the carry in registers, W resident in
  shared memory where it fits and streamed through a ring of slabs at
  K 512;
- ``cuda_dot_stage`` (``pallas_dot_stage``): the same, each product's
  output stored in three slots first, as the TPU's v2 kernel stages its
  taps: the cost of staging;
- ``torch_dot`` (``xla_dot``): the same chain as one ``torch.matmul``
  (cuBLAS) per step, captured in a CUDA graph
  (``matmul_chain_library``);
- ``--pairs KxN,...``: ``pair`` / ``pair_stage`` (the TPU's ``pair`` /
  ``pair_stage``), alternating (K→N, N→K) products in
  ``ops/matmul_chain.py::pair_chain``, and ``torch_pair``, their cuBLAS
  twin.

Every rate is differential, as in the TPU script: ms per launch at
``--lo`` and ``--hi`` repeats (CUDA events, mean of ``--runs`` launches
after one warm launch), and the extra FLOP over the extra time, so fixed
costs cancel. One JSON line per variant: ``bench, k, n, tf_s, ms_lo,
ms_hi``, as the TPU script prints, plus ``m``, ``device``, ``card``
(``nvidia-smi``'s name and power limit), ``bound_ms_hi`` (the H100's
least time for one launch at ``--hi``: FLOP at 989 TFLOP/s or bytes at
3.35 TB/s, the larger), ``rows_per_block`` of the kernel (None for the
library) and ``finite`` (whether the ``--hi`` output is finite).

Inputs depart from the TPU script on purpose: it feeds uniform [0, 1)
data unscaled, so each product multiplies the row sums by about K/2 and
the chain overflows bf16 within tens of steps. Here W is scaled by 2/K
(w1 by 2/K, w2 by 2/N), as ``scripts/bench_peak.py`` scales its W, so
the timed chain stays finite and can be checked.

``--device cpu`` runs the wrappers' plain versions (use a small ``--m``):
a check of the harness, not a measurement of a card.

Usage: python -m s2sr_tpu_torch.bench.mxu [--runs 3] [--lo 128] [--hi 1024]
       [--ks 192,128,256,512] [--pairs 96x160,...] [--m 27840]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import matmul_chain as mc
from .rdb_ladder import card_name

M = 27840                      # the v2 RDB kernel's product M (174·160)
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16, NVIDIA data sheet
PEAK_BYTES = 3.35e12
CHAIN_VARIANTS = ("cuda_dot", "cuda_dot_stage", "torch_dot")
PAIR_VARIANTS = ("pair", "pair_stage", "torch_pair")


def inputs(rng, m: int, k: int, n, device: str):
    """x (m, k) uniform [0, 1) and the weights, uniform [0, 1) scaled by 2
    over their fan-in: ``(W,)`` for the chain (``n`` None), ``(w1, w2)``
    for the pair. bf16 on ``device``."""
    def bf16(v):
        return torch.from_numpy(v.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)

    x = bf16(rng.random((m, k)))
    if n is None:
        return x, (bf16(rng.random((k, k)) * (2.0 / k)),)
    return x, (bf16(rng.random((k, n)) * (2.0 / k)),
               bf16(rng.random((n, k)) * (2.0 / n)))


def variant_fn(name: str, x, ws):
    """``f(repeat)`` running the variant once."""
    if name in ("cuda_dot", "cuda_dot_stage"):
        return lambda r: mc.matmul_chain(x, *ws, r, stage=name.endswith("stage"))
    if name in ("pair", "pair_stage"):
        return lambda r: mc.pair_chain(x, *ws, r, stage=name.endswith("stage"))
    if name == "torch_dot":
        return lambda r: mc.matmul_chain_library(x, *ws, r)
    return lambda r: mc.pair_chain_library(x, *ws, r)


def time_launch(fn, runs: int, device: str):
    """(mean ms per call over ``runs`` calls after one warm call, the last
    output)."""
    out = fn()
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(runs):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / runs, out
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs, out


def bound_ms(m: int, k: int, n, repeat: int) -> float:
    """The H100's least time for one launch: FLOP at the bf16 peak or the
    bytes (x in, out, the weights) at the HBM rate, the larger."""
    if n is None:
        flops, wbytes = 2 * m * k * k * repeat, 2 * k * k
    else:
        flops, wbytes = 4 * m * k * n * repeat, 4 * k * n
    return max(flops / PEAK_BF16_FLOPS, (4 * m * k + wbytes) / PEAK_BYTES) * 1e3


def measure(name: str, x, ws, lo: int, hi: int, runs: int, device: str,
            card: str) -> dict:
    """One variant's JSON line."""
    m, k = x.shape
    pair = len(ws) == 2
    n = ws[0].shape[1] if pair else None
    fn = variant_fn(name, x, ws)
    ms_lo, _ = time_launch(lambda: fn(lo), runs, device)
    ms_hi, out = time_launch(lambda: fn(hi), runs, device)
    per_step = (4 * m * k * n) if pair else (2 * m * k * k)
    dflops = per_step * (hi - lo)
    tf = dflops / ((ms_hi - ms_lo) * 1e9) if ms_hi > ms_lo else float("nan")
    rows = None
    if device != "cpu" and not name.startswith("torch"):
        rows = mc.kernel_tiling("pair_chain" if pair else "matmul_chain", k,
                                n or k, name.endswith("stage"))["rows_per_block"]
    return {"bench": name, "k": k, "n": n if pair else k, "tf_s": tf,
            "ms_lo": ms_lo, "ms_hi": ms_hi, "m": m, "device": device,
            "card": card, "bound_ms_hi": bound_ms(m, k, n, hi),
            "rows_per_block": rows,
            "finite": bool(torch.isfinite(out.float()).all().item())}


def run(ks=(192, 128, 256, 512), pairs=(), m: int = M, lo: int = 128,
        hi: int = 1024, runs: int = 3, device: str = "cuda",
        emit=None) -> list:
    """The chains at each K of ``ks``, then the pairs ``(K, N)`` of
    ``pairs``, as ``main`` runs them; returns (and emits) the lines."""
    emit = emit or (lambda obj: print(json.dumps(obj), flush=True))
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device (or --device cpu)")
    card = card_name(device)
    rng = np.random.default_rng(0)
    lines = []
    cases = [(k, None, CHAIN_VARIANTS) for k in ks]
    cases += [(k, n, PAIR_VARIANTS) for k, n in pairs]
    for k, n, variants in cases:
        x, ws = inputs(rng, m, k, n, device)
        for name in variants:
            line = measure(name, x, ws, lo, hi, runs, device, card)
            emit(line)
            lines.append(line)
        del x, ws
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--lo", type=int, default=128)
    ap.add_argument("--hi", type=int, default=1024)
    ap.add_argument("--ks", default="192,128,256,512")
    ap.add_argument("--pairs", default="",
                    help="KxN,... : run the pairs instead of the chains")
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.pairs:
        pairs = [tuple(int(v) for v in spec.split("x"))
                 for spec in args.pairs.split(",")]
        run((), pairs, args.m, args.lo, args.hi, args.runs, args.device)
    else:
        run([int(v) for v in args.ks.split(",")], (), args.m, args.lo,
            args.hi, args.runs, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
