"""The card's measured bf16 matrix rate through cuBLAS.

Port of ``scripts/bench_peak.py``: chains of (M, K)×(K, K) bf16
``torch.matmul`` products (float32 accumulation, no reduced-precision
reduction), each step fed the last one's output, at three square shapes
large enough to saturate the tensor cores (one step is ≥ 8.6 GFLOP, so no
CUDA graph is needed). W is scaled by 2/K so the carried activation stays
O(1). Per repeat count the minimum of ``--runs`` timed chains (CUDA
events, after one warm chain); the rate is the least-squares slope of
time against repeat count, so fixed costs land in the intercept. It is a
library path only, printed beside the H100 data sheet's 989 TFLOP/s.

``device="cpu"`` (or ``--device cpu``) runs the same chains on the CPU:
a check of the harness, not a measurement of a card.

Usage: python -m s2sr_tpu_torch.bench.peak [--runs 5] [--device cuda|cpu]
Prints one JSON line per shape and a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .mxu import PEAK_BF16_FLOPS
from .rdb_ladder import card_name

# (m, k, repeats): 1024-square is the canonical peak shape; 512 and 2048
# bracket it
SHAPES = ((8192, 1024, (256, 1024, 2048, 4096)),
          (8192, 512, (1024, 4096, 8192)),
          (4096, 2048, (128, 512, 1024)))


def chain(x: torch.Tensor, w: torch.Tensor, repeat: int) -> torch.Tensor:
    for _ in range(repeat):
        x = torch.matmul(x, w)
    return x


def time_min(fn, runs: int, device: str) -> float:
    """Least milliseconds of ``runs`` calls, after one warm call."""
    fn()
    best = float("inf")
    for _ in range(runs):
        if device == "cpu":
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def measure(m: int, k: int, repeats, runs: int, device: str) -> dict:
    """One shape's line: the slope's rate, ms per step, the minimum time
    per repeat count."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((m, k)).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
    w = torch.from_numpy((rng.random((k, k)) * (2.0 / k)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)
    times = [time_min(lambda r=r: chain(x, w, r), runs, device)
             for r in repeats]
    rs = np.asarray(repeats, np.float64)
    ts = np.asarray(times, np.float64)
    slope_ms = float(np.cov(rs, ts, bias=True)[0, 1] / np.var(rs))
    tf = 2.0 * m * k * k / (slope_ms * 1e9)
    return {"bench": "peak_chain", "m": m, "k": k, "tf_s": tf,
            "ms_per_iter": slope_ms,
            "min_times_ms": {str(r): t for r, t in zip(repeats, times)}}


def peak(shapes=SHAPES, runs: int = 5, device: str = "cuda",
         emit=None) -> dict:
    """Each shape's line, then the summary: the best rate, per shape, the
    card and the data sheet's peak. Returns the summary."""
    emit = emit or (lambda obj: print(json.dumps(obj), flush=True))
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device (or --device cpu)")
    card = card_name(device)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        results = {}
        for m, k, repeats in shapes:
            line = measure(m, k, repeats, runs, device)
            results[f"{m}x{k}x{k}"] = line["tf_s"]
            emit({**line, "device": device, "card": card})
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    summary = {"bench": "peak_summary", "bf16_peak_tf_s": max(results.values()),
               "per_shape": results, "data_sheet_tf_s": PEAK_BF16_FLOPS / 1e12,
               "device": device, "card": card}
    emit(summary)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    peak(runs=args.runs, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
