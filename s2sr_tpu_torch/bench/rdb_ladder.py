"""The RDB ablation ladder: every fused-RDB formulation of the port, gated
for exactness and timed in chains on one card.

Port of ``scripts/bench_kernels.py``'s gate and timing. Variants:

- ``plain``: ``ops/rdb.py::rdb_reference`` (cuDNN convs), the counterpart
  of the JAX ladder's XLA variants ``xla`` / ``xp``;
- ``v1``, ``v2``, ``v3``: the K-packed concat rung and the delta-form
  rungs in ``csrc/rdb_ladder.cu`` (``ops/rdb_ladder.py``);
- ``v4``: ``ops/rdb.py::rdb``, the main path's kernel ``csrc/rdb.cu``.

Each kernel variant is first gated in float32 at (1, 40, 72) against
``rdb_reference`` (max abs error < 1e-4; TF32 off). Then a chain of
``--chain`` RDBs runs on one stream at ``--shape`` in bfloat16, ``--runs``
times back to back, each run fed the last one's output, timed with CUDA
events. One JSON line per variant: ``variant, shape, chain,
ms_per_chain, tf_s`` (useful TFLOP/s at 479,232 FLOP per pixel),
``compile_s`` (the first chain's seconds, kernel build included),
``ms_per_launch``, ``card``, and for the kernels the tile and the FLOP
the kernel executes per output pixel (halo recompute included), as the
kernel source counts them.

``--device cpu`` runs the wrappers' plain versions (use a small
``--shape``): a check of the harness, not a measurement of a card.

Usage: python -m s2sr_tpu_torch.bench.rdb_ladder [--variants plain,v1,v2,v3,v4]
       [--runs 3] [--chain 12] [--shape 16,264,264] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from ..models.weights import init_state_dict
from ..ops import rdb as rdb_mod
from ..ops import rdb_ladder as ladder_mod

FLOP_PER_PIXEL = 2 * 9 * (64 * 192 + 32 * (160 + 128 + 96 + 64))
VARIANTS = ("plain", "v1", "v2", "v3", "v4")
GATE_SHAPE = (1, 40, 72)
GATE_TOL = 1e-4


def card_name(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if device == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ladder_weights(seed: int = 0):
    """One RDB of the seeded ``realesrgan_x4`` init: five OIHW kernels and
    their (zero) biases."""
    sd = init_state_dict(num_block=1, seed=seed)
    return ([sd[f"body.0.rdb1.conv{k}.weight"] for k in range(1, 6)],
            [sd[f"body.0.rdb1.conv{k}.bias"] for k in range(1, 6)])


def variant_fns(variants, kernels, biases, dtype, device) -> dict:
    """name → one RDB on ``x`` with the variant's weights in ``dtype``."""
    w, b = (t.to(device) for t in rdb_mod.pack_rdb_weights(kernels, biases,
                                                           dtype))
    fns = {}
    for name in variants:
        if name == "plain":
            fns[name] = lambda x: rdb_mod.rdb_reference(x, w, b)
        elif name == "v4":
            fns[name] = lambda x: rdb_mod.rdb(x, w, b)
        else:
            blocks, b14, b5 = ladder_mod.pack_ladder_weights(w, b, name, dtype)
            packed = (tuple(t.to(device) for t in blocks), b14.to(device),
                      b5.to(device))
            fns[name] = (lambda x, fn=ladder_mod.WRAPPERS[name],
                         packed=packed: fn(x, packed))
    return fns


def kernel_info(name: str, shape, dtype, device: str) -> dict:
    """Tile and executed FLOP per output pixel (halo and padding included)
    of a kernel variant on the card; empty for ``plain`` or the CPU."""
    if device == "cpu" or name == "plain":
        return {}
    bsz, h, w = shape
    t = (rdb_mod.kernel_tiling(dtype) if name == "v4"
         else ladder_mod.kernel_tiling(name, dtype))
    tiles = bsz * math.ceil(h / t["tile"]) * math.ceil(w / t["tile"])
    executed = 2 * t.pop("macs_per_tile") * tiles / (bsz * h * w)
    return {**t, "executed_flop_per_pixel": executed,
            "executed_over_useful": executed / FLOP_PER_PIXEL}


def gate(fns32: dict, xs: torch.Tensor, w, b, emit) -> None:
    """Each kernel variant in float32 against ``rdb_reference`` (TF32
    off for the reference's convs), max abs error < 1e-4."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = rdb_mod.rdb_reference(xs, w, b)
        for name, fn in fns32.items():
            if name == "plain":
                continue
            err = (fn(xs) - want).abs().max().item()
            emit({"check": f"{name}_exact", "shape": list(xs.shape[:3]),
                  "max_err": err, "tolerance": GATE_TOL})
            if not err < GATE_TOL:
                raise AssertionError(f"{name} inexact on {xs.device}: {err}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def time_chain(fn, x, chain: int, runs: int, device: str):
    """(seconds of the first chain, ms per chain over ``runs`` chains fed
    back to back)."""
    def run(v):
        for _ in range(chain):
            v = fn(v)
        return v

    t0 = time.perf_counter()
    out = run(x)
    sync(device)
    first_s = time.perf_counter() - t0
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(runs):
            out = run(out)
        return first_s, (time.perf_counter() - t0) * 1e3 / runs
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        out = run(out)
    end.record()
    torch.cuda.synchronize()
    return first_s, start.elapsed_time(end) / runs


def ladder(variants=VARIANTS, shape=(16, 264, 264), chain: int = 12,
           runs: int = 3, device: str = "cuda", emit=None) -> list:
    """Gate and time ``variants``; returns (and emits) one dict per
    variant."""
    emit = emit or (lambda obj: print(json.dumps(obj), flush=True))
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("the ladder needs a CUDA device (or --device cpu)")
    card = card_name(device)
    kernels, biases = ladder_weights()
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.random((*GATE_SHAPE, 64)).astype(np.float32))
    w32, b32 = rdb_mod.pack_rdb_weights(kernels, biases, torch.float32)
    gate(variant_fns(variants, kernels, biases, torch.float32, device),
         xs.to(device), w32.to(device), b32.to(device), emit)
    x = torch.from_numpy(rng.random((*shape, 64)).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
    useful = math.prod(shape) * FLOP_PER_PIXEL * chain
    lines = []
    for name, fn in variant_fns(variants, kernels, biases, torch.bfloat16,
                                device).items():
        first_s, ms = time_chain(fn, x, chain, runs, device)
        line = {"variant": name, "device": device, "shape": list(shape),
                "chain": chain, "runs": runs, "ms_per_chain": ms,
                "ms_per_launch": ms / chain, "tf_s": useful / ms / 1e9,
                "compile_s": first_s, "card": card,
                **kernel_info(name, shape, torch.bfloat16, device)}
        emit(line)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ",".join(VARIANTS))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--chain", type=int, default=12)
    ap.add_argument("--shape", default="16,264,264", help="B,H,W")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    variants = [v for v in args.variants.split(",") if v]
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown or not variants:
        ap.error(f"unknown variants {unknown}: the port has "
                 f"{','.join(VARIANTS)}")
    shape = tuple(int(v) for v in args.shape.split(","))
    if len(shape) != 3:
        ap.error("--shape is B,H,W")
    ladder(variants, shape, args.chain, args.runs, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
