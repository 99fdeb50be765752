#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``s2sr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written kernels from ``s2sr_tpu_torch/csrc`` (one
``nvcc`` per source, all started together) and holds each against its
plain PyTorch version on the card. It drives two paths of the port with
random weights from seed 0, each at the full width of its model:

- the ``/api/wow`` path (``process_wow_sr`` and
  ``SREngine.enhance_serving_many``) on ``realesrgan_x4``, whose residual
  dense blocks run the ``rdb`` kernel, and at precision "int8" (the
  int8-mixed trunk) the ``rdb_i8`` kernel (phases kernel, main, numbers);
- the HTTP server (``s2sr_tpu_torch.server.app`` over a live socket): its
  job routes ``/api/pipeline`` (offline synthetic scene → tiles → WOW SR
  → SR tiles), ``/api/wow``, ``/api/enhance`` (two uploads coalesced) and
  ``/api/sr`` (the farm chain; scale 2 fails as in the JAX server), each
  polled to its end, then a download, a tile of each tree and the
  read-only routes, a ``"turbo"`` (int8) ``/api/wow`` job and a JPEG
  and a lossy WebP ``/api/enhance`` upload, on the same
  ``realesrgan_x4``; ``/api/decode`` (a QR, a plate with and without
  the SR retry, a non-image, an upload over the limit) and one decode
  with its retry under ``torch.profiler``; the committed upload fixtures
  (PNG, JPEG with its CMYK and arithmetic variants, BMP, GIF, WebP, TIFF
  by content with CCITT fax, ZSTD and CIELab) decoded against PIL's
  SHA-256 (phase server);
- scene acquisition (``s2sr_tpu_torch.fetch``, ``geo/cog.py``) against a
  local server standing in for Earth-Search, its COG bucket and UP42 (a
  Sentinel-2-sized visual COG and band crops made from ``--seed``):
  ``smart_fetch`` online (STAC search, range reads, the AOI clip on the
  card, equal to the CPU's), the RGB-band merge, the multiband stack
  (SCL nearest) card vs CPU, the UP42 order flow with a retry, then
  ``run_esrgan_and_tiles`` on the fetched scene (its RDBs in the ``rdb``
  kernel) and the device's tile warp rate (phase fetch); phase server
  adds ``/api/pipeline`` online at zooms 10–16, the PNG encoder in use
  (native or pure, and why) with one pyramid on each, and a host
  ``cProfile`` of a warm ``/api/wow`` job on each encoder;
- the QR/serial scan (``s2sr_tpu_torch.decode``), whose binarizer runs on
  the card: QR codes of versions 1 to 40 at every level, inverted,
  mirrored, rotated, warped, blurred, in Kanji, ECI and
  structured-append, and in a 1024×768 scene, each decoded on the card
  and held to the CPU; the committed plates' OCR held to the JAX
  package's recorded answers; the low-quality plate's SR retry on the
  full-width ``realesrgan_x4``, its RDBs in the ``rdb`` kernel (phase
  decode);
- field-boundary vectors (``s2sr_tpu_torch.vectors``): the card's
  ``fields.geojson`` held to the CPU's on a 1024² planted scene, then
  over a live socket ``/api/wow`` → ``/api/vectors`` (the job finds the
  4096² WOW output) and a 4096² planted raster under ``torch.profiler``
  (phase vectors);
- the classic SR path (``s2sr_tpu_torch.pipelines.super_resolution``):
  ``process_sentinel2_sr`` on a 512² GeoTIFF through the full-width
  ``edsr_x4``/``x3``/``x2`` and ``espcn_x4``, and the luma ``espcn_x4`` and
  ``lapsrn_x8`` converted from ``.pb`` graphs written here; the masked
  bucket bit-equal to the unpadded forward, the float32 models card vs
  CPU, the converters against ``execute_graphdef`` on the card, batched
  serving byte-equal to single, each conv layer's shape and batch
  invariance under cuDNN and PyTorch's own convolution, and ``sr_cli``
  (modes edsr and realesrgan, with tiles) in a child process (phase
  classic); ``cli.warmup`` in a child process on an empty build
  directory, then again on the same one, its ``rdb`` and ``swin_block``
  launches counted in the child (phase warmup);
- training (``s2sr_tpu_torch.training``, ``cli.train``): one float32
  step card vs CPU, then ``cli.train`` at full width (23 blocks, 64/32,
  ×4, batch 16, crop 48, bf16, the device pipeline, chunk 32, 64 steps)
  with remat and the blur/noise/JPEG degradations and without remat,
  SwinIR at ``swinir_x4``'s width, a resume against an unbroken run
  under deterministic algorithms, and the trained checkpoint exported
  (``convert_weights --from-ckpt``) and served by ``SREngine``, its RDBs
  in the ``rdb`` kernel (phase train);
- SwinIR serving on ``swinir_x4`` (``process_wow_sr`` on the exact path,
  the halo-tiled engine path, a 3×5 upload, exact 2048² and 2560² images
  with the strip tail held to the whole tail), whose Swin blocks run the
  ``swin_block`` kernel, or ``window_attention`` under
  ``S2SR_SWINIR_FUSED_LEVEL=attn`` (phases swin_kernel, swin_main,
  swin_large, swin_numbers).

It also drives the RDB ablation ladder (``s2sr_tpu_torch.bench.rdb_ladder``)
at the main path's chunk shape, whose rungs run the ``rdb_v1``, ``rdb_v2``
and ``rdb_v3`` kernels (bf16 ``v1`` and ``v3`` on the tensor cores in
``csrc/rdb_ladder_tc.cu``, the rest in ``csrc/rdb_ladder.cu``; phase
ladder), and the
matrix-unit microbenchmark (``s2sr_tpu_torch.bench.mxu`` and
``bench.peak``), whose chains and pairs run the ``matmul_chain`` and
``pair_chain`` kernels of ``csrc/matmul_chain.cu`` (phase mxu).

It checks the outputs, that every block of each path went through its
kernel, the main path's contracts on the card (a float32 engine with
PyTorch's default TF32 flags within 1e-4 of the CPU, ``enhance_serving``
byte-equal to ``enhance``, the masked bucket bit-equal to the unpadded
forward, the WOW chain byte-equal to the CPU's; the int8 engine's bucket
bit-equal too and its PSNR against bf16's above 35 dB; the server's
``/api/wow`` GeoTIFF byte-equal to a direct ``process_wow_sr``, the farm
chain byte-equal to the CPU's, a batch of tiles, bilinear and lanczos,
within the CPU tests' bounds of the CPU's), and times the kernels, the
SR stages, the upload decodes and the server's jobs. Nothing is caught: any
failure exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernels'
JSON record, and the one before that the card's name and power limit.
Without CUDA, or without the package beside it, it exits non-zero and
prints no result.

``--phases`` picks a subset (device, build, kernel, main, numbers,
fetch, server, vectors, decode, classic, warmup, train, swin_kernel,
swin_main, swin_large, swin_numbers, ladder, mxu) for a quick check; the
default runs them all.
``--seed`` seeds the fetched scene's pixels.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PHASES = ("device", "build", "kernel", "main", "numbers", "fetch", "server",
          "vectors", "decode", "classic", "warmup", "train", "swin_kernel",
          "swin_main", "swin_large", "swin_numbers", "ladder", "mxu")
KERNEL_SOURCES = ("rdb", "window_attention", "rdb_ladder", "rdb_ladder_tc",
                  "matmul_chain")

# H100 SXM dense peaks (NVIDIA data sheet) used for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# One RDB: 2·9·(64·192 + 32·160 + 32·128 + 32·96 + 32·64) FLOP per pixel
RDB_FLOP_PER_PIXEL = 2 * 9 * (64 * 192 + 32 * 160 + 32 * 128 + 32 * 96
                              + 32 * 64)
RDB_WEIGHT_FLOATS = 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32
                         + 192 * 64) + 192


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rdb_inputs(shape, dtype, masked_hw=None, seed=0):
    """Input, packed weights and mask for one RDB on the card. Weights
    are the model's init ×10, i.e. plain Kaiming without the 0.1 residual
    scaling, so x1..x4 move the output by O(0.1) and a kernel that drops
    one of them shows; biases are nonzero, and x spans both signs so both
    LeakyReLU branches run."""
    import torch

    from s2sr_tpu_torch.models.weights import init_state_dict
    from s2sr_tpu_torch.ops.rdb import pack_rdb_weights

    g = torch.Generator().manual_seed(seed)
    sd = init_state_dict(num_block=1, seed=seed)
    kernels = [sd[f"body.0.rdb1.conv{k}.weight"] * 10 for k in range(1, 6)]
    biases = [torch.randn(sd[f"body.0.rdb1.conv{k}.bias"].shape,
                          generator=g) * 0.05 for k in range(1, 6)]
    w, b = pack_rdb_weights(kernels, biases, dtype)
    x = torch.randn(*shape, 64, generator=g) * 0.5
    mask = None
    if masked_hw is not None:
        bsz, h, wd = shape
        mh, mw = masked_hw
        x[:, mh:] = 0
        x[:, :, mw:] = 0
        mask = torch.zeros(bsz, h, wd)
        mask[:, :mh, :mw] = 1
        mask = mask.cuda()
    return x.to(dtype).cuda(), w.cuda(), b.cuda(), mask


def rdb_bound_ms(shape, dtype, masked: bool) -> tuple:
    """Least time for one RDB on the H100: the larger of its FLOPs at the
    dtype's dense peak and its bytes (x and out once, weights, mask)."""
    import torch

    bsz, h, w = shape
    pixels = bsz * h * w
    item = 2 if dtype == torch.bfloat16 else 4
    flops = RDB_FLOP_PER_PIXEL * pixels
    nbytes = (2 * pixels * 64 * item + RDB_WEIGHT_FLOATS * 4
              + (pixels * 4 if masked else 0))
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def ieee_phase(phase):
    """A phase that holds kernels against plain versions in IEEE float32:
    TF32 off for cuDNN and cuBLAS while it runs, the process's flags as
    they were after it."""
    @functools.wraps(phase)
    def run(state):
        from s2sr_tpu_torch.utils.precision import ieee_fp32

        with ieee_fp32():
            return phase(state)
    return run


def phase_device(state):
    import torch

    state["card"] = card_line()
    emit({"phase": "device", "card": state["card"],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})


def phase_build(state):
    from concurrent.futures import ThreadPoolExecutor

    from s2sr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    # one nvcc per source, all at once
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = dict(zip(KERNEL_SOURCES, pool.map(_build.build,
                                                  KERNEL_SOURCES)))
    ptxas = {name: ptxas_summary(log) for name, (_, log) in built.items()}
    state["ptxas"] = ptxas
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_seconds": {n: b[0] for n, b in built.items()},
          "ptxas": ptxas})
    # the tensor-core kernels, one line each: registers and spills
    for name, pattern in (("rdb", "rdb_tc_kernel"), ("rdb", "rdb_i8_kernel"),
                          ("matmul_chain", "wg_chain_kernel"),
                          ("window_attention", "swin_tc_kernel"),
                          ("rdb_ladder_tc", "_tc_kernel")):
        emit({"phase": "build", "kernel": pattern, "ptxas": {
            k: v for k, v in ptxas[name].items() if pattern in k}})


def ptxas_summary(log: str) -> dict:
    """Per kernel entry of ptxas's ``-v`` report: registers, stack frame
    and spill bytes, e.g. ``{"_Z...": "168 reg, 0 stack, 0/0 spill"}``."""
    import re

    out, name, frame = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([\w$]+)'?", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = f"{m.group(1)} stack, {m.group(2)}/{m.group(3)} spill"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} reg, {frame}"
    return out


def drop_dense_input(w, b, i: int):
    """Packed weights of an RDB whose x_i (1..4) is stored as zero: every
    later conv's slice that reads x_i is zeroed. The plain version with
    these weights computes what a kernel that lost x_i would."""
    from s2sr_tpu_torch.ops.rdb import G, NF, unpack_rdb_weights

    w = w.clone()
    kernels, _ = unpack_rdb_weights(w, b)          # views into the clone
    for k in range(i + 1, 6):
        kernels[k - 1][:, NF + (i - 1) * G:NF + i * G] = 0
    return w


def hold_against_plain(phase, name, run, plain, cases, tiling):
    """Hold one fused-RDB kernel against its plain version on the card.

    For fp32 and bf16 and each ``(shape, masked_hw)`` of ``cases``, the
    inputs of :func:`rdb_inputs` go through ``run(x, w, b, mask)`` (the
    kernel) and ``plain(x, w, b, mask)`` (its plain version, from the same
    flat weights). The error is max |kernel − plain| over the largest
    change the block makes, max |out − x| of the fp32 ``rdb_reference``:
    x itself cancels, and a bf16 ulp of a large x cannot hide the block's
    own work. Each case also runs the plain version with each of x1..x4
    stored as zero: the kernel must sit further than the tolerance from
    all four, or the check could not see a dense connection gone wrong.
    Raises on any failure; returns the worst bf16 (abs, rel) error."""
    import torch

    from s2sr_tpu_torch.ops import rdb as rdb_mod

    tol = {torch.float32: 1e-4, torch.bfloat16: 0.05}
    worst_abs = worst_rel = 0.0
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape, masked_hw in cases:
            x, w, b, mask = rdb_inputs(shape, dtype, masked_hw)
            got = run(x, w, b, mask).float()
            torch.cuda.synchronize()
            change = (rdb_mod.rdb_reference(x.float(), w, b, mask)
                      - x.float()).abs().max().item()

            def err_vs(wt):
                return (got - plain(x, wt, b, mask).float()).abs().max().item()

            err = err_vs(w)
            faults = {f"x{i}_zero": err_vs(drop_dense_input(w, b, i)) / change
                      for i in (1, 2, 3, 4)}
            rel = err / change
            finite = bool(torch.isfinite(got).all().item())
            emit({"phase": phase, "kernel": name, "dtype": str(dtype),
                  "shape": list(shape), "masked": masked_hw is not None,
                  **tiling(dtype), "max_abs_err": err, "max_change": change,
                  "rel_err": rel, "tolerance": tol[dtype],
                  "rel_err_vs_planted_fault": faults, "finite": finite})
            case = f"{name} {dtype} {shape} masked={masked_hw}"
            if not finite or not rel <= tol[dtype]:
                failures.append(f"{case}: rel err {rel} over {tol[dtype]}")
            if not min(faults.values()) > tol[dtype]:
                failures.append(f"{case}: a planted fault is within "
                                f"tolerance {faults}")
            if dtype == torch.bfloat16:
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            del x, w, b, mask, got
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"{name} kernel vs plain:\n" + "\n".join(failures))
    return worst_abs, worst_rel


# the int8 RDB (precision "int8"): its shapes on the card, the main path's
# chunk shape and a masked bucket; its bound counts the x conv's 12,288 of
# the 26,624 multiply-adds a pixel at the int8 rate
RDB_I8_CASES = (((16, 264, 264), None), ((1, 40, 72), (33, 61)))
RDB_I8_REPLACES = "s2sr_tpu/models/rrdbnet_int8.py:155"
PEAK_I8_OPS = 1979e12
RDB_I8_X_MACS = 9 * 64 * 192


def rdb_i8_bound_ms(shape, masked: bool) -> tuple:
    """Least time for one int8-mixed RDB on the H100: its x conv's
    operations at the int8 peak plus the rest at the bf16 peak, against
    its bytes (x and out in bf16, the int8 x conv, the bf16 rest, 192
    factors and biases, the mask)."""
    bsz, h, w = shape
    pixels = bsz * h * w
    x_ops = 2 * RDB_I8_X_MACS * pixels
    rest = RDB_FLOP_PER_PIXEL * pixels - x_ops
    t_ops = (x_ops / PEAK_I8_OPS + rest / PEAK_BF16_FLOPS) * 1e3
    nbytes = (2 * pixels * 64 * 2 + RDB_I8_X_MACS
              + (RDB_WEIGHT_FLOATS - 192 - RDB_I8_X_MACS) * 2 + 2 * 192 * 4
              + (pixels * 4 if masked else 0))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def rdb_i8_params(x, w, b):
    """One RDB's int8 x conv from its packed float weights, quantized as
    ``rrdbnet_int8.quantize_body_mixed`` does, with the activation scale
    max|x| / 127 that calibration on x would give: (wx8, deq, qm)."""
    from s2sr_tpu_torch.models.rrdbnet_int8 import (_pack_rdb_kernels,
                                                    _quantize_kernel)
    from s2sr_tpu_torch.ops.rdb import unpack_rdb_weights

    kernels, biases = unpack_rdb_weights(w, b)
    p = {f"conv{k}": {"kernel": kernels[k - 1].permute(2, 3, 1, 0),
                      "bias": biases[k - 1]} for k in range(1, 6)}
    w8, sw = _quantize_kernel(_pack_rdb_kernels(p)[0])
    s_act = x.float().abs().amax().clamp(min=1e-12) / 127.0
    return w8, (sw * s_act).float(), float(1.0 / s_act)


def hold_i8_against_plain(state) -> None:
    """``rdb_i8`` (the int8 instance of the bf16 kernel) against
    ``rdb_i8_reference`` on the card at :data:`RDB_I8_CASES`, within 0.05
    of max |out − x| of the fp32 plain version (the bf16 ``rdb``'s bound),
    with three planted faults further than that: stage 1's dequantization
    factors zeroed, stage 5's zeroed, and qm doubled (x saturates). Then
    its ms per launch at the chunk shape beside its bound, its plain
    version's and the bf16 ``rdb``'s ms in the same run."""
    import torch

    from s2sr_tpu_torch.ops import rdb as rdb_mod

    tol = 0.05
    launches0 = rdb_mod.LAUNCHES_I8, rdb_mod.LAUNCHES
    failures, worst = [], (0.0, 0.0)
    for shape, masked_hw in RDB_I8_CASES:
        x, w, b, mask = rdb_inputs(shape, torch.bfloat16, masked_hw)
        wx8, deq, qm = rdb_i8_params(x, w, b)
        got = rdb_mod.rdb_i8(x, w, b, wx8, deq, qm, mask).float()
        torch.cuda.synchronize()
        change = (rdb_mod.rdb_i8_reference(x.float(), w, b, wx8, deq, qm, mask)
                  - x.float()).abs().max().item()

        def err_vs(deq_=deq, qm_=qm):
            ref = rdb_mod.rdb_i8_reference(x, w, b, wx8, deq_, qm_, mask)
            return (got - ref.float()).abs().max().item()

        def zeroed(lo, hi):
            d = deq.clone()
            d[lo:hi] = 0
            return d

        err = err_vs()
        faults = {"stage1_deq_zero": err_vs(deq_=zeroed(160, 192)) / change,
                  "stage5_deq_zero": err_vs(deq_=zeroed(0, 64)) / change,
                  "qm_doubled": err_vs(qm_=2 * qm) / change}
        rel = err / change
        finite = bool(torch.isfinite(got).all().item())
        emit({"phase": "kernel", "kernel": "rdb_i8", "dtype": "bfloat16+int8",
              "shape": list(shape), "masked": masked_hw is not None,
              **rdb_mod.kernel_tiling_i8(), "qm": qm, "max_abs_err": err,
              "max_change": change, "rel_err": rel, "tolerance": tol,
              "rel_err_vs_planted_fault": faults, "finite": finite})
        case = f"rdb_i8 {shape} masked={masked_hw}"
        if not finite or not rel <= tol:
            failures.append(f"{case}: rel err {rel} over {tol}")
        if not min(faults.values()) > tol:
            failures.append(f"{case}: a planted fault is within {tol}: {faults}")
        worst = max(worst, (err, rel), key=lambda e: e[1])
        if masked_hw is None:
            ms = time_cuda(lambda: rdb_mod.rdb_i8(x, w, b, wx8, deq, qm),
                           iters=10)
            plain_ms = time_cuda(lambda: rdb_mod.rdb_i8_reference(
                x, w, b, wx8, deq, qm), iters=10)
            bf16_ms = time_cuda(lambda: rdb_mod.rdb(x, w, b), iters=10)
            bound_ms, bound_by = rdb_i8_bound_ms(shape, masked=False)
            state["rdb_i8_numbers"] = {"ms": ms, "plain_ms": plain_ms,
                                       "bound_ms": bound_ms,
                                       "bound_by": bound_by}
            emit({"phase": "kernel", "card": state.get("card"),
                  "kernel": "rdb_i8", "shape": list(shape), "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "rdb_bf16_ms_same_run": bf16_ms,
                  "i8_over_bf16": ms / bf16_ms})
        del x, w, b, mask, got, wx8, deq
        torch.cuda.empty_cache()
    rdb_mod.LAUNCHES_I8, rdb_mod.LAUNCHES = launches0
    if failures:
        raise AssertionError("rdb_i8 kernel vs plain:\n" + "\n".join(failures))
    state["rdb_i8_max_abs_err"], state["rdb_i8_rel_err"] = worst


@ieee_phase
def phase_kernel(state):
    import torch

    from s2sr_tpu_torch.ops import _build
    from s2sr_tpu_torch.ops import rdb as rdb_mod

    # fp32: the kernel and the plain version sum the 1,728 products of
    # each output in different orders (cuDNN may pick Winograd/FFT), ~1e-6
    # of the change. bf16: the plain version rounds to bf16 after every
    # conv and add, the kernel only where it stores.
    cases = [((2, 70, 50), None), ((2, 70, 50), (61, 37)),
             ((16, 264, 264), None), ((1, 576, 448), (576, 432))]
    t0 = time.perf_counter()
    sass = sass_counts(_build.lib_path("rdb"))
    emit({"phase": "kernel", "sass": sass})
    tc = [c for k, c in sass.items() if "rdb_tc_kernel" in k]
    if len(tc) != 1 or tc[0]["HMMA"] == 0:
        raise AssertionError(f"rdb's bf16 kernel issues no HMMA: {sass}")
    i8 = [c for k, c in sass.items() if "rdb_i8_kernel" in k]
    if len(i8) != 1 or i8[0]["IMMA"] == 0 or i8[0]["HMMA"] == 0:
        raise AssertionError(f"rdb's int8 kernel issues no IMMA or HMMA: {sass}")
    launches0 = rdb_mod.LAUNCHES
    state["rdb_max_abs_err"], state["rdb_rel_err"] = hold_against_plain(
        "kernel", "rdb", rdb_mod.rdb, rdb_mod.rdb_reference, cases,
        rdb_mod.kernel_tiling)
    # comparison launches are not main-path launches
    rdb_mod.LAUNCHES = launches0
    hold_i8_against_plain(state)
    emit({"phase": "kernel", "seconds": round(time.perf_counter() - t0, 3)})


def phase_main(state):
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields, synthetic_scene
    from s2sr_tpu_torch.geo import read_geotiff
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.pipelines.wow_sr import process_wow_sr
    from s2sr_tpu_torch.tiles.png import decode_png

    t0 = time.perf_counter()
    work = state["work"]
    weights = work / "weights"                   # empty: random init
    scenes = {"tiled_1024": (1024, 1024), "bucket_576x432": (576, 432)}
    eng = engine_mod.get_engine("realesrgan_x4", weights_dir=str(weights),
                                device="cuda")
    if eng.dtype != torch.bfloat16 or len(eng.model.body) != 23:
        raise AssertionError("main path must be full-width bf16 realesrgan_x4")
    n_rdb = 3 * len(eng.model.body)
    meta_keys = None
    for name, (h, w) in scenes.items():
        tif = work / f"{name}.tif"
        synthetic_scene(tif, size=(h, w), seed=3)
        chunks0 = eng.chunks_dispatched
        rdb_mod.LAUNCHES = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        result = process_wow_sr(tif, work / f"out_{name}",
                                weights_dir=str(weights), device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches = rdb_mod.LAUNCHES
        chunks = eng.chunks_dispatched - chunks0
        meta = result["sr_metadata"]
        png = decode_png(Path(result["outputs"]["sr_png"]).read_bytes())
        if png.shape != (4 * h, 4 * w, 3) or png.dtype != np.uint8:
            raise AssertionError(f"{name}: PNG twin {png.shape} {png.dtype}")
        if meta["output_size"] != [4 * h, 4 * w] or meta["precision"] != "bfloat16":
            raise AssertionError(f"{name}: metadata {meta}")
        if result["outputs"]["sr_tif"] is None:
            raise AssertionError(f"{name}: no GeoTIFF written")
        if not np.array_equal(read_geotiff(result["outputs"]["sr_tif"]).data,
                              png):
            raise AssertionError(f"{name}: PNG twin differs from the GeoTIFF")
        if launches != n_rdb * chunks or chunks == 0:
            raise AssertionError(
                f"{name}: {launches} RDB launches for {chunks} chunks "
                f"(want {n_rdb} x chunks)")
        keys = sorted(meta)
        if meta_keys is not None and keys != meta_keys:
            raise AssertionError(f"{name}: metadata keys differ: {keys}")
        meta_keys = keys
        stages = {s["name"]: s["seconds"] for s in meta["timing"]["stages"]}
        emit({"phase": "main", "scene": name, "chunks": chunks,
              "rdb_launches": launches, "seconds": round(secs, 3),
              "sr_stage_seconds": stages["Real-ESRGAN x4 (GAN upscaling)"],
              "enhance_stage_seconds": stages["Crop visibility enhancement"],
              "png_mean": float(png.mean())})
        state.setdefault("main_launches", 0)
        state["main_launches"] += launches
    # batch-coalesced serving of two uploads
    ups = [synthetic_fields((200, 152), seed=5),
           synthetic_fields((96, 128), seed=6)]
    chunks0 = eng.chunks_dispatched
    rdb_mod.LAUNCHES = 0
    outs = eng.enhance_serving_many(ups)
    torch.cuda.synchronize()
    launches = rdb_mod.LAUNCHES
    chunks = eng.chunks_dispatched - chunks0
    for up, out in zip(ups, outs):
        if out.shape != (4 * up.shape[0], 4 * up.shape[1], 3) or out.dtype != np.uint8:
            raise AssertionError(f"serving_many: bad output {out.shape}")
    singles = [eng.enhance_serving(up) for up in ups]
    same = all(np.array_equal(a, b) for a, b in zip(outs, singles))
    if launches != n_rdb * chunks or not same:
        raise AssertionError(f"serving_many: launches {launches}, chunks "
                             f"{chunks}, equal to single serving: {same}")
    emit({"phase": "main", "scene": "serving_many_2_uploads",
          "chunks": chunks, "rdb_launches": launches,
          "equal_to_single": same})
    state["main_launches"] += launches
    state["engine"] = eng
    eng32 = check_against_plain(eng, work)
    check_byte_contracts(eng, eng32)
    check_wow_chain()
    check_int8_engine(state, eng)
    emit({"phase": "main", "seconds": round(time.perf_counter() - t0, 3)})


# the int8 engine's calibration held to the CPU's over its first blocks
INT8_CALIB_BLOCKS = 2


# the int8 trunk held card vs CPU: conv weights ×10 (plain Kaiming, as
# tests/test_torch_int8.py::unscaled_tree), so that the trunk moves the
# output; the image it runs on; the bound on max |card − CPU| over the
# CPU output's largest magnitude
INT8_TRUNK_WEIGHT_SCALE = 10.0
INT8_TRUNK_IMAGE = (48, 40)
INT8_TRUNK_TOL = 0.1


def check_int8_trunk(state) -> None:
    """A full-width int8 engine on converted weights (seed-0 init, conv
    weights ×10: with the init's own 0.1 scale the trunk barely moves the
    output, and a wrong trunk would not show) against the same quantized
    model moved to the CPU, where every RDB runs ``rdb_i8_reference`` on
    the card's ``wx8``, ``deq`` and ``qm``: the model's float output
    within :data:`INT8_TRUNK_TOL` of the CPU output's largest magnitude.
    Three planted faults in the per-block settings lie further than that:
    each block given the next block's, rdb1's and rdb3's swapped, and
    rdb2's ``deq`` zeroed."""
    import copy

    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.models.engine import SREngine
    from s2sr_tpu_torch.models.weights import init_state_dict

    wdir = state["work"] / "weights_int8_trunk"
    wdir.mkdir(exist_ok=True)
    sd = {k: v * INT8_TRUNK_WEIGHT_SCALE if k.endswith(".weight") else v
          for k, v in init_state_dict(seed=0).items()}
    torch.save(sd, wdir / "realesrgan_x4.pth")
    eng = SREngine("realesrgan_x4", weights_dir=str(wdir), dtype="int8",
                   device="cuda")
    if not eng.quantized or len(eng.model.body) != 23:
        raise AssertionError("the int8 trunk check wants a full-width "
                             "quantized realesrgan_x4")
    x = torch.from_numpy(synthetic_fields(INT8_TRUNK_IMAGE, seed=14))
    x = x.float()[None] / 255.0
    card = eng.model(x.cuda()).float().cpu()
    cpu = copy.deepcopy(eng.model).cpu()
    want = cpu(x).float()
    scale = want.abs().max().item()
    rel = (card - want).abs().max().item() / scale
    qb = {f"rdb{j}": {k: torch.stack([torch.as_tensor(getattr(
        getattr(b, f"rdb{j}"), k)) for b in cpu.body])
        for k in ("wx8", "deq", "qm")} for j in (1, 2, 3)}
    zeroed = copy.deepcopy(qb)
    zeroed["rdb2"]["deq"].zero_()
    planted = {
        "next_blocks_settings": {r: {k: v.roll(-1, 0) for k, v in d.items()}
                                 for r, d in qb.items()},
        "rdb1_rdb3_swapped": {"rdb1": qb["rdb3"], "rdb2": qb["rdb2"],
                              "rdb3": qb["rdb1"]},
        "rdb2_deq_zeroed": zeroed}
    faults = {}
    for name, bad in planted.items():
        m = copy.deepcopy(cpu).quantize(bad)
        faults[name] = (card - m(x).float()).abs().max().item() / scale
    emit({"phase": "main", "check": "int8 trunk, card vs CPU",
          "weights": f"seed-0 init, conv weights x{INT8_TRUNK_WEIGHT_SCALE}",
          "image": list(INT8_TRUNK_IMAGE), "output_max_abs": scale,
          "rel_err": rel, "tolerance": INT8_TRUNK_TOL,
          "rel_err_vs_planted_fault": faults})
    if not rel <= INT8_TRUNK_TOL:
        raise AssertionError(f"int8 trunk: card vs CPU {rel} over "
                             f"{INT8_TRUNK_TOL}")
    if not min(faults.values()) > INT8_TRUNK_TOL:
        raise AssertionError(f"int8 trunk: a planted fault is within "
                             f"{INT8_TRUNK_TOL}: {faults}")
    state["int8_trunk_rel_err"] = rel
    del eng, cpu
    torch.cuda.empty_cache()


def check_int8_engine(state, eng) -> None:
    """The int8-mixed trunk (precision "int8", the ``/api/wow`` field
    "turbo") on the card: full-width ``realesrgan_x4`` from seed-0 random
    init, every RDB in ``rdb_i8``.

    - its calibration (one fp32 forward, TF32 off) against the CPU's on
      the same input over the first blocks: the largest relative
      difference of the activation scales;
    - ``process_wow_sr`` on the 1024² scene at precision "int8": rdb_i8
      launches = 69 × chunks and no bf16 rdb launch, metadata "int8";
    - the 576×432 image's 576×448 bucket against the unpadded int8
      forward: 0 differing values (model output, before uint8);
    - :func:`check_int8_trunk`: the quantized trunk card vs CPU, on
      weights that let it move the output;
    - PSNR of its uint8 1024² output against the bf16 engine's, above
      JAX's 35 dB bar (vacuous on random init, whose trunk barely moves
      the output; reported as measured);
    - warm 1024² SR seconds and MPix/s, int8 and bf16 in turns."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields, synthetic_scene
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.models.rrdbnet import RRDBNet
    from s2sr_tpu_torch.models.rrdbnet_int8 import calibrate_act_scales
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.parallel.tiling import bucket_pad
    from s2sr_tpu_torch.pipelines.wow_sr import process_wow_sr

    work = state["work"]
    weights = str(work / "weights")
    eng8 = engine_mod.get_engine("realesrgan_x4", weights_dir=weights,
                                 dtype="int8", device="cuda")
    if not (eng8.quantized and eng8.model.quantized
            and len(eng8.model.body) == 23 and eng8.dtype == torch.bfloat16):
        raise AssertionError("the int8 engine must be full-width "
                             "realesrgan_x4 with its trunk quantized")
    n_rdb = 3 * len(eng8.model.body)

    # calibration on the card vs the CPU, the first blocks of the same net
    calib = torch.from_numpy(synthetic_fields(size=(256, 256), seed=42))
    calib = calib.float()[None].flip(-1) / 255.0
    nb = min(INT8_CALIB_BLOCKS, len(eng8.model.body))
    cut = RRDBNet(num_block=nb, dtype=torch.bfloat16)
    sd = {k: v for k, v in eng8.model.state_dict().items()
          if not k.startswith("body.") or int(k.split(".")[1]) < nb}
    cut.load_state_dict(sd)
    cpu_s = calibrate_act_scales(cut, calib)
    card_s = calibrate_act_scales(cut.cuda(), calib.cuda()).cpu()
    qm_card = np.array([[getattr(b, f"rdb{j}").qm for j in (1, 2, 3)]
                        for b in eng8.model.body[:nb]])
    calib_rel = float(((card_s - cpu_s).abs() / cpu_s).max())
    engine_rel = float(np.abs(1.0 / (qm_card * card_s[:, :, 0].numpy()) - 1).max())
    emit({"phase": "main", "check": "int8 calibration, card vs CPU",
          "blocks": nb, "scales_max_rel_diff": calib_rel,
          "engine_qm_vs_card_scale_max_rel_diff": engine_rel,
          "tolerance": 1e-5})
    if not calib_rel <= 1e-5:
        raise AssertionError(f"int8 calibration: card vs CPU {calib_rel}")
    del cut

    # the /api/wow path at precision "int8"
    tif = work / "tiled_1024.tif"
    if not tif.exists():
        synthetic_scene(tif, size=(1024, 1024), seed=3)
    chunks0 = eng8.chunks_dispatched
    rdb_mod.LAUNCHES = rdb_mod.LAUNCHES_I8 = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    result = process_wow_sr(tif, work / "out_int8", weights_dir=weights,
                            precision="int8", device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    launches, bf16_launches = rdb_mod.LAUNCHES_I8, rdb_mod.LAUNCHES
    chunks = eng8.chunks_dispatched - chunks0
    meta = result["sr_metadata"]
    stages = {st["name"]: st["seconds"] for st in meta["timing"]["stages"]}
    emit({"phase": "main", "scene": "tiled_1024", "precision": "int8",
          "chunks": chunks, "rdb_i8_launches": launches,
          "rdb_launches": bf16_launches, "seconds": round(secs, 3),
          "sr_stage_seconds": stages["Real-ESRGAN x4 (GAN upscaling)"],
          "metadata_precision": meta["precision"]})
    if (launches != n_rdb * chunks or chunks == 0 or bf16_launches
            or meta["precision"] != "int8"):
        raise AssertionError(f"int8 /api/wow path: {launches} rdb_i8 and "
                             f"{bf16_launches} rdb launches for {chunks} "
                             f"chunks, precision {meta['precision']}")
    state["main_launches_i8"] = state.get("main_launches_i8", 0) + launches

    launches0 = rdb_mod.LAUNCHES, rdb_mod.LAUNCHES_I8
    # the bucket contract
    h, w = CONTRACT_BUCKET
    up = synthetic_fields((h, w), seed=14)
    padded, mask = bucket_pad(up)
    x = eng8._to_float(torch.from_numpy(up).cuda())[None]
    xp = eng8._to_float(torch.from_numpy(padded).cuda())[None]
    mk = torch.from_numpy(mask).cuda()[None]
    exact = eng8._fwd(x)
    bucket = eng8._fwd(xp * mk, mk)[:, :4 * h, :4 * w]
    torch.cuda.synchronize()
    b_diff = int((exact != bucket).sum().item())
    emit({"phase": "main", "check": "byte contracts", "dtype": "int8",
          "bucket": list(padded.shape[:2]), "image": [h, w],
          "bucket_vs_unpadded_values_differing": b_diff,
          "bucket_max_abs_diff": (exact - bucket).abs().max().item()})
    if b_diff:
        raise AssertionError(f"int8 bucket differs from the unpadded "
                             f"forward on {b_diff} values")
    del exact, bucket, x, xp
    check_int8_trunk(state)

    # quality against bf16, and the warm rate in turns
    img = synthetic_fields((1024, 1024), seed=3)
    out8, out16 = eng8.enhance_serving(img), eng.enhance_serving(img)
    mse = np.mean((out8.astype(np.float64) - out16) ** 2) / 255.0 ** 2
    psnr = 99.0 if mse == 0 else float(10 * np.log10(1.0 / mse))
    reps = {"bfloat16": [], "int8": []}
    for e, name in ((eng, "bfloat16"), (eng8, "int8"), (eng8, "int8"),
                    (eng, "bfloat16")):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        e.enhance_serving(img)
        torch.cuda.synchronize()
        reps[name].append(time.perf_counter() - t1)
    rdb_mod.LAUNCHES, rdb_mod.LAUNCHES_I8 = launches0
    rate = {k: 1024 * 1024 / min(v) / 1e6 for k, v in reps.items()}
    emit({"phase": "main", "check": "int8 vs bf16, 1024² scene",
          "card": state.get("card"), "psnr_db": psnr, "tolerance_db": 35.0,
          "pixels_differing": int(np.any(out8 != out16, axis=-1).sum()),
          "sr_1024_seconds": reps, "sr_1024_mpix_per_s": rate,
          "int8_over_bf16_rate": rate["int8"] / rate["bfloat16"]})
    if not psnr > 35.0:
        raise AssertionError(f"int8 vs bf16 PSNR {psnr} dB")
    state["int8_numbers"] = {"psnr_db": psnr, "mpix_per_s": rate}


def wow_op_checks() -> dict:
    """Each op of the WOW chain alone on the card against the CPU: the
    colour conversions over the whole 256³ cube, CLAHE on an even-tile
    and an odd-tile channel, the blur and the weighted add. Returns
    op → count of differing pixels."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.ops import blur, clahe, color

    grid = np.meshgrid(*(np.arange(256),) * 3, indexing="ij")
    cube = torch.from_numpy(np.stack(grid, -1).reshape(-1, 3).astype(np.uint8))
    img = torch.from_numpy(synthetic_fields((512, 384), seed=11))
    rng = np.random.default_rng(12)
    odd = torch.from_numpy(rng.integers(0, 256, (67, 93)).astype(np.uint8))
    ops = {
        **{name: (getattr(color, name), cube) for name in (
            "rgb_to_hsv_u8", "hsv_to_rgb_u8", "rgb_to_lab_u8",
            "lab_to_rgb_u8")},
        "clahe_u8_512x384": (clahe.clahe_u8, img[..., 1].contiguous()),
        "clahe_u8_67x93": (clahe.clahe_u8, odd),
        "gaussian_blur_u8": (lambda a: blur.gaussian_blur_u8(a, 1.2), img),
        "add_weighted_u8": (lambda a: blur.add_weighted_u8(
            a, 1.4, a.flip(0), -0.4), img),
    }
    counts = {}
    for name, (fn, x) in ops.items():
        cpu = fn(x)
        gpu = fn(x.cuda()).cpu()
        diff = cpu != gpu
        counts[name] = int((diff.any(-1) if x.shape[-1] == 3 else diff).sum())
    return counts


def check_wow_chain() -> None:
    """The WOW chain on the card against the same chain on the CPU, byte
    for byte: first each op alone, then the chain on a 512×384 image.
    Every float op rounds once, as IEEE has it, on both devices
    (``ops/color.py`` says how), so no pixel may differ."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.ops.enhance import enhance_for_crops

    ops = wow_op_checks()
    emit({"phase": "main", "check": "WOW ops on the card vs the CPU",
          "pixels_differing": ops})
    img = torch.from_numpy(synthetic_fields((512, 384), seed=11))
    cpu = enhance_for_crops(img).numpy()
    gpu = enhance_for_crops(img.cuda()).cpu().numpy()
    diff = np.abs(cpu.astype(np.int16) - gpu.astype(np.int16))
    touched = int(np.any(diff > 0, axis=-1).sum())
    emit({"phase": "main", "check": "WOW chain on the card vs the CPU",
          "image": [512, 384], "max_abs_diff": int(diff.max()),
          "pixels_differing": touched, "tol_pixels_differing": 0})
    if gpu.shape != cpu.shape or touched or any(ops.values()):
        raise AssertionError(f"WOW chain on the card differs from the CPU: "
                             f"{touched} pixels; ops {ops}")


def check_against_plain(eng, work: Path):
    """The main path's model on a small masked bucket, against the same
    weights in fp32 on the CPU (where every RDB runs its plain version),
    relative to the reference's largest output: a float32 engine with
    the process's TF32 flags as PyTorch sets them (the model turns TF32
    off itself, tolerance 1e-4), the same forward with TF32 forced on
    (printed, to show the check tells the two apart), and the bf16
    serving path.

    The random init scales every conv by 0.1, so its x4 output is ~1e-4
    and would hide an error. Here the RDB convs are scaled ×5 and the
    others ×4: the output spans about 0..0.7 and the 69 RDBs move it by
    up to ~0.15 (their last convs zeroed, on the CPU). Returns the float32
    engine."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.models import rrdbnet as rrdb_mod
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.parallel.tiling import bucket_pad

    defaults = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    if defaults != (True, False):
        raise AssertionError(f"TF32 flags are not PyTorch's defaults: "
                             f"{defaults}")
    launches0 = rdb_mod.LAUNCHES
    img, mask = bucket_pad(synthetic_fields((40, 52), seed=9))
    x = torch.from_numpy(img).float()[None] / 255.0
    m = torch.from_numpy(mask)[None]
    sd = {k: v.detach().cpu() * (1 if not k.endswith("weight")
                                 else 5 if k.startswith("body.") else 4)
          for k, v in eng.model.state_dict().items()}

    def net(dtype, device):
        model = rrdb_mod.RRDBNet(num_block=len(eng.model.body), dtype=dtype)
        model.load_state_dict(sd)
        return model.to(device).pack()

    ref = net(torch.float32, "cpu")(x, mask=m)
    eng32 = engine_mod.SREngine("realesrgan_x4", weights_dir=str(
        work / "weights"), dtype="float32", device="cuda")
    eng32.model.load_state_dict(sd)
    eng32.model.pack()
    out32 = eng32._fwd(x.cuda(), m.cuda()).cpu()
    # TF32 forced: the model's own scope bypassed, cuDNN's flag on
    with mock.patch.object(rrdb_mod, "ieee_fp32",
                           lambda enabled=True: contextlib.nullcontext()):
        torch.backends.cudnn.allow_tf32 = True
        out_tf32 = eng32._fwd(x.cuda(), m.cuda()).cpu()
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = defaults
    outbf = net(torch.bfloat16, "cuda")(x.cuda(), mask=m.cuda()).cpu()
    rdb_mod.LAUNCHES = launches0
    scale = ref.abs().max().item()
    rel32 = (out32 - ref).abs().max().item() / scale
    rel_tf32 = (out_tf32 - ref).abs().max().item() / scale
    relbf = (outbf - ref).abs().max().item() / scale
    # fp32: ~350 convs each summing in another order (~1e-7 each);
    # bf16: 8-bit mantissas through 69 blocks (0.031 for the plain
    # version in bf16 on the CPU)
    tol32, tolbf = 1e-4, 0.1
    u8 = [np.trunc(np.clip(t[0, :160, :208].numpy() * 255, 0, 255))
          for t in (ref, out32)]
    emit({"phase": "main", "check": "full model vs fp32 plain on CPU",
          "image": [40, 52], "bucket": list(img.shape[:2]),
          "ref_max_abs": scale, "ref_u8_mean": float(u8[0].mean()),
          "tf32_flags_at_start": list(defaults),
          "rel_err_fp32_engine_defaults": rel32, "tol_fp32": tol32,
          "rel_err_fp32_tf32_forced": rel_tf32,
          "rel_err_bf16": relbf, "tol_bf16": tolbf,
          "u8_bytes_differing_fp32": int((u8[0] != u8[1]).sum())})
    if not (rel32 <= tol32 and relbf <= tolbf and np.isfinite(scale)):
        raise AssertionError(f"full model disagrees with the plain path: "
                             f"fp32 {rel32}, bf16 {relbf}")
    if not rel_tf32 > rel32:
        raise AssertionError(f"the check cannot tell TF32 ({rel_tf32}) from "
                             f"IEEE float32 ({rel32})")
    return eng32


# the byte contracts' tiled scenes (bf16 engine, fp32 engine) and the
# image whose bucket is held to its unpadded forward
CONTRACT_SCENES = (("bf16", (1024, 1024)), ("fp32", (600, 520)))
CONTRACT_BUCKET = (576, 432)


def check_byte_contracts(eng, eng32) -> None:
    """The main path's two exactness contracts on the card, in bf16 and
    in fp32: ``enhance_serving`` (fixed windows in power-of-two chunks)
    equals ``enhance`` (``tiled_apply``) byte for byte on a tiled scene,
    and the 576×432 image zero-padded to its 576×448 bucket with a mask
    gives the unpadded forward bit for bit, on the model output before
    uint8."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.parallel.tiling import bucket_pad

    launches0 = rdb_mod.LAUNCHES
    failures = []
    for (label, side), e in zip(CONTRACT_SCENES, (eng, eng32)):
        img = synthetic_fields(side, seed=13)
        serving = e.enhance_serving(img)
        whole = e.enhance(img)
        n_diff = int(np.any(serving != whole, axis=-1).sum())
        h, w = CONTRACT_BUCKET
        up = synthetic_fields((h, w), seed=14)
        padded, mask = bucket_pad(up)
        x = e._to_float(torch.from_numpy(up).cuda())[None]
        xp = e._to_float(torch.from_numpy(padded).cuda())[None]
        mk = torch.from_numpy(mask).cuda()[None]
        exact = e._fwd(x)
        bucket = e._fwd(xp * mk, mk)[:, :4 * h, :4 * w]
        torch.cuda.synchronize()
        b_diff = int((exact != bucket).sum().item())
        emit({"phase": "main", "check": "byte contracts", "dtype": label,
              "serving_scene": list(side),
              "serving_vs_enhance_pixels_differing": n_diff,
              "bucket": list(padded.shape[:2]), "image": [h, w],
              "bucket_vs_unpadded_values_differing": b_diff,
              "bucket_max_abs_diff": (exact - bucket).abs().max().item()})
        if n_diff or b_diff or serving.shape != whole.shape:
            failures.append(f"{label}: serving differs on {n_diff} pixels, "
                            f"bucket on {b_diff} values")
    rdb_mod.LAUNCHES = launches0
    if failures:
        raise AssertionError("byte contracts broken on the card: "
                             + "; ".join(failures))


def device_breakdown(fn, top: int = 8) -> dict:
    """Device time by kernel over one call of ``fn`` under
    ``torch.profiler``: the host's wall time around it (ending in a
    synchronize), the summed device time and its share of the wall, and
    the ``top`` kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): an operator's self
    # device time repeats the time of the kernels it launched, which are
    # listed as events of their own
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "launches": sum(r[1] for r in rows),
            "top": [{"kernel": k[:120], "ms": ms, "calls": n,
                     "share_of_device": ms / device_ms if device_ms else None}
                    for ms, n, k in rows[:top]]}


def phase_numbers(state):
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.ops import rdb as rdb_mod

    t0 = time.perf_counter()
    card = state.get("card") or card_line()
    launches0 = rdb_mod.LAUNCHES
    # one RDB at the main path's chunk shape, bf16
    shape, dtype = (16, 264, 264), torch.bfloat16
    x, w, b, _ = rdb_inputs(shape, dtype)
    ms = time_cuda(lambda: rdb_mod.rdb(x, w, b), iters=10)
    plain_ms = time_cuda(lambda: rdb_mod.rdb_reference(x, w, b), iters=10)
    bound_ms, bound_by = rdb_bound_ms(shape, dtype, masked=False)
    rdb_mod.LAUNCHES = launches0
    del x, w, b
    torch.cuda.empty_cache()
    emit({"phase": "numbers", "card": card, "kernel": "rdb",
          "shape": list(shape), "dtype": "bfloat16", "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "tflops": RDB_FLOP_PER_PIXEL * np.prod(shape) / ms / 1e9})
    # the 1024² SR stage (engine only, warm)
    eng = state.get("engine") or engine_mod.get_engine(
        "realesrgan_x4", weights_dir=str(state["work"] / "weights"),
        device="cuda")
    img = synthetic_fields((1024, 1024), seed=3)
    eng.enhance_serving(img)
    torch.cuda.synchronize()
    reps = []
    for _ in range(2):
        t1 = time.perf_counter()
        eng.enhance_serving(img)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t1)
    sr_s = min(reps)
    emit({"phase": "numbers", "card": card, "sr_1024_seconds": reps,
          "sr_1024_mpix_per_s": 1024 * 1024 / sr_s / 1e6})
    emit({"phase": "numbers", "card": card,
          "profile": "one warm 1024² enhance_serving",
          **device_breakdown(lambda: eng.enhance_serving(img))})
    rdb_mod.LAUNCHES = launches0
    emit({"phase": "numbers", "seconds": round(time.perf_counter() - t0, 3)})
    state["rdb_numbers"] = {"ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by}


# --- scene acquisition: fetch/, geo/cog.py, the ESRGAN tiles --------------

S2_SIDE = 10980               # one Sentinel-2 tile at 10 m
S2_SMALL_SIDE = 5490          # if writing the whole tile would take > 30 s
BAND_SIDE = 2745              # the bands' crop around the AOI
S2_RES = 10.0
SCL_CODES = (4, 5, 6, 8, 9, 3)   # vegetation, bare, water, clouds, shadow


class AssetServer:
    """A ``ThreadingHTTPServer`` on 127.0.0.1 that stands in for
    Earth-Search, its COG bucket and UP42: files of a directory answered
    with ``Range`` (206) and JSON routes; requests and bytes per path."""

    def __init__(self, root: Path):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        owner = self
        self.root, self.routes, self.stats = root, {}, {}
        self.lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                owner.answer(self, "GET")

            def do_POST(self):
                owner.answer(self, "POST")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def answer(self, h, method: str) -> None:
        import urllib.parse

        path = urllib.parse.urlsplit(h.path).path
        n = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(n) if n else b""
        file = self.root / path.lstrip("/")
        headers: dict = {}
        if path in self.routes:
            status, out = self.routes[path](method, body)
            headers["Content-Type"] = "application/json"
        elif method == "GET" and file.is_file():
            size = file.stat().st_size
            start, end = 0, size - 1
            status = 200
            if h.headers.get("Range"):
                a, b = h.headers["Range"].split("=")[1].split("-")
                start, end, status = int(a), min(int(b), size - 1), 206
                headers["Content-Range"] = f"bytes {start}-{end}/{size}"
            with open(file, "rb") as f:
                f.seek(start)
                out = f.read(end - start + 1)
        else:
            status, out = 404, b'{"detail": "Not Found"}'
        with self.lock:
            st = self.stats.setdefault(path, [0, 0])
            st[0] += 1
            st[1] += len(out)
        h.send_response(status)
        for k, v in headers.items():
            h.send_header(k, v)
        h.send_header("Content-Length", str(len(out)))
        h.end_headers()
        h.wfile.write(out)

    def json_route(self, path: str, reply, status: int = 200) -> None:
        self.routes[path] = lambda method, body: (
            status, json.dumps(reply(method, body) if callable(reply)
                               else reply).encode())

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


class FetchTimer:
    """Seconds of a fetch's stages, from wrappers around the functions
    that do them: the STAC search (``smart_fetch.check_remote_catalog``),
    the COG reads (``PublicSentinel2Client._download_asset``: the range
    requests and their decode) and the AOI clip (``_clip_to_aoi``, which
    ends in its copy back); and the range files the reads made."""

    def __enter__(self):
        from s2sr_tpu_torch.fetch import client, smart_fetch
        from s2sr_tpu_torch.geo import cog

        self.seconds = {"search": 0.0, "range_reads": 0.0, "clip": 0.0}
        self.files: list = []
        timer = self

        def timed(fn, stage):
            @functools.wraps(fn)
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    timer.seconds[stage] += time.perf_counter() - t0
            return run

        class Recorded(cog.HttpRangeFile):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                timer.files.append(self)

        cls = client.PublicSentinel2Client
        self.saved = [(smart_fetch, "check_remote_catalog"),
                      (cls, "_download_asset"), (cls, "_clip_to_aoi"),
                      (cog, "HttpRangeFile")]
        self.saved = [(o, n, getattr(o, n)) for o, n in self.saved]
        smart_fetch.check_remote_catalog = timed(
            smart_fetch.check_remote_catalog, "search")
        cls._download_asset = timed(cls._download_asset, "range_reads")
        cls._clip_to_aoi = timed(cls._clip_to_aoi, "clip")
        cog.HttpRangeFile = Recorded
        return self

    def __exit__(self, *exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)

    def reads(self) -> dict:
        return {"requests_made": sum(f.requests_made for f in self.files),
                "bytes_fetched": sum(f.bytes_fetched for f in self.files)}


def s2_grid(side: int):
    """The EPSG:32636 transform of a ``side``² 10 m tile whose west and
    north edges lie 30% of a full tile (32.9 km) from the AOI's centre."""
    import numpy as np

    from s2sr_tpu_torch.fetch.synthetic import DEFAULT_BOUNDS
    from s2sr_tpu_torch.geo import Affine
    from s2sr_tpu_torch.geo.crs import lonlat_to_utm

    w, s, e, n = DEFAULT_BOUNDS
    cx, cy = lonlat_to_utm(np.array([(w + e) / 2]), np.array([(s + n) / 2]),
                           36, True)
    off = int(0.3 * S2_SIDE) * S2_RES
    return Affine(S2_RES, 0.0, float(np.floor(cx[0] / S2_RES) * S2_RES - off),
                  0.0, -S2_RES, float(np.floor(cy[0] / S2_RES) * S2_RES + off))


def stac_item(base: str, scene_id: str, visual: str) -> dict:
    from datetime import datetime, timedelta, timezone

    acq = datetime.now(timezone.utc) - timedelta(days=1)
    assets = {"visual": {"href": base + visual}}
    assets.update({k: {"href": f"{base}/bands/{k}.tif"}
                   for k in ("red", "green", "blue", "nir", "scl")})
    return {"id": scene_id, "type": "Feature", "collection": "sentinel-2-l2a",
            "properties": {"datetime": acq.strftime("%Y-%m-%dT%H:%M:%SZ"),
                           "eo:cloud_cover": 3.2},
            "assets": assets}


def fetch_assets(state) -> dict:
    """The canned scene, written once per run and served by an
    :class:`AssetServer`: the ``visual`` asset (a Sentinel-2 tile of RGB
    uint8 in EPSG:32636 at 10 m, deflate strips with the predictor, as
    the port's GeoTIFF writer writes them; pixels from ``--seed``), the
    red, green, blue and nir bands (uint16) and scl (uint8 class codes)
    on a 2745² crop of the same grid around the AOI, and the STAC reply
    of two items: one with the visual asset, one whose visual asset
    answers 404."""
    if "assets" in state:
        return state["assets"]
    import numpy as np

    from s2sr_tpu_torch.fetch.synthetic import DEFAULT_BOUNDS
    from s2sr_tpu_torch.geo import CRS, Affine, GeoTiff, write_geotiff

    root = state["work"] / "assets"
    (root / "bands").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(state["seed"])
    t0 = time.perf_counter()
    parcels = rng.integers(30, 226, (S2_SIDE // 20 + 1, S2_SIDE // 20 + 1, 3),
                           dtype=np.uint8)
    visual = np.repeat(np.repeat(parcels, 20, 0), 20, 1)[:S2_SIDE, :S2_SIDE]
    visual += rng.integers(0, 24, visual.shape, dtype=np.uint8)
    made_s = time.perf_counter() - t0
    # project the whole tile's write from 16 strips of it
    t0 = time.perf_counter()
    rows = 16 * ((1 << 20) // (S2_SIDE * 3))
    write_geotiff(GeoTiff(visual[:rows], transform=s2_grid(S2_SIDE),
                          crs=CRS(32636)), root / "probe.tif")
    projected = (time.perf_counter() - t0) * S2_SIDE / rows
    (root / "probe.tif").unlink()
    side = S2_SIDE if projected <= 30 else S2_SMALL_SIDE
    tr = s2_grid(side)
    t0 = time.perf_counter()
    write_geotiff(GeoTiff(np.ascontiguousarray(visual[:side, :side]),
                          transform=tr, crs=CRS(32636)), root / "visual.tif")
    write_s = time.perf_counter() - t0
    if side != S2_SIDE:
        emit({"phase": "fetch", "note": f"visual asset cut to {side}² "
              f"(writing {S2_SIDE}² was projected at {projected:.1f} s, "
              "over 30 s, on this host)"})
    # the bands: a BAND_SIDE² crop centred on the AOI, on the same grid
    w, s, e, n = DEFAULT_BOUNDS
    from s2sr_tpu_torch.geo.crs import lonlat_to_utm

    cx, cy = lonlat_to_utm(np.array([(w + e) / 2]), np.array([(s + n) / 2]),
                           36, True)
    c0 = int((cx[0] - tr.c) / S2_RES) - BAND_SIDE // 2
    r0 = int((tr.f - cy[0]) / S2_RES) - BAND_SIDE // 2
    crop = visual[r0:r0 + BAND_SIDE, c0:c0 + BAND_SIDE]
    btr = tr * Affine.translation(c0, r0)
    for k, key in enumerate(("red", "green", "blue", "nir")):
        band = crop[:, :, k % 3].astype(np.uint16) * 12 + rng.integers(
            0, 40, crop.shape[:2], dtype=np.uint16)
        write_geotiff(GeoTiff(band[:, :, None], transform=btr, crs=CRS(32636)),
                      root / "bands" / f"{key}.tif")
    codes = np.asarray(SCL_CODES, np.uint8)[rng.integers(
        0, len(SCL_CODES), (BAND_SIDE // 30 + 1, BAND_SIDE // 30 + 1))]
    scl = np.repeat(np.repeat(codes, 30, 0), 30, 1)[:BAND_SIDE, :BAND_SIDE]
    write_geotiff(GeoTiff(np.ascontiguousarray(scl)[:, :, None], transform=btr,
                          crs=CRS(32636)), root / "bands" / "scl.tif")
    srv = AssetServer(root)
    items = {"S2_VISUAL": stac_item(srv.base, "S2_VISUAL", "/visual.tif"),
             "S2_NO_VISUAL": stac_item(srv.base, "S2_NO_VISUAL",
                                       "/missing/visual.tif")}
    srv.json_route("/search", {"type": "FeatureCollection",
                               "features": [items["S2_VISUAL"]]})
    state["assets"] = {"server": srv, "root": root, "side": side,
                       "items": items, "visual_bytes":
                       (root / "visual.tif").stat().st_size}
    w, s, e, n = DEFAULT_BOUNDS
    state["assets"]["aoi"] = {"type": "Polygon", "coordinates": [[
        [w, s], [e, s], [e, n], [w, n], [w, s]]]}
    emit({"phase": "fetch", "assets": {
        "visual": f"{side}x{side}x3 uint8 EPSG:32636 10 m, deflate strips",
        "visual_bytes": state["assets"]["visual_bytes"],
        "bands": f"red, green, blue, nir uint16 and scl uint8, "
                 f"{BAND_SIDE}x{BAND_SIDE} crop of the same grid",
        "pixels_seconds": round(made_s, 3),
        "write_seconds": round(write_s, 3),
        "projected_full_write_seconds": round(projected, 3),
        "seed": state["seed"]}})
    return state["assets"]


def clip_card_vs_cpu(path: Path, url: str, aoi: dict, settings) -> int:
    """Bytes apart between the card's clip (the fetched GeoTIFF) and the
    CPU's clip of the same COG window."""
    import numpy as np

    from s2sr_tpu_torch.fetch.client import PublicSentinel2Client
    from s2sr_tpu_torch.geo import read_geotiff

    cpu = PublicSentinel2Client(settings, device="cpu")
    window = cpu._stream_window(url, aoi)
    want = cpu._clip_to_aoi(window, aoi).data
    got = read_geotiff(path).data
    if got.shape != want.shape:
        raise AssertionError(f"clip {got.shape} vs CPU {want.shape}")
    return int(np.count_nonzero(got != want))


def phase_fetch(state):
    """Scene acquisition on the card against local servers: (a)
    ``smart_fetch`` online over the default AOI (STAC search, range reads
    of the visual COG, the 1024² clip on the card, equal to the CPU's),
    (b) the RGB-band merge when the visual asset answers 404, (c)
    ``fetch_and_stack_multiband`` card vs CPU, (d) ``UP42Client``
    through a failed reply, an order poll and the download, (f)
    ``run_esrgan_and_tiles`` on the fetched scene (rdb launches, tiles/s)
    and (e) ``warp_tiles_device_benchmark`` on its SR raster."""
    import numpy as np

    from s2sr_tpu_torch.config import Settings
    from s2sr_tpu_torch.fetch import client, multiband, smart_fetch
    from s2sr_tpu_torch.geo import read_geotiff
    from s2sr_tpu_torch.models.engine import loaded_engines
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.pipelines.esrgan_tiles import run_esrgan_and_tiles
    from s2sr_tpu_torch.tiles.mercator import tiles_for_bounds
    from s2sr_tpu_torch.tiles.pyramid import warp_tiles_device_benchmark

    card = state.get("card") or card_line()
    assets = fetch_assets(state)
    srv, aoi = assets["server"], assets["aoi"]
    root = state["work"] / "fetch"
    settings = Settings(offline=False, data_dir=str(root / "data"),
                        weights_dir=str(state["work"] / "weights"))
    smart_fetch.STAC_URL = srv.base + "/search"

    # (a) smart_fetch online: search → range reads → clip on the card
    srv.stats.clear()
    with FetchTimer() as ft:
        t0 = time.perf_counter()
        path, meta = smart_fetch.smart_fetch(aoi, root / "source",
                                             settings=settings, device="cuda")
        total = time.perf_counter() - t0
    if meta.get("source") != "aws_earth_search" or \
            meta.get("scene_id") != "S2_VISUAL":
        raise AssertionError(f"smart_fetch online: {meta}")
    reads = ft.reads()
    apart = clip_card_vs_cpu(path, srv.base + "/visual.tif", aoi, settings)
    share = reads["bytes_fetched"] / assets["visual_bytes"]
    emit({"phase": "fetch", "case": "smart_fetch online, visual COG",
          "seconds": round(total, 4),
          "stage_seconds": {k: round(v, 4) for k, v in ft.seconds.items()},
          **reads, "visual_bytes": assets["visual_bytes"],
          "share_of_file": share, "clip": list(read_geotiff(path).data.shape),
          "clip_bytes_apart_card_vs_cpu": apart, "card": card})
    if apart or share > 0.25:
        raise AssertionError(f"smart_fetch: {apart} bytes apart, "
                             f"{share:.4f} of the file read")
    state["fetched_scene"] = path

    # (b) the visual asset answers 404: the RGB bands merged
    item = assets["items"]["S2_NO_VISUAL"]
    outs = {}
    for dev in ("cuda", "cpu"):
        with FetchTimer() as ft:
            t0 = time.perf_counter()
            p, m = client.PublicSentinel2Client(settings, device=dev
                                                ).fetch_best_scene(
                aoi, root / f"merge_{dev}",
                scene={"scene_id": item["id"], "feature": item})
            secs = time.perf_counter() - t0
        outs[dev] = read_geotiff(p).data
        if dev == "cuda":
            line = {"phase": "fetch", "case": "visual 404 -> RGB band merge",
                    "seconds": round(secs, 4),
                    "stage_seconds": {k: round(v, 4)
                                      for k, v in ft.seconds.items()},
                    **ft.reads(), "scene_id": m["scene_id"]}
    apart = int(np.count_nonzero(outs["cuda"] != outs["cpu"]))
    emit({**line, "clip_bytes_apart_card_vs_cpu": apart,
          "band_bytes": sum((assets["root"] / "bands" / f"{k}.tif").stat()
                            .st_size for k in ("red", "green", "blue")),
          "card": card})
    if apart or not outs["cuda"].any():
        raise AssertionError(f"RGB merge: {apart} bytes apart card vs CPU")

    # (c) multiband: red, NIR bilinear and SCL nearest on the card
    multiband.EARTH_SEARCH = srv.base + "/search"
    stacks = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p, m = multiband.fetch_and_stack_multiband(
            aoi, root / f"mb_{dev}", settings=settings, device=dev)
        stacks[dev] = (read_geotiff(p).data, time.perf_counter() - t0)
    got, want = stacks["cuda"][0], stacks["cpu"][0]
    apart = {b: int(np.count_nonzero(got[..., i] != want[..., i]))
             for i, b in enumerate(("red", "nir", "scl"))}
    classes = sorted(int(v) for v in np.unique(got[..., 2]))
    emit({"phase": "fetch", "case": "fetch_and_stack_multiband",
          "seconds": round(stacks["cuda"][1], 4),
          "cpu_seconds": round(stacks["cpu"][1], 4),
          "shape": list(got.shape), "values_apart_card_vs_cpu": apart,
          "scl_classes": classes, "card": card})
    if any(apart.values()) or not set(classes) <= set(SCL_CODES) | {0}:
        raise AssertionError(f"multiband: {apart}, classes {classes}")

    # (d) UP42: token, catalog (one 500 first), order, poll, download
    up = {"catalog": 0, "polls": 0}

    def catalog(method, body):
        up["catalog"] += 1
        return (500, b"{}") if up["catalog"] == 1 else (200, json.dumps(
            {"features": [assets["items"]["S2_VISUAL"]]}).encode())

    def order(method, body):
        up["polls"] += 1
        return {"id": "ord-1", "status": "RUNNING" if up["polls"] == 1
                else "FULFILLED",
                "assets": [{"url": srv.base + "/up42/asset.tif"}]}

    srv.json_route("/up42/auth", {"access_token": "tok", "expires_in": 3600})
    srv.routes["/up42/catalog"] = catalog
    srv.json_route("/up42/api/orders", lambda m, b: {"id": "ord-1"} if b
                   else {"content": []})
    srv.json_route("/up42/api/orders/ord-1", order)
    (assets["root"] / "up42").mkdir(exist_ok=True)
    (assets["root"] / "up42" / "asset.tif").write_bytes(path.read_bytes())
    up_settings = Settings(
        offline=False, up42_username="user", up42_password="pw",
        up42_auth_url=srv.base + "/up42/auth",
        up42_api_base=srv.base + "/up42/api",
        up42_catalog_url=srv.base + "/up42/catalog")
    up42 = client.UP42Client(up_settings)
    up42.wait_for_order = functools.partial(client.UP42Client.wait_for_order,
                                            up42, poll_s=0.05)
    t0 = time.perf_counter()
    p, m = up42.fetch_best_scene(aoi, root / "up42")
    secs = time.perf_counter() - t0
    emit({"phase": "fetch", "case": "UP42Client.fetch_best_scene",
          "seconds": round(secs, 4), "catalog_requests": up["catalog"],
          "order_polls": up["polls"], "order_id": m["order_id"],
          "scene_id": m["scene_id"]})
    if (up["catalog"] != 2 or up["polls"] != 2 or m["order_id"] != "ord-1"
            or Path(p).read_bytes() != path.read_bytes()):
        raise AssertionError(f"UP42: {up}, {m}")

    # (f) the ESRGAN tiles of the fetched scene, z15-17
    def engine_chunks() -> int:
        return sum(e.chunks_dispatched for e in loaded_engines())

    bounds = _mercator_bounds_of(read_geotiff(path))
    zooms = {z: len(list(tiles_for_bounds(bounds, z))) for z in range(15, 21)}
    emit({"phase": "fetch", "cut": "run_esrgan_and_tiles at z15-17, not "
          "JAX's default z18-20", "base_tiles_by_zoom": zooms})
    rdb_mod.LAUNCHES = 0
    chunks0 = engine_chunks()
    t0 = time.perf_counter()
    res = run_esrgan_and_tiles(path, root / "esrgan", min_zoom=15, max_zoom=17,
                               weights_dir=settings.weights_dir, device="cuda")
    secs = time.perf_counter() - t0
    launches, chunks = rdb_mod.LAUNCHES, engine_chunks() - chunks0
    stages = {s["name"]: s["seconds"] for s in res["timing"]["stages"]}
    tile_s = stages.get("tiles z15-17")
    emit({"phase": "fetch", "case": "run_esrgan_and_tiles z15-17",
          "seconds": round(secs, 4), "stage_seconds": stages,
          "tiles": res["tile_count"],
          "tiles_per_s": res["tile_count"] / tile_s if tile_s else None,
          "rdb_launches": launches, "chunks": chunks, "card": card})
    if not res["tile_count"] or not chunks or launches != 69 * chunks:
        raise AssertionError(f"esrgan tiles: {res['tile_count']} tiles, "
                             f"{launches} rdb launches for {chunks} chunks")
    state["main_launches"] = state.get("main_launches", 0) + launches

    # (e) the device's tiles/s at z16 on the 4096² SR raster
    sr = read_geotiff(res["sr_output"])
    warp_tiles_device_benchmark(sr, 16, device="cuda")          # warm
    t0 = time.perf_counter()
    n = warp_tiles_device_benchmark(sr, 16, device="cuda")
    secs = time.perf_counter() - t0
    emit({"phase": "fetch", "case": "warp_tiles_device_benchmark z16",
          "raster": list(sr.data.shape), "tiles": n, "seconds": round(secs, 4),
          "device_tiles_per_s": n / secs, "card": card})


def _mercator_bounds_of(raster):
    from s2sr_tpu_torch.geo.crs import CRS, transform_bounds

    return transform_bounds(raster.crs, CRS(3857), *raster.bounds)


# --- the HTTP server's job routes ------------------------------------------

SERVER_AOI = {"type": "Feature", "geometry": {"type": "Polygon", "coordinates": [[
    [35.0, 32.0], [35.02, 32.0], [35.02, 32.02], [35.0, 32.02], [35.0, 32.0]]]}}
TILE_STATUSES = ("tiling", "tiling_original", "tiling_sr")


class LiveServer:
    """The port's app served by ``server/http.py::serve`` on 127.0.0.1 in
    a thread of its own, stopped through serve()'s shutdown path."""

    def __init__(self, app):
        import socket

        self.app = app
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.base = f"http://127.0.0.1:{self.port}"

    def __enter__(self):
        import asyncio
        import threading

        from s2sr_tpu_torch.server.http import serve

        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        async def main():
            self.stop = asyncio.Event()
            ready = asyncio.Event()
            task = asyncio.ensure_future(serve(
                self.app, host="127.0.0.1", port=self.port, stop=self.stop,
                ready=ready))
            await ready.wait()
            started.set()
            await task

        self.thread = threading.Thread(
            target=lambda: self.loop.run_until_complete(main()), daemon=True)
        self.thread.start()
        if not started.wait(30):
            raise AssertionError("server did not start")
        return self

    def __exit__(self, *exc):
        self.loop.call_soon_threadsafe(self.stop.set)
        self.thread.join(timeout=60)
        self.loop.close()
        if self.thread.is_alive():
            raise AssertionError("server did not shut down")

    def request(self, method, path, body=None, headers=None) -> bytes:
        import urllib.request

        req = urllib.request.Request(self.base + path, data=body,
                                     headers=headers or {}, method=method)
        with urllib.request.urlopen(req, timeout=120) as r:
            if r.status != 200:
                raise AssertionError(f"{method} {path}: HTTP {r.status}")
            return r.read()

    def call(self, method, path, body=None, headers=None) -> tuple:
        """(status, parsed JSON body or None), 4xx and 5xx included."""
        import urllib.error

        try:
            return 200, json.loads(self.request(method, path, body, headers))
        except urllib.error.HTTPError as err:
            raw = err.read()
            return err.code, json.loads(raw) if raw else None

    def json(self, method, path, body=None, headers=None):
        if isinstance(body, dict):
            body = json.dumps(body).encode()
            headers = {"Content-Type": "application/json"}
        return json.loads(self.request(method, path, body, headers))

    def poll(self, path, timeout: float = 300.0) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            job = self.json("GET", path)
            if job["status"] in ("completed", "failed"):
                return job
            time.sleep(0.02)
        raise AssertionError(f"{path} did not finish: {job}")


def multipart_image(data: bytes, fields: dict, boundary: str,
                    filename: str = "up.png",
                    ctype: str = "image/png") -> tuple:
    body = b""
    for name, value in fields.items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"\r\n\r\n{value}\r\n').encode()
    body += (f"--{boundary}\r\nContent-Disposition: form-data; "
             f'name="image"; filename="{filename}"\r\n'
             f"Content-Type: {ctype}\r\n\r\n").encode()
    body += data + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def multipart_png(img, fields: dict, boundary: str) -> tuple:
    from s2sr_tpu_torch.tiles.png import encode_png

    return multipart_image(encode_png(img), fields, boundary)


# upload fixtures with the SHA-256 of PIL's RGB decode of each
FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures_torch"
# the lanczos warp against the CPU: the CPU tests' bounds against JAX
LANCZOS_FLOAT_TOL = 0.01
LANCZOS_BYTE_SHARE = 5e-4
LANCZOS_TILES = 8


def check_fixture_decodes(card) -> None:
    """Each committed upload fixture decoded by the port on this machine
    (no PIL here) to bytes whose SHA-256 is the one PIL gave when it was
    committed; the seconds each decode took on this host."""
    import hashlib

    from s2sr_tpu_torch.pipelines.io import decode_upload

    manifest = json.loads((FIXTURES / "fixtures.json").read_text())
    failures = []
    for name, rec in manifest.items():
        data = (FIXTURES / name).read_bytes()
        t1 = time.perf_counter()
        rgb = decode_upload(data, name)
        secs = time.perf_counter() - t1
        sha = hashlib.sha256(rgb.tobytes()).hexdigest()
        same = sha == rec["sha256"] and list(rgb.shape) == rec["shape"]
        emit({"phase": "server", "check": "upload decode vs PIL's SHA-256",
              "fixture": name, "bytes": len(data), "shape": list(rgb.shape),
              "decode_seconds": secs, "sha256_equal": same, "card": card})
        if not same:
            failures.append(name)
    if failures:
        raise AssertionError(f"decodes differ from PIL's: {failures}")


def check_lanczos_batch(sr_tif: Path, zoom: int) -> dict:
    """The lanczos warp of a few base-zoom tiles of ``sr_tif`` on the card
    against the CPU: floats within 0.01 of 255, RGBA bytes equal on at
    least 99.95% of the values and within 1 elsewhere (the CPU tests'
    bounds against jitted JAX; lanczos's sin and cos may round otherwise
    on the card)."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.geo import read_geotiff
    from s2sr_tpu_torch.geo.warp import warp_lanczos_batch
    from s2sr_tpu_torch.tiles import pyramid

    raster = read_geotiff(sr_tif)
    src = torch.from_numpy(pyramid._rgba_source(raster))
    keys, ctrls = next(pyramid.base_zoom_batches(raster, zoom))
    ctrls = torch.from_numpy(ctrls[:LANCZOS_TILES])
    out = {}
    for dev in ("cpu", "cuda"):
        s_, c = src.to(dev), ctrls.to(dev)
        out[dev] = (warp_lanczos_batch(s_, c, 256, 256)[0].cpu().numpy(),
                    pyramid._warp_tiles_rgba_u8(s_, c, 256, True).cpu().numpy())
    ferr = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    a, b = out["cpu"][1].astype(np.int32), out["cuda"][1].astype(np.int32)
    diff = np.abs(a - b)
    rec = {"tiles": int(ctrls.shape[0]), "zoom": zoom,
           "float_max_abs_diff": ferr, "tol_float": LANCZOS_FLOAT_TOL,
           "bytes_differing": int((diff > 0).sum()), "values": int(diff.size),
           "max_byte_diff": int(diff.max()),
           "tol_share_differing": LANCZOS_BYTE_SHARE}
    if (not ferr <= LANCZOS_FLOAT_TOL or diff.max() > 1
            or (diff > 0).mean() > LANCZOS_BYTE_SHARE):
        raise AssertionError(f"lanczos batch on the card vs the CPU: {rec}")
    return rec


def tile_mtimes(data_dir: Path) -> dict:
    return {p: p.stat().st_mtime_ns for tree in ("tiles", "tiles_wow", "tiles_sr")
            for p in (data_dir / tree).glob("*/*/*.png")}


def check_farm_chain() -> dict:
    """The farm chain on the card against the CPU, byte for byte, on a
    512×384 image (the WOW chain's check, with the farm's constants)."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.ops.enhance import enhance_farm

    img = torch.from_numpy(synthetic_fields((512, 384), seed=11))
    cpu = enhance_farm(img).numpy()
    gpu = enhance_farm(img.cuda()).cpu().numpy()
    touched = int(np.any(cpu != gpu, axis=-1).sum())
    if gpu.shape != cpu.shape or touched:
        raise AssertionError(f"farm chain on the card differs from the CPU "
                             f"on {touched} pixels")
    return {"image": [512, 384], "pixels_differing": touched,
            "tol_pixels_differing": 0}


def check_tile_batch(sr_tif: Path, zoom: int) -> dict:
    """One base-zoom batch of tiles of ``sr_tif`` warped on the card and
    on the CPU, bit for bit: every op of the warp rounds once, as IEEE
    has it, on both devices (one kernel per op, the divisions by a 0-dim
    tensor), so the floats and the RGBA bytes must be equal. (Against
    jitted JAX, whose compiler contracts multiply-adds, the CPU tests
    allow 0.01 and 5e-4 of the bytes.)"""
    import numpy as np
    import torch

    from s2sr_tpu_torch.geo import read_geotiff
    from s2sr_tpu_torch.geo.warp import warp_bilinear_batch
    from s2sr_tpu_torch.tiles import pyramid

    raster = read_geotiff(sr_tif)
    src = torch.from_numpy(pyramid._rgba_source(raster))
    keys, ctrls = next(pyramid.base_zoom_batches(raster, zoom))
    ctrls = torch.from_numpy(ctrls)
    out = {}
    for dev in ("cpu", "cuda"):
        s, c = src.to(dev), ctrls.to(dev)
        out[dev] = (warp_bilinear_batch(s, c, 256, 256)[0].cpu().numpy(),
                    pyramid._warp_tiles_rgba_u8(s, c, 256, False).cpu().numpy())
    ferr = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    a, b = out["cpu"][1].astype(np.int32), out["cuda"][1].astype(np.int32)
    flips = (a[..., 3] == 0) != (b[..., 3] == 0)
    diff = np.abs(a - b)
    diff[flips] = 0
    rec = {"tiles": len(keys), "zoom": zoom, "float_max_abs_diff": ferr,
           "bytes_differing": int((diff > 0).sum()), "values": int(diff.size),
           "max_byte_diff": int(diff.max()), "coverage_flips": int(flips.sum()),
           "tol_differing": 0}
    if ferr or diff.any() or flips.any():
        raise AssertionError(f"tile batch on the card vs the CPU: {rec}")
    return rec


def check_decode_route(srv, state, card, engine_chunks) -> None:
    """``POST /api/decode`` over the live socket: a QR PNG (the port's own
    PNG encoder) and the low-quality plate with the retry off, each equal
    to the JAX package's recorded answer; a non-image (400) and an upload
    over the limit (413); the plate with the retry, which must run the
    card's ``realesrgan_x4`` (rdb launches = 69 × chunks)."""
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.pipelines.io import decode_upload
    from s2sr_tpu_torch.tiles.png import encode_png

    manifest = json.loads((FIXTURES / "fixtures.json").read_text())
    qr = encode_png(decode_upload((FIXTURES / "scan_qr.png").read_bytes()))
    plate = (FIXTURES / "scan_plate_low_quality.png").read_bytes()
    limit = srv.app.settings.max_upload_bytes
    probes = [
        ("qr", qr, {}, 200, dict(manifest["scan_qr.png"]["decode_no_retry"],
                                 filename="scan.png")),
        ("plate, enhance_retry=false", plate, {"enhance_retry": "false"}, 200,
         dict(manifest["scan_plate_low_quality.png"]["decode_no_retry"],
              filename="scan.png")),
        ("non-image", b"GIF89a but not really", {}, 400,
         {"detail": "could not decode uploaded image"}),
        ("over the upload limit", bytes(limit + 1), {}, 413,
         {"detail": f"Upload exceeds maximum allowed size of "
                    f"{limit // (1024 * 1024)} MB"}),
        ("plate with the retry", plate, {}, 200, None),
    ]
    failures = []
    for k, (name, data, fields, want_code, want) in enumerate(probes):
        body, headers = multipart_image(data, fields, f"bd{k}", "scan.png")
        chunks0 = engine_chunks()
        rdb_mod.LAUNCHES = 0
        t1 = time.perf_counter()
        code, out = srv.call("POST", "/api/decode", body, headers)
        secs = time.perf_counter() - t1
        launches, chunks = rdb_mod.LAUNCHES, engine_chunks() - chunks0
        if want is None:            # the retry: rdb on the card, 69 a chunk
            ok = (code == 200 and out["retried_with_enhancement"] and chunks
                  and launches == 69 * chunks)
            state["main_launches"] = state.get("main_launches", 0) + launches
        else:
            ok = code == want_code and same_scan(out, want) and launches == 0
        line = {"phase": "server", "route": "/api/decode", "probe": name,
                "status": code, "seconds": round(secs, 4),
                "rdb_launches": launches, "chunks": chunks, "as_expected": ok,
                "card": card}
        if code == 200:
            line.update(serial=out["serial"],
                        retried=out["retried_with_enhancement"],
                        stages=[a["stage"] for a in out["attempts"]])
        emit(line)
        if not ok:
            failures.append((name, code, out))
    if failures:
        raise AssertionError(f"/api/decode: {failures}")


def check_online_pipeline(state, card) -> None:
    """``/api/pipeline`` with ``offline=False`` over a live socket at JAX's
    default zooms 10–16: the job fetches the canned scene (STAC search,
    range reads, the clip on the card, all on the runner), tiles it, runs
    the SR and tiles that; POST → completed with the stage split and the
    fetch's own split; the SR GeoTIFF against ``process_wow_sr`` on the
    fetched file."""
    from s2sr_tpu_torch.config import Settings
    from s2sr_tpu_torch.fetch import smart_fetch
    from s2sr_tpu_torch.models.engine import loaded_engines
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.pipelines.wow_sr import process_wow_sr
    from s2sr_tpu_torch.server.app import create_app
    from s2sr_tpu_torch.utils import write_json

    assets = fetch_assets(state)
    smart_fetch.STAC_URL = assets["server"].base + "/search"
    root = state["work"] / "server_online"
    write_json({"type": "Feature", "geometry": assets["aoi"]},
               root / "aoi.geojson")
    settings = Settings(data_dir=str(root / "data"),
                        aoi_path=str(root / "aoi.geojson"), offline=False,
                        weights_dir=str(state["work"] / "weights"))
    app = create_app(settings, device="cuda")
    changes: list = []
    update = app.jobs.update

    def timed_update(job_id, **fields):
        if "status" in fields:
            changes.append((fields["status"], time.perf_counter()))
        return update(job_id, **fields)

    app.jobs.update = timed_update
    chunks0 = sum(e.chunks_dispatched for e in loaded_engines())
    rdb_mod.LAUNCHES = 0
    with LiveServer(app) as srv, FetchTimer() as ft:
        t0 = time.perf_counter()
        job_id = srv.json("POST", "/api/pipeline", {})["job_id"]
        rec = srv.poll(f"/api/pipeline/{job_id}", timeout=900)
        secs = time.perf_counter() - t0
    launches = rdb_mod.LAUNCHES
    chunks = sum(e.chunks_dispatched for e in loaded_engines()) - chunks0
    if rec["status"] != "completed" or \
            [st["status"] for st in rec["steps"]] != ["completed"] * 4:
        raise AssertionError(f"online pipeline: {rec['status']}: "
                             f"{rec.get('message')} {rec.get('steps')}")
    fetched = rec["fetch_metadata"]
    if fetched.get("source") != "aws_earth_search":
        raise AssertionError(f"online pipeline fetched {fetched}")
    stages = {a[0]: round(b[1] - a[1], 4) for a, b in zip(changes, changes[1:])}
    tiles = {name: sum(1 for _ in (root / "data" / name).glob("*/*/*.png"))
             for name in ("tiles", "tiles_wow")}
    tiling = sum(v for k, v in stages.items() if k in TILE_STATUSES)
    sr_tif = Path(rec["steps"][2]["details"]["output"])
    direct = process_wow_sr(rec["input_file"], root / "direct",
                            weights_dir=settings.weights_dir, device="cuda")
    same = Path(direct["outputs"]["sr_tif"]).read_bytes() == sr_tif.read_bytes()
    emit({"phase": "server", "route": "/api/pipeline online",
          "zooms": [10, 16], "seconds": round(secs, 4),
          "stage_seconds": stages,
          "fetch_stage_seconds": {k: round(v, 4) for k, v in ft.seconds.items()},
          **ft.reads(), "tiles": tiles,
          "tiles_per_s": round(sum(tiles.values()) / tiling, 1) if tiling else None,
          "rdb_launches": launches, "chunks": chunks,
          "sr_tif_bytes": sr_tif.stat().st_size,
          "sr_tif_equal_to_process_wow_sr": same, "card": card})
    if not same or not chunks or launches != 69 * chunks:
        raise AssertionError(f"online pipeline: SR GeoTIFF equal {same}, "
                             f"{launches} rdb launches for {chunks} chunks")
    state["main_launches"] = state.get("main_launches", 0) + launches


def check_png_encoders(sr_tif: Path, card) -> None:
    """The encoder in use and why, and one pyramid (z14–16 of the /api/wow
    SR raster) on each encoder: tiles/s, and every tile's pixels equal."""
    import numpy as np

    from s2sr_tpu_torch import native
    from s2sr_tpu_torch.geo import read_geotiff
    from s2sr_tpu_torch.tiles.png import decode_png
    from s2sr_tpu_torch.tiles.pyramid import generate_xyz_tiles

    encoder = native.png_encoder()
    emit({"phase": "server", **encoder, "card": card})
    raster = read_geotiff(sr_tif)
    out = sr_tif.parent / "encoders"
    rates = {}
    load = native.load
    for name in ("native", "pure"):
        if name == "pure":
            native.load = lambda: None
        try:
            t0 = time.perf_counter()
            generate_xyz_tiles(raster, out / name, 14, 16, device="cuda")
            secs = time.perf_counter() - t0
        finally:
            native.load = load
        n = sum(1 for _ in (out / name).glob("*/*/*.png"))
        rates[name] = {"tiles": n, "seconds": round(secs, 4),
                       "tiles_per_s": n / secs}
    names = sorted(p.relative_to(out / "native")
                   for p in (out / "native").glob("*/*/*.png"))
    pure = sorted(p.relative_to(out / "pure")
                  for p in (out / "pure").glob("*/*/*.png"))
    differ = sum(not np.array_equal(decode_png((out / "native" / p).read_bytes()),
                                    decode_png((out / "pure" / p).read_bytes()))
                 for p in names)
    same_bytes = sum((out / "native" / p).read_bytes()
                     == (out / "pure" / p).read_bytes() for p in names)
    emit({"phase": "server", "check": "one pyramid z14-16 on each encoder",
          "encoder": encoder["png_encoder"], **{f"{k}": v for k, v in
                                                rates.items()},
          "tiles_with_pixels_apart": differ, "tiles_byte_equal": same_bytes,
          "card": card})
    if names != pure or differ or not names:
        raise AssertionError(f"encoders: {len(names)} vs {len(pure)} tiles, "
                             f"{differ} with pixels apart")


def host_profile_wow(srv, app, scene: Path, card, top: int = 15) -> None:
    """``cProfile`` of one warm ``/api/wow`` job's run on the runner
    thread, on the native encoder and on the pure one: the top functions
    by cumulative time. (Python 3.12's profiler sees every thread, so the
    caller waits on an event, not by polling, while the job runs.)"""
    import cProfile
    import pstats
    import threading

    from s2sr_tpu_torch import native

    load = native.load
    for name in ("native", "pure"):
        prof = cProfile.Profile()
        done = threading.Event()
        submit = app.runner.submit

        def profiled(job_id, fn, *a, **k):
            def run():
                prof.enable()
                try:
                    return fn()
                finally:
                    prof.disable()
                    done.set()
            return submit(job_id, run, *a, **k)

        app.runner.submit = profiled
        if name == "pure":
            native.load = lambda: None
        try:
            t0 = time.perf_counter()
            job_id = srv.json("POST", "/api/wow",
                              {"input_file": str(scene)})["job_id"]
            if not done.wait(600):
                raise AssertionError("profiled /api/wow did not finish")
            secs = time.perf_counter() - t0
        finally:
            native.load = load
            del app.runner.submit
        rec = srv.poll(f"/api/sr/{job_id}")
        if rec["status"] != "completed":
            raise AssertionError(f"profiled /api/wow: {rec['message']}")
        st = pstats.Stats(prof)
        rows = sorted(st.stats.items(), key=lambda kv: kv[1][3],
                      reverse=True)[:top]
        emit({"phase": "server", "profile": f"host cProfile of one warm "
              f"/api/wow job's run (1024² scene), {name} encoder",
              "seconds": round(secs, 4), "total_tt": st.total_tt,
              "top_cumulative": [
                  {"func": f"{Path(f).name}:{line}({fn})", "ncalls": nc,
                   "tottime": round(tt, 4), "cumtime": round(ct, 4)}
                  for (f, line, fn), (_cc, nc, tt, ct, _c) in rows],
              "card": card})


def phase_server(state):
    """The port's HTTP server over a live socket at full width: the four
    job routes, polled to their end, then downloads, tiles and the
    read-only routes; the rdb launches they made, the /api/wow output
    against a direct ``process_wow_sr`` call, the farm chain and a tile
    batch against the CPU."""
    import threading

    import torch

    from s2sr_tpu_torch.config import Settings
    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields, synthetic_scene
    from s2sr_tpu_torch.models.engine import loaded_engines
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.pipelines.wow_sr import process_wow_sr
    from s2sr_tpu_torch.server.app import create_app
    from s2sr_tpu_torch.tiles.png import decode_png
    from s2sr_tpu_torch.utils import write_json

    t0 = time.perf_counter()
    card = state.get("card") or card_line()
    root = state["work"] / "server"
    data = root / "data"
    write_json(SERVER_AOI, root / "aoi.geojson")
    settings = Settings(data_dir=str(data), aoi_path=str(root / "aoi.geojson"),
                        offline=True, weights_dir=str(state["work"] / "weights"),
                        tile_min_zoom=12, tile_max_zoom=13)
    app = create_app(settings, device="cuda")
    changes: dict = {}                        # job id → [(status, t)]
    update = app.jobs.update

    def timed_update(job_id, **fields):
        if "status" in fields:
            changes.setdefault(job_id, []).append(
                (fields["status"], time.perf_counter()))
        return update(job_id, **fields)

    app.jobs.update = timed_update
    wow_scene = root / "scene_1024.tif"
    synthetic_scene(wow_scene, size=(1024, 1024), seed=3)

    def engine_chunks() -> int:
        return sum(e.chunks_dispatched for e in loaded_engines())

    total_launches = total_chunks = 0
    last: dict = {}

    def drive(route, post, status_path, expect="completed"):
        """POST, poll to the end; the job's record, seconds, stages,
        tiles written and rdb launches."""
        nonlocal total_launches, total_chunks
        before = tile_mtimes(data)
        chunks0 = engine_chunks()
        rdb_mod.LAUNCHES = rdb_mod.LAUNCHES_I8 = 0
        t1 = time.perf_counter()
        ids = post()
        recs = [srv.poll(status_path + i) for i in ids]
        secs = time.perf_counter() - t1
        launches, chunks = rdb_mod.LAUNCHES, engine_chunks() - chunks0
        last.update(launches=launches, launches_i8=rdb_mod.LAUNCHES_I8,
                    chunks=chunks)
        total_launches += launches + rdb_mod.LAUNCHES_I8
        total_chunks += chunks
        after = tile_mtimes(data)
        written = sum(1 for p, m in after.items() if before.get(p) != m)
        for rec in recs:
            if rec["status"] != expect:
                raise AssertionError(f"{route}: {rec['status']}: {rec['message']}")
        steps = changes[ids[0]]
        stages = {a[0]: round(b[1] - a[1], 4) for a, b in zip(steps, steps[1:])}
        tiling = sum(v for k, v in stages.items() if k in TILE_STATUSES)
        line = {"phase": "server", "route": route, "jobs": len(ids),
                "status": recs[0]["status"], "seconds": round(secs, 4),
                "stage_seconds": stages, "tiles_written": written,
                "tiles_per_s": round(written / tiling, 1) if tiling else None,
                "rdb_launches": launches, "rdb_i8_launches": last["launches_i8"],
                "chunks": chunks, "card": card}
        result = recs[0].get("result") or {}
        if "sr_metadata" in result:
            line["sr_stage_seconds"] = {
                st["name"]: st["seconds"]
                for st in result["sr_metadata"]["timing"]["stages"]}
        emit(line)
        return recs

    with LiveServer(app) as srv:
        pipe = drive("/api/pipeline", lambda: [srv.json(
            "POST", "/api/pipeline", {"min_zoom": 12, "max_zoom": 13})["job_id"]],
            "/api/pipeline/")[0]
        if [st["status"] for st in pipe["steps"]] != ["completed"] * 4:
            raise AssertionError(f"pipeline steps: {pipe['steps']}")
        source = pipe["input_file"]
        wow = drive("/api/wow", lambda: [srv.json("POST", "/api/wow", {
            "input_file": str(wow_scene)})["job_id"]], "/api/sr/")[0]

        def post_enhance():
            gate = threading.Event()          # hold the runner: coalesce
            app.runner.submit("hold", lambda: gate.wait(120))
            ids = []
            for k, (shape, seed) in enumerate((((200, 152), 5), ((96, 128), 6))):
                body, headers = multipart_png(synthetic_fields(shape, seed=seed),
                                              {"model": "realesrgan_x4"}, f"b{k}")
                ids.append(srv.json("POST", "/api/enhance", body, headers)["job_id"])
            gate.set()
            return ids

        enh = drive("/api/enhance", post_enhance, "/api/sr/")
        if [r.get("coalesced") for r in enh] != [2, 2]:
            raise AssertionError(f"enhance jobs did not coalesce: {enh}")
        drive("/api/sr", lambda: [srv.json("POST", "/api/sr", {
            "input_file": source, "scale": 4})["job_id"]], "/api/sr/")
        bad = drive("/api/sr x2", lambda: [srv.json("POST", "/api/sr", {
            "input_file": source, "scale": 2})["job_id"]], "/api/sr/",
            expect="failed")[0]
        if not bad["message"].startswith("Unknown model: realesrgan_x2"):
            raise AssertionError(f"/api/sr x2: {bad['message']}")

        n_rdb = None
        for e in loaded_engines():
            if e.model_name == "realesrgan_x4" and e.device.type == "cuda":
                if e.dtype != torch.bfloat16 or len(e.model.body) != 23:
                    raise AssertionError("server must run full-width bf16 "
                                         "realesrgan_x4")
                n_rdb = 3 * len(e.model.body)
        if n_rdb is None or total_chunks == 0 or \
                total_launches != n_rdb * total_chunks:
            raise AssertionError(f"server: {total_launches} rdb launches for "
                                 f"{total_chunks} chunks (want {n_rdb} x chunks)")
        state["main_launches"] = state.get("main_launches", 0) + total_launches

        # downloads, tiles and the read-only routes
        name = Path(wow["result"]["outputs"]["sr_png"]).name
        wow_id = Path(wow["output_dir"]).name
        png = decode_png(srv.request("GET", f"/api/sr/download/{wow_id}/{name}"))
        if png.shape != (4096, 4096, 3):
            raise AssertionError(f"downloaded SR PNG {png.shape}")
        fetched = {}
        for tree in ("tiles", "tiles_wow", "tiles_sr"):
            one = next((data / tree).glob("*/*/*.png"))
            tile = decode_png(srv.request("GET", f"/{tree}/" + "/".join(one.parts[-3:])))
            if tile.shape != (256, 256, 4):
                raise AssertionError(f"{tree} tile {tile.shape}")
            fetched[tree] = "/".join(one.parts[-3:])
        meta = srv.json("GET", "/api/metadata")
        model = meta["models"]["realesrgan_x4"]
        if not (meta["tilesAvailable"] and meta["wowTilesAvailable"]
                and meta["srTilesAvailable"]) or "halo_margin_lsb" not in model:
            raise AssertionError(f"/api/metadata: {meta}")
        runtime = srv.json("GET", "/api/runtime")
        kinds = [d.get("kind") for d in runtime["devices"]]
        if torch.cuda.get_device_name(0) not in kinds or \
                runtime["devices"][0]["platform"] != "gpu":
            raise AssertionError(f"/api/runtime devices: {runtime['devices']}")
        metrics = srv.request("GET", "/metrics").decode()
        for want in ('s2sr_jobs{status="completed"} 5',
                     's2sr_jobs{status="failed"} 1'):
            if want not in metrics:
                raise AssertionError(f"/metrics lacks {want!r}:\n{metrics}")
        emit({"phase": "server", "download_png": list(png.shape),
              "tiles_fetched": fetched, "metadata_model": model,
              "runtime_devices": runtime["devices"],
              "metrics_lines": len(metrics.splitlines())})

        # precision "turbo": the int8-mixed trunk, every RDB in rdb_i8
        turbo = drive("/api/wow turbo", lambda: [srv.json("POST", "/api/wow", {
            "input_file": str(wow_scene), "precision": "turbo"})["job_id"]],
            "/api/sr/")[0]
        md = turbo["result"]["sr_metadata"]
        if (turbo["precision"] != "int8" or md["precision"] != "int8"
                or last["launches"] or not last["chunks"]
                or last["launches_i8"] != n_rdb * last["chunks"]):
            raise AssertionError(f"/api/wow turbo: precision {md['precision']}, "
                                 f"{last} (want {n_rdb} rdb_i8 x chunks)")
        state["main_launches_i8"] = (state.get("main_launches_i8", 0)
                                     + last["launches_i8"])
        models = srv.json("GET", "/api/metadata")["models"]
        if models.get("realesrgan_x4:int8", {}).get("precision") != "int8":
            raise AssertionError(f"/api/metadata lists no int8 engine: {models}")

        # a JPEG upload (the committed 1024×768 fixture), decoded by the port
        jpg = (FIXTURES / "upload_1024x768.jpg").read_bytes()
        up = drive("/api/enhance jpeg", lambda: [srv.json(
            "POST", "/api/enhance", *multipart_image(
                jpg, {"model": "realesrgan_x4"}, "bj", "up.jpg",
                "image/jpeg"))["job_id"]], "/api/sr/")[0]
        md = up["result"]["sr_metadata"]
        if (md["original_size"] != [768, 1024]
                or md["output_size"] != [3072, 4096]
                or last["launches"] != n_rdb * last["chunks"]):
            raise AssertionError(f"/api/enhance jpeg: {md['original_size']} → "
                                 f"{md['output_size']}, {last}")
        state["main_launches"] += last["launches"]

        # a lossy WebP upload (the committed 1024×768 fixture, quality 80:
        # a phone photo scaled for upload), decoded by the port's VP8
        from s2sr_tpu_torch.pipelines.io import decode_upload

        webp = (FIXTURES / "upload_1024x768.webp").read_bytes()
        t1 = time.perf_counter()
        decode_upload(webp, "upload_1024x768.webp")
        webp_decode_s = time.perf_counter() - t1
        up = drive("/api/enhance webp", lambda: [srv.json(
            "POST", "/api/enhance", *multipart_image(
                webp, {"model": "realesrgan_x4"}, "bw", "up.webp",
                "image/webp"))["job_id"]], "/api/sr/")[0]
        md = up["result"]["sr_metadata"]
        if (md["original_size"] != [768, 1024]
                or md["output_size"] != [3072, 4096]
                or last["launches"] != n_rdb * last["chunks"]):
            raise AssertionError(f"/api/enhance webp: {md['original_size']} → "
                                 f"{md['output_size']}, {last}")
        state["main_launches"] += last["launches"]
        emit({"phase": "server", "upload": "upload_1024x768.webp",
              "bytes": len(webp), "decode_seconds": webp_decode_s,
              "card": card})

        # the QR/serial scan, POST to response
        check_decode_route(srv, state, card, engine_chunks)

        # the host's time in one warm /api/wow job, on each PNG encoder
        launches0 = rdb_mod.LAUNCHES
        host_profile_wow(srv, app, wow_scene, card)
        state["main_launches"] += rdb_mod.LAUNCHES - launches0

        # the device's idle share of one warm /api/wow job
        def wow_job():
            job_id = srv.json("POST", "/api/wow", {
                "input_file": str(wow_scene)})["job_id"]
            rec = srv.poll(f"/api/sr/{job_id}")
            if rec["status"] != "completed":
                raise AssertionError(f"profiled /api/wow: {rec['message']}")

        launches0 = rdb_mod.LAUNCHES
        prof = device_breakdown(wow_job)
        emit({"phase": "server", "card": card,
              "profile": "one warm /api/wow job, 1024² scene, POST to completed",
              "device_idle_share": 1.0 - prof["device_busy_share"], **prof})

        # the device's idle share of one /api/decode with its SR retry
        plate = (FIXTURES / "scan_plate_low_quality.png").read_bytes()

        def decode_request():
            code, out = srv.call("POST", "/api/decode", *multipart_image(
                plate, {}, "bp", "plate.png"))
            if code != 200 or not out["retried_with_enhancement"]:
                raise AssertionError(f"profiled /api/decode: {code} {out}")

        prof = device_breakdown(decode_request)
        emit({"phase": "server", "card": card,
              "profile": "one /api/decode with its SR retry, low-quality "
                         "plate, POST to response",
              "device_idle_share": 1.0 - prof["device_busy_share"], **prof})

    # the /api/wow output against process_wow_sr on the same engine and scene
    direct = process_wow_sr(wow_scene, root / "direct",
                            weights_dir=settings.weights_dir, device="cuda")
    job_tif = Path(wow["result"]["outputs"]["sr_tif"]).read_bytes()
    same = Path(direct["outputs"]["sr_tif"]).read_bytes() == job_tif
    rdb_mod.LAUNCHES = launches0
    farm = check_farm_chain()
    tiles = check_tile_batch(Path(wow["result"]["outputs"]["sr_tif"]),
                             zoom=settings.tile_max_zoom + 2)
    emit({"phase": "server", "check": "/api/wow GeoTIFF vs process_wow_sr",
          "bytes": len(job_tif), "byte_equal": same})
    emit({"phase": "server", "check": "farm chain on the card vs the CPU", **farm})
    emit({"phase": "server", "check": "tile batch on the card vs the CPU", **tiles})
    lanczos = check_lanczos_batch(Path(wow["result"]["outputs"]["sr_tif"]),
                                  zoom=settings.tile_max_zoom + 2)
    emit({"phase": "server", "check": "lanczos batch on the card vs the CPU",
          **lanczos})
    check_fixture_decodes(card)
    if not same:
        raise AssertionError("/api/wow GeoTIFF differs from process_wow_sr")
    check_png_encoders(Path(wow["result"]["outputs"]["sr_tif"]), card)
    check_online_pipeline(state, card)
    emit({"phase": "server", "rdb_launches": total_launches,
          "chunks": total_chunks, "seconds": round(time.perf_counter() - t0, 3)})


# --- field-boundary vectors ----------------------------------------------------

VECTORS_SIDE = 1024            # card vs CPU, and the /api/wow scene
VECTORS_LARGE = 4096           # the planted raster of the profiled job
VECTORS_V2_SIDE = 512          # v2, card vs CPU (the CPU's k-means is slow)
ZONES_404 = ("Management zones not found. Run v2 vector extraction "
             "with --zones")


def _geojson_sans_time(g: dict) -> dict:
    g = json.loads(json.dumps(g))
    g["properties"].pop("generated_at", None)
    for f in g["features"]:
        f["properties"].pop("created_at", None)
    return g


def vector_split(tif: Path, aoi: Path) -> dict:
    """The segmentation chain of one raster with a sync after each stage
    (``segment_fields(timings=...)``), and the fixpoint passes and host
    syncs it made."""
    import numpy as np

    from s2sr_tpu_torch.geo import read_geotiff
    from s2sr_tpu_torch.vectors import ops
    from s2sr_tpu_torch.vectors.extraction import (
        ExtractionConfig, bucket_shape, compute_vegetation_mask,
        crop_raster_to_aoi, load_aoi_geojson, segment_fields)

    config = ExtractionConfig()
    working = crop_raster_to_aoi(read_geotiff(tif), load_aoi_geojson(aoi))
    th, tw = working.data.shape[:2]
    hb, wb = bucket_shape(th, tw)
    padded = np.zeros((hb, wb, working.count), working.data.dtype)
    padded[:th, :tw] = working.data
    working.data = padded
    mask, _ = compute_vegetation_mask(working, config, "cuda")
    segment_fields(mask, config, valid_hw=(th, tw), device="cuda")   # warm
    timings: dict = {}
    t1 = time.perf_counter()
    segment_fields(mask, config, timings, valid_hw=(th, tw), device="cuda")
    passes = dict(ops.PASSES)
    syncs = sum(-(-n // ops.CHECK_EVERY_CUDA) for n in passes.values())
    return {"seconds": time.perf_counter() - t1, "stages": timings,
            "passes": passes, "check_every": ops.CHECK_EVERY_CUDA,
            "host_syncs": syncs, "frame": [hb, wb]}


def phase_vectors(state):
    """Field-boundary vectors on ``realesrgan_x4``: (a) the card's
    ``fields.geojson`` against the CPU's on a 1024² planted scene;
    (b) over a live socket, ``/api/wow`` on a 1024² scene, then
    ``/api/vectors`` with no raster_path (it must find that 4096²
    output), then with a 4096² planted raster, then the vector GETs;
    (c) that 4096² job under ``torch.profiler``: seconds, stage split,
    fixpoint passes and the device's idle share; (d) v2 on a 5-band
    planted raster, card against CPU."""
    from urllib.error import HTTPError

    import torch

    from s2sr_tpu_torch.config import Settings
    from s2sr_tpu_torch.fetch.synthetic import synthetic_scene
    from s2sr_tpu_torch.models.engine import loaded_engines
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.server.app import create_app
    from s2sr_tpu_torch.utils import write_json
    from s2sr_tpu_torch.vectors import ops
    from s2sr_tpu_torch.vectors.extraction import extract_field_polygons
    from s2sr_tpu_torch.vectors.synthetic import write_planted_scene

    t0 = time.perf_counter()
    card = state.get("card") or card_line()
    root = state["work"] / "vectors"

    # (a) card against CPU, both in the port
    tif, aoi = write_planted_scene(root / "planted", VECTORS_SIDE, seed=1)
    runs = {}
    for dev in ("cuda", "cpu"):
        t1 = time.perf_counter()
        res = extract_field_polygons(aoi, [tif], root / f"out_{dev}",
                                     device=dev)
        runs[dev] = (res, time.perf_counter() - t1, dict(ops.PASSES))
    (card_res, card_s, card_passes), (cpu_res, cpu_s, _) = runs["cuda"], runs["cpu"]
    same = (_geojson_sans_time(card_res["geojson"])
            == _geojson_sans_time(cpu_res["geojson"]))
    emit({"phase": "vectors", "check": "fields.geojson, card vs CPU",
          "side": VECTORS_SIDE, "features": card_res["feature_count"],
          "equal": same, "card_seconds": card_s, "cpu_seconds": cpu_s,
          "card_stage_timings_s": card_res["stage_timings_s"],
          "passes": card_passes, "card": card})
    if not same or card_res["feature_count"] <= 0:
        raise AssertionError(f"vectors card vs CPU: equal {same}, "
                             f"{card_res['feature_count']} features")

    # (b) the users' chain over a live socket
    data = root / "data"
    write_json(SERVER_AOI, root / "aoi.geojson")
    settings = Settings(data_dir=str(data), aoi_path=str(root / "aoi.geojson"),
                        offline=True, weights_dir=str(state["work"] / "weights"),
                        tile_min_zoom=12, tile_max_zoom=13)
    app = create_app(settings, device="cuda")
    scene = root / "scene_1024.tif"
    synthetic_scene(scene, size=(VECTORS_SIDE, VECTORS_SIDE), seed=5)
    big_tif, big_aoi = write_planted_scene(root / "planted_large",
                                           VECTORS_LARGE, seed=2)
    with LiveServer(app) as srv:
        chunks0 = sum(e.chunks_dispatched for e in loaded_engines())
        rdb_mod.LAUNCHES = rdb_mod.LAUNCHES_I8 = 0
        t1 = time.perf_counter()
        wow = srv.poll("/api/sr/" + srv.json("POST", "/api/wow", {
            "input_file": str(scene)})["job_id"], timeout=600)
        wow_s = time.perf_counter() - t1
        launches = rdb_mod.LAUNCHES
        chunks = sum(e.chunks_dispatched for e in loaded_engines()) - chunks0
        n_rdb = next(3 * len(e.model.body) for e in loaded_engines()
                     if e.model_name == "realesrgan_x4"
                     and e.device.type == "cuda" and not e.quantized)
        if wow["status"] != "completed" or launches != n_rdb * chunks \
                or not chunks:
            raise AssertionError(f"/api/wow: {wow['status']}, {launches} rdb "
                                 f"launches for {chunks} chunks")
        state["main_launches"] = state.get("main_launches", 0) + launches
        t1 = time.perf_counter()
        found = srv.poll("/api/vectors/" + srv.json(
            "POST", "/api/vectors", {})["job_id"], timeout=600)
        found_s = time.perf_counter() - t1
        if found["status"] != "completed" or found["raster_paths"] != [
                wow["result"]["outputs"]["sr_tif"]]:
            raise AssertionError(f"/api/vectors after /api/wow: {found}")
        emit({"phase": "vectors", "route": "/api/wow then /api/vectors",
              "wow_seconds": wow_s, "rdb_launches": launches,
              "chunks": chunks, "vector_seconds": found_s,
              "raster": Path(found["raster_paths"][0]).name,
              "features": found["result"]["feature_count"],
              "source_method": found["result"]["source_method"],
              "card": card})

        def planted_job():
            job_id = srv.json("POST", "/api/vectors", {
                "raster_path": str(big_tif), "aoi_path": str(big_aoi)})["job_id"]
            rec = srv.poll(f"/api/vectors/{job_id}", timeout=600)
            if rec["status"] != "completed":
                raise AssertionError(f"/api/vectors 4096²: {rec['message']}")
            planted.append(rec)

        planted: list = []
        t1 = time.perf_counter()
        planted_job()                         # warm
        first_s = time.perf_counter() - t1
        prof = device_breakdown(planted_job)
        rec = planted[-1]
        passes = dict(ops.PASSES)
        meta = srv.json("GET", "/api/vectors/metadata")
        fields = srv.json("GET", "/vectors/fields.geojson")
        try:
            srv.request("GET", "/vectors/zones.geojson")
            raise AssertionError("/vectors/zones.geojson answered 200")
        except HTTPError as err:
            zones = (err.code, json.loads(err.read())["detail"])
        n = rec["result"]["feature_count"]
        if (n <= 0 or len(fields["features"]) != n
                or meta.get("featureCount") != n or not meta["vectorsAvailable"]
                or zones != (404, ZONES_404)):
            raise AssertionError(f"vector GETs: {n} features, "
                                 f"{len(fields['features'])} served, "
                                 f"metadata {meta.get('featureCount')}, "
                                 f"zones {zones}")
        timings = meta["metadata"]["stage_timings_s"]
        syncs = sum(-(-k // ops.CHECK_EVERY_CUDA) for k in passes.values())
        host = timings["polygonise"] + timings["cleanup"]
        emit({"phase": "vectors", "route": "/api/vectors 4096² planted",
              "profile": "POST to completed, warm", "features": n,
              "first_seconds": first_s, "seconds": prof["wall_ms"] / 1e3,
              "stage_timings_s": timings, "passes": passes,
              "check_every": ops.CHECK_EVERY_CUDA, "host_syncs": syncs,
              "device_idle_share": 1.0 - prof["device_busy_share"],
              "host_polygonise_share": host / (prof["wall_ms"] / 1e3),
              **prof, "card": card})
    split = vector_split(big_tif, big_aoi)
    emit({"phase": "vectors", "check": "segmentation stage split, 4096²",
          **split, "card": card})

    # (d) v2 (gradient watershed, k-means zones) on a 5-band planted
    # raster, card against CPU: the fields equal; the zones' k-means sums
    # run in another order on the card, so their labels are compared,
    # not required equal
    from s2sr_tpu_torch.vectors.extraction_v2 import (
        ExtractionConfigV2, extract_field_polygons_v2)

    tif5, aoi5 = write_planted_scene(root / "planted5", VECTORS_V2_SIDE,
                                     seed=3, bands=5)
    v2 = {}
    for dev in ("cuda", "cpu"):
        t1 = time.perf_counter()
        res = extract_field_polygons_v2(aoi5, tif5, root / f"v2_{dev}",
                                        ExtractionConfigV2(use_osm_roads=False),
                                        device=dev)
        zones = root / f"v2_{dev}" / "zones.geojson"
        v2[dev] = (res, time.perf_counter() - t1,
                   json.loads(zones.read_text())["features"]
                   if zones.exists() else [])
    same = (_geojson_sans_time(v2["cuda"][0]["geojson"])
            == _geojson_sans_time(v2["cpu"][0]["geojson"]))
    zones_same = v2["cuda"][2] == v2["cpu"][2]
    emit({"phase": "vectors", "check": "v2 fields.geojson, card vs CPU",
          "side": VECTORS_V2_SIDE, "features": v2["cuda"][0]["feature_count"],
          "equal": same, "zones": [len(v2["cuda"][2]), len(v2["cpu"][2])],
          "zones_equal": zones_same, "card_seconds": v2["cuda"][1],
          "cpu_seconds": v2["cpu"][1], "card": card})
    if not same or v2["cuda"][0]["feature_count"] <= 0:
        raise AssertionError(f"v2 card vs CPU: equal {same}, "
                             f"{v2['cuda'][0]['feature_count']} features")
    emit({"phase": "vectors", "seconds": round(time.perf_counter() - t0, 3)})


# --- the QR/serial scan: POST /api/decode's flow -----------------------------

DECODE_VERSIONS = (1, 5, 10, 25, 40)
DECODE_SCENE = (768, 1024)        # a phone photo scaled for upload
OCR_CONF_TOL = 1e-6
LOCATION_TOL = 1e-6
# data streams of the segment modes encode_qr does not pick itself:
# Kanji "あ", ECI 26 (UTF-8) + byte "HI", structured append + "PART-1"
QR_SEGMENTS = {
    "kanji": ("1000" + f"{1:08b}" + f"{288:013b}", "あ"),
    "eci": ("0111" + "00011010" + "0100" + f"{2:08b}"
            + "".join(f"{ord(c):08b}" for c in "HI"), "HI"),
    "structured_append": ("0011" + "0" * 16 + "0100" + f"{6:08b}"
                          + "".join(f"{b:08b}" for b in b"PART-1"), "PART-1"),
}


def qr_symbol(text: str, level: str, version: int, bits: str | None = None):
    """The port's encoder's symbol of ``text``, or of the raw data stream
    ``bits`` (any segment modes) wrapped as the encoder wraps its own:
    terminator, pad bytes, RS blocks, interleave, patterns, format, mask."""
    from unittest import mock

    from s2sr_tpu_torch.decode import qr_encode

    if bits is None:
        return qr_encode.encode_qr(text, level=level, version=version)
    with mock.patch.object(qr_encode, "_encoded_bits",
                           lambda *a: [int(c) for c in bits]):
        return qr_encode.encode_qr("x", level=level, version=version, mask=0)


def qr_payload(version: int, level: str) -> str:
    """An alphanumeric payload that fills about half of the symbol."""
    from s2sr_tpu_torch.decode.qr_tables import data_capacity

    n = max(4, (data_capacity(version, level) * 8 - 17) * 2 // 11 // 2)
    return (f"V{version}{level}-" + "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
            * 60)[:n]


def warp_perspective(img, corners, fill: int = 255):
    """``img`` warped so its corners land on ``corners`` (TL, TR, BR, BL),
    by an inverse homography sampled at pixel centres, nearest, ``fill``
    outside."""
    import numpy as np

    from s2sr_tpu_torch.decode.locate import _homography

    h, w = img.shape[:2]
    src = np.array([(0, 0), (w, 0), (w, h), (0, h)], np.float64)
    H = _homography(np.asarray(corners, np.float64), src)   # out → in
    yy, xx = np.mgrid[:h, :w] + 0.5
    p = H @ np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)])
    xs = np.floor(p[0] / p[2]).astype(int)
    ys = np.floor(p[1] / p[2]).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    out = np.full(h * w, fill, img.dtype)
    out[ok] = img[ys[ok], xs[ok]]
    return out.reshape(h, w)


def noisy_blur(img, seed: int, sigma: float = 10.0):
    """A 3×3 box blur and seeded Gaussian noise."""
    import numpy as np

    p = np.pad(img.astype(np.float32), 1, mode="edge")
    h, w = img.shape
    blur = sum(p[dy:dy + h, dx:dx + w] for dy in range(3)
               for dx in range(3)) / 9.0
    rng = np.random.default_rng(seed)
    return np.clip(blur + rng.normal(0, sigma, blur.shape), 0,
                   255).astype(np.uint8)


def qr_scene(code, seed: int):
    """A 1024×768 noisy RGB scene (a lit gradient with texture) with the
    code, pixel-repeated ×2, at an off-centre spot."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = DECODE_SCENE
    ramp = (np.linspace(70, 190, w)[None, :, None]
            + np.linspace(-20, 20, h)[:, None, None]) * np.array([1.0, 0.95, 0.85])
    scene = ramp + rng.normal(0, 9, (h, w, 3))
    big = np.kron(code, np.ones((2, 2), np.uint8)).astype(np.float64)
    y0, x0 = 180, 430
    scene[y0:y0 + big.shape[0], x0:x0 + big.shape[1]] = \
        big[..., None] * 0.85 + 20 + rng.normal(0, 6, big.shape + (3,))
    return np.clip(scene, 0, 255).astype(np.uint8)


def qr_cases() -> list:
    """(name, image, payload): versions 1, 5, 10, 25, 40 × levels L, M, Q,
    H; inverted, mirrored, rotated 90°, perspective and noisy-blurred
    variants of three of them; the segment-mode symbols; and one code in
    a 1024×768 noisy RGB scene."""
    import numpy as np

    from s2sr_tpu_torch.decode.qr_encode import render

    cases = []
    base = {}
    for v in DECODE_VERSIONS:
        for level in "LMQH":
            text = qr_payload(v, level)
            scale = {25: 5, 40: 4}.get(v) or max(4, min(8, 560 // (4 * v + 25)))
            img = render(qr_symbol(text, level, v), scale, 4)
            cases.append((f"v{v}-{level}", img, text))
            base[(v, level)] = (img, text)
    for v, level in ((5, "M"), (10, "Q"), (25, "H")):
        img, text = base[(v, level)]
        h, w = img.shape
        cases += [
            (f"v{v}-{level} inverted", 255 - img, text),
            (f"v{v}-{level} mirrored", np.ascontiguousarray(img[:, ::-1]), text),
            (f"v{v}-{level} rotated 90", np.ascontiguousarray(np.rot90(img)), text),
            (f"v{v}-{level} perspective", warp_perspective(img, [
                (0.03 * w, 0.02 * h), (0.98 * w, 0.05 * h),
                (0.95 * w, 0.97 * h), (0.01 * w, 0.94 * h)]), text),
            (f"v{v}-{level} noise+blur", noisy_blur(img, seed=v), text)]
    for name, (bits, text) in QR_SEGMENTS.items():
        cases.append((name, render(qr_symbol("", "M", 2, bits), 8, 4), text))
    code = render(qr_symbol("SN-KBTX-1234567", "M", 3), 4, 4)
    cases.append(("scene 1024x768", qr_scene(code, seed=5), "SN-KBTX-1234567"))
    return cases


def same_scan(got, want, path="") -> bool:
    """Equal results: dicts, lists and values; floats within 1e-6."""
    if isinstance(want, dict):
        return (isinstance(got, dict) and set(got) == set(want)
                and all(same_scan(got[k], want[k], f"{path}.{k}") for k in want))
    if isinstance(want, (list, tuple)):
        return (isinstance(got, (list, tuple)) and len(got) == len(want)
                and all(same_scan(g, w) for g, w in zip(got, want)))
    if isinstance(want, float):
        return abs(got - want) <= OCR_CONF_TOL
    return got == want


def as_json(obj):
    return json.loads(json.dumps(obj))


def binarized_differences(img) -> int:
    """Pixels where the card's bool maps differ from the CPU's at every
    scale ``decode_qr`` binarizes, in both pad modes."""
    from s2sr_tpu_torch.decode.locate import binarize

    diff = 0
    for s in (1, 2, 4):
        view = img[::s, ::s] if s > 1 else img
        if min(view.shape[:2]) < 21:
            break
        for mode in ("white", "edge"):
            diff += int((binarize(view, mode, device="cuda")
                         != binarize(view, mode, device="cpu")).sum())
    return diff


def upscale4(arr):
    import numpy as np

    return np.kron(arr, np.ones((4, 4, 1), np.uint8))


def phase_decode(state):
    """The QR/serial scan of ``/api/decode`` (``s2sr_tpu_torch.decode``)
    with binarization on the card: QR codes of every level at versions 1
    to 40 and their variants, decoded on the card and held to the CPU;
    the committed plates' OCR and scan flow held to the JAX package's
    recorded answers; the low-quality plate's SR retry on the card's
    full-width ``realesrgan_x4`` (rdb launches = 69 × chunks)."""
    import dataclasses

    import numpy as np
    import torch

    from s2sr_tpu_torch.decode.locate import _binarize_device, binarize
    from s2sr_tpu_torch.decode.ocr import ocr_image
    from s2sr_tpu_torch.decode.qr_decode import decode_qr
    from s2sr_tpu_torch.decode.service import decode_with_retry
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.pipelines.io import decode_upload

    card = state.get("card") or card_line()
    t0 = time.perf_counter()
    failures = []
    n_diff = 0
    for name, img, text in qr_cases():
        t1 = time.perf_counter()
        got = decode_qr(img, device="cuda")
        secs = time.perf_counter() - t1
        want = decode_qr(img, device="cpu")
        got_d = got and dataclasses.asdict(got)
        want_d = want and dataclasses.asdict(want)
        diff = binarized_differences(img)
        n_diff += diff
        ok = got is not None and got.text == text and \
            same_scan(as_json(got_d), as_json(want_d))
        line = {"phase": "decode", "qr": name, "shape": list(img.shape),
                "decoded": got is not None and got.text == text,
                "equal_to_cpu": ok, "binarized_differences": diff,
                "seconds": round(secs, 4)}
        if got is not None:
            line.update(version=got.version, ec_level=got.ec_level,
                        errors_corrected=got.errors_corrected,
                        inverted=got.inverted, mirrored=got.mirrored)
        if name.startswith("scene"):
            line["card"] = card
        emit(line)
        if not ok:
            failures.append(name)
    emit({"phase": "decode", "check": "binarized maps, card vs CPU",
          "differing_pixels": n_diff})
    if n_diff:
        emit({"phase": "decode", "why": "the card's threshold is the CPU's "
              "float32 additions in the same order; a difference means an "
              "operation rounded differently on the card"})
        failures.append(f"{n_diff} binarized pixels differ")

    # binarize alone at 1024×768 on the card (the device part and the
    # one copy back), warm
    scene = qr_scene(np.zeros((8, 8), np.uint8), seed=1)
    gray = scene.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)
    pad = torch.full((1024, 1024), 255.0, device="cuda")
    pad[:768, :] = torch.from_numpy(gray).cuda()
    dev_ms = time_cuda(lambda: _binarize_device(pad), iters=20)
    for _ in range(2):
        binarize(scene, device="cuda")
    t1 = time.perf_counter()
    for _ in range(10):
        binarize(scene, device="cuda")
    bin_s = (time.perf_counter() - t1) / 10
    emit({"phase": "decode", "binarize": "1024x768", "device_ms": dev_ms,
          "host_call_seconds": bin_s, "card": card})

    # the plates: OCR and the scan flow against the recorded JAX answers
    manifest = json.loads((FIXTURES / "fixtures.json").read_text())
    for name, rec in manifest.items():
        if "ocr" not in rec:
            continue
        img = decode_upload((FIXTURES / name).read_bytes(), name)
        t1 = time.perf_counter()
        ocr = as_json(ocr_image(img, device="cuda"))
        ocr_s = time.perf_counter() - t1
        flow = as_json(decode_with_retry(img, enhance_fn=upscale4,
                                         device="cuda"))
        flow0 = as_json(decode_with_retry(img, enhance_fn=None, device="cuda"))
        ok = (same_scan(ocr, rec["ocr"]) and same_scan(flow, rec["decode_upscale4"])
              and same_scan(flow0, rec["decode_no_retry"]))
        emit({"phase": "decode", "plate": name, "text": ocr["text"],
              "confidence": ocr["confidence"], "serial": flow["serial"],
              "equal_to_jax_record": ok, "ocr_seconds": round(ocr_s, 4),
              "card": card})
        if not ok:
            failures.append(name)

    # the SR retry on the card: the low-quality plate through the full-width
    # bf16 realesrgan_x4 (the route's engine), every RDB in rdb_tc_kernel
    eng = engine_mod.get_engine("realesrgan_x4",
                                weights_dir=str(state["work"] / "weights"),
                                device="cuda")
    plate = decode_upload((FIXTURES / "scan_plate_low_quality.png").read_bytes())
    eng.enhance_serving(plate)                          # warm
    torch.cuda.synchronize()
    chunks0 = eng.chunks_dispatched
    rdb_mod.LAUNCHES = 0
    t1 = time.perf_counter()
    out = decode_with_retry(plate, enhance_fn=eng.enhance_serving,
                            device="cuda")
    retry_s = time.perf_counter() - t1
    launches, chunks = rdb_mod.LAUNCHES, eng.chunks_dispatched - chunks0
    n_rdb = 3 * len(eng.model.body)
    emit({"phase": "decode", "retry": "scan_plate_low_quality.png",
          "shape": list(plate.shape), "seconds": round(retry_s, 4),
          "retried_with_enhancement": out["retried_with_enhancement"],
          "stages": [a["stage"] for a in out["attempts"]],
          "serial": out["serial"], "rdb_launches": launches, "chunks": chunks,
          "card": card})
    if not out["retried_with_enhancement"] or not chunks or \
            launches != n_rdb * chunks or len(eng.model.body) != 23:
        failures.append(f"retry: {launches} rdb launches for {chunks} chunks")
    state["main_launches"] = state.get("main_launches", 0) + launches
    emit({"phase": "decode", "seconds": round(time.perf_counter() - t0, 3)})
    if failures:
        raise AssertionError(f"decode: {failures}")


# --- the classic SR path (EDSR, ESPCN, LapSRN), sr_cli, warmup ------------

CLASSIC_SCENE = 512            # the GeoTIFF each classic model upscales
CLASSIC_BUCKET = (576, 432)    # masked bucket (576×448) vs unpadded
CLASSIC_CPU_SIDE = 64          # float32 models card vs CPU
CLASSIC_F32_TOL = 1e-5         # of max |out|: card vs CPU, converters
CLASSIC_UPLOADS = ((100, 90), (120, 64), (64, 64), (128, 128), (70, 128),
                   (100, 90), (64, 64), (128, 100))   # 3 buckets
# per input pixel: head, 2·32 body convs, body conv, the upsample convs
# at their resolutions, the tail at the output's (MACs; ×2 for FLOP)
EDSR_MACS = {4: 9 * (3 * 256 + 66 * 256 * 256 + 256 * 1024
                     + 4 * 256 * 1024 + 16 * 256 * 3),
             3: 9 * (3 * 256 + 66 * 256 * 256 + 256 * 2304 + 9 * 256 * 3),
             2: 9 * (3 * 256 + 66 * 256 * 256 + 256 * 1024 + 4 * 256 * 3)}


def _pb_varint(v: int) -> bytes:
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _pb_field(num: int, wire: int, payload) -> bytes:
    key = _pb_varint((num << 3) | wire)
    if wire == 0:
        return key + _pb_varint(payload)
    if wire == 5:
        return key + payload
    return key + _pb_varint(len(payload)) + payload


class GraphWriter:
    """A frozen TF GraphDef written from its protobuf wire format, wired
    as the released EDSR / ESPCN / LapSRN graphs are (Conv2D + BiasAdd,
    DepthToSpace, Conv2DBackpropInput, Relu / LeakyRelu / Tanh, Add,
    Sub), for the ``.pb`` converters and the graph executor."""

    def __init__(self, seed: int):
        import numpy as np

        self.rng = np.random.default_rng(seed)
        self.parts = [self._node("x", "Placeholder",
                                 attrs=self._attr("dtype", _pb_field(6, 0, 1)))]
        self.n = 0

    @staticmethod
    def _attr(key: str, value: bytes) -> bytes:
        return _pb_field(5, 2, _pb_field(1, 2, key.encode())
                         + _pb_field(2, 2, value))

    def _node(self, name, op, inputs=(), attrs=b""):
        body = _pb_field(1, 2, name.encode()) + _pb_field(2, 2, op.encode())
        for i in inputs:
            body += _pb_field(3, 2, i.encode())
        return _pb_field(1, 2, body + attrs)

    def _name(self, prefix):
        self.n += 1
        return f"{prefix}_{self.n}"

    def const(self, arr, prefix="c"):
        import numpy as np

        arr = np.asarray(arr)
        dtype, raw = ((3, arr.astype("<i4")) if arr.dtype.kind == "i"
                      else (1, arr.astype("<f4")))
        shape = b"".join(_pb_field(2, 2, _pb_field(1, 0, s))
                         for s in arr.shape)
        tensor = (_pb_field(1, 0, dtype) + _pb_field(2, 2, shape)
                  + _pb_field(4, 2, raw.tobytes()))
        name = self._name(prefix)
        self.parts.append(self._node(
            name, "Const", attrs=self._attr("value", _pb_field(8, 2, tensor))))
        return name

    def _op(self, op, inputs, attrs=b""):
        name = self._name(op.lower())
        t = self._attr("T", _pb_field(6, 0, 1))
        self.parts.append(self._node(name, op, inputs, attrs + t))
        return name

    def _conv_attrs(self, stride=1):
        strides = b"".join(_pb_field(3, 0, s) for s in (1, stride, stride, 1))
        return (self._attr("padding", _pb_field(2, 2, b"SAME"))
                + self._attr("strides", _pb_field(1, 2, strides)))

    def weight(self, *shape, gain=1.0):
        import numpy as np

        fan_in = int(np.prod(shape[:-1]))
        return (self.rng.standard_normal(shape) * gain
                * np.sqrt(1.0 / fan_in)).astype(np.float32)

    def conv(self, inp, kh, cin, cout, gain=1.0):
        w = self.const(self.weight(kh, kh, cin, cout, gain=gain), "w")
        c = self._op("Conv2D", [inp, w], self._conv_attrs())
        b = self.const(self.rng.standard_normal(cout).astype("f4") * 0.05, "b")
        return self._op("BiasAdd", [c, b])

    def tconv(self, inp, c, out_shape):
        import numpy as np

        oshape = self.const(np.asarray(out_shape, np.int32), "os")
        w = self.const(self.weight(4, 4, c, c), "tw")
        return self._op("Conv2DBackpropInput", [oshape, w, inp],
                        self._conv_attrs(2))

    def unary(self, op, inp, alpha=None):
        import struct

        attrs = b"" if alpha is None else self._attr(
            "alpha", _pb_field(4, 5, struct.pack("<f", alpha)))
        return self._op(op, [inp], attrs)

    def binary(self, op, a, b):
        return self._op(op, [a, b])

    def d2s(self, inp, block):
        return self._op("DepthToSpace", [inp], self._attr(
            "block_size", _pb_field(3, 0, block)))

    def write(self, path: Path) -> Path:
        path.write_bytes(b"".join(self.parts))
        return path


def edsr_graph(path: Path, feat: int, blocks: int, scale: int) -> Path:
    """EDSR as the Saafke graphs wire it: x − mean, head, residual blocks,
    body conv + skip, the depth-to-space stages, tail + mean."""
    import numpy as np

    g = GraphWriter(seed=scale)
    mean = g.const(np.float32([114.444, 111.4605, 103.02]), "mean")
    head = g.conv(g.binary("Sub", "x", mean), 3, 3, feat)
    cur = head
    for _ in range(blocks):
        r = g.unary("Relu", g.conv(cur, 3, feat, feat))
        cur = g.binary("Add", cur, g.conv(r, 3, feat, feat, gain=0.1))
    cur = g.binary("Add", head, g.conv(cur, 3, feat, feat))
    s = scale
    while s > 1:
        f = 3 if s == 3 else 2
        cur = g.d2s(g.conv(cur, 3, feat, feat * f * f), f)
        s //= f
    g.binary("Add", g.conv(cur, 3, feat, 3), mean)
    return g.write(path)


def espcn_graph(path: Path, scale: int) -> Path:
    """The released luma ESPCN: 5×5/64, tanh, 3×3/32, tanh, 3×3/s²,
    depth-to-space."""
    g = GraphWriter(seed=10 + scale)
    t = g.unary("Tanh", g.conv("x", 5, 1, 64))
    t = g.unary("Tanh", g.conv(t, 3, 64, 32))
    g.d2s(g.conv(t, 3, 32, scale * scale), scale)
    return g.write(path)


def lapsrn_graph(path: Path, scale: int, hw, feat: int = 64,
                 depth: int = 5) -> Path:
    """The released luma LapSRN for an input of ``hw`` (its transposed
    convs carry their output shapes): per ×2 level the embeddings, the
    feature and image transposed convs and the residual."""
    import numpy as np

    g = GraphWriter(seed=20 + scale)
    fcur = g.unary("LeakyRelu", g.conv("x", 3, 1, feat), alpha=0.2)
    icur, size = "x", np.array(hw)
    for _ in range(int(np.log2(scale))):
        e = fcur
        for _ in range(depth):
            e = g.unary("LeakyRelu", g.conv(e, 3, feat, feat), alpha=0.2)
        size = size * 2
        fcur = g.tconv(e, feat, [1, int(size[0]), int(size[1]), feat])
        res = g.conv(fcur, 3, feat, 1)
        iup = g.tconv(icur, 1, [1, int(size[0]), int(size[1]), 1])
        icur = g.binary("Add", iup, res)
    return g.write(path)


def _classic_weights_dir(state) -> Path:
    """An empty ``weights_dir`` for the classic models (seeded random init
    until a phase drops a ``.pb`` there), through the environment the
    settings read."""
    from s2sr_tpu_torch.config import settings as settings_mod
    from s2sr_tpu_torch.pipelines import super_resolution as sr

    wdir = state["work"] / "classic_weights"
    wdir.mkdir(exist_ok=True)
    os.environ["WEIGHTS_DIR"] = str(wdir)
    settings_mod.get_settings.cache_clear()
    sr._MODEL_CACHE.clear()
    return wdir


def classic_scene_run(tif: Path, out: Path, model: str, scale: int,
                      card: str, label: str) -> None:
    """``process_sentinel2_sr`` on the card, cold then warm; the warm
    seconds (host clock, ending in ``synchronize``), MPix/s of input, the
    output checked (shape, finite uint8, PNG twin equal to the GeoTIFF)."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.geo import read_geotiff
    from s2sr_tpu_torch.pipelines.super_resolution import process_sentinel2_sr
    from s2sr_tpu_torch.tiles.png import decode_png

    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        result = process_sentinel2_sr(tif, out, scale=scale, model=model,
                                      device="cuda")
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t1)
    meta = result["sr_metadata"]
    side = CLASSIC_SCENE * scale
    sr_tif = read_geotiff(result["outputs"]["sr_tif"]).data
    png = decode_png(Path(result["outputs"]["sr_png"]).read_bytes())
    if sr_tif.shape != (side, side, 3) or sr_tif.dtype != np.uint8 or \
            not np.array_equal(sr_tif, png) or meta["output_size"] != [side, side]:
        raise AssertionError(f"classic {label}: output {sr_tif.shape} "
                             f"{meta}")
    stage = meta["timing"]["stages"][0]["seconds"]
    emit({"phase": "classic", "scene": f"{CLASSIC_SCENE}^2", "model": label,
           "cold_seconds": round(runs[0], 4), "seconds": round(runs[1], 4),
           "mpix_per_s": CLASSIC_SCENE ** 2 / runs[1] / 1e6,
           "sr_stage_seconds": stage,
           "sr_stage_mpix_per_s": CLASSIC_SCENE ** 2 / stage / 1e6,
           "output_mean": float(sr_tif.mean()), "card": card})


def classic_forward_ms(model, c: int) -> dict:
    """One warm forward at the scene's size, CUDA events: as served
    (PyTorch's own convs) and, for the record of what the pin costs, with
    cuDNN's choice (``invariant_convs`` bypassed for this timing only)."""
    import contextlib

    import torch

    from s2sr_tpu_torch.models import classic

    x = torch.rand(1, CLASSIC_SCENE, CLASSIC_SCENE, c, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    ms = time_cuda(lambda: model(x), iters=3, warmup=1)
    pinned = classic.invariant_convs
    classic.invariant_convs = lambda device, dtype: contextlib.nullcontext()
    try:
        cudnn_ms = time_cuda(lambda: model(x), iters=3, warmup=1)
    finally:
        classic.invariant_convs = pinned
    return {"forward_ms": ms, "cudnn_forward_ms": cudnn_ms}


# the classic models' conv layers, by model: (label, dtype, cin, cout,
# kernel, transposed, the input side as a multiple of the model input)
CLASSIC_CONVS = (
    ("edsr head", "bfloat16", 3, 256, 3, False, 1),
    ("edsr body", "bfloat16", 256, 256, 3, False, 1),
    ("edsr up1", "bfloat16", 256, 1024, 3, False, 1),
    ("edsr up2", "bfloat16", 256, 1024, 3, False, 2),
    ("edsr tail x4", "bfloat16", 256, 3, 3, False, 4),
    ("espcn conv1", "float32", 3, 64, 5, False, 1),
    ("espcn luma conv1", "float32", 1, 64, 5, False, 1),
    ("espcn conv2", "float32", 64, 32, 3, False, 1),
    ("espcn conv3", "float32", 32, 48, 3, False, 1),
    ("lapsrn head", "float32", 1, 64, 3, False, 1),
    ("lapsrn embed L1", "float32", 64, 64, 3, False, 1),
    ("lapsrn embed L3", "float32", 64, 64, 3, False, 4),
    ("lapsrn up_feat L1", "float32", 64, 64, 4, True, 1),
    ("lapsrn up_feat L3", "float32", 64, 64, 4, True, 4),
    ("lapsrn res L3", "float32", 64, 1, 3, False, 8),
    ("lapsrn up_img L3", "float32", 1, 1, 4, True, 4),
)


def classic_conv_invariance(card: str) -> dict:
    """Each classic conv layer alone on the card, under cuDNN's default
    choice, cuDNN restricted to deterministic algorithms, and PyTorch's
    own CUDA convolution: the values that differ between the unpadded
    576×432 input and its zero-padded 576×448 bucket (on the unpadded
    region), and between image 0 of a batch of 5 at 128² and the same
    image alone (and of a batch of 2 at 64²); and its ms at 576×432. A
    conv whose count is not 0 breaks the bucket's or the batch's equality
    with single serving: the models run PyTorch's own convolutions
    (``utils/precision.py::invariant_convs``, mode "native" here), and
    this says why and at what cost."""
    import contextlib

    import torch
    import torch.nn.functional as F

    from s2sr_tpu_torch.models.classic import _layout
    from s2sr_tpu_torch.utils.precision import ieee_fp32

    modes = {"default": contextlib.nullcontext,
             "deterministic": lambda: torch.backends.cudnn.flags(
                 enabled=True, benchmark=False, deterministic=True),
             "native": lambda: torch.backends.cudnn.flags(enabled=False)}
    g = torch.Generator("cuda").manual_seed(5)
    out = {}
    for label, dt, cin, cout, k, transposed, mult in CLASSIC_CONVS:
        dtype = getattr(torch, dt)
        w = torch.randn(cin if transposed else cout, cout if transposed
                        else cin, k, k, device="cuda", generator=g,
                        dtype=torch.float32).to(dtype) * (1.0 / (k * k * cin)) ** 0.5

        def op(x):
            x = _layout(x)
            if transposed:
                return F.conv_transpose2d(x, w, stride=2)
            return F.conv2d(x, w, padding=k // 2)

        h, wd = (CLASSIC_BUCKET[0] * mult, CLASSIC_BUCKET[1] * mult)
        hb, wb = h, -(-CLASSIC_BUCKET[1] // 64) * 64 * mult
        s = 2 if transposed else 1
        x = torch.rand(1, cin, h, wd, device="cuda", generator=g).to(dtype)
        xb = torch.rand(5, cin, 128 * mult, 128 * mult, device="cuda",
                        generator=g).to(dtype)
        xb2 = torch.rand(2, cin, 64 * mult, 64 * mult, device="cuda",
                         generator=g).to(dtype)
        row = {}
        for mode, ctx in modes.items():
            with ctx(), ieee_fp32():
                a = op(x)
                b = op(F.pad(x, (0, wb - wd, 0, hb - h)))
                bucket = int((a != b[..., :a.shape[2], :a.shape[3]]).sum())
                del a, b
                batch = {}
                for n, xs in ((5, xb), (2, xb2)):
                    many, one = op(xs)[:1], op(xs[:1])
                    batch[n] = int((many != one).sum())
                ms = time_cuda(lambda: op(x), iters=3, warmup=1)
            row[mode] = {"bucket": bucket, "batch_5x128": batch[5],
                         "batch_2x64": batch[2], "ms": ms}
            torch.cuda.empty_cache()
        out[label] = row
    emit({"phase": "classic", "check": "conv invariance by layer",
          "bucket": [list(CLASSIC_BUCKET), [CLASSIC_BUCKET[0], -(-CLASSIC_BUCKET[1] // 64) * 64]],
          "differing_values": out, "card": card})
    return out


def check_classic_bucket(models: dict, card: str) -> dict:
    """The masked 64-multiple bucket against the unpadded forward at
    576×432, model output compared bit for bit (float32 models under IEEE
    float32, EDSR in bf16): the count of differing values, 0 required."""
    import torch
    import torch.nn.functional as F

    h, w = CLASSIC_BUCKET
    hb, wb = -(-h // 64) * 64, -(-w // 64) * 64
    diffs = {}
    for label, model in models.items():
        g = torch.Generator("cuda").manual_seed(1)
        x = torch.rand(1, h, w, model.num_ch, device="cuda", generator=g)
        want = model(x)
        mask = torch.zeros(1, hb, wb, 1, device="cuda")
        mask[:, :h, :w] = 1
        got = model(F.pad(x, (0, 0, 0, wb - w, 0, hb - h)), mask)
        s = model.scale
        diffs[label] = int((got[:, :h * s, :w * s] != want).sum())
        del want, got
        torch.cuda.empty_cache()
    emit({"phase": "classic", "check": "masked bucket vs unpadded",
          "shape": [h, w], "bucket": [hb, wb], "differing_values": diffs,
          "card": card})
    return diffs


def check_classic_cpu(models: dict, card: str) -> dict:
    """The float32 models at 64² on the card against the same weights on
    the CPU: max |card − CPU| over the CPU output's largest magnitude."""
    import copy

    import torch

    errs = {}
    for label, model in models.items():
        if model.dtype != torch.float32:
            continue
        g = torch.Generator().manual_seed(2)
        x = torch.rand(1, CLASSIC_CPU_SIDE, CLASSIC_CPU_SIDE, model.num_ch,
                       generator=g)
        want = copy.deepcopy(model).cpu()(x)
        got = model(x.cuda()).cpu()
        errs[label] = float((got - want).abs().max() / want.abs().max())
    emit({"phase": "classic", "check": "card vs CPU", "side": CLASSIC_CPU_SIDE,
          "rel_err": errs, "tol": CLASSIC_F32_TOL, "card": card})
    return errs


def check_classic_converters(graphs: dict, card: str) -> dict:
    """Each ``.pb`` converter's model on the card against
    ``execute_graphdef`` on the card over the same file (EDSR in float32,
    in the graph's 255 domain): max |model − graph| over max |graph|."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.models import pb_reader
    from s2sr_tpu_torch.models.classic import EDSR, ESPCN, LapSRN
    from s2sr_tpu_torch.models.graph_executor import execute_graphdef
    from s2sr_tpu_torch.models.weights import params_from_jax_classic

    errs = {}
    for label, (path, family, scale, hw) in graphs.items():
        rng = np.random.default_rng(3)
        mean = None
        if family == "edsr":
            tree, cfg = pb_reader.convert_edsr_pb(path, scale)
            mean = cfg["mean"]
            model = EDSR(scale, num_feat=cfg["channels"],
                         num_blocks=cfg["blocks"], dtype=torch.float32)
            x = (rng.random((1, *hw, 3)) * 255).astype(np.float32)
            x_in, out_scale = x / 255.0, 255.0
        else:
            tree = getattr(pb_reader, f"convert_{family}_pb")(path, scale)
            model = (ESPCN(scale, num_ch=1) if family == "espcn" else
                     LapSRN(scale, num_ch=1))
            x = rng.random((1, *hw, 1)).astype(np.float32)
            x_in, out_scale = x, 1.0
        model.load_state_dict(params_from_jax_classic(tree, family, mean=mean))
        model = model.cuda().eval()
        want = execute_graphdef(path, {"x": x}, device="cuda")
        got = model(torch.from_numpy(x_in).cuda()) * out_scale
        if got.shape != want.shape:
            raise AssertionError(f"converter {label}: {got.shape} vs "
                                 f"{want.shape}")
        errs[label] = float((got - want).abs().max() / want.abs().max())
    emit({"phase": "classic", "check": "converters vs execute_graphdef",
          "rel_err": errs, "tol": CLASSIC_F32_TOL, "card": card})
    return errs


def check_classic_many(models: dict, card: str) -> dict:
    """``run_classic_sr_many`` over 8 mixed-size uploads (3 buckets, one
    on the grid) against ``run_classic_sr`` one at a time: byte-equal."""
    import numpy as np

    from s2sr_tpu_torch.pipelines.super_resolution import (
        run_classic_sr, run_classic_sr_many)

    rng = np.random.default_rng(4)
    ups = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
           for h, w in CLASSIC_UPLOADS]
    equal = {}
    for label, model in models.items():
        many = run_classic_sr_many(model, ups)
        singles = [run_classic_sr(model, up) for up in ups]
        equal[label] = all(
            a.shape == (h * model.scale, w * model.scale, 3)
            and np.array_equal(a, b)
            for a, b, (h, w) in zip(many, singles, CLASSIC_UPLOADS))
    emit({"phase": "classic", "check": "run_classic_sr_many vs single",
          "uploads": len(ups), "buckets": 3, "byte_equal": equal,
          "card": card})
    return equal


def run_cli(args: list, cwd: Path, env: dict, timeout: int) -> tuple:
    """A ``python -m`` CLI of the port in a child process: (seconds,
    stdout). Raises with its output if it fails."""
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t1
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return secs, proc.stdout


def child_env(**extra) -> dict:
    root = Path(__file__).resolve().parent
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root), *filter(None, [env.get("PYTHONPATH")])])
    return env


def phase_classic(state):
    """The classic SR path on the card: ``process_sentinel2_sr`` on a 512²
    GeoTIFF through the full-width registry models (``edsr_x4``/``x3``/
    ``x2`` bf16, ``espcn_x4``) and the luma ``espcn_x4`` / ``lapsrn_x8``
    from ``.pb`` graphs; the masked bucket against the unpadded forward;
    the float32 models card vs CPU; the converters against the card's
    graph executor; batched serving against single; ``sr_cli`` in modes
    edsr and realesrgan with ``--tile`` in a child process."""
    import shutil

    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_scene
    from s2sr_tpu_torch.pipelines.super_resolution import create_sr_model

    t0 = time.perf_counter()
    card = state.get("card") or card_line()
    work = state["work"] / "classic"
    work.mkdir()
    wdir = _classic_weights_dir(state)
    tif = work / "scene.tif"
    synthetic_scene(tif, size=(CLASSIC_SCENE, CLASSIC_SCENE), seed=3)
    failures = []

    models = {}
    for model, scale in (("edsr", 4), ("edsr", 3), ("edsr", 2),
                         ("espcn", 4)):
        label = f"{model}_x{scale}"
        classic_scene_run(tif, work / label, model, scale, card, label)
        net = models[label] = create_sr_model(model, scale, device="cuda")
        want = (torch.bfloat16, 256, 32) if model == "edsr" else \
            (torch.float32, None, None)
        got = (net.dtype, getattr(net, "num_feat", None),
               getattr(net, "num_blocks", None))
        if got != want or net.num_ch != 3:
            failures.append(f"{label}: {got}, {net.num_ch} channels")
        fwd = classic_forward_ms(net, 3)
        emit({"phase": "classic", "model": label, **fwd,
              "tflops": (2 * EDSR_MACS[scale] * CLASSIC_SCENE ** 2
                         / fwd["forward_ms"] / 1e9
                         if model == "edsr" else None),
              "card": card})

    graphs = {"edsr_x4": (edsr_graph(work / "edsr_x4.pb", 64, 4, 4),
                          "edsr", 4, (48, 40)),
              "espcn_x4": (espcn_graph(work / "espcn_x4.pb", 4), "espcn", 4,
                           (48, 40)),
              "lapsrn_x8": (lapsrn_graph(work / "lapsrn_x8.pb", 8, (48, 40)),
                            "lapsrn", 8, (48, 40))}
    conv_errs = check_classic_converters(graphs, card)
    failures += [f"converter {k}: {v}" for k, v in conv_errs.items()
                 if not v <= CLASSIC_F32_TOL]

    # the released luma graphs dropped in weights_dir: the pipeline
    # converts them and runs the YCrCb luma path
    for label, model, scale in (("espcn_x4", "espcn", 4),
                                ("lapsrn_x8", "lapsrn", 8)):
        shutil.copy(graphs[label][0], wdir / f"{label}.pb")
        classic_scene_run(tif, work / f"{label}_luma", model, scale, card,
                          f"{label}_luma")
        net = models[f"{label}_luma"] = create_sr_model(model, scale,
                                                       device="cuda")
        if net.num_ch != 1 or net.dtype != torch.float32:
            failures.append(f"{label}_luma: {net.num_ch} channels")
        emit({"phase": "classic", "model": f"{label}_luma",
              **classic_forward_ms(net, 1), "card": card})

    classic_conv_invariance(card)
    diffs = check_classic_bucket(models, card)
    failures += [f"bucket {k}: {v} values differ" for k, v in diffs.items()
                 if v]
    cpu_errs = check_classic_cpu(models, card)
    failures += [f"card vs CPU {k}: {v}" for k, v in cpu_errs.items()
                 if not v <= CLASSIC_F32_TOL]
    equal = check_classic_many({k: models[k] for k in
                                ("edsr_x4", "espcn_x4", "espcn_x4_luma",
                                 "lapsrn_x8_luma")}, card)
    failures += [f"many {k}" for k, v in equal.items() if not v]

    # the CLI in a child process: EDSR (classic) and the WOW path, tiled
    env = child_env(WEIGHTS_DIR=str(work / "cli_weights"))
    for mode in ("edsr", "realesrgan"):
        secs, out = run_cli(
            ["s2sr_tpu_torch.cli.sr_cli", str(tif), "-o", f"cli_{mode}",
             "--mode", mode, "--tile", "--min-zoom", "12", "--max-zoom",
             "14"], work, env, timeout=300)
        tiles = list((work / f"cli_{mode}" / "tiles").rglob("*.png"))
        emit({"phase": "classic", "cli": f"sr_cli --mode {mode} --tile",
              "seconds": round(secs, 3), "tiles": len(tiles),
              "stdout_tail": out.strip().splitlines()[-2:], "card": card})
        if "SR complete" not in out or not tiles:
            failures.append(f"sr_cli {mode}: {out[-500:]}")
    emit({"phase": "classic", "seconds": round(time.perf_counter() - t0, 3)})
    if failures:
        raise AssertionError(f"classic: {failures}")


def phase_warmup(state):
    """``cli.warmup --models realesrgan_x4,swinir_x4`` in a child process
    on an empty build directory (every library built), then again on the
    same directory (every library cached): the cold and warm seconds, the
    build seconds per library, and the rdb / swin_block launches of each
    run (counted by the child, whose counts start at 0)."""
    import re

    card = state.get("card") or card_line()
    build = state["work"] / "warmup_build"
    work = state["work"] / "warmup"
    work.mkdir()
    env = child_env(S2SR_TORCH_BUILD_DIR=str(build))
    total = {"rdb": 0, "swin_block": 0}
    for run in ("cold", "warm"):
        secs, out = run_cli(["s2sr_tpu_torch.cli.warmup", "--models",
                             "realesrgan_x4,swinir_x4"], work, env,
                            timeout=600)
        libs = {name: (how, float(secs_)) for how, name, secs_ in re.findall(
            r"^\s*(built|cached) (\S+) in ([0-9.]+)s$", out, re.M)}
        launches = {k: int(v) for k, v in re.findall(
            r"(\w+) (\d+)", out.split("kernel launches: ")[1].splitlines()[0])}
        warmed = [ln.strip() for ln in out.splitlines() if "warmed" in ln]
        emit({"phase": "warmup", "run": run, "seconds": round(secs, 3),
              "libraries": {k: {"state": v[0], "seconds": v[1]}
                            for k, v in libs.items()},
              "launches": launches, "warmed": warmed, "card": card})
        want = "built" if run == "cold" else "cached"
        if len(libs) != len(KERNEL_SOURCES) + 1 or any(
                v[0] != want for k, v in libs.items() if k != "pngenc"):
            raise AssertionError(f"warmup {run}: libraries {libs}")
        if not launches["rdb"] or not launches["swin_block"]:
            raise AssertionError(f"warmup {run}: launches {launches}")
        for k in total:
            total[k] += launches[k]
    state["warmup_launches"] = total


# --- training: cli.train at full width, resume, serving what was trained ---

# The full-width trainer's shape (realesrgan_x4: 23 blocks, 64/32) and
# swinir_x4's (SwinIR-M)
TRAIN_RRDB = ["--blocks", "23", "--feat", "64", "--grow", "32",
              "--batch", "16", "--crop", "48", "--chunk", "32",
              "--steps", "64", "--pool", "48"]
TRAIN_SWIN = ["--family", "swinir", "--embed-dim", "180",
              "--depths", "6,6,6,6,6,6", "--heads", "6,6,6,6,6,6",
              "--window", "8", "--batch", "16", "--crop", "48",
              "--chunk", "4", "--steps", "8", "--pool", "8"]
TRAIN_DEGRADE = ["--blur-sigma", "1.0", "--noise-std", "0.01",
                 "--jpeg", "30,95"]
# One forward of RRDBNet-23 ×4 per LR pixel: 69 RDBs, conv_first and
# conv_body at 1×, the phase-split up-convs at 1× and 2×, conv_hr and
# conv_last at 4×
RRDB_FWD_FLOP_PER_PIXEL = (69 * RDB_FLOP_PER_PIXEL + 2 * 9 * 3 * 64
                           + 2 * 9 * 64 * 64 + 5 * 2 * 9 * 64 * 256
                           + 16 * 2 * 9 * 64 * 64 + 16 * 2 * 9 * 64 * 3)

# Save at step 4 of 8, resume, run to 8, against an unbroken run, under
# torch's deterministic algorithms (warnings name any op without one);
# one JSON line
RESUME_CHILD = r"""
import json, sys, warnings
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.benchmark = False
from s2sr_tpu_torch.models.weights import tree_flatten
from s2sr_tpu_torch.training.checkpoint import CheckpointManager
from s2sr_tpu_torch.training.train import (TrainConfig, init_training,
    make_chunked_train_step, make_pool_sampler, restore_flexible)
cfg = TrainConfig(num_block=2, lr_decay_steps=8, ema_decay=0.999)
g = torch.Generator().manual_seed(0)
pool = torch.rand(4, 192, 192, 3, generator=g).cuda()
sample = make_pool_sampler(4, 32, 4, blur_sigma=1.0, noise_std=0.01,
                           jpeg_range=(30.0, 95.0))
gen = torch.Generator(device="cuda").manual_seed(0)
lr, hr = (torch.stack(t) for t in zip(*[sample(pool, gen) for _ in range(8)]))
run, _ = make_chunked_train_step(cfg)
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    p0, o0 = init_training(cfg, seed=0, device="cuda")
    pa, oa, la = run(p0, o0, lr, hr)
    pb, ob, lb1 = run(p0, o0, lr[:4], hr[:4])
    mgr = CheckpointManager(sys.argv[1])
    mgr.save(4, pb, ob)
    pb, ob, step, ok = restore_flexible(mgr, cfg, device="cuda")
    pb, ob, lb2 = run(pb, ob, lr[4:], hr[4:])
    torch.cuda.synchronize()
lb = torch.cat([lb1, lb2])
pairs = [(la, lb)] + [
    (x, y) for a, b in ((pa, pb), (oa.mu, ob.mu), (oa.nu, ob.nu),
                        (oa.ema, ob.ema))
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0])]
rel = max(float((x.float() - y.float()).abs().max()
                / y.float().abs().max().clamp_min(1e-30)) for x, y in pairs)
print(json.dumps({
    "restored_step": step, "opt_restored": ok,
    "bit_equal": all(torch.equal(x, y) for x, y in pairs),
    "max_rel_diff": rel, "losses_unbroken": la.tolist(),
    "losses_resumed": lb.tolist(),
    "nondeterministic_ops": sorted({str(w.message)[:160] for w in caught
                                    if "deterministic" in str(w.message)})}))
"""


def train_cli(args: list, work: Path, label: str, card: str) -> dict:
    """``cli.train`` in a child process on the card: its steady steps/s,
    peak device memory and every step's loss (``--loss-log``)."""
    import re

    import numpy as np

    log = work / f"{label}.losses"
    secs, out = run_cli(["s2sr_tpu_torch.cli.train", *args,
                         "--ckpt-dir", str(work / label),
                         "--loss-log", str(log)], work, child_env(),
                        timeout=900)
    losses = [float(v) for v in log.read_text().split()]
    rates = re.findall(r"\(([0-9.]+) steps/s\)", out)
    peak = int(re.search(r"peak device memory: (\d+) bytes", out).group(1))
    head = next(ln for ln in out.splitlines() if ln.startswith("training:"))
    rec = {"phase": "train", "run": label, "seconds": round(secs, 3),
           "config": head, "steps": len(losses),
           "steps_per_s": float(rates[-1]) if rates else None,
           "peak_memory_bytes": peak, "first_losses": losses[:4],
           "last_losses": losses[-4:], "card": card}
    emit(rec)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {label}: a loss is not finite")
    rec["losses"] = losses
    return rec


def phase_train(state):
    """Training on the card (``s2sr_tpu_torch.training``, no kernel of
    its own: cuDNN's convolutions and PyTorch's autograd, as JAX training
    runs XLA's): (1) one float32 step of a 2-block 64/32 model on the card
    against the same step on the CPU, then four full-width steps under
    ``torch.profiler``; (2) ``cli.train`` at full width
    (23 blocks, 64/32, ×4, batch 16, LR crop 48, bf16, the device
    pipeline, chunk 32, 64 steps on the synthetic pool) with remat and the
    blur/noise/JPEG degradations, and without remat: loss finite and the
    mean of the last 16 losses below that of the first 16, steps/s and
    peak memory; (3) SwinIR at swinir_x4's width, 8 steps; (4) save,
    resume and run on against an unbroken run under deterministic
    algorithms (bit-equal, or the ops without one named and the runs held
    within 1e-6); (5) the remat run's checkpoint exported by
    ``convert_weights --from-ckpt`` and served by ``SREngine`` on
    ``realesrgan_x4``, its RDBs in the ``rdb`` kernel (launches counted),
    held within the bf16 tolerance of ``rrdbnet_apply`` on the same
    weights, and ``cli.evaluate`` on its output."""
    import json as _json

    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.models.engine import SREngine
    from s2sr_tpu_torch.models.rrdbnet import rrdbnet_apply
    from s2sr_tpu_torch.models.weights import (load_npz_tree, tree_flatten,
                                               tree_to_torch, tree_unflatten)
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.tiles.png import encode_png
    from s2sr_tpu_torch.training.train import (TrainConfig, init_training,
                                               make_device_pool_train_step,
                                               make_train_step)

    card = state.get("card") or card_line()
    work = state["work"] / "train"
    work.mkdir()

    # (1) float32: card against CPU, one step
    cfg = TrainConfig(num_block=2, dtype="float32", learning_rate=1e-4)
    params, opt = init_training(cfg, seed=0, device="cpu")
    hr = np.stack([synthetic_fields((64, 64), seed=s) for s in (1, 2)])
    hr = torch.from_numpy(hr.astype(np.float32) / 255.0)
    lr = hr.reshape(2, 16, 4, 16, 4, 3).mean((2, 4))
    step, _ = make_train_step(cfg)
    p_cpu, _, l_cpu = step(params, opt, lr, hr)
    to_card = [t.cuda() for t in tree_flatten(params)[0]]
    p_card, _, l_card = step(tree_unflatten(tree_flatten(params)[1], to_card),
                             opt.to("cuda"), lr.cuda(), hr.cuda())
    loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    p_err = max(float((a.cpu() - b).abs().max()) for a, b in
                zip(tree_flatten(p_card)[0], tree_flatten(p_cpu)[0]))
    emit({"phase": "train", "check": "float32 step card vs CPU",
          "model": "2 blocks, 64/32, x4", "batch": [2, 16, 16],
          "loss_cpu": float(l_cpu), "loss_rel_err": loss_rel,
          "params_max_abs_err": p_err, "tol": 1e-5, "card": card})
    if not (loss_rel <= 1e-5 and p_err <= 1e-5):
        raise AssertionError(f"float32 step: loss {loss_rel}, params {p_err}")

    # where a full-width step's time goes: 4 warm steps in this process
    # (cuDNN's benchmark mode, as the CLI sets it) under torch.profiler
    bench0 = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    cfg = TrainConfig(remat=True, lr_decay_steps=64)
    params, opt = init_training(cfg, seed=0, device="cuda")
    pool = torch.from_numpy(np.stack([
        synthetic_fields((384, 384), seed=1 + i) for i in range(8)
    ]).astype(np.float32) / 255.0).cuda()
    run, _ = make_device_pool_train_step(cfg, 48, 16, 4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state_ = {"p": params, "o": opt}

    def steps():
        state_["p"], state_["o"], _ = run(state_["p"], state_["o"], pool, gen)

    steps()
    prof = device_breakdown(steps, top=6)
    torch.backends.cudnn.benchmark = bench0
    emit({"phase": "train", "check": "full-width step under the profiler",
          "steps": 4, "step_ms": prof["wall_ms"] / 4,
          "device_ms_per_step": prof["device_ms"] / 4,
          "device_busy_share": prof["device_busy_share"],
          "kernel_launches_per_step": prof["launches"] / 4,
          "top": prof["top"], "card": card})
    del state_, pool

    # (2) full width
    full = {}
    for label, extra in (("remat_degrade", ["--remat", *TRAIN_DEGRADE]),
                         ("no_remat", ["--no-remat"])):
        rec = full[label] = train_cli(TRAIN_RRDB + extra, work, label, card)
        losses = rec["losses"]
        first, last = np.mean(losses[:16]), np.mean(losses[-16:])
        flop = 16 * 48 * 48 * RRDB_FWD_FLOP_PER_PIXEL * (
            4 if label.startswith("remat") else 3)
        emit({"phase": "train", "run": label, "mean_first_16": first,
              "mean_last_16": last, "step_tflop": flop / 1e12,
              "step_ms": (1e3 / rec["steps_per_s"]
                          if rec["steps_per_s"] else None),
              "bound_ms": flop / PEAK_BF16_FLOPS * 1e3, "card": card})
        if not (len(losses) == 64 and last < first):
            raise AssertionError(f"train {label}: loss did not fall "
                                 f"({first} → {last})")

    # (3) SwinIR at swinir_x4's width
    swin = train_cli(TRAIN_SWIN, work, "swinir_x4", card)
    if swin["steps"] != 8:
        raise AssertionError(f"swinir: {swin['steps']} steps")

    # (4) resume against an unbroken run, deterministic algorithms
    env = child_env(CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, "-c", RESUME_CHILD,
                          str(work / "resume")], cwd=work, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"resume child failed: {out.stderr[-3000:]}")
    res = _json.loads(out.stdout.strip().splitlines()[-1])
    emit({"phase": "train", "check": "resume at 4 of 8 vs unbroken",
          **res, "card": card})
    if not (res["restored_step"] == 4 and res["opt_restored"]
            and (res["bit_equal"] or (res["nondeterministic_ops"]
                                      and res["max_rel_diff"] <= 1e-6))):
        raise AssertionError(f"resume: {res}")

    # (5) serve what was trained
    wdir = work / "weights"
    secs, out = run_cli(["s2sr_tpu_torch.cli.convert_weights", "--from-ckpt",
                         str(work / "remat_degrade"), "--model-name",
                         "realesrgan_x4", "-o",
                         str(wdir / "realesrgan_x4.npz")], work, child_env(),
                        timeout=300)
    scene = synthetic_fields((128, 128), seed=77)
    small = scene.reshape(32, 4, 32, 4, 3).mean((1, 3)).round().astype(
        np.uint8)
    rdb_mod.LAUNCHES = 0
    eng = SREngine("realesrgan_x4", weights_dir=str(wdir), device="cuda")
    sr = eng.enhance(small)
    torch.cuda.synchronize()
    launches = rdb_mod.LAUNCHES
    state["train_launches"] = launches
    if not (eng.pretrained and launches >= 69 and sr.shape == scene.shape):
        raise AssertionError(f"serving the trained weights: pretrained "
                             f"{eng.pretrained}, rdb launches {launches}, "
                             f"shape {sr.shape}")
    x = torch.from_numpy(small).float().cuda()[None] / 255.0
    tree = tree_to_torch(load_npz_tree(wdir / "realesrgan_x4.npz"), "cuda")
    with torch.no_grad():
        got = eng.model(x)
        want = rrdbnet_apply(tree, x, scale=4, dtype=torch.bfloat16)
    rdb_mod.LAUNCHES = launches
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    (work / "sr.png").write_bytes(encode_png(sr))
    (work / "hr.png").write_bytes(encode_png(scene))
    _, ev = run_cli(["s2sr_tpu_torch.cli.evaluate", str(work / "sr.png"),
                     str(work / "hr.png")], work, child_env(), timeout=300)
    emit({"phase": "train", "check": "trained weights served",
          "export_seconds": round(secs, 3), "rdb_launches": launches,
          "pretrained": eng.pretrained, "kernel_vs_rrdbnet_apply_rel": rel,
          "tol_bf16": 0.1, "evaluate_sr_vs_hr": _json.loads(
              ev.strip().splitlines()[-1]), "card": card})
    if not (np.isfinite(scale) and rel <= 0.1):
        raise AssertionError(f"served model vs rrdbnet_apply: {rel}")
    state["train"] = {"full": {k: {kk: v[kk] for kk in (
        "steps_per_s", "peak_memory_bytes")} for k, v in full.items()},
        "swinir": {kk: swin[kk] for kk in ("steps_per_s",
                                            "peak_memory_bytes")}}


# --- SwinIR: swin_block and window_attention ------------------------------

# Per token of one Swin block (C 180, 6 heads of 30, 64-token windows,
# MLP 360): qkv 2·180·540, proj 2·180·180, fc1 and fc2 2·180·360 each,
# QKᵀ and PV 2·64·180 each
SWIN_FLOP_PER_TOKEN = {
    "swin_block": 2 * (180 * 540 + 180 * 180 + 2 * 180 * 360)
    + 2 * 2 * 64 * 180,
    "window_attention": 2 * (180 * 540 + 180 * 180) + 2 * 2 * 64 * 180,
}
SWIN_WEIGHTS = {"swin_block": 180 * 540 + 180 * 180 + 2 * 180 * 360,
                "window_attention": 180 * 540 + 180 * 180}
SWIN_REPLACES = {
    "swin_block": "s2sr_tpu/ops/pallas/window_attention.py:338",
    "window_attention": "s2sr_tpu/ops/pallas/window_attention.py:385",
}
SWIN_BLOCKS = 36
# Full swinir_x4 in bf16 against fp32, relative to the largest output:
# the plain model on the CPU sits 0.012–0.015 from fp32 (both levels)
# and the attn level 0.015–0.022 from the block level (measured on
# 40×56 with chip_smoke's weights when written)
SWIN_BF16_TOL = 0.05


def swin_kernels() -> dict:
    """name → (wrapper, plain version, whether it holds the MLP)."""
    from s2sr_tpu_torch.ops import window_attention as wa

    return {"swin_block": (wa.swin_block, wa.swin_block_reference, True),
            "window_attention": (wa.window_attention,
                                 wa.window_attention_reference, False)}


def swin_inputs(shape, dtype, shift: int, seed: int = 0, device="cuda"):
    """Input and tables (in ``dtype`` and in fp32) of one Swin block.

    Block-style weights (tests/test_window_attention.py's scales, bias
    table ×5, MLP 0.03) and x of scale 0.05: attention moves the output
    by 0.36–0.59 and the whole block by 0.74–0.79, while |out| stays
    under 1, where a bf16 ulp is ≤ 2⁻⁸ (the plain versions on the CPU at
    (1, 24, 32))."""
    import torch

    from s2sr_tpu_torch.ops import window_attention as wa

    g = torch.Generator().manual_seed(seed)

    def n(*size, s=1.0):
        return torch.randn(*size, generator=g) * s

    c, hid = 180, 360
    p = {"norm1.weight": 1 + n(c, s=0.1), "norm1.bias": n(c, s=0.05),
         "attn.qkv.weight": n(3 * c, c, s=0.05), "attn.qkv.bias": n(3 * c, s=0.02),
         "attn.proj.weight": n(c, c, s=0.05), "attn.proj.bias": n(c, s=0.02),
         "attn.relative_position_bias_table": n(225, 6, s=0.5),
         "norm2.weight": 1 + n(c, s=0.1), "norm2.bias": n(c, s=0.05),
         "mlp.fc1.weight": n(hid, c, s=0.03), "mlp.fc1.bias": n(hid, s=0.02),
         "mlp.fc2.weight": n(c, hid, s=0.03), "mlp.fc2.bias": n(c, s=0.02)}
    x = (n(*shape, c) * 0.05).to(dtype).to(device)
    t = wa.tables_to(wa.build_block_tables(p, 6, 8, shift, dtype), device)
    t32 = wa.tables_to(wa.build_block_tables(p, 6, 8, shift, torch.float32),
                       device)
    return x, t, t32


def swin_faults(t: dict, mlp: bool) -> dict:
    """Tables whose plain version computes what a faulty kernel would:
    the shift mask dropped, every window given mask type 0 (interior,
    all zeros, so it equals the dropped mask) or type 3 (corner), the
    relative-position bias dropped, heads 0 and 1 given each other's q,
    k and v columns (a packer or fragment offset off by one head), and
    (whole block) the MLP dropped."""
    import torch

    out = {}
    cols = 3 * t["dp"]
    perm = torch.arange(t["wqkv"].shape[1], device=t["wqkv"].device)
    perm[:2 * cols] = torch.cat([perm[cols:2 * cols], perm[:cols]])
    out["heads_0_1_swapped"] = {**t, "wqkv": t["wqkv"][:, perm].contiguous(),
                                "bqkv": t["bqkv"][perm].contiguous()}
    if t["shift"]:
        out["mask_dropped"] = {**t, "masks": torch.zeros_like(t["masks"])}
        for k in (0, 3):
            out[f"mask_type{k}"] = {**t, "masks": t["masks"][k:k + 1]
                                    .expand(4, -1, -1).contiguous()}
    out["bias_dropped"] = {**t, "bias": torch.zeros_like(t["bias"])}
    if mlp:
        out["mlp_dropped"] = {**t, "w2": torch.zeros_like(t["w2"]),
                              "bf2": torch.zeros_like(t["bf2"])}
    return out


def swin_bound_ms(name: str, shape, dtype) -> tuple:
    """Least time for one launch on the H100: the larger of its FLOPs at
    the dtype's dense peak and its bytes (x and out once, the weights,
    the bias table and masks)."""
    import torch

    bsz, h, w = shape
    tokens = bsz * h * w
    item = 2 if dtype == torch.bfloat16 else 4
    flops = SWIN_FLOP_PER_TOKEN[name] * tokens
    nbytes = (2 * tokens * 180 * item + SWIN_WEIGHTS[name] * item
              + (6 + 4) * 64 * 64 * 4)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


@ieee_phase
def phase_swin_kernel(state):
    import torch

    from s2sr_tpu_torch.ops import _build
    from s2sr_tpu_torch.ops import window_attention as wa

    # The error is max |kernel − plain| over the kernel's own change to
    # its input: max |out − x| of the fp32 plain version for swin_block,
    # max |y| for window_attention (which adds no residual). fp32: the
    # two sum the same products in other orders. bf16: both round at the
    # same places, so only a near-tie rounded apart differs (the plain
    # bf16 version sits 0.006 of the change from the fp32 one on the
    # CPU). Each case also holds the kernel further than the tolerance
    # from the plain version with each planted fault (0.45–1.03 of the
    # change on the CPU at (1, 24, 32); the head swap 0.63–0.87).
    tol = {torch.float32: 1e-4, torch.bfloat16: 0.05}
    grids = [(1, 24, 32), (2, 40, 72), (1, 512, 512)]
    launches0 = dict(wa.LAUNCHES)
    failures = []
    worst = {}
    t0 = time.perf_counter()
    sass = sass_counts(_build.lib_path("window_attention"))
    emit({"phase": "swin_kernel", "sass": sass})
    tc = [c for k, c in sass.items() if "swin_tc_kernel" in k]
    if len(tc) != 2 or any(c["HMMA"] == 0 for c in tc):
        raise AssertionError(f"a bf16 Swin kernel issues no HMMA: {sass}")
    for name, (fn, ref, mlp) in swin_kernels().items():
        for dtype in (torch.float32, torch.bfloat16):
            tiling = wa.kernel_tiling(dtype, mlp)
            emit({"phase": "swin_kernel", "kernel": name, "dtype": str(dtype),
                  **tiling})
            for grid in grids:
                for shift in (0, 4):
                    x, t, t32 = swin_inputs(grid, dtype, shift)
                    got = fn(x, t).float()
                    torch.cuda.synchronize()
                    want32 = ref(x.float(), t32)
                    change = ((want32 - x.float()) if mlp else want32) \
                        .abs().max().item()
                    err = (got - ref(x, t).float()).abs().max().item()
                    rel = err / change
                    faults = {k: (got - ref(x, f).float()).abs().max().item()
                              / change
                              for k, f in swin_faults(t, mlp).items()}
                    finite = bool(torch.isfinite(got).all().item())
                    emit({"phase": "swin_kernel", "kernel": name,
                          "dtype": str(dtype), "shape": [*grid, 180],
                          "shift": shift, "max_abs_err": err,
                          "max_change": change, "rel_err": rel,
                          "tolerance": tol[dtype],
                          "rel_err_vs_planted_fault": faults,
                          "finite": finite})
                    case = f"{name} {dtype} {grid} shift {shift}"
                    if not finite or not rel <= tol[dtype]:
                        failures.append(f"{case}: rel err {rel} over "
                                        f"{tol[dtype]}")
                    if not min(faults.values()) > tol[dtype]:
                        failures.append(f"{case}: a planted fault is within "
                                        f"tolerance {faults}")
                    if dtype == torch.bfloat16:
                        a, r = worst.get(name, (0.0, 0.0))
                        worst[name] = (max(a, err), max(r, rel))
                    del x, t, t32, got, want32
                    torch.cuda.empty_cache()
    # comparison launches are not main-path launches
    wa.LAUNCHES.update(launches0)
    if failures:
        raise AssertionError("swin kernels vs plain:\n" + "\n".join(failures))
    state["swin_err"] = worst
    emit({"phase": "swin_kernel", "seconds": round(time.perf_counter() - t0, 3)})


def at_level(level: str, fn):
    """``fn()`` with SwinIR's ``FUSED_LEVEL`` set to ``level``, as
    ``S2SR_SWINIR_FUSED_LEVEL`` would set it."""
    from s2sr_tpu_torch.models import swinir as swin_mod

    old = swin_mod.FUSED_LEVEL
    swin_mod.FUSED_LEVEL = level
    try:
        return fn()
    finally:
        swin_mod.FUSED_LEVEL = old


def check_swin_against_plain(eng) -> dict:
    """The main path's SwinIR at full width, with the kernels on the card
    (fp32 and bf16, both fused levels), against the same weights in fp32
    on the CPU, where every block runs its plain version, relative to
    the reference's largest output. The random init's Linear weights
    (std 0.02) barely move the output, so here they and the bias tables
    are scaled ×5: the 36 blocks then change the output by a multiple of
    the tolerance. Two exact-path images: 40×56 (window multiples) and
    37×53 (reflect-padded)."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.models.swinir import SwinIR

    kw = {"scale": eng.model.scale, "embed_dim": 180, "depths": (6,) * 6,
          "num_heads": (6,) * 6, "window_size": 8}
    sd = {k: v.detach().cpu() * (5 if k.endswith(
              ("qkv.weight", "proj.weight", "fc1.weight", "fc2.weight",
               "bias_table")) else 1)
          for k, v in eng.model.state_dict().items()}

    def net(dtype, device):
        m = SwinIR(**kw, dtype=dtype)
        m.load_state_dict(sd)
        return m.to(device).eval().pack()

    # fp32: 36 blocks and ~20 convs summing in other orders; bf16: see
    # SWIN_BF16_TOL. Zeroing every block's proj and fc2 moves the output
    # by 0.84 of its largest value on the CPU, so a lost block shows.
    tol32, tolbf = 1e-3, SWIN_BF16_TOL
    res = {}
    m32, mbf = net(torch.float32, "cuda"), net(torch.bfloat16, "cuda")
    ref_model = net(torch.float32, "cpu")
    blockless = net(torch.float32, "cpu")
    for b in blockless.blocks():
        b.tables["wo"].zero_()
        b.tables["w2"].zero_()
        b.tables["bf2"].zero_()
    for i, (h, w) in enumerate(((40, 56), (37, 53))):
        x = torch.from_numpy(synthetic_fields((h, w), seed=20 + i)
                             ).float()[None] / 255.0
        ref = ref_model(x)
        scale = ref.abs().max().item()
        trunk = (blockless(x) - ref).abs().max().item() / scale
        outs = {"fp32": m32(x.cuda()), "bf16": mbf(x.cuda()),
                "bf16_attn": at_level("attn", lambda: mbf(x.cuda()))}
        rels = {k: (o.cpu() - ref).abs().max().item() / scale
                for k, o in outs.items()}
        emit({"phase": "swin_main", "check": "full swinir_x4 vs fp32 plain "
              "on CPU", "image": [h, w], "ref_max_abs": scale,
              "rel_change_without_blocks": trunk, "rel_err": rels,
              "tol_fp32": tol32, "tol_bf16": tolbf})
        if not (rels["fp32"] <= tol32 and rels["bf16"] <= tolbf
                and rels["bf16_attn"] <= tolbf and np.isfinite(scale)
                and trunk > 5 * tolbf):
            raise AssertionError(f"full SwinIR disagrees with the plain "
                                 f"path at {h}x{w}: {rels}, blocks move "
                                 f"the output by {trunk}")
        for k, v in rels.items():
            res[k] = max(res.get(k, 0.0), v)
    return res


def phase_swin_main(state):
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields, synthetic_scene
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.ops import window_attention as wa
    from s2sr_tpu_torch.pipelines.wow_sr import process_wow_sr
    from s2sr_tpu_torch.tiles.png import decode_png

    t0 = time.perf_counter()
    work = state["work"]
    weights = str(work / "weights")              # empty: random init
    eng = engine_mod.get_engine("swinir_x4", weights_dir=weights,
                                device="cuda")
    blocks = eng.model.blocks()
    if (eng.dtype != torch.bfloat16 or len(blocks) != SWIN_BLOCKS
            or eng.model.conv_first.out_channels != 180
            or {(b.heads, b.window) for b in blocks} != {(6, 8)}):
        raise AssertionError("main path must be full-width bf16 swinir_x4")

    # the plain versions must not run on the card in this phase
    plain = {"swin_block_reference": wa.swin_block_reference,
             "window_attention_reference": wa.window_attention_reference}

    def guard(name):
        def refuse(x, t):
            if x.is_cuda:
                raise AssertionError(f"{name} ran on the card on the main path")
            return plain[name](x, t)
        return refuse

    for name in plain:
        setattr(wa, name, guard(name))
    try:
        for k in wa.LAUNCHES:
            wa.LAUNCHES[k] = 0
        forwards = 0
        # 1. process_wow_sr on a 512×384 scene: the exact path, one forward
        tif = work / "swin_exact_512x384.tif"
        synthetic_scene(tif, size=(512, 384), seed=4)
        chunks0 = eng.chunks_dispatched
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        result = process_wow_sr(tif, work / "out_swin", model="swinir_x4",
                                weights_dir=weights, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        forwards += 1
        meta = result["sr_metadata"]
        png = decode_png(Path(result["outputs"]["sr_png"]).read_bytes())
        if (png.shape != (2048, 1536, 3) or meta["output_size"] != [2048, 1536]
                or meta["precision"] != "bfloat16"
                or eng.chunks_dispatched != chunks0
                or wa.LAUNCHES["swin_block"] != SWIN_BLOCKS):
            raise AssertionError(f"swin exact 512x384: png {png.shape}, "
                                 f"meta {meta}, launches {wa.LAUNCHES}")
        stages = {s["name"]: s["seconds"] for s in meta["timing"]["stages"]}
        emit({"phase": "swin_main", "scene": "exact_512x384",
              "swin_block_launches": wa.LAUNCHES["swin_block"],
              "seconds": round(secs, 3), "stages": stages,
              "png_mean": float(png.mean())})

        # 2. the halo-tiled engine path: 600×520 → 9 windows of 288²
        eng_t = engine_mod.get_engine("swinir_x4", weights_dir=weights,
                                      device="cuda", exact_area=0)
        img = synthetic_fields((600, 520), seed=5)
        wins = eng_t._serving_parts(img)[0]
        before, chunks0 = wa.LAUNCHES["swin_block"], eng_t.chunks_dispatched
        t1 = time.perf_counter()
        out = eng_t.enhance_serving(img)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        chunks = eng_t.chunks_dispatched - chunks0
        launches = wa.LAUNCHES["swin_block"] - before
        forwards += chunks
        if (wins.shape != (9, 288, 288, 3) or out.shape != (2400, 2080, 3)
                or launches != SWIN_BLOCKS * chunks or chunks == 0):
            raise AssertionError(f"swin tiled 600x520: windows {wins.shape}, "
                                 f"out {out.shape}, {launches} launches for "
                                 f"{chunks} chunks")
        emit({"phase": "swin_main", "scene": "tiled_600x520",
              "windows": list(wins.shape), "chunks": chunks,
              "swin_block_launches": launches, "seconds": round(secs, 3),
              "out_mean": float(out.mean())})

        # 3. a 3×5 upload: the reflect pad to 8×8 passes both sides
        up = np.random.default_rng(6).integers(0, 256, (3, 5, 3)).astype(
            np.uint8)
        before = wa.LAUNCHES["swin_block"]
        out = eng.enhance_serving(up)
        forwards += 1
        if (out.shape != (12, 20, 3) or out.dtype != np.uint8
                or wa.LAUNCHES["swin_block"] - before != SWIN_BLOCKS):
            raise AssertionError(f"3x5 upload: {out.shape} {out.dtype}")
        emit({"phase": "swin_main", "scene": "upload_3x5",
              "out_shape": list(out.shape), "out_mean": float(out.mean())})

        # 4. S2SR_SWINIR_FUSED_LEVEL=attn: one forward on the attention
        # kernel, against the block-kernel forward
        x = torch.from_numpy(synthetic_fields((64, 48), seed=7)).cuda() \
            .float()[None] / 255.0
        before = dict(wa.LAUNCHES)
        out_b = eng.model(x)
        out_a = at_level("attn", lambda: eng.model(x))
        torch.cuda.synchronize()
        forwards += 1
        d_block = wa.LAUNCHES["swin_block"] - before["swin_block"]
        d_attn = wa.LAUNCHES["window_attention"] - before["window_attention"]
        rel = ((out_a - out_b).abs().max() / out_b.abs().max()).item()
        emit({"phase": "swin_main", "check": "attn level vs block level",
              "image": [64, 48], "rel_diff": rel, "tol": SWIN_BF16_TOL,
              "swin_block_launches": d_block,
              "window_attention_launches": d_attn})
        if (d_block != SWIN_BLOCKS or d_attn != SWIN_BLOCKS
                or not rel <= SWIN_BF16_TOL):
            raise AssertionError(f"attn level: launches {d_block}/{d_attn}, "
                                 f"rel diff {rel}")
        torch.cuda.synchronize()
        main_launches = dict(wa.LAUNCHES)
    finally:
        for name, fn in plain.items():
            setattr(wa, name, fn)
    if main_launches["swin_block"] != SWIN_BLOCKS * forwards:
        raise AssertionError(f"{main_launches} swin_block launches for "
                             f"{forwards} block-level forwards")
    state["swin_launches"] = main_launches
    state["swin_engine"] = eng
    state["swin_model_rel_err"] = check_swin_against_plain(eng)
    wa.LAUNCHES.update(main_launches)
    emit({"phase": "swin_main", "seconds": round(time.perf_counter() - t0, 3)})


# SwinIR's exact path at its large sizes: the strip tail engages above
# TAIL_STRIP_AREA (1280²), and SWINIR_EXACT_AREA (2560²) is the largest
# exact image
SWIN_LARGE_SIDES = (2048, 2560)


def phase_swin_large(state):
    """Exact ``enhance_serving`` of 2048² and 2560² images on the
    full-width bf16 ``swinir_x4`` engine: one forward each (36
    ``swin_block`` launches, no chunk), its seconds and peak device
    memory; then, on the 2048² image's trunk features, the strip tail
    against the whole tail."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.models import swinir as swin_mod
    from s2sr_tpu_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    eng = state.get("swin_engine") or engine_mod.get_engine(
        "swinir_x4", weights_dir=str(state["work"] / "weights"),
        device="cuda")
    model = eng.model
    launches0 = dict(wa.LAUNCHES)
    captured, failures = {}, []
    strips = model._tail_strips

    def capture(feat):
        out = strips(feat)
        captured["feat"], captured["strips"] = feat, out
        return out

    for side in SWIN_LARGE_SIDES:
        if side * side > eng.engage_area:
            raise AssertionError(f"{side}² is not on the exact path")
        img = synthetic_fields((side, side), seed=30)
        wa.LAUNCHES["swin_block"] = 0
        chunks0 = eng.chunks_dispatched
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model._tail_strips = capture
        try:
            t1 = time.perf_counter()
            out = eng.enhance_serving(img)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
        finally:
            del model._tail_strips
        peak = torch.cuda.max_memory_allocated()
        launches = wa.LAUNCHES["swin_block"]
        trunk = side * side > swin_mod.TAIL_STRIP_AREA
        emit({"phase": "swin_large", "card": state.get("card"),
              "image": [side, side], "out_shape": list(out.shape),
              "swin_block_launches": launches,
              "chunks_dispatched_delta": eng.chunks_dispatched - chunks0,
              "strip_tail": "strips" in captured, "seconds": secs,
              "peak_memory_bytes": peak, "out_mean": float(out.mean())})
        if (out.shape != (4 * side, 4 * side, 3) or out.dtype != np.uint8
                or launches != SWIN_BLOCKS or eng.chunks_dispatched != chunks0
                or ("strips" in captured) != trunk):
            raise AssertionError(f"swin exact {side}²: out {out.shape}, "
                                 f"{launches} launches, chunks "
                                 f"{eng.chunks_dispatched - chunks0}")
        del out
        if side == SWIN_LARGE_SIDES[0]:
            # The strip tail against the whole tail on the same features
            # (bit-equal on the CPU, tests/test_torch_swinir.py). Held on
            # the card: at most 1% of values apart, each by at most one
            # bf16 ulp of the output's largest value (2⁻⁷ of it). Printed
            # beside it: whether the whole tail repeats itself bit for bit,
            # and each tail conv alone on the first strip's rows against the
            # same conv on the whole map (cuDNN picks an algorithm by shape).
            feat, got = captured.pop("feat"), captured.pop("strips")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                want = model._tail(feat)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            with torch.no_grad():
                repeats = bool(torch.equal(model._tail(feat), want))
            differ = got != want
            share = differ.float().mean().item()
            diff = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            per_conv = tail_conv_shares(model, feat)
            emit({"phase": "swin_large", "check": "strip tail vs whole tail",
                  "trunk": list(feat.shape), "out": list(want.shape),
                  "byte_equal": bool(torch.equal(got, want)),
                  "share_differing": share, "tol_share": 0.01,
                  "max_abs_diff": diff, "max_abs_out": scale,
                  "tol_abs": 2.0 ** -7 * scale,
                  "whole_tail_repeats_bit_for_bit": repeats,
                  "share_differing_per_conv_strip_vs_whole": per_conv,
                  "peak_memory_bytes_whole_tail": peak})
            if (got.shape != want.shape or share > 0.01
                    or diff > 2.0 ** -7 * scale):
                failures.append(f"strip tail differs from the whole tail: "
                                f"{share} of values, up to {diff}")
            del feat, got, want, differ
        captured.clear()
        torch.cuda.empty_cache()
    wa.LAUNCHES.update(launches0)
    if failures:
        raise AssertionError("; ".join(failures))
    emit({"phase": "swin_large", "seconds": round(time.perf_counter() - t0, 3)})


def tail_conv_shares(model, feat) -> dict:
    """Each conv of SwinIR's tail, on its whole-map input (the tail run
    layer by layer on ``feat``), applied to the first strip's rows and to
    the whole map: per conv, the share of the strip's output rows (all but
    its last, which sees the strip's own zero padding) that differ."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    from s2sr_tpu_torch.models import swinir as swin_mod

    rows = swin_mod.TAIL_STRIP + 2 * swin_mod._TAIL_PAD
    layers = ([("conv_before_upsample", model.conv_before_upsample[0])]
              + [(f"upsample.{i}", m) for i, m in enumerate(model.upsample)]
              + [("conv_last", model.conv_last)])
    out, x = {}, feat
    with torch.no_grad():
        for name, m in layers:
            if isinstance(m, nn.PixelShuffle):
                x = F.pixel_shuffle(x, m.upscale_factor)
                rows *= m.upscale_factor
                continue
            whole = swin_mod._conv(x, m, model.dtype)
            strip = swin_mod._conv(x[:, :, :rows], m, model.dtype)
            out[name] = (whole[:, :, :rows - 1] != strip[:, :, :rows - 1]
                         ).float().mean().item()
            del strip
            x = (F.leaky_relu(whole, 0.01) if name == "conv_before_upsample"
                 else whole)
            del whole
    return out


def l2_copy_rate() -> float:
    """Bytes per second, read plus written, that ``Tensor.copy_`` moves
    between two 8 MiB bf16 tensors kept in the 50 MB L2: 20 copies in a
    CUDA graph (no launch gaps), replayed warm, CUDA events. A lower bound
    on the L2's rate, at which the run prices the Swin kernels' table
    reads."""
    import torch

    src = torch.ones(4 << 20, dtype=torch.bfloat16, device="cuda")
    dst = torch.empty_like(src)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dst.copy_(src)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            dst.copy_(src)
    ms = time_cuda(graph.replay, iters=10, warmup=2) / 20
    return 2 * src.numel() * 2 / (ms * 1e-3)


def swin_l2_bytes(name: str, shape, dtype) -> int:
    """Bytes a launch reads from L2 for its tables, per window: the
    matrices as the kernel reads them (bf16 fragments with K padded; the
    fp32 matrices), the bias of every head and the window's mask."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.ops import window_attention as wa

    bsz, h, w = shape
    windows = bsz * (h // 8) * (w // 8)
    keys = ("wqkv", "wo") + (("w1", "w2") if name == "swin_block" else ())
    if dtype == torch.bfloat16:
        mats = sum(int(np.prod(wa._MMA_SHAPES[k + "_mma"])) * 2 for k in keys)
    else:
        mats = sum(int(np.prod(wa._TABLE_SHAPES[k])) * 4 for k in keys)
    return windows * (mats + (6 + 1) * 64 * 64 * 4)


def phase_swin_numbers(state):
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    card = state.get("card") or card_line()
    launches0 = dict(wa.LAUNCHES)
    shape, dtype = (1, 512, 512), torch.bfloat16
    l2_rate = l2_copy_rate()
    emit({"phase": "swin_numbers", "card": card,
          "l2_bytes_per_s_copy_8MiB": l2_rate})
    numbers = {}
    for name, (fn, ref, mlp) in swin_kernels().items():
        per_shift = {}
        for shift in (0, 4):
            x, t, _ = swin_inputs(shape, dtype, shift)
            per_shift[shift] = (time_cuda(lambda: fn(x, t), iters=10),
                                time_cuda(lambda: ref(x, t), iters=5))
            del x, t
        # the main path runs both shifts equally often
        ms = sum(v[0] for v in per_shift.values()) / 2
        plain_ms = sum(v[1] for v in per_shift.values()) / 2
        bound_ms, bound_by = swin_bound_ms(name, shape, dtype)
        numbers[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        tiling = wa.kernel_tiling(dtype, mlp)
        tokens = int(np.prod(shape))
        l2 = swin_l2_bytes(name, shape, dtype)
        emit({"phase": "swin_numbers", "card": card, "kernel": name,
              "shape": [*shape, 180], "dtype": "bfloat16",
              "ms_by_shift": {s: v[0] for s, v in per_shift.items()},
              "plain_ms_by_shift": {s: v[1] for s, v in per_shift.items()},
              **numbers[name],
              "tflops_useful": SWIN_FLOP_PER_TOKEN[name] * tokens / ms / 1e9,
              "tflops_executed": 2 * tiling["macs_per_window"] * tokens / 64
              / ms / 1e9,
              "blocks_per_sm": tiling["blocks_per_sm"],
              "smem_bytes": tiling["smem_bytes"],
              "l2_table_bytes_per_launch": l2,
              "l2_table_ms_at_copy_rate": l2 / l2_rate * 1e3,
              "l2_table_bytes_per_s_in_kernel": l2 / (ms * 1e-3)})
        torch.cuda.empty_cache()
    wa.LAUNCHES.update(launches0)
    # warm 512² exact enhance_serving
    eng = state.get("swin_engine") or engine_mod.get_engine(
        "swinir_x4", weights_dir=str(state["work"] / "weights"),
        device="cuda")
    img = synthetic_fields((512, 512), seed=3)
    eng.enhance_serving(img)
    torch.cuda.synchronize()
    reps = []
    for _ in range(2):
        t1 = time.perf_counter()
        eng.enhance_serving(img)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t1)
    emit({"phase": "swin_numbers", "card": card, "sr_512_seconds": reps,
          "sr_512_mpix_per_s": 512 * 512 / min(reps) / 1e6})
    emit({"phase": "swin_numbers", "card": card,
          "profile": "one warm 512² swinir_x4 enhance_serving",
          **device_breakdown(lambda: eng.enhance_serving(img))})
    wa.LAUNCHES.update(launches0)
    state["swin_numbers"] = numbers
    emit({"phase": "swin_numbers",
          "seconds": round(time.perf_counter() - t0, 3)})


# --- the RDB ablation ladder: rdb_v1, rdb_v2 and rdb_v3 --------------------

LADDER_REPLACES = {"v1": "s2sr_tpu/ops/pallas/fused_rdb.py:219",
                   "v2": "s2sr_tpu/ops/pallas/fused_rdb.py:472",
                   "v3": "s2sr_tpu/ops/pallas/fused_rdb.py:673"}
# the ladder at the main path's chunk shape: chains of 12 per variant,
# one untimed and two timed
LADDER_SHAPE, LADDER_CHAIN, LADDER_RUNS = (16, 264, 264), 12, 2


def on_flat_weights(fn, rung: str):
    """A rung's wrapper ``fn(x, packed, images)`` as ``f(x, w, b, mask)``
    on the flat weights of ``ops/rdb.py`` (the rungs take no mask); the
    tensor-core kernels' images packed on the way."""
    import torch

    from s2sr_tpu_torch.ops import rdb_ladder as lad

    def run(x, w, b, mask):
        packed = lad.pack_ladder_weights(w, b, rung, x.dtype)
        images = (lad.pack_tc_images(packed, rung)
                  if x.dtype == torch.bfloat16 and rung in lad.TC_RUNGS
                  else None)
        return fn(x, packed, images)
    return run


def on_flat_reference(rung: str):
    """The rung's plain version as ``f(x, w, b, mask)``."""
    from s2sr_tpu_torch.ops import rdb_ladder as lad

    return lambda x, w, b, mask: lad.REFERENCES[rung](
        x, lad.pack_ladder_weights(w, b, rung, x.dtype))


def conv_v3_padded(v, w, rows: int):
    """``ops/rdb_ladder.py::_conv_v3`` with the staged matrix padded in M
    to ``rows`` (zero rows appended, the product sliced back): the same
    values through the float32 product cuBLAS runs at that M."""
    import torch
    import torch.nn.functional as F

    _, h, wd, _ = v.shape
    vp = F.pad(v, (0, 0, 1, 1, 1, 1))
    staged = torch.cat([vp[:, dy:dy + h, dx:dx + wd]
                        for dy in range(3) for dx in range(3)], -1)
    flat = staged.reshape(-1, staged.shape[-1]).float()
    padded = flat.new_zeros(max(rows, flat.shape[0]), flat.shape[1])
    padded[:flat.shape[0]] = flat
    out = (padded @ w)[:flat.shape[0]]
    return out.reshape(*staged.shape[:-1], -1).to(v.dtype)


def ladder_step0(card) -> dict:
    """Why the bf16 CUDA-core v3 kernel read 0 against its plain version
    at some shapes and not at others: the kernel (``ladder_kernel<bf16,
    9>``, sums each output over k in order with ``fmaf``) against
    ``rdb_v3_reference`` as it is and with every staged product padded in
    M to the chunk shape's rows, and the CUDA-core v2 against its plain
    version (three products summed in float32, so other roundings). Max
    abs error and the count of differing outputs."""
    import math

    import torch

    from s2sr_tpu_torch.ops import rdb_ladder as lad

    rows = math.prod(LADDER_SHAPE)
    out = {}
    for shape in ((1, 12, 12), (2, 70, 50), LADDER_SHAPE):
        x, w, b, _ = rdb_inputs(shape, torch.bfloat16)
        line = {}
        for rung in ("v3", "v2"):
            pk = lad.pack_ladder_weights(w, b, rung, torch.bfloat16)
            got = lad.rdb_ladder_cuda_cores(x, pk, rung).float()
            wants = {"plain": lad.REFERENCES[rung](x, pk)}
            if rung == "v3" and shape != LADDER_SHAPE:
                wants["plain_padded_m"] = lad._delta_rdb(
                    x, pk, functools.partial(conv_v3_padded, rows=rows))
            for name, want in wants.items():
                d = (got - want.float()).abs()
                line[f"{rung}_vs_{name}"] = {"max_abs_err": d.max().item(),
                                             "n_differ": int((d > 0).sum())}
        out[str(list(shape))] = line
        del x, w, b
        torch.cuda.empty_cache()
    emit({"phase": "ladder", "card": card, "check": "step 0: bf16 CUDA-core "
          "v3 vs plain, as is and with M padded", "padded_rows": rows,
          "results": out})
    return out


def ladder_l2_bytes(rung: str, shape) -> dict:
    """Bytes a tensor-core rung's launch moves, as ``csrc/rdb_ladder_tc.cu``
    stages them. From L2 into shared memory: ``x_a`` and ``b``, in all
    ``total``. v1, v3: per block and product, each pass (128 region pixels)
    of each K slab copies B's slab (N rows of 128 bytes) and, for the
    products of x, the pass's A slab (128 pixels × 128 bytes) from the
    image. v2: each pass (128 positions at pitch P, the region side rounded
    up to 8) copies B's slabs, of x_j's [dx 2 | zero] slabs only the half
    it reads, and, for x, its band (128 + 2P rows of 128 bytes) once per
    dx tap. Inside shared memory: ``a_from_slots``, the A bytes copied
    from the slots (read once, written once), and ``wgmma_reads``, what
    the wgmmas read (per k16 step and warpgroup 64 × 32 bytes of A and
    N × 32 of B)."""
    import math

    import torch

    from s2sr_tpu_torch.ops import rdb_ladder as lad

    tile = lad.kernel_tiling(rung, torch.bfloat16)["tile"]
    shapes = lad.tc_image_shapes(rung)       # (K slabs, N, 8, 8) per product
    x_a = b = slots = reads = 0
    for j, (slabs, n, _, _) in enumerate(shapes):
        side = tile + 2 * (4 - j)
        k16 = (9 * 64 if j == 0 else 9 * 128 if rung == "v1" else 9 * 32) // 16
        if rung == "v2":
            pitch = -(-side // 8) * 8
            passes = math.ceil(((side - 1) * pitch + side) / 128)
            rows = 128 + 2 * pitch
            if j == 0:
                b += passes * slabs * n * 128
                x_a += passes * 3 * rows * 128
            else:
                b += passes * 3 * n * (128 + 64)
                slots += passes * rows * (128 + 64)
        else:
            passes = math.ceil(side * side / 128)
            b += passes * slabs * n * 128
            if j == 0:
                x_a += passes * slabs * 128 * 128
            else:                            # v3's slab 4 holds tap 8 alone
                slots += passes * 128 * (slabs * 128 - (64 if rung == "v3"
                                                        else 0))
        reads += passes * k16 * 2 * (64 * 32 + n * 32)
    bsz, h, w = shape
    blocks = bsz * math.ceil(h / tile) * math.ceil(w / tile)
    return {"x_a": x_a * blocks, "b": b * blocks, "total": (x_a + b) * blocks,
            "a_from_slots": slots * blocks, "wgmma_reads": reads * blocks}


def ladder_tc_report(state, lines: list, parent_ms: dict) -> None:
    """Per tensor-core rung: route, SASS counts (HGMMA must be nonzero; no
    tensor-core instruction in any CUDA-core kernel of rdb_ladder.cu),
    registers and spills, blocks per SM, useful and executed TFLOP/s at
    the ladder shape, and the CUDA-core kernel's time in the same run."""
    import torch

    from s2sr_tpu_torch.ops import _build
    from s2sr_tpu_torch.ops import rdb_ladder as lad

    tc = sass_counts(_build.lib_path("rdb_ladder_tc"))
    cc = sass_counts(_build.lib_path("rdb_ladder"))
    bad = [k for k, c in cc.items() if c["HMMA"] or c["HGMMA"]]
    bad += [k for k, c in tc.items() if "_tc_kernel" in k and not c["HGMMA"]]
    if bad or len([k for k in tc if "_tc_kernel" in k]) != len(lad.TC_RUNGS):
        raise AssertionError(f"ladder kernels on the wrong route: {bad}; "
                             f"tc {tc}; cuda cores {cc}")
    ptxas = state.get("ptxas", {})
    by_variant = {ln["variant"]: ln for ln in lines}
    for rung in lad.TC_RUNGS:
        name = f"{rung}_tc_kernel"
        ln = by_variant[rung]
        l2 = ladder_l2_bytes(rung, LADDER_SHAPE)
        emit({"phase": "ladder", "card": state.get("card"), "kernel":
              f"rdb_{rung}", "route": "wgmma",
              "sass": {k: c for k, c in tc.items() if name in k},
              "ptxas": {k: v for k, v in ptxas.get("rdb_ladder_tc", {}).items()
                        if name in k} or "cached build: see phase build",
              **lad.kernel_tiling(rung, torch.bfloat16),
              "useful_tflop_s": ln["tf_s"],
              "executed_tflop_s": ln["tf_s"] * ln["executed_over_useful"],
              "executed_over_useful": ln["executed_over_useful"],
              "ms": ln["ms_per_launch"],
              "l2_bytes_per_launch": l2["total"],
              "l2_bytes_x_a": l2["x_a"], "l2_bytes_b": l2["b"],
              "a_from_slots_bytes": l2["a_from_slots"],
              "wgmma_read_bytes": l2["wgmma_reads"],
              "l2_tb_s": l2["total"] / ln["ms_per_launch"] / 1e9,
              "cuda_core_kernel_ms": parent_ms[rung],
              "cuda_core_kernel_tiling": lad.kernel_tiling(
                  rung, torch.bfloat16, cuda_cores=True)})


@ieee_phase
def phase_ladder(state):
    import torch

    from s2sr_tpu_torch.bench import rdb_ladder as bench
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.ops import rdb_ladder as lad

    t0 = time.perf_counter()
    card = state.get("card") or card_line()
    # Each rung against its own plain version, as phase kernel holds rdb,
    # on an image smaller than a tile, a ragged one and the chunk shape.
    # fp32: the two sum each product in other orders. bf16: both round at
    # the same places (every product output and slot add in v2/v3; p1..p4
    # and x_k in v1), so only a sum landing near a rounding tie differs.
    # bf16 v1, v2 and v3 run on the tensor cores (wgmma), which sum in
    # another order than the plain version's cuBLAS products: bf16 flips.
    cases = [(shape, None) for shape in ((1, 12, 12), (2, 70, 50),
                                         LADDER_SHAPE)]
    launches0 = dict(lad.LAUNCHES)
    worst = {}
    for rung in lad.RUNGS:
        worst[rung] = hold_against_plain(
            "ladder", f"rdb_{rung}", on_flat_weights(lad.WRAPPERS[rung], rung),
            on_flat_reference(rung), cases,
            functools.partial(lad.kernel_tiling, rung))
    # comparison launches are not the ladder's launches
    lad.LAUNCHES.update(launches0)
    ladder_step0(card)

    # the ladder itself, as `python -m s2sr_tpu_torch.bench.rdb_ladder`
    # runs it; its v4 launches are not main-path launches of rdb
    rdb0 = rdb_mod.LAUNCHES
    for k in lad.LAUNCHES:
        lad.LAUNCHES[k] = 0
    lines = bench.ladder(bench.VARIANTS, LADDER_SHAPE, LADDER_CHAIN,
                         LADDER_RUNS, "cuda",
                         emit=lambda obj: emit({"phase": "ladder", **obj}))
    torch.cuda.synchronize()
    launches = dict(lad.LAUNCHES)
    rdb_mod.LAUNCHES = rdb0
    per_launch = {ln["variant"]: ln["ms_per_launch"] for ln in lines}

    # the CUDA-core kernels the tensor-core ones replaced, in the same run
    parent_ms = {}
    xb, w, b, _ = rdb_inputs(LADDER_SHAPE, torch.bfloat16)
    for rung in lad.TC_RUNGS:
        pk = lad.pack_ladder_weights(w, b, rung, torch.bfloat16)
        _, ms = bench.time_chain(
            lambda v, pk=pk, rung=rung: lad.rdb_ladder_cuda_cores(v, pk, rung),
            xb, LADDER_CHAIN, LADDER_RUNS, "cuda")
        parent_ms[rung] = ms / LADDER_CHAIN
    del xb, w, b
    ladder_tc_report(state, lines, parent_ms)

    # each rung's plain version at the same shape, for the record
    bound_ms, bound_by = rdb_bound_ms(LADDER_SHAPE, torch.bfloat16,
                                      masked=False)
    numbers = {}
    for rung in lad.RUNGS:
        x, w, b, _ = rdb_inputs(LADDER_SHAPE, torch.bfloat16)
        pk = lad.pack_ladder_weights(w, b, rung, torch.bfloat16)
        plain_ms = time_cuda(lambda: lad.REFERENCES[rung](x, pk), iters=3,
                             warmup=1)
        numbers[rung] = {"ms": per_launch[rung], "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        emit({"phase": "ladder", "card": card, "kernel": f"rdb_{rung}",
              "shape": list(LADDER_SHAPE), "dtype": "bfloat16",
              "ladder_launches": launches[rung], **numbers[rung]})
        del x, w, b, pk
        torch.cuda.empty_cache()
    state["ladder"] = {"launches": launches, "numbers": numbers,
                       "err": worst}
    emit({"phase": "ladder", "seconds": round(time.perf_counter() - t0, 3)})


# --- the matrix-unit microbenchmark: matmul_chain and pair_chain -----------

MXU_REPLACES = {"matmul_chain": "scripts/bench_mxu.py:60",
                "pair_chain": "scripts/bench_mxu.py:169"}
MXU_M = 27840
# the benchmark at full size: the TPU script's chains and the pairs its
# notes measured
MXU_KS = (192, 128, 256, 512)
MXU_PAIRS = ((96, 160), (96, 128), (288, 128), (384, 192), (64, 128))
# held against the plain version: (M, K, N), N None for the chain
MXU_CASES = {"matmul_chain": [(48, 64, None), (1000, 96, None),
                              (1000, 160, None), (100, 80, None)]
             + [(MXU_M, k, None) for k in MXU_KS],
             "pair_chain": [(1000, 64, 128), (1000, 96, 128), (MXU_M, 96, 160),
                            (MXU_M, 288, 128), (MXU_M, 384, 192)]}
MXU_CHECK_REPEAT = 8
# max |kernel − plain| over max |plain|: both round each float32 product
# to bf16, but sum it in other orders, so a rounding moves by one ulp now
# and then and the chain carries it
MXU_TOL = 2.0 ** -5
# the record's shapes (pairs 96×160) and repeat count
MXU_RECORD = {"matmul_chain": (192, None, "cuda_dot", "torch_dot"),
              "pair_chain": (96, 160, "pair", "torch_pair")}
MXU_HI = 1024


def mxu_inputs(m: int, k: int, n, seed: int):
    """Zero-mean inputs on the card: x ~ N(0, 1), each weight N(0, 1) over
    the square root of its fan-in, bf16. A chain of them stays O(1) and
    does not collapse onto one vector, so a planted fault shows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(shape, fan_in):
        v = rng.normal(size=shape) / np.sqrt(fan_in)
        return torch.from_numpy(v.astype(np.float32)).to("cuda", torch.bfloat16)

    x = t((m, k), 1)
    return x, ((t((k, k), k),) if n is None else (t((k, n), k), t((n, k), n)))


def mxu_faults(ws) -> dict:
    """name → (weights, steps added): what the plain version computes for
    a kernel that runs one step fewer, reads each weight in the other
    order (transposed), or (pairs) swaps w1 and w2."""
    def transposed(w):
        return w.t().contiguous().view(w.shape)

    out = {"one_step_fewer": (ws, -1),
           "w_transposed": (tuple(transposed(w) for w in ws), 0)}
    if len(ws) == 2:
        out["w1_w2_swapped"] = ((ws[1].reshape(ws[0].shape),
                                 ws[0].reshape(ws[1].shape)), 0)
    return out


def sass_counts(lib) -> dict:
    """Per kernel of the built library, the SASS instructions that show
    the tensor cores at work (HMMA for mma.sync, HGMMA for wgmma, IMMA for
    the int8 mma.sync), the A
    loads (LDSM) and the shared stores (STS), as ``cuobjdump -sass``
    lists them."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HMMA": 0, "HGMMA": 0, "IMMA": 0, "LDSM": 0,
                            "STS": 0}
        elif name:
            for op in counts[name]:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


@ieee_phase
def phase_mxu(state):
    import torch

    from s2sr_tpu_torch.bench import mxu as bench
    from s2sr_tpu_torch.bench import peak as peak_bench
    from s2sr_tpu_torch.ops import _build
    from s2sr_tpu_torch.ops import matmul_chain as mc

    t0 = time.perf_counter()
    card = state.get("card") or card_line()
    sass = sass_counts(_build.lib_path("matmul_chain"))
    emit({"phase": "mxu", "sass": sass})
    # the wgmma instances (wg_chain_kernel) must issue HGMMA, the mma.sync
    # ones (chain_kernel) HMMA
    wg = {k: c for k, c in sass.items() if "wg_chain_kernel" in k}
    mma = {k: c for k, c in sass.items() if "wg_chain_kernel" not in k
           and "chain_kernel" in k}
    if (len(wg) != 10 or not mma or any(c["HGMMA"] == 0 for c in wg.values())
            or any(c["HMMA"] == 0 for c in mma.values())):
        raise AssertionError(f"a matmul_chain kernel lacks its tensor-core "
                             f"instruction: {sass}")

    # 1. each kernel against its plain version, staged equal to unstaged,
    # every planted fault further than the tolerance
    r = MXU_CHECK_REPEAT
    failures, worst = [], {}
    for name, cases in MXU_CASES.items():
        fn, ref = mc.WRAPPERS[name], mc.REFERENCES[name]
        for i, (m, k, n) in enumerate(cases):
            x, ws = mxu_inputs(m, k, n, seed=i)
            got = fn(x, *ws, r)
            staged = fn(x, *ws, r, stage=True)
            torch.cuda.synchronize()
            want = ref(x, *ws, r).float()
            scale = want.abs().max().item()
            err = (got.float() - want).abs().max().item()
            faults = {f: (got.float() - ref(x, *fws, r + dr).float()).abs()
                      .max().item() / scale
                      for f, (fws, dr) in mxu_faults(ws).items()}
            finite = bool(torch.isfinite(got.float()).all().item())
            same = torch.equal(got, staged)
            emit({"phase": "mxu", "kernel": name, "m": m, "k": k,
                  "n": n or k, "repeat": r,
                  **mc.kernel_tiling(name, k, n or k, False),
                  "max_abs_err": err, "max_abs_plain": scale,
                  "rel_err": err / scale, "tolerance": MXU_TOL,
                  "staged_equals_unstaged": same,
                  "rel_err_vs_planted_fault": faults, "finite": finite})
            case = f"{name} ({m}, {k}, {n})"
            if not (finite and err / scale <= MXU_TOL and same):
                failures.append(f"{case}: rel err {err / scale}, staged equal "
                                f"{same}, finite {finite}")
            if not min(faults.values()) > MXU_TOL:
                failures.append(f"{case}: a planted fault is within "
                                f"tolerance {faults}")
            if (k, n) == MXU_RECORD[name][:2] and m == MXU_M:
                worst[name] = (err, err / scale)
            del x, ws, got, staged, want
    if failures:
        raise AssertionError("mxu kernels vs plain:\n" + "\n".join(failures))

    # 2. the benchmark at full size, as `python -m s2sr_tpu_torch.bench.mxu`
    # runs it, chains then pairs
    for key in mc.LAUNCHES:
        mc.LAUNCHES[key] = 0
    lines = bench.run(MXU_KS, (), MXU_M, hi=MXU_HI,
                      emit=lambda obj: emit({"phase": "mxu", **obj}))
    lines += bench.run((), MXU_PAIRS, MXU_M, hi=MXU_HI,
                       emit=lambda obj: emit({"phase": "mxu", **obj}))
    torch.cuda.synchronize()
    launches = dict(mc.LAUNCHES)
    if not all(ln["finite"] for ln in lines):
        raise AssertionError(f"a benchmark chain is not finite: {lines}")

    # 3. the card's cuBLAS rate
    peak_bench.peak(runs=3, emit=lambda obj: emit({"phase": "mxu", **obj}))

    # 4. the record's numbers: K = 192 (pairs 96×160) at repeat 1024
    launches0 = dict(mc.LAUNCHES)
    numbers = {}
    for name, (k, n, kernel_bench, lib_bench) in MXU_RECORD.items():
        line = {ln["bench"]: ln for ln in lines
                if ln["k"] == k and ln["n"] == (n or k)}
        x, ws = mxu_inputs(MXU_M, k, n, seed=0)
        plain_ms = time_cuda(lambda: mc.REFERENCES[name](x, *ws, MXU_HI),
                             iters=2, warmup=1)
        numbers[name] = {"ms": line[kernel_bench]["ms_hi"],
                         "plain_ms": plain_ms,
                         "bound_ms": line[kernel_bench]["bound_ms_hi"],
                         "bound_by": "operations",
                         "library_ms": line[lib_bench]["ms_hi"]}
        emit({"phase": "mxu", "card": card, "kernel": name, "m": MXU_M,
              "k": k, "n": n or k, "repeat": MXU_HI,
              "bench_launches": launches[name], **numbers[name]})
        del x, ws
    mc.LAUNCHES.update(launches0)
    state["mxu"] = {"launches": launches, "numbers": numbers, "err": worst}
    emit({"phase": "mxu", "seconds": round(time.perf_counter() - t0, 3)})


def kernels_record(state) -> list | None:
    """The kernels' JSON record, or None if a phase it needs did not run."""
    if not {"rdb_numbers", "main_launches", "rdb_i8_numbers",
            "main_launches_i8", "swin_numbers", "swin_launches", "swin_err",
            "ladder", "mxu"} <= state.keys():
        return None
    from s2sr_tpu_torch.ops.rdb_ladder import TC_RUNGS

    # phase warmup's child processes count their own launches
    warm = state.get("warmup_launches", {})
    rows = [{"name": "rdb", "route": "cuda",
             "source": "s2sr_tpu_torch/csrc/rdb.cu",
             "replaces": "s2sr_tpu/ops/pallas/fused_rdb_v4.py:234",
             "launches": (state["main_launches"] + warm.get("rdb", 0)
                          + state.get("train_launches", 0)),
             "max_abs_err": state["rdb_max_abs_err"],
             "rel_err": state["rdb_rel_err"],
             **state["rdb_numbers"], "library_ms": None},
            # no TPU kernel: JAX runs this conv as XLA's int8 convolution
            {"name": "rdb_i8", "route": "cuda",
             "source": "s2sr_tpu_torch/csrc/rdb.cu",
             "replaces": RDB_I8_REPLACES,
             "launches": state["main_launches_i8"],
             "max_abs_err": state["rdb_i8_max_abs_err"],
             "rel_err": state["rdb_i8_rel_err"],
             **state["rdb_i8_numbers"], "library_ms": None}]
    for name in ("swin_block", "window_attention"):
        err, rel = state["swin_err"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": "s2sr_tpu_torch/csrc/window_attention.cu",
                     "replaces": SWIN_REPLACES[name],
                     "launches": (state["swin_launches"][name]
                                  + warm.get(name, 0)),
                     "max_abs_err": err, "rel_err": rel,
                     **state["swin_numbers"][name], "library_ms": None})
    lad = state["ladder"]
    for rung, replaces in LADDER_REPLACES.items():
        err, rel = lad["err"][rung]
        source = "rdb_ladder_tc.cu" if rung in TC_RUNGS else "rdb_ladder.cu"
        rows.append({"name": f"rdb_{rung}", "route": "cuda",
                     "source": f"s2sr_tpu_torch/csrc/{source}",
                     "replaces": replaces, "launches": lad["launches"][rung],
                     "max_abs_err": err, "rel_err": rel,
                     **lad["numbers"][rung], "library_ms": None})
    mxu = state["mxu"]
    for name, replaces in MXU_REPLACES.items():
        err, rel = mxu["err"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": "s2sr_tpu_torch/csrc/matmul_chain.cu",
                     "replaces": replaces, "launches": mxu["launches"][name],
                     "max_abs_err": err, "rel_err": rel,
                     **mxu["numbers"][name]})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the fetched scene's pixels (phase fetch)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "s2sr_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: no s2sr_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(root))

    # every HTTP request of the run goes to a server of its own on
    # 127.0.0.1: never through a proxy
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "127.0.0.1,localhost"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="s2sr_smoke_") as work:
        state: dict = {"work": Path(work), "seed": args.seed}
        try:
            for phase in phases:
                t1 = time.perf_counter()
                globals()[f"phase_{phase}"](state)
                emit({"phase_done": phase,
                      "seconds": round(time.perf_counter() - t1, 3)})
        finally:
            if "assets" in state:
                state["assets"]["server"].close()
    card = state.get("card") or card_line()
    kernels = kernels_record(state)
    if kernels is not None and any(r["launches"] == 0 for r in kernels):
        raise AssertionError(f"a kernel never ran on its path: {kernels}")
    print(card, flush=True)
    if kernels is not None:
        emit({"kernels": kernels, "card": card,
              "total_seconds": round(time.perf_counter() - t0, 3)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
