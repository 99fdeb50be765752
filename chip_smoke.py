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
  dense blocks run the ``rdb`` kernel (phases kernel, main, numbers);
- SwinIR serving on ``swinir_x4`` (``process_wow_sr`` on the exact path,
  the halo-tiled engine path, a 3×5 upload), whose Swin blocks run the
  ``swin_block`` kernel, or ``window_attention`` under
  ``S2SR_SWINIR_FUSED_LEVEL=attn`` (phases swin_kernel, swin_main,
  swin_numbers).

It also drives the RDB ablation ladder (``s2sr_tpu_torch.bench.rdb_ladder``)
at the main path's chunk shape, whose rungs run the ``rdb_v1``, ``rdb_v2``
and ``rdb_v3`` kernels of ``csrc/rdb_ladder.cu`` (phase ladder).

It checks the outputs, that every block of each path went through its
kernel, and times the kernels and the SR stages. Nothing is caught: any
failure exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernels'
JSON record, and the one before that the card's name and power limit.
Without CUDA, or without the package beside it, it exits non-zero and
prints no result.

``--phases`` picks a subset (device, build, kernel, main, numbers,
swin_kernel, swin_main, swin_numbers, ladder) for a quick check; the
default runs them all.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PHASES = ("device", "build", "kernel", "main", "numbers", "swin_kernel",
          "swin_main", "swin_numbers", "ladder")
KERNEL_SOURCES = ("rdb", "window_attention", "rdb_ladder")

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
    # each kernel's entry line (its mangled name), registers and spills
    ptxas = {name: [ln for ln in log.splitlines()
                    if any(key in ln for key in ("entry function", "registers",
                                                 "spill", "smem"))]
             for name, (_, log) in built.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_seconds": {n: b[0] for n, b in built.items()},
          "ptxas": ptxas})


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


def phase_kernel(state):
    import torch

    from s2sr_tpu_torch.ops import rdb as rdb_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # fp32: the kernel and the plain version sum the 1,728 products of
    # each output in different orders (cuDNN may pick Winograd/FFT), ~1e-6
    # of the change. bf16: the plain version rounds to bf16 after every
    # conv and add, the kernel only where it stores.
    cases = [((2, 70, 50), None), ((2, 70, 50), (61, 37)),
             ((16, 264, 264), None), ((1, 576, 448), (576, 432))]
    t0 = time.perf_counter()
    launches0 = rdb_mod.LAUNCHES
    state["rdb_max_abs_err"], state["rdb_rel_err"] = hold_against_plain(
        "kernel", "rdb", rdb_mod.rdb, rdb_mod.rdb_reference, cases,
        rdb_mod.kernel_tiling)
    # comparison launches are not main-path launches
    rdb_mod.LAUNCHES = launches0
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
    check_against_plain(eng)
    check_wow_chain()
    emit({"phase": "main", "seconds": round(time.perf_counter() - t0, 3)})


def check_wow_chain() -> None:
    """The WOW chain on the card against the same chain on the CPU. The
    ops are integer or float32 elementwise; CUDA's ``powf`` and the
    CLAHE blend may land a ``.5`` tie on the other side, which the chain
    spreads over a few LSB of the same pixel, so bound the share of
    pixels touched (as the CPU tests bound it against JAX)."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.ops.enhance import enhance_for_crops

    img = torch.from_numpy(synthetic_fields((512, 384), seed=11))
    cpu = enhance_for_crops(img).numpy()
    gpu = enhance_for_crops(img.cuda()).cpu().numpy()
    diff = np.abs(cpu.astype(np.int16) - gpu.astype(np.int16))
    touched = float(np.any(diff > 0, axis=-1).mean())
    emit({"phase": "main", "check": "WOW chain on the card vs the CPU",
          "image": [512, 384], "max_abs_diff": int(diff.max()),
          "pixels_touched": touched, "tol_pixels_touched": 0.01})
    if gpu.shape != cpu.shape or touched > 0.01:
        raise AssertionError(f"WOW chain on the card touches {touched} of "
                             "the pixels the CPU chain gives")


def check_against_plain(eng) -> None:
    """The main path's model on a small masked bucket, against the same
    weights in fp32 on the CPU (where every RDB runs its plain version):
    the fp32 kernel path and the bf16 serving path, relative to the
    reference's largest output.

    The random init scales every conv by 0.1, so its x4 output is ~1e-4
    and would hide an error. Here the RDB convs are scaled ×5 and the
    others ×4: the output spans about 0..0.7 and the 69 RDBs move it by
    up to ~0.15 (their last convs zeroed, on the CPU)."""
    import numpy as np
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.models.rrdbnet import RRDBNet
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.parallel.tiling import bucket_pad

    launches0 = rdb_mod.LAUNCHES
    img, mask = bucket_pad(synthetic_fields((40, 52), seed=9))
    x = torch.from_numpy(img).float()[None] / 255.0
    m = torch.from_numpy(mask)[None]
    n_block = len(eng.model.body)
    sd = {k: v.detach().cpu() * (1 if not k.endswith("weight")
                                 else 5 if k.startswith("body.") else 4)
          for k, v in eng.model.state_dict().items()}

    def net(dtype, device):
        model = RRDBNet(num_block=n_block, dtype=dtype)
        model.load_state_dict(sd)
        return model.to(device).pack()

    ref = net(torch.float32, "cpu")(x, mask=m)
    out32 = net(torch.float32, "cuda")(x.cuda(), mask=m.cuda()).cpu()
    outbf = net(torch.bfloat16, "cuda")(x.cuda(), mask=m.cuda()).cpu()
    rdb_mod.LAUNCHES = launches0
    scale = ref.abs().max().item()
    rel32 = (out32 - ref).abs().max().item() / scale
    relbf = (outbf - ref).abs().max().item() / scale
    # fp32: ~350 convs each summing in another order (~1e-7 each);
    # bf16: 8-bit mantissas through 69 blocks (0.031 for the plain
    # version in bf16 on the CPU)
    tol32, tolbf = 1e-3, 0.1
    u8 = [np.trunc(np.clip(t[0, :160, :208].numpy() * 255, 0, 255))
          for t in (ref, out32)]
    emit({"phase": "main", "check": "full model vs fp32 plain on CPU",
          "image": [40, 52], "bucket": list(img.shape[:2]),
          "ref_max_abs": scale, "ref_u8_mean": float(u8[0].mean()),
          "rel_err_fp32": rel32, "tol_fp32": tol32,
          "rel_err_bf16": relbf, "tol_bf16": tolbf,
          "u8_bytes_differing_fp32": int((u8[0] != u8[1]).sum())})
    if not (rel32 <= tol32 and relbf <= tolbf and np.isfinite(scale)):
        raise AssertionError(f"full model disagrees with the plain path: "
                             f"fp32 {rel32}, bf16 {relbf}")


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
    relative-position bias dropped, and (whole block) the MLP dropped."""
    import torch

    out = {}
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


def phase_swin_kernel(state):
    import torch

    from s2sr_tpu_torch.ops import window_attention as wa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # The error is max |kernel − plain| over the kernel's own change to
    # its input: max |out − x| of the fp32 plain version for swin_block,
    # max |y| for window_attention (which adds no residual). fp32: the
    # two sum the same products in other orders. bf16: both round at the
    # same places, so only a near-tie rounded apart differs (the plain
    # bf16 version sits 0.006 of the change from the fp32 one on the
    # CPU). Each case also holds the kernel further than the tolerance
    # from the plain version with each planted fault (0.45–0.84 of the
    # change on the CPU).
    tol = {torch.float32: 1e-4, torch.bfloat16: 0.05}
    grids = [(1, 24, 32), (2, 40, 72), (1, 512, 512)]
    launches0 = dict(wa.LAUNCHES)
    failures = []
    worst = {}
    t0 = time.perf_counter()
    emit({"phase": "swin_kernel", "smem_bytes": wa.kernel_smem_bytes()})
    for name, (fn, ref, mlp) in swin_kernels().items():
        for dtype in (torch.float32, torch.bfloat16):
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


def phase_swin_numbers(state):
    import torch

    from s2sr_tpu_torch.fetch.synthetic import synthetic_fields
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    card = state.get("card") or card_line()
    launches0 = dict(wa.LAUNCHES)
    shape, dtype = (1, 512, 512), torch.bfloat16
    numbers = {}
    for name, (fn, ref, _) in swin_kernels().items():
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
        emit({"phase": "swin_numbers", "card": card, "kernel": name,
              "shape": [*shape, 180], "dtype": "bfloat16",
              "ms_by_shift": {s: v[0] for s, v in per_shift.items()},
              "plain_ms_by_shift": {s: v[1] for s, v in per_shift.items()},
              **numbers[name],
              "tflops": SWIN_FLOP_PER_TOKEN[name] * 512 * 512 / ms / 1e9})
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
    """A rung's ``fn(x, packed)`` as ``f(x, w, b, mask)`` on the flat
    weights of ``ops/rdb.py`` (the rungs take no mask)."""
    from s2sr_tpu_torch.ops import rdb_ladder as lad

    return lambda x, w, b, mask: fn(x, lad.pack_ladder_weights(w, b, rung,
                                                               x.dtype))


def phase_ladder(state):
    import torch

    from s2sr_tpu_torch.bench import rdb_ladder as bench
    from s2sr_tpu_torch.ops import rdb as rdb_mod
    from s2sr_tpu_torch.ops import rdb_ladder as lad

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    card = state.get("card") or card_line()
    # Each rung against its own plain version, as phase kernel holds rdb,
    # on an image smaller than a tile, a ragged one and the chunk shape.
    # fp32: the two sum each product in other orders. bf16: both round at
    # the same places (every product output and slot add in v2/v3; p1..p4
    # and x_k in v1), so only a sum landing near a rounding tie differs.
    cases = [(shape, None) for shape in ((1, 12, 12), (2, 70, 50),
                                         LADDER_SHAPE)]
    launches0 = dict(lad.LAUNCHES)
    worst = {}
    for rung in lad.RUNGS:
        worst[rung] = hold_against_plain(
            "ladder", f"rdb_{rung}", on_flat_weights(lad.WRAPPERS[rung], rung),
            on_flat_weights(lad.REFERENCES[rung], rung), cases,
            functools.partial(lad.kernel_tiling, rung))
    # comparison launches are not the ladder's launches
    lad.LAUNCHES.update(launches0)

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


def kernels_record(state) -> list | None:
    """The kernels' JSON record, or None if a phase it needs did not run."""
    if not {"rdb_numbers", "main_launches", "swin_numbers",
            "swin_launches", "swin_err", "ladder"} <= state.keys():
        return None
    rows = [{"name": "rdb", "route": "cuda",
             "source": "s2sr_tpu_torch/csrc/rdb.cu",
             "replaces": "s2sr_tpu/ops/pallas/fused_rdb_v4.py:234",
             "launches": state["main_launches"],
             "max_abs_err": state["rdb_max_abs_err"],
             "rel_err": state["rdb_rel_err"],
             **state["rdb_numbers"], "library_ms": None}]
    for name in ("swin_block", "window_attention"):
        err, rel = state["swin_err"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": "s2sr_tpu_torch/csrc/window_attention.cu",
                     "replaces": SWIN_REPLACES[name],
                     "launches": state["swin_launches"][name],
                     "max_abs_err": err, "rel_err": rel,
                     **state["swin_numbers"][name], "library_ms": None})
    lad = state["ladder"]
    for rung, replaces in LADDER_REPLACES.items():
        err, rel = lad["err"][rung]
        rows.append({"name": f"rdb_{rung}", "route": "cuda",
                     "source": "s2sr_tpu_torch/csrc/rdb_ladder.cu",
                     "replaces": replaces, "launches": lad["launches"][rung],
                     "max_abs_err": err, "rel_err": rel,
                     **lad["numbers"][rung], "library_ms": None})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
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

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="s2sr_smoke_") as work:
        state: dict = {"work": Path(work)}
        for phase in phases:
            t1 = time.perf_counter()
            globals()[f"phase_{phase}"](state)
            emit({"phase_done": phase,
                  "seconds": round(time.perf_counter() - t1, 3)})
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
