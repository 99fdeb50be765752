#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``s2sr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written kernel from ``s2sr_tpu_torch/csrc``, holds it
against its plain PyTorch version on the card, drives the port's ``/api/wow`` path
(``process_wow_sr`` and ``SREngine.enhance_serving_many``) at the full
width of ``realesrgan_x4`` with random weights from seed 0, checks the
outputs and that every residual dense block of that run went through the
kernel, and times the kernel and the SR stage. Nothing is caught: any
failure exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernels'
JSON record. Without CUDA, or without the package beside it, it exits
non-zero and prints no result.

``--phases`` picks a subset (device, build, kernel, main, numbers) for
a quick check; the default runs them all.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PHASES = ("device", "build", "kernel", "main", "numbers")

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
    from s2sr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds, log = _build.build("rdb")
    ptxas = [ln for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_seconds": {"rdb": seconds}, "ptxas": {"rdb": ptxas}})


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


def phase_kernel(state):
    import torch

    from s2sr_tpu_torch.ops import rdb as rdb_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # The error is max |kernel - plain| over the largest change the block
    # makes, max |out - x| of the fp32 plain version: x itself cancels,
    # and a bf16 ulp of a large x cannot hide the block's own work.
    # fp32: the two sum the 1,728 products of each output in different
    # orders (cuDNN may pick Winograd/FFT), ~1e-6 of the change.
    # bf16: the plain version rounds to bf16 after every conv and add,
    # the kernel only where it stores.
    # Each case also runs the plain version with each of x1..x4 stored
    # as zero: the kernel must sit further than the tolerance from all
    # four, or the check could not see a dense connection gone wrong.
    tol = {torch.float32: 1e-4, torch.bfloat16: 0.05}
    cases = [((2, 70, 50), None), ((2, 70, 50), (61, 37)),
             ((16, 264, 264), None), ((1, 576, 448), (576, 432))]
    worst_abs = worst_rel = 0.0
    failures = []
    t0 = time.perf_counter()
    launches0 = rdb_mod.LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        tiling = rdb_mod.kernel_tiling(dtype)
        for shape, masked_hw in cases:
            x, w, b, mask = rdb_inputs(shape, dtype, masked_hw)
            got = rdb_mod.rdb(x, w, b, mask).float()
            torch.cuda.synchronize()
            change = (rdb_mod.rdb_reference(x.float(), w, b, mask)
                      - x.float()).abs().max().item()

            def err_vs(wt):
                want = rdb_mod.rdb_reference(x, wt, b, mask).float()
                return (got - want).abs().max().item()

            err = err_vs(w)
            faults = {f"x{i}_zero": err_vs(drop_dense_input(w, b, i)) / change
                      for i in (1, 2, 3, 4)}
            rel = err / change
            finite = bool(torch.isfinite(got).all().item())
            emit({"phase": "kernel", "kernel": "rdb", "dtype": str(dtype),
                  "shape": list(shape), "masked": masked_hw is not None,
                  "tile": tiling["tile"], "smem_bytes": tiling["smem_bytes"],
                  "max_abs_err": err, "max_change": change,
                  "rel_err": rel, "tolerance": tol[dtype],
                  "rel_err_vs_planted_fault": faults, "finite": finite})
            if not finite or not rel <= tol[dtype]:
                failures.append(f"{dtype} {shape} masked={masked_hw}: "
                                f"rel err {rel} over {tol[dtype]}")
            if not min(faults.values()) > tol[dtype]:
                failures.append(f"{dtype} {shape} masked={masked_hw}: a "
                                f"planted fault is within tolerance {faults}")
            if dtype == torch.bfloat16:
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            del x, w, b, mask, got
            torch.cuda.empty_cache()
    # comparison launches are not main-path launches
    rdb_mod.LAUNCHES = launches0
    if failures:
        raise AssertionError("rdb kernel vs plain:\n" + "\n".join(failures))
    state["rdb_max_abs_err"] = worst_abs
    state["rdb_rel_err"] = worst_rel
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
    print(card, flush=True)
    if "rdb_numbers" in state and "main_launches" in state:
        emit({"kernels": [{
            "name": "rdb", "route": "cuda",
            "source": "s2sr_tpu_torch/csrc/rdb.cu",
            "replaces": "s2sr_tpu/ops/pallas/fused_rdb_v4.py:234",
            "launches": state["main_launches"],
            "max_abs_err": state["rdb_max_abs_err"],
            "rel_err": state["rdb_rel_err"],
            **state["rdb_numbers"], "library_ms": None}],
            "card": card,
            "total_seconds": round(time.perf_counter() - t0, 3)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
