"""CLI: build the port's kernels and run every production hot path once
(the port of ``s2sr_tpu.cli.warmup``).

Usage: python -m s2sr_tpu_torch.cli.warmup [--models M1,M2] [--dtype D]
       [--full-size N] [--skip-aux] [--device cuda|cpu]

A cold process on the card spends its first request building the
hand-written kernels (``nvcc``, tens of seconds). This command builds
every library of ``csrc/`` and ``native/`` into the build cache
(``ops/_build.py::build_all``; ``S2SR_TORCH_BUILD_DIR`` or
``build/kernels/``), so a later server or CLI process only loads them,
and then runs a representative workload through each hot path:

- each engine's masked-bucket serving (a 150×130 upload), its chunked
  tiled serving and its whole-image ``enhance`` at ``--full-size``²
  (0 skips both), on the card's kernels (``rdb``, ``swin_block``);
- the WOW and farm enhancement chains at the SR output's size;
- the tile warp; the vector mask and segmentation chains.

Run it at image-build time, or as an init container that shares the
build directory with the server. Idempotent: with the libraries cached it
only loads them and runs the paths once. It prints the JAX package's
"warmed …" lines, then the kernel launches of the run.
"""
import argparse
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Build the kernels and warm the production paths")
    parser.add_argument("--models", default="realesrgan_x4",
                        help="comma-separated engine models to warm")
    parser.add_argument("--dtype", default=None,
                        help="engine dtype override (default: settings)")
    parser.add_argument("--full-size", type=int, default=1024,
                        help="representative tiled-path image size "
                             "(0 skips the big tiled run)")
    parser.add_argument("--skip-aux", action="store_true",
                        help="engine paths only (skip WOW/tiles/vectors)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on the CPU)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..models.engine import get_engine, resolve_device
    from ..ops import _build, rdb, window_attention

    device = resolve_device(args.device)
    t0 = time.monotonic()

    def tick(name: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"  warmed {name} ({time.monotonic() - t0:.0f}s total)",
              flush=True)

    built = _build.build_all()
    for name, b in built.items():
        state = "cached" if b["cached"] else "built"
        print(f"  {state} {name} in {b['seconds']:.2f}s", flush=True)
    tick(f"kernel libraries ({len(built)})")

    rng = np.random.default_rng(0)
    engine = None
    for model in args.models.split(","):
        kwargs = {"dtype": args.dtype} if args.dtype else {}
        engine = get_engine(model.strip(), device=str(device), **kwargs)
        # small awkward size → the masked-bucket path (exact serving for
        # small uploads)
        engine.enhance_serving(
            rng.integers(0, 255, (150, 130, 3)).astype(np.uint8))
        tick(f"{model}: masked-bucket serving")
        if args.full_size:
            big = rng.integers(
                0, 255, (args.full_size, args.full_size, 3)
            ).astype(np.uint8)
            # large size → the chunked tiled serving path
            engine.enhance_serving(big)
            tick(f"{model}: chunked tiled serving {args.full_size}^2")
            # and the whole-image enhance() the pipelines use
            engine.enhance(big)
            tick(f"{model}: tiled {args.full_size}^2")

    if not args.skip_aux:
        from ..fetch.synthetic import synthetic_scene
        from ..ops.enhance import enhance_farm, enhance_for_crops
        from ..tiles.pyramid import warp_tiles_device_benchmark
        from ..vectors.extraction import (ExtractionConfig,
                                          compute_green_mask_hsv,
                                          segment_fields)

        # enhancement runs on the SR output (scale × the scene side)
        sr_side = (engine.scale if engine is not None else 4) * 512
        img = torch.from_numpy(rng.integers(
            0, 255, (sr_side, sr_side, 3)).astype(np.uint8)).to(device)
        enhance_for_crops(img).cpu()
        enhance_farm(img).cpu()
        tick(f"WOW + farm enhancement chains ({sr_side}^2)")

        scene = synthetic_scene(size=(512, 512), seed=0)
        warp_tiles_device_benchmark(scene, zoom=13, batch=32, device=device)
        tick("tile warp")

        vcfg = ExtractionConfig()
        mask = compute_green_mask_hsv(scene, vcfg, device=device)
        segment_fields(mask, vcfg, device=device)
        tick("vector mask + segmentation chains")

    launches = {"rdb": rdb.LAUNCHES, "rdb_i8": rdb.LAUNCHES_I8,
                **window_attention.LAUNCHES}
    print("kernel launches: " + ", ".join(f"{k} {v}"
                                          for k, v in launches.items()))
    print(f"warmup done in {time.monotonic() - t0:.0f}s")


if __name__ == "__main__":
    main()
