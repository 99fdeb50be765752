"""CLI: train or fine-tune RRDBNet or SwinIR on synthetic (or directory)
HR scenes (the port of ``s2sr_tpu.cli.train``).

- the device pipeline (default): the HR scene pool is copied to the card
  once and every batch is cropped, flipped and degraded there
  (``training/train.py::make_device_pool_train_step``), drawn from a
  ``torch.Generator`` seeded with the start step;
- the host pipeline: :class:`~s2sr_tpu_torch.training.data.PairSampler`
  batches prefetched through pinned memory;
- block-level remat (default for ≥ 8 blocks), cosine LR decay over the
  run, a weight EMA, periodic checkpoints and ``--resume``.

LR inputs are area-downsampled HR crops, optionally blurred, noised and
JPEG-compressed. It runs on CUDA unless ``--device cpu``; ``--mesh`` takes
a one-device spec (``dp=1``).
"""
import argparse
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train an SR model (RRDBNet or SwinIR)")
    parser.add_argument("--family", choices=("rrdbnet", "swinir"),
                        default="rrdbnet",
                        help="model family; swinir trains through the "
                             "same L1 step")
    parser.add_argument("--embed-dim", type=int, default=60,
                        help="swinir: embedding dim (SwinIR-M uses 180)")
    parser.add_argument("--depths", default="2,2",
                        help="swinir: per-RSTB block depths, e.g. "
                             "'6,6,6,6,6,6' for SwinIR-M")
    parser.add_argument("--heads", default="4,4",
                        help="swinir: per-RSTB attention heads")
    parser.add_argument("--window", type=int, default=8,
                        help="swinir: attention window")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--crop", type=int, default=48, help="LR crop size")
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--blocks", type=int, default=23)
    parser.add_argument("--feat", type=int, default=64)
    parser.add_argument("--grow", type=int, default=32)
    parser.add_argument("--chunk", type=int, default=32,
                        help="optimizer steps per chunk (device pipeline)")
    parser.add_argument("--pipeline", choices=("device", "host"),
                        default="device")
    parser.add_argument("--remat", default=None,
                        action=argparse.BooleanOptionalAction,
                        help="rematerialise blocks on backward "
                             "(default: on for --blocks >= 8)")
    parser.add_argument("--decay-steps", type=int, default=None,
                        help="cosine-decay horizon (default: the total "
                             "planned steps incl. resume offset; 0 = "
                             "constant LR)")
    parser.add_argument("--pool", type=int, default=48,
                        help="synthetic HR pool scenes (ignored with "
                             "--data-dir)")
    parser.add_argument("--blur-sigma", type=float, default=0.0,
                        help="gaussian blur on the LR (0 = area-only)")
    parser.add_argument("--noise-std", type=float, default=0.0,
                        help="gaussian noise std on the LR in [0,1] units")
    parser.add_argument("--jpeg", default="",
                        help="JPEG compression on the LR as 'QLO,QHI' "
                             "(per-sample uniform quality, e.g. '30,95'; "
                             "needs --crop a multiple of 16)")
    parser.add_argument("--ema-decay", type=float, default=0.0,
                        help="weight EMA decay (upstream uses 0.999; 0 = "
                             "off). Export the EMA with convert_weights "
                             "--from-ckpt --ema")
    parser.add_argument("--ckpt-dir", default="checkpoints/rrdbnet")
    parser.add_argument("--save-every", type=int, default=2000,
                        help="checkpoint every N steps")
    parser.add_argument("--data-dir", default=None,
                        help="directory of HR GeoTIFFs/PNGs (default: "
                             "synthetic)")
    parser.add_argument("--mesh", default="", help='a one-device spec, "dp=1"')
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--loss-log", default=None, metavar="FILE",
                        help="append every step's loss to FILE, one per "
                             "line")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    jpeg_range = None
    if args.jpeg:
        lo, hi = (float(v) for v in args.jpeg.split(","))
        jpeg_range = (lo, hi)

    import torch

    from ..fetch.synthetic import synthetic_fields
    from ..models.engine import resolve_device
    from ..parallel.mesh import build_mesh
    from ..training.checkpoint import CheckpointManager
    from ..training.train import (TrainConfig, init_training,
                                  make_device_pool_train_step,
                                  make_train_step, restore_flexible)

    device = resolve_device(args.device)
    if device.type == "cuda":
        # training has no shape-invariance contract: cuDNN's fastest pick
        torch.backends.cudnn.benchmark = True
    chunk = max(1, min(args.chunk, args.steps))
    args.steps -= args.steps % chunk
    remat = args.remat if args.remat is not None else args.blocks >= 8
    mgr = CheckpointManager(Path(args.ckpt_dir))
    start = 0 if not args.resume else (mgr.latest_step or 0)
    decay = (args.decay_steps if args.decay_steps is not None
             else start + args.steps)
    config = TrainConfig(family=args.family,
                         num_feat=args.feat, num_block=args.blocks,
                         num_grow_ch=args.grow, embed_dim=args.embed_dim,
                         depths=tuple(int(v) for v in args.depths.split(",")),
                         heads=tuple(int(v) for v in args.heads.split(",")),
                         window=args.window, learning_rate=args.lr,
                         lr_decay_steps=decay, remat=remat,
                         ema_decay=args.ema_decay)
    mesh = build_mesh(args.mesh, device) if args.mesh else None
    params, opt_state = init_training(config, device=device)
    if args.resume and mgr.latest_step is not None:
        params, opt_state, start, opt_ok = restore_flexible(mgr, config,
                                                            device=device)
        print(f"resumed from step {start}"
              + ("" if opt_ok else
                 " (schedule kind changed — Adam moments transplanted, "
                 "schedule state reset)"))

    # --- HR pool ------------------------------------------------------
    crop_hr = args.crop * config.scale
    if args.data_dir:
        from ..pipelines.io import load_rgb

        paths = sorted(p for p in Path(args.data_dir).iterdir()
                       if p.suffix.lower() in (".tif", ".tiff", ".png"))
        pool = [load_rgb(p)[0] for p in paths]
        if not pool:
            raise SystemExit(f"no .tif/.tiff/.png files in {args.data_dir}")
    else:
        pool = [synthetic_fields(size=(crop_hr * 2,) * 2, seed=1 + i)
                for i in range(args.pool)]
    min_side = min(min(p.shape[0], p.shape[1]) for p in pool)
    if min_side < crop_hr:
        raise SystemExit(f"pool images ({min_side}px) smaller than the "
                         f"HR crop ({crop_hr}px)")

    device_pipe = args.pipeline == "device" and chunk > 1
    shape = (f"{args.blocks} blocks / {args.feat} feat"
             if args.family == "rrdbnet" else
             f"swinir dim {args.embed_dim} depths {args.depths} "
             f"heads {args.heads} window {args.window}")
    print(f"training: {shape}, "
          f"{args.steps} steps @ chunk {chunk}, pipeline={args.pipeline}, "
          f"remat={remat}, decay to step {decay}, pool={len(pool)}, "
          f"device={device}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def log_losses(losses):
        if args.loss_log:
            with open(args.loss_log, "a") as f:
                f.writelines(f"{v!r}\n" for v in losses)

    t_steady = None
    done = 0
    if device_pipe:
        # one common pool shape: every scene centre-cropped to the
        # smallest square
        side = min_side
        pool_np = np.stack([
            p[(p.shape[0] - side) // 2:(p.shape[0] + side) // 2,
              (p.shape[1] - side) // 2:(p.shape[1] + side) // 2]
            for p in pool]).astype(np.float32) / 255.0
        pool_dev = torch.from_numpy(pool_np).to(device)
        run, _ = make_device_pool_train_step(
            config, args.crop, args.batch, chunk, mesh=mesh,
            blur_sigma=args.blur_sigma, noise_std=args.noise_std,
            jpeg_range=jpeg_range)
        gen = torch.Generator(device=device).manual_seed(start)
        for gi in range(args.steps // chunk):
            params, opt_state, lvec = run(params, opt_state, pool_dev, gen)
            done += chunk
            if args.loss_log:
                log_losses(lvec.tolist())
            if gi == 0:
                sync()
                t_steady = time.monotonic()
            if (gi + 1) % 10 == 0 or done == args.steps:
                last = float(lvec[-1])
                rate = ((done - chunk) / (time.monotonic() - t_steady)
                        if done > chunk else 0.0)
                print(f"step {start + done}/{start + args.steps}: loss "
                      f"{last:.4f} ({rate:.1f} steps/s)", flush=True)
            if done % args.save_every < chunk and done != args.steps:
                mgr.save(start + done, params, opt_state)
    else:
        from ..training.data import PairSampler, prefetch

        step_fn, _ = make_train_step(config, mesh)
        sampler = PairSampler(hr_images=pool, crop_lr=args.crop,
                              scale=config.scale, batch_size=args.batch,
                              blur_sigma=args.blur_sigma,
                              noise_std=args.noise_std,
                              jpeg_range=jpeg_range, seed=start)
        for i, (lr_b, hr_b) in enumerate(prefetch(sampler, args.steps,
                                                  device=device)):
            params, opt_state, loss = step_fn(params, opt_state, lr_b, hr_b)
            done = i + 1
            if args.loss_log:
                log_losses([float(loss)])
            if done % 50 == 0 or done == args.steps:
                print(f"step {start + done}: loss {float(loss):.4f}",
                      flush=True)
            if done % args.save_every == 0 and done != args.steps:
                mgr.save(start + done, params, opt_state)

    mgr.save(start + args.steps, params, opt_state)
    mgr.wait()
    print(f"saved checkpoint at step {start + args.steps} -> {args.ckpt_dir}")
    if device.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(device)} bytes", flush=True)


if __name__ == "__main__":
    main()
