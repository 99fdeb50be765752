"""Training convergence demo: loss ↓ and PSNR above bicubic (the port of
``scripts/train_demo.py``, with its flags, phases and JSON report).

1. L1 phase: fine-tune a small RRDBNet (``training/train.py``) on
   synthetic-fields HR/LR pairs, on the device pipeline (the pool on the
   device, each batch cropped and degraded there; ``--second-order``
   takes the two-stage Real-ESRGAN chain) or the host one
   (``PairSampler`` + ``prefetch``).
2. GAN phase: a short second stage of ``training/gan.py`` (relativistic
   discriminator + perceptual loss) on top of the L1 weights.
3. Held-out evaluation: PSNR/SSIM on unseen scenes against the bicubic
   upsample, at init, after L1 and after GAN; with ``--eval-degraded``
   also on fixed degraded LR (blur 1.0, noise 0.02, JPEG q 60 on the
   host).

Writes one JSON report (default TRAIN_DEMO.json). It runs on CUDA unless
``--cpu``. The bicubic baseline is ``ops/resize.py::upscale_cubic``
(cv2's INTER_CUBIC) rounded to uint8, and the evaluation's JPEG
``tiles/jpeg.py::jpeg_roundtrip`` (libjpeg's arithmetic): the card's
machine has neither cv2 nor PIL.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2500, help="L1 steps")
    ap.add_argument("--chunk", type=int, default=32,
                    help="optimizer steps per call of the chunked trainer "
                         "(1 = one step per call)")
    ap.add_argument("--pipeline", choices=("device", "host"),
                    default="device",
                    help="'device': the pool lives on the device, crops "
                         "sampled and degraded there; 'host': "
                         "PairSampler+prefetch threads")
    ap.add_argument("--gan-steps", type=int, default=40)
    ap.add_argument("--pool", type=int, default=24,
                    help="pre-generated HR training scenes (0 = generate "
                         "a fresh scene per sample; host pipeline only)")
    ap.add_argument("--gan-weight", type=float, default=0.02)
    ap.add_argument("--blur-sigma", type=float, default=0.0,
                    help="gaussian blur on the training LR")
    ap.add_argument("--noise-std", type=float, default=0.0,
                    help="gaussian noise std on the training LR")
    ap.add_argument("--second-order", action="store_true",
                    help="degrade the LR through the two-stage Real-ESRGAN "
                         "chain (training/degradation.py) in place of the "
                         "blur/noise/jpeg knobs; device pipeline only, "
                         "crop a multiple of 16")
    ap.add_argument("--jpeg", default="",
                    help="training-LR JPEG quality range 'QLO,QHI' "
                         "(per-sample uniform)")
    ap.add_argument("--eval-degraded", action="store_true",
                    help="also evaluate on degraded held-out LR (blur 1.0 "
                         "+ noise 0.02 + JPEG q60, fixed, on the host) "
                         "against the bicubic baseline on the same inputs")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--crop", type=int, default=48, help="LR crop size")
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--grow", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--ema-decay", type=float, default=0.0,
                    help="weight EMA decay (0 = off); adds an after_l1_ema "
                         "evaluation of the EMA")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each RRDB block on backward")
    ap.add_argument("--eval-size", type=int, default=192,
                    help="held-out LR eval size (HR = 4x)")
    ap.add_argument("--eval-scenes", type=int, default=3)
    ap.add_argument("--out", default="TRAIN_DEMO.json")
    ap.add_argument("--ckpt-dir", default="",
                    help="save the final params with the training "
                         "CheckpointManager")
    ap.add_argument("--init-ckpt", default="",
                    help="warm-start params from a CheckpointManager dir; "
                         "with --steps 0 this runs a GAN-only fine-tune")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    jpeg_range = None
    if args.jpeg:
        lo, hi = (float(v) for v in args.jpeg.split(","))
        jpeg_range = (lo, hi)

    import torch

    from ..fetch.synthetic import synthetic_fields
    from ..models.engine import resolve_device
    from ..models.rrdbnet import rrdbnet_apply
    from ..ops.resize import upscale_cubic
    from ..training.checkpoint import CheckpointManager
    from ..training.data import PairSampler, area_downsample, prefetch
    from ..training.gan import (GanConfig, UNetDiscriminator,
                                make_device_pool_gan_step,
                                make_gan_train_step)
    from ..training.train import (TrainConfig, init_training,
                                  make_chunked_train_step,
                                  make_device_pool_train_step,
                                  make_optimizer, make_train_step)
    from ..utils.metrics import psnr, ssim

    device = resolve_device("cpu" if args.cpu else "cuda")
    platform = "gpu" if device.type == "cuda" else "cpu"
    if device.type == "cuda":
        # training has no shape-invariance contract: cuDNN's fastest pick
        torch.backends.cudnn.benchmark = True
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # clamp the chunk to the run length, round steps to whole chunks
    # before sizing the cosine schedule
    chunk = (max(1, min(args.chunk, args.steps)) if args.steps
             else max(1, args.chunk))
    device_pipe = args.pipeline == "device" and chunk > 1
    if args.steps % chunk:
        args.steps -= args.steps % chunk
        print(f"rounding L1 steps down to {args.steps} (chunk {chunk})")
    config = TrainConfig(num_feat=args.feat, num_block=args.blocks,
                         num_grow_ch=args.grow, learning_rate=args.lr,
                         lr_decay_steps=args.steps, remat=args.remat,
                         ema_decay=args.ema_decay)
    params, opt_state = init_training(config, seed=0, device=device)
    start_step = 0
    if args.init_ckpt:
        from ..training.train import restore_flexible

        params, opt_state, start_step, _ = restore_flexible(
            CheckpointManager(args.init_ckpt), config, device=device)
        print(f"warm-start params from {args.init_ckpt} "
              f"@ step {start_step}")
    second_order = None
    if args.second_order:
        if not device_pipe:
            raise SystemExit("--second-order needs the device pipeline")
        from ..training.degradation import DegradationConfig

        second_order = DegradationConfig()
    if device_pipe:
        pool_fn, _ = make_device_pool_train_step(
            config, args.crop, args.batch, chunk,
            blur_sigma=args.blur_sigma, noise_std=args.noise_std,
            jpeg_range=jpeg_range, second_order=second_order)
    elif chunk > 1:
        chunk_fn, _ = make_chunked_train_step(config)
    else:
        step_fn, _ = make_train_step(config)

    # --- held-out eval scenes (seeds far outside the sampler's range) --
    scale = config.scale
    eval_pairs = []
    for i in range(args.eval_scenes):
        hr_u8 = synthetic_fields(
            size=(args.eval_size * scale,) * 2, seed=100_000 + i)
        hr = hr_u8.astype(np.float32) / 255.0
        eval_pairs.append((area_downsample(hr, scale), hr_u8))

    def to_u8(x: np.ndarray) -> np.ndarray:
        return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)

    def score(p, pairs) -> dict:
        ps, ss = [], []
        for lr_img, hr_u8 in pairs:
            with torch.no_grad():
                sr = rrdbnet_apply(
                    p, torch.from_numpy(lr_img[None]).to(device),
                    scale=scale, dtype=torch.bfloat16)[0].cpu().numpy()
            sr_u8 = to_u8(sr)
            ps.append(psnr(sr_u8, hr_u8))
            ss.append(ssim(sr_u8, hr_u8))
        return {"psnr": float(np.mean(ps)), "ssim": float(np.mean(ss))}

    def bicubic(pairs) -> dict:
        ps, ss = [], []
        for lr_img, hr_u8 in pairs:
            up = upscale_cubic(torch.from_numpy(to_u8(lr_img)).float(), scale)
            up = up.round().clamp(0, 255).to(torch.uint8).numpy()
            ps.append(psnr(up, hr_u8))
            ss.append(ssim(up, hr_u8))
        return {"psnr": float(np.mean(ps)), "ssim": float(np.mean(ss))}

    # --- degraded held-out eval (fixed blur+noise+JPEG on the LR) ----
    # fixed parameters (not the training ranges), so clean-trained and
    # degradation-trained runs are scored on identical inputs
    eval_deg_pairs = []
    if args.eval_degraded:
        from scipy.ndimage import gaussian_filter

        from ..tiles.jpeg import jpeg_roundtrip

        deg_rng = np.random.default_rng(2024)
        for lr_img, hr_u8 in eval_pairs:
            d = gaussian_filter(lr_img, (1.0, 1.0, 0))
            d = d + deg_rng.normal(0, 0.02, d.shape)
            u8 = np.clip(np.round(d * 255.0), 0, 255).astype(np.uint8)
            dec = jpeg_roundtrip(u8, 60)
            eval_deg_pairs.append((dec.astype(np.float32) / 255.0, hr_u8))

    def evaluate(p) -> dict:
        return score(p, eval_pairs)

    def evaluate_degraded(p) -> dict | None:
        return score(p, eval_deg_pairs) if eval_deg_pairs else None

    baseline = bicubic(eval_pairs)
    at_init = evaluate(params)
    baseline_deg = bicubic(eval_deg_pairs) if eval_deg_pairs else None
    print(f"bicubic baseline: {baseline}")
    print(f"model at init:    {at_init}")
    if baseline_deg:
        print(f"bicubic degraded: {baseline_deg}")

    # --- L1 phase -------------------------------------------------------
    pool = [synthetic_fields(size=(args.crop * scale * 2,) * 2, seed=1 + i)
            for i in range(args.pool)] or None
    sampler = PairSampler(hr_images=pool, crop_lr=args.crop, scale=scale,
                          batch_size=args.batch, seed=1,
                          blur_sigma=args.blur_sigma,
                          noise_std=args.noise_std, jpeg_range=jpeg_range)
    losses = []
    t0 = time.monotonic()
    t_steady = None
    if device_pipe:
        if not pool:
            raise SystemExit("--pipeline device requires --pool > 0")
        pool_dev = torch.from_numpy(
            np.stack(pool).astype(np.float32) / 255.0).to(device)
        gen = torch.Generator(device=device).manual_seed(123)
        groups = args.steps // chunk
        for gi in range(groups):
            params, opt_state, lvec = pool_fn(params, opt_state, pool_dev,
                                              gen)
            losses.append(lvec)
            if gi == 0:
                sync()
                t_steady = time.monotonic()
            if (gi + 1) % 25 == 0 or gi + 1 == groups:
                done = (gi + 1) * chunk
                last = float(lvec[-1])
                rate = ((done - chunk) / (time.monotonic() - t_steady)
                        if done > chunk else 0.0)
                print(f"  L1 {done}/{args.steps} loss {last:.4f} "
                      f"({rate:.1f} steps/s)", flush=True)
    elif chunk > 1:
        it = iter(prefetch(sampler, args.steps, device=device))
        for gi in range(args.steps // chunk):
            pairs = [next(it) for _ in range(chunk)]
            lr_c = torch.stack([p[0] for p in pairs])
            hr_c = torch.stack([p[1] for p in pairs])
            params, opt_state, lvec = chunk_fn(params, opt_state, lr_c, hr_c)
            losses.append(lvec)
            if gi == 0:
                sync()
                t_steady = time.monotonic()
    else:
        for i, (lr_b, hr_b) in enumerate(prefetch(sampler, args.steps,
                                                  device=device)):
            params, opt_state, loss = step_fn(params, opt_state, lr_b, hr_b)
            losses.append(loss.reshape(1))
            if i == 0:
                sync()
                t_steady = time.monotonic()
    sync()
    t1 = time.monotonic()
    loss_np = (torch.cat(losses).float().cpu().numpy() if losses
               else np.zeros(0, np.float32))
    per_call = chunk if chunk > 1 else 1
    steady_rate = ((args.steps - per_call) / (t1 - t_steady)
                   if args.steps > per_call else 0.0)
    if args.steps:
        print(f"L1: {args.steps} steps, loss {loss_np[0]:.4f} -> "
              f"{loss_np[-1]:.4f} (min {loss_np.min():.4f}), "
              f"{steady_rate:.1f} steps/s steady "
              f"(first call {t_steady - t0:.0f}s)")

    # checkpoint the L1 pair now: (params, opt_state) are consistent here
    # (the GAN phase updates params under other optimizers)
    if args.ckpt_dir and args.steps:
        mgr = CheckpointManager(args.ckpt_dir)
        mgr.save(args.steps, params, opt_state)
        print(f"saved L1 params+opt to {args.ckpt_dir} @ {args.steps}")

    after_l1 = evaluate(params)
    print(f"after L1:         {after_l1}")
    after_l1_ema = None
    if args.ema_decay > 0 and args.steps and opt_state.ema is not None:
        after_l1_ema = evaluate(opt_state.ema)
        print(f"after L1 (EMA):   {after_l1_ema}")
    after_l1_deg = evaluate_degraded(params)
    if after_l1_deg:
        print(f"after L1 (degraded LR): {after_l1_deg}")

    # --- GAN phase ------------------------------------------------------
    gan_metrics = []
    after_gan = None
    keys = ("g_loss", "d_loss", "pixel", "adv")
    if args.gan_steps > 0:
        gcfg = GanConfig(base=config, gan_weight=args.gan_weight)
        d_params = UNetDiscriminator(gcfg.num_feat_d).init(
            torch.Generator().manual_seed(7), device)
        mlist = []
        t0 = time.monotonic()
        if device_pipe:
            chunk_g = min(chunk, args.gan_steps)
            args.gan_steps -= args.gan_steps % chunk_g
            gan_run, _, g_tx, d_tx = make_device_pool_gan_step(
                gcfg, args.crop, args.batch, chunk_g,
                blur_sigma=args.blur_sigma, noise_std=args.noise_std,
                jpeg_range=jpeg_range)
            g_opt, d_opt = g_tx.init(params), d_tx.init(d_params)
            gen_g = torch.Generator(device=device).manual_seed(777)
            for gi in range(args.gan_steps // chunk_g):
                params, d_params, g_opt, d_opt, mm = gan_run(
                    params, d_params, g_opt, d_opt, pool_dev, gen_g)
                mlist.append(mm)
                if gi == 0:
                    sync()
                    t_steady = time.monotonic()
        else:
            chunk_g = 1
            gan_step, _, g_tx, d_tx = make_gan_train_step(gcfg)
            g_opt, d_opt = g_tx.init(params), d_tx.init(d_params)
            for i, (lr_b, hr_b) in enumerate(prefetch(
                    sampler, args.gan_steps, device=device)):
                params, d_params, g_opt, d_opt, m = gan_step(
                    params, d_params, g_opt, d_opt, lr_b, hr_b)
                mlist.append({k: m[k].reshape(1) for k in keys})
                if i == 0:
                    sync()
                    t_steady = time.monotonic()
        sync()
        gan_rate = ((args.gan_steps - chunk_g) / (time.monotonic() - t_steady)
                    if args.gan_steps > chunk_g else 0.0)
        stacked = {k: torch.cat([m[k] for m in mlist]).float().cpu().tolist()
                   for k in keys}
        gan_metrics = [{k: stacked[k][i] for k in keys}
                       for i in range(args.gan_steps)]
        print(f"GAN: {args.gan_steps} steps, "
              f"g_loss {gan_metrics[0]['g_loss']:.4f} -> "
              f"{gan_metrics[-1]['g_loss']:.4f}, "
              f"d_loss {gan_metrics[-1]['d_loss']:.4f}, "
              f"pixel {gan_metrics[-1]['pixel']:.4f}, "
              f"{gan_rate:.2f} steps/s steady "
              f"(first call {t_steady - t0:.0f}s)")
        after_gan = evaluate(params)
        print(f"after GAN:        {after_gan}")
        # a GAN-only run checkpoints the post-GAN params with a fresh L1
        # optimizer state (the GAN stage's optimizers are its own)
        if args.ckpt_dir and not args.steps:
            mgr = CheckpointManager(args.ckpt_dir)
            mgr.save(start_step + args.gan_steps, params,
                     make_optimizer(config).init(params))
            print(f"saved post-GAN params to {args.ckpt_dir} "
                  f"@ {start_step + args.gan_steps}")
    if device.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(device)} bytes", flush=True)

    report = {
        "platform": platform,
        "config": {"feat": args.feat, "blocks": args.blocks,
                   "grow": args.grow, "scale": scale, "lr": args.lr,
                   "batch": args.batch, "crop_lr": args.crop,
                   "l1_steps": args.steps, "chunk": chunk,
                   "pipeline": args.pipeline, "remat": args.remat,
                   "gan_steps": args.gan_steps,
                   "pool": args.pool, "gan_weight": args.gan_weight,
                   "eval_lr_size": args.eval_size,
                   "eval_scenes": args.eval_scenes},
        "degradation": {"blur_sigma": args.blur_sigma,
                        "noise_std": args.noise_std,
                        "jpeg_range": list(jpeg_range) if jpeg_range
                        else None,
                        "second_order": bool(second_order)},
        "bicubic": baseline,
        "bicubic_degraded": baseline_deg,
        "model_init": at_init,
        "after_l1": after_l1,
        "after_l1_ema": after_l1_ema,
        "ema_decay": args.ema_decay or None,
        "after_l1_degraded": after_l1_deg,
        "after_gan": after_gan,
        "init_ckpt": args.init_ckpt or None,
        "l1_loss_first": float(loss_np[0]) if len(loss_np) else None,
        "l1_loss_last": float(loss_np[-1]) if len(loss_np) else None,
        "l1_loss_curve_every25": [float(x) for x in loss_np[::25]],
        "l1_steps_per_s_steady": round(steady_rate, 2),
        "gan_metrics_every10": gan_metrics[::10],
        "beats_bicubic": bool(after_l1["psnr"] > baseline["psnr"]),
    }
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}; beats_bicubic={report['beats_bicubic']}")


if __name__ == "__main__":
    main()
