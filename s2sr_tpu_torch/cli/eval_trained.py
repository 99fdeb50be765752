"""End-to-end quality eval: trained weights through the serving path (the
port of ``scripts/eval_trained.py``, with its flags, steps and JSON
report).

Takes a checkpoint written by the in-repo trainer (``cli/train_demo.py
--ckpt-dir``, in ``training/checkpoint.py``'s format), writes it through
the engine's own weights format, builds a real ``SREngine`` from that
file and measures PSNR/SSIM on held-out scenes against the bicubic
baseline, through ``enhance()`` (the product serving path: uint8 in,
bucket or halo tiling, uint8 truncation out), not a bare model forward.
The engine runs ``--dtype``: bfloat16 and float32 serve every residual
dense block through the ``rdb`` kernel, int8 the mixed trunk through
``rdb_i8``.

The engine is built with ``bgr_order=False``: the demo checkpoints are
trained on RGB batches, unlike the released Real-ESRGAN weights (trained
BGR, which the engine's default flip reproduces).

The bicubic baseline is ``ops/resize.py::upscale_cubic`` rounded and
clipped to uint8, the port's stand-in for ``cv2.resize(INTER_CUBIC)``
(the card's machine has no cv2). On the eval's own scenes (192² LR of
``synthetic_fields(768², seed)``) it differs from cv2 by 1 on 2.3e-6
(seed 100000), 3.4e-6 (100001) and 3.4e-6 (100002) of the values and
nowhere by more, which moves the bicubic PSNR by −1.4e-7, −5.7e-7 and
0 dB (``tests/test_torch_eval_trained.py::
test_bicubic_stand_in_against_cv2``).

Two departures from the JAX script, neither a new feature: the weights
go to a fresh temporary directory (not a fixed path two runs would race
on), and the checkpoint is the port's own format (the JAX package writes
orbax checkpoints). Runs on CUDA unless ``--cpu``. Writes one JSON report
(default EVAL_TRAINED.json).
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", required=True,
                    help="CheckpointManager dir from cli/train_demo.py")
    ap.add_argument("--feat", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=23)
    ap.add_argument("--grow", type=int, default=32)
    ap.add_argument("--eval-size", type=int, default=192,
                    help="held-out LR eval size (HR = 4x)")
    ap.add_argument("--eval-scenes", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32", "int8"))
    ap.add_argument("--out", default="EVAL_TRAINED.json")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def eval_scenes(eval_size: int, count: int, scale: int = 4):
    """The held-out scenes, one at a time: (seed, HR uint8, LR uint8) for
    seeds 100_000 + i, HR ``synthetic_fields`` of ``eval_size · scale``
    square, LR its area downsample rounded and clipped to uint8."""
    from ..fetch.synthetic import synthetic_fields
    from ..training.data import area_downsample

    for i in range(count):
        seed = 100_000 + i
        hr_u8 = synthetic_fields(size=(eval_size * scale,) * 2, seed=seed)
        lr_u8 = np.clip(np.round(
            area_downsample(hr_u8.astype(np.float32), scale)), 0, 255
        ).astype(np.uint8)
        yield seed, hr_u8, lr_u8


def run(args) -> tuple:
    """The eval of parsed ``args`` → (report, the engine that served it);
    writes the report to ``args.out``."""
    import torch

    from ..models.engine import SREngine, resolve_device
    from ..models.weights import save_params, tree_to_numpy
    from ..ops.resize import upscale_cubic
    from ..training.checkpoint import CheckpointManager
    from ..training.train import TrainConfig, restore_flexible
    from ..utils.metrics import psnr, ssim

    device = resolve_device("cpu" if args.cpu else "cuda")
    mgr = CheckpointManager(args.ckpt_dir)
    cfg = TrainConfig(num_feat=args.feat, num_block=args.blocks,
                      num_grow_ch=args.grow, lr_decay_steps=1)
    params, _, step, _ = restore_flexible(mgr, cfg, device=device)
    print(f"restored step {step} from {args.ckpt_dir}")

    with tempfile.TemporaryDirectory(prefix="eval_trained_weights_") as wd:
        save_params(tree_to_numpy(params), Path(wd) / "realesrgan_x4.npz")
        engine = SREngine("realesrgan_x4", weights_dir=wd, dtype=args.dtype,
                          bgr_order=False, device=device)
    if not engine.pretrained:
        raise RuntimeError("the engine did not load the written weights")

    scale = engine.scale
    rows = []
    for seed, hr_u8, lr_u8 in eval_scenes(args.eval_size, args.eval_scenes,
                                          scale):
        sr_u8 = engine.enhance(lr_u8)           # the real serving path
        bi_u8 = upscale_cubic(torch.from_numpy(lr_u8).float(), scale)
        bi_u8 = bi_u8.round().clamp(0, 255).to(torch.uint8).numpy()
        rows.append({
            "seed": seed,
            "engine_psnr": psnr(sr_u8, hr_u8),
            "engine_ssim": ssim(sr_u8, hr_u8),
            "bicubic_psnr": psnr(bi_u8, hr_u8),
            "bicubic_ssim": ssim(bi_u8, hr_u8),
        })
        print(rows[-1])

    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in rows[0] if k != "seed"}
    report = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "ckpt_step": int(step),
        "config": {"feat": args.feat, "blocks": args.blocks,
                   "grow": args.grow, "dtype": args.dtype,
                   "eval_lr_size": args.eval_size,
                   "eval_scenes": args.eval_scenes},
        "scenes": rows,
        "mean": mean,
        "beats_bicubic": bool(mean["engine_psnr"] > mean["bicubic_psnr"]),
    }
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}; beats_bicubic={report['beats_bicubic']} "
          f"(engine {mean['engine_psnr']:.2f} dB vs bicubic "
          f"{mean['bicubic_psnr']:.2f} dB)")
    return report, engine


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))[0]


if __name__ == "__main__":
    main()
