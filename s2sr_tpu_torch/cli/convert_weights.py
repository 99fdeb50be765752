"""CLI: convert checkpoints to the servable ``.npz`` (the port of
``s2sr_tpu.cli.convert_weights``).

Two sources:
- a released RRDBNet ``.pth`` (state dict, ``params_ema`` / ``params``
  wrappers unwrapped);
- ``--from-ckpt DIR``: a training checkpoint directory of
  ``python -m s2sr_tpu_torch.cli.train`` (its latest step; ``--ema``
  exports the weight EMA).

The ``.npz`` has the JAX package's keys and layout (HWIO kernels, the
RRDB stack on a leading axis), so either package serves it: drop it in
``weights_dir`` as ``<model>.npz``.

Usage: python -m s2sr_tpu_torch.cli.convert_weights PTH [-o OUT.npz]
       python -m s2sr_tpu_torch.cli.convert_weights --from-ckpt DIR \\
           [--family rrdbnet|swinir] [--feat/--blocks/--grow ...] [--ema]
"""
import argparse
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Convert a Real-ESRGAN .pth or a training "
                    "checkpoint dir to servable .npz weights")
    parser.add_argument("pth", nargs="?", default=None,
                        help="released torch .pth checkpoint")
    parser.add_argument("--from-ckpt", default=None, metavar="DIR",
                        help="training checkpoint dir instead of a .pth "
                             "(restores the latest step)")
    parser.add_argument("--family", choices=("rrdbnet", "swinir"),
                        default="rrdbnet",
                        help="--from-ckpt model family (template for the "
                             "restore)")
    parser.add_argument("--embed-dim", type=int, default=60)
    parser.add_argument("--depths", default="2,2")
    parser.add_argument("--heads", default="4,4")
    parser.add_argument("--window", type=int, default=8)
    parser.add_argument("--feat", type=int, default=64,
                        help="--from-ckpt model template: num_feat")
    parser.add_argument("--blocks", type=int, default=23,
                        help="--from-ckpt model template: num_block")
    parser.add_argument("--grow", type=int, default=32,
                        help="--from-ckpt model template: num_grow_ch")
    parser.add_argument("--model-name", default="realesrgan_x4",
                        help="output weight-file stem (the engine model "
                             "name it will serve as)")
    parser.add_argument("--ema", action="store_true",
                        help="--from-ckpt: export the weight EMA (the "
                             "checkpoint must be trained with "
                             "--ema-decay > 0)")
    parser.add_argument("-o", "--output", default=None)
    args = parser.parse_args(argv)
    if bool(args.pth) == bool(args.from_ckpt):
        parser.error("give exactly one of: a .pth path, or --from-ckpt")

    if args.from_ckpt:
        from ..models.weights import save_params, tree_to_numpy
        from ..training.checkpoint import CheckpointManager
        from ..training.train import TrainConfig, ema_params, restore_flexible

        cfg = TrainConfig(family=args.family, num_feat=args.feat,
                          num_block=args.blocks, num_grow_ch=args.grow,
                          embed_dim=args.embed_dim,
                          depths=tuple(int(v) for v in args.depths.split(",")),
                          heads=tuple(int(v) for v in args.heads.split(",")),
                          window=args.window, lr_decay_steps=1,
                          # any > 0 restores the EMA slot; the decay
                          # itself is not stored
                          ema_decay=0.999 if args.ema else 0.0)
        try:
            params, opt, step, _ = restore_flexible(
                CheckpointManager(args.from_ckpt), cfg, device="cpu")
        except (FileNotFoundError, ValueError) as exc:
            raise SystemExit(f"--from-ckpt {args.from_ckpt}: {exc}")
        label = "params"
        if args.ema:
            ema = ema_params(opt)
            if ema is None:
                raise SystemExit("--ema: checkpoint carries no EMA (train "
                                 "with --ema-decay > 0)")
            params, label = ema, "params_ema"
        out = (Path(args.output) if args.output
               else Path(args.from_ckpt) / f"{args.model_name}.npz")
        path = save_params(tree_to_numpy(params), out)
        print(f"Exported step {step} ({label}) -> {path}")
        print(f"Serve it: point weights_dir at {path.parent} "
              f"(model '{args.model_name}')")
        return

    from ..models.weights import convert_checkpoint

    out = (Path(args.output) if args.output
           else Path(args.pth).with_suffix(".npz"))
    path = convert_checkpoint(Path(args.pth), out)
    print(f"Converted -> {path}")


if __name__ == "__main__":
    main()
