"""CLI: convert a released RRDBNet ``.pth`` to the servable ``.npz``
(the port of ``s2sr_tpu.cli.convert_weights``).

Usage: python -m s2sr_tpu_torch.cli.convert_weights PTH [-o OUT.npz]

The ``.npz`` has the JAX package's keys and layout (HWIO kernels, the
RRDB stack on a leading axis), so either package serves it: drop it in
``weights_dir`` as ``<model>.npz``. ``--from-ckpt`` (export a training
checkpoint) needs the training stack, which the port does not have yet
(ROADMAP queue 1 item 15): it is refused with a non-zero exit.
"""
import argparse
from pathlib import Path

FROM_CKPT_REFUSED = (
    "--from-ckpt: the port has no training checkpoints yet (ROADMAP "
    "queue 1 item 15, training); export with the JAX package's "
    "`python -m s2sr_tpu.cli.convert_weights --from-ckpt DIR`, whose "
    ".npz this package loads")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Convert a Real-ESRGAN .pth to servable .npz weights")
    parser.add_argument("pth", nargs="?", default=None,
                        help="released torch .pth checkpoint")
    parser.add_argument("--from-ckpt", default=None, metavar="DIR",
                        help="a training checkpoint dir: refused (ROADMAP "
                             "queue 1 item 15)")
    parser.add_argument("-o", "--output", default=None)
    args, rest = parser.parse_known_args(argv)
    if args.from_ckpt:
        # the JAX CLI's model-template flags come with --from-ckpt only
        raise SystemExit(FROM_CKPT_REFUSED)
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if not args.pth:
        parser.error("give a .pth path")

    from ..models.weights import convert_checkpoint

    out = (Path(args.output) if args.output
           else Path(args.pth).with_suffix(".npz"))
    path = convert_checkpoint(Path(args.pth), out)
    print(f"Converted -> {path}")


if __name__ == "__main__":
    main()
