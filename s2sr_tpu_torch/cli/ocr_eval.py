"""Accuracy envelope of the in-repo OCR (the port of
``scripts/ocr_eval.py``, with its conditions, flags and JSON lines).

Evaluates :mod:`s2sr_tpu_torch.decode.ocr` on held-out conditions:

- DejaVuSerif / DejaVuSerif-Bold at 48 px (in the atlas since the JAX
  package's r4 widening);
- PIL's default font (not DejaVu at all; held out);
- jitter on an atlas font: additive Gaussian noise, ±3° rotations, a
  20 px render size.

Each condition prints one JSON line: ``condition``, ``n``,
``exact_rate`` (the whole serial read) and ``char_acc``
(``difflib.SequenceMatcher``'s ratio); ``--composed`` runs the failing
conditions through the scan flow (``decode/service.py::
decode_with_retry``: QR miss → OCR → SR retry) and adds ``retry_rate``.
``--composed bicubic`` upscales the retry with PIL's bicubic
(:func:`..ops.resize.resize_pil_bicubic_u8`, byte-equal to PIL), and
``--composed engine`` with the resident ``realesrgan_x4``
(``models/engine.py::get_engine``, random init without weights in
``models/``), whose residual dense blocks run the ``rdb`` kernel.

The card's machine has no PIL, so the clean renders of the JAX script's
``render`` are committed, one per serial for each (font, size, rotation)
of :data:`CONDITIONS`, in ``decode/ocr_eval_renders.npz``
(``tests/fixtures_torch/make_ocr_renders.py`` writes it); :func:`render`
adds the seeded noise as the script does. The scans binarize on the card
unless ``--cpu``.

Usage: ``python -m s2sr_tpu_torch.cli.ocr_eval [--n 10] [--composed
off|bicubic|engine] [--cpu]``
"""

from __future__ import annotations

import argparse
import difflib
import functools
import json
from pathlib import Path

import numpy as np

SERIALS = [
    "SN-4821-AX", "PLATE-0092", "A7B2-C9D4", "UP42-POC-17", "XK-3305",
    "S2SR-88-Q", "LOT-7741-Z", "MFG-2024-B", "RRDB-23-X4", "TPU-V5E-01",
]
RENDERS = (Path(__file__).resolve().parent.parent / "decode"
           / "ocr_eval_renders.npz")
# (font, size in px, rotation in degrees) of every committed clean
# render: "default" is PIL's default font, any other name a DejaVu face
CONDITIONS = (("DejaVuSans", 48, 0), ("DejaVuSerif", 48, 0),
              ("DejaVuSerif-Bold", 48, 0), ("default", 16, 0),
              ("DejaVuSans", 48, 3), ("DejaVuSans", 48, -3),
              ("DejaVuSans", 20, 0), ("DejaVuSans", 14, 0))


def render_key(font: str, size: int, rot: float, index: int) -> str:
    """The renders file's name of ``SERIALS[index]`` under a condition."""
    return f"{font}-{size}px-rot{rot:+g}/{index}"


@functools.lru_cache(maxsize=1)
def _renders() -> dict:
    with np.load(RENDERS) as z:
        return {k: z[k] for k in z.files}


def render(text, font, size, noise=0.0, rot=0.0, seed=0):
    """The JAX script's ``render(text, font, size, noise, rot, seed)``:
    the committed clean render of ``text`` (a serial of
    :data:`SERIALS`), with ``default_rng(seed)``'s Gaussian noise of
    standard deviation ``noise`` added in float and clipped to uint8."""
    a = _renders()[render_key(font, size, rot, SERIALS.index(text))]
    a = a.astype(np.float32)
    if noise:
        a = a + np.random.default_rng(seed).normal(0, noise, a.shape)
    return np.clip(a, 0, 255).astype(np.uint8)


def _cases(n: int) -> list:
    return [SERIALS[i % len(SERIALS)] for i in range(n)]


def _line(name: str, exact: int, char_acc: list, **extra) -> None:
    total = len(char_acc)
    print(json.dumps({
        "condition": name, "n": total,
        "exact_rate": round(exact / total, 3),
        "char_acc": round(float(np.mean(char_acc)), 3),
        **{k: round(v / total, 3) for k, v in extra.items()},
    }), flush=True)


def evaluate(name, n, *, device="cuda", **kw):
    """The raw recognizer on ``n`` renders of one condition."""
    from ..decode.ocr import ocr_image

    exact = 0
    char_acc = []
    for i, text in enumerate(_cases(n)):
        img = render(text, seed=i, **kw)
        got = ocr_image(img, device=device)["text"].replace(" ", "")
        want = text.replace(" ", "")
        exact += got == want
        char_acc.append(difflib.SequenceMatcher(None, got, want).ratio())
    _line(name, exact, char_acc)


def evaluate_composed(name, n, enhance_fn, *, device="cuda", **kw):
    """The product's scan flow (QR miss → OCR → SR-enhanced retry) on
    ``n`` renders of one condition; the final serial is the outcome."""
    from ..decode.service import decode_with_retry

    exact = 0
    char_acc = []
    retried = 0
    for i, text in enumerate(_cases(n)):
        img = render(text, seed=i, **kw)
        rgb = np.stack([img] * 3, axis=-1)
        res = decode_with_retry(rgb, enhance_fn=enhance_fn, device=device)
        got = (res.get("serial") or "").replace(" ", "")
        want = text.replace(" ", "")
        exact += got == want
        retried += len(res.get("attempts", [])) > 1
        char_acc.append(difflib.SequenceMatcher(None, got, want).ratio())
    _line(name, exact, char_acc, retry_rate=retried)


def _bicubic_x4(arr):
    from ..ops.resize import resize_pil_bicubic_u8

    return resize_pil_bicubic_u8(arr, (arr.shape[0] * 4, arr.shape[1] * 4))


def _engine_x4(device):
    from ..models.engine import get_engine

    return get_engine("realesrgan_x4", weights_dir="models",
                      device=str(device)).enhance_serving


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--composed", choices=("off", "bicubic", "engine"),
                    default="off",
                    help="run the FAILING raw conditions through the "
                         "decode service's SR-retry flow instead of "
                         "the raw recognizer; 'engine' uses the "
                         "resident SR engine (random init when no "
                         "weights are in models/ — the offline product "
                         "answer), 'bicubic' the information floor")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..models.engine import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.composed != "off":
        fn = (_bicubic_x4 if args.composed == "bicubic"
              else _engine_x4(device))
        tag = f"composed+{args.composed}"
        for name, kw in (
                ("DejaVuSans 20px", dict(font="DejaVuSans", size=20)),
                ("DejaVuSans 14px", dict(font="DejaVuSans", size=14)),
                ("PIL default bitmap", dict(font="default", size=16)),
                ("noise sigma=20", dict(font="DejaVuSans", size=48,
                                        noise=20))):
            evaluate_composed(f"{tag}: {name}", args.n, fn, device=device,
                              **kw)
        return
    for name, kw in (
            # atlas font baseline (sanity: should be ~perfect)
            ("atlas: DejaVuSans 48px", dict(font="DejaVuSans", size=48)),
            # serif faces (in the atlas; the bitmap row stays held out)
            ("serif: DejaVuSerif 48px", dict(font="DejaVuSerif", size=48)),
            ("serif: DejaVuSerif-Bold 48px",
             dict(font="DejaVuSerif-Bold", size=48)),
            ("held-out: PIL default bitmap", dict(font="default", size=16)),
            # jitter on an atlas font
            ("jitter: noise sigma=20", dict(font="DejaVuSans", size=48,
                                            noise=20)),
            ("jitter: rot +3deg", dict(font="DejaVuSans", size=48, rot=3)),
            ("jitter: rot -3deg + noise 12", dict(font="DejaVuSans", size=48,
                                                  rot=-3, noise=12)),
            ("small: DejaVuSans 20px", dict(font="DejaVuSans", size=20))):
        evaluate(name, args.n, device=device, **kw)


if __name__ == "__main__":
    main()
