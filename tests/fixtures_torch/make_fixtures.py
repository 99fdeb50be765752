"""Write the upload fixtures of this directory and ``fixtures.json``, the
SHA-256 and shape of PIL's ``Image.open(f).convert("RGB")`` bytes of
each, which the port's decoders are held to where PIL is absent
(``chip_smoke.py`` phase server; ``tests/test_torch_decode.py``). A
``.tiff_upload`` file is a TIFF under a name without the ``.tif``
suffix, as an upload reaches the server.

Run from the repository root, where PIL is installed:

    python tests/fixtures_torch/make_fixtures.py
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE.parent.parent))

from test_torch_decode import own_jpeg, photo, pil_jpeg, png_bytes  # noqa: E402
from test_torch_decode_formats import (  # noqa: E402
    BMP_CASES, _alpha_photo, _pil_file, _webp)
from test_torch_decode_jpeg import S420, arith_file  # noqa: E402


def fixtures() -> dict:
    rng = np.random.default_rng(42)
    pal = rng.integers(0, 256, (16, 3))
    return {
        "upload_420.jpg": pil_jpeg(photo(48, 64, seed=1), quality=90,
                                   subsampling=2),
        "upload_progressive_422_restart.jpg": pil_jpeg(
            photo(40, 56, seed=2), quality=85, subsampling=1,
            progressive=True, restart_marker_blocks=4),
        "upload_440_adobe.jpg": own_jpeg(
            photo(33, 47, seed=3), sampling=((1, 2), (1, 1), (1, 1)), app=(),
            adobe_transform=1, restart=3),
        "upload_rgb16_adam7.png": png_bytes(
            rng.integers(0, 65536, (30, 41, 3)), 2, 16, interlace=True, seed=4),
        "upload_palette4_trns.png": png_bytes(
            rng.integers(0, 16, (37, 29, 1)), 3, 4, palette=pal,
            trns=bytes(range(0, 160, 20)), seed=5),
        "upload_gray2_adam7.png": png_bytes(
            rng.integers(0, 4, (23, 31, 1)), 0, 2, interlace=True, seed=6),
        # a photo-sized upload: the card times its decode
        "upload_1024x768.jpg": pil_jpeg(photo(768, 1024, seed=7), quality=90,
                                        subsampling=2),
        "upload_24bit.bmp": _pil_file(Image.fromarray(photo(41, 53, seed=8)),
                                      "BMP"),
        "upload_rle8.bmp": BMP_CASES["rle8_delta"](),
        "upload_bitfields32.bmp": BMP_CASES["bitfields32_abgr"](),
        "upload_interlaced.gif": _pil_file(
            Image.fromarray(photo(45, 61, seed=9)), "GIF", interlace=True),
        "upload_animated.gif": _pil_file(
            Image.fromarray(photo(40, 50, seed=10)), "GIF", save_all=True,
            append_images=[Image.fromarray(photo(40, 50, seed=11))],
            duration=100, loop=0),
        "upload_lossy.webp": _webp(photo(48, 64, seed=12), quality=80),
        "upload_lossy_alpha.webp": _webp(_alpha_photo(40, 56, 13), quality=75),
        "upload_lossless.webp": _webp(photo(37, 53, seed=14), lossless=True),
        "upload_lzw_rgb.tiff_upload": _pil_file(
            Image.fromarray(photo(33, 45, seed=15)), "TIFF",
            compression="tiff_lzw"),
        "upload_gray16.tiff_upload": _pil_file(Image.fromarray(
            (photo(31, 43, seed=16)[..., 0].astype(np.uint16) * 3)), "TIFF"),
        "upload_cmyk.jpg": _pil_file(Image.fromarray(photo(36, 52, seed=17))
                                     .convert("CMYK"), "JPEG", quality=90),
        "upload_arithmetic_progressive.jpg": arith_file(
            photo(40, 56, seed=18), S420, progressive=True, restart=3),
        # a phone photo scaled for upload: the card times its decode and
        # its /api/enhance job
        "upload_1024x768.webp": _webp(photo(768, 1024, seed=19), quality=80),
    }


def main() -> None:
    manifest = {}
    for name, data in fixtures().items():
        (HERE / name).write_bytes(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        manifest[name] = {"shape": list(rgb.shape),
                          "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (HERE / "fixtures.json").write_text(json.dumps(manifest, indent=1) + "\n")


if __name__ == "__main__":
    main()
