"""Write the upload fixtures of this directory and ``fixtures.json``, the
SHA-256 and shape of PIL's ``Image.open(f).convert("RGB")`` bytes of
each, which the port's decoders are held to where PIL is absent
(``chip_smoke.py`` phase server; ``tests/test_torch_decode.py``). A
``.tiff_upload`` file is a TIFF under a name without the ``.tif``
suffix, as an upload reaches the server.

The scan fixtures (``scan_*.png``: serial plates rendered by PIL and a
QR code) also carry the JAX package's answers, which ``chip_smoke.py``
phase decode holds the card to: ``ocr`` (``ocr_image``),
``decode_no_retry`` (``decode_with_retry`` without an engine) and
``decode_upscale4`` (with a ×4 pixel-repeat standing in for the engine).
The OCR's glyph atlas, the six DejaVu faces PIL renders at 64 px, is
written to ``s2sr_tpu_torch/decode/glyphs.npz``.

Run from the repository root, where PIL and the JAX package are
installed:

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
    BMP_CASES, _alpha_photo, _lab_file, _pil_file, _webp, fax_file)
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
        # the TIFF tail: CCITT fax (T.4 2-D, T.6 with FillOrder 2 and
        # photometric 0, Modified Huffman), ZSTD (predictor 2; and a
        # 480×640 one-strip photo: a frame of several blocks with
        # predefined, RLE, FSE and repeated sequence tables), CIELab
        "upload_fax_t4_2d.tiff_upload": fax_file("t4_2d_fill_bits"),
        "upload_fax_t6_fill_order_2.tiff_upload": fax_file("t6_fill_order_2"),
        "upload_fax_mh.tiff_upload": fax_file("mh_photometric_1"),
        "upload_zstd_predictor.tiff_upload": _pil_file(
            Image.fromarray(photo(41, 57, seed=20)), "TIFF", compression="zstd",
            tiffinfo={317: 2}),
        "upload_zstd_large.tiff_upload": _pil_file(
            Image.fromarray(photo(480, 640, seed=3) // 4 * 4), "TIFF",
            compression="zstd", strip_size=1 << 22),
        "upload_lab.tiff_upload": _lab_file(_lab_photo(45, 61, seed=21)),
    }


def _lab_photo(h: int, w: int, seed: int) -> np.ndarray:
    """A photo's channels as CIELab bytes (L; a and b signed, both signs)."""
    rgb = photo(h, w, seed=seed).astype(np.int64)
    return np.stack([rgb[..., 0], rgb[..., 1] - 100, 90 - rgb[..., 2]],
                    -1).astype(np.uint8)


def glyph_patches() -> tuple:
    """The JAX OCR's atlas glyphs, as its ``_atlas`` renders them: each
    face of ``_FONT_FILES`` at 64 px, every ``CHARSET`` character drawn
    at (8, 8) on a 96² canvas, thresholded at 96, cropped tight."""
    from PIL import ImageDraw, ImageFont
    from s2sr_tpu.decode.ocr import CHARSET, _FONT_FILES

    patches, labels = [], []
    for path, _ in _FONT_FILES:
        font = ImageFont.truetype(path, 64)
        for ch in CHARSET:
            img = Image.new("L", (96, 96), 0)
            ImageDraw.Draw(img).text((8, 8), ch, fill=255, font=font)
            a = np.asarray(img) > 96
            ys, xs = np.nonzero(a)
            if len(ys):
                patches.append(a[ys.min():ys.max() + 1, xs.min():xs.max() + 1])
                labels.append(ch)
    return patches, labels


def scan_fixtures() -> dict:
    """Plates as JAX's ``tests/test_ocr.py`` renders them (bold, mono,
    serif, two lines, inverted, and a low-quality one that asks for the
    SR retry) and a QR code, as PNG uploads."""
    from PIL import ImageDraw, ImageFont
    from s2sr_tpu.decode.qr_encode import encode_qr, render as qr_render
    from test_ocr import FONT_BOLD, FONT_MONO, render

    serif = ImageFont.truetype(
        "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf", 48)
    img = Image.new("L", (10 + 48 * 10, 144), 255)
    ImageDraw.Draw(img).text((8, 48), "MFG-2024-B", fill=0, font=serif)
    two = Image.new("RGB", (430, 160), (245, 245, 240))
    d = ImageDraw.Draw(two)
    bold = ImageFont.truetype(FONT_BOLD, 40)
    d.text((16, 18), "MODEL 8X42", fill=(10, 10, 10), font=bold)
    d.text((16, 84), "SERIAL 00912", fill=(10, 10, 10), font=bold)
    plates = {
        "scan_plate_bold.png": render("SN KBTX-1234567"),
        "scan_plate_mono.png": render("AB12CD34EF", font_path=FONT_MONO,
                                      size=36),
        "scan_plate_serif.png": np.asarray(img),
        "scan_plate_two_lines.png": np.asarray(two),
        "scan_plate_inverted.png": render("VIN 7890 AC", fg=(240, 240, 235),
                                          bg=(20, 24, 28)),
        "scan_plate_low_quality.png": render("KQ4Z-77812X0", size=13, pad=8),
        "scan_qr.png": np.stack([qr_render(encode_qr(
            "SN-KBTX-1234567", level="M"))] * 3, -1),
    }
    return {name: _pil_file(Image.fromarray(a), "PNG")
            for name, a in plates.items()}


def upscale4(arr: np.ndarray) -> np.ndarray:
    return np.kron(arr, np.ones((4, 4, 1), np.uint8))


def scan_record(rgb: np.ndarray) -> dict:
    """The JAX package's answers on one scan fixture's RGB decode."""
    from s2sr_tpu.decode.ocr import ocr_image
    from s2sr_tpu.decode.service import decode_with_retry

    rec = {"ocr": ocr_image(rgb),
           "decode_no_retry": decode_with_retry(rgb, enhance_fn=None),
           "decode_upscale4": decode_with_retry(rgb, enhance_fn=upscale4)}
    return json.loads(json.dumps(rec))


def main() -> None:
    from s2sr_tpu_torch.decode.ocr import GLYPHS, pack_glyphs

    np.savez_compressed(GLYPHS, **pack_glyphs(*glyph_patches()))
    manifest = {}
    scans = scan_fixtures()
    for name, data in {**fixtures(), **scans}.items():
        (HERE / name).write_bytes(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        manifest[name] = {"shape": list(rgb.shape),
                          "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
        if name in scans:
            manifest[name].update(scan_record(rgb))
    (HERE / "fixtures.json").write_text(json.dumps(manifest, indent=1) + "\n")


if __name__ == "__main__":
    main()
