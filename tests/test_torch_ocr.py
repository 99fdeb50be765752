"""The port's OCR and scan flow (``s2sr_tpu_torch/decode/ocr.py``,
``decode/service.py``) against the JAX package's, on the CPU.

Tolerance: the glyph templates and labels element-equal to JAX's
``ocr._atlas()`` (the port loads PIL's glyphs from the committed
``glyphs.npz``); ``ocr_image`` and ``decode_with_retry`` results equal,
text and words exactly and each confidence within 1e-6, on the plates
of JAX's ``tests/test_ocr.py`` and the committed plate fixtures, whose
recorded answers must also equal JAX's current output.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from s2sr_tpu.decode import ocr as j_ocr
from s2sr_tpu.decode import service as j_service
from s2sr_tpu.decode.qr_encode import encode_qr, render as qr_render
from s2sr_tpu_torch.decode import ocr as p_ocr
from s2sr_tpu_torch.decode import service as p_service
from s2sr_tpu_torch.pipelines.io import decode_upload

from test_ocr import FONT_BOLD, FONT_MONO, render
from torch_threads import one_torch_thread  # noqa: F401

CONF_TOL = 1e-6
FIXTURES = Path(__file__).parent / "fixtures_torch"
SANS = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
SERIF = "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf"


def assert_same(got, want, path="") -> None:
    """Equal dicts/lists/values; floats within 1e-6; tuples as lists."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (path, got, want)
        for k, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{k}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= CONF_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _text_img(text, font_path, size, shape, at, mode="L", fg=0, bg=255,
              lines=()):
    font = ImageFont.truetype(font_path, size)
    img = Image.new(mode, shape, bg)
    d = ImageDraw.Draw(img)
    d.text(at, text, fill=fg, font=font)
    for rect in lines:
        d.rectangle(rect, fill=fg)
    return np.asarray(img)


def _two_lines():
    font = ImageFont.truetype(FONT_BOLD, 40)
    img = Image.new("RGB", (430, 160), (245, 245, 240))
    d = ImageDraw.Draw(img)
    d.text((16, 18), "MODEL 8X42", fill=(10, 10, 10), font=font)
    d.text((16, 84), "SERIAL 00912", fill=(10, 10, 10), font=font)
    return np.asarray(img)


PLATES = {
    "serial": lambda: render("SN KBTX-1234567"),
    "inverted": lambda: render("VIN 7890 AC", fg=(240, 240, 235),
                               bg=(20, 24, 28)),
    "two_lines": _two_lines,
    "mono": lambda: render("AB12CD34EF", font_path=FONT_MONO, size=36),
    "blank": lambda: np.full((120, 200, 3), 230, np.uint8),
    "dash": lambda: _text_img("SN-4821-AX", SANS, 48, (400, 144), (8, 48)),
    "serif": lambda: _text_img("MFG-2024-B", SERIF, 48, (10 + 48 * 10, 144),
                               (8, 48)),
    "underline": lambda: _text_img(
        "SN 4821 AX", SANS, 48, (400, 170), (8, 40),
        lines=[(x0, 122, x0 + 18, 125) for x0 in range(10, 360, 28)]),
    "low_quality": lambda: render("KQ4Z-77812X0", size=13, pad=8),
}


def test_atlas_equal():
    want_t, want_l = j_ocr._atlas()
    got_t, got_l = p_ocr._atlas()
    assert got_t.dtype == want_t.dtype and np.array_equal(got_t, want_t)
    assert np.array_equal(got_l, want_l)
    assert p_ocr.CHARSET == j_ocr.CHARSET and p_ocr.available()


@pytest.mark.parametrize("name", list(PLATES))
def test_ocr_image_equal(name):
    img = PLATES[name]()
    want = j_ocr.ocr_image(img)
    got = p_ocr.ocr_image(img, device="cpu")
    assert_same(got, want)


def upscale4(arr):
    return np.kron(arr, np.ones((4, 4, 1), np.uint8))


def _qr_short():
    m = encode_qr("AB12")
    img = np.kron(1 - m, np.ones((8, 8), np.uint8)) * 255
    img = np.pad(img, 32, constant_values=255)
    return np.stack([img] * 3, axis=-1).astype(np.uint8)


def _boom(arr):
    raise RuntimeError("engine unavailable")


FLOWS = {
    # (image, enhance_fn, try_ocr)
    "qr_hit_no_retry": (lambda: _qr_short(), _boom, True),
    "qr_serial_skips_ocr": (lambda: np.stack(
        [qr_render(encode_qr("SN-KBTX-1234567", level="M"))] * 3, -1),
        None, True),
    "ocr_hit": (PLATES["serial"], None, True),
    "low_quality_retry": (PLATES["low_quality"], upscale4, True),
    "low_quality_no_retry": (PLATES["low_quality"], None, True),
    "retry_skipped_above_4mpix": (
        lambda: np.full((2100, 2100, 3), 240, np.uint8), _boom, True),
    "retry_error_recorded": (PLATES["low_quality"], _boom, True),
    "qr_only": (PLATES["serial"], upscale4, False),
}


@pytest.mark.parametrize("name", list(FLOWS))
def test_decode_with_retry_equal(name):
    make, fn, try_ocr = FLOWS[name]
    img = make()
    want = j_service.decode_with_retry(img, enhance_fn=fn, try_ocr=try_ocr)
    got = p_service.decode_with_retry(img, enhance_fn=fn, try_ocr=try_ocr,
                                      device="cpu")
    assert_same(got, want)
    retried = [a["stage"] for a in got["attempts"]]
    if name == "low_quality_retry":
        assert got["retried_with_enhancement"]
        assert got["serial"] == "KQ4Z-77812X0" and retried == ["original",
                                                                "enhanced"]
    if name == "retry_error_recorded":
        assert got["attempts"][-1] == {"stage": "enhanced",
                                       "error": "engine unavailable"}


def test_first_pass_serial_kept_equal(monkeypatch):
    """An enhanced pass with higher OCR confidence but no serial does not
    replace a first pass that found one: both packages, the same fakes."""
    def fake_ocr_factory():
        calls = []

        def fake_ocr(img, device=None):
            calls.append(img.shape)
            if len(calls) == 1:
                return {"available": True, "text": "SN ABCD-12345",
                        "confidence": 55.0,
                        "words": [{"text": "SN", "confidence": 55.0},
                                  {"text": "ABCD-12345", "confidence": 55.0}]}
            return {"available": True, "text": "zzzz qqqq", "confidence": 65.0,
                    "words": [{"text": "zzzz", "confidence": 65.0},
                              {"text": "qqqq", "confidence": 65.0}]}
        return fake_ocr, calls

    outs = []
    for mod in (j_service, p_service):
        fake, calls = fake_ocr_factory()
        monkeypatch.setattr(mod, "decode_qr", lambda img, **kw: None)
        monkeypatch.setattr(mod, "_try_ocr", fake)
        img = np.zeros((32, 32, 3), np.uint8)
        kw = {"device": "cpu"} if mod is p_service else {}
        outs.append(mod.decode_with_retry(img, enhance_fn=lambda a: np.repeat(
            np.repeat(a, 4, 0), 4, 1), **kw))
        assert len(calls) == 2
    assert_same(outs[1], outs[0])
    assert outs[1]["serial"] == "ABCD-12345"


def test_plate_fixtures_match_the_record():
    """Each committed plate fixture: its recorded JAX answers (which
    ``chip_smoke.py`` holds the card to) equal JAX's current output, and
    the port's on the CPU equals them."""
    manifest = json.loads((FIXTURES / "fixtures.json").read_text())
    plates = {k: v for k, v in manifest.items() if "ocr" in v}
    assert len(plates) >= 6
    for name, rec in plates.items():
        img = decode_upload((FIXTURES / name).read_bytes(), name)
        want_ocr = json.loads(json.dumps(j_ocr.ocr_image(img)))
        want_flow = json.loads(json.dumps(j_service.decode_with_retry(
            img, enhance_fn=upscale4)))
        assert_same(rec["ocr"], want_ocr, name)
        assert_same(rec["decode_upscale4"], want_flow, name)
        assert_same(json.loads(json.dumps(p_ocr.ocr_image(img, device="cpu"))),
                    rec["ocr"], name)
        assert_same(json.loads(json.dumps(p_service.decode_with_retry(
            img, enhance_fn=upscale4, device="cpu"))), rec["decode_upscale4"],
            name)
