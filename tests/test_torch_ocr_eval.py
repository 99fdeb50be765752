"""The port's ``cli/ocr_eval.py`` on the CPU against ``scripts/ocr_eval.py``:
the committed clean renders equal to the script's ``render`` drawn anew,
the noisy renders bit-equal, ``ops/resize.py::resize_pil_bicubic_u8``
byte-equal to PIL's ``BICUBIC``, the recognizer's text and confidence
equal to JAX's ``ocr_image`` on each raw condition, the composed
bicubic flow's serial and attempts equal to JAX's ``decode_with_retry``,
and ``main``'s JSON lines equal to the script's."""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from s2sr_tpu_torch.cli import ocr_eval
from s2sr_tpu_torch.decode.ocr import ocr_image
from s2sr_tpu_torch.decode.service import decode_with_retry
from s2sr_tpu_torch.ops.resize import resize_pil_bicubic_u8
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests" / "fixtures_torch"))

from make_ocr_renders import clean_renders, font_arg, jax_script  # noqa: E402

# the script's raw conditions: (name, render keywords in the port's form)
RAW = [
    ("atlas: DejaVuSans 48px", dict(font="DejaVuSans", size=48)),
    ("serif: DejaVuSerif 48px", dict(font="DejaVuSerif", size=48)),
    ("serif: DejaVuSerif-Bold 48px", dict(font="DejaVuSerif-Bold", size=48)),
    ("held-out: PIL default bitmap", dict(font="default", size=16)),
    ("jitter: noise sigma=20", dict(font="DejaVuSans", size=48, noise=20)),
    ("jitter: rot +3deg", dict(font="DejaVuSans", size=48, rot=3)),
    ("jitter: rot -3deg + noise 12", dict(font="DejaVuSans", size=48, rot=-3,
                                          noise=12)),
    ("small: DejaVuSans 20px", dict(font="DejaVuSans", size=20)),
]


@pytest.fixture(scope="module")
def script():
    """``scripts/ocr_eval.py`` as a module (JAX on the CPU)."""
    return jax_script()


def jax_render(script, text, font, size, **kw):
    return script.render(text, font_arg(font), size, **kw)


def test_serials_equal_the_script(script):
    assert ocr_eval.SERIALS == script.SERIALS


@pytest.mark.parametrize("cond", ocr_eval.CONDITIONS,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]:+d}")
def test_committed_renders_equal_script_render(script, cond):
    font, size, rot = cond
    with np.load(ocr_eval.RENDERS) as z:
        committed = {k: z[k] for k in z.files}
    assert len(committed) == len(ocr_eval.CONDITIONS) * len(ocr_eval.SERIALS)
    for i, text in enumerate(script.SERIALS):
        want = jax_render(script, text, font, size, rot=rot)
        got = committed[ocr_eval.render_key(font, size, rot, i)]
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{cond} {i}")
        np.testing.assert_array_equal(
            ocr_eval.render(text, font, size, rot=rot), want)


def test_generator_draws_what_is_committed(script):
    """``make_ocr_renders.py`` would write the committed arrays."""
    with np.load(ocr_eval.RENDERS) as z:
        assert sorted(z.files) == sorted(clean_renders(script))


@pytest.mark.parametrize("seed", [0, 13])
@pytest.mark.parametrize("kw", [dict(font="DejaVuSans", size=48, noise=20),
                                dict(font="DejaVuSans", size=48, rot=-3,
                                     noise=12)],
                         ids=["noise20", "rot-3+noise12"])
def test_noisy_render_bit_equal(script, seed, kw):
    text = ocr_eval.SERIALS[seed % len(ocr_eval.SERIALS)]
    got = ocr_eval.render(text, seed=seed, **kw)
    want = jax_render(script, text, seed=seed, **kw)
    np.testing.assert_array_equal(got, want)


def pil_bicubic(img: np.ndarray, shape) -> np.ndarray:
    im = Image.fromarray(img)
    return np.asarray(im.resize((shape[1], shape[0]), Image.BICUBIC))


@pytest.mark.parametrize("cond", ocr_eval.CONDITIONS,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]:+d}")
def test_pil_bicubic_x4_on_renders(cond):
    img = ocr_eval.render(ocr_eval.SERIALS[3], *cond[:2], rot=cond[2])
    shape = (img.shape[0] * 4, img.shape[1] * 4)
    got = resize_pil_bicubic_u8(img, shape)
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, pil_bicubic(img, shape))
    rgb = np.stack([img] * 3, -1)
    np.testing.assert_array_equal(resize_pil_bicubic_u8(rgb, shape),
                                  pil_bicubic(rgb, shape))


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("width", [1, 2, 3, 7, 29])
def test_pil_bicubic_random(channels, width):
    """×4 of random L and RGB images, widths 1–3 included, and sizes that
    are not a ×4 (reductions widen PIL's support)."""
    rng = np.random.default_rng(width * 10 + (channels or 1))
    for h in (1, 2, 5, 17):
        img = rng.integers(0, 256, (h, width) + ((channels,) if channels
                                                 else ())).astype(np.uint8)
        for shape in ((h * 4, width * 4), (h * 3 + 1, max(1, width // 2)),
                      (max(1, h // 3), width * 5 + 2)):
            np.testing.assert_array_equal(
                resize_pil_bicubic_u8(img, shape), pil_bicubic(img, shape),
                err_msg=f"{img.shape} -> {shape}")


@pytest.mark.parametrize("case", range(len(RAW)), ids=[n for n, _ in RAW])
def test_ocr_equals_jax_on_each_raw_condition(script, case):
    _, kw = RAW[case]
    text = ocr_eval.SERIALS[case]
    img = ocr_eval.render(text, seed=case, **kw)
    np.testing.assert_array_equal(img, jax_render(script, text, seed=case,
                                                  **kw))
    want = script.ocr_image(img)
    got = ocr_image(img, device="cpu")
    assert got["text"] == want["text"]
    assert abs(got["confidence"] - float(want["confidence"])) <= 1e-6


@pytest.mark.parametrize("kw,case", [
    (dict(font="DejaVuSans", size=20), 0),
    (dict(font="default", size=16), 1)], ids=["DejaVuSans-20", "default-16"])
def test_composed_bicubic_equals_jax(script, kw, case):
    """The scan flow with the bicubic retry: the port's (PIL's arithmetic
    without PIL) against the script's (PIL's resize, JAX's flow)."""
    from s2sr_tpu.decode.service import decode_with_retry as jax_flow

    text = ocr_eval.SERIALS[case]
    rgb = np.stack([ocr_eval.render(text, seed=case, **kw)] * 3, -1)
    want = jax_flow(rgb, enhance_fn=script._bicubic_x4)
    got = decode_with_retry(rgb, enhance_fn=ocr_eval._bicubic_x4,
                            device="cpu")
    assert got["serial"] == want["serial"]
    assert len(got["attempts"]) == len(want["attempts"])
    assert got["retried_with_enhancement"] == want["retried_with_enhancement"]


def lines_of(fn) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [json.loads(ln) for ln in buf.getvalue().splitlines()]


def test_main_prints_the_script_lines(script, monkeypatch):
    """``main --cpu --n 2`` prints the script's eight lines, keys and
    values; ``--composed bicubic`` its four with ``retry_rate``."""
    got = lines_of(lambda: ocr_eval.main(["--cpu", "--n", "2"]))
    monkeypatch.setattr(sys, "argv", ["ocr_eval.py", "--n", "2"])
    want = lines_of(script.main)
    assert got == want and len(got) == len(RAW)
    assert [ln["condition"] for ln in got] == [n for n, _ in RAW]
    for ln in got:
        assert list(ln) == ["condition", "n", "exact_rate", "char_acc"]
        assert ln["n"] == 2
    composed = lines_of(lambda: ocr_eval.main(
        ["--cpu", "--n", "2", "--composed", "bicubic"]))
    assert len(composed) == 4
    for ln in composed:
        assert ln["condition"].startswith("composed+bicubic: ")
        assert list(ln) == ["condition", "n", "exact_rate", "char_acc",
                            "retry_rate"]


def test_missing_renders_file_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(ocr_eval, "RENDERS", tmp_path / "absent.npz")
    ocr_eval._renders.cache_clear()
    try:
        with pytest.raises(FileNotFoundError):
            ocr_eval.render(ocr_eval.SERIALS[0], "DejaVuSans", 48)
    finally:
        ocr_eval._renders.cache_clear()

