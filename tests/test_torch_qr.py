"""The port's QR decode (``s2sr_tpu_torch/decode/``: tables, GF(256) and
Reed–Solomon, the encoder, the matrix decoder, the binarizer in torch,
the locator and ``decode_qr``) against the JAX package's
(``s2sr_tpu/decode/``), on the CPU.

Tolerance: equal. Tables, codewords, matrices and results element-equal
(``location`` within 1e-6, though it comes out equal); the binarizer's
bool maps equal to jitted JAX's on every image a test decodes (both
polarities come from one map) and on a seeded random corpus, where the
count of differing pixels is pinned at 0: the port repeats XLA's order
of float32 additions (``decode/locate.py``). Images are the JAX tests'
(``tests/test_qr.py``): cv2's warps, blur and resize make them here.
"""

import dataclasses
import random
import string
from unittest import mock

import cv2
import numpy as np
import pytest

from s2sr_tpu.decode import galois as j_galois
from s2sr_tpu.decode import locate as j_locate
from s2sr_tpu.decode import qr_decode as j_qr
from s2sr_tpu.decode import qr_encode as j_enc
from s2sr_tpu.decode import qr_tables as j_tables
from s2sr_tpu.decode import serial as j_serial
from s2sr_tpu_torch.decode import galois as p_galois
from s2sr_tpu_torch.decode import locate as p_locate
from s2sr_tpu_torch.decode import qr_decode as p_qr
from s2sr_tpu_torch.decode import qr_encode as p_enc
from s2sr_tpu_torch.decode import qr_tables as p_tables
from s2sr_tpu_torch.decode import serial as p_serial
from torch_threads import one_torch_thread  # noqa: F401

PAYLOAD = "KBTX1234567890123"
LOCATION_TOL = 1e-6


def qr_fields(res) -> dict | None:
    return None if res is None else dataclasses.asdict(res)


def assert_same_result(got, want) -> None:
    """Two ``QRResult`` dicts (or None) equal, ``location`` within 1e-6."""
    assert (got is None) == (want is None), (got, want)
    if want is None:
        return
    got, want = dict(got), dict(want)
    loc_g, loc_w = got.pop("location"), want.pop("location")
    assert got == want
    assert (loc_g is None) == (loc_w is None)
    if loc_w is not None:
        assert np.allclose(np.asarray(loc_g, float), np.asarray(loc_w, float),
                           rtol=0, atol=LOCATION_TOL)


def decode_both(img):
    want = qr_fields(j_qr.decode_qr(img))
    got = qr_fields(p_qr.decode_qr(img, device="cpu"))
    assert_same_result(got, want)
    return got


def maps_equal(img) -> None:
    """The port's bool maps equal jitted JAX's at every scale decode_qr
    binarizes, in both pad modes."""
    for s in (1, 2, 4):
        view = img[::s, ::s] if s > 1 else img
        if min(view.shape[:2]) < 21:
            break
        for mode in ("white", "edge"):
            want = j_locate.binarize(view, pad_mode=mode)
            got = p_locate.binarize(view, pad_mode=mode, device="cpu")
            assert got.dtype == bool and np.array_equal(got, want), (s, mode)


def symbol_from_bits(enc, bits, version: int, level: str, mask: int = 0):
    """A symbol whose data stream is ``bits`` (any segment modes), built
    by the encoder ``enc`` around them: terminator, pad bytes, RS blocks,
    interleave, function patterns, format and mask."""
    with mock.patch.object(enc, "_encoded_bits", lambda *a: list(bits)):
        return enc.encode_qr("x", level=level, version=version, mask=mask)


def bitlist(s: str) -> list:
    return [int(c) for c in s]


# Kanji "あ", ECI 26 (UTF-8) with byte "HI", structured append + "PART-1"
SEGMENT_STREAMS = {
    "kanji": "1000" + f"{1:08b}" + f"{288:013b}",
    "eci": "0111" + "00011010" + "0100" + f"{2:08b}"
           + "".join(f"{ord(c):08b}" for c in "HI"),
    "eci_2byte": "0111" + "1000000000011010" + "0100" + f"{2:08b}"
                 + "".join(f"{ord(c):08b}" for c in "HI"),
    "structured_append": "0011" + "0" * 16 + "0100" + f"{6:08b}"
                         + "".join(f"{b:08b}" for b in b"PART-1"),
}


# --- tables, GF(256), Reed–Solomon ------------------------------------------------

def test_tables_equal():
    for name in ("MAX_VERSION", "ECL_BITS", "ECL_FROM_BITS", "ALIGNMENT",
                 "EC_BLOCKS", "FORMAT_MASK", "FORMAT_GEN", "VERSION_GEN",
                 "FORMAT_WORDS"):
        assert getattr(p_tables, name) == getattr(j_tables, name), name
    ii, jj = np.mgrid[:40, :40]
    for v in range(1, 41):
        assert p_tables.total_codewords(v) == j_tables.total_codewords(v)
        assert p_tables.size_for_version(v) == j_tables.size_for_version(v)
        if v >= 7:
            assert p_tables.bch_version(v) == j_tables.bch_version(v)
        for level in "LMQH":
            assert p_tables.data_capacity(v, level) == \
                j_tables.data_capacity(v, level)
    for m in range(8):
        assert np.array_equal(p_tables.mask_fn(m)(ii, jj),
                              j_tables.mask_fn(m)(ii, jj))
    assert np.array_equal(p_galois.EXP, j_galois.EXP)
    assert np.array_equal(p_galois.LOG, j_galois.LOG)


def test_reed_solomon_equal():
    rng = np.random.default_rng(3)
    for trial in range(40):
        nsym = int(rng.integers(2, 31))
        data = rng.integers(0, 256, int(rng.integers(1, 120))).astype(np.int32)
        cw = p_galois.rs_encode(data, nsym)
        assert np.array_equal(cw, j_galois.rs_encode(data, nsym))
        bad = cw.copy()
        n_err = int(rng.integers(0, nsym // 2 + 3))
        pos = rng.choice(len(bad), min(n_err, len(bad)), replace=False)
        bad[pos] ^= rng.integers(1, 256, len(pos)).astype(np.int32)
        try:
            want = j_galois.rs_decode(bad, nsym)
        except Exception as exc:  # noqa: BLE001 - both must refuse alike
            with pytest.raises(type(exc)):
                p_galois.rs_decode(bad, nsym)
            continue
        got = p_galois.rs_decode(bad, nsym)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


# --- the encoder and the matrix decoder --------------------------------------------

@pytest.mark.parametrize("level", list("LMQH"))
def test_encode_qr_equal(level):
    """Seeded payloads (numeric, alphanumeric, byte) at a sample of
    versions 1-40 and the encoder's own version choice."""
    rng = random.Random(f"enc-{level}")
    alphabets = (string.digits, string.ascii_uppercase + string.digits + " $%*+-./:",
                 string.ascii_letters + string.digits + "é²")
    for version in (1, 2, 5, 7, 10, 13, 17, 21, 25, 30, 34, 40):
        alpha = alphabets[version % 3]
        cap = j_tables.data_capacity(version, level)
        text = "".join(rng.choices(alpha, k=max(1, cap // 3)))
        want = j_enc.encode_qr(text, level=level, version=version)
        assert np.array_equal(p_enc.encode_qr(text, level=level,
                                              version=version), want)
    text = "".join(rng.choices(string.ascii_uppercase, k=40))
    assert np.array_equal(p_enc.encode_qr(text, level=level),
                          j_enc.encode_qr(text, level=level))
    assert np.array_equal(p_enc.render(p_enc.encode_qr(text, level=level), 3, 2),
                          j_enc.render(j_enc.encode_qr(text, level=level), 3, 2))


def test_decode_matrix_equal():
    """Clean, module-error, mirrored and segment-mode symbols (Kanji,
    ECI, structured append), and a refused one."""
    rng = np.random.default_rng(5)
    mats = []
    for level, version in (("L", 1), ("M", 5), ("Q", 10), ("H", 25), ("M", 40)):
        m = j_enc.encode_qr(f"S2SR-{version}{level}" * 3, level=level,
                            version=version)
        mats.append(m)
        noisy = m.copy()
        idx = rng.choice(m.size, 6 + version, replace=False)
        noisy.flat[idx] ^= True
        mats.append(noisy)
        mats.append(m.T.copy())
    for name, stream in SEGMENT_STREAMS.items():
        mats.append(symbol_from_bits(j_enc, bitlist(stream), 2, "M"))
    junk = rng.random((25, 25)) > 0.5
    mats.append(junk)
    for m in mats:
        try:
            want = qr_fields(j_qr.decode_matrix(m))
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc)[:20]):
                p_qr.decode_matrix(m)
            continue
        assert_same_result(qr_fields(p_qr.decode_matrix(m)), want)
    texts = [p_qr.decode_matrix(symbol_from_bits(p_enc, bitlist(s), 2, "M")).text
             for s in SEGMENT_STREAMS.values()]
    assert texts == ["あ", "HI", "HI", "PART-1"]


# --- the binarizer --------------------------------------------------------------

def _corpus():
    """A seeded random corpus: uniform noise, smooth fields with noise
    (gray and RGB), gradients, and rendered codes with blur and noise, at
    shapes that span a few 256-multiple buckets and odd edges."""
    rng = np.random.default_rng(2024)
    shapes = [(100, 130), (256, 256), (300, 200), (480, 640), (37, 500),
              (513, 257)]
    out = []
    for k in range(24):
        h, w = shapes[k % len(shapes)]
        kind = k % 4
        if kind == 0:
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        elif kind == 1:
            base = rng.random((h // 16 + 2, w // 16 + 2)) * 255
            img = np.kron(base, np.ones((16, 16)))[:h, :w]
            img = np.clip(img + rng.normal(0, 15, (h, w)), 0, 255).astype(np.uint8)
        elif kind == 2:
            ramp = np.linspace(0, 255, w)[None, :] + np.linspace(0, 80, h)[:, None]
            img = np.stack([np.clip(ramp, 0, 255)] * 3, -1)
            img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)
        else:
            m = j_enc.encode_qr("".join(rng.choice(list("ABC0123")) for _ in range(30)))
            img = j_enc.render(m, scale=int(rng.integers(2, 6)), border=2)
            img = cv2.GaussianBlur(img, (3, 3), 0.8)
            img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
        out.append(img)
    return out


# pinned: pixels where the port's map differs from jitted JAX's over the
# corpus (0 since the port repeats XLA's order of additions)
CORPUS_DIFFERING_PIXELS = 0


def test_binarize_seeded_corpus_count():
    diff = 0
    for img in _corpus():
        want = j_locate.binarize(img)
        got = p_locate.binarize(img, device="cpu")
        diff += int((got != want).sum())
    assert diff == CORPUS_DIFFERING_PIXELS


def test_cumsum_in_xla_order():
    """The integral image's cumulative sums equal jitted ``jnp.cumsum``
    bit for bit at lengths that take one, two and three levels of XLA's
    chunked rewrite."""
    import jax
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(9)
    for n in (5, 16, 17, 96, 250, 300):
        x = (rng.random((n, 7)) * 255).astype(np.float32)
        want = np.asarray(jax.jit(lambda a: jnp.cumsum(jnp.cumsum(a, 0), 1))(x))
        got = p_locate._cumsum(p_locate._cumsum(torch.from_numpy(x), 0), 1)
        assert np.array_equal(got.numpy(), want), n


def test_binarize_raises_without_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_locate.binarize(np.zeros((30, 30), np.uint8))


# --- decode_qr on the JAX tests' images -------------------------------------------

def _base():
    return j_enc.render(j_enc.encode_qr(PAYLOAD, level="M"), scale=8, border=4)


def _rotated25(b):
    h, w = b.shape
    M = cv2.getRotationMatrix2D((w / 2, h / 2), 25, 0.8)
    return cv2.warpAffine(b, M, (w, h), borderValue=255)


def _perspective(b):
    h, w = b.shape
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = np.float32([[20, 12], [w - 8, 25], [w - 30, h - 15], [6, h - 38]])
    return cv2.warpPerspective(b, cv2.getPerspectiveTransform(src, dst),
                               (w, h), borderValue=255)


def _noise_blur(b):
    rng = np.random.default_rng(1234)
    img = cv2.GaussianBlur(b, (5, 5), 1.2).astype(np.int16)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def _embedded(b):
    bg = np.linspace(60, 200, 640).astype(np.uint8)[None, :].repeat(480, 0)
    bg = np.stack([bg] * 3, -1).copy()
    small = cv2.resize(b, (200, 200), interpolation=cv2.INTER_AREA)
    bg[140:340, 220:420] = small[..., None]
    return bg


IMAGES = {
    "plain": lambda b: b,
    "inverted": lambda b: 255 - b,
    "rot90": lambda b: np.rot90(b).copy(),
    "rotated25": _rotated25,
    "perspective": _perspective,
    "noise_blur": _noise_blur,
    "embedded_rgb": _embedded,
    "rgb": lambda b: np.stack([b] * 3, -1),
    "mirrored": lambda b: b[:, ::-1].copy(),
    "no_code": lambda b: np.random.default_rng(0).integers(
        0, 255, (256, 256), dtype=np.uint8),
}


@pytest.mark.parametrize("name", list(IMAGES))
def test_decode_qr_equal(name):
    img = IMAGES[name](_base())
    got = decode_both(img)
    if name == "no_code":
        assert got is None
    else:
        assert got is not None and got["text"] == PAYLOAD
        assert got["inverted"] == (name == "inverted")
        assert got["mirrored"] == (name == "mirrored")
    maps_equal(img)


def _fuzz_case(i: int):
    """Case ``i`` of a seeded corpus built as JAX's ``test_fuzz_decode_rate``
    builds its own (random payload, level, scale; rotation, perspective,
    or blur and noise, sometimes inverted)."""
    rng = np.random.default_rng(1000 + i)
    pick = random.Random(11 + i)
    n = int(rng.integers(5, 60))
    payload = "".join(pick.choices(string.ascii_uppercase + string.digits + "-",
                                   k=n))
    level = pick.choice("LMQH")
    scale = int(rng.integers(4, 12))
    img = j_enc.render(j_enc.encode_qr(payload, level=level), scale=scale,
                       border=4)
    h, w = img.shape
    mode = i % 4
    if mode == 1:
        M = cv2.getRotationMatrix2D((w / 2, h / 2), float(rng.uniform(-40, 40)),
                                    float(rng.uniform(0.7, 1.0)))
        img = cv2.warpAffine(img, M, (w, h), borderValue=255)
    elif mode == 2:
        def j():
            return float(rng.uniform(0, 0.08))
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        dst = np.float32([[w * j(), h * j()], [w * (1 - j()), h * j()],
                          [w * (1 - j()), h * (1 - j())],
                          [w * j(), h * (1 - j())]])
        img = cv2.warpPerspective(img, cv2.getPerspectiveTransform(src, dst),
                                  (w, h), borderValue=255)
    elif mode == 3:
        img = cv2.GaussianBlur(img, (3, 3), float(rng.uniform(0.3, 1.0)))
        img = np.clip(img.astype(np.int16) + rng.normal(0, 8, img.shape),
                      0, 255).astype(np.uint8)
        if i % 8 == 3:
            img = 255 - img
    return payload, img


@pytest.mark.parametrize("i", range(12))
def test_decode_qr_fuzz_subset_equal(i):
    """Image by image, not by rate: the port's result equals JAX's on
    each seeded case, decoded or not."""
    _, img = _fuzz_case(i)
    decode_both(img)


# --- serial extraction and the retry policy ---------------------------------------

SERIAL_CASES = [
    ("pin: KBTX1234567890123 qty 4", None),
    ("AB12345678 and KBTX1234567890123", None),
    ("20240101123456 SN-ABC123456789", None),
    ("hello world, no serials here", None),
    ("ABCDEF7890123 ZZTOP123456789",
     [{"text": "ZZTOP123456789", "confidence": 95.0}]),
    ("sn: kbtx-1234567 / lot 99-88-77", [{"text": "KBTX-1234567",
                                          "confidence": 40.0}]),
    ("", None),
]
RETRY_CASES = [(100.0, None), (59.0, "KBTX1234567890123"), (95.0, "AB-12"),
               (95.0, "KBTX1234567890123"), (60.0, "ABCDEFGHIJ")]


def test_extract_serial_and_retry_policy_equal():
    for text, words in SERIAL_CASES:
        assert p_serial.extract_serial(text, words) == \
            j_serial.extract_serial(text, words)
    for conf, serial in RETRY_CASES:
        assert p_serial.should_retry_with_enhancement(conf, serial) == \
            j_serial.should_retry_with_enhancement(conf, serial)
