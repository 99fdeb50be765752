"""The port's native PNG encoder (``s2sr_tpu_torch/native/pngenc.cc``,
loaded by ``native/__init__.py``, taken by ``tiles/png.py::encode_png``)
against the JAX package's ``s2sr_tpu/native`` on the CPU.

Tolerance: the bytes equal JAX's native encoder's (the same libpng calls:
the Sub filter on every row, the same level); the decoded pixels equal
the pure-Python path's. The zlib-only build (for a machine without
libpng's headers) is byte-equal to the pure path (compress2 at the level
is ``zlib.compress``). Tests that build skip only where ``g++`` or
``png.h`` is absent, and say so.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

from s2sr_tpu.tiles import png as jpng
from s2sr_tpu_torch import native
from s2sr_tpu_torch.ops import _build
from s2sr_tpu_torch.tiles import png
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(256, 256, 4), (17, 23, 3), (9, 6), (8, 5, 2), (1, 1, 4),
          (300, 7, 3)]


@pytest.fixture(scope="module")
def toolchain():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native encoder cannot build here")
    if not Path("/usr/include/png.h").exists():
        pytest.skip("png.h (libpng's headers) is absent: the libpng build "
                    "cannot run here")
    return native.load()


def tile(shape, seed=0):
    """Imagery-like pixels: smooth gradients with noise (compressible, as
    a map tile is)."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[:h, :w]
    base = (x * 3 + y * 5) % 256
    if len(shape) == 3:
        base = base[..., None]
    return ((base + rng.integers(0, 12, shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
def test_native_bytes_match_jax_native(toolchain, shape):
    assert toolchain is not None, native.png_encoder()
    img = tile(shape)
    for level in (1, 3, 6):
        got = png.encode_png(img, level=level)
        want = jpng._native_encode(img, level)
        assert want is not None and got == want
        pixels = img if img.ndim == 3 else img[:, :, None]
        assert np.array_equal(png.decode_png(got), pixels)
        assert np.array_equal(png.decode_png(got), png.decode_png(
            png._encode_png_py(img, level)))


def test_overflow_falls_back_to_pure(toolchain):
    """Incompressible pixels overflow ``h·w·c + 4096`` (libpng's 12-byte
    header on every 8 KiB IDAT chunk): the native encoder returns 5 and
    ``encode_png`` takes the pure path, as JAX's does."""
    img = np.random.default_rng(1).integers(0, 256, (1024, 1024, 3)
                                            ).astype(np.uint8)
    assert png._native_encode(img, 3) is None
    assert jpng._native_encode(img, 3) is None
    assert png.encode_png(img) == png._encode_png_py(img) == \
        jpng.encode_png(img)


def test_zlib_only_build_matches_pure(toolchain):
    """The build a machine without libpng's headers gets (the card's):
    the same chunks from zlib alone, byte-equal to the pure path."""
    import ctypes

    lib = ctypes.CDLL(str(_build.build_host(native.SOURCE, (
        "-DS2SR_PNG_ZLIB_ONLY", "-lz"))))
    lib.s2sr_png_backend.restype = ctypes.c_char_p
    assert lib.s2sr_png_backend() == b"zlib"
    for shape in SHAPES:
        img = np.ascontiguousarray(tile(shape, seed=2))
        h, w = shape[:2]
        c = shape[2] if len(shape) == 3 else 1
        out = ctypes.create_string_buffer(h * w * c + 4096)
        n = ctypes.c_size_t(0)
        rc = lib.s2sr_png_encode(img.ctypes.data_as(ctypes.c_char_p), h, w,
                                 c, 3, out, len(out), ctypes.byref(n))
        assert rc == 0
        assert ctypes.string_at(out, n.value) == png._encode_png_py(img, 3)


def test_build_lands_in_the_build_directory(toolchain):
    """The library is built once into the git-ignored build directory,
    keyed by the source's hash, never beside the source."""
    lib = _build.host_lib_path(native.SOURCE, ("-lpng", "-lz"))
    assert lib.exists() and lib.parent == _build.build_dir()
    assert not list(Path(native.__file__).parent.glob("*.so"))
    assert native.png_encoder() == {
        "png_encoder": "native",
        "png_encoder_reason": "built from pngenc.cc against libpng"}


def test_failed_build_is_reported_and_pure_runs(monkeypatch, tmp_path):
    """No compiler (and nothing cached): ``load`` keeps the error of each
    build it tried, the reason names it, and ``encode_png`` writes the
    pure path's bytes."""
    monkeypatch.setenv("S2SR_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_attempted", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "")
    monkeypatch.setenv("CXX", "no-such-compiler-s2sr")
    img = tile((32, 32, 3))
    assert png.encode_png(img) == png._encode_png_py(img)
    status = native.png_encoder()
    assert status["png_encoder"] == "pure"
    assert "no C++ compiler" in status["png_encoder_reason"]
    assert status["png_encoder_reason"].count("no C++ compiler") == 2


def test_pyramid_tiles_decode_equal_on_both_encoders(toolchain, tmp_path,
                                                    monkeypatch):
    """One pyramid on the native encoder and on the pure one: the same
    tiles, every tile's pixels equal."""
    from s2sr_tpu_torch.geo import Affine, CRS, GeoTiff
    from s2sr_tpu_torch.tiles.pyramid import generate_xyz_tiles

    data = tile((96, 80, 3), seed=4)
    r = GeoTiff(data, transform=Affine.from_bounds(35.0, 32.0, 35.01, 32.012,
                                                   80, 96), crs=CRS(4326))
    generate_xyz_tiles(r, tmp_path / "native", 15, 16, device="cpu")
    monkeypatch.setattr(native, "load", lambda: None)
    generate_xyz_tiles(r, tmp_path / "pure", 15, 16, device="cpu")
    names = sorted(p.relative_to(tmp_path / "native")
                   for p in (tmp_path / "native").glob("*/*/*.png"))
    assert names == sorted(p.relative_to(tmp_path / "pure")
                           for p in (tmp_path / "pure").glob("*/*/*.png"))
    for n in names:
        a, b = (tmp_path / "native" / n).read_bytes(), \
            (tmp_path / "pure" / n).read_bytes()
        assert a == jpng._native_encode(png.decode_png(b), 3)
        assert np.array_equal(png.decode_png(a), png.decode_png(b))
