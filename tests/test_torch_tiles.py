"""The port's tile stage (``tiles/mercator``, ``geo/warp``,
``tiles/pyramid``, ``tiles/tiling``) against the JAX package on the CPU.

The port keeps each warp expression in the JAX order, one torch op per
``jnp`` op, so it is bit-equal to the JAX functions run eagerly
(``disable_jit``): the densified coordinates, the bilinear and nearest
warps, the uint8 RGBA tiles and ``warp_to_mercator``. Lanczos (off the
jobs' path: ``process_raster_to_tiles`` samples bilinearly) differed
there by ≤ 1.6e-4 on the 0–255 scale when measured (the two libraries'
``sin``); its eager run compiles ~700 ops, so it is held to the jitted
function only.

The JAX package runs the warps jitted, and XLA contracts multiply-adds
into fma: its densified coordinates differ from the eager ones by up to
2.3e-5 px on ~24% of pixels. Pinned from measurement (when the port was
made) against the jitted functions:
- warped float values within 0.01 on the 0–255 scale (measured ≤ 0.0041);
- uint8 tile values equal on ≥ 99.95% and within 1 elsewhere (measured:
  ≤ 2.6e-4 of values differ on uniform noise, the worst case for a .5
  tie; ≤ 2e-5 on the synthetic scene);
- the nearest warp picks another tap on ≤ 1e-4 of pixels (measured
  ≤ 5.7e-6: a coordinate within 2.3e-5 of a .5 tie).
The coverage masks, the tile sets, the mercator math, the 2×2 average and
``tileset.json`` are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.geo import GeoTiff as JaxGeoTiff
from s2sr_tpu.geo import warp as jw
from s2sr_tpu.geo.affine import Affine as JaxAffine
from s2sr_tpu.geo.crs import CRS as JaxCRS
from s2sr_tpu.tiles import mercator as jm
from s2sr_tpu.tiles import pyramid as jp
from s2sr_tpu.tiles import tiling as jt
from s2sr_tpu_torch.geo import Affine, CRS, GeoTiff, read_geotiff
from s2sr_tpu_torch.geo import warp as tw
from s2sr_tpu_torch.tiles import mercator as tm
from s2sr_tpu_torch.tiles import pyramid as tp
from s2sr_tpu_torch.tiles import tiling as tt
from s2sr_tpu_torch.tiles.png import decode_png
from torch_threads import one_torch_thread  # noqa: F401

FLOAT_TOL = 0.01          # warped values vs jitted JAX, 0-255 scale
BYTE_SHARE = 5e-4         # share of uint8 values allowed to differ by 1
NEAREST_SHARE = 1e-4      # share of pixels the nearest warp may move


def rasters(kind: str):
    """The same raster as (JAX GeoTiff, port GeoTiff)."""
    rng = np.random.default_rng(3)
    if kind == "wgs84":          # an odd-sized RGB scene, EPSG:4326
        data = rng.integers(0, 256, (80, 96, 3)).astype(np.uint8)
        bounds, epsg, nodata = (35.0, 32.0, 35.011, 32.009), 4326, None
    elif kind == "utm_nodata":   # UTM with a nodata collar
        data = rng.integers(1, 256, (72, 88, 3)).astype(np.uint8)
        data[:, :9] = 0
        bounds, epsg, nodata = (690000.0, 3543000.0, 690880.0, 3543720.0), \
            32636, 0
    else:                        # uint16 RGBA with a partial alpha band
        data = rng.integers(0, 65536, (64, 64, 4)).astype(np.uint16)
        data[:32, :, 3] = 0
        data[32:, :, 3] = 65535
        bounds, epsg, nodata = (35.0, 32.0, 35.006, 32.006), 4326, None
    w, s, e, n = bounds
    h, wd = data.shape[:2]
    return (JaxGeoTiff(data, transform=JaxAffine.from_bounds(w, s, e, n, wd, h),
                       crs=JaxCRS(epsg), nodata=nodata),
            GeoTiff(data, transform=Affine.from_bounds(w, s, e, n, wd, h),
                    crs=CRS(epsg), nodata=nodata))


def assert_bytes_close(got, want):
    """Within 1 on all but BYTE_SHARE of the values, except pixels whose
    coverage flips (alpha 0 on one side only: a coordinate on the
    footprint's edge), which may be NEAREST_SHARE of the pixels."""
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if got.shape[-1] == 4:
        flips = (got[..., 3] == 0) != (want[..., 3] == 0)
        assert flips.mean() <= NEAREST_SHARE
        diff[flips] = 0
    assert diff.max() <= 1 and (diff > 0).mean() <= BYTE_SHARE


def test_mercator_matches_jax():
    assert tm.TILE_SIZE == jm.TILE_SIZE and tm.WORLD == jm.WORLD
    bounds = [(3896182.0, 3763310.0, 3901748.0, 3769000.0),
              (-20037508.34, -20037508.34, 20037508.34, 20037508.34),
              (0.0, 0.0, 1222.99245256282, 1222.99245256282)]
    for z in range(0, 21, 3):
        assert tm.resolution(z) == jm.resolution(z)
        for x, y in ((0, 0), (5, 9), ((1 << z) - 1, (1 << z) // 2)):
            assert tm.tile_bounds(z, x, y) == jm.tile_bounds(z, x, y)
        for mx, my in ((3896182.0, 3763310.0), (-1e7, 1e7), (0.0, 0.0)):
            assert tm.mercator_to_tile(mx, my, z) == jm.mercator_to_tile(mx, my, z)
        for b in bounds[::2] if z > 6 else bounds:   # the world: z ≤ 6
            assert list(tm.tiles_for_bounds(b, z)) == \
                list(jm.tiles_for_bounds(b, z))
    assert tm.tile_count(bounds[0], 10, 16) == jm.tile_count(bounds[0], 10, 16)


@pytest.mark.parametrize("kind", ["wgs84", "utm_nodata", "rgba16"])
def test_rgba_source_and_control_grid_match_jax(kind):
    jr, r = rasters(kind)
    assert np.array_equal(tp._rgba_source(r), jp._rgba_source(jr))
    keys, ctrls = next(tp.base_zoom_batches(r, 17))
    res = jm.resolution(17)
    want = np.stack([jw.control_grid(
        JaxAffine.from_origin(jm.tile_bounds(17, x, y)[0],
                              jm.tile_bounds(17, x, y)[3], res, res),
        JaxCRS(3857), jr.transform, jr.crs, 256, 256) for x, y in keys])
    assert np.array_equal(ctrls, want)


def _warp_inputs(kind, zoom=17, batch=8):
    jr, r = rasters(kind)
    src = tp._rgba_source(r)
    _, ctrls = next(tp.base_zoom_batches(r, zoom, batch=batch))
    return src, ctrls


@pytest.mark.parametrize("kind", ["wgs84", "utm_nodata"])
def test_densify_is_eager_jax(kind):
    _, ctrls = _warp_inputs(kind)
    with jax.disable_jit():
        want = jw._densify_ctrl(jnp.asarray(ctrls), 256, 256, 72, 88)
    got = tw._densify_ctrl(torch.from_numpy(ctrls), 256, 256, 72, 88)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind, name", [
    ("wgs84", "warp_bilinear_batch"), ("utm_nodata", "warp_bilinear_batch"),
    ("wgs84", "warp_nearest_batch"), ("utm_nodata", "warp_nearest_batch"),
    ("wgs84", "warp_lanczos_batch")])
def test_warps_match_jax(name, kind):
    src, ctrls = _warp_inputs(kind)
    got, cov = getattr(tw, name)(torch.from_numpy(src),
                                 torch.from_numpy(ctrls), 256, 256)
    jitted, jcov = getattr(jw, name)(jnp.asarray(src), jnp.asarray(ctrls),
                                     256, 256)
    assert got.dtype == torch.float32 and got.shape == jitted.shape
    assert np.array_equal(cov.numpy(), np.asarray(jcov))
    got = got.numpy()
    if name != "warp_lanczos_batch":   # eager lanczos: ~700 op compiles
        with jax.disable_jit():
            eager, ecov = getattr(jw, name)(jnp.asarray(src),
                                            jnp.asarray(ctrls), 256, 256)
        assert np.array_equal(cov.numpy(), np.asarray(ecov))
        assert np.array_equal(got, np.asarray(eager))
    if name == "warp_nearest_batch":
        moved = np.any(got != np.asarray(jitted), axis=-1)
        assert moved.mean() <= NEAREST_SHARE
    else:
        assert np.abs(got - np.asarray(jitted)).max() <= FLOAT_TOL


@pytest.mark.parametrize("kind", ["wgs84", "utm_nodata", "rgba16"])
def test_warp_tiles_rgba_u8_matches_jax(kind):
    src, ctrls = _warp_inputs(kind, zoom=18)
    got = tp._warp_tiles_rgba_u8(torch.from_numpy(src),
                                 torch.from_numpy(ctrls), 256, False)
    assert got.dtype == torch.uint8 and got.shape == (8, 256, 256, 4)
    got = got.numpy()
    want = np.asarray(jp._warp_tiles_rgba_u8(
        jnp.asarray(src), jnp.asarray(ctrls), 256, False))
    assert_bytes_close(got, want)
    with jax.disable_jit():
        eager = np.asarray(jp._warp_tiles_rgba_u8(
            jnp.asarray(src), jnp.asarray(ctrls), 256, False))
    assert np.array_equal(got, eager)


@pytest.mark.parametrize("kind, method", [("utm_nodata", "bilinear"),
                                          ("utm_nodata", "nearest"),
                                          ("wgs84", "bilinear")])
def test_warp_to_mercator_matches_jax(kind, method):
    jr, r = rasters(kind)
    got = tw.warp_to_mercator(r, method=method, device="cpu")
    want = jw.warp_to_mercator(jr, method=method)
    assert got.crs.epsg == want.crs.epsg == 3857
    assert tuple(got.transform) == tuple(want.transform)
    assert got.nodata == want.nodata
    assert_bytes_close(got.data, want.data)
    if (kind, method) == ("utm_nodata", "bilinear"):
        # blocks of 40 rows: the block loop and the nodata reweighting
        with jax.disable_jit():
            eager = jw.warp_to_mercator(jr, block_rows=40)
        got = tw.warp_to_mercator(r, block_rows=40, device="cpu")
        assert np.array_equal(got.data, eager.data)


def test_downsample_level_matches_jax():
    rng = np.random.default_rng(5)
    children = {}
    for key in ((10, 20), (11, 20), (10, 21), (13, 21), (14, 22)):
        t = rng.integers(0, 256, (256, 256, 4)).astype(np.uint8)
        t[:40, :, 3] = 0                       # transparent rows
        children[key] = t
    want = jp._downsample_level(children)
    got = tp._downsample_level(children)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["wgs84", "utm_nodata"])
def test_generate_xyz_tiles_matches_jax(tmp_path, kind):
    jr, r = rasters(kind)
    jp.generate_xyz_tiles(jr, tmp_path / "jax", min_zoom=14, max_zoom=17)
    tp.generate_xyz_tiles(r, tmp_path / "torch", min_zoom=14, max_zoom=17,
                          device="cpu")
    want = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").glob("*/*/*.png"))
    got = sorted(p.relative_to(tmp_path / "torch")
                 for p in (tmp_path / "torch").glob("*/*/*.png"))
    assert got == want and {p.parts[0] for p in got} == {"14", "15", "16",
                                                         "17"}
    a = np.stack([decode_png((tmp_path / "jax" / p).read_bytes())
                  for p in want])
    b = np.stack([decode_png((tmp_path / "torch" / p).read_bytes())
                  for p in got])
    assert_bytes_close(b, a)


def test_process_raster_to_tiles_matches_jax(tmp_path):
    from s2sr_tpu.geo import write_geotiff as jax_write

    jr, r = rasters("utm_nodata")
    jax_write(jr, tmp_path / "scene.tif")
    jinfo = jt.get_raster_info(tmp_path / "scene.tif")
    info = tt.get_raster_info(tmp_path / "scene.tif")
    assert (info.crs, info.bounds, info.width, info.height, info.bands,
            info.dtype) == (jinfo.crs, jinfo.bounds, jinfo.width,
                            jinfo.height, jinfo.bands, jinfo.dtype)
    assert np.allclose(info.bounds_4326, jinfo.bounds_4326, rtol=0, atol=0)
    want = jt.process_raster_to_tiles(tmp_path / "scene.tif",
                                      tmp_path / "jax", 15, 16)
    got = tt.process_raster_to_tiles(tmp_path / "scene.tif",
                                     tmp_path / "torch", 15, 16, device="cpu")
    assert got == want
    assert (tmp_path / "torch" / "tileset.json").read_bytes() == \
        (tmp_path / "jax" / "tileset.json").read_bytes()
    # the 3857 intermediate, for callers that want it
    jt.reproject_to_web_mercator(tmp_path / "scene.tif", tmp_path / "j.tif")
    tt.reproject_to_web_mercator(tmp_path / "scene.tif", tmp_path / "t.tif",
                                 device="cpu")
    assert_bytes_close(read_geotiff(tmp_path / "t.tif").data,
                       read_geotiff(tmp_path / "j.tif").data)


def test_tile_stage_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    _, r = rasters("wgs84")
    with pytest.raises((RuntimeError, AssertionError)):
        tp.generate_xyz_tiles(r, tmp_path, min_zoom=16, max_zoom=16)
    assert not list(tmp_path.glob("*/*/*.png"))


@pytest.mark.parametrize("kind", ["wgs84", "utm_nodata"])
def test_warp_tiles_rgba_u8_lanczos_matches_jax(kind):
    """The lanczos RGBA pack (``resampling="lanczos"``) against jitted JAX,
    within ``assert_bytes_close``, on two tiles of 64 px (a 256-px tile's
    control grid densified to 64: the same geometry, at the cost of a few
    seconds of XLA compile instead of ~40 s for eager JAX)."""
    src, ctrls = _warp_inputs(kind, zoom=18, batch=2)
    got = tp._warp_tiles_rgba_u8(torch.from_numpy(src),
                                 torch.from_numpy(ctrls), 64, True)
    assert got.dtype == torch.uint8 and got.shape == (2, 64, 64, 4)
    want = np.asarray(jp._warp_tiles_rgba_u8(
        jnp.asarray(src), jnp.asarray(ctrls), 64, True))
    assert_bytes_close(got.numpy(), want)
