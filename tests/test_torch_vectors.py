"""The port's field-boundary vectors (``s2sr_tpu_torch/vectors/``) against
the JAX package's (``s2sr_tpu/vectors/``) on the CPU.

Tolerances:

- bit-equal: morphology (with and without the ``valid`` rectangle),
  ``fill_holes``, ``connected_components``, ``watershed_uniform``, the
  jump-flooding distances, ``renumber_labels``, ``maximum_filter`` and
  the geometry (rings, simplification, rasterisation);
- gaussian and sobel floats within 2 float32 ulps of their magnitude
  (eager PyTorch rounds each multiply and add; XLA on the CPU may
  contract them into fma), with the thresholded mask the chain reads
  (``smoothed > 0.5``) equal;
- ``watershed_gradient`` and ``kmeans_1d`` labels equal on
  well-separated inputs: no flip allowed here (a float32 ulp can move a
  quantisation level or an assignment only for values on a boundary,
  which these inputs keep away from);
- end to end, ``fields.geojson`` equal except ``created_at`` and
  ``generated_at``, with > 0 features; for v2 ``zones.geojson`` too
  (its k-means on these inputs flips no assignment).

Every mask is 64² so JAX compiles each while-loop once.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2sr_tpu.vectors import geometry as jgeo
from s2sr_tpu.vectors import ops as jops
from s2sr_tpu.vectors.extraction import extract_field_polygons as jax_extract
from s2sr_tpu_torch.cli import generate_vectors as gv_cli
from s2sr_tpu_torch.pipelines.generate_vectors import find_best_raster
from s2sr_tpu_torch.vectors import geometry as tgeo
from s2sr_tpu_torch.vectors import ops as tops
from s2sr_tpu_torch.vectors.extraction import extract_field_polygons
from s2sr_tpu_torch.vectors.synthetic import planted_field_rgb, write_planted_scene
from torch_threads import one_torch_thread  # noqa: F401

N = 64


def _blobs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:N, :N]
    m = np.zeros((N, N), bool)
    for _ in range(5):
        cy, cx = rng.uniform(0, N, 2)
        ry, rx = rng.uniform(3, 12, 2)
        m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    m[rng.random((N, N)) < 0.02] ^= True
    return m.astype(np.uint8)


def _pinched_wall() -> np.ndarray:
    """A diagonal one-pixel wall: 8-connected, 4-pinched everywhere,
    enclosing a triangle that is a hole only 4-connectedly."""
    m = np.zeros((N, N), np.uint8)
    for i in range(N):
        m[i, i] = 1
    m[:, 0] = 1
    m[N - 1, :] = 1
    m[20:30, 40:50] = 1
    return m


def _hole_by_frame() -> np.ndarray:
    """A ring touching the frame with a hole inside, and a bay open to
    the frame (not a hole)."""
    m = np.zeros((N, N), np.uint8)
    m[0:20, 0:20] = 1
    m[3:10, 3:10] = 0
    m[30:50, 44:64] = 1
    m[35:45, 50:64] = 0
    return m


MASKS = {"blobs_1": _blobs(1), "blobs_2": _blobs(2),
         "pinched_wall": _pinched_wall(), "hole_by_frame": _hole_by_frame()}
VALID_HW = (51, 57)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _valid():
    v = np.zeros((N, N), bool)
    v[:VALID_HW[0], :VALID_HW[1]] = True
    return v


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("with_valid", [False, True])
def test_morphology_bit_equal(name, with_valid):
    m = MASKS[name]
    v = _valid() if with_valid else None
    for op in ("binary_close", "binary_open"):
        want = np.asarray(getattr(jops, op)(
            jnp.asarray(m), 5, 2, None if v is None else jnp.asarray(v)))
        got = getattr(tops, op)(_t(m), 5, 2,
                                None if v is None else _t(v)).numpy()
        assert got.dtype == np.uint8 and np.array_equal(got, want), op


@pytest.mark.parametrize("name", list(MASKS))
def test_fill_holes_bit_equal(name):
    m = MASKS[name]
    want = np.asarray(jops.fill_holes(jnp.asarray(m)))
    got = tops.fill_holes(_t(m)).numpy()
    assert np.array_equal(got, want)
    assert tops.PASSES["fill_holes"] >= 1


@pytest.mark.parametrize("name", list(MASKS))
def test_connected_components_bit_equal(name):
    """Pointer jumping gives the relaxation's labels (smallest flat index
    + 1 per 8-connected component), in fewer passes."""
    m = MASKS[name]
    want = np.asarray(jops.connected_components(jnp.asarray(m)))
    got = tops.connected_components(_t(m)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tops.renumber_labels(got),
                          jops.renumber_labels(want))


@pytest.mark.parametrize("name", list(MASKS))
def test_distance_transform_bit_equal(name):
    m = MASKS[name]
    want = np.asarray(jops.distance_transform(jnp.asarray(m)))
    got = tops.distance_transform(_t(m)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", list(MASKS))
def test_watershed_uniform_bit_equal(name):
    """Markers: the components of the distance cores; flood region: the
    whole frame (the extraction chain's call)."""
    m = MASKS[name]
    dist = np.asarray(jops.distance_transform(jnp.asarray(m)))
    cc = np.asarray(jops.connected_components(
        jnp.asarray((dist > 0.3 * dist.max()).astype(np.uint8))))
    markers = np.where(cc > 0, cc + 1, np.where(m > 0, 1, 0)).astype(np.int32)
    region = np.ones((N, N), np.uint8)
    want = np.asarray(jops.watershed_uniform(jnp.asarray(markers),
                                             jnp.asarray(region)))
    got = tops.watershed_uniform(_t(markers), _t(region)).numpy()
    assert np.array_equal(got, want)
    # ties between two fronts: the smaller label, pass by pass
    two = np.zeros((N, N), np.int32)
    two[5, 5], two[5, 9], two[50, 30] = 7, 3, 5
    want = np.asarray(jops.watershed_uniform(jnp.asarray(two),
                                             jnp.asarray(1 - m)))
    got = tops.watershed_uniform(_t(two), _t(1 - m)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_within_ulps_and_threshold_equal(seed):
    """Floats within 2 ulps of float32 at their magnitude; the mask the
    chain thresholds at 0.5 equal."""
    m = _blobs(seed).astype(np.float32)
    want = np.asarray(jops.gaussian_filter(jnp.asarray(m), 2.0))
    got = tops.gaussian_filter(_t(m), 2.0).numpy()
    assert np.abs(got - want).max() <= 2 * np.finfo(np.float32).eps
    assert np.array_equal(got > 0.5, want > 0.5)
    x = np.random.default_rng(seed).random((N, N)).astype(np.float32)
    want = np.asarray(jops.gaussian_filter(jnp.asarray(x), 2.0))
    got = tops.gaussian_filter(_t(x), 2.0).numpy()
    assert np.abs(got - want).max() <= 2 * np.finfo(np.float32).eps


def test_sobel_within_ulps_and_maximum_filter_equal():
    x = np.random.default_rng(3).random((N, N)).astype(np.float32) * 10
    want = np.asarray(jops.sobel_gradient(jnp.asarray(x)))
    got = tops.sobel_gradient(_t(x)).numpy()
    assert np.abs(got - want).max() <= 4 * np.finfo(np.float32).eps * want.max()
    for size in (3, 4, 7):
        want = np.asarray(jops.maximum_filter(jnp.asarray(x), size))
        got = tops.maximum_filter(_t(x), size).numpy()
        assert np.array_equal(got, want), size


def test_watershed_gradient_labels_equal():
    """Two basins split by a ridge: every pixel's label equal (no flip)."""
    yy, xx = np.mgrid[:N, :N].astype(np.float32)
    grad = np.exp(-((xx - 31.5) ** 2) / 20.0) * 8 + 0.01 * yy
    markers = np.zeros((N, N), np.int32)
    markers[32, 8], markers[32, 56], markers[5, 30] = 2, 3, 4
    mask = np.ones((N, N), np.uint8)
    mask[:, :2] = 0
    want = np.asarray(jops.watershed_gradient(
        jnp.asarray(markers), jnp.asarray(grad), jnp.asarray(mask), 16))
    got = tops.watershed_gradient(_t(markers), _t(grad), _t(mask), 16).numpy()
    assert np.array_equal(got, want)
    assert tops.PASSES["watershed_gradient"] > 16


def test_kmeans_1d_labels_equal():
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.normal(c, 0.05, 300) for c in (0.1, 0.5, 0.9)])
    vals = rng.permutation(vals).astype(np.float32)
    want = np.asarray(jops.kmeans_1d(jnp.asarray(vals), 3))
    got = tops.kmeans_1d(_t(vals), 3).numpy()
    assert np.array_equal(got, want)
    # the quantile init at 2**24 + 1 values, past torch.quantile's limit,
    # is not needed here: the init is exercised on the sorted values
    assert sorted(np.unique(got)) == [0, 1, 2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_equal_to_jax(seed):
    """Rings, polygons, simplification and rasterisation: the port's copy
    gives the JAX package's values on random masks."""
    rng = np.random.default_rng(seed)
    m = (rng.random((24, 28)) < 0.55).astype(np.uint8)
    m[rng.random((24, 28)) < 0.1] = 0
    want = jgeo.mask_to_rings(m)
    got = tgeo.mask_to_rings(m)
    assert len(got) == len(want) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for a, b in zip(tgeo.mask_to_polygons(m), jgeo.mask_to_polygons(m)):
        assert a.wkt == b.wkt
        assert a.simplify(1.5).wkt == b.simplify(1.5).wkt
    ring = [[1.5, 2.0], [20.2, 3.1], [18.0, 17.5], [4.0, 15.0], [1.5, 2.0]]
    from s2sr_tpu.geo import Affine as JAffine
    from s2sr_tpu_torch.geo import Affine as TAffine
    got = tgeo.rasterize_polygon([ring], (24, 28), TAffine.identity())
    want = jgeo.rasterize_polygon([ring], (24, 28), JAffine.identity())
    assert got.any() and np.array_equal(got, want)
    labels = rng.integers(0, 4, (24, 28))
    for (lt, st, ot), (lj, sj, oj) in zip(tgeo.iter_label_masks(labels),
                                          jgeo.iter_label_masks(labels)):
        assert lt == lj and ot == oj and np.array_equal(st, sj)


def _strip(geojson: dict) -> dict:
    g = json.loads(json.dumps(geojson))
    g["properties"].pop("generated_at")
    for f in g["features"]:
        f["properties"].pop("created_at")
    return g


@pytest.mark.parametrize("size, seed", [(128, 0), (128, 3)])
def test_extract_field_polygons_equal_to_jax(tmp_path, size, seed):
    """End to end on a planted GeoTIFF with an AOI: the port's
    fields.geojson (CPU) is the JAX package's, timestamps aside, and
    holds fields."""
    tif, aoi = write_planted_scene(tmp_path, size, seed)
    got = extract_field_polygons(aoi, [tif], tmp_path / "t", device="cpu")
    want = jax_extract(aoi, [tif], tmp_path / "j")
    assert got["feature_count"] > 0
    assert _strip(got["geojson"]) == _strip(want["geojson"])
    assert got["source_method"] == want["source_method"] == "rgb_fallback"
    meta = json.loads((tmp_path / "t" / "extraction_metadata.json").read_text())
    assert set(meta["stage_timings_s"]) == {"mask", "segment_total",
                                            "polygonise", "cleanup"}


def test_planted_scene_is_seeded():
    a, b = planted_field_rgb(96, 5), planted_field_rgb(96, 5)
    assert np.array_equal(a, b) and not np.array_equal(a, planted_field_rgb(96, 6))


def test_cli_and_raster_search(tmp_path, monkeypatch, capsys):
    """``python -m s2sr_tpu_torch.cli.generate_vectors --device cpu``
    writes fields.geojson; the raster search takes wow over sr over
    source, newest first."""
    tif, aoi = write_planted_scene(tmp_path / "data" / "source", 128, 0)
    (tmp_path / "data" / "sr").mkdir()
    assert find_best_raster(tmp_path / "data") == tif
    monkeypatch.setattr("sys.argv", [
        "generate_vectors", "--raster", str(tif), "--aoi", str(aoi),
        "-o", str(tmp_path / "out"), "--device", "cpu"])
    gv_cli.main()
    assert "Extracted" in capsys.readouterr().out
    fields = json.loads((tmp_path / "out" / "fields.geojson").read_text())
    assert fields["properties"]["feature_count"] > 0


def test_device_defaults_to_cuda():
    """No fallback: without CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract_field_polygons("aoi.geojson", ["none.tif"], "out")


@pytest.mark.parametrize("size, seed", [(128, 0)])
def test_extract_field_polygons_v2_equal_to_jax(tmp_path, size, seed):
    """v2 (gradient watershed, statistics, k-means zones; roads off, as
    offline) on a 5-band planted raster: fields.geojson and zones.geojson
    equal to the JAX package's, timestamps aside."""
    from s2sr_tpu.vectors.extraction_v2 import (
        ExtractionConfigV2 as JaxConfigV2, extract_field_polygons_v2 as jax_v2)
    from s2sr_tpu_torch.vectors.extraction_v2 import (
        ExtractionConfigV2, extract_field_polygons_v2)

    tif, aoi = write_planted_scene(tmp_path, size, seed, bands=5)
    got = extract_field_polygons_v2(aoi, tif, tmp_path / "t",
                                    ExtractionConfigV2(use_osm_roads=False),
                                    device="cpu")
    want = jax_v2(aoi, tif, tmp_path / "j", JaxConfigV2(use_osm_roads=False))
    assert got["feature_count"] > 0 and got["zone_count"] > 0
    assert _strip(got["geojson"]) == _strip(want["geojson"])
    zones = [json.loads((tmp_path / d / "zones.geojson").read_text())
             for d in ("t", "j")]
    for z in zones:
        z["properties"].pop("generated_at")
    assert zones[0] == zones[1]


def test_road_carving_and_offline_fetch(monkeypatch):
    """Roads burnt into the labels as JAX burns them; offline, no fetch."""
    from s2sr_tpu.geo import Affine as JAffine
    from s2sr_tpu.vectors.extraction_v2 import carve_roads_from_labels as jcarve
    from s2sr_tpu_torch.config import get_settings
    from s2sr_tpu_torch.geo import Affine as TAffine
    from s2sr_tpu_torch.vectors.extraction_v2 import (
        carve_roads_from_labels, fetch_osm_roads)

    labels = np.random.default_rng(0).integers(0, 5, (40, 50))
    road = [np.array([[35.0001, 31.9999], [35.0009, 31.9991]])]
    deg = 2.5 / 111000
    for buffer_m in (5.0, 20.0):
        got = carve_roads_from_labels(labels, road, TAffine.from_origin(
            35.0, 32.0, deg, deg), buffer_m, device="cpu")
        want = jcarve(labels, road, JAffine.from_origin(35.0, 32.0, deg, deg),
                      buffer_m)
        assert np.array_equal(got, want) and (got == 0).sum() > (labels == 0).sum()
    monkeypatch.setenv("OFFLINE", "true")
    get_settings.cache_clear()
    try:
        assert fetch_osm_roads((35.0, 32.0, 35.01, 32.01)) == []
    finally:
        get_settings.cache_clear()


def test_vectors_v2_cli(tmp_path, monkeypatch, capsys):
    from s2sr_tpu_torch.cli import vectors_v2

    tif, aoi = write_planted_scene(tmp_path, 128, 0, bands=5)
    monkeypatch.setattr("sys.argv", [
        "vectors_v2", str(tif), "--aoi", str(aoi), "-o", str(tmp_path / "out"),
        "--no-roads", "--device", "cpu"])
    vectors_v2.main()
    assert "V2 extraction:" in capsys.readouterr().out
    assert (tmp_path / "out" / "zones.geojson").exists()
