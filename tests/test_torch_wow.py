"""Port's ``/api/wow`` path end to end (``process_wow_sr`` and its CLI)
against the JAX package on a 64² synthetic GeoTIFF with a one-block
model sharing one ``.npz``, on the CPU."""

import json

import numpy as np
import pytest

from s2sr_tpu.fetch.synthetic import synthetic_scene
from s2sr_tpu.geo import read_geotiff as jax_read_geotiff
from s2sr_tpu.models import registry as jax_registry
from s2sr_tpu.models.weights import save_params
from s2sr_tpu.pipelines.wow_sr import process_wow_sr as jax_process_wow_sr
from s2sr_tpu_torch.geo import read_geotiff
from s2sr_tpu_torch.models import registry
from s2sr_tpu_torch.pipelines.wow_sr import process_wow_sr
from s2sr_tpu_torch.tiles.png import decode_png

from test_torch_engine import TINY, jax_tree_one_block


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("wow")
    save_params(jax_tree_one_block(np.random.default_rng(7)),
                d / "w" / "rrdb_tiny.npz")
    synthetic_scene(d / "scene.tif", size=(64, 64), seed=2)
    jax_registry.MODELS["rrdb_tiny"] = dict(TINY)
    registry.MODELS["rrdb_tiny"] = dict(TINY)
    kw = dict(model="rrdb_tiny", weights_dir=d / "w", precision="float32")
    want = jax_process_wow_sr(d / "scene.tif", d / "jax", **kw)
    got = process_wow_sr(d / "scene.tif", d / "torch", device="cpu", **kw)
    yield d, want, got
    jax_registry.MODELS.pop("rrdb_tiny", None)
    registry.MODELS.pop("rrdb_tiny", None)


def test_pixels_match_jax(setup):
    _, want, got = setup
    a = jax_read_geotiff(want["outputs"]["sr_tif"]).data
    b = read_geotiff(got["outputs"]["sr_tif"]).data
    assert b.shape == a.shape == (256, 256, 3) and b.dtype == np.uint8
    # engine bound (|diff| ≤ 1 on ≤ 0.1% of SR bytes, trunc boundaries)
    # spread by the WOW chain (CLAHE .5 ties under JAX's jit, see
    # test_torch_enhance): few pixels touched
    assert np.any(a != b, axis=-1).mean() <= 0.01


def test_metadata_keys_match_jax(setup):
    d, want, got = setup
    assert sorted(got) == sorted(want)
    assert sorted(got["outputs"]) == sorted(want["outputs"])
    assert sorted(got["sr_metadata"]) == sorted(want["sr_metadata"])
    gm, wm = got["sr_metadata"], want["sr_metadata"]
    for k in ("scale", "pipeline", "stages", "enhancements", "original_size",
              "output_size", "original_resolution_m",
              "effective_resolution_m", "optimized_for", "pretrained",
              "precision"):
        assert gm[k] == wm[k], k
    side = json.loads((d / "torch" / "scene_wow_sr_metadata.json").read_text())
    assert side["sr_metadata"]["output_size"] == [256, 256]


def test_png_twin_and_georeference(setup):
    _, want, got = setup
    tif = read_geotiff(got["outputs"]["sr_tif"])
    png = decode_png(open(got["outputs"]["sr_png"], "rb").read())
    assert np.array_equal(png, tif.data)
    ref = jax_read_geotiff(want["outputs"]["sr_tif"])
    assert tuple(tif.transform) == tuple(ref.transform)
    assert tif.crs.epsg == ref.crs.epsg == 4326


@pytest.mark.parametrize("filter_sub", [True, False])
@pytest.mark.parametrize("shape", [(17, 23, 3), (8, 5, 4), (9, 6)])
def test_png_codec_matches_jax(shape, filter_sub):
    from s2sr_tpu.tiles import png as jpng
    from s2sr_tpu_torch.tiles.png import _encode_png_py, encode_png

    img = np.random.default_rng(4).integers(0, 256, shape).astype(np.uint8)
    want = img if img.ndim == 3 else img[:, :, None]
    data = encode_png(img, filter_sub=filter_sub)
    assert np.array_equal(jpng.decode_png(data), want)
    assert np.array_equal(decode_png(data), want)
    # both take their native encoder where it builds, else the pure path
    assert data == jpng.encode_png(img, filter_sub=filter_sub)
    assert _encode_png_py(img, filter_sub=filter_sub) == \
        jpng._encode_png_py(img, filter_sub=filter_sub)


def test_cli_entry_point(setup, capsys):
    from s2sr_tpu_torch.cli.wow_sr import main

    d, _, _ = setup
    synthetic_scene(d / "small.tif", size=(24, 20), seed=3)
    main([str(d / "small.tif"), "-o", str(d / "cli"), "--model",
          "realesrgan_anime", "--weights-dir", str(d / "none"),
          "--no-enhance", "--device", "cpu"])
    assert "sr_png" in capsys.readouterr().out
    meta = json.loads((d / "cli" / "small_wow_sr_metadata.json").read_text())
    assert meta["sr_metadata"]["output_size"] == [96, 80]
    assert meta["sr_metadata"]["enhancements"] == []
    assert meta["sr_metadata"]["pretrained"] is False
