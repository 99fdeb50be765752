"""The port's farm chain (``ops/enhance.py::enhance_farm``,
``enhance_local_contrast``) and farm pipeline (``pipelines/farm_sr.py``,
``cli/farm_sr.py``) against the JAX package on the CPU.

The chains are byte-equal to eager JAX (one rounding per op, as the
port runs). Eager JAX compiles each op per shape (~10 s for the chain),
so that comparison runs at one odd-tile shape; at three shapes the
chain is held to jitted JAX with ``test_torch_enhance.py``'s bound
(CLAHE's .5 ties under jit: ≤ 1% of pixels touched; 0.2% measured at
the odd shapes, 0 at 64²).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.fetch.synthetic import synthetic_scene
from s2sr_tpu.geo import read_geotiff as jax_read_geotiff
from s2sr_tpu.models import registry as jax_registry
from s2sr_tpu.models.weights import save_params
from s2sr_tpu.ops import enhance as je
from s2sr_tpu.pipelines.farm_sr import process_farm_sr as jax_process_farm_sr
from s2sr_tpu_torch.cli import farm_sr as farm_cli
from s2sr_tpu_torch.geo import read_geotiff
from s2sr_tpu_torch.models import registry
from s2sr_tpu_torch.ops import enhance as te
from s2sr_tpu_torch.pipelines.farm_sr import process_farm_sr
from s2sr_tpu_torch.tiles.png import decode_png

from test_torch_engine import TINY, jax_tree_one_block
from torch_threads import one_torch_thread  # noqa: F401


def rand_u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def test_farm_chains_byte_equal_to_eager_jax():
    img = rand_u8((67, 93, 3), 5)
    got = te.enhance_farm(torch.from_numpy(img)).numpy()
    got_lc = te.enhance_local_contrast(torch.from_numpy(img)).numpy()
    got_lc2 = te.enhance_local_contrast(torch.from_numpy(img), 2.0, 4).numpy()
    with jax.disable_jit():
        want = np.asarray(je.enhance_farm(jnp.asarray(img)))
        want_lc = np.asarray(je.enhance_local_contrast(jnp.asarray(img)))
        want_lc2 = np.asarray(je.enhance_local_contrast(jnp.asarray(img),
                                                        2.0, 4))
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got_lc, want_lc)
    assert np.array_equal(got_lc2, want_lc2)


@pytest.mark.parametrize("shape", [(64, 64, 3), (128, 96, 3), (45, 71, 3)])
def test_farm_chain_matches_jitted_jax(shape):
    img = rand_u8(shape, 6)
    got = te.enhance_farm(torch.from_numpy(img)).numpy()
    want = np.asarray(je.enhance_farm(jnp.asarray(img)))
    assert got.shape == shape and got.dtype == np.uint8
    assert np.any(got != want, axis=-1).mean() <= 0.01
    lc = te.enhance_local_contrast(torch.from_numpy(img)).numpy()
    want_lc = np.asarray(je.enhance_local_contrast(jnp.asarray(img)))
    assert np.any(lc != want_lc, axis=-1).mean() <= 0.01


def test_farm_chain_is_not_the_wow_chain():
    """The farm constants (σ 1.5, 2.2/−1.2, ×1.3) take effect."""
    img = rand_u8((64, 64, 3), 7)
    farm = te.enhance_farm(torch.from_numpy(img)).numpy()
    wow = te.enhance_for_crops(torch.from_numpy(img)).numpy()
    assert not np.array_equal(farm, wow)


@pytest.fixture(scope="module")
def farm(tmp_path_factory):
    """realesrgan_x4 as the one-block TINY model in both registries (one
    shared .npz), float32 engines without the pad probe (the process
    settings, through the environment); both pipelines on one 64² scene."""
    from s2sr_tpu.config import settings as jax_settings_mod
    from s2sr_tpu.models import engine as jax_engine_mod
    from s2sr_tpu_torch.config import settings as settings_mod
    from s2sr_tpu_torch.models import engine as engine_mod

    d = tmp_path_factory.mktemp("farm")
    save_params(jax_tree_one_block(np.random.default_rng(9)),
                d / "w" / "realesrgan_x4.npz")
    synthetic_scene(d / "scene.tif", size=(64, 64), seed=2)
    saved = (jax_registry.MODELS["realesrgan_x4"],
             registry.MODELS["realesrgan_x4"])
    jax_registry.MODELS["realesrgan_x4"] = dict(TINY)
    registry.MODELS["realesrgan_x4"] = dict(TINY)
    mp = pytest.MonkeyPatch()
    mp.setenv("SR_DTYPE", "float32")
    mp.setenv("SR_PAD_PROBE", "false")
    jax_settings_mod.get_settings.cache_clear()
    settings_mod.get_settings.cache_clear()
    try:
        want = jax_process_farm_sr(d / "scene.tif", d / "jax",
                                   weights_dir=d / "w")
        got = process_farm_sr(d / "scene.tif", d / "torch",
                              weights_dir=d / "w", device="cpu")
        yield d, want, got
    finally:
        for cache in (jax_engine_mod._ENGINE_CACHE, engine_mod._ENGINE_CACHE):
            for key in [k for k in cache if str(d) in str(k)]:
                del cache[key]
        jax_registry.MODELS["realesrgan_x4"], \
            registry.MODELS["realesrgan_x4"] = saved
        mp.undo()
        jax_settings_mod.get_settings.cache_clear()
        settings_mod.get_settings.cache_clear()


def test_farm_pipeline_pixels_match_jax(farm):
    _, want, got = farm
    a = jax_read_geotiff(want["outputs"]["sr_tif"])
    b = read_geotiff(got["outputs"]["sr_tif"])
    assert b.data.shape == a.data.shape == (256, 256, 3)
    assert tuple(b.transform) == tuple(a.transform)
    # the engine bound spread by the farm chain (test_torch_wow.py's)
    assert np.any(a.data != b.data, axis=-1).mean() <= 0.01
    png = decode_png(open(got["outputs"]["sr_png"], "rb").read())
    assert np.array_equal(png, b.data)


def test_farm_pipeline_metadata_matches_jax(farm):
    d, want, got = farm
    assert sorted(got) == sorted(want)
    assert sorted(got["outputs"]) == sorted(want["outputs"])
    gm, wm = got["sr_metadata"], want["sr_metadata"]
    assert sorted(gm) == sorted(wm)
    for k in ("scale", "pipeline", "steps", "original_size", "output_size",
              "original_resolution_m", "effective_resolution_m",
              "pretrained"):
        assert gm[k] == wm[k], k
    assert [s["name"] for s in gm["timing"]["stages"]] == \
        [s["name"] for s in wm["timing"]["stages"]]
    side = json.loads((d / "torch" / "scene_farm_sr_metadata.json").read_text())
    assert sorted(side) == sorted(want)


@pytest.mark.parametrize("scale", [2, 3])
def test_unknown_scale_raises_like_jax(farm, scale):
    d, _, _ = farm
    with pytest.raises(ValueError) as jerr:
        jax_process_farm_sr(d / "scene.tif", d / "jax2", scale=scale,
                            weights_dir=d / "w")
    with pytest.raises(ValueError) as err:
        process_farm_sr(d / "scene.tif", d / "torch2", scale=scale,
                        weights_dir=d / "w", device="cpu")
    assert str(err.value) == str(jerr.value)
    assert str(err.value).startswith(f"Unknown model: realesrgan_x{scale}")


def test_farm_cli(farm, capsys):
    d, _, got = farm
    farm_cli.main([str(d / "scene.tif"), "-o", str(d / "cli"),
                   "--weights-dir", str(d / "w"), "--device", "cpu"])
    assert "Results:" in capsys.readouterr().out
    a = read_geotiff(d / "cli" / "scene_farm_sr.tif").data
    assert np.array_equal(a, read_geotiff(got["outputs"]["sr_tif"]).data)
