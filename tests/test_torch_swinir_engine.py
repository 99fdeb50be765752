"""Port's ``SREngine`` on the ``swinir`` family against the JAX engine,
with a tiny SwinIR registered in both registries and one ``.npz`` of
weights for both, in fp32 on the CPU.

Target: byte-identical uint8, allowing |diff| ≤ 1 on at most 0.1% of
the bytes (the engines truncate ``x·255``, so one summation order can
move a pixel on an integer boundary).
"""

import numpy as np
import pytest

from s2sr_tpu.models import engine as jax_engine_mod
from s2sr_tpu.models import registry as jax_registry
from s2sr_tpu.models.weights import save_params
from s2sr_tpu_torch.models import engine as engine_mod
from s2sr_tpu_torch.models import registry
from s2sr_tpu_torch.pipelines import wow_sr

from test_torch_engine import assert_bytes_close
from test_torch_swinir import DEPTHS, DIM, HEADS, WIN, jax_tree

TINY = {"family": "swinir", "scale": 2, "embed_dim": DIM, "depths": DEPTHS,
        "num_heads": HEADS, "window_size": WIN, "description": "test"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    save_params(jax_tree(2, seed=1), d / "swinir_tiny.npz")
    jax_registry.MODELS["swinir_tiny"] = dict(TINY)
    registry.MODELS["swinir_tiny"] = dict(TINY)
    kw = dict(weights_dir=d, tile_size=16, dtype="float32")
    # exact_area 0: every image takes the tiled path
    yield {"jax": jax_engine_mod.SREngine("swinir_tiny", **kw),
           "port": engine_mod.SREngine("swinir_tiny", device="cpu", **kw),
           "jax_tiled": jax_engine_mod.SREngine("swinir_tiny", exact_area=0,
                                                **kw),
           "port_tiled": engine_mod.SREngine("swinir_tiny", exact_area=0,
                                             device="cpu", **kw),
           "dir": d}
    jax_registry.MODELS.pop("swinir_tiny", None)
    registry.MODELS.pop("swinir_tiny", None)


def image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("shape", [(24, 20), (13, 30), (3, 5)])
def test_exact_path_matches_jax(tiny, shape):
    """Small images run the exact per-shape forward (no bucket); (3, 5)
    reflect-pads past its side."""
    eng, jeng = tiny["port"], tiny["jax"]
    assert eng.pretrained and eng.tile_pad == 16
    img = image(shape, sum(shape))
    assert eng._serving_parts(img) is None
    want = jeng.enhance_serving(img)
    got = eng.enhance_serving(img)
    assert_bytes_close(got, want)
    assert np.array_equal(eng.enhance(img), got)


@pytest.mark.parametrize("shape", [(60, 52), (49, 70)])
def test_tiled_path_matches_jax(tiny, shape):
    eng, jeng = tiny["port_tiled"], tiny["jax_tiled"]
    img = image(shape, 7)
    parts = eng._serving_parts(img)
    assert parts is not None and parts[1]["kind"] == "tiled"
    assert parts[0].shape[1:3] == (48, 48)           # 16-px tile, 16-px halo
    got = eng.enhance_serving(img)
    assert_bytes_close(got, jeng.enhance_serving(img))
    assert np.array_equal(eng.enhance(img), got)


def test_serving_many_equals_single(tiny):
    eng = tiny["port_tiled"]
    imgs = [image((40, 52), 8), image((9, 7), 9), image((52, 40), 10)]
    for img, out in zip(imgs, eng.enhance_serving_many(imgs)):
        assert np.array_equal(out, eng.enhance_serving(img))


def test_wow_pipeline_runs_swinir(tiny, tmp_path):
    from s2sr_tpu_torch.fetch.synthetic import synthetic_scene

    tif = tmp_path / "scene.tif"
    synthetic_scene(tif, size=(24, 32), seed=3)
    res = wow_sr.process_wow_sr(tif, tmp_path / "out", model="swinir_tiny",
                                weights_dir=str(tiny["dir"]),
                                precision="float32", device="cpu")
    meta = res["sr_metadata"]
    assert meta["output_size"] == [48, 64] and meta["scale"] == 2
    assert meta["stages"][0]["model"] == "swinir_tiny"
    assert meta["pretrained"] and meta["precision"] == "float32"
    assert res["outputs"]["sr_tif"] and res["outputs"]["sr_png"]
    assert wow_sr.MODEL_DISPLAY.get("swinir_x4", "swinir_x4") == "swinir_x4"
