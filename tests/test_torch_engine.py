"""Port's ``SREngine`` against the JAX engine on a one-block model with
the same ``.npz`` weights, on the CPU, in fp32.

Target: byte-identical uint8. The engines truncate ``x·255``, so a
float difference of one summation order can move a pixel that sits on
an integer boundary by one LSB; each comparison therefore allows
|diff| ≤ 1 on at most 0.1% of the bytes (and measured 0 on these
inputs when written).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.models import engine as jax_engine_mod
from s2sr_tpu.models import registry as jax_registry
from s2sr_tpu.models.weights import save_params
from s2sr_tpu_torch.models import engine as engine_mod
from s2sr_tpu_torch.models import registry

TINY = {"family": "rrdbnet", "scale": 4, "channels": 64, "blocks": 1,
        "growth": 32, "num_in_ch": 3, "description": "test"}


def jax_tree_one_block(rng, nf=64, gc=32):
    """A JAX rrdbnet param tree (HWIO, stacked body) drawn with numpy at
    the JAX init's scale, with nonzero biases."""
    def conv(cin, cout, stack=False):
        k = rng.normal(size=(3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin)) * 0.1
        b = rng.normal(0, 0.02, cout)
        if stack:
            k, b = k[None], b[None]
        return {"kernel": k.astype(np.float32), "bias": b.astype(np.float32)}

    body = {f"rdb{j}": {f"conv{k}": conv(nf + (k - 1) * gc,
                                         gc if k < 5 else nf, stack=True)
                        for k in range(1, 6)} for j in (1, 2, 3)}
    tree = {"conv_first": conv(3, nf), "body": body,
            "conv_last": conv(nf, 3)}
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        tree[name] = conv(nf, nf)
    return tree


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """'rrdb_tiny' registered in both registries, one .npz for both."""
    d = tmp_path_factory.mktemp("weights")
    params = jax_tree_one_block(np.random.default_rng(0))
    save_params(params, d / "rrdb_tiny.npz")
    jax_registry.MODELS["rrdb_tiny"] = dict(TINY)
    registry.MODELS["rrdb_tiny"] = dict(TINY)
    kw = dict(weights_dir=d, tile_size=32, dtype="float32", pad_probe=False)
    yield (jax_engine_mod.SREngine("rrdb_tiny", **kw),
           engine_mod.SREngine("rrdb_tiny", device="cpu", **kw), d, params)
    jax_registry.MODELS.pop("rrdb_tiny", None)
    registry.MODELS.pop("rrdb_tiny", None)


def assert_bytes_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("shape", [(40, 52), (64, 64), (23, 61)])
def test_masked_bucket_path_matches_jax(tiny, shape):
    jax_eng, eng, _, _ = tiny
    img = np.random.default_rng(1).integers(0, 256, (*shape, 3)).astype(np.uint8)
    assert shape[0] * shape[1] <= eng.engage_area          # bucket path
    want = jax_eng.enhance_serving(img)
    got = eng.enhance_serving(img)
    assert_bytes_close(got, want)
    assert np.array_equal(eng.enhance(img), got)     # exact == serving


@pytest.mark.parametrize("shape", [(72, 80), (100, 66)])
def test_tiled_path_matches_jax(tiny, shape):
    jax_eng, eng, _, _ = tiny
    img = np.random.default_rng(2).integers(0, 256, (*shape, 3)).astype(np.uint8)
    assert shape[0] * shape[1] > eng.engage_area            # tiled path
    got = eng.enhance_serving(img)
    assert_bytes_close(got, jax_eng.enhance_serving(img))
    assert np.array_equal(eng.enhance(img), got)


def test_serving_many_equals_single(tiny):
    _, eng, _, _ = tiny
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, s).astype(np.uint8)
            for s in ((30, 40, 3), (72, 80, 3), (20, 20, 3), (80, 72, 3))]
    many = eng.enhance_serving_many(imgs)
    for img, out in zip(imgs, many):
        assert np.array_equal(out, eng.enhance_serving(img))


def test_power_of_two_chunks(tiny):
    _, eng, _, _ = tiny
    wins = np.random.default_rng(4).integers(0, 256, (7, 8, 8, 3)).astype(np.uint8)
    eng.batch_size = 4
    try:
        before = eng.chunks_dispatched
        out = eng._run_chunked(wins)
        assert eng.chunks_dispatched - before == 3       # 4 + 2 + 1
    finally:
        eng.batch_size = 16
    assert out.shape == (7, 32, 32, 3)
    for i in range(7):   # each window alone gives the same bytes
        assert_bytes_close(eng._run_chunked(wins[i:i + 1])[0], out[i])


def test_halo_probe_matches_jax(tiny):
    _, _, d, params = tiny
    eng = engine_mod.SREngine("rrdb_tiny", weights_dir=d, tile_size=32,
                              dtype="float32", pad_probe=True, device="cpu")
    assert eng.pretrained and eng.halo_margin_lsb is not None
    want = jax_engine_mod.probe_halo_margin(
        jax.tree.map(jnp.asarray, params), 4, jnp.float32, 4)
    # both near the fp32 noise floor, far under the 0.25-LSB threshold
    assert abs(eng.halo_margin_lsb - want) < 1e-3
    assert eng.tile_pad == 4


def test_unported_options_raise(tmp_path):
    # SwinIR is ported: swinir_x4 builds on the CPU from its random init,
    # with the reference's halo of at least 16 and the exact-area rule
    eng = engine_mod.SREngine("swinir_x4", weights_dir=tmp_path, device="cpu")
    assert eng.family == "swinir" and not eng.pretrained
    assert eng.tile_pad >= 16 and eng.scale == 4
    assert eng.engage_area == engine_mod.SWINIR_EXACT_AREA == 2560 * 2560
    assert len(eng.model.blocks()) == 36
    with pytest.raises(ValueError, match="only supported for rrdbnet"):
        engine_mod.SREngine("swinir_x2", weights_dir=tmp_path, dtype="int8",
                            device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        engine_mod.SREngine("realesrgan_anime", weights_dir=tmp_path,
                            dtype="int8", device="cpu")


def test_cuda_default_raises_without_gpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    _, _, d, _ = tiny
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine_mod.SREngine("rrdb_tiny", weights_dir=d, dtype="float32")


def test_get_engine_caches(tiny):
    _, _, d, _ = tiny
    a = engine_mod.get_engine("rrdb_tiny", weights_dir=str(d),
                              dtype="float32", device="cpu")
    b = engine_mod.get_engine("rrdb_tiny", weights_dir=str(d),
                              dtype="float32", device="cpu")
    assert a is b and a.tile_size == 256 and a.tile_pad == 4
    assert a.batch_size == 16 and a.device.type == "cpu"


def test_settings_match_jax(tmp_path, monkeypatch):
    from s2sr_tpu.config.settings import load_settings as jax_load
    from s2sr_tpu_torch.config import Settings, load_settings

    names = [f for f in Settings.__dataclass_fields__]
    assert names == ["sr_tile_size", "sr_tile_pad", "sr_batch_size",
                     "sr_dtype", "sr_exact_area", "sr_pad_probe"]
    env = tmp_path / ".env"
    env.write_text("# knobs\nSR_TILE_SIZE=128\nsr_dtype='float32'\n"
                   "SR_PAD_PROBE=false\nUNRELATED=1\n")
    monkeypatch.setenv("SR_BATCH_SIZE", "8")
    monkeypatch.setenv("sr_tile_size", "192")      # environment beats .env
    for env_file in (None, env):
        want, got = jax_load(env_file), load_settings(env_file)
        assert {n: getattr(got, n) for n in names} == \
            {n: getattr(want, n) for n in names}
    got = load_settings(env, sr_tile_pad=6)
    assert (got.sr_tile_size, got.sr_tile_pad, got.sr_batch_size,
            got.sr_dtype, got.sr_pad_probe) == (192, 6, 8, "float32", False)


def test_random_init_without_weights(tmp_path):
    registry.MODELS["rrdb_tiny2"] = dict(TINY)
    try:
        eng = engine_mod.SREngine("rrdb_tiny2", weights_dir=tmp_path,
                                  device="cpu")
    finally:
        registry.MODELS.pop("rrdb_tiny2", None)
    assert not eng.pretrained and eng.halo_margin_lsb is None
    assert eng.dtype == torch.bfloat16
    out = eng.enhance_serving(np.full((16, 12, 3), 128, np.uint8))
    assert out.shape == (64, 48, 3) and out.dtype == np.uint8
