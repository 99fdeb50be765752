"""The host training data path against the JAX package: ``PairSampler``
batches equal for one seed (with blur, noise and the JPEG round trip),
the port's host JPEG round trip byte-equal to OpenCV's
``imencode``/``imdecode`` (libjpeg-turbo), ``area_downsample``, and
``prefetch``'s ordering, error propagation and early exit."""

import threading
import time

import numpy as np
import pytest
import torch

from s2sr_tpu.training import data as jdata
from s2sr_tpu_torch.training import data as pdata


def scenes(n=3, side=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (side + 3 * i, side + i, 3), dtype=np.uint8)
            for i in range(n)]


@pytest.mark.parametrize("knobs", [
    {},
    {"blur_sigma": 1.0, "noise_std": 0.02},
    {"jpeg_range": (30.0, 95.0)},
])
def test_pair_sampler_equals_jax(knobs):
    imgs = scenes()
    kw = dict(crop_lr=16, scale=2, batch_size=3, seed=7, **knobs)
    js = jdata.PairSampler(hr_images=imgs, **kw)
    ps = pdata.PairSampler(hr_images=imgs, **kw)
    for _ in range(2):
        (jl, jh), (pl, ph) = js.sample(), ps.sample()
        assert pl.dtype == np.float32 and ph.dtype == np.float32
        np.testing.assert_array_equal(ph, jh)
        np.testing.assert_array_equal(pl, jl)


def test_pair_sampler_synthetic_equals_jax():
    js = jdata.PairSampler(crop_lr=8, scale=2, batch_size=2, seed=1)
    ps = pdata.PairSampler(crop_lr=8, scale=2, batch_size=2, seed=1)
    for a, b in zip(js.sample(), ps.sample()):
        np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="20x20"):
        pdata.PairSampler(hr_images=[np.zeros((20, 20, 3), np.uint8)],
                          crop_lr=16, scale=2)


def test_area_downsample_equals_jax():
    hr = np.random.default_rng(2).random((12, 8, 3), dtype=np.float32)
    np.testing.assert_array_equal(pdata.area_downsample(hr, 4),
                                  jdata.area_downsample(hr, 4))


@pytest.mark.parametrize("quality", [30, 50, 75, 95])
def test_jpeg_roundtrip_equals_opencv(quality):
    """Byte-equal to libjpeg-turbo's 4:2:0 encode and decode, on even and
    odd sizes, noise and smooth content."""
    cv2 = pytest.importorskip("cv2")
    from s2sr_tpu_torch.tiles.jpeg import jpeg_roundtrip

    rng = np.random.default_rng(quality)
    for h, w in ((48, 48), (37, 53), (16, 33), (9, 15)):
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0)
                           for c in range(3)], -1) + rng.normal(0, 8, (h, w, 3))
        for img in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                    np.clip(smooth, 0, 255).astype(np.uint8)):
            ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                                   [cv2.IMWRITE_JPEG_QUALITY, quality])
            want = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
            np.testing.assert_array_equal(jpeg_roundtrip(img, quality), want)


def test_prefetch_yields_sampler_batches():
    kw = dict(hr_images=scenes(), crop_lr=8, scale=2, batch_size=2, seed=4)
    ref = pdata.PairSampler(**kw)
    got = list(pdata.prefetch(pdata.PairSampler(**kw), steps=3,
                              device="cpu"))
    assert len(got) == 3
    for lr, hr in got:
        wl, wh = ref.sample()
        assert isinstance(lr, torch.Tensor) and lr.device.type == "cpu"
        np.testing.assert_array_equal(lr.numpy(), wl)
        np.testing.assert_array_equal(hr.numpy(), wh)


def test_prefetch_propagates_producer_errors():
    class Boom:
        def sample(self):
            raise ValueError("bad sample")

    with pytest.raises(ValueError, match="bad sample"):
        list(pdata.prefetch(Boom(), steps=3, device="cpu"))


def test_prefetch_early_exit_unblocks_producer():
    before = threading.active_count()
    it = pdata.prefetch(pdata.PairSampler(hr_images=scenes(), crop_lr=8,
                                          scale=2, batch_size=1, seed=3),
                        steps=50, buffer_size=1, device="cpu")
    next(it)
    it.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(pdata.prefetch(pdata.PairSampler(crop_lr=8, scale=2), steps=1))
