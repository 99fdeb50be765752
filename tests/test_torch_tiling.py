"""Port's halo tiling (``s2sr_tpu_torch.parallel.tiling``) against the JAX
package's: identical window plans, byte-identical stitches."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2sr_tpu.parallel import tiling as jt
from s2sr_tpu_torch.parallel import tiling as tt
from torch_threads import one_torch_thread  # noqa: F401

PLANS = [(100, 80, 32, 4, 4), (256, 256, 64, 10, 4), (70, 200, 32, 8, 2),
         (33, 33, 32, 4, 4), (600, 450, 256, 4, 4)]


@pytest.mark.parametrize("h,w,tile,pad,scale", PLANS)
def test_plan_matches_jax(h, w, tile, pad, scale):
    a = jt.TilePlan.for_image(h, w, tile=tile, pad=pad, scale=scale)
    b = tt.TilePlan.for_image(h, w, tile=tile, pad=pad, scale=scale)
    assert (a.ny, a.nx, a.win_h, a.win_w) == (b.ny, b.nx, b.win_h, b.win_w)
    assert np.array_equal(a.starts(), b.starts())
    assert a.keep_size() == b.keep_size()
    for x, y in zip(a.crop_boxes(), b.crop_boxes()):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("h,w,tile,pad,scale", PLANS[:3])
def test_stitch_host_matches_jax(h, w, tile, pad, scale):
    plan = jt.TilePlan.for_image(h, w, tile=tile, pad=pad, scale=scale)
    rng = np.random.default_rng(0)
    outs = rng.integers(0, 256, (plan.num_windows, plan.win_h * scale,
                                 plan.win_w * scale, 3)).astype(np.uint8)
    want = plan.stitch_host(outs)
    got = tt.TilePlan.for_image(h, w, tile=tile, pad=pad,
                                scale=scale).stitch_host(outs)
    assert np.array_equal(got, want)


def _model_pair(scale):
    """The same window function in both frameworks: nearest ×scale of
    2·x plus the window's first pixel — exact in fp32, and
    window-dependent, so overlaps show which window wins."""
    def jax_fn(b):
        up = jnp.repeat(jnp.repeat(b * 2.0, scale, 1), scale, 2)
        return up + b[:, :1, :1, :]

    def torch_fn(b):
        up = (b * 2.0).repeat_interleave(scale, 1).repeat_interleave(scale, 2)
        return up + b[:, :1, :1, :]
    return jax_fn, torch_fn


@pytest.mark.parametrize("h,w,tile,pad,batch", [(100, 80, 32, 4, 4),
                                                 (70, 130, 32, 8, 3),
                                                 (96, 96, 32, 4, 16)])
def test_tiled_apply_byte_identical(h, w, tile, pad, batch):
    jax_fn, torch_fn = _model_pair(4)
    img = np.random.default_rng(1).random((h, w, 3)).astype(np.float32)
    want = np.asarray(jt.tiled_apply(jax_fn, jnp.asarray(img), tile=tile,
                                     pad=pad, scale=4, batch_size=batch))
    got = tt.tiled_apply(torch_fn, torch.from_numpy(img), tile=tile, pad=pad,
                         scale=4, batch_size=batch).numpy()
    assert got.tobytes() == want.tobytes()


def test_tiled_apply_pads_last_chunk_with_last_window():
    seen = []

    def fn(b):
        seen.append(b.clone())
        return b.repeat_interleave(2, 1).repeat_interleave(2, 2)

    img = torch.rand(80, 80, 3)
    tt.tiled_apply(fn, img, tile=32, pad=4, scale=2, batch_size=4)
    assert [s.shape[0] for s in seen] == [4, 4, 4]          # 9 windows
    assert all(torch.equal(seen[-1][i], seen[-1][0]) for i in range(4))


def test_bucket_pad_matches_jax():
    img = np.random.default_rng(2).integers(0, 256, (70, 33, 3)).astype(np.uint8)
    for a, b in zip(jt.bucket_pad(img), tt.bucket_pad(img)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("size", [(40, 40), (80, 72)])
def test_sr_whole_image_matches_jax(size):
    jax_fn, torch_fn = _model_pair(4)
    img = np.random.default_rng(3).random((*size, 3)).astype(np.float32)
    want = np.asarray(jt.sr_whole_image(jax_fn, jnp.asarray(img), tile=16,
                                        pad=4, scale=4, batch_size=4))
    got = tt.sr_whole_image(torch_fn, torch.from_numpy(img), tile=16, pad=4,
                            scale=4, batch_size=4).numpy()
    assert got.tobytes() == want.tobytes()
