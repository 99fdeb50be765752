"""Port's WOW chain ops (``s2sr_tpu_torch.ops``: color, CLAHE, blur,
``enhance_for_crops``) against the JAX package, byte for byte.

The port runs the ops as written, one rounding per op. It is
byte-identical to the JAX functions run the same way (``disable_jit``,
checked on the whole chain at an odd CLAHE tile size: eager JAX runs
the even-tile blend's ``lax.map`` too slowly for tier-1) and to
jitted JAX for every op but CLAHE's final blend: under jit the
CPU compiler turns ``x / th`` into a reciprocal multiply and contracts
multiply-adds into fma, which moves values lying on a ``.5`` rounding
tie by one LSB (tens of pixels per 10⁴). Those comparisons allow
|diff| ≤ 1 on CLAHE's output, and the chain's downstream spread of
such pixels, on at most 1% of pixels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.ops import blur as jb
from s2sr_tpu.ops import clahe as jcl
from s2sr_tpu.ops import color as jc
from s2sr_tpu.ops import enhance as je
from s2sr_tpu_torch.ops import blur as tb
from s2sr_tpu_torch.ops import clahe as tcl
from s2sr_tpu_torch.ops import color as tc
from s2sr_tpu_torch.ops import enhance as te


def rand_u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["rgb_to_lab_u8", "lab_to_rgb_u8",
                                  "rgb_to_hsv_u8"])
@pytest.mark.parametrize("shape", [(67, 93, 3), (128, 128, 3)])
def test_color_byte_identical(name, shape):
    img = rand_u8(shape, 0)
    want = np.asarray(jax.jit(getattr(jc, name))(jnp.asarray(img)))
    got = getattr(tc, name)(t(img)).numpy()
    assert np.array_equal(got, want)


def test_rgb_to_lab_cube_slice():
    # every (r, g) pair at 16 blue levels: 2^20 colors
    r, g, b = np.meshgrid(np.arange(256), np.arange(256),
                          np.arange(0, 256, 16), indexing="ij")
    img = np.stack([r, g, b], -1).reshape(-1, 3).astype(np.uint8)
    want = np.asarray(jax.jit(jc.rgb_to_lab_u8)(jnp.asarray(img)))
    assert np.array_equal(tc.rgb_to_lab_u8(t(img)).numpy(), want)


def test_hsv_to_rgb_full_cube():
    """All 256³ HSV triples (H ≥ 180 included), in four slices to bound
    memory; the emulated fma must keep cv2's single rounding."""
    h, s, v = np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                          indexing="ij")
    cube = np.stack([h, s, v], -1).reshape(-1, 3).astype(np.uint8)
    fn = jax.jit(jc.hsv_to_rgb_u8)
    for part in np.array_split(cube, 4):
        want = np.asarray(fn(jnp.asarray(part)))
        assert np.array_equal(tc.hsv_to_rgb_u8(t(part)).numpy(), want)


@pytest.mark.parametrize("shape", [(64, 64), (128, 96), (67, 93),
                                   (100, 60), (256, 192)])
def test_clahe(shape):
    ch = rand_u8(shape, 1)
    got = tcl.clahe_u8(t(ch), 2.5, 8, 8).numpy()
    jitted = np.asarray(jcl.clahe_u8(jnp.asarray(ch), 2.5, 8, 8))
    diff = np.abs(got.astype(np.int16) - jitted)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01   # .5 ties only


@pytest.mark.parametrize("sigma", [1.0, 1.2, 1.5, 2.0])
def test_gaussian_blur_byte_identical(sigma):
    img = rand_u8((61, 47, 3), 2)
    want = np.asarray(jax.jit(lambda a: jb.gaussian_blur_u8(a, sigma))(
        jnp.asarray(img)))
    assert np.array_equal(tb.gaussian_blur_u8(t(img), sigma).numpy(), want)


def test_add_weighted_byte_identical():
    a, b = rand_u8((128, 128, 3), 3), rand_u8((128, 128, 3), 4)
    want = np.asarray(jax.jit(lambda x, y: jb.add_weighted_u8(
        x, 1.4, y, -0.4))(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(tb.add_weighted_u8(t(a), 1.4, t(b), -0.4).numpy(),
                          want)


@pytest.mark.parametrize("shape", [(64, 64, 3), (128, 96, 3), (67, 93, 3)])
def test_enhance_for_crops(shape):
    img = rand_u8(shape, 5)
    got = te.enhance_for_crops(t(img)).numpy()
    assert got.shape == shape and got.dtype == np.uint8
    if shape == (67, 93, 3):             # odd CLAHE tile: fast eagerly
        with jax.disable_jit():
            eager = np.asarray(je.enhance_for_crops(jnp.asarray(img)))
        assert np.array_equal(got, eager)
    jitted = np.asarray(je.enhance_for_crops(jnp.asarray(img)))
    # a CLAHE tie moves L by 1; Lab→RGB→HSV→RGB can spread that to a few
    # LSB on the same pixel, so bound the share of pixels touched
    touched = np.any(got != jitted, axis=-1)
    assert touched.mean() <= 0.01
