"""The port's package exports against the JAX package's, its
``unsharp_mask_u8`` byte for byte against JAX's, and the one-device
``build_mesh``."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.mark.parametrize("pkg", ["ops", "models", "parallel", "training"])
def test_package_all_equals_jax(pkg):
    port = importlib.import_module(f"s2sr_tpu_torch.{pkg}")
    ref = importlib.import_module(f"s2sr_tpu.{pkg}")
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert callable(getattr(port, name)) or isinstance(
            getattr(port, name), dict), name


@pytest.mark.parametrize("sigma", [1.0, 1.2, 1.5, 2.0])
def test_unsharp_mask_u8_equals_jax(sigma):
    from s2sr_tpu.ops.blur import unsharp_mask_u8 as junsharp
    from s2sr_tpu_torch.ops import unsharp_mask_u8

    rng = np.random.default_rng(int(sigma * 10))
    img = rng.integers(0, 256, (37, 45, 3), dtype=np.uint8)
    img[5:20, 8:30] = 200                      # flat patches and edges
    for amount in (0.4, 0.8):
        want = np.asarray(junsharp(jnp.asarray(img), sigma, amount))
        got = unsharp_mask_u8(torch.from_numpy(img), sigma, amount).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_build_mesh_one_device():
    from s2sr_tpu_torch.parallel import build_mesh

    mesh = build_mesh("dp=1", device="cpu")
    assert mesh.axis_names == ("dp",) and mesh.shape == (1,)
    assert build_mesh("", device="cpu").axis_names == ("dp",)
    assert build_mesh("dp=1,sp=1", device="cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="item 16"):
        build_mesh("dp=2", device="cpu")
