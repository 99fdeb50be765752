"""Port's ``RRDBNet`` (``s2sr_tpu_torch.models.rrdbnet``) against the JAX
``rrdbnet_apply``, with the same weights carried across as a released
state dict or through ``params_from_jax``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.models.rrdbnet import rrdbnet_apply
from s2sr_tpu.models.weights import convert_rrdbnet_state_dict as jax_convert
from s2sr_tpu_torch.models.rrdbnet import RRDBNet
from s2sr_tpu_torch.models.weights import (convert_rrdbnet_state_dict,
                                           init_state_dict, params_from_jax)

NF, GC, NB = 64, 32, 2    # the kernel's widths, two RRDB blocks


def make_state_dict(seed: int = 0, nf: int = NF, gc: int = GC, nb: int = NB):
    """Released-checkpoint-style flat state dict (OIHW, ``body.N.*``)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def put(name, cin, cout):
        sd[f"{name}.weight"] = torch.randn(cout, cin, 3, 3, generator=g) * 0.05
        sd[f"{name}.bias"] = torch.randn(cout, generator=g) * 0.05

    put("conv_first", 3, nf)
    for i in range(nb):
        for j in (1, 2, 3):
            for k in (1, 2, 3, 4, 5):
                cin = nf + (k - 1) * gc
                put(f"body.{i}.rdb{j}.conv{k}", cin, gc if k < 5 else nf)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        put(name, nf, nf)
    put("conv_last", nf, 3)
    return sd


@pytest.fixture(scope="module")
def weights():
    sd = make_state_dict()
    jax_params = jax_convert({"params_ema": sd})
    port = RRDBNet(num_block=NB, dtype=torch.float32)
    port.load_state_dict(convert_rrdbnet_state_dict({"params_ema": sd}))
    return jax_params, port.pack()


@pytest.mark.parametrize("shape", [(1, 20, 24), (2, 17, 13)])
def test_forward_matches_jax(weights, shape):
    jax_params, port = weights
    x = np.random.default_rng(0).random((*shape, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a: rrdbnet_apply(
        p, a, dtype=jnp.float32))(jax_params, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0], 4 * shape[1], 4 * shape[2], 3)
    # fp32 end to end; ~50 convs summed in another order
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_params_from_jax_tree():
    """A JAX param tree (stacked body, HWIO) carried over gives the same
    forward as the JAX package."""
    sd = make_state_dict(seed=4, nb=1)
    tree = jax.tree.map(np.asarray, jax_convert(sd))
    port = RRDBNet(num_block=1, dtype=torch.float32)
    port.load_state_dict(params_from_jax(tree))
    port.pack()
    x =np.random.default_rng(1).random((1, 16, 12, 3)).astype(np.float32)
    want = np.asarray(rrdbnet_apply(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(x), dtype=jnp.float32))
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want,
                               atol=1e-5)   # fp32, summation order only


def test_masked_bucket_bit_identical_to_unpadded(weights):
    _, port = weights
    h, w = 21, 27
    x = np.random.default_rng(2).random((1, h, w, 3)).astype(np.float32)
    exact = port(torch.from_numpy(x)).numpy()
    xp = np.zeros((1, 64, 64, 3), np.float32)
    xp[:, :h, :w] = x
    mask = np.zeros((1, 64, 64, 1), np.float32)
    mask[:, :h, :w] = 1.0
    bucket = port(torch.from_numpy(xp), mask=torch.from_numpy(mask)).numpy()
    # the mask re-zeroes every conv input outside the rectangle: exact
    assert np.array_equal(bucket[:, :4 * h, :4 * w], exact)


def test_masked_bucket_matches_jax(weights):
    jax_params, port = weights
    h, w = 13, 19
    xp = np.zeros((1, 32, 32, 3), np.float32)
    xp[:, :h, :w] = np.random.default_rng(3).random((1, h, w, 3))
    mask = np.zeros((1, 32, 32, 1), np.float32)
    mask[:, :h, :w] = 1.0
    want = np.asarray(jax.jit(lambda p, a, m: rrdbnet_apply(
        p, a, dtype=jnp.float32, mask=m))(jax_params, jnp.asarray(xp),
                                          jnp.asarray(mask)))
    got = port(torch.from_numpy(xp), mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)  # fp32, order only


@pytest.mark.parametrize("sub", [1, 2])
def test_up_sub_batch(weights, sub):
    jax_params, port = weights
    x = np.random.default_rng(5).random((3, 12, 10, 3)).astype(np.float32)
    whole = port(torch.from_numpy(x)).numpy()
    split = port(torch.from_numpy(x), up_sub_batch=sub).numpy()
    # same math and order; the CPU conv may block a batch of 1 and of 3
    # differently, so allow float noise
    np.testing.assert_allclose(split, whole, atol=1e-6)
    want = np.asarray(jax.jit(lambda p, a: rrdbnet_apply(
        p, a, dtype=jnp.float32, up_sub_batch=sub))(jax_params,
                                                    jnp.asarray(x)))
    np.testing.assert_allclose(split, want, atol=1e-5)


def test_bf16_close_to_fp32(weights):
    _, port = weights
    x = torch.from_numpy(np.random.default_rng(6).random((1, 16, 16, 3))
                         .astype(np.float32))
    ref = port(x).numpy()
    port.dtype = torch.bfloat16
    try:
        got = port.pack()(x).numpy()
    finally:
        port.dtype = torch.float32
        port.pack()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    # bf16 keeps ~3 significant digits through ~50 convs
    np.testing.assert_allclose(got, ref, atol=0.05)


def test_random_init_shapes_and_determinism():
    a = init_state_dict(num_block=2, seed=0)
    b = init_state_dict(num_block=2, seed=0)
    net = RRDBNet(num_block=2)
    assert set(a) == set(net.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["body.1.rdb3.conv5.weight"].shape == (64, 192, 3, 3)
    assert not torch.equal(a["conv_first.weight"],
                           init_state_dict(num_block=2, seed=1)["conv_first.weight"])


def test_rejects_other_widths():
    with pytest.raises(ValueError, match="64 features"):
        RRDBNet(num_feat=32, num_grow_ch=16)
