"""Port's residual dense block (``s2sr_tpu_torch.ops.rdb``) against the
JAX package's ``_rdb_packed`` and Pallas ``rdb_pallas_v4``.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel
itself is held against that version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.models.rrdbnet import _rdb_packed
from s2sr_tpu_torch.ops import rdb as rdb_mod
from s2sr_tpu_torch.ops.rdb import (pack_rdb_weights, rdb, rdb_reference,
                                    unpack_rdb_weights)


@pytest.fixture(scope="module")
def rdb_params():
    """One RDB at the kernel's widths (64 features, growth 32), with
    nonzero biases so the bias path is exercised."""
    rng = np.random.default_rng(3)
    p = {}
    for k in range(1, 6):
        cin, cout = 64 + 32 * (k - 1), 32 if k < 5 else 64
        # the JAX init's scale: normal · sqrt(2 / fan_in) · 0.1
        p[f"conv{k}"] = {
            "kernel": (rng.normal(size=(3, 3, cin, cout))
                       * np.sqrt(2.0 / (9 * cin)) * 0.1).astype(np.float32),
            "bias": rng.normal(0, 0.05, cout).astype(np.float32)}
    return p


def torch_weights(p, dtype=torch.float32):
    kernels = [torch.from_numpy(np.transpose(p[f"conv{k}"]["kernel"],
                                             (3, 2, 0, 1)).copy())
               for k in range(1, 6)]
    biases = [torch.from_numpy(p[f"conv{k}"]["bias"]) for k in range(1, 6)]
    return pack_rdb_weights(kernels, biases, dtype)


def make_mask(shape, rng):
    b, h, w = shape
    mask = np.zeros((b, h, w, 1), np.float32)
    for i in range(b):
        mh, mw = rng.integers(h // 2, h + 1), rng.integers(w // 2, w + 1)
        mask[i, :mh, :mw] = 1.0
    return mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(1, 12, 12), (2, 70, 50), (1, 40, 200)])
def test_reference_matches_jax_rdb_packed(rdb_params, shape, masked):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 0.5, (*shape, 64)).astype(np.float32)
    mask = make_mask(shape, rng) if masked else None
    want = np.asarray(_rdb_packed(jnp.asarray(x), jax.tree.map(
        jnp.asarray, rdb_params), jnp.float32,
        None if mask is None else jnp.asarray(mask)))
    w, b = torch_weights(rdb_params)
    got = rdb_reference(torch.from_numpy(x), w, b,
                        None if mask is None else torch.from_numpy(mask))
    # fp32, same formulation; only conv summation order differs
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_reference_matches_pallas_v4_interpret(rdb_params):
    from s2sr_tpu.ops.pallas.fused_rdb import pack_rdb_weights_v2
    from s2sr_tpu.ops.pallas.fused_rdb_v4 import rdb_pallas_v4

    rng = np.random.default_rng(8)
    x = rng.random((2, 70, 50, 64)).astype(np.float32)
    packed, b14, b5 = pack_rdb_weights_v2(
        jax.tree.map(jnp.asarray, rdb_params), dtype=jnp.float32)
    want = np.asarray(rdb_pallas_v4(jnp.asarray(x), packed, b14, b5,
                                    interpret=True, tile=32))
    w, b = torch_weights(rdb_params)
    got = rdb_reference(torch.from_numpy(x), w, b)
    # fp32; the TPU kernel accumulates per source in f32 like the port
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_bf16_reference_tracks_jax_bf16(rdb_params):
    rng = np.random.default_rng(9)
    x = rng.normal(0, 0.5, (1, 24, 20, 64)).astype(np.float32)
    want = np.asarray(_rdb_packed(
        jnp.asarray(x, jnp.bfloat16),
        jax.tree.map(jnp.asarray, rdb_params), jnp.bfloat16)
        .astype(jnp.float32))
    w, b = torch_weights(rdb_params, torch.bfloat16)
    got = rdb_reference(torch.from_numpy(x).bfloat16(), w, b).float().numpy()
    # bf16 storage in both; the convs round at bf16 (2^-8 relative) and
    # may sum in another order, so allow a few bf16 ulps at |v| < 2
    np.testing.assert_allclose(got, want, atol=2.0 ** -5)


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_wrapper_takes_plain_path(rdb_params, masked):
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 18, 22, 64)).astype(np.float32))
    mask = (torch.from_numpy(make_mask((2, 18, 22), rng)[..., 0]).contiguous()
            if masked else None)
    w, b = torch_weights(rdb_params)
    before = rdb_mod.LAUNCHES
    got = rdb(x, w, b, mask)
    assert rdb_mod.LAUNCHES == before == 0
    assert torch.equal(got, rdb_reference(x, w, b, mask))


def test_wrapper_refuses_other_devices(rdb_params):
    w, b = torch_weights(rdb_params)
    x = torch.empty(1, 4, 4, 64, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        rdb(x, w.to("meta"), b.to("meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_unpack_roundtrip(rdb_params, dtype):
    w, b = torch_weights(rdb_params, dtype)
    assert w.dtype == torch.float32 and w.numel() == 239616
    assert b.numel() == 192
    kernels, biases = unpack_rdb_weights(w, b)
    for k in range(1, 6):
        want = torch.from_numpy(np.transpose(
            rdb_params[f"conv{k}"]["kernel"], (3, 2, 0, 1)).copy())
        assert torch.equal(kernels[k - 1], want.to(dtype).float())
        assert torch.equal(biases[k - 1], torch.from_numpy(
            rdb_params[f"conv{k}"]["bias"]).to(dtype).float())


def test_pack_rejects_wrong_widths():
    kernels = [torch.zeros(16, 32, 3, 3)] * 5
    with pytest.raises(ValueError, match="conv1"):
        pack_rdb_weights(kernels, [torch.zeros(16)] * 5, torch.float32)
