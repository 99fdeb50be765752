"""The training path's ops against the JAX package on the CPU: the float
Gaussian blur, the JPEG degradation, the metrics, and the trainable
forwards (``rrdbnet_apply``, ``swinir_apply``) with remat, on the same
numpy-seeded inputs and params."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu_torch.models.weights import (tree_flatten, tree_to_torch,
                                           tree_unflatten)
from torch_threads import one_torch_thread  # noqa: F401


def test_gaussian_blur_matches_jax():
    from s2sr_tpu.ops.blur import gaussian_blur as jblur
    from s2sr_tpu_torch.ops import gaussian_blur

    rng = np.random.default_rng(0)
    imgs = rng.random((3, 20, 27, 3), dtype=np.float32)
    for sigma in (0.6, 1.0, 2.0):
        want = np.stack([np.asarray(jblur(jnp.asarray(im), sigma))
                         for im in imgs])
        got = gaussian_blur(torch.from_numpy(imgs), sigma).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        one = gaussian_blur(torch.from_numpy(imgs[0]), sigma).numpy()
        np.testing.assert_array_equal(one, got[0])


def _near_half_blocks(img, q):
    """(by, bx) of every 16×16 MCU where JAX's own float32 ``coef / table``
    of any channel lies within 1e-4 of a half-integer (round may go
    either way there)."""
    from s2sr_tpu.ops import jpeg as jj

    x = img.astype(np.float32) * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    h, w = y.shape
    d = jj.dct8_matrix()
    bad = set()
    tl = np.asarray(jj.luma_qtable(float(q)))
    tc = np.asarray(jj.chroma_qtable(float(q)))
    planes = [(y, tl, 1)] + [
        (c.reshape(h // 2, 2, w // 2, 2).mean((1, 3)), tc, 2) for c in (cb, cr)]
    for ch, table, f in planes:
        bl = np.asarray(jj._blocks(jnp.asarray(ch - 128.0)))
        coef = np.asarray(jnp.einsum("ij,bcjk,lk->bcil", d, bl, d))
        frac = np.abs(coef / table - np.floor(coef / table) - 0.5)
        for by, bx in zip(*np.nonzero((frac < 1e-4).any((-1, -2)))):
            bad.add((by * 8 * f // 16, bx * 8 * f // 16))
    return bad


@pytest.mark.parametrize("subsample", [True, False])
def test_jpeg_degrade_matches_jax(subsample):
    from s2sr_tpu.ops.jpeg import jpeg_degrade as jdeg
    from s2sr_tpu.ops import jpeg as jj
    from s2sr_tpu_torch.ops.jpeg import (chroma_qtable, jpeg_degrade,
                                         luma_qtable)

    rng = np.random.default_rng(1)
    imgs = rng.random((3, 32, 48, 3), dtype=np.float32)
    imgs[0] = np.clip(imgs[0] * 0.2 + np.linspace(0, 0.8, 48)[None, :, None],
                      0, 1)
    qs = np.array([30.0, 57.5, 95.0], np.float32)
    got = jpeg_degrade(torch.from_numpy(imgs), torch.from_numpy(qs),
                       subsample=subsample).numpy()
    for q in (1.0, 33.0, 49.9, 50.0, 77.7, 100.0):
        np.testing.assert_array_equal(luma_qtable(q).numpy(),
                                      np.asarray(jj.luma_qtable(q)))
        np.testing.assert_array_equal(chroma_qtable(q).numpy(),
                                      np.asarray(jj.chroma_qtable(q)))
    differing = 0
    for im, q, g in zip(imgs, qs, got):
        want = np.asarray(jdeg(jnp.asarray(im), float(q), subsample))
        diff = np.abs(g - want) > 1e-5
        bad = _near_half_blocks(im, q) if subsample else set()
        for by, bx in zip(*np.nonzero(diff.reshape(2, 16, 3, 16, 3)
                                      .any((1, 3, 4)))):
            assert (by, bx) in bad, (q, by, bx)
        differing += int(diff.sum())
        one = jpeg_degrade(torch.from_numpy(im), float(q), subsample).numpy()
        np.testing.assert_array_equal(one, g)
    assert differing < got.size // 100


def test_metrics_match_jax():
    from s2sr_tpu.utils import metrics as jm
    from s2sr_tpu_torch.utils import metrics as pm

    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (40, 33, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0, 255)
    small = a[:8, :8]
    for fa, fb in ((a, b), (small, b[:8, :8]), (a[..., 0], b[..., 0])):
        assert abs(pm.psnr(fa, fb) - jm.psnr(fa, fb)) <= 1e-12
        assert abs(pm.ssim(fa, fb) - jm.ssim(fa, fb)) <= 1e-12
        assert abs(pm.ssim_global(fa, fb) - jm.ssim_global(fa, fb)) <= 1e-12
    assert pm.psnr(a, a) == float("inf")


def _jax_rrdb_params(seed=3, feat=8, blocks=2, grow=4):
    """An RRDBNet tree in the JAX layout with numpy draws large enough
    that every conv moves the output (nonzero biases)."""
    from s2sr_tpu_torch.models.weights import init_state_dict, rrdbnet_tree

    tree = rrdbnet_tree(init_state_dict(num_feat=feat, num_block=blocks,
                                        num_grow_ch=grow))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.normal(0, 0.15, np.shape(a))).astype(np.float32), tree)


@pytest.mark.parametrize("scale", [2, 4])
def test_rrdbnet_apply_matches_jax(scale):
    from s2sr_tpu.models.rrdbnet import rrdbnet_apply as japply
    from s2sr_tpu_torch.models import rrdbnet_apply

    tree = _jax_rrdb_params()
    rng = np.random.default_rng(4)
    x = rng.random((2, 10, 12, 3), dtype=np.float32)
    fwd = jax.jit(lambda p, x, m: japply(p, x, scale=scale, dtype=jnp.float32,
                                         mask=m))
    want = np.asarray(fwd(tree, x, None))
    got = rrdbnet_apply(tree_to_torch(tree), torch.from_numpy(x), scale=scale,
                        dtype=torch.float32)
    assert got.shape == (2, 10 * scale, 12 * scale, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    mask = np.zeros((2, 10, 12, 1), np.float32)
    mask[:, :7, :9] = 1
    want = np.asarray(fwd(tree, x * mask, mask))
    got = rrdbnet_apply(tree_to_torch(tree), torch.from_numpy(x * mask),
                        scale=scale, dtype=torch.float32,
                        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # bf16: the same casts per conv (its rounding differs by backend)
    bf = rrdbnet_apply(tree_to_torch(tree), torch.from_numpy(x), scale=scale)
    ref = rrdbnet_apply(tree_to_torch(tree), torch.from_numpy(x), scale=scale,
                        dtype=torch.float32)
    assert bf.dtype == torch.float32
    assert float((bf - ref).abs().max()) < 0.05


@pytest.mark.parametrize("family", ["rrdbnet", "swinir"])
def test_remat_grads_equal(family):
    from s2sr_tpu_torch.training.train import TrainConfig, init_params, loss_fn

    kw = (dict(num_feat=8, num_block=2, num_grow_ch=4) if family == "rrdbnet"
          else dict(family="swinir", embed_dim=12, depths=(2, 1),
                    heads=(2, 2), window=4))
    rng = np.random.default_rng(5)
    lr = torch.from_numpy(rng.random((2, 8, 8, 3), dtype=np.float32))
    hr = torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32))
    grads = []
    for remat in (False, True):
        cfg = TrainConfig(scale=2, dtype="float32", remat=remat, **kw)
        params = init_params(cfg, seed=1, device="cpu")
        leaves, struct = tree_flatten(params)
        leaves = [p.requires_grad_(True) for p in leaves]
        loss = loss_fn(tree_unflatten(struct, leaves), lr, hr, cfg)
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
    for a, b in zip(*grads):
        if a is None:
            assert b is None
            continue
        assert torch.equal(a, b)


def test_swinir_apply_matches_jax():
    from s2sr_tpu.models.swinir import SwinIR
    from s2sr_tpu_torch.models.swinir import swinir_apply
    from s2sr_tpu_torch.models.weights import (init_swinir_state_dict,
                                               swinir_tree)

    depths, heads = (2, 1), (2, 3)
    net = SwinIR(scale=2, embed_dim=12, depths=depths, num_heads=heads,
                 window_size=4, dtype=jnp.float32, fused_attn="0")
    rng = np.random.default_rng(6)
    tree = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.05, np.shape(a))).astype(np.float32),
        swinir_tree(init_swinir_state_dict(
            scale=2, embed_dim=12, depths=depths, num_heads=heads,
            window_size=4, seed=1), depths))
    x = rng.random((2, 10, 13, 3), dtype=np.float32)
    want = np.asarray(jax.jit(net.apply)(tree, x))
    got = swinir_apply(tree_to_torch(tree), torch.from_numpy(x), scale=2,
                       num_heads=heads, window_size=4, dtype=torch.float32)
    assert got.shape == want.shape
    # float32 sums in another order: 1e-5 of the output's largest value
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
