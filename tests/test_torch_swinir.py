"""Port's SwinIR (``s2sr_tpu_torch.models.swinir``) against the JAX
package's ``SwinIR.apply`` with the same weights, carried over by
``params_from_jax_swinir``, on a tiny configuration in fp32 on the CPU
(where every Swin block runs its plain version)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.models import swinir as jsw
from s2sr_tpu_torch.models import swinir as psw
from s2sr_tpu_torch.models.weights import (
    convert_swinir_state_dict,
    init_swinir_state_dict,
    params_from_jax_swinir,
    resolve_params,
)
from torch_threads import one_torch_thread  # noqa: F401

DIM, DEPTHS, HEADS, WIN, NF = 12, (2, 2), (2, 2), 4, 64
KW = dict(embed_dim=DIM, depths=DEPTHS, num_heads=HEADS, window_size=WIN,
          num_feat=NF)


def jax_tree(scale, seed=0):
    """A JAX SwinIR tree (the structure of ``SwinIR.init``) with every
    leaf drawn from numpy: weights at a scale where the Swin blocks move
    the output, nonzero biases, norm weights around 1."""
    rng = np.random.default_rng(seed)
    # the structure and shapes only: no init is run
    init = jax.eval_shape(jsw.SwinIR(scale=scale, **KW).init,
                          jax.random.PRNGKey(0))

    def draw(path, leaf):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        shape = np.shape(leaf)
        if names[-1] == "bias":
            v = rng.normal(0, 0.02, shape)
        elif names[-1] == "weight" and len(shape) == 1:     # LayerNorm
            v = 0.5 + rng.random(shape)
        elif names[-1] == "relative_position_bias_table":
            v = rng.normal(0, 0.2, shape)
        elif names[-1] == "kernel":
            v = rng.normal(0, 0.05, shape)
        else:                                               # Linear
            v = rng.normal(0, 0.15, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, init)


def port_model(tree, scale, dtype=torch.float32):
    m = psw.SwinIR(scale=scale, dtype=dtype, **KW)
    m.load_state_dict(params_from_jax_swinir(tree))
    return m.eval().pack()


@pytest.fixture(scope="module")
def trees():
    return {s: jax_tree(s) for s in (2, 4)}


def run_both(tree, scale, shape, seed):
    x = np.random.default_rng(seed).random((1, *shape, 3)).astype(np.float32)
    want = np.asarray(jsw.SwinIR(scale=scale, **KW).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    got = port_model(tree, scale)(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("scale, shape", [
    (2, (8, 8)), (2, (7, 6)), (2, (16, 16)), (2, (16, 24)),
    (2, (2, 3)), (2, (1, 2)), (4, (7, 6)), (4, (1, 2))])
def test_swinir_matches_jax(trees, scale, shape):
    """(2, 3) and (1, 2): the reflect pad to window 4 reaches or passes
    the side (and a side of 1), which numpy's reflect takes and
    F.pad(mode="reflect") refuses."""
    got, want = run_both(trees[scale], scale, shape, seed=sum(shape))
    assert got.shape == want.shape == (1, scale * shape[0], scale * shape[1], 3)
    # fp32; as tests/test_swinir.py holds the JAX model to its oracle
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-3)


def test_attn_level_matches_jax(trees, monkeypatch):
    monkeypatch.setattr(psw, "FUSED_LEVEL", "attn")
    got, want = run_both(trees[2], 2, (16, 24), seed=5)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("n, pad", [(3, 5), (1, 3), (2, 2), (5, 3), (4, 0)])
def test_reflect_index_follows_numpy(n, pad):
    want = np.pad(np.arange(n), (0, pad), mode="reflect")
    np.testing.assert_array_equal(psw.reflect_index(n, pad).numpy(), want)


def test_blocks_move_the_output(trees):
    """The test weights make the trunk matter: dropping its Swin blocks'
    attention changes the output by far more than the tolerance."""
    x = torch.from_numpy(np.random.default_rng(9).random((1, 8, 8, 3))
                         .astype(np.float32))
    m = port_model(trees[2], 2)
    out = m(x)
    for b in m.blocks():
        b.tables["wo"].zero_()
    assert (m(x) - out).abs().max() > 0.05


def test_params_win_over_params_ema():
    sd = init_swinir_state_dict(scale=2, seed=1, **KW)
    other = init_swinir_state_dict(scale=2, seed=2, **KW)
    extra = {"layers.0.residual_group.blocks.1.attn_mask": torch.zeros(1),
             "layers.0.residual_group.blocks.0.attn.relative_position_index":
             torch.zeros(1)}
    got = convert_swinir_state_dict({"params": {**sd, **extra},
                                     "params_ema": other}, depths=DEPTHS)
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    m = psw.SwinIR(scale=2, **KW)
    m.load_state_dict(got)                               # strict


def test_pth_and_npz_resolve(tmp_path, trees):
    from s2sr_tpu.models.weights import save_params
    from s2sr_tpu_torch.models import registry

    cfg = {"family": "swinir", "scale": 2, "embed_dim": DIM,
           "depths": DEPTHS, "num_heads": HEADS, "window_size": WIN}
    registry.MODELS["swinir_tiny_w"] = cfg
    try:
        sd = init_swinir_state_dict(scale=2, seed=3, **KW)
        torch.save({"params": sd}, tmp_path / "swinir_tiny_w.pth")
        got, pre = resolve_params("swinir_tiny_w", tmp_path)
        assert pre and all(torch.equal(got[k], sd[k]) for k in sd)
        save_params(trees[2], tmp_path / "swinir_tiny_w.npz")   # npz wins
        got, pre = resolve_params("swinir_tiny_w", tmp_path)
        want = params_from_jax_swinir(trees[2])
        assert pre and all(torch.equal(got[k], want[k]) for k in want)
        got, pre = resolve_params("swinir_tiny_w", tmp_path / "none")
        assert not pre and got.keys() == sd.keys()
    finally:
        registry.MODELS.pop("swinir_tiny_w", None)


def test_init_matches_jax_shapes_and_scales():
    sd = init_swinir_state_dict(scale=4, **KW)
    tree = jsw.SwinIR(scale=4, **KW).init(jax.random.PRNGKey(0))
    want = params_from_jax_swinir(jax.tree.map(np.asarray, tree))
    assert sd.keys() == want.keys()
    for k in sd:
        assert sd[k].shape == want[k].shape, k
    qkv = sd["layers.0.residual_group.blocks.0.attn.qkv.weight"]
    assert qkv.abs().max() <= 0.04 + 1e-7 and 0.015 < qkv.std() < 0.02
    assert torch.equal(init_swinir_state_dict(scale=4, **KW)["conv_last.weight"],
                       sd["conv_last.weight"])


@pytest.mark.parametrize("h", [40, 41, 23])
def test_tail_strips_bit_exact(monkeypatch, h):
    m = psw.SwinIR(scale=4, **KW)
    m.load_state_dict(init_swinir_state_dict(scale=4, seed=4, **KW))
    m.eval()
    monkeypatch.setattr(psw, "TAIL_STRIP", 16)
    feat = torch.from_numpy(np.random.default_rng(h).random((1, DIM, h, 24))
                            .astype(np.float32))
    with torch.no_grad():
        a, b = m._tail(feat), m._tail_strips(feat)
    assert a.shape == b.shape == (1, 3, 4 * h, 96)
    assert torch.equal(a, b), (a - b).abs().max()


def test_bf16_forward_tracks_fp32(trees):
    x = torch.from_numpy(np.random.default_rng(11).random((1, 12, 16, 3))
                         .astype(np.float32))
    want = port_model(trees[2], 2)(x)
    got = port_model(trees[2], 2, dtype=torch.bfloat16)(x)
    assert got.dtype == torch.float32
    # bf16 storage through 4 blocks and the convs
    assert (got - want).abs().max() < 0.05


def test_unknown_level_raises(trees, monkeypatch):
    m = port_model(trees[2], 2)
    monkeypatch.setattr(psw, "FUSED_LEVEL", "xla")
    with pytest.raises(ValueError, match="fused level"):
        m(torch.zeros(1, 4, 4, 3))
