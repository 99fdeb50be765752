"""Port's Swin block and window attention (``s2sr_tpu_torch.ops.
window_attention``) against the JAX package's Pallas kernels (interpret
mode) and its XLA ``_swin_block``, at the kernels' widths (C 180, 6
heads, window 8, MLP 360), on the CPU.

On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those versions on the card by
``chip_smoke.py`` (phase ``swin_kernel``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.models import swinir as sw
from s2sr_tpu.ops.pallas.window_attention import (
    build_attention_tables,
    swin_block_fused,
    window_attention_fused,
)
from s2sr_tpu_torch.ops import window_attention as wa

C, HEADS, WIN, HIDDEN = 180, 6, 8, 360


def jax_block(seed, c=C, heads=HEADS, win=WIN, hidden=HIDDEN):
    """A JAX block param tree drawn with numpy at the scale of
    ``tests/test_window_attention.py``, MLP included, nonzero biases."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return {
        "norm1": {"weight": 1.0 + n(c, s=0.1), "bias": n(c, s=0.05)},
        "attn": {
            "qkv": {"weight": n(c, 3 * c, s=0.05), "bias": n(3 * c, s=0.02)},
            "proj": {"weight": n(c, c, s=0.05), "bias": n(c, s=0.02)},
            "relative_position_bias_table": n((2 * win - 1) ** 2, heads,
                                              s=0.1),
        },
        "norm2": {"weight": 1.0 + n(c, s=0.1), "bias": n(c, s=0.05)},
        "mlp": {"fc1": {"weight": n(c, hidden, s=0.05),
                        "bias": n(hidden, s=0.02)},
                "fc2": {"weight": n(hidden, c, s=0.05),
                        "bias": n(c, s=0.02)}},
    }


def torch_block(p):
    """The JAX block tree under the checkpoint's names, torch layouts."""
    def lin(q):
        return torch.from_numpy(q["weight"].T.copy()), torch.from_numpy(q["bias"])

    out = {}
    for name, q in (("attn.qkv", p["attn"]["qkv"]),
                    ("attn.proj", p["attn"]["proj"]),
                    ("mlp.fc1", p["mlp"]["fc1"]), ("mlp.fc2", p["mlp"]["fc2"])):
        out[f"{name}.weight"], out[f"{name}.bias"] = lin(q)
    for name in ("norm1", "norm2"):
        out[f"{name}.weight"] = torch.from_numpy(p[name]["weight"])
        out[f"{name}.bias"] = torch.from_numpy(p[name]["bias"])
    out["attn.relative_position_bias_table"] = torch.from_numpy(
        p["attn"]["relative_position_bias_table"])
    return out


def tables(p, shift, dtype=torch.float32, heads=HEADS, win=WIN):
    return wa.build_block_tables(torch_block(p), heads, win, shift, dtype)


def roll(x, s):
    return jnp.roll(x, (s, s), axis=(1, 2)) if s else x


def inputs(shape, seed):
    return np.random.default_rng(seed).normal(size=(*shape, C)).astype(
        np.float32)


@pytest.mark.parametrize("shift", [0, WIN // 2])
def test_block_reference_matches_pallas_interpret(shift):
    """(1, 24, 32) holds all four mask types when shifted."""
    p = jax_block(0)
    x = inputs((1, 24, 32), 1)
    jt = build_attention_tables(p["attn"], HEADS, WIN, shift,
                                dtype=jnp.float32)
    want = roll(swin_block_fused(roll(jnp.asarray(x), -shift),
                                 jax.tree.map(jnp.asarray, p), jt, HEADS, WIN,
                                 shifted=bool(shift), interpret=True), shift)
    got = wa.swin_block(torch.from_numpy(x), tables(p, shift))
    # fp32, as tests/test_window_attention.py holds the kernel to XLA
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("shift", [0, WIN // 2])
def test_attention_reference_matches_pallas_interpret(shift):
    p = jax_block(2)
    x = inputs((1, 16, 32), 3)
    jt = build_attention_tables(p["attn"], HEADS, WIN, shift,
                                dtype=jnp.float32)
    want = roll(window_attention_fused(
        roll(jnp.asarray(x), -shift), jax.tree.map(jnp.asarray, p["norm1"]),
        jt, HEADS, WIN, shifted=bool(shift), interpret=True), shift)
    got = wa.window_attention(torch.from_numpy(x), tables(p, shift))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def xla_block(p, x, shift, dtype=jnp.float32):
    """The JAX package's XLA ``_swin_block`` on an NHWC map."""
    b, h, w, _ = x.shape
    bias_idx = jnp.asarray(sw.relative_position_index(WIN))
    mask = sw._shift_mask_device(h, w, WIN, WIN // 2) if shift else None
    pc = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
    tok = jnp.asarray(x, dtype).reshape(b, h * w, C)
    return np.asarray(sw._swin_block(tok, pc, h, w, HEADS, WIN, shift,
                                     bias_idx, mask).astype(jnp.float32)
                      ).reshape(x.shape)


@pytest.mark.parametrize("shift", [0, WIN // 2])
def test_odd_window_counts_match_xla_block(shift):
    """(2, 16, 24): 2×3 windows and a batch, where the JAX package falls
    back to XLA (its kernel needs an even window count per row)."""
    p = jax_block(4)
    x = inputs((2, 16, 24), 5)
    got = wa.swin_block(torch.from_numpy(x), tables(p, shift))
    np.testing.assert_allclose(got.numpy(), xla_block(p, x, shift),
                               atol=3e-5, rtol=3e-5)


def test_bf16_block_close_to_fp32_xla():
    p = jax_block(6)
    x = inputs((1, 16, 16), 7)
    want = xla_block(p, x, WIN // 2)
    got = wa.swin_block(torch.from_numpy(x).bfloat16(),
                        tables(p, WIN // 2, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # bf16 storage, f32 accumulation: activation-scale agreement, the
    # bound tests/test_window_attention.py sets for the TPU kernel
    assert np.abs(got.float().numpy() - want).max() < 0.05


@pytest.mark.parametrize("h, w, win", [(16, 16, 8), (8, 8, 8), (8, 24, 8),
                                       (40, 16, 8), (64, 64, 8), (12, 12, 4),
                                       (4, 20, 4)])
def test_mask_types_match_jax(h, w, win):
    """The port's four mask types, gathered by window position, equal
    JAX's device-assembled mask and its full construction."""
    full = sw._shift_mask(h, w, win, win // 2)
    dev = np.asarray(sw._shift_mask_device(h, w, win, win // 2))
    got = wa.shift_mask_types(win, win // 2)[wa.mask_type_index(h // win,
                                                                 w // win)]
    np.testing.assert_array_equal(got, dev)
    np.testing.assert_array_equal(got, full)
    np.testing.assert_array_equal(wa.shift_mask(h, w, win, win // 2), full)


@pytest.mark.parametrize("win", [4, 8])
def test_bias_and_index_match_jax(win):
    np.testing.assert_array_equal(wa.relative_position_index(win),
                                  sw.relative_position_index(win))
    p = jax_block(8, win=win)
    t = tables(p, 0, win=win)
    table = p["attn"]["relative_position_bias_table"]
    want = table[sw.relative_position_index(win)].transpose(2, 0, 1)
    np.testing.assert_array_equal(t["bias"].numpy(), want)


def test_tables_fold_query_scale_and_pad():
    p = jax_block(9)
    t = tables(p, WIN // 2)
    assert tuple(t["wqkv"].shape) == (180, 576)
    assert tuple(t["wo"].shape) == (192, 192)
    assert tuple(t["w1"].shape) == (180, 384)
    assert tuple(t["w2"].shape) == (360, 192)
    w = p["attn"]["qkv"]["weight"]                    # (C, 3C), JAX layout
    got = t["wqkv"].numpy().reshape(C, HEADS, 3, 32)
    for h in (0, 5):
        sl = slice(h * 30, (h + 1) * 30)
        np.testing.assert_allclose(got[:, h, 0, :30], w[:, sl] * 30 ** -0.5,
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[:, h, 1, :30], w[:, C + h * 30:
                                                           C + (h + 1) * 30])
        assert not got[:, h, :, 30:].any()
    assert not t["wo"][:, 180:].any() and not t["w1"][:, 360:].any()
    # masks: −100 / 0, zero when unshifted
    assert set(np.unique(t["masks"].numpy())) == {-100.0, 0.0}
    assert not tables(p, 0)["masks"].any()


def test_cpu_wrappers_take_plain_path():
    p = jax_block(10)
    x = torch.from_numpy(inputs((1, 8, 16), 11))
    t = tables(p, WIN // 2)
    before = dict(wa.LAUNCHES)
    assert torch.equal(wa.swin_block(x, t), wa.swin_block_reference(x, t))
    assert torch.equal(wa.window_attention(x, t),
                       wa.window_attention_reference(x, t))
    assert wa.LAUNCHES == before == {"swin_block": 0, "window_attention": 0}


def test_wrappers_refuse_other_devices():
    t = wa.tables_to(tables(jax_block(12), 0), "meta")
    x = torch.empty(1, 8, 8, C, device="meta")
    for fn in (wa.swin_block, wa.window_attention):
        with pytest.raises(RuntimeError, match="unsupported device"):
            fn(x, t)


def test_kernel_check_refuses_other_configs():
    """The launch path checks the configuration before it builds or
    launches anything."""
    p = jax_block(13, c=12, heads=2, win=4, hidden=24)
    t = wa.build_block_tables(torch_block(p), 2, 4, 0, torch.float32)
    with pytest.raises(ValueError, match="built for"):
        wa._check("swin_block", torch.empty(1, 8, 8, 12), t)
    t = tables(jax_block(14), 0)
    with pytest.raises(ValueError, match="multiples of 8"):
        wa._check("swin_block", torch.empty(1, 12, 8, C), t)
    with pytest.raises(TypeError, match="tables built for"):
        wa._check("swin_block", torch.empty(1, 8, 8, C, dtype=torch.bfloat16),
                  t)
