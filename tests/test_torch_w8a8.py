"""Full W8A8 in the port (``ops/rdb.py::rdb_w8a8`` and its plain version,
``models/rrdbnet_int8.py::rrdbnet_apply_int8(mode="full")``) and the
packed prefix layout (``models/rrdbnet.py::packed_prefix_kernels``)
against the JAX package's ``s2sr_tpu/models/rrdbnet.py`` and
``rrdbnet_int8.py``, on the CPU.

On the CPU the wrapper runs its plain version; ``rdb_w8a8_kernel``'s
data movement (int8 x and x1..x4 in swizzled shared memory, 64-row
warpgroup tiles, the s8 B slabs streamed through the ring and read
through the wgmma descriptor's swizzle, per-source dequantization at the
stage's packed columns) is emulated in numpy here
(``test_torch_int8.py::emulate_wg_rdb``), and the kernel itself is held
against the plain version on the card by ``chip_smoke.py`` (phase
kernel).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.models import rrdbnet as jr
from s2sr_tpu.models import rrdbnet_int8 as jq
from s2sr_tpu_torch.models import rrdbnet_int8 as tq
from s2sr_tpu_torch.models.rrdbnet import packed_prefix_kernels, rrdbnet_bands
from s2sr_tpu_torch.ops import rdb as rdb_mod
from s2sr_tpu_torch.parallel import spatial

from test_torch_int8 import (COUTS, emulate_wg_rdb, port_model, rdb_tree,
                             to_jax, torch_p, unscaled_tree, wg_macs_per_tile)
from torch_threads import one_torch_thread  # noqa: F401

SRC_CIN = (64, 32, 32, 32, 32)
SRC_COLS = (192, 160, 128, 96, 64)


def w8a8_qp(p, x):
    """One RDB quantized as ``quantize_body`` does, with the activation
    scales a float32 calibration pass on ``x`` gives (max |input| of each
    conv / 127), as torch tensors."""
    _, maxes = tq._rdb_stats(torch.from_numpy(x), torch_p(p))
    s_act = torch.clamp(maxes, min=1e-12) / 127.0
    w8, deq = zip(*(tq._quantize_kernel(w)
                    for w in tq._pack_rdb_kernels(torch_p(p))))
    return {"w8": tuple(w8),
            "deq": tuple((d * s_act[k]).float() for k, d in enumerate(deq)),
            "qm": (1.0 / s_act).float(),
            "b": tuple(torch.from_numpy(p[f"conv{k}"]["bias"])
                       for k in range(1, 6))}


def jax_qp(qp):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), qp)


def test_packed_prefix_kernels_bit_equal_jax():
    """The one definition of the layout equals JAX's, kernel by kernel;
    the OIHW and stacked views that ``rdb_reference`` and the trainer
    read are the same slices."""
    p = rdb_tree(30)
    want = jr.packed_prefix_kernels(to_jax(p))
    got = packed_prefix_kernels(torch_p(p))
    assert [tuple(g.shape) for g in got] == [(3, 3, 64, 192), (3, 3, 32, 160),
                                             (3, 3, 32, 128), (3, 3, 32, 96),
                                             (3, 3, 32, 64)]
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    oihw = [torch_p(p)[f"conv{k}"]["kernel"].permute(3, 2, 0, 1)
            for k in range(1, 6)]
    for g, o in zip(got, rdb_mod.prefix_kernels(oihw, 1, 0)):
        assert torch.equal(g.permute(3, 2, 0, 1), o)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rdb_w8a8_reference_matches_jax(dtype, masked):
    """``rdb_w8a8_reference`` against JAX's ``_rdb_packed_i8`` on the same
    x and quantized block: float32 within 1e-4 of max |out − x| (an ulp of
    difference in a conv input can move round(x·qm) across a half step,
    one quantization step at that pixel), bf16 within 0.05 of it (the
    frameworks round their bf16 sums in other places), as the mixed
    block's test bounds it."""
    p = rdb_tree(31)
    rng = np.random.default_rng(32)
    x = rng.normal(0, 0.5, (2, 12, 17, 64)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((2, 12, 17, 1), np.float32)
        mask[0, :9, :13] = mask[1, :12, :8] = 1
        x = x * mask
    qp = w8a8_qp(p, x)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jq._rdb_packed_i8(
        jnp.asarray(x, jdt), jax_qp(qp), jdt,
        None if mask is None else jnp.asarray(mask, jdt))).astype(np.float32)
    got = rdb_mod.rdb_w8a8_reference(
        torch.from_numpy(x).to(tdt), qp,
        None if mask is None else torch.from_numpy(mask)).float().numpy()
    change = np.abs(want - x).max()
    assert change > 0.3                                  # the block works
    tol = 1e-4 if dtype == "float32" else 0.05
    assert np.abs(got - want).max() <= tol * change


# --- the full-W8A8 kernel's data movement, emulated in numpy -----------------
# (test_torch_int8.py::emulate_wg_rdb, the all-s8 instance)

@pytest.mark.parametrize("shape, masked", [((1, 16, 16), False),
                                           ((1, 18, 21), True)])
def test_w8a8_kernel_emulation_matches_reference(shape, masked):
    """The kernel's data movement (x and x1..x4 in int8 in swizzled shared
    memory; 64-row warpgroup tiles with per-lane ldmatrix tap addresses for
    each source's k-steps; the five kernels' s8 slabs from the packer,
    streamed through the ring in slab order and read through the
    descriptor's swizzle; each source's deq at the stage's packed columns;
    x1..x4 quantized with their own qm; the residual from x), emulated on
    one 16² tile and on a ragged masked image of 2×2 tiles in float32,
    gives the float32 plain version within 1e-6 of max |out| (the same
    sums in the same order: every int8 product is exact, each
    dequantization a product and a sum rounded once), executing the
    kernel's count of multiply-adds."""
    p = rdb_tree(33)
    rng = np.random.default_rng(34)
    x = rng.normal(size=(*shape, 64)).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()   # the kernel's input
    mask = None
    if masked:
        mask = np.zeros(shape, np.float32)
        mask[:, :13, :17] = 1
        x = x * mask[..., None]
    qp = w8a8_qp(p, x)
    pk = rdb_mod.pack_rdb_w8a8(qp)
    got, macs = emulate_wg_rdb(x, (pk.wq.view(torch.uint8).numpy(),),
                               pk.deq.numpy(), pk.qm.numpy(), pk.b.numpy(),
                               True, mask)
    assert macs == wg_macs_per_tile()
    want = rdb_mod.rdb_w8a8_reference(
        torch.from_numpy(x), qp,
        None if mask is None else torch.from_numpy(mask)).numpy()
    assert np.abs(want - x).max() > 0.3
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_w8a8_fragments_roundtrip_and_layout():
    """The five-kernel slab index is a permutation (every weight once, an
    exact round trip, the rest padding), puts a weight where wgmma's
    descriptor reads it, and a stack of blocks packs as each block alone;
    deq, qm and the biases concatenate in source order."""
    idx = rdb_mod.slab_index_w8a8()
    total = sum(9 * c * n for c, n in zip(SRC_CIN, SRC_COLS))
    real = idx[idx >= 0]
    assert sorted(real.tolist()) == list(range(total))
    gen = torch.Generator().manual_seed(35)
    w8 = tuple(torch.randint(-127, 128, (2, 3, 3, c, n), generator=gen,
                             dtype=torch.int8)
               for c, n in zip(SRC_CIN, SRC_COLS))
    qp = {"w8": w8, "deq": tuple(torch.rand(2, n, generator=gen)
                                 for n in SRC_COLS),
          "qm": torch.rand(2, 5, generator=gen),
          "b": tuple(torch.rand(2, n, generator=gen) for n in COUTS)}
    pk = rdb_mod.pack_rdb_w8a8(qp)
    assert pk.wq.shape == (2, idx.numel()) and (pk.wq[:, idx < 0] == 0).all()
    flat = torch.cat([w.reshape(2, -1) for w in w8], -1)
    back = torch.empty_like(flat)
    back[:, real] = pk.wq[:, idx >= 0]
    assert torch.equal(back, flat)
    one = rdb_mod.pack_rdb_w8a8({k: (tuple(t[1] for t in v)
                                     if isinstance(v, tuple) else v[1])
                                 for k, v in qp.items()})
    for a, b in zip(pk.block(1), one):
        assert torch.equal(a, b)
    assert torch.equal(one.deq, torch.cat([d[1] for d in qp["deq"]]))
    assert one.deq.numel() == 640 and one.b.numel() == 192
    # stage 2's part follows stage 1's 5 slabs of 32 rows: x's 18 k-steps,
    # then x1's 9 (one a tap); its k-step 20 is x1's tap 2 (32 channels),
    # in slab 5 at k-step 0, reading x1's packed columns 128..159. Output
    # channel n's byte kb is logical chunk kb // 16 of row n, stored at
    # chunk (kb // 16) ^ (n % 8)
    n, kb = 6, 21
    at = (5 + 5) * 32 * 128 + n * 128 + ((kb // 16) ^ (n % 8)) * 16 + kb % 16
    assert int(one.wq[at]) == int(w8[1][1, 0, 2, kb, 128 + n])
    with pytest.raises(ValueError, match="int8"):
        rdb_mod.pack_rdb_w8a8(dict(qp, w8=(w8[0].float(),) + w8[1:]))


def test_rdb_w8a8_wrapper_cpu_plain_and_refuses_other_devices():
    """On the CPU the wrapper is its plain version and counts no launch;
    another device raises; operands that are not the kernel's are
    refused when packed."""
    p = rdb_tree(36)
    x = np.random.default_rng(37).normal(0, 0.5, (1, 9, 10, 64)).astype(np.float32)
    qp = w8a8_qp(p, x)
    xt = torch.from_numpy(x).bfloat16()
    n0 = rdb_mod.LAUNCHES_W8A8
    got = rdb_mod.rdb_w8a8(xt, qp)
    assert torch.equal(got, rdb_mod.rdb_w8a8_reference(xt, qp))
    assert got.dtype == torch.bfloat16 and rdb_mod.LAUNCHES_W8A8 == n0
    with pytest.raises(RuntimeError, match="unsupported device"):
        rdb_mod.rdb_w8a8(xt.to("meta"), qp)
    with pytest.raises(ValueError, match=r"w8\[4\]"):
        rdb_mod.pack_rdb_w8a8(dict(qp, w8=qp["w8"][:4] + (qp["w8"][3],)))


def test_conv_i8_gemm_equals_float_form():
    """The int8 GEMM (``torch._int_mm`` on im2col rows, the card's form)
    equals the float32 conv of the integer values (the CPU's form) bit for
    bit: at the extremes, and on an image of fewer than 32 pixels (rows
    padded for the GEMM)."""
    rng = np.random.default_rng(38)
    for shape in ((2, 64, 9, 11), (1, 32, 3, 4)):
        x8 = rng.integers(-127, 128, shape).astype(np.float32)
        x8[0, :, :3, :3] = 127
        w8 = rng.integers(-127, 128, (96, shape[1], 3, 3)).astype(np.int8)
        w8[0] = 127
        xt, wt = torch.from_numpy(x8), torch.from_numpy(w8)
        gemm = rdb_mod.conv_i8_gemm(xt, wt)
        assert gemm.dtype == torch.int32
        assert torch.equal(gemm.float(), rdb_mod.conv_i8_int(xt, wt))
    assert int(gemm.abs().max()) <= 127 * 127 * 9 * 32


def test_full_w8a8_band_forward_equals_one_device():
    """``rrdbnet_bands`` takes full mode through ``int8_rdb_fn`` as it
    takes mixed: two bands of H (5-row extended bands around every
    block) give the one-band forward bit for bit (float32, oneDNN off);
    quant(0) = 0 keeps the bands' zero border exact."""
    model = port_model(unscaled_tree(39), torch.float32)
    gen = torch.Generator().manual_seed(40)
    qbody = tq.quantize_rrdbnet(model, torch.rand(1, 16, 16, 3, generator=gen),
                                mode="full")
    x = torch.rand(1, 26, 20, 3, generator=gen)
    with torch.backends.mkldnn.flags(enabled=False):
        one = tq.rrdbnet_apply_int8(model, qbody, x, mode="full")
        parts = spatial.split(x, spatial.band_bounds(26, 2), ["cpu"] * 2)
        bands = rrdbnet_bands([model, model], parts,
                              rdb_fn=tq.int8_rdb_fn(model, qbody, "full"))
    assert torch.equal(spatial.gather(bands, "cpu"), one)
