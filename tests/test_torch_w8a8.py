"""Full W8A8 in the port (``ops/rdb.py::rdb_w8a8`` and its plain version,
``models/rrdbnet_int8.py::rrdbnet_apply_int8(mode="full")``) and the
packed prefix layout (``models/rrdbnet.py::packed_prefix_kernels``)
against the JAX package's ``s2sr_tpu/models/rrdbnet.py`` and
``rrdbnet_int8.py``, on the CPU.

On the CPU the wrapper runs its plain version; ``rdb_w8a8_kernel``'s
indexing (int8 x and x1..x4 in swizzled shared memory, k32 slabs per
source, per-source dequantization at the stage's packed columns) is
emulated in numpy here, and the kernel itself is held against the plain
version on the card by ``chip_smoke.py`` (phase kernel).
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

from test_torch_int8 import (COUTS, TC_HALO, TC_TILE, port_model, rdb_tree,
                             to_jax, torch_p, unscaled_tree)
from test_torch_rdb import _swz
from torch_threads import one_torch_thread  # noqa: F401

# deq columns of stage s's output channel 0 in every source's kernel
COLS = (160, 128, 96, 64, 0)
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


# --- the full-W8A8 kernel's indexing, emulated in numpy ----------------------

def _w8_layout():
    """Byte offsets of x (64 bytes a pixel) and x1..x4 (32 bytes a pixel),
    all int8, in the kernel's shared memory (``w8_off(j)``)."""
    out, off = [], 0
    for j in range(5):
        side, ch = TC_TILE + 2 * (TC_HALO - j), SRC_CIN[j]
        out.append((off, side, ch))
        off += side * side * ch
    return out, off


def _unpack_w8_slabs(wq: np.ndarray) -> dict:
    """``{(stage, source): (slabs, 32, Cout)}`` read back from the packed
    B fragments as ``mma.m16n8k32`` reads them, in the order the kernel
    walks them (``w8_woff``): lane 4g + t's byte 8h + 4a + e of n16 block
    n is row 16a + 4t + e of column 16n + 8h + g."""
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    out, off = {}, 0
    for s, cout in enumerate(COUTS, start=1):
        for j in range(s):
            nslab = 9 * SRC_CIN[j] // 32
            n = nslab * 32 * cout
            pk = wq[off:off + n].reshape(nslab, cout // 16, 32, 16)
            mat = np.zeros((nslab, 32, cout), np.int64)
            for nb in range(cout // 16):
                for h in range(2):
                    for a in range(2):
                        for e in range(4):
                            mat[:, 16 * a + 4 * t + e, 16 * nb + 8 * h + g] = \
                                pk[:, nb, :, 8 * h + 4 * a + e]
            out[(s, j)] = mat
            off += n
    assert off == wq.size
    return out


def emulate_w8a8_rdb(x, wq, deq, qm, bias, mask=None):
    """``rdb_w8a8_kernel`` in numpy, tile by tile: x quantized on load into
    its swizzled 4-chunk pixels; per stage and source, every k32 slab's A
    gathered as ldmatrix.x4 returns it from the per-lane tap addresses
    (two slabs a tap for x, one for x1..x4), the int64 sums dequantized by
    that source's factors at the stage's columns and added to the float32
    accumulator; x1..x4 stored as int8 (bias, LeakyReLU, mask, then
    round(v·qm)) into swizzled 2-chunk pixels; the residual from x."""
    bsz, h, w, _ = x.shape
    layout, nbytes = _w8_layout()
    slabs = _unpack_w8_slabs(wq)
    deq_off = np.cumsum((0,) + SRC_COLS[:-1])
    lanes = np.arange(32)
    out = np.zeros_like(x)
    xq = np.clip(np.round(x * qm[0]), -127, 127).astype(np.int64)
    for b in range(bsz):
        for oy0 in range(0, h, TC_TILE):
            for ox0 in range(0, w, TC_TILE):
                mem8 = np.full(nbytes, -999, np.int64)
                r0 = layout[0][1]
                for p in range(r0 * r0):
                    gy, gx = oy0 - TC_HALO + p // r0, ox0 - TC_HALO + p % r0
                    inside = 0 <= gy < h and 0 <= gx < w
                    for c in range(8):
                        at = _swz(p * 4 + c // 2) * 16 + 8 * (c % 2)
                        mem8[at:at + 8] = xq[b, gy, gx, 8 * c:8 * c + 8] \
                            if inside else 0
                for s in range(1, 6):
                    rs = TC_TILE + 2 * (TC_HALO - s)
                    npix, cout = rs * rs, COUTS[s - 1]
                    for mt in range((npix + 15) // 16):
                        pix = np.minimum(mt * 16 + lanes % 16, npix - 1)
                        py, px = pix // rs, pix % rs
                        acc = np.zeros((16, cout), np.float32)
                        for j in range(s):
                            base, rj, cj = layout[j]
                            d = s - 1 - j
                            spj = (py + d) * rj + px + d
                            iacc = np.zeros((16, cout), np.int64)
                            k = 0
                            for tap in range(9):
                                toff = (tap // 3) * rj + tap % 3
                                for c in range(cj // 32):
                                    q = (spj + toff) * (cj // 16) + 2 * c + lanes // 16
                                    rows = mem8[base + (_swz(q) * 16)[:, None]
                                                + np.arange(16)]
                                    tile_a = np.concatenate([rows[:16], rows[16:]], 1)
                                    assert (tile_a != -999).all()
                                    iacc += tile_a @ slabs[(s, j)][k]
                                    k += 1
                            dq = deq[deq_off[j] + COLS[s - 1]:][:cout]
                            acc = acc + iacc.astype(np.float32) * dq
                        for r in range(16):
                            p = mt * 16 + r
                            if p >= npix:
                                continue
                            ry, rx = divmod(p, rs)
                            v = acc[r] + bias[(s - 1) * 32:(s - 1) * 32 + cout]
                            if s < 5:
                                hs = TC_HALO - s
                                gy, gx = oy0 - hs + ry, ox0 - hs + rx
                                ins = 0 <= gy < h and 0 <= gx < w
                                mk = np.float32((mask[b, gy, gx] if mask is not None
                                                 else 1.0) if ins else 0.0)
                                val = np.where(v >= 0, v, np.float32(0.2) * v) * mk
                                q8 = np.clip(np.round(val * qm[s]), -127, 127)
                                co = np.arange(cout)
                                addr = (layout[s][0] + _swz(p * 2 + co // 16) * 16
                                        + co % 16)
                                mem8[addr] = q8 if ins else 0
                            else:
                                gy, gx = oy0 + ry, ox0 + rx
                                if gy >= h or gx >= w:
                                    continue
                                mk = np.float32(mask[b, gy, gx] if mask is not None
                                                else 1.0)
                                out[b, gy, gx] = (v * np.float32(0.2)
                                                  + x[b, gy, gx]) * mk
    return out


@pytest.mark.parametrize("shape, masked", [((1, 16, 16), False),
                                           ((1, 18, 21), True)])
def test_w8a8_kernel_emulation_matches_reference(shape, masked):
    """The kernel's indexing (x and x1..x4 in int8 in swizzled shared
    memory, per-lane ldmatrix tap addresses for k32 slabs of each source,
    the five-kernel fragment packer, each source's deq at the stage's
    packed columns, x1..x4 quantized with their own qm, the residual from
    x), emulated on one 16² tile and on a ragged masked image of 2×2
    tiles in float32, gives the float32 plain version within 1e-6 of max
    |out| (the same sums in the same order: every int8 product is exact,
    each dequantization a product and a sum rounded once)."""
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
    got = emulate_w8a8_rdb(x, pk.wq.numpy().astype(np.int64), pk.deq.numpy(),
                           pk.qm.numpy(), pk.b.numpy(), mask)
    want = rdb_mod.rdb_w8a8_reference(
        torch.from_numpy(x), qp,
        None if mask is None else torch.from_numpy(mask)).numpy()
    assert np.abs(want - x).max() > 0.3
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_w8a8_fragments_roundtrip_and_layout():
    """The five-kernel fragment index is a permutation (every weight once,
    an exact round trip), puts a weight where m16n8k32 reads it, and a
    stack of blocks packs as each block alone; deq, qm and the biases
    concatenate in source order."""
    idx = rdb_mod.fragment_index_w8a8()
    total = sum(9 * c * n for c, n in zip(SRC_CIN, SRC_COLS))
    assert sorted(idx.tolist()) == list(range(total))
    gen = torch.Generator().manual_seed(35)
    w8 = tuple(torch.randint(-127, 128, (2, 3, 3, c, n), generator=gen,
                             dtype=torch.int8)
               for c, n in zip(SRC_CIN, SRC_COLS))
    qp = {"w8": w8, "deq": tuple(torch.rand(2, n, generator=gen)
                                 for n in SRC_COLS),
          "qm": torch.rand(2, 5, generator=gen),
          "b": tuple(torch.rand(2, n, generator=gen) for n in COUTS)}
    pk = rdb_mod.pack_rdb_w8a8(qp)
    flat = torch.cat([w.reshape(2, -1) for w in w8], -1)
    back = torch.empty_like(flat)
    back[:, idx] = pk.wq
    assert torch.equal(back, flat)
    one = rdb_mod.pack_rdb_w8a8({k: (tuple(t[1] for t in v)
                                     if isinstance(v, tuple) else v[1])
                                 for k, v in qp.items()})
    for a, b in zip(pk.block(1), one):
        assert torch.equal(a, b)
    assert torch.equal(one.deq, torch.cat([d[1] for d in qp["deq"]]))
    assert one.deq.numel() == 640 and one.b.numel() == 192
    # stage 2 reads x1's packed columns 128..159; its first slab follows
    # stage 1's 18 slabs of x and stage 2's 18 of x (2 n16 blocks of 32
    # lanes × 16 bytes each); lane 4g + t's bytes 8h + 4a + e are row
    # 16a + 4t + e of column 128 + 8h + g
    g, t = 6, 1
    at = 2 * 18 * 2 * 32 * 16 + (4 * g + t) * 16
    mat = w8[1][1].reshape(9 * 32, 160)
    want = [int(mat[16 * a + 4 * t + e, 128 + 8 * h + g])
            for h in (0, 1) for a in (0, 1) for e in range(4)]
    assert one.wq[at:at + 16].tolist() == want
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
