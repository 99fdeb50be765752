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
from torch_threads import one_torch_thread  # noqa: F401


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


# --- rdb_tc_kernel's indexing (the ladder's v4_mma), emulated in numpy -----

TC_TILE, TC_HALO, TC_WARPS = 16, 5, 8


def _swz(q):
    """The kernel's chunk swizzle: 16-byte chunk q stored at q ^ ((q >> 3)
    & 7) in its low three bits."""
    return q ^ ((q >> 3) & 7)


def _tc_layout():
    """Per source j (0 = x, 1..4 = x1..x4): (byte offset, region side,
    channels), as ``tc_off`` / ``tc_side`` lay them out."""
    out, off = [], 0
    for j in range(5):
        side, ch = TC_TILE + 2 * (TC_HALO - j), 64 if j == 0 else 32
        out.append((off, side, ch))
        off += side * side * ch * 2
    return out, off


def _unpack_b_slabs(wf: np.ndarray, cin: int, cout: int) -> np.ndarray:
    """A stage's B fragments (``[K/16][Cout/16][lane][8]``) read back as the
    mma reads them: lane 4g + t's uint4 of n16 block n gives, for n8 tile
    2n + h, b0 = rows 2t, 2t+1 and b1 = rows 2t+8, 2t+9 of column g."""
    pk = wf.reshape(9 * cin // 16, cout // 16, 32, 8)
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    out = np.zeros((9 * cin // 16, 16, cout), np.float32)
    for n in range(cout // 16):
        for h in range(2):
            for a in range(2):
                for e in range(2):
                    out[:, 2 * t + e + 8 * a, 16 * n + 8 * h + g] = \
                        pk[:, n, :, 4 * h + 2 * a + e]
    return out


def emulate_tc_rdb(x, wf, bias, mask=None):
    """``rdb_tc_kernel`` in float32 numpy, tile by tile: the input halo
    written at swizzled chunks, every k16 slab's A gathered as ldmatrix.x4
    returns it from the per-lane tap addresses, B from the fragments, and
    x1..x4 stored back through the swizzled addresses (in float32, so the
    result is the fp32 RDB)."""
    bsz, h, w, _ = x.shape
    layout, nbytes = _tc_layout()
    cins, couts = (64, 96, 128, 160, 192), (32, 32, 32, 32, 64)
    slabs, off = [], 0
    for cin, cout in zip(cins, couts):
        n = 9 * cin * cout
        slabs.append(_unpack_b_slabs(wf[off:off + n], cin, cout))
        off += n
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    out = np.zeros_like(x)
    for b in range(bsz):
        for oy0 in range(0, h, TC_TILE):
            for ox0 in range(0, w, TC_TILE):
                mem = np.full(nbytes // 2, np.nan, np.float32)
                r0 = layout[0][1]
                for p in range(r0 * r0):
                    gy, gx = oy0 - TC_HALO + p // r0, ox0 - TC_HALO + p % r0
                    inside = 0 <= gy < h and 0 <= gx < w
                    for c in range(8):
                        at = _swz(p * 8 + c) * 8
                        mem[at:at + 8] = x[b, gy, gx, 8 * c:8 * c + 8] \
                            if inside else 0
                for s in range(1, 6):
                    rs = TC_TILE + 2 * (TC_HALO - s)
                    npix, cout = rs * rs, couts[s - 1]
                    for mt in range((npix + 15) // 16):
                        tile_d = np.zeros((16, cout), np.float32)
                        pix = np.minimum(mt * 16 + lanes % 16, npix - 1)
                        py, px = pix // rs, pix % rs
                        k = 0
                        for j in range(s):
                            base, rj, cj = layout[j]
                            sp0 = (py + s - 1 - j) * rj + px + s - 1 - j
                            for tap in range(9):
                                toff = (tap // 3) * rj + tap % 3
                                for c in range(cj // 16):
                                    q = (sp0 + toff) * (cj // 8) + 2 * c + lanes // 16
                                    addr = base + _swz(q) * 16
                                    rows = mem[(addr // 2)[:, None] + np.arange(8)]
                                    # lane L: row L % 16, columns 8(L // 16)..
                                    tile_a = np.concatenate([rows[:16], rows[16:]], 1)
                                    tile_d += tile_a @ slabs[s - 1][k]
                                    k += 1
                        for hh in range(2):
                            p = mt * 16 + g + 8 * hh
                            for kk in range(cout // 8):
                                for e in range(2):
                                    co = 8 * kk + 2 * t + e
                                    v = tile_d[g + 8 * hh, co] + bias[(s - 1) * 32 + co]
                                    for ln in range(32):
                                        if p[ln] >= npix:
                                            continue
                                        ry, rx = divmod(int(p[ln]), rs)
                                        if s < 5:
                                            hs = TC_HALO - s
                                            gy, gx = oy0 - hs + ry, ox0 - hs + rx
                                            ins = 0 <= gy < h and 0 <= gx < w
                                            mk = (mask[b, gy, gx] if mask is not None
                                                  else 1.0) if ins else 0.0
                                            val = v[ln] if v[ln] >= 0 else 0.2 * v[ln]
                                            addr = (layout[s][0] + _swz(int(p[ln]) * 4 + kk) * 16
                                                    + 4 * int(t[ln]) + 2 * e)
                                            mem[addr // 2] = val * mk if ins else 0.0
                                        else:
                                            gy, gx = oy0 + ry, ox0 + rx
                                            if gy >= h or gx >= w:
                                                continue
                                            xp = (ry + TC_HALO) * r0 + rx + TC_HALO
                                            xin = mem[(_swz(xp * 8 + kk) * 16
                                                       + 4 * int(t[ln]) + 2 * e) // 2]
                                            mk = mask[b, gy, gx] if mask is not None else 1.0
                                            out[b, gy, gx, co[ln]] = (v[ln] * 0.2 + xin) * mk
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_tc_kernel_emulation_matches_reference(rdb_params, masked):
    """The bf16 kernel's indexing (swizzled pixel-major buffers, per-lane
    ldmatrix tap addresses, the B-fragment packer, the epilogue stores),
    emulated in float32 on a 2×2-tile image, gives the fp32 RDB."""
    x = np.random.default_rng(4).normal(size=(1, 18, 21, 64)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((1, 18, 21), np.float32)
        mask[:, :13, :17] = 1
        x = x * mask[..., None]
    w, b = torch_weights(rdb_params)
    wf = w[rdb_mod.fragment_index()].numpy()
    got = emulate_tc_rdb(x, wf, b.numpy(), mask)
    want = rdb_reference(torch.from_numpy(x), w, b,
                         None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_fragment_index_is_a_permutation():
    idx = rdb_mod.fragment_index()
    assert sorted(idx.tolist()) == list(range(idx.numel()))
    # stage 1, slab 0 (x, tap 0, channels 0..15), lane 4g + t of n16
    # block 0: rows 2t, 2t+1, 2t+8, 2t+9 of column g, then of column 8 + g
    g, t = 3, 2
    want = [(r * 32 + col) for col in (g, 8 + g)
            for r in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
    assert idx[(0 * 2 + 0) * 256 + (4 * g + t) * 8:][:8].tolist() == want
