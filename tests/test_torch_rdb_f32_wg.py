"""The float32 RDB kernel, ``csrc/rdb.cu::rdb_f32_wg_kernel`` (split TF32 on
``wgmma``, B streamed through a ring of bulk copies), emulated in numpy on
the CPU.

The emulation (:func:`emulate_f32_rdb`) follows the kernel's arithmetic and
data movement: the input tile in float32 at ``rot_f32<16>`` chunks, x1..x4
at ``rot_f32<8>``; each stage's 64-row M tiles (warpgroup w's tiles w, w + 2
over all of Cout, stage 3's fourth all padding; in stage 5 its one tile
over half of Cout), rows past the region loading its last pixel; A gathered as ``ldmatrix.x4``
returns it from the per-lane tap addresses and read back through the TF32
fragment layout, split into hi and lo by ``cvt.rna``; B read from the
ring's slot through the 128-byte swizzle of the ``wgmma`` descriptor (hi at
the group's unit, lo 4 KB into it or in the next unit); the ring filled by
whole 8 KB units from :func:`pack_rdb_f32_wg`'s stream in order, a slot
refilled with unit g + 7 once unit g is released, every read checked
against the unit the slot holds; the three products of each k-step (8
channels of one tap) in the kernel's order into the partial sums of its
step (two k-steps, four in stage 5; each product's sum of 8 added to them
as the tensor cores add it: rounded once, or with ``truncate`` toward
zero), a step's partials added to the float32 sums, rounded; the
accumulators mapped to pixels and
channels through ``wgmma``'s D fragment; the residual read from the
resident copy of x. The kernel itself is held against ``rdb_reference`` on
the card by ``chip_smoke.py`` (phase kernel).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.models.rrdbnet import _rdb_packed
from s2sr_tpu_torch.ops import rdb as rdb_mod
from s2sr_tpu_torch.ops.rdb import pack_rdb_weights, rdb_reference
from torch_threads import one_torch_thread  # noqa: F401

RDB_CU = Path(rdb_mod.__file__).resolve().parent.parent / "csrc" / "rdb.cu"
TILE, HALO = 8, 5
CINS, COUTS = (64, 96, 128, 160, 192), (32, 32, 32, 32, 64)
WGS, KQ, UNIT = 2, 4, 8192
NBUF = rdb_mod.F32_RING_SLOTS
SMEM_LIMIT = 232448
F32 = np.float32


@pytest.fixture(scope="module")
def rdb_params():
    """One RDB at the kernel's widths: the model's init (normal ·
    sqrt(2 / fan_in) · 0.1) with every kernel ×8, so x1..x4 move the
    output, and nonzero biases."""
    rng = np.random.default_rng(31)
    p = {}
    for k in range(1, 6):
        cin, cout = CINS[k - 1], COUTS[k - 1]
        p[f"conv{k}"] = {
            "kernel": (rng.normal(size=(3, 3, cin, cout))
                       * np.sqrt(2.0 / (9 * cin)) * 0.1 * 8).astype(F32),
            "bias": rng.normal(0, 0.05, cout).astype(F32)}
    return p


def torch_weights(p):
    kernels = [torch.from_numpy(np.transpose(p[f"conv{k}"]["kernel"],
                                             (3, 2, 0, 1)).copy())
               for k in range(1, 6)]
    biases = [torch.from_numpy(p[f"conv{k}"]["bias"]) for k in range(1, 6)]
    return pack_rdb_weights(kernels, biases, torch.float32)


def rna(a):
    """float32 to TF32 as ``cvt.rna.tf32.f32``: to nearest, ties away from
    zero, at 10 stored mantissa bits (the low 13 bits cleared)."""
    bits = np.ascontiguousarray(a, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(a):
    """(hi, lo): hi = rna(a), lo = rna(a − hi) (the difference exact)."""
    hi = rna(a)
    return hi, rna(np.asarray(a, F32) - hi)


def side(j):
    """Region side of source j (x: j = 0) and of stage j's output."""
    return TILE + 2 * (HALO - j)


def src_off(j):
    """Byte offset of source j after the ring (float32, pixel-major)."""
    return sum(side(k) ** 2 * (64 if k == 0 else 32) * 4 for k in range(j))


def n_tiles(s):
    return -(-side(s) ** 2 // 64)


def is_split(s):
    """Stages of one M tile (stage 5): both warpgroups run it over half of
    Cout."""
    return n_tiles(s) < WGS


def wg_mt(s):
    """M tiles a warpgroup runs in stage s (``f32_mt``)."""
    return n_tiles(s) if is_split(s) else -(-n_tiles(s) // WGS)


def steps(s):
    """k-steps of stage s: x's 72, x1..x_{s-1}'s 36 each."""
    return 72 + 36 * (s - 1)


def step_len(s):
    """k-steps a step of the kernel's pipeline takes (``f32_sl``)."""
    return 4 if s == 5 else 2


def upg(s):
    """8 KB units a group of KQ k-steps takes: hi and lo of 32 rows in
    one, of 64 rows (stage 5) in two."""
    return COUTS[s - 1] // 32


def unit0(s):
    return sum(steps(k) // KQ * upg(k) for k in range(1, s))


def macs_per_tile():
    """``f32_macs_per_tile``: each stage's executed 64-row tiles (stage 3's
    padded fourth included), 9 Cin × Cout."""
    return sum((1 if is_split(s) else WGS) * wg_mt(s) * 64 * 9 * CINS[s - 1]
               * COUTS[s - 1] for s in range(1, 6))


def rot(p, c, cq):
    """``rot_f32<CQ>``: byte offset of 16-byte chunk c of pixel p in a
    source of cq (8 or 16) chunks a pixel, chunk c at bank group (p + c) % 8."""
    return (p * cq + (c & ~7)) * 16 + ((p + c) % 8) * 16


class Ring:
    """The B ring: NBUF slots of one 8 KB unit, the first NBUF units
    copied in at the start; ``release(g)``: every consumer has read unit g,
    and the producer copies unit g + NBUF into its slot. A copy over a unit
    not yet released, or a read of a slot that holds another unit, fails."""

    def __init__(self, stream):
        self.mem = np.zeros(NBUF * UNIT // 4, F32)
        self.tag = [-1] * NBUF
        self.stream, self.released = stream, []
        self.n = len(stream) * 4 // UNIT
        for g in range(min(NBUF, self.n)):
            self.issue(g)

    def issue(self, g):
        slot = g % NBUF
        assert self.tag[slot] < 0 or self.tag[slot] in self.released, \
            "a unit overwritten before it was read"
        n = UNIT // 4
        self.mem[slot * n:(slot + 1) * n] = self.stream[g * n:(g + 1) * n]
        self.tag[slot] = g

    def release(self, g):
        assert g == len(self.released), f"unit {g} released out of turn"
        self.released.append(g)
        if g + NBUF < self.n:
            self.issue(g + NBUF)

    def b(self, g, off, n):
        """The k-step at byte ``off`` into unit g's slot as wgmma reads it
        through the descriptor: (8, n) TF32 values."""
        assert self.tag[g % NBUF] == g, "the slot holds another unit"
        rows, kb = np.arange(n)[:, None], np.arange(0, 32, 4)[None, :]
        addr = (g % NBUF) * UNIT + off + (rows // 8) * 1024 + (rows % 8) * 128 + kb
        addr = addr ^ (((addr >> 7) & 7) << 4)
        return self.mem[addr // 4].T


def fragments(mem, base, pa, cc, cq):
    """A of one k-step, (blocks, rows, 8), as the kernel gets it: per warp
    (16 rows) one ``ldmatrix.x4`` whose lane l points at row l & 15 at
    chunk 2cc + (l >> 4); matrix i (the rows lanes 8i..8i+7 point at) lands
    in register i, thread l holding 32-bit word l % 4 of its row l // 4;
    read back through wgmma's TF32 A fragment: a0 (g, t), a1 (g + 8, t),
    a2 (g, t + 4), a3 (g + 8, t + 4)."""
    pw = pa.reshape(-1, 16)
    lanes = np.arange(32)
    addr = base + rot(pw[:, lanes & 15], 2 * cc + (lanes >> 4), cq)
    src_lane = 8 * np.arange(4)[:, None] + lanes[None, :] // 4
    regs = mem[:, (addr[:, src_lane] + 4 * (lanes % 4)) // 4]   # (nb, warps, 4, 32)
    g, t = lanes // 4, lanes % 4
    a = np.full((mem.shape[0], pw.shape[0], 16, 8), np.nan, F32)
    a[:, :, g, t] = regs[:, :, 0]
    a[:, :, g + 8, t] = regs[:, :, 1]
    a[:, :, g, t + 4] = regs[:, :, 2]
    a[:, :, g + 8, t + 4] = regs[:, :, 3]
    return a.reshape(mem.shape[0], -1, 8)


def rz(x):
    """float64 to float32 rounded toward zero."""
    y = x.astype(F32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], F32(0))
    return y


def wgmma(c, a, b, truncate):
    """One wgmma: c plus each output's sum of 8 TF32 products (exact),
    rounded once to float32: to nearest, or toward zero as the tensor
    cores round where they add (``truncate``)."""
    s = c.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)
    return rz(s) if truncate else s.astype(F32)


def d_fragment(acc, mt, nw):
    """The accumulators as the kernel's threads hold them: for tile m,
    warp q, lane (g, t) and i = 4k + 2h + e, row 16q + g + 8h and column
    8k + 2t + e of the tile. → (values (nb, mt, 4, 32, nw/2), tile row,
    column)."""
    i = np.arange(nw // 2)
    k, h, e = i // 4, (i // 2) % 2, i % 2
    lanes = np.arange(32)
    row = (16 * np.arange(4)[:, None, None] + (lanes // 4)[None, :, None]
           + 8 * h[None, None, :])                               # (4, 32, na)
    col = np.broadcast_to(8 * k + 2 * (lanes % 4)[:, None] + e, row.shape)
    m = np.arange(mt)[:, None, None, None]
    vals = acc[:, m * 64 + row[None], col[None]]
    return vals, row, col


def emulate_f32_rdb(x, stream, bias, mask=None, lo_products=True,
                    truncate=False, chained=False):
    """``rdb_f32_wg_kernel`` in numpy, every block of the image at once.
    ``lo_products`` False keeps only hi·hi (plain TF32); ``truncate``
    rounds each wgmma's sum toward zero; ``chained`` adds every product
    straight into the running sums (the design without partials). Returns
    the output and the multiply-adds (of each product) one block
    executes."""
    bsz, h, w, _ = x.shape
    blocks = np.array([(b, oy, ox) for b in range(bsz) for oy in range(0, h, TILE)
                       for ox in range(0, w, TILE)])
    nb = len(blocks)
    bb, oy0, ox0 = (blocks[:, i, None] for i in range(3))
    mem = np.full((nb, src_off(5) // 4), np.nan, F32)
    r0 = side(0)
    p0 = np.arange(r0 * r0)
    gy, gx = oy0 - HALO + p0 // r0, ox0 - HALO + p0 % r0
    ins = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    xt = np.zeros((nb, r0 * r0, 64), F32)
    xt[ins] = x[np.broadcast_to(bb, ins.shape)[ins], gy[ins], gx[ins]]
    co64 = np.arange(64)
    mem[:, (rot(p0[:, None], co64 // 4, 16) + 4 * (co64 % 4)) // 4] = xt
    ring = Ring(stream)
    out = np.zeros_like(x)
    macs = 0
    for s in range(1, 6):
        rs, cout = side(s), COUTS[s - 1]
        npix = rs * rs
        sp = is_split(s)
        mt = wg_mt(s)
        nw = cout // WGS if sp else cout
        u, u0, sl = upg(s), unit0(s), step_len(s)
        wgs = []
        for wg in range(WGS):
            tiles = [m if sp else wg + WGS * m for m in range(mt)]
            rows = (np.array(tiles)[:, None] * 64 + np.arange(64)).reshape(-1)
            pix = np.minimum(rows, npix - 1)
            wgs.append({"tiles": tiles, "col0": wg * nw if sp else 0,
                        "py": pix // rs, "px": pix % rs,
                        "acc": np.zeros((nb, rows.size, nw), F32)})
        for tt in range(steps(s)):
            j, kk = (0, tt) if tt < 72 else (1 + (tt - 72) // 36, (tt - 72) % 36)
            spt, cq = (8, 16) if j == 0 else (4, 8)
            tap, cc = divmod(kk, spt)
            d, rj = s - 1 - j, side(j)
            g, r = u0 + tt // KQ * u, tt % KQ
            for wg in wgs:
                pa = (wg["py"] + d + tap // 3) * rj + wg["px"] + d + tap % 3
                a = fragments(mem, src_off(j), pa, cc, cq)
                assert not np.isnan(a).any()
                ah, al = split(a)
                off = wg["col0"] * 128 + r * 32
                bh = ring.b(g, off, nw)
                bl = ring.b(g + 1, off, nw) if u == 2 else ring.b(g, UNIT // 2 + off, nw)
                acc = wg["acc"]
                if chained:
                    wg["part"] = acc
                elif tt % sl == 0:                    # the step's first: scale-d 0
                    wg["part"] = np.zeros_like(acc)
                terms = ([(al, bh), (ah, bl)] if lo_products else []) + [(ah, bh)]
                for a_, b_ in terms:
                    wg["part"][...] = wgmma(wg["part"], a_, b_, truncate)
                if not chained and tt % sl == sl - 1:
                    acc += wg["part"]                  # __fadd_rn
                macs += acc.shape[1] * 8 * nw
            # wgmma_wait<1>: the step before has completed
            if r == 0 and tt > 0:
                for q in range(u, 0, -1):
                    ring.release(g - q)
        for q in range(u, 0, -1):                      # the stage's last group
            ring.release(unit0(s + 1) - q)
        for wg_i, wg in enumerate(wgs):
            vals, row, col = d_fragment(wg["acc"], mt, nw)
            p = np.array(wg["tiles"])[:, None, None, None] * 64 + row[None]
            co = wg["col0"] + col[None]
            p, co = np.broadcast_to(p, vals.shape[1:]), np.broadcast_to(co, vals.shape[1:])
            v = vals + bias[(s - 1) * 32 + co]
            if s < 5:
                keep = p < npix
                pk, ck, vk = p[keep], co[keep], v[:, keep]
                hs = HALO - s
                gy, gx = oy0 - hs + pk // rs, ox0 - hs + pk % rs
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                mk = np.zeros(inside.shape, F32)
                mk[inside] = (mask[np.broadcast_to(bb, inside.shape)[inside],
                                   gy[inside], gx[inside]]
                              if mask is not None else 1.0)
                val = np.where(vk >= 0, vk, F32(0.2) * vk) * mk
                val[~inside] = 0.0
                mem[:, (src_off(s) + rot(pk, ck // 4, 8) + 4 * (ck % 4)) // 4] = val
            else:
                gy, gx = oy0 + p.reshape(-1) // rs, ox0 + p.reshape(-1) % rs
                keep = (gy < h) & (gx < w)
                xp = (p.reshape(-1) // rs + HALO) * r0 + p.reshape(-1) % rs + HALO
                cf = co.reshape(-1)
                xin = mem[:, (rot(xp, cf // 4, 16) + 4 * (cf % 4)) // 4]
                # (acc + b) * 0.2f + x as one FFMA, then the mask
                res = (v.reshape(nb, -1).astype(np.float64) * np.float64(F32(0.2))
                       + xin).astype(F32)
                bk = np.broadcast_to(bb, keep.shape)[keep]
                mk = mask[bk, gy[keep], gx[keep]] if mask is not None else F32(1.0)
                out[bk, gy[keep], gx[keep], np.broadcast_to(cf, keep.shape)[keep]] = \
                    res[keep] * mk
    assert ring.released == list(range(ring.n))             # each unit once
    return out, macs


def _image(shape, masked, seed):
    """float32 x (zero outside the mask's rectangle) and the mask."""
    x = np.random.default_rng(seed).normal(0, 0.5, (*shape, 64)).astype(F32)
    mask = None
    if masked:
        b, h, w = shape
        mask = np.zeros(shape, F32)
        mask[:, :h - 5, :w - 4] = 1
        x = x * mask[..., None]
    return x, mask


def _stream(w):
    """The packed stream's bytes as float32 values."""
    return rdb_mod.pack_rdb_f32_wg(w).numpy().view(F32)


def _rel(got, want, x):
    """max |got − want| over the block's largest change, max |want − x|."""
    change = np.abs(want - x).max()
    assert change > 0.1                        # the block moves x
    return np.abs(got - want).max() / change


@pytest.fixture(scope="module")
def emulated(rdb_params):
    """The emulation on a ragged 3×4-tile image, unmasked and masked, beside
    its inputs."""
    w, b = torch_weights(rdb_params)
    stream = _stream(w)
    runs = {}
    for masked in (False, True):
        x, mask = _image((1, 21, 30), masked, 32)
        got, macs = emulate_f32_rdb(x, stream, b.numpy(), mask)
        runs[masked] = (x, mask, got, macs)
    return w, b, stream, runs


@pytest.mark.parametrize("masked", [False, True])
def test_emulation_matches_float64_reference(emulated, masked):
    """Split TF32 keeps float32's accuracy: the emulated kernel within
    1e-5 of the block's change of ``rdb_reference`` in float64; each block
    executes the kernel's count of multiply-adds."""
    w, b, _, runs = emulated
    x, mask, got, macs = runs[masked]
    want = rdb_reference(torch.from_numpy(x).double(), w.double(), b.double(),
                         None if mask is None
                         else torch.from_numpy(mask).double()).numpy()
    assert _rel(got, want, x) <= 1e-5
    assert macs == macs_per_tile() == 34_209_792
    if masked:
        assert not got[:, 16:].any() and not got[:, :, 26:].any()


@pytest.mark.parametrize("masked", [False, True])
def test_emulation_matches_jax_rdb_packed(emulated, rdb_params, masked):
    """The emulation against the JAX package's ``_rdb_packed`` in float32
    (XLA's convolutions on the CPU), within 1e-5 of the block's change."""
    w, b, _, runs = emulated
    x, mask, got, _ = runs[masked]
    want = np.asarray(_rdb_packed(jnp.asarray(x), jax.tree.map(jnp.asarray, rdb_params),
                                  jnp.float32,
                                  None if mask is None else jnp.asarray(mask[..., None])))
    assert _rel(got, want, x) <= 1e-5


def test_plain_tf32_is_seen(emulated):
    """Without the lo products (plain TF32: hi·hi alone) the emulation lands
    above 1e-4 of the block's change from float64, so the checks at 1e-4
    and 1e-5 can tell TF32 from split TF32."""
    w, b, stream, runs = emulated
    x, _, _, _ = runs[False]
    got, _ = emulate_f32_rdb(x, stream, b.numpy(), lo_products=False)
    want = rdb_reference(torch.from_numpy(x).double(), w.double(),
                         b.double()).numpy()
    assert _rel(got, want, x) > 1e-4


def test_partials_hold_float32_accuracy_where_the_adds_truncate(emulated):
    """With every wgmma's sum rounded toward zero (the tensor cores'
    adds), the per-step partials (6 or 12 sums a chain) keep the error
    within 1e-5 of the block's change; adding every product straight into
    the running sums (648 truncated adds at stage 5) lands above it, as
    that design did on the card (1.6–1.7e-5)."""
    w, b, stream, _ = emulated
    x, _ = _image((1, 16, 16), False, 37)
    want = rdb_reference(torch.from_numpy(x).double(), w.double(),
                         b.double()).numpy()
    got, _ = emulate_f32_rdb(x, stream, b.numpy(), truncate=True)
    assert _rel(got, want, x) <= 1e-5
    chained, _ = emulate_f32_rdb(x, stream, b.numpy(), truncate=True,
                                 chained=True)
    assert _rel(chained, want, x) > 1e-5


def test_output_of_a_pixel_is_the_same_wherever_it_sits(emulated):
    """The bucket contract: a 13×11 image alone, and at (3, 5) of batch
    element 1 of a (2, 24, 25) canvas with a 0/1 mask on it (another tile
    offset, another block of another batch element), gives the same bits
    on every pixel."""
    _, b, stream, _ = emulated
    img = np.random.default_rng(33).normal(0, 0.5, (1, 13, 11, 64)).astype(F32)
    alone, _ = emulate_f32_rdb(img, stream, b.numpy())
    canvas = np.zeros((2, 24, 25, 64), F32)
    mask = np.zeros((2, 24, 25), F32)
    canvas[1, 3:16, 5:16] = img[0]
    mask[1, 3:16, 5:16] = 1
    canvas[0] = np.random.default_rng(34).normal(0, 0.5, (24, 25, 64))
    mask[0] = 1
    got, _ = emulate_f32_rdb(canvas, stream, b.numpy(), mask)
    assert np.array_equal(got[1, 3:16, 5:16], alone[0])
    assert not got[1, :3].any() and not got[1, :, :5].any()


def test_tf32_split_is_cvt_rna():
    """``tf32_split`` (the packer's) equals the numpy ``cvt.rna`` bit for
    bit: ties away from zero, carries into the exponent, both signs; hi has
    its low 13 bits clear, lo too, and hi + lo is within 2⁻²² of the
    value."""
    bits = np.array([0x3F800000, 0x3F801000, 0x3F803000, 0x3F802FFF,
                     0xBF801000, 0x3FFFF000, 0x00000000, 0x80000000,
                     0x3F7FFFFF, 0xC2C81234], np.uint32)
    v = np.concatenate([bits.view(F32),
                        np.random.default_rng(35).normal(0, 3, 4096).astype(F32)])
    hi, lo = rdb_mod.tf32_split(torch.from_numpy(v))
    nhi, nlo = split(v)
    assert np.array_equal(hi.numpy().view(np.uint32), nhi.view(np.uint32))
    assert np.array_equal(lo.numpy().view(np.uint32), nlo.view(np.uint32))
    assert list(nhi[:6].view(np.uint32)) == [0x3F800000, 0x3F802000, 0x3F804000,
                                             0x3F802000, 0xBF802000, 0x40000000]
    assert not (nhi.view(np.uint32) & 0x1FFF).any()
    assert not (nlo.view(np.uint32) & 0x1FFF).any()
    err = np.abs(nhi.astype(np.float64) + nlo - v) / np.maximum(np.abs(v), 1e-30)
    assert err.max() <= 2.0 ** -22


def test_stream_index_and_packer(rdb_params):
    """The stream is 234 units of 8 KB, every byte of every weight's hi
    and lo once, no padding; the packer equals the numpy split gathered by
    the index bit for bit; a value lands where the descriptor reads it."""
    idx = rdb_mod.slab_index_f32_wg()
    n_w = sum(9 * c * o for c, o in zip(CINS, COUTS))
    assert idx.numel() == unit0(6) * UNIT == 234 * 8192
    assert sorted(idx.tolist()) == list(range(8 * n_w))
    w, _ = torch_weights(rdb_params)
    stream = _stream(w)
    hi, lo = split(w.numpy())
    assert np.array_equal(stream.view(np.uint8),
                          np.concatenate([hi, lo]).view(np.uint8)[idx.numpy()])
    # stage 3, k-step 77: x1's tap 1, its channels 8..15 (conv 3's 72..79),
    # in group 19, unit 18 + 27 + 19; the lo slab, output channel 21, value 5
    s, tt, n, i = 3, 77, 21, 5
    kk = tt - 72
    tap, cc = divmod(kk, 4)
    ch = 64 + 8 * cc + i
    unit = unit0(s) + tt // KQ
    r = tt % KQ
    byte = unit * UNIT + UNIT // 2 + n * 128 + ((2 * r + i // 4) ^ (n % 8)) * 16 + 4 * (i % 4)
    off3 = 9 * (64 * 32 + 96 * 32)
    assert stream.view(np.uint32)[byte // 4] == lo[off3 + (tap * 128 + ch) * 32 + n].view(np.uint32)
    # stage 5's groups: hi in one unit, lo in the next (64 rows each)
    s, tt, n, i = 5, 200, 50, 2
    kk = tt - 72
    j, kk = 1 + kk // 36, kk % 36
    tap, cc = divmod(kk, 4)
    ch = 64 + 32 * (j - 1) + 8 * cc + i
    unit = unit0(s) + tt // KQ * 2
    r = tt % KQ
    at = n * 128 + ((2 * r + i // 4) ^ (n % 8)) * 16 + 4 * (i % 4)
    off5 = 9 * 32 * (64 + 96 + 128 + 160)
    want = off5 + (tap * 192 + ch) * 64 + n
    assert stream.view(np.uint32)[(unit * UNIT + at) // 4] == hi[want].view(np.uint32)
    assert stream.view(np.uint32)[((unit + 1) * UNIT + at) // 4] == lo[want].view(np.uint32)


def _source_int(pattern: str) -> int:
    return int(re.search(pattern, RDB_CU.read_text()).group(1).replace(",", ""))


def test_shared_memory_plan_fits_and_matches_the_source():
    """x and x1..x4 in float32 at the 8×8 tile take 172,032 bytes (as
    ``rdb_kernel<float>``'s planar sources); with the ring of 7 slots of
    8 KB, 1024 of alignment and two barriers a slot the block has 230,512
    of its 232,448; an eighth slot would not fit. The plan equals
    ``csrc/rdb.cu``'s constants (which phase kernel holds to the built
    library)."""
    plan = rdb_mod.rdb_f32_wg_smem_plan()
    assert plan["sources"] == src_off(5) == 172_032
    assert plan["total"] == 1024 + NBUF * UNIT + src_off(5) + 2 * NBUF * 8
    assert plan["total"] == 230_512 <= SMEM_LIMIT
    assert 1024 + 8 * UNIT + src_off(5) + 2 * 8 * 8 > SMEM_LIMIT
    assert _source_int(r"constexpr int F32_NBUF = (\d+);") == NBUF
    assert _source_int(r"constexpr int F32_UNIT = (\d+);") == UNIT
    assert _source_int(r"f32_smem_bytes\(\) == (\d+)") == plan["total"]
    assert _source_int(r"f32_off\(5\) == (\d+)") == plan["sources"]
    assert _source_int(r"f32_macs_per_tile\(\) == (\d+)") == macs_per_tile()
    # a 10×10 tile's sources alone leave room for one slot
    big = sum((10 + 2 * (5 - j)) ** 2 * (64 if j == 0 else 32) * 4 for j in range(5))
    assert big == 220_160 and (SMEM_LIMIT - big - 1024) // UNIT == 1
    for v in ("230,512", "172,032", "232,448", "220,160"):
        assert v in RDB_CU.read_text()


def test_x_layout_is_conflict_free_from_any_first_pixel():
    """``rot_f32``: an ldmatrix phase (8 consecutive pixels at one chunk)
    hits 8 bank groups from any first pixel, in x (16 chunks a pixel) and
    x1..x4 (8)."""
    for cq in (8, 16):
        for first in range(64):
            for chunk in range(cq):
                banks = rot(np.arange(first, first + 8), chunk, cq) // 16 % 8
                assert len(set(banks.tolist())) == 8


def test_executed_work_and_floors():
    """34.21 M multiply-adds a tile executed (stage 3's padded fourth tile
    included; 31.85 M without it), 2.23× the tile's useful work (its halo
    recompute 1.77× of it); the split-TF32 floors at (16, 264, 264): 3.24
    ms unpadded, 7.23 ms as executed (6.73 at 31.85 M), at 495 TFLOP/s for
    three products; 7.98 ms at 67 TFLOP/s of FP32 FMA."""
    useful = 64 * 9 * sum(c * n for c, n in zip(CINS, COUTS))
    assert macs_per_tile() / useful == pytest.approx(2.2308, abs=1e-4)
    halo = sum(side(s) ** 2 * 9 * CINS[s - 1] * COUTS[s - 1] for s in range(1, 6))
    assert halo / useful == pytest.approx(1.7692, abs=1e-4)
    unpadded = sum(n_tiles(s) * 64 * 9 * CINS[s - 1] * COUTS[s - 1] for s in range(1, 6))
    assert unpadded == 31_850_496
    tiles = 16 * 33 * 33
    assert tiles == 17_424
    assert tiles * macs_per_tile() * 2 * 3 / 495e12 * 1e3 == pytest.approx(7.23, abs=0.005)
    assert tiles * unpadded * 2 * 3 / 495e12 * 1e3 == pytest.approx(6.73, abs=0.005)
    flop = 2 * 9 * (64 * 192 + 32 * 160 + 32 * 128 + 32 * 96 + 32 * 64) * 16 * 264 * 264
    assert 3 * flop / 495e12 * 1e3 == pytest.approx(3.24, abs=0.005)
    assert flop / 67e12 * 1e3 == pytest.approx(7.98, abs=0.005)


def test_packed_once_a_body(rdb_params):
    """``rdb``'s float32 stream is packed once for a weight tensor and
    again after an in-place change."""
    w, _ = torch_weights(rdb_params)
    calls = []

    def pack(t):
        calls.append(t)
        return rdb_mod.pack_rdb_f32_wg(t)

    cache = type(rdb_mod._F32_PACKS)()
    first = rdb_mod._packed(cache, w, pack)
    assert rdb_mod._packed(cache, w, pack) is first and len(calls) == 1
    w.mul_(0.5)
    assert rdb_mod._packed(cache, w, pack) is not first and len(calls) == 2


def test_ffma_and_rdb_cpu_plain_and_refuse_other_devices(rdb_params):
    """On the CPU ``rdb`` and the timing baseline ``rdb_ffma`` run the plain
    version and count no launch; another device raises."""
    w, b = torch_weights(rdb_params)
    x = torch.from_numpy(_image((1, 9, 10), False, 36)[0])
    n0 = rdb_mod.LAUNCHES_F32, rdb_mod.LAUNCHES_FFMA, rdb_mod.LAUNCHES
    want = rdb_reference(x, w, b)
    assert torch.equal(rdb_mod.rdb_ffma(x, w, b), want)
    assert torch.equal(rdb_mod.rdb(x, w, b), want)
    assert (rdb_mod.LAUNCHES_F32, rdb_mod.LAUNCHES_FFMA, rdb_mod.LAUNCHES) == n0
    with pytest.raises(RuntimeError, match="unsupported device"):
        rdb_mod.rdb_ffma(x.to("meta"), w.to("meta"), b.to("meta"))

