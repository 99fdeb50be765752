"""The served float32 Swin kernel,
``csrc/window_attention.cu::swin_f32_wg_kernel``
(split TF32 on ``wgmma``, two windows a block sharing every B unit a ring
of bulk copies streams), emulated in NumPy at the kernel's widths (C 180,
6 heads, window 8, MLP 360) and held to the port's IEEE float32 plain
versions and to the JAX package's fused kernels in interpret mode.

The emulation follows the kernel's data movement, every window of the
grid at once: the block's two windows (an odd count's last pair computing
its last window again and dropping the stores), x read at the rolled
token addresses, LN1 / LN2 / O_h / H_q stored by the kernel's own address
arithmetic (``a_at``: 16-byte chunk c of row r at c ^ (r % 8)) and read
back by ``ldmatrix`` of 32-bit elements into TF32 A fragments (a0 (g, t),
a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)), split into hi and lo;
q and P carried as A fragments straight from the accumulators, K and V^T
written with their head dims and keys relabelled [0, 2, 4, 6, 1, 3, 5,
7] within each group of 8 (``b_at``, ``relabel``), every B operand read
back through its descriptor (start, 8-row groups 1024 bytes apart, the
128-byte swizzle on the byte address) from the K / V^T buffers or the
ring's slot, the ring filled unit by unit from the packed stream
(:func:`pack_f32_wg_units`), each wgmma's sum of 8 TF32 products added as
the tensor cores add it (rounded once, or with ``truncate`` toward zero),
the three products of a multiply-add in the kernel's order into a
partial of their own folded into the float32 sums by a rounded add, the
softmax, the erf GELU and y in float32. The kernel itself runs only on
the card (``chip_smoke.py``, phase ``swin_kernel``).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.ops.pallas.window_attention import (
    build_attention_tables,
    swin_block_fused,
    window_attention_fused,
)
from s2sr_tpu_torch.ops import window_attention as wa
from test_torch_swin_wg import block_weights
from test_torch_window_attention import jax_block, roll, tables
from torch_threads import one_torch_thread  # noqa: F401

SRC = Path(wa.__file__).resolve().parent.parent / "csrc" / "window_attention.cu"
C, HEADS, WIN, N = 180, 6, 8, 64
NBUF, UNIT = 5, 96 * 128
W_A, W_KH, W_KL, W_VH, W_VL = 0, 49152, 57344, 65536, 73728
WIN_BYTES = 81920
TABLE = (2 * WIN - 1) ** 2
F32, F64 = np.float32, np.float64

WARP = np.arange(4)[:, None]
LANE = np.arange(32)[None, :]
G, T = LANE >> 2, LANE & 3
R0 = 16 * WARP + G                     # a thread's accumulator rows (4, 32)
R1 = R0 + 8


def rna(a):
    """float32 to TF32 as ``cvt.rna.tf32.f32``: the low 13 bits rounded
    away, ties away from zero."""
    bits = np.ascontiguousarray(a, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(a):
    hi = rna(a)
    return hi, rna(np.asarray(a, F32) - hi)


def a_at(ldc, row, col):
    """The kernel's ``a_at<LDC>``: byte offset of float32 (row, col)."""
    cc = col >> 2
    return row * ldc * 16 + ((((cc ^ row) & 7) | (cc & ~7)) * 16) + (col & 3) * 4


def b_at(row, p):
    """The kernel's ``b_at``: TF32 (row, place p < 32), 128-byte rows."""
    return row * 128 + (((p >> 2) ^ row) & 7) * 16 + (p & 3) * 4


def relabel(c):
    """Place of column c of a group of 8 in a k8 step: 2t at t, 2t + 1 at
    t + 4."""
    return (c >> 1) + 4 * (c & 1)


def desc_read(mem, start, rows):
    """A K-major, 128-byte-swizzle operand read through its descriptor: the
    k8 step at byte ``start`` of ``rows`` rows, (..., 8, rows)."""
    n, k = np.arange(rows)[:, None], np.arange(8)[None, :]
    addr = start + (n // 8) * 1024 + (n % 8) * 128 + 4 * k
    addr = addr ^ (((addr >> 7) & 7) << 4)
    return np.swapaxes(mem[..., addr // 4], -1, -2)


def ldsm(mem, base, ldc, s):
    """k8 step s of an A buffer as the kernel loads it: per warp one
    ``ldmatrix.x4`` whose lane l points at row 16w + l % 16, column 8s +
    4 (l // 16); matrix i (lanes 8i..) into register i, thread l holding
    word l % 4 of its row l // 4; read back through the TF32 A fragment.
    → (windows, 64, 8)."""
    lanes = np.arange(32)
    row = 16 * WARP + (lanes & 15)
    addr = base + a_at(ldc, row, 8 * s + 4 * (lanes >> 4))            # (4, 32)
    src = 8 * np.arange(4)[:, None] + lanes[None, :] // 4             # (reg, lane)
    regs = mem[:, (addr[:, src] + 4 * (lanes % 4)) // 4]              # (nw, 4, 4, 32)
    return frag_to_a(np.moveaxis(regs, 2, 3))


def frag_to_a(regs):
    """TF32 A fragments (windows, 4 warps, 32 lanes, 4 regs) → (windows, 64,
    8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)."""
    a = np.full((regs.shape[0], 64, 8), np.nan, F32)
    for r in range(4):
        a[:, R0 + 8 * (r & 1), T + 4 * (r >> 1)] = regs[..., r]
    return a


def acc_regs(m, cols0=0):
    """The accumulator layout: element i of thread (w, g, t) is row r0 (i %
    4 < 2) or r1, column 8 (i // 4) + 2t + i % 2 of ``m`` (windows, 64,
    n). → (windows, 4, 32, n // 2)."""
    na = m.shape[-1] // 2
    i = np.arange(na)[None, None, :]
    rows = np.where(i % 4 < 2, R0[..., None], R1[..., None])
    cols = cols0 + 8 * (i // 4) + 2 * T[..., None] + (i & 1)
    return m[:, rows, np.broadcast_to(cols, rows.shape)]


def rz(x):
    """float64 to float32 rounded toward zero."""
    y = x.astype(F32)
    over = np.abs(y.astype(F64)) > np.abs(x)
    y[over] = np.nextafter(y[over], F32(0))
    return y


class Ring:
    """The B ring over one pair's stream: NBUF slots, the first NBUF units
    copied in at the start; ``release(g)``: both consumers' warps have
    read unit g, and unit g + NBUF is copied into its slot. A read of a
    slot holding another unit, or a copy over a unit not yet released,
    fails."""

    def __init__(self, units):
        self.units, self.n = units, len(units)
        self.mem = np.zeros(NBUF * UNIT // 4, F32)
        self.tag, self.released = [-1] * NBUF, []
        for g in range(NBUF):
            self.fill(g)

    def fill(self, g):
        slot = g % NBUF
        assert self.tag[slot] < 0 or self.tag[slot] in self.released
        self.mem[slot * UNIT // 4:(slot + 1) * UNIT // 4] = self.units[g].reshape(-1)
        self.tag[slot] = g

    def slot(self, g):
        assert self.tag[g % NBUF] == g, f"unit {g}: its slot holds {self.tag[g % NBUF]}"
        return (g % NBUF) * UNIT

    def release(self, g):
        assert g == len(self.released), f"unit {g} released out of turn"
        self.released.append(g)
        if g + NBUF < self.n:
            self.fill(g + NBUF)


class Emu:
    """One run of the kernel over a list of windows (its consumers' windows
    in block order), all at once."""

    def __init__(self, units, nw, lo_products=True, truncate=True):
        self.ring = Ring(units)
        self.mem = np.full((nw, WIN_BYTES // 4), np.nan, F32)
        self.lo, self.trunc = lo_products, truncate

    def products(self, part, a, b):
        """One k8 step's three products (lo_a hi_b, hi_a lo_b, hi_a hi_b;
        plain TF32: hi_a hi_b alone) into ``part`` (None: scale-d 0), each
        wgmma's sum added as the tensor cores add it."""
        (ah, al), (bh, bl) = a, b
        terms = ([(al, bh), (ah, bl)] if self.lo else []) + [(ah, bh)]
        for x, y in terms:
            s = x.astype(F64) @ y.astype(F64)
            if part is not None:
                s = s + part
            part = rz(s) if self.trunc else s.astype(F32)
        return part

    def chain96(self, abuf, ldc, kb0, kb, i0):
        """``chain96<KB, LDC>``: the partial from zero over kb K blocks, a K
        block's units released once its wgmmas have completed."""
        part, r = None, self.ring
        for b in range(kb):
            hi, lo = r.slot(i0 + 2 * b), r.slot(i0 + 2 * b + 1)
            for s in range(4):
                a = split(ldsm(self.mem, abuf, ldc, 4 * (kb0 + b) + s))
                bb = (desc_read(r.mem, hi + 32 * s, 96), desc_read(r.mem, lo + 32 * s, 96))
                assert all(np.array_equal(rna(v), v) for v in bb)    # TF32 values
                part = self.products(part, a, bb)
            r.release(i0 + 2 * b)
            r.release(i0 + 2 * b + 1)
        return part

    def gemm96(self, abuf, i0):
        acc = np.zeros((self.mem.shape[0], 64, 96), F32)
        for b in range(6):
            acc = acc + self.chain96(abuf, 48, b, 1, i0 + 2 * b)
        return acc

    def sts(self, addr, v):
        """Stores by thread (w, lane): ``addr`` (4, 32) bytes, v (nw, 4, 32)."""
        self.mem[:, np.broadcast_to(addr, (4, 32)) // 4] = v


def gelu32(v):
    return torch.nn.functional.gelu(torch.from_numpy(np.ascontiguousarray(v))).numpy()


def emulate(x, t, units, mlp, rolled=False, last=True, **kw):
    """``swin_f32_wg_kernel<mlp>`` on ``x`` (B, H, W, 180) float32 with
    the numpy tables ``t`` and the packed stream ``units``."""
    bsz, h, w, _ = x.shape
    windows = bsz * (h // WIN) * (w // WIN)
    shift = t["shift"]
    hshift = 0 if rolled else shift
    last_wy = -1 if rolled and not last else h // WIN - 1
    runs = [(min(2 * p + wg, windows - 1), 2 * p + wg < windows)
            for p in range(-(-windows // 2)) for wg in range(2)]
    wins = np.array([r[0] for r in runs])
    nwh, nww = h // WIN, w // WIN
    b_, wy, wx = wins // (nwh * nww), (wins // nww) % nwh, wins % nww
    lr = (shift > 0) & (wy == last_wy)
    lc = (shift > 0) & (wx == nww - 1)
    r = np.arange(N)
    gy = (wy[:, None] * WIN + (r >> 3) + hshift) % h
    gx = (wx[:, None] * WIN + (r & 7) + shift) % w
    tok = (b_[:, None] * h + gy) * w + gx                           # (nw, 64)
    xs = x.reshape(-1, C)[tok]                                      # (nw, 64, 180)
    nw = len(runs)
    e = Emu(units, nw, **kw)
    n_units = len(units) if mlp else len(units) // 2
    e.ring.n = n_units

    # LN1 into A
    mean = xs.sum(-1, dtype=F32) / F32(C)
    var = ((xs - mean[..., None]) ** 2).sum(-1, dtype=F32) / F32(C)
    rstd = F32(1) / np.sqrt(var + F32(1e-5))
    ln = np.zeros((nw, 64, 192), F32)
    ln[..., :C] = (xs - mean[..., None]) * rstd[..., None] * t["g1"] + t["b1"]
    rows, cols = np.meshgrid(np.arange(64), np.arange(192), indexing="ij")
    e.mem[:, (W_A + a_at(48, rows, cols)) // 4] = ln
    assert not np.isnan(e.mem[:, :W_KH // 4]).any()

    tb = t["bias_table"].T.reshape(-1)                               # [head][225]
    y = np.zeros((nw, 64, 192), F32)
    for hd in range(HEADS):
        u0 = 16 * hd
        acc = e.gemm96(W_A, u0) + t["bqkv"][96 * hd:96 * hd + 96]
        regs = acc_regs(acc)                                         # (nw, 4, 32, 48)
        # q as S's A fragments: k8 step s is tile s, (v00, v10, v01, v11)
        qa = [split(frag_to_a(regs[..., [4 * s, 4 * s + 2, 4 * s + 1, 4 * s + 3]]))
              for s in range(4)]
        for j in range(4, 12):
            v = [split(regs[..., 4 * j + i]) for i in range(4)]    # v00 v01 v10 v11
            if j < 8:
                p = 8 * (j - 4) + T
                for (row, pl), i in (((R0, p), 0), ((R0, p + 4), 1), ((R1, p), 2),
                                     ((R1, p + 4), 3)):
                    e.sts(W_KH + b_at(row, pl), v[i][0])
                    e.sts(W_KL + b_at(row, pl), v[i][1])
            else:
                d = 8 * (j - 8) + 2 * T
                p = 16 * WARP + relabel(G)
                for (dd, pl), i in (((d, p), 0), ((d + 1, p), 1), ((d, p + 8), 2),
                                    ((d + 1, p + 8), 3)):
                    off = (pl >> 5) * 4096 + b_at(dd, pl & 31)
                    e.sts(W_VH + off, v[i][0])
                    e.sts(W_VL + off, v[i][1])
        # S = q K^T
        sc = None
        for s in range(4):
            bk = (desc_read(e.mem, W_KH + 32 * s, 64), desc_read(e.mem, W_KL + 32 * s, 64))
            sc = e.products(sc, qa[s], bk)
        # + bias + mask, softmax (row i = 8 yi + xi, key j = 8 yj + xj)
        i_, j_ = np.arange(64)[:, None], np.arange(64)[None, :]
        yi, xi, yj, xj = i_ // 8, i_ % 8, j_ // 8, j_ % 8
        sc = sc + tb[hd * TABLE + (yi - yj + 7) * 15 + xi - xj + 7]
        if shift:
            edge = WIN - shift
            apart = ((lr[:, None, None] & ((yi >= edge) != (yj >= edge)))
                     | (lc[:, None, None] & ((xi >= edge) != (xj >= edge))))
            sc = sc + np.where(apart, F32(-100), F32(0))
        ex = np.exp(sc - sc.max(-1, keepdims=True))
        pm = ex * (F32(1) / ex.sum(-1, keepdims=True, dtype=F32))
        pr = acc_regs(pm)                                            # (nw, 4, 32, 32)
        oa = None
        for n in range(8):
            pa = split(frag_to_a(pr[..., [4 * n, 4 * n + 2, 4 * n + 1, 4 * n + 3]]))
            off = (n >> 2) * 4096 + 32 * (n & 3)
            bv = (desc_read(e.mem, W_VH + off, 32), desc_read(e.mem, W_VL + off, 32))
            oa = e.products(oa, pa, bv)
        # O_h over K hi, then y += O_h wo_h a column half at a time
        o = acc_regs(oa)
        for d in range(4):
            col = 8 * d + 2 * T
            for row, i in ((R0, 4 * d), (R1, 4 * d + 2)):
                e.sts(W_KH + a_at(8, row, col), o[..., i])
                e.sts(W_KH + a_at(8, row, col + 1), o[..., i + 1])
        for u in range(2):
            y[..., 96 * u:96 * u + 96] += e.chain96(W_KH, 8, 0, 1, u0 + 12 + 2 * u)

    if not mlp:
        out = y + t["bo"]
    else:
        y[..., :C] = (xs + y[..., :C]) + t["bo"][:C]
        y[..., C:] = 0
        mean = y[..., :C].sum(-1, dtype=F32) / F32(C)
        var = ((y[..., :C] - mean[..., None]) ** 2).sum(-1, dtype=F32) / F32(C)
        rstd = F32(1) / np.sqrt(var + F32(1e-5))
        ln = np.zeros_like(y)
        ln[..., :C] = (y[..., :C] - mean[..., None]) * rstd[..., None] * t["g2"] + t["b2"]
        e.mem[:, (W_A + a_at(48, rows, cols)) // 4] = ln
        for q in range(4):
            u0 = 96 + 24 * q
            f = gelu32(e.gemm96(W_A, u0) + t["bf1"][96 * q:96 * q + 96])
            fr = acc_regs(f)
            for j in range(12):
                col = 8 * j + 2 * T
                for row, i in ((R0, 4 * j), (R1, 4 * j + 2)):
                    e.sts(W_KH + a_at(24, row, col), fr[..., i])
                    e.sts(W_KH + a_at(24, row, col + 1), fr[..., i + 1])
            for u in range(2):
                y[..., 96 * u:96 * u + 96] += e.chain96(W_KH, 24, 0, 3, u0 + 12 + 6 * u)
        out = y + t["bf2"]
    assert e.ring.released == list(range(n_units))
    res = np.full(x.size // C * C, np.nan, F32).reshape(-1, C)
    keep = np.array([r[1] for r in runs])
    flat = tok[keep].reshape(-1)
    assert len(np.unique(flat)) == flat.size, "a token written twice"
    res[flat] = out[keep][..., :C].reshape(-1, C)
    assert not np.isnan(res).any(), "a token never written"
    return res.reshape(x.shape)


def np_tables(t):
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in t.items()}


def rel(got, want, x, mlp):
    """max |got − want| over the block's own change (max |out − x| of the
    block, max |y| of the attention)."""
    change = np.abs(want - x if mlp else want).max()
    assert change > 0.1
    return np.abs(got - want).max() / change


# (shape, shift, rolled, last): even and odd window counts, B = 2 with
# pairs across the images, a band of H above the last and the last band
CASES = [((1, 16, 24), 0, False, True), ((1, 16, 24), 4, False, True),
         ((1, 24, 8), 4, False, True), ((2, 24, 8), 4, False, True),
         ((1, 16, 16), 4, True, False), ((1, 16, 16), 4, True, True)]


def case_inputs(shape, shift, mlp):
    t32 = wa.build_block_tables(block_weights(shift + 2 * mlp), HEADS, WIN, shift,
                                torch.float32)
    x = np.random.default_rng(shift + 7 * len(shape) + shape[0]).normal(
        size=(*shape, C)).astype(F32) * 0.5
    return t32, x


@pytest.mark.parametrize("mlp", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-s{c[1]}-r{int(c[2])}{int(c[3])}")
def test_emulation_matches_plain_float32(case, mlp):
    """The emulated kernel, its tensor-core adds truncating, within 1e-5
    of the block's change of the IEEE float32 plain version."""
    shape, shift, rolled, last = case
    t32, x = case_inputs(shape, shift, mlp)
    got = emulate(x, np_tables(t32), t32["f32_units"].numpy(), mlp, rolled, last)
    ref = wa.swin_block_reference if mlp else wa.window_attention_reference
    want = ref(torch.from_numpy(x), t32, rolled, last).numpy()
    assert rel(got, want, x, mlp) <= 1e-5


@pytest.mark.parametrize("mlp", [True, False])
def test_emulation_matches_jax_fused_kernels(mlp):
    """Against the JAX package's ``swin_block_fused`` /
    ``window_attention_fused`` in float32 (interpret mode) on (1, 16, 32),
    shifted (all four mask types): within 1e-5 of the block's change."""
    p = jax_block(40 + mlp)
    shift = WIN // 2
    x = np.random.default_rng(41).normal(size=(1, 16, 32, C)).astype(F32)
    jt = build_attention_tables(p["attn"], HEADS, WIN, shift, dtype=jnp.float32)
    xr = roll(jnp.asarray(x), -shift)
    if mlp:
        want = swin_block_fused(xr, jax.tree.map(jnp.asarray, p), jt, HEADS, WIN,
                                shifted=True, interpret=True)
    else:
        want = window_attention_fused(xr, jax.tree.map(jnp.asarray, p["norm1"]), jt,
                                      HEADS, WIN, shifted=True, interpret=True)
    want = np.asarray(roll(want, shift))
    t32 = tables(p, shift)
    got = emulate(x, np_tables(t32), t32["f32_units"].numpy(), mlp)
    assert rel(got, want, x, mlp) <= 1e-5


def test_plain_tf32_is_seen():
    """With hi·hi alone (plain TF32) the emulation lands ≥ 1e-4 of the
    block's change from the IEEE plain version, so the card's checks at
    1e-5 tell split TF32 from TF32; with round-to-nearest adds the split
    kernel stays within 1e-5 as well."""
    t32, x = case_inputs((1, 16, 16), 4, True)
    want = wa.swin_block_reference(torch.from_numpy(x), t32).numpy()
    args = (x, np_tables(t32), t32["f32_units"].numpy(), True)
    assert rel(emulate(*args, lo_products=False), want, x, True) >= 1e-4
    assert rel(emulate(*args, truncate=False), want, x, True) <= 1e-5


def test_tf32_split_is_cvt_rna():
    """The packer's split (``ops/rdb.py::tf32_split``) equals ``cvt.rna``
    bit for bit: ties away from zero, both signs, carries into the
    exponent; hi + lo within 2⁻²² of the value."""
    bits = np.array([0x3F801000, 0x3F803000, 0x3F802FFF, 0xBF801000,
                     0x3FFFF000, 0x00000000, 0x80000000, 0xC2C81234], np.uint32)
    v = np.concatenate([bits.view(F32),
                        np.random.default_rng(42).normal(0, 3, 2048).astype(F32)])
    hi, lo = wa.tf32_split(torch.from_numpy(v))
    nhi, nlo = split(v)
    assert np.array_equal(hi.numpy().view(np.uint32), nhi.view(np.uint32))
    assert np.array_equal(lo.numpy().view(np.uint32), nlo.view(np.uint32))
    assert list(nhi[:5].view(np.uint32)) == [0x3F802000, 0x3F804000, 0x3F802000,
                                             0xBF802000, 0x40000000]
    err = np.abs(nhi.astype(F64) + nlo - v) / np.maximum(np.abs(v), 1e-30)
    assert err.max() <= 2.0 ** -22


def test_unit_index_is_a_permutation_and_the_packer_splits():
    """Every hi and lo value of the four matrices in the stream once; the
    rest are the K pads; the packer equals the numpy split gathered by the
    index bit for bit; window_attention's units are the stream's first
    96."""
    idx = wa.f32_wg_unit_index()
    total = sum(k * n for k, n in wa.WG_MATRICES.values())
    assert idx.numel() == 192 * 96 * 32
    held = idx[idx >= 0]
    assert torch.equal(held.sort().values, torch.arange(2 * total))
    # pads: qkv and fc1 K 180..191 (6 + 4 quarters x 12 rows), fc2 360..383
    assert (idx < 0).sum().item() == 2 * 96 * (6 * 12 + 4 * 12 + 2 * 24)
    t = wa.build_block_tables(block_weights(3), HEADS, WIN, 4, torch.float32)
    units = t["f32_units"]
    assert units.dtype == torch.float32 and tuple(units.shape) == (192, 96, 32)
    flat = np.concatenate([t[k].numpy().reshape(-1) for k in wa.WG_MATRICES])
    both = np.concatenate([*split(flat), np.zeros(1, F32)])
    i = idx.numpy()
    assert np.array_equal(units.numpy().reshape(-1).view(np.uint32),
                          both[np.where(i < 0, both.size - 1, i)].view(np.uint32))
    plan = wa.f32_wg_unit_plan()
    assert [u[0] for u in plan[:96]] == (["wqkv"] * 12 + ["wo"] * 4) * 6
    assert "f32_units" not in wa.build_block_tables(block_weights(3), HEADS, WIN, 4,
                                                    torch.bfloat16)


def test_units_read_back_through_the_descriptor_are_the_matrices():
    """Each unit read as the kernel's descriptor reads a slot (k8 step s at
    + 32 s, row n: output column n0 + n) gives the matrix's K rows k0 +
    8s.., hi + lo the float32 value within 2⁻²², the K pads zero."""
    t = wa.build_block_tables(block_weights(4), HEADS, WIN, 0, torch.float32)
    units = t["f32_units"].numpy()
    kpad = {"wqkv": 192, "wo": 192, "w1": 192, "w2": 384}
    got = {k: np.zeros((2, kpad[k], n), F32) for k, (_, n) in wa.WG_MATRICES.items()}
    for u, (name, k0, n0, half) in enumerate(wa.f32_wg_unit_plan()):
        for s in range(4):
            got[name][half, k0 + 8 * s:k0 + 8 * s + 8, n0:n0 + 96] = \
                desc_read(units[u].reshape(-1), 32 * s, 96)
    for name, m in got.items():
        k = wa.WG_MATRICES[name][0]
        want = t[name].numpy()
        assert np.array_equal(m[0, :k], rna(want)), name
        assert np.abs(m[0, :k].astype(F64) + m[1, :k] - want).max() <= \
            2.0 ** -22 * np.abs(want).max()
        assert not m[:, k:].any(), name


def ring_run(pairs, n, paces):
    """The ring's bookkeeping as ``unit_wait`` / ``unit_release`` keep it,
    for a block walking ``pairs`` window pairs of ``n`` units, its two
    consumers (4 warps each) advancing at ``paces`` (units a turn): slot,
    parity and count of every unit, the refill by the warp that completes
    the count of 8. Returns the units each consumer read in order."""
    total = n * pairs
    slot_unit, phase, count = [-1] * NBUF, [0] * NBUF, [0] * NBUF
    arrived = [0] * NBUF              # full-barrier completions
    issued = []

    def fill(g):
        s = g % NBUF
        assert slot_unit[s] < 0 or count[s] % 8 == 0, "refilled before released"
        slot_unit[s] = g
        arrived[s] += 1
        issued.append(g)

    for g in range(min(NBUF, total)):
        fill(g)
    at, read = [0, 0], [[], []]
    while min(at) < total:
        for wg in range(2):
            for _ in range(paces[wg]):
                g = at[wg]
                if g >= total:
                    break
                s = g % NBUF
                # unit_wait: the phase of parity g / NBUF has completed
                if not (arrived[s] > g // NBUF and slot_unit[s] == g):
                    break
                read[wg].append(g % n)
                for _warp in range(4):        # unit_release, lane 0 of each warp
                    old = count[s]
                    count[s] += 1
                    if (old & 7) == 7 and g + NBUF < total:
                        fill(g + NBUF)
                at[wg] += 1
    assert issued == list(range(total))
    return read


@pytest.mark.parametrize("paces", [(1, 1), (3, 1), (1, 4)])
def test_ring_runs_every_pair_in_order(paces):
    """Three pairs of 96 units (window_attention) and two of 192: each
    consumer reads the stream in order, pair after pair, whatever the
    other's pace; every unit is issued once, into a slot all 8 warps have
    released."""
    for pairs, n in ((3, 96), (2, 192)):
        read = ring_run(pairs, n, paces)
        assert read[0] == read[1] == list(range(n)) * pairs


def test_layouts_are_conflict_free():
    """Every ldmatrix phase (8 rows at one chunk) and every store pattern
    of the kernel (LN1's lane pairs, an accumulator's float2 per thread, K's
    and V^T's relabelled scalars) hits each 16-byte bank group equally."""
    for ldc in (48, 24, 8):
        for s in range(ldc // 2):
            for half in range(2):
                for r0 in range(0, 64, 8):
                    banks = a_at(ldc, np.arange(r0, r0 + 8), 8 * s + 4 * half) // 16 % 8
                    assert len(set(banks.tolist())) == 8
        # an accumulator n8 tile: rows g (8), columns 8j + 2t (4 float2)
        for j in range(ldc // 2):
            banks = a_at(ldc, G, 8 * j + 2 * T) // 16 % 8
            assert np.bincount(banks.reshape(-1), minlength=8).tolist() == [4] * 8
    for k in range(3):                             # LN1: a row, lanes 2 lane + 64k
        banks = a_at(48, 5, 2 * np.arange(32) + 64 * k) // 16 % 8
        assert np.bincount(banks, minlength=8).tolist() == [4] * 8
    for s in range(4):                             # K: rows g, places 8s + t
        banks = b_at(R0[0], 8 * s + T) // 16 % 8
        assert len(set(banks.reshape(-1).tolist())) == 8
    for w in range(4):                             # V^T: dims 2t + e, keys' places
        for e in range(2):
            banks = b_at(2 * T + e, (16 * w + relabel(G)) & 31) // 16 % 8
            assert len(set(banks.reshape(-1).tolist())) == 8


def test_relabel_keeps_every_product():
    """A k8 step whose A fragment is an accumulator's n8 tile read as the
    kernel reads it (a0 = d0, a1 = d2, a2 = d1, a3 = d3) times B with its K
    places relabelled is the plain product."""
    rng = np.random.default_rng(43)
    m, b = rng.normal(size=(1, 64, 8)).astype(F32), rng.normal(size=(8, 16)).astype(F32)
    regs = acc_regs(np.concatenate([m, np.zeros((1, 64, 8), F32)], -1))
    a = frag_to_a(regs[..., [0, 2, 1, 3]])
    bp = b[[relabel_inverse(p) for p in range(8)]]
    np.testing.assert_allclose(a[0] @ bp, m[0] @ b, rtol=1e-6, atol=1e-6)
    assert [relabel(c) for c in range(8)] == [0, 4, 1, 5, 2, 6, 3, 7]


def relabel_inverse(p):
    return 2 * p if p < 4 else 2 * (p - 4) + 1


def _src_int(pattern):
    return int(re.search(pattern, SRC.read_text()).group(1).replace(",", ""))


def test_shared_memory_plan_is_the_kernel_note():
    """``f32_wg_smem_plan`` adds up to the kernel's F32_WG_SMEM (asserted in
    the source), within a block's 232,448 bytes with no room for a sixth
    slot; the window buffers are the A buffer and K, V^T of a head with hi
    and lo, and H_q (64 × 96 float32) fits over K and V^T."""
    plan = wa.f32_wg_smem_plan()
    assert _src_int(r"F32_WG_SMEM == (\d+)") == plan["total"] == 231764
    assert plan["total"] <= 232448 < plan["total"] + wa.F32_UNIT_BYTES
    assert _src_int(r"constexpr int F32_NBUF = (\d+);") == wa.F32_RING_SLOTS == NBUF
    assert plan["ring"] == NBUF * UNIT == _src_int(r"F32_OFF_WIN == (\d+)")
    assert plan["windows"] == 2 * WIN_BYTES == 2 * _src_int(r"F32_WIN_BYTES == (\d+)")
    assert W_KH == 64 * 192 * 4 and 64 * 96 * 4 <= WIN_BYTES - W_KH
    for v in ("231,764", "81,920", "61,440", "232,448", "244,052"):
        assert v in SRC.read_text()


def test_executed_work_floors_and_l2_bytes():
    """20,447,232 multiply-adds a window executed (1.1320× the useful
    work); at (1, 512, 512): 0.897 ms for the useful work as three TF32
    products at 495 TFLOP/s, 1.015 ms as executed, 2.209 ms at 67 TFLOP/s
    of FP32 FMA; 4.83 GB of units from L2 (2,048 pairs × 192 units)."""
    macs = 64 * 192 * 576 + 2 * 6 * 64 * 64 * 32 + 64 * 192 * 192 + 2 * 64 * 192 * 384
    assert macs == 20_447_232
    useful = 564_480 * 64 // 2
    assert macs / useful == pytest.approx(1.1320, abs=1e-4)
    tokens = 512 * 512
    assert 564_480 * tokens * 3 / 495e12 * 1e3 == pytest.approx(0.897, abs=5e-4)
    assert macs * 2 * tokens / 64 * 3 / 495e12 * 1e3 == pytest.approx(1.015, abs=5e-4)
    assert 564_480 * tokens / 67e12 * 1e3 == pytest.approx(2.209, abs=5e-4)
    units = len(wa.f32_wg_unit_plan())
    assert 2048 * units * wa.F32_UNIT_BYTES == 4_831_838_208
    assert units * wa.F32_UNIT_BYTES == 2_359_296 == sum(
        (192 if k != "w2" else 384) * n * 8 for k, (_, n) in wa.WG_MATRICES.items())


def test_wrapper_designs_and_tables():
    """``design="ffma"`` (the CUDA-core baseline) takes float32 only,
    ``"mma"`` and ``"no_l2"`` bfloat16 only; on the CPU the float32 wrappers
    and ``ffma`` run the plain version and count no launch; the served
    float32 kernel wants its units, the baseline does not."""
    t = wa.build_block_tables(block_weights(9), HEADS, WIN, 4, torch.float32)
    x = torch.from_numpy(np.random.default_rng(44).normal(
        size=(1, 8, 16, C)).astype(F32))
    xb = x.bfloat16()
    with pytest.raises(TypeError, match="float32 kernel"):
        wa._check_design("swin_block", xb, True, "ffma")
    for d in ("mma", "no_l2"):
        with pytest.raises(TypeError, match="bfloat16 kernel"):
            wa._check_design("swin_block", x, True, d)
    counts = [dict(c) for c in (wa.LAUNCHES, wa.LAUNCHES_F32, wa.LAUNCHES_FFMA)]
    for fn, ref in ((wa.swin_block, wa.swin_block_reference),
                    (wa.window_attention, wa.window_attention_reference)):
        want = ref(x, t)
        assert torch.equal(fn(x, t), want)
        assert torch.equal(fn(x, t, design="ffma"), want)
    assert [dict(c) for c in (wa.LAUNCHES, wa.LAUNCHES_F32, wa.LAUNCHES_FFMA)] == counts
    with pytest.raises(TypeError, match="float32 kernel"):
        wa.swin_block(xb, wa.build_block_tables(block_weights(9), HEADS, WIN, 4,
                                                torch.bfloat16), design="ffma")
    wa._check("swin_block", x, t)
    no_units = {k: v for k, v in t.items() if k != "f32_units"}
    with pytest.raises(ValueError, match="f32_units missing"):
        wa._check("swin_block", x, no_units)
    wa._check("swin_block", x, no_units, "ffma")
    with pytest.raises(ValueError, match="f32_units"):
        wa._check("swin_block", x, {**t, "f32_units": t["f32_units"][:96]})
    with pytest.raises(RuntimeError, match="unsupported device"):
        wa._launch("swin_block", x, t, True)


def test_float32_tables_pack_once_and_small_configs_skip_the_units():
    """The units come with the tables (packed once a body, where the block
    is built); a configuration the kernel is not built for gets none."""
    t = wa.build_block_tables(block_weights(5), HEADS, WIN, 0, torch.float32)
    assert math.prod(t["f32_units"].shape) == 192 * 96 * 32
    small = jax_block(45, c=12, heads=2, win=4, hidden=24)
    t = tables(small, 0, heads=2, win=4)
    assert "f32_units" not in t
