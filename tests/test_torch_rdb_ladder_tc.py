"""The bf16 tensor-core ladder rungs' data movement (``csrc/rdb_ladder_tc.cu``,
``v1_tc_kernel``, ``v2_tc_kernel`` and ``v3_tc_kernel``), emulated in NumPy
and held to the port's plain versions.

The kernels run only on the card (``chip_smoke.py``, phase ``ladder``).
Here every address they compute is followed in NumPy, in float32 so that
the result is the float32 rung: shared memory is an array of 2-byte
cells addressed by byte; the A slabs are staged at the kernel's swizzled
addresses (x by 16-byte copies from the image, zero outside it; x_j and
v1's growth buffer from the pixel-major slots; v2's band once per pass
and dx group, read by its three dy steps at descriptor starts dy·P·128
bytes apart); B slabs are copied from the packed images; each ``wgmma``
reads both operands through the 128-byte swizzle of its descriptor's
address, and its accumulator is handed out in the hardware's register
layout, which the kernel's epilogues read back. The ring's next slab is
staged before the current slab's product is read, as the kernel overlaps
them, so a stage that overwrote the buffer in use would show. The
packers are checked on their own.
"""

import numpy as np
import pytest
import torch

from s2sr_tpu_torch.ops import rdb_ladder as lad
from s2sr_tpu_torch.ops.matmul_chain import pack_wgmma
from torch_threads import one_torch_thread  # noqa: F401

NF, G, LANES = 64, 32, 128
WGS, THREADS = 2, 256
PASS = 64 * WGS
A_SLAB = 64 * 128
RING = 2 * (WGS * A_SLAB + 192 * 128)
TILE = {"v1": 14, "v2": 16, "v3": 16}
# v2: the ring holds B alone; the band after it holds a pass's 128 rows
# and the 2·24 rows its dy parts reach below them
RING_BYTES = {"v1": RING, "v2": 61440, "v3": RING}
BAND = {"v1": 0, "v2": (PASS + 2 * 24) * 128, "v3": 0}
SMEM_LIMIT = 232448


def ring_stages(n, a_bytes=WGS * A_SLAB, ring=RING):
    """``Ring<N, A_BYTES, BYTES>``: bytes of one stage (1024-byte atoms)
    and stages."""
    stage = cdiv(a_bytes + n * 128, 1024) * 1024
    return stage, ring // stage


def pitch(s):
    """v2's band pitch over a region of side s: a multiple of 8 rows."""
    return cdiv(s, 8) * 8


def side(tile, k):
    return tile + 2 * (5 - k)


def cdiv(a, b):
    return -(-a // b)


def slot_off(tile, k):
    return sum((G if i < 5 else NF) * 2 * side(tile, i) ** 2
               for i in range(1, k))


def values_bytes(rung):
    t = TILE[rung]
    return slot_off(t, 5) + NF * 4 * t * t if rung == "v1" else slot_off(t, 6)


def smem_bytes(rung):
    """``Cfg<R>::SMEM``: alignment, ring, band, stage values."""
    return 1024 + RING_BYTES[rung] + BAND[rung] + values_bytes(rung)


def swz(r, c):
    """Byte offset of 16-byte chunk c of row r in a swizzled slab."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def slot_at(pix, ch, chans):
    """Channel ch of pixel pix in a slot of ``chans`` channels, pixel-major."""
    return (pix * chans + ch) * 2


def p5_at(pix, ch):
    """Channel ch of pixel pix in v1's float32 p5, pixel-major."""
    return (pix * NF + ch) * 4


def phys(addr):
    """The 128-byte swizzle on a shared address, as wgmma applies it to the
    addresses its descriptor generates (bits 4-6 XOR bits 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def src_n(j):
    return NF + G * (4 - j)


def rung_n(rung, j):
    if rung != "v1":
        return src_n(j)
    return NF + 4 * G if j == 0 else (G if j < 4 else NF)


def rung_k(rung, j):
    """K values executed per position of product j."""
    if rung == "v1":
        return 9 * NF if j == 0 else 9 * LANES
    return 9 * (NF if j == 0 else G)         # v2: 3 dy x (64 + 32) for x_j


def image_k(rung, j):
    """K rows of product j's B image (before padding to 64)."""
    return 3 * 128 if rung == "v2" and j > 0 else rung_k(rung, j)


def rung_rows(rung, j):
    """M rows product j runs: its region's pixels, or for v2 its
    positions qy·P + qx up to the region's last."""
    s = side(TILE[rung], j + 1)
    return (s - 1) * pitch(s) + s if rung == "v2" else s * s


def macs_per_tile(rung):
    """What ``Cfg<R>::macs`` counts: each product over its rows in passes
    of 128 positions, all N columns, the executed K."""
    return sum(cdiv(rung_rows(rung, j), PASS) * PASS * rung_k(rung, j)
               * rung_n(rung, j) for j in range(5))


class Block:
    """One thread block of a tensor-core rung, in float32."""

    def __init__(self, rung, x, images, b14, b5, out, b, oy0, ox0):
        self.rung, self.x, self.out = rung, x, out
        self.images = [im.reshape(-1) for im in images]
        self.b14, self.b5 = b14, b5
        self.b, self.oy0, self.ox0 = b, oy0, ox0
        self.h, self.w = x.shape[1:3]
        # NaN everywhere the kernel has not written: a read of a cell it
        # never stored would poison the output
        self.ring = RING_BYTES[rung]
        self.band = self.ring
        self.vals = self.band + BAND[rung]
        self.mem = np.full((self.vals + values_bytes(rung)) // 2, np.nan,
                           np.float32)
        self.macs = 0
        self.starts = set()           # every descriptor start, less 32·kk

    # --- shared memory -----------------------------------------------------

    def st(self, addr, v):                 # 2-byte cells, byte addresses
        self.mem[np.asarray(addr) // 2] = v

    def ld(self, addr):
        return self.mem[np.asarray(addr) // 2]

    def st16(self, addr, v):               # (n,) addresses, (n, 8) values
        self.st(np.asarray(addr)[:, None] + 2 * np.arange(8), v)

    def ld16(self, addr):
        return self.ld(np.asarray(addr)[:, None] + 2 * np.arange(8))

    @staticmethod
    def a_chunk(a0, p, ch):
        return a0 + (p >> 6) * A_SLAB + swz(p & 63, ch)

    # --- staging -----------------------------------------------------------

    def stage_b(self, b0, j, n, s, half=False):
        """B slab s of image j; ``half``: only the chunks holding logical
        chunks 0..3 (physical chunk c of row r holds c ^ (r % 8))."""
        src = self.images[j][s * n * 64:(s + 1) * n * 64].reshape(-1, 8)
        i = np.arange(n * 8)
        keep = ((i ^ (i >> 3)) & 7) < 4 if half else np.ones(i.size, bool)
        self.st16(b0 + 16 * i[keep], src[keep])

    def stage_x(self, a0, s_side, pas, tap):
        dy, dx = tap // 3, tap % 3
        e = np.arange(PASS * 8)
        p, ch = e >> 3, e & 7
        i = pas * PASS + p
        qy, qx = i // s_side, i % s_side
        gy, gx = self.oy0 - 5 + qy + dy, self.ox0 - 5 + qx + dx
        inside = ((i < s_side * s_side) & (gy >= 0) & (gy < self.h)
                  & (gx >= 0) & (gx < self.w))
        v = np.zeros((e.size, 8), np.float32)
        v[inside] = self.x[self.b, gy[inside], gx[inside]].reshape(
            -1, 8, 8)[np.arange(inside.sum()), ch[inside]]
        self.st16(self.a_chunk(a0, p, ch), v)

    def stage_slots(self, a0, pas, s_side, chunk_src):
        """A slab from the slots: chunk_src(p, ch, i) → (source byte
        address, valid, staged) per chunk; invalid chunks store zeros,
        chunks not staged are left alone."""
        e = np.arange(PASS * 8)
        p, ch = e >> 3, e & 7
        i = pas * PASS + p
        addr, valid, staged = chunk_src(p, ch, i)
        v = np.zeros((e.size, 8), np.float32)
        v[valid] = self.ld16(addr[valid])
        self.st16(self.a_chunk(a0, p, ch)[staged], v[staged])

    # --- the product ---------------------------------------------------------

    def read_operand(self, start, rows):
        """(rows, 16) K-major operand of one k16 step from the descriptor's
        start address: row r at start + 128 r (8-row groups 1024 apart),
        element e at + 2 e, through the swizzle."""
        addr = start + 128 * np.arange(rows)[:, None] + 2 * np.arange(16)
        return self.ld(phys(addr))

    @staticmethod
    def to_registers(d, n):
        """The m64nNk16 accumulator in the hardware's layout: thread tid of
        the warpgroup (warp tid / 32, g = lane / 4, t = lane % 4) holds in
        register 4 i + 2 h + e row 16 warp + g + 8 h, column 8 i + 2 t + e."""
        tid = np.arange(128)[:, None]
        j = np.arange(n // 2)[None, :]
        warp, lane = tid >> 5, tid & 31
        g, t = lane >> 2, lane & 3
        i, h, e = j // 4, (j // 2) % 2, j % 2
        return d[16 * warp + g + 8 * h, 8 * i + 2 * t + e]

    @staticmethod
    def for_acc(regs, n):
        """The kernel's epilogues' reading of the registers (``acc_pixel``,
        ``acc_col``): per thread, half h and n8 block i, the pair (row
        16 warp + g + 8 h, columns 8 i + 2 t, + 1) from registers 4 i + 2 h
        and 4 i + 2 h + 1."""
        tid, i, h = np.meshgrid(np.arange(128), np.arange(n // 8),
                                np.arange(2), indexing="ij")
        warp, lane = tid >> 5, tid & 31
        g, t = lane >> 2, lane & 3
        row = (16 * warp + g + 8 * h).ravel()
        col = (8 * i + 2 * t).ravel()
        v0 = regs[tid, 4 * i + 2 * h].ravel()
        v1 = regs[tid, 4 * i + 2 * h + 1].ravel()
        return row, col, v0, v1

    def product(self, n, nslab, npix, ks, stage, epi,
                a_bytes=WGS * A_SLAB, a_at=None, band=None):
        """The passes' steps as one sequence through the ring of
        ``ring_stages(n, a_bytes)``: step it + NBUF - 1 (across passes) is
        staged before step it's product is read, as the kernel stages it
        while the wgmmas run, so a stage that overwrote a buffer in use
        shows. ``a_at(base, pass, s)``: WG 0's A (default: the ring stage);
        ``band(pass, s)`` stages A outside the ring before the step."""
        size, nbuf = ring_stages(n, a_bytes, self.ring)
        steps = cdiv(npix, PASS) * nslab

        def stage_step(st):
            if st < steps:
                base = (st % nbuf) * size
                stage(base, base + a_bytes, st // nslab, st % nslab)

        for st in range(nbuf - 1):
            stage_step(st)
        acc = [None] * WGS
        for it in range(steps):
            pas, s = it // nslab, it % nslab
            base = (it % nbuf) * size
            if band is not None:
                band(pas, s)
            a0 = base if a_at is None else a_at(base, pas, s)
            stage_step(it + nbuf - 1)
            for wg in range(WGS):                 # both issue, always
                for kk in range(ks(s)):
                    self.starts.update((a0 + wg * A_SLAB, base + a_bytes))
                    a = self.read_operand(a0 + wg * A_SLAB + 32 * kk, 64)
                    bm = self.read_operand(base + a_bytes + 32 * kk, n)
                    prod = a.astype(np.float64) @ bm.T.astype(np.float64)
                    self.macs += 64 * 16 * n
                    acc[wg] = prod if s == 0 and kk == 0 else acc[wg] + prod
            if s < nslab - 1:
                continue
            for wg in range(WGS):
                if pas * PASS + wg * 64 < npix:
                    row, col, v0, v1 = self.for_acc(
                        self.to_registers(acc[wg].astype(np.float32), n), n)
                    epi(pas * PASS + wg * 64 + row, col, v0, v1)

    # --- epilogues -----------------------------------------------------------

    def activate(self, tile, k):
        s = side(tile, k)
        e = np.arange(s * s * (G // 2))
        p, ch = e // (G // 2), 2 * (e % (G // 2))
        gy, gx = self.oy0 - (5 - k) + p // s, self.ox0 - (5 - k) + p % s
        inside = (gy >= 0) & (gy < self.h) & (gx >= 0) & (gx < self.w)
        at = self.vals + slot_off(tile, k) + 4 * e
        for d in (0, 1):
            v = self.ld(at + 2 * d) + self.b14[(k - 1) * G + ch + d]
            v = np.where(v >= 0, v, v * np.float32(0.2))
            self.st(at + 2 * d, np.where(inside, v, 0))

    def store_out(self, qy, qx, ch, x5s):
        gy, gx = self.oy0 + qy, self.ox0 + qx
        ok = (gy < self.h) & (gx < self.w)
        for d, x5 in enumerate(x5s):
            xin = self.x[self.b, gy[ok], gx[ok], ch[ok] + d]
            y = (x5[ok] + self.b5[ch[ok] + d]) * np.float32(0.2) + xin
            self.out[self.b, gy[ok], gx[ok], ch[ok] + d] = y

    # --- v3 ------------------------------------------------------------------

    def v3_source(self, j):
        tile = TILE["v3"]
        s_side = side(tile, j + 1)
        n = src_n(j)
        nslab = 9 if j == 0 else 5

        def stage(a0, b0, pas, s):
            if j == 0:
                self.stage_x(a0, s_side, pas, s)
            else:
                def chunk_src(p, ch, i):
                    tap = 2 * s + (ch >> 2)
                    staged = tap <= 8
                    qy, qx = i // s_side + tap // 3, i % s_side + tap % 3
                    addr = (self.vals + slot_off(tile, j)
                            + slot_at(qy * (s_side + 2) + qx, 8 * (ch & 3), G))
                    return addr, staged & (i < s_side * s_side), staged
                self.stage_slots(a0, pas, s_side, chunk_src)
            self.stage_b(b0, j, n, s)

        def epi(i, col, v0, v1):
            ok = i < s_side * s_side
            self.delta_update(j, tile, i[ok] // s_side, i[ok] % s_side,
                              col[ok], v0[ok], v1[ok])

        self.product(n, nslab, s_side * s_side,
                     lambda s: 2 if j > 0 and s == 4 else 4, stage, epi)
        if j < 4:
            self.activate(tile, j + 1)

    def delta_update(self, j, tile, qy, qx, col, v0, v1):
        """Source j's columns at pixel (qy, qx) of R_{j+1} into the slots
        (``delta_update`` in the kernel)."""
        k = np.where(col < NF, 5, 4 - (col - NF) // G)
        ch = np.where(col < NF, col, (col - NF) % G)
        o = k - j - 1
        sk = tile + 2 * (5 - k)
        inr = (qy >= o) & (qy < o + sk) & (qx >= o) & (qx < o + sk)
        offs = np.array([slot_off(tile, kk) for kk in range(6)])
        at = self.vals + offs[k] + slot_at((qy - o) * sk + qx - o, ch,
                                           np.where(k < 5, G, NF))
        at, v0, v1, qy, qx, ch = (a[inr] for a in (at, v0, v1, qy, qx, ch))
        if j == 0:
            self.st(at, v0)
            self.st(at + 2, v1)
        elif j < 4:
            self.st(at, self.ld(at) + v0)
            self.st(at + 2, self.ld(at + 2) + v1)
        else:
            self.store_out(qy, qx, ch, (self.ld(at) + v0,
                                        self.ld(at + 2) + v1))

    def run_v3(self):
        for j in range(5):
            self.v3_source(j)

    # --- v2 ------------------------------------------------------------------

    def band_x(self, pas, dx, s_side, p):
        """x's band for one pass and dx tap: row r is position q = pass·128
        + r at pitch p, window pixel (q / p, q % p + dx); zero outside the
        image and the window."""
        e = np.arange((PASS + 2 * p) * 8)
        r, ch = e >> 3, e & 7
        q = pas * PASS + r
        wy, wx = q // p, q % p + dx
        gy, gx = self.oy0 - 5 + wy, self.ox0 - 5 + wx
        inside = ((wy < s_side + 2) & (wx < s_side + 2) & (gy >= 0)
                  & (gy < self.h) & (gx >= 0) & (gx < self.w))
        v = np.zeros((e.size, 8), np.float32)
        v[inside] = self.x[self.b, gy[inside], gx[inside]].reshape(
            -1, 8, 8)[np.arange(inside.sum()), ch[inside]]
        self.st16(self.band + swz(r, ch), v)

    def band_slots(self, j, pas, g, s_side, p):
        """x_j's band for one pass and group g (0: [dx 0 | dx 1], 1: [dx
        2], chunks 0..3 only) from slot j over R_j (side s_side + 2)."""
        chans = 8 if g == 0 else 4
        e = np.arange((PASS + 2 * p) * chans)
        r, ch = e // chans, e % chans
        q = pas * PASS + r
        wy, wx = q // p, q % p + 2 * g + (ch >> 2)
        valid = (wy < s_side + 2) & (wx < s_side + 2)
        addr = (self.vals + slot_off(TILE["v2"], j)
                + slot_at(wy * (s_side + 2) + wx, 8 * (ch & 3), G))
        v = np.zeros((e.size, 8), np.float32)
        v[valid] = self.ld16(addr[valid])
        self.st16(self.band + swz(r, ch), v)

    def v2_source(self, j):
        tile = TILE["v2"]
        s_side = side(tile, j + 1)
        p = pitch(s_side)
        n = src_n(j)
        nslab = 9 if j == 0 else 6           # step s: group s / 3, dy s % 3

        def stage(a0, b0, pas, s):
            g, dy = s // 3, s % 3
            if j == 0:
                self.stage_b(b0, 0, n, 3 * dy + g)
            else:
                self.stage_b(b0, j, n, 2 * dy + g, half=g == 1)

        def band(pas, s):
            if s % 3 == 0:
                if j == 0:
                    self.band_x(pas, s // 3, s_side, p)
                else:
                    self.band_slots(j, pas, s // 3, s_side, p)

        def epi(i, col, v0, v1):
            qy, qx = i // p, i % p
            ok = (qy < s_side) & (qx < s_side)
            self.delta_update(j, tile, qy[ok], qx[ok], col[ok], v0[ok],
                              v1[ok])

        self.product(n, nslab, rung_rows("v2", j),
                     lambda s: 2 if j > 0 and s >= 3 else 4, stage, epi,
                     a_bytes=0, band=band,
                     a_at=lambda base, pas, s: self.band + (s % 3) * p * 128)
        if j < 4:
            self.activate(tile, j + 1)

    def run_v2(self):
        for j in range(5):
            self.v2_source(j)

    # --- v1 ------------------------------------------------------------------

    def v1_stage1(self):
        tile = TILE["v1"]
        s_side = side(tile, 1)
        n = NF + 4 * G
        p5 = slot_off(tile, 5)

        def stage(a0, b0, pas, s):
            self.stage_x(a0, s_side, pas, s)
            self.stage_b(b0, 0, n, s)

        def epi(i, col, v0, v1):
            ok = i < s_side * s_side
            i, col, v0, v1 = i[ok], col[ok], v0[ok], v1[ok]
            k = np.minimum(col // G + 1, 5)
            ch = col - (k - 1) * G
            o = k - 1
            sk = tile + 2 * (5 - k)
            qy, qx = i // s_side - o, i % s_side - o
            inr = (qy >= 0) & (qy < sk) & (qx >= 0) & (qx < sk)
            offs = np.array([slot_off(tile, kk) for kk in range(6)])
            bf = inr & (k < 5)
            at = self.vals + offs[k] + slot_at(qy * sk + qx, ch, G)
            self.st(at[bf], v0[bf])
            self.st(at[bf] + 2, v1[bf])
            f32 = inr & (k == 5)
            at = self.vals + p5 + p5_at(qy * tile + qx, ch)
            self.st(at[f32], v0[f32])
            self.st(at[f32] + 4, v1[f32])

        self.product(n, 9, s_side * s_side, lambda s: 4, stage, epi)
        self.activate(tile, 1)

    def v1_stage(self, k):
        tile = TILE["v1"]
        s_side = side(tile, k)
        n = G if k < 5 else NF
        p5 = slot_off(tile, 5)

        def stage(a0, b0, pas, s):
            tap, h = s >> 1, s & 1

            def chunk_src(p, ch, i):
                src = 2 * h + (ch >> 2) + 1
                ss = tile + 2 * (5 - src)
                o = k - src - 1
                qy, qx = i // s_side + o + tap // 3, i % s_side + o + tap % 3
                offs = np.array([slot_off(tile, kk) for kk in range(6)])
                addr = (self.vals + offs[src]
                        + slot_at(qy * ss + qx, 8 * (ch & 3), G))
                valid = (src < k) & (i < s_side * s_side)
                return addr, valid, np.ones_like(valid)
            self.stage_slots(a0, pas, s_side, chunk_src)
            self.stage_b(b0, k - 1, n, s)

        def epi(i, ch, v0, v1):
            ok = i < s_side * s_side
            i, ch, v0, v1 = i[ok], ch[ok], v0[ok], v1[ok]
            qy, qx = i // s_side, i % s_side
            if k < 5:
                gy, gx = self.oy0 - (5 - k) + qy, self.ox0 - (5 - k) + qx
                inside = (gy >= 0) & (gy < self.h) & (gx >= 0) & (gx < self.w)
                at = self.vals + slot_off(tile, k) + slot_at(i, ch, G)
                for d, v in enumerate((v0, v1)):
                    y = self.ld(at + 2 * d) + v + self.b14[(k - 1) * G + ch + d]
                    y = np.where(y >= 0, y, y * np.float32(0.2))
                    self.st(at + 2 * d, np.where(inside, y, 0))
            else:
                at = self.vals + p5 + p5_at(i, ch)
                self.store_out(qy, qx, ch, (self.ld(at) + v0,
                                            self.ld(at + 4) + v1))

        self.product(n, 18, s_side * s_side, lambda s: 4, stage, epi)

    def run_v1(self):
        self.v1_stage1()
        for k in range(2, 6):
            self.v1_stage(k)


def emulate(rung, x, packed):
    """The rung's tensor-core kernel over the whole image, in float32:
    returns (output, multiply-adds executed per block, the descriptor
    starts of every block's wgmmas less their k16 offsets)."""
    images = [t.numpy() for t in fp32_images(packed, rung)]
    _, b14, b5 = packed
    x = x.numpy()
    out = np.full_like(x, np.nan)
    bsz, h, w, _ = x.shape
    tile = TILE[rung]
    macs, starts = set(), set()
    for b in range(bsz):
        for by in range(cdiv(h, tile)):
            for bx in range(cdiv(w, tile)):
                blk = Block(rung, x, images, b14.numpy().ravel(),
                            b5.numpy().ravel(), out, b, by * tile, bx * tile)
                getattr(blk, f"run_{rung}")()
                macs.add(blk.macs)
                starts |= blk.starts
    assert len(macs) == 1
    return out, macs.pop(), starts


def fp32_images(packed, rung):
    """:func:`pack_tc_images`' layout without the cast to bf16, so that the
    emulation computes the float32 rung."""
    return [pack_wgmma(m) for m in lad.tc_matrices(packed, rung)]


@pytest.fixture(scope="module")
def weights():
    """Kaiming weights at the kernel's widths (no 0.1 scale, so x1..x4
    move the output) and nonzero biases."""
    rng = np.random.default_rng(5)
    kernels, biases = [], []
    for k in range(1, 6):
        cin, cout = 64 + 32 * (k - 1), 32 if k < 5 else 64
        kernels.append(torch.from_numpy(
            (rng.normal(size=(cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin)))
            .astype(np.float32)))
        biases.append(torch.from_numpy(
            rng.normal(0, 0.05, cout).astype(np.float32)))
    return kernels, biases


# images that cross a tile edge in both directions (v2, v3 tile 16, v1 14)
SHAPES = {"v3": (1, 19, 17), "v2": (1, 17, 19), "v1": (2, 16, 15)}


@pytest.mark.parametrize("rung", lad.TC_RUNGS)
def test_emulation_matches_reference(weights, rung):
    packed = lad.PACKERS[rung](*weights, torch.float32)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(0, 0.5, (*SHAPES[rung], 64))
                         .astype(np.float32))
    got, macs, starts = emulate(rung, x, packed)
    want = lad.REFERENCES[rung](x, packed).numpy()
    assert np.isfinite(got).all()
    assert np.abs(want - x.numpy()).max() > 0.3        # the block does work
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the executed count the kernel source reports is what ran
    assert macs == macs_per_tile(rung)
    # every descriptor starts on a swizzle atom, so its base offset is 0;
    # v2's dy parts too, dy·P·128 bytes into the band (P 24 and 16)
    assert all(a % 1024 == 0 for a in starts)
    if rung == "v2":
        band = RING_BYTES["v2"]
        assert {band + dy * p * 128 + wg * A_SLAB for dy in range(3)
                for p in (24, 16) for wg in range(WGS)} <= starts


@pytest.mark.parametrize("rung", lad.TC_RUNGS)
def test_executed_over_useful(rung):
    """Executed work per output pixel at a whole tile: v3 computes every
    column over each product's region; v1 also the zero rows."""
    useful = 9 * (64 * 192 + 32 * (160 + 128 + 96 + 64))
    ratio = macs_per_tile(rung) / (TILE[rung] ** 2 * useful)
    assert ratio == pytest.approx({"v3": 2.0962, "v2": 2.2500,
                                   "v1": 2.5118}[rung], abs=1e-4)


@pytest.mark.parametrize("rung", lad.TC_RUNGS)
def test_shared_memory_fits(rung):
    """``Cfg<R>::SMEM`` under the block limit, and the ring's stages at
    every N the rung runs: two or more (``Ring``'s assertion)."""
    assert smem_bytes(rung) <= SMEM_LIMIT
    a_bytes = 0 if rung == "v2" else WGS * A_SLAB
    for j in range(5):
        assert ring_stages(rung_n(rung, j), a_bytes, RING_BYTES[rung])[1] >= 2


def unpack_image(img, k):
    """Inverse of ``pack_wgmma``: ``(K/64, N, 8, 8)`` → ``(k, N)``."""
    kb, n = img.shape[:2]
    rows = np.arange(n)[:, None]
    logical = np.empty_like(img)
    for j in range(8):                   # physical chunk j of row n
        logical[:, rows[:, 0], (j ^ (rows[:, 0] % 8))] = img[:, :, j]
    full = logical.reshape(kb, n, 64).transpose(0, 2, 1).reshape(kb * 64, n)
    assert not full[k:].any()
    return full[:k]


@pytest.mark.parametrize("rung", lad.TC_RUNGS)
def test_images_are_exact_permutations(weights, rung):
    packed = lad.PACKERS[rung](*weights, torch.bfloat16)
    images = lad.pack_tc_images(packed, rung)
    assert [tuple(t.shape) for t in images] == lad.tc_image_shapes(rung)
    blocks, _, _ = packed
    for j, (img, blk) in enumerate(zip(images, blocks)):
        assert img.dtype == torch.bfloat16 and img.is_contiguous()
        n = blk.shape[-1]
        got = unpack_image(img.float().numpy(), image_k(rung, j))
        if rung == "v3" or (rung == "v2" and j == 0):
            want = blk.numpy().reshape(-1, n)
        elif rung == "v2":               # each dy's 96 rows padded to 128
            want = np.pad(blk.numpy(), ((0, 0), (0, 128 - blk.shape[1]),
                                        (0, 0))).reshape(-1, n)
        else:
            rows = blk.numpy().reshape(9, LANES, n)
            if j == 0:                   # x's pad lanes are dropped: zero
                assert not rows[:, NF:].any()
                rows = rows[:, :NF]
            want = rows.reshape(-1, n)
        np.testing.assert_array_equal(got, want)
        # every value of the packed weights is in the image exactly once
        assert np.count_nonzero(got) == np.count_nonzero(blk.numpy())
        np.testing.assert_array_equal(np.sort(got.ravel()[got.ravel() != 0]),
                                      np.sort(blk.numpy()[blk.numpy() != 0]))


def test_v2_x_image_is_v3s(weights):
    """Where v2's K is not padded (x: rows (dy, dx, cin) are v3's (tap,
    cin)), its B image equals v3's element for element."""
    ims = {r: lad.pack_tc_images(lad.PACKERS[r](*weights, torch.bfloat16), r)
           for r in ("v2", "v3")}
    assert torch.equal(ims["v2"][0], ims["v3"][0])


def test_tc_route_by_rung_and_dtype(weights):
    """bf16 v1, v2 and v3 take the tensor-core route (and so want the
    images on the card), float32 does not; on the CPU every rung runs its
    plain version."""
    packed = lad.PACKERS["v3"](*weights, torch.bfloat16)
    x = torch.empty(1, 4, 4, 64, dtype=torch.bfloat16)
    assert lad.rdb_v3(x.zero_(), packed).shape == x.shape    # CPU: plain
    for rung in ("v1", "v2", "v3"):
        assert lad._on_tensor_cores(rung, torch.bfloat16)
        assert not lad._on_tensor_cores(rung, torch.float32)
