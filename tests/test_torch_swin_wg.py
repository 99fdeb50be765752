"""The served bf16 Swin kernel, ``csrc/window_attention.cu::swin_wg_kernel``
(``wgmma``, two windows a block, B streamed through a ring of bulk
copies), emulated in NumPy at the kernel's widths (C 180, 6 heads, window
8, MLP 360) and held to the port's plain versions.

The kernel itself runs only on the card (``chip_smoke.py``, phase
``swin_kernel``). Here its data movement is followed in float32, so that
the result is the fp32 block: the block's two windows (the last block of
an odd count computing its last window again and dropping the stores), x
read at the rolled token addresses, LN1 / O / H / LN2 stored by the
kernel's own address arithmetic into the 128-byte-swizzle K-major layout,
k into K's, v into the 64-byte-swizzle MN-major layout, every ``wgmma``
operand read back through its descriptor as the hardware reads it (start,
8-row group stride, the swizzle on the byte address), the ring filled
slab by slab from the packed stream (a head's qkv issued behind the head
before it, its slabs held until it completes), q and P carried as
``wgmma`` A register fragments, the accumulator layouts, the compact bias
table at
the tokens' offsets and the mask by its rule, y in registers with LN2's
statistics over the quad, the output staged in the LN buffer and copied
out a token row at a time. The packers, the bias and the mask rule are
checked on their own.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from s2sr_tpu_torch.ops import window_attention as wa
from torch_threads import one_torch_thread  # noqa: F401

WA_CU = Path(wa.__file__).resolve().parent.parent / "csrc" / "window_attention.cu"
C, HEADS, DP, WIN, N, HID = 180, 6, 32, 8, 64, 360
KBLK = N * 128                       # a K block of a 64-row A buffer
NBUF, SLAB = 6, 96 * 128
WO_WIN = NBUF * SLAB
W_LN, W_O, W_K, W_V, W_BYTES = 0, 3 * KBLK, 6 * KBLK, 7 * KBLK, 8 * KBLK
TABLE = (2 * WIN - 1) ** 2
X_IN_KV, X_TAIL = 45, 6848          # x staged over K and V, then a tail
WO_XT = WO_WIN + 2 * W_BYTES
EMU_BYTES = WO_XT + 2 * X_TAIL       # the ring, both windows, the tails

WARP = np.arange(4)[:, None]
LANE = np.arange(32)[None, :]
G, T = LANE >> 2, LANE & 3
R0 = 16 * WARP + G                   # a thread's accumulator rows (4, 32)
R1 = R0 + 8


def sw128(row, col):
    """The kernel's byte offset of bf16 (row, col < 64), 128-byte rows."""
    return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2


def sw64(row, col):
    """The kernel's byte offset of bf16 (row, col < 32), 64-byte rows."""
    return row * 64 + ((((col >> 3) ^ (row >> 1)) & 3) << 4) + (col & 7) * 2


def swizzle(addr, mode):
    """The hardware's swizzle of a byte address from a 1024-aligned base:
    bits 4.. XOR bits 7.. (three of them for 128 bytes, two for 64)."""
    return addr ^ (((addr >> 7) & (7 if mode == 128 else 3)) << 4)


def read_k128(mem, start, rows):
    """A K-major, 128-byte-swizzle operand by its descriptor (8-row groups
    1024 bytes apart): ``rows`` × 16 values from ``start``."""
    r, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    lin = start + (r // 8) * 1024 + (r % 8) * 128 + 2 * k
    return mem[swizzle(lin, 128) // 2]


def read_mn64(mem, start):
    """B MN-major, 64-byte swizzle (8-row groups along K 512 bytes apart,
    one 32-column atom): (16, 32) from ``start``."""
    k, n = np.arange(16)[:, None], np.arange(32)[None, :]
    lin = start + (k // 8) * 512 + (k % 8) * 64 + 2 * n
    return mem[swizzle(lin, 64) // 2]


def acc_index(na):
    """Rows and columns of accumulator element i of each thread (4, 32, na):
    n8 tile i // 4, row r0 (i % 4 < 2) or r1, column 8 (i // 4) + 2t + i % 2."""
    i = np.arange(na)[None, None, :]
    rows = np.where(i % 4 < 2, R0[..., None], R1[..., None])
    cols = 8 * (i // 4) + 2 * T[..., None] + (i & 1)
    return rows, np.broadcast_to(cols, rows.shape)


def frag_to_a(regs):
    """wgmma's A register fragments (4 warps, 32 lanes, 4 regs, 2) → the
    64 × 16 matrix: warp w's rows 16w + g (regs 0, 2) and + 8 (1, 3),
    columns 2t (+1), and + 8 in regs 2, 3."""
    a = np.full((64, 16), np.nan, np.float32)
    for r in range(4):
        for e in range(2):
            a[16 * WARP + G + 8 * (r & 1), 2 * T + 8 * (r >> 1) + e] = regs[:, :, r, e]
    return a


def sts(mem, addr, lo, hi):
    """A 32-bit shared store of two bf16 values (float32 here), per lane."""
    mem[addr // 2] = lo
    mem[addr // 2 + 1] = hi


def quad(v, op):
    """``op`` over the 4 lanes of each quad, back on every lane."""
    q = op(v.reshape(4, 8, 4), axis=2)
    return np.repeat(q, 4, axis=1)


class Ring:
    """The B ring as one consumer sees it: slab g is in slot g % 6 when
    the consumer waits for it, which needs its release of slab g − 6."""

    def __init__(self, mem, slabs):
        self.mem, self.slabs, self.released = mem, slabs, set()

    def wait(self, g):
        assert g < NBUF or g - NBUF in self.released, f"slab {g} before {g - NBUF} freed"
        at = (g % NBUF) * SLAB // 2
        self.mem[at:at + SLAB // 2] = self.slabs[g].reshape(-1)

    def release(self, g):
        assert g not in self.released
        self.released.add(g)


def gemm(acc, mem, abuf, ring, g0, ns):
    """``wg_gemm<ns>``: 12 k-steps of ``ns`` m64n96k16, A from ``abuf``'s K
    blocks, B from the slots of slabs g0 + ns (k // 4) + s (the
    accumulator's columns 96 s..), both at + (k % 4)·32."""
    rows, cols = acc_index(48)
    for k in range(12):
        g = g0 + ns * (k // 4)
        if k % 4 == 0:
            for s in range(ns):
                ring.wait(g + s)
        a = read_k128(mem, abuf + (k // 4) * KBLK + (k % 4) * 32, 64)
        for s in range(ns):
            b = read_k128(mem, ((g + s) % NBUF) * SLAB + (k % 4) * 32, 96)
            acc[..., 48 * s:48 * s + 48] += (a @ b.T)[rows, cols]
        if k % 4 == 0 and k > 0:
            for s in range(ns):
                ring.release(g - ns + s)
    for s in range(ns):
        ring.release(g0 + 2 * ns + s)


def issue(acc, mem, abuf, ring, g0):
    """``wg_issue``: the three slabs of a 96-column product waited for,
    then its 12 k-steps of m64n96k16 at once (released by the caller)."""
    rows, cols = acc_index(48)
    for s in range(3):
        ring.wait(g0 + s)
    for k in range(12):
        a = read_k128(mem, abuf + (k // 4) * KBLK + (k % 4) * 32, 64)
        b = read_k128(mem, ((g0 + k // 4) % NBUF) * SLAB + (k % 4) * 32, 96)
        acc += (a @ b.T)[rows, cols]


def release3(ring, g0):
    for s in range(3):
        ring.release(g0 + s)


def gelu32(v):
    return wa.gelu(torch.from_numpy(np.ascontiguousarray(v)), torch.float32).numpy()


def emulate_consumer(x, t, slabs, wg, win, windows, mlp, hshift, last_wy, out):
    """Consumer warpgroup ``wg`` on window ``win`` (the last window again
    where ``win`` is past the end, its stores dropped), writing ``out``."""
    bsz, H, W, _ = x.shape
    shift = t["shift"]
    valid = win < windows
    if not valid:
        win = windows - 1
    nwh, nww = H // WIN, W // WIN
    b, wy, wx = win // (nwh * nww), (win // nww) % nwh, win % nww
    lr, lc = shift > 0 and wy == last_wy, shift > 0 and wx == nww - 1
    flat = x.reshape(-1)

    def pix(r):
        gy = (wy * WIN + (r >> 3) + hshift) % H
        gx = (wx * WIN + (r & 7) + shift) % W
        return ((b * H + gy) * W + gx) * C

    mem = np.full(EMU_BYTES // 2, np.nan, np.float32)
    ring = Ring(mem, slabs)
    wbase = WO_WIN + wg * W_BYTES
    ln, ob, kb, vb = wbase + W_LN, wbase + W_O, wbase + W_K, wbase + W_V
    tb = t["bias_table"].T.reshape(-1)                 # [head][225]
    # x staged (over K and V, then the tail), LN1 from there: a row a warp,
    # lane pairs 2 lane + 64 k
    def x_stage(r):
        return (wbase + W_K + r * 2 * C if r < X_IN_KV
                else WO_XT + wg * X_TAIL + (r - X_IN_KV) * 2 * C)

    for r in range(N):
        mem[x_stage(r) // 2:][:C] = flat[pix(r):pix(r) + C]
    for r in range(N):
        v = mem[x_stage(r) // 2:][:C].copy()
        mean = v.sum(dtype=np.float32) / np.float32(C)
        rstd = 1 / np.sqrt(((v - mean) ** 2).sum() / C + 1e-5)
        o = np.concatenate([(v - mean) * rstd * t["g1"] + t["b1"], np.zeros(12)])
        lanes = LANE[0]
        for k in range(3):
            c = 2 * lanes + 64 * k
            sts(mem, ln + k * KBLK + sw128(r, 2 * lanes), o[c], o[c + 1])
    rows96, cols96 = acc_index(96)
    rows32, cols32 = acc_index(32)
    rows16, cols16 = acc_index(16)

    def epilogue(acc, h):
        """``qkv_epilogue``: q into A fragments, k into K's half h % 2, v
        into V buffer h % 2."""
        qa = np.full((2, 4, 32, 4, 2), np.nan, np.float32)
        par = h & 1
        for j in range(12):
            n = 96 * h + 8 * j + 2 * T
            c0, c1 = t["bqkv"][n], t["bqkv"][n + 1]
            lo = (acc[..., 4 * j] + c0, acc[..., 4 * j + 1] + c1)
            hi = (acc[..., 4 * j + 2] + c0, acc[..., 4 * j + 3] + c1)
            if j < 4:
                qa[j >> 1, :, :, 2 * (j & 1)] = np.stack(lo, -1)
                qa[j >> 1, :, :, 2 * (j & 1) + 1] = np.stack(hi, -1)
            elif j < 8:
                d = 32 * par + 8 * (j - 4) + 2 * T
                sts(mem, kb + sw128(R0, d), *lo)
                sts(mem, kb + sw128(R1, d), *hi)
            else:
                d = 8 * (j - 8) + 2 * T
                sts(mem, vb + par * N * 64 + sw64(R0, d), *lo)
                sts(mem, vb + par * N * 64 + sw64(R1, d), *hi)
        return qa

    acc = np.zeros((4, 32, 48), np.float32)
    issue(acc, mem, ln, ring, 0)
    release3(ring, 0)
    qa = epilogue(acc, 0)
    for h in range(HEADS):
        par = h & 1
        sc = np.zeros((4, 32, 32), np.float32)
        for s in range(2):
            a = frag_to_a(qa[s])
            sc += (a @ read_k128(mem, kb + 64 * par + 32 * s, 64).T)[rows32, cols32]
        if h + 1 < HEADS:
            acc = np.zeros((4, 32, 48), np.float32)
            issue(acc, mem, ln, ring, 3 * (h + 1))
        edge = WIN - shift
        for n in range(8):
            for e in range(4):
                yi, xi = 2 * WARP + (e >> 1), G
                yj, xj = n, 2 * T + (e & 1)
                idx = (yi - yj + WIN - 1) * (2 * WIN - 1) + xi - xj + WIN - 1
                v = sc[..., 4 * n + e] + tb[h * TABLE + idx]
                if shift > 0:
                    apart = ((lr & ((yi >= edge) != (yj >= edge)))
                             | (lc & ((xi >= edge) != (xj >= edge))))
                    v = v + np.where(apart, np.float32(-100), np.float32(0))
                sc[..., 4 * n + e] = v
        half = [sc[..., [4 * n + e for n in range(8) for e in (2 * r, 2 * r + 1)]]
                for r in range(2)]
        mx = [quad(h_.max(-1), np.max)[..., None] for h_ in half]
        for n in range(8):
            for e in range(4):
                sc[..., 4 * n + e] = np.exp(sc[..., 4 * n + e] - mx[e >> 1][..., 0])
        inv = [1 / quad(sc[..., [4 * n + e for n in range(8) for e in (2 * r, 2 * r + 1)]]
                        .sum(-1), np.sum) for r in range(2)]
        pa = np.empty((4, 4, 32, 4, 2), np.float32)
        for s in range(4):
            for r in range(4):
                tile, row = 2 * s + (r >> 1), r & 1
                for e in range(2):
                    pa[s, :, :, r, e] = sc[..., 4 * tile + 2 * row + e] * inv[row]
        oa = np.zeros((4, 32, 16), np.float32)
        for s in range(4):
            oa += (frag_to_a(pa[s]) @ read_mn64(mem, vb + par * N * 64 + 1024 * s)
                   )[rows16, cols16]
        if h + 1 < HEADS:
            release3(ring, 3 * (h + 1))
        for d in range(4):
            col = 32 * par + 8 * d + 2 * T
            sts(mem, ob + (h >> 1) * KBLK + sw128(R0, col), oa[..., 4 * d], oa[..., 4 * d + 1])
            sts(mem, ob + (h >> 1) * KBLK + sw128(R1, col), oa[..., 4 * d + 2],
                oa[..., 4 * d + 3])
        if h + 1 < HEADS:
            qa = epilogue(acc, h + 1)

    y = np.zeros((4, 32, 96), np.float32)
    gemm(y, mem, ob, ring, 18, 2)
    res = {}
    if not mlp:
        for j in range(24):
            col = 8 * j + 2 * T
            for e in range(4):
                res[(j, e)] = y[..., 4 * j + e] + t["bo"][np.minimum(col + (e & 1), 191)]
    else:
        # x again, copied into the LN buffer while proj runs (360 bytes a
        # token), read at the accumulator's rows and columns
        for r in range(N):
            mem[(ln + r * 2 * C) // 2:][:C] = flat[pix(r):pix(r) + C]
        xv = mem[(ln + rows96 * 2 * C + 2 * np.minimum(cols96, C - 1)) // 2]
        ok = (cols96 < C)
        y = np.where(ok, (xv + y)
                     + t["bo"][np.minimum(cols96, C - 1)], 0).astype(np.float32)
        stats = []
        for r in range(2):
            sel = [4 * j + e for j in range(24) for e in (2 * r, 2 * r + 1)]
            v, m = y[..., sel], ok[..., sel]
            mean = quad(np.where(m, v, 0).sum(-1), np.sum) / np.float32(C)
            var = quad(np.where(m, (v - mean[..., None]) ** 2, 0).sum(-1), np.sum) / C
            stats.append((mean, 1 / np.sqrt(var + 1e-5)))
        for j in range(24):
            col = 8 * j + 2 * T
            cc = np.minimum(col, C - 2)
            o = []
            for r in range(2):
                mean, rstd = stats[r]
                o.append(tuple(np.where(col < C, (y[..., 4 * j + 2 * r + e] - mean) * rstd
                                        * t["g2"][cc + e] + t["b2"][cc + e], 0)
                               for e in range(2)))
            sts(mem, ln + (j >> 3) * KBLK + sw128(R0, col & 63), *o[0])
            sts(mem, ln + (j >> 3) * KBLK + sw128(R1, col & 63), *o[1])
        for h in range(2):
            for q in range(2):
                f = np.zeros((4, 32, 48), np.float32)
                gemm(f, mem, ln, ring, 24 + 12 * h + 3 * q, 1)
                for j in range(12):
                    col = 96 * q + 8 * j + 2 * T
                    n = 192 * h + col
                    v = [gelu32(f[..., 4 * j + k] + t["bf1"][n + (k & 1)]) for k in range(4)]
                    sts(mem, ob + (col >> 6) * KBLK + sw128(R0, col & 63), v[0], v[1])
                    sts(mem, ob + (col >> 6) * KBLK + sw128(R1, col & 63), v[2], v[3])
            gemm(y, mem, ob, ring, 24 + 12 * h + 6, 2)
        for j in range(24):
            col = 8 * j + 2 * T
            for e in range(4):
                res[(j, e)] = y[..., 4 * j + e] + t["bf2"][np.minimum(col + (e & 1), 191)]
    assert ring.released == set(range(48 if mlp else 24))
    # ``wg_store``: staged in the LN buffer, 360 bytes a token, then copied
    # out a token row at a time in 8-byte pieces
    for (j, e), v in res.items():
        row = R0 if e < 2 else R1
        col = 8 * j + 2 * T + (e & 1)
        ok = np.broadcast_to(col < C, row.shape)
        at = (ln + row * 2 * C + 2 * col) // 2
        mem[at[ok]] = v[ok]
    if not valid:
        return
    for r in range(N):
        for c in range(C // 4):
            src = (ln + r * 2 * C + 8 * c) // 2
            at = pix(r) + 4 * c
            assert np.isnan(out[at:at + 4]).all(), "a token written twice"
            out[at:at + 4] = mem[src:src + 4]


def block_windows(windows):
    """The (block, consumer, window, stores) the kernel's grid runs."""
    runs = []
    for blk in range(-(-windows // 2)):
        for wg in range(2):
            win = 2 * blk + wg
            runs.append((blk, wg, min(win, windows - 1), win < windows))
    return runs


def emulate(x, t, slabs, mlp, rolled=False, last=True):
    bsz, h, w, _ = x.shape
    windows = bsz * (h // WIN) * (w // WIN)
    hshift = 0 if rolled else t["shift"]
    last_wy = h // WIN - 1 if (last or not rolled) else -1
    out = np.full(x.size, np.nan, np.float32)
    for blk, wg, _, _ in block_windows(windows):
        emulate_consumer(x, t, slabs, wg, 2 * blk + wg, windows, mlp, hshift,
                         last_wy, out)
    assert not np.isnan(out).any(), "a token never written"
    return out.reshape(x.shape)


def block_weights(seed):
    """One block's weights under the checkpoint's names, block-test scales
    (``chip_smoke.py``'s ``swin_inputs``)."""
    g = torch.Generator().manual_seed(seed)

    def n(*size, s=1.0):
        return torch.randn(*size, generator=g) * s

    return {"norm1.weight": 1 + n(C, s=0.1), "norm1.bias": n(C, s=0.05),
            "attn.qkv.weight": n(3 * C, C, s=0.05),
            "attn.qkv.bias": n(3 * C, s=0.02),
            "attn.proj.weight": n(C, C, s=0.05), "attn.proj.bias": n(C, s=0.02),
            "attn.relative_position_bias_table": n(TABLE, HEADS, s=0.5),
            "norm2.weight": 1 + n(C, s=0.1), "norm2.bias": n(C, s=0.05),
            "mlp.fc1.weight": n(HID, C, s=0.03), "mlp.fc1.bias": n(HID, s=0.02),
            "mlp.fc2.weight": n(C, HID, s=0.03), "mlp.fc2.bias": n(C, s=0.02)}


# (shape, shift, rolled, last): even and odd window counts, B = 2 with
# pairs across the images, a band of H above the last and the last band
CASES = [((1, 16, 24), 0, False, True), ((1, 16, 24), 4, False, True),
         ((1, 24, 8), 4, False, True), ((2, 24, 8), 4, False, True),
         ((1, 16, 16), 4, True, False), ((1, 16, 16), 4, True, True)]


@pytest.mark.parametrize("mlp", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-s{c[1]}-r{int(c[2])}{int(c[3])}")
def test_wg_kernel_emulation_matches_reference(case, mlp):
    """The emulated kernel, fed fp32 tables packed as the bf16 ones are,
    equals the fp32 plain version within 1e-5."""
    shape, shift, rolled, last = case
    t32 = wa.build_block_tables(block_weights(shift + 2 * mlp), HEADS, WIN, shift,
                                torch.float32)
    slabs = wa.pack_wg_slabs(t32).numpy()
    t = {k: v.numpy() if torch.is_tensor(v) else v for k, v in t32.items()}
    x = np.random.default_rng(shift + 7 * len(shape)).normal(
        size=(*shape, C)).astype(np.float32) * 0.5
    got = emulate(x, t, slabs, mlp, rolled, last)
    ref = wa.swin_block_reference if mlp else wa.window_attention_reference
    want = ref(torch.from_numpy(x), t32, rolled, last).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_wg_slab_index_is_a_permutation():
    """Every element of the four matrices in the stream once; the rest are
    the K pads."""
    idx = wa.wg_slab_index()
    total = sum(k * n for k, n in wa.WG_MATRICES.values())
    assert idx.numel() == 48 * 96 * 64
    held = idx[idx >= 0]
    assert held.numel() == total
    assert torch.equal(held.sort().values, torch.arange(total))
    # pads: qkv and fc1 K 180..191, fc2 K 360..383 (4 * 12 + 2 * 12 + 24 rows)
    assert (idx < 0).sum().item() == 192 * (3 * 12 + 2 * 12 + 24)


def unpack_slabs(slabs):
    """The four (K padded, N) matrices from the stream, read as the kernel's
    descriptor reads a slab: row n, physical chunk p is logical chunk
    p ^ (n % 8) of K rows k0 + 8 (p ^ (n % 8)) ..."""
    kpad = {"wqkv": 192, "wo": 192, "w1": 192, "w2": 384}
    mats = {k: torch.full((kpad[k], n), float("nan")) for k, (_, n) in wa.WG_MATRICES.items()}
    for s, (name, k0, n0) in enumerate(wa.wg_slab_plan()):
        for n in range(96):
            for p in range(8):
                c = p ^ (n % 8)
                mats[name][k0 + 8 * c:k0 + 8 * c + 8, n0 + n] = slabs[s, n, 8 * p:8 * p + 8]
    return mats


def test_wg_slabs_unpack_to_the_matrices():
    """The bf16 tables carry the slabs; read back slab by slab they are
    the matrices, K pads zero, no element missing."""
    t = wa.build_block_tables(block_weights(3), HEADS, WIN, 4, torch.bfloat16)
    s = t["wg_slabs"]
    assert s.dtype == torch.bfloat16 and tuple(s.shape) == (48, 96, 64)
    assert s.is_contiguous()
    mats = unpack_slabs(s.float())
    for name, m in mats.items():
        k = wa.WG_MATRICES[name][0]
        assert torch.equal(m[:k], t[name].float()), name
        assert not m[k:].isnan().any() and not m[k:].any(), name
    # window_attention's 24 slabs are the stream's first 24
    assert [p[0] for p in wa.wg_slab_plan()[:24]] == ["wqkv"] * 18 + ["wo"] * 6
    t32 = wa.build_block_tables(block_weights(3), HEADS, WIN, 4, torch.float32)
    assert "wg_slabs" not in t32 and tuple(t32["bias_table"].shape) == (TABLE, HEADS)


@pytest.mark.parametrize("shift", [0, 4])
def test_compact_bias_and_mask_rule_are_the_tables(shift):
    """The kernel's bias (the compact table at (yi − yj + 7)·15 + xi − xj + 7)
    and its mask rule (last row: rows on the two sides of 8 − shift apart;
    last column: columns) equal ``build_block_tables``' dense ``bias`` and
    ``masks``, bit for bit, for every head and window type."""
    t = wa.build_block_tables(block_weights(5), HEADS, WIN, shift, torch.float32)
    table = t["bias_table"]
    i, j = torch.arange(N)[:, None], torch.arange(N)[None, :]
    yi, xi, yj, xj = i // WIN, i % WIN, j // WIN, j % WIN
    idx = (yi - yj + WIN - 1) * (2 * WIN - 1) + xi - xj + WIN - 1
    bias = table[idx].permute(2, 0, 1)
    assert torch.equal(bias, t["bias"])
    edge = WIN - shift
    for typ in range(4):
        lr, lc = shift > 0 and typ >= 2, shift > 0 and typ % 2 == 1
        apart = ((lr & ((yi >= edge) != (yj >= edge)))
                 | (lc & ((xi >= edge) != (xj >= edge))))
        mask = torch.where(apart, torch.tensor(-100.0), torch.tensor(0.0))
        assert torch.equal(mask, t["masks"][typ]), typ
        assert mask.dtype == t["masks"].dtype


@pytest.mark.parametrize("windows", list(range(1, 10)))
def test_pairing_covers_every_window_once(windows):
    """Two windows a block: every window stores once; an odd count's last
    block computes its last window again on its second consumer, which
    stores nothing."""
    runs = block_windows(windows)
    assert len(runs) == 2 * (-(-windows // 2))
    stored = [win for _, _, win, st in runs if st]
    assert sorted(stored) == list(range(windows))
    dropped = [(blk, wg, win) for blk, wg, win, st in runs if not st]
    assert dropped == ([] if windows % 2 == 0 else
                       [(windows // 2, 1, windows - 1)])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Design names, the bf16-only designs, no_l2 without the MLP and on
    the CPU, and the served kernel's two tables (slabs, compact bias)
    missing or of the wrong type or shape."""
    t = wa.build_block_tables(block_weights(9), HEADS, WIN, 4, torch.bfloat16)
    x = torch.zeros(1, 8, 8, C, dtype=torch.bfloat16)
    wa._check("swin_block", x, t)
    wa._check_design("swin_block", x, True, "served")
    wa._check_design("swin_block", x, True, "no_l2")
    with pytest.raises(ValueError, match="design"):
        wa._check_design("swin_block", x, True, "fast")
    with pytest.raises(ValueError, match="swin_block only"):
        wa._check_design("window_attention", x, False, "no_l2")
    with pytest.raises(TypeError, match="bfloat16 kernel"):
        wa._check_design("swin_block", x.float(), True, "mma")
    with pytest.raises(ValueError, match="no plain version"):
        wa.swin_block(x, t, design="no_l2")
    with pytest.raises(ValueError, match="wg_slabs missing"):
        wa._check("swin_block", x, {k: v for k, v in t.items() if k != "wg_slabs"})
    with pytest.raises(ValueError, match="wg_slabs"):
        wa._check("swin_block", x, {**t, "wg_slabs": t["wg_slabs"].float()})
    with pytest.raises(ValueError, match="bias_table"):
        wa._check("swin_block", x, {**t, "bias_table": t["bias_table"][:224]})
    with pytest.raises(RuntimeError, match="unsupported device"):
        wa._launch("swin_block", x, t, True)


def test_shared_memory_plan_is_the_kernel_note():
    """``wg_smem_plan`` adds up to the kernel's WG_SMEM (asserted in the
    source), within a block's 232,448 bytes, with no room for one more
    slot."""
    plan = wa.wg_smem_plan()
    src = WA_CU.read_text()
    m = re.search(r"WG_SMEM == (\d+)", src)
    assert m and int(m.group(1)) == plan["total"] == 225016
    assert plan["total"] <= 232448 < plan["total"] + wa.RING_SLOT_BYTES
    assert plan["ring"] == NBUF * SLAB and plan["windows"] == 2 * W_BYTES
