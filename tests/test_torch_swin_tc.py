"""The bf16 tensor-core Swin kernel's data movement (``csrc/window_attention.cu``,
``swin_tc_kernel``), emulated in NumPy at the kernel's widths (C 180, 6
heads, window 8, MLP 360) and held to the port's plain versions.

The kernel itself runs only on the card (``chip_smoke.py``, phase
``swin_kernel``). Here every address it computes is followed in NumPy, in
float32 so that the result is the fp32 block: x staged by 8-byte copies
at the rolled token addresses, the swizzled bf16 buffers, the per-lane
``ldmatrix`` (and ``.trans``) row addresses, the packed B fragments, the
accumulator layouts of the q/k/v, score, P and O registers with the
in-register softmax across a quad, and the epilogues' stores. The packers
are checked against the tables on their own.
"""

import numpy as np
import pytest
import torch

from s2sr_tpu_torch.ops import window_attention as wa
from torch_threads import one_torch_thread  # noqa: F401

C, HEADS, DP, WIN, N = 180, 6, 32, 8, 64
CP, HP, QKV_N = 192, 384, 576
AK = CP // 8                                  # 16-byte chunks a row
TB_Y, TB_LN = 0, N * C * 4
TB_KV = TB_LN + N * CP * 2
KV_HEAD = 2 * N * DP * 2
TB_O = TB_KV + 2 * KV_HEAD
TB_H = TB_KV
TC_SMEM = TB_O + N * CP * 2
STAGE_ROW = C * 2

L = np.arange(32)
G, T = L >> 2, L & 3


def swz(q):
    return q ^ ((q >> 3) & 7)


def elem(base, row, col, chunks):
    """Byte address of bf16 element (row, col) of a swizzled buffer."""
    return base + swz(row * chunks + (col >> 3)) * 16 + (col & 7) * 2


def ldsm(mem, addr, trans=False):
    """ldmatrix.x4 from per-lane row addresses (bytes): regs (32, 4, 2),
    register i of lane T from matrix i (the rows lanes 8i..8i+7 point at):
    row T/4, columns 2(T%4), +1; with ``trans`` row 2(T%4) (+1), column
    T/4."""
    rows = mem[(addr // 2)[:, None] + np.arange(8)]          # (32, 8)
    out = np.empty((32, 4, 2), np.float32)
    for i in range(4):
        for e in range(2):
            if trans:
                out[:, i, e] = rows[8 * i + 2 * T + e, G]
            else:
                out[:, i, e] = rows[8 * i + G, 2 * T + e]
    return out


def frag_a(a):
    """m16k16 A fragment registers (32, 4, 2) → the 16×16 matrix."""
    m = np.empty((16, 16), np.float32)
    for r in range(4):
        for e in range(2):
            m[G + 8 * (r & 1), 2 * T + 8 * (r >> 1) + e] = a[:, r, e]
    return m


def frag_b(b):
    """k16n8 B fragment registers (32, 2, 2) → the 16×8 matrix."""
    m = np.empty((16, 8), np.float32)
    for r in range(2):
        for e in range(2):
            m[2 * T + e + 8 * r, G] = b[:, r, e]
    return m


def mma(acc, a, b):
    """acc (32, 4): the m16n8 accumulator, row g (e 0, 1) / g + 8 (e 2,
    3), column 2t + e % 2."""
    d = frag_a(a) @ frag_b(b)
    for e in range(4):
        acc[:, e] += d[G + 8 * (e >> 1), 2 * T + (e & 1)]


def warp_gemm(mem, abuf, mt0, mtiles, frags, n0, ntiles, slab0, ks):
    """``warp_gemm``: acc[m][j] over k16 slabs of A (rows 16(mt0 + m)..)
    and the packed B fragments ``frags`` (slabs, n8 tiles, 32, 4), n8 tiles
    n0.. from slab slab0."""
    acc = np.zeros((mtiles, ntiles, 32, 4), np.float32)
    for s in range(ks):
        b = frags[slab0 + s, n0:n0 + ntiles].reshape(ntiles, 32, 2, 2)
        for m in range(mtiles):
            row = 16 * (mt0 + m) + (L & 15)
            a = ldsm(mem, abuf + swz(row * AK + 2 * s + (L >> 4)) * 16)
            for j in range(ntiles):
                mma(acc[m, j], a, b[j])
    return acc


def store2(mem, addr, lo, hi):
    """A 32-bit shared store of two bf16 values (float32 here)."""
    mem[addr // 2] = lo
    mem[addr // 2 + 1] = hi


def layer_norm(mem, y, src, g, b):
    """``tc_layer_norm``: rows r, column pairs 2 lane + 64k; ``src`` (64,
    180) float32 already read from the staging or Y."""
    for r in range(N):
        v = src[r]
        mean = v.sum(dtype=np.float32) / np.float32(C)
        rstd = 1 / np.sqrt(((v - mean) ** 2).sum() / C + 1e-5)
        out = (v - mean) * rstd * g + b
        for k in range(3):
            c = 2 * L + 64 * k
            ok = c < C
            cc = np.minimum(c, C - 2)
            store2(mem, elem(TB_LN, r, c, AK), np.where(ok, out[cc], 0),
                   np.where(ok, out[cc + 1], 0))


def emulate_window(x, t, frag, win, mlp):
    """One block of ``swin_tc_kernel`` on window ``win`` of the NHWC map
    ``x`` (float32), writing into ``out`` and returning it."""
    bsz, h, w, _ = x.shape
    nwh, nww, shift = h // WIN, w // WIN, t["shift"]
    b, wy, wx = win // (nwh * nww), (win // nww) % nwh, win % nww
    flat = x.reshape(-1)
    mask = (t["masks"][2 * (wy == nwh - 1) + (wx == nww - 1)]
            if shift else None)

    def pix(r):
        gy = (wy * WIN + (r >> 3) + shift) % h
        gx = (wx * WIN + (r & 7) + shift) % w
        return ((b * h + gy) * w + gx) * C

    mem = np.full(TC_SMEM // 2, np.nan, np.float32)
    # x: 45 8-byte copies a token into O, raw
    for r in range(N):
        for c in range(C // 4):
            dst = (TB_O + r * STAGE_ROW + 8 * c) // 2
            mem[dst:dst + 4] = flat[pix(r) + 4 * c:pix(r) + 4 * c + 4]
    stage = np.stack([mem[(TB_O + r * STAGE_ROW) // 2:][:C] for r in range(N)])
    y = stage.copy()                                         # Y, float32
    layer_norm(mem, y, stage, t["g1"], t["b1"])

    for hp in range(HEADS // 2):
        qa = {}
        for warp in range(8):
            hw, mt = warp >> 2, warp & 3
            head = 2 * hp + hw
            i0 = 16 * mt + G
            kbuf = TB_KV + hw * KV_HEAD
            vbuf = kbuf + N * DP * 2
            acc = warp_gemm(mem, TB_LN, mt, 1, frag["wqkv_mma"], head * 12,
                            12, 0, 12)[0]
            regs = np.empty((2, 32, 4, 2), np.float32)
            for j in range(12):
                n = head * 3 * DP + 8 * j + 2 * T
                c0, c1 = t["bqkv"][n], t["bqkv"][n + 1]
                lo = np.stack([acc[j][:, 0] + c0, acc[j][:, 1] + c1], 1)
                hi = np.stack([acc[j][:, 2] + c0, acc[j][:, 3] + c1], 1)
                if j < 4:
                    regs[j >> 1][:, 2 * (j & 1)] = lo
                    regs[j >> 1][:, 2 * (j & 1) + 1] = hi
                else:
                    buf = kbuf if j < 8 else vbuf
                    d = 8 * (j & 3) + 2 * T
                    store2(mem, elem(buf, i0, d, DP // 8), lo[:, 0], lo[:, 1])
                    store2(mem, elem(buf, i0 + 8, d, DP // 8), hi[:, 0],
                           hi[:, 1])
            qa[warp] = regs
        # __syncthreads
        for warp in range(8):
            hw, mt = warp >> 2, warp & 3
            head = 2 * hp + hw
            i0 = 16 * mt + G
            kbuf = TB_KV + hw * KV_HEAD
            vbuf = kbuf + N * DP * 2
            sc = np.zeros((8, 32, 4), np.float32)
            for n in range(8):
                kb = ldsm(mem, kbuf + swz((8 * n + (L & 7)) * (DP // 8)
                                          + (L >> 3)) * 16)
                mma(sc[n], qa[warp][0], kb[:, 0:2])
                mma(sc[n], qa[warp][1], kb[:, 2:4])
            for n in range(8):
                j = 8 * n + 2 * T
                for e in range(4):
                    i = i0 + 8 * (e >> 1)
                    sc[n][:, e] += t["bias"][head][i, j + (e & 1)]
                    if mask is not None:
                        sc[n][:, e] += mask[i, j + (e & 1)]
            # row max and sum over the lane's 16 values, then its quad
            quad = (L[:, None] & ~3) + np.arange(4)            # (32, 4)
            mx = [np.max(sc[:, :, 2 * r:2 * r + 2], (0, 2)) for r in range(2)]
            mx = [m[quad].max(1) for m in mx]
            for r in range(2):
                sc[:, :, 2 * r:2 * r + 2] = np.exp(
                    sc[:, :, 2 * r:2 * r + 2] - mx[r][None, :, None])
            sm = [sc[:, :, 2 * r:2 * r + 2].sum((0, 2)) for r in range(2)]
            sm = [s_[quad].sum(1) for s_ in sm]
            p = sc.copy()
            for r in range(2):
                p[:, :, 2 * r:2 * r + 2] /= sm[r][None, :, None]
            oa = np.zeros((4, 32, 4), np.float32)
            for s in range(4):
                pa = np.empty((32, 4, 2), np.float32)
                pa[:, 0] = p[2 * s][:, 0:2]
                pa[:, 1] = p[2 * s][:, 2:4]
                pa[:, 2] = p[2 * s + 1][:, 0:2]
                pa[:, 3] = p[2 * s + 1][:, 2:4]
                for d in (0, 2):
                    i = L >> 3
                    vb = ldsm(mem, vbuf + swz((16 * s + 8 * (i & 1) + (L & 7))
                                              * (DP // 8) + d + (i >> 1)) * 16,
                              trans=True)
                    mma(oa[d], pa, vb[:, 0:2])
                    mma(oa[d + 1], pa, vb[:, 2:4])
            for d in range(4):
                col = head * DP + 8 * d + 2 * T
                store2(mem, elem(TB_O, i0, col, AK), oa[d][:, 0], oa[d][:, 1])
                store2(mem, elem(TB_O, i0 + 8, col, AK), oa[d][:, 2],
                       oa[d][:, 3])
        # __syncthreads

    out = np.full((N, C), np.nan, np.float32)

    def epilogue(acc, mp, nq, fn):
        """fn(rows, cols, v0, v1) per (M tile, n8 tile, row half), for the
        32 lanes at once: lane (g, t) holds row g (+8), columns 2t, 2t+1."""
        for m in range(2):
            for j in range(6):
                for hh in range(2):
                    row = 16 * (2 * mp + m) + G + 8 * hh
                    col = 8 * (nq * 6 + j) + 2 * T
                    fn(row, col, acc[m, j][:, 2 * hh], acc[m, j][:, 2 * hh + 1])

    def proj_epi(row, col, v0, v1):
        ok = col < C
        row, col, v0, v1 = row[ok], col[ok], v0[ok], v1[ok]
        bo = t["bo"]
        if mlp:
            y[row, col] = y[row, col] + v0 + bo[col]
            y[row, col + 1] = y[row, col + 1] + v1 + bo[col + 1]
        else:
            out[row, col] = v0 + bo[col]
            out[row, col + 1] = v1 + bo[col + 1]

    for warp in range(8):
        mp, nq = warp & 1, warp >> 1
        acc = warp_gemm(mem, TB_O, 2 * mp, 2, frag["wo_mma"], nq * 6, 6, 0, 12)
        epilogue(acc, mp, nq, proj_epi)
    if mlp:
        layer_norm(mem, y, y.copy(), t["g2"], t["b2"])
        for half in range(2):
            for warp in range(8):
                mp, nq = warp & 1, warp >> 1
                acc = warp_gemm(mem, TB_LN, 2 * mp, 2, frag["w1_mma"],
                                24 * half + nq * 6, 6, 0, 12)

                def fc1_epi(row, col, v0, v1):
                    n = CP * half + col
                    hid = torch.from_numpy(np.stack([v0 + t["bf1"][n],
                                                     v1 + t["bf1"][n + 1]]))
                    g0, g1 = wa.gelu(hid, torch.float32).numpy()
                    store2(mem, elem(TB_H, row, col, AK), g0, g1)

                epilogue(acc, mp, nq, fc1_epi)
            for warp in range(8):
                mp, nq = warp & 1, warp >> 1
                acc = warp_gemm(mem, TB_H, 2 * mp, 2, frag["w2_mma"], nq * 6,
                                6, 12 * half, 12)

                def fc2_epi(row, col, v0, v1):
                    ok = col < C
                    row, col, v0, v1 = row[ok], col[ok], v0[ok], v1[ok]
                    if half == 0:
                        y[row, col] += v0
                        y[row, col + 1] += v1
                    else:
                        out[row, col] = y[row, col] + (v0 + t["bf2"][col])
                        out[row, col + 1] = (y[row, col + 1]
                                             + (v1 + t["bf2"][col + 1]))

                epilogue(acc, mp, nq, fc2_epi)
    res = np.full_like(flat, np.nan)
    for r in range(N):
        res[pix(r):pix(r) + C] = out[r]
    return res


def emulate(x, t, frag, mlp):
    bsz, h, w, _ = x.shape
    got = np.full(x.size, np.nan, np.float32)
    for win in range(bsz * (h // WIN) * (w // WIN)):
        res = emulate_window(x, t, frag, win, mlp)
        done = ~np.isnan(res)
        assert not (done & ~np.isnan(got)).any(), "a token written twice"
        got[done] = res[done]
    return got.reshape(x.shape)


def block_weights(seed):
    """One block's weights under the checkpoint's names, block-test
    scales (``chip_smoke.py``'s ``swin_inputs``)."""
    g = torch.Generator().manual_seed(seed)

    def n(*size, s=1.0):
        return torch.randn(*size, generator=g) * s

    return {"norm1.weight": 1 + n(C, s=0.1), "norm1.bias": n(C, s=0.05),
            "attn.qkv.weight": n(3 * C, C, s=0.05),
            "attn.qkv.bias": n(3 * C, s=0.02),
            "attn.proj.weight": n(C, C, s=0.05), "attn.proj.bias": n(C, s=0.02),
            "attn.relative_position_bias_table": n(225, 6, s=0.5),
            "norm2.weight": 1 + n(C, s=0.1), "norm2.bias": n(C, s=0.05),
            "mlp.fc1.weight": n(360, C, s=0.03), "mlp.fc1.bias": n(360, s=0.02),
            "mlp.fc2.weight": n(C, 360, s=0.03), "mlp.fc2.bias": n(C, s=0.02)}


KPAD = {"wqkv": CP, "wo": HEADS * DP, "w1": CP, "w2": HP}


def pack_f32(w: np.ndarray, kpad: int) -> np.ndarray:
    """``pack_mma_b`` in float32: the same index map, no rounding."""
    wp = np.zeros((kpad, w.shape[1]), np.float32)
    wp[:w.shape[0]] = w
    idx = wa.mma_b_index(kpad, w.shape[1]).numpy()
    return wp.reshape(-1)[idx].reshape(kpad // 16, w.shape[1] // 8, 32, 4)


def unpack(f: torch.Tensor) -> torch.Tensor:
    """The (kpad, N) matrix of packed B fragments, read back as the mma
    reads them: lane 4g + t's values (a, e) are row 8a + 2t + e of column
    g of their k16 slab and n8 tile."""
    ks, nt = f.shape[:2]
    return (f.reshape(ks, nt, 8, 4, 2, 2).permute(0, 4, 3, 5, 1, 2)
            .reshape(16 * ks, 8 * nt))


@pytest.mark.parametrize("mlp", [True, False])
@pytest.mark.parametrize("shift", [0, 4])
def test_tc_kernel_emulation_matches_reference(shift, mlp):
    """Two windows of (1, 8, 16), shifted (mask types 2 and 3) or not: the
    emulated kernel, with the fp32 tables packed as the bf16 ones are,
    equals the fp32 plain version."""
    t = {k: v.numpy() if torch.is_tensor(v) else v
         for k, v in wa.build_block_tables(block_weights(shift + mlp), HEADS,
                                           WIN, shift, torch.float32).items()}
    frag = {key: pack_f32(t[name], KPAD[name])
            for key, name in wa.MMA_KEYS.items()}
    x = np.random.default_rng(shift).normal(size=(1, 8, 16, C)).astype(
        np.float32) * 0.5
    got = emulate(x, t, frag, mlp)
    tt = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in t.items()}
    ref = wa.swin_block_reference if mlp else wa.window_attention_reference
    want = ref(torch.from_numpy(x), tt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("key", list(wa.MMA_KEYS))
def test_mma_b_index_is_a_permutation(key):
    name = wa.MMA_KEYS[key]
    shape = {"wqkv": (C, QKV_N), "wo": (CP, CP), "w1": (C, HP),
             "w2": (360, CP)}[name]
    kpad, n = KPAD[name], shape[1]
    idx = wa.mma_b_index(kpad, n)
    assert sorted(idx.tolist()) == list(range(kpad * n))
    # slab 0, n8 tile 0, lane 4g + t: rows 2t, 2t+1, 2t+8, 2t+9 of column g
    g, t = 5, 3
    want = [r * n + g for r in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
    assert idx[(4 * g + t) * 4:][:4].tolist() == want


def test_bf16_tables_carry_the_packed_fragments():
    """build_block_tables adds each matrix's B fragments for bf16 (and
    only there); they unpack to the table, padded K rows zero."""
    p = block_weights(7)
    t = wa.build_block_tables(p, HEADS, WIN, 4, torch.bfloat16)
    for key, name in wa.MMA_KEYS.items():
        f = t[key]
        assert f.dtype == torch.bfloat16 and f.is_contiguous()
        assert tuple(f.shape) == wa._MMA_SHAPES[key]
        m = unpack(f)
        k = t[name].shape[0]
        assert torch.equal(m[:k], t[name])
        assert not m[k:].any()
    t32 = wa.build_block_tables(p, HEADS, WIN, 4, torch.float32)
    assert not set(wa.MMA_KEYS) & set(t32)
    # the launch check wants them for bf16 input
    x = torch.zeros(1, 8, 8, C, dtype=torch.bfloat16)
    wa._check("swin_block", x, t)
    with pytest.raises(ValueError, match="wo_mma missing"):
        wa._check("swin_block", x, {k: v for k, v in t.items()
                                    if k != "wo_mma"})
    bad = {**t, "w1_mma": t["w1_mma"].float()}
    with pytest.raises(ValueError, match="w1_mma"):
        wa._check("swin_block", x, bad)


def test_launch_check_refuses_a_misaligned_input():
    """The kernel copies x in 8-byte pieces and stores pairs of bf16: a
    view that starts off a 16-byte boundary is refused before launch."""
    t = wa.build_block_tables(block_weights(8), HEADS, WIN, 0, torch.bfloat16)
    flat = torch.zeros(8 * 8 * C + 1, dtype=torch.bfloat16)
    x = flat[1:].view(1, 8, 8, C)
    assert x.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        wa._check("swin_block", x, t)
    wa._check("swin_block", flat[:-1].view(1, 8, 8, C), t)
