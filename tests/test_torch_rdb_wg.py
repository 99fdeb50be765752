"""The main path's bf16 RDB kernel, ``csrc/rdb.cu::rdb_wg_kernel`` (``wgmma``,
B streamed through a ring of bulk copies), emulated in numpy on the CPU.

The emulation (:func:`emulate_wg_rdb`) follows the kernel's data movement:
the input tile in bf16 at ``rot<8>`` chunks, x1..x4 at ``rot<4>``; each
stage's 64-row warpgroup tiles, rows past the region loading its last
pixel; A gathered as ``ldmatrix.x4`` returns it from the per-lane tap
addresses; B read from the ring's slot through the 128-byte swizzle of the
``wgmma`` descriptor (start = slot + (k-step % 4)·32); the ring filled by
whole-slab copies from :func:`pack_rdb_wg`'s stream in slab order, a slot
refilled with slab g + 3 once slab g is released, every read checked
against the slab the slot holds; the residual read from the resident copy
of x. The kernel itself is held against ``rdb_reference`` on the card by
``chip_smoke.py`` (phase kernel).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.ops.pallas.fused_rdb import pack_rdb_weights_v2
from s2sr_tpu.ops.pallas.fused_rdb_v4 import rdb_pallas_v4
from s2sr_tpu_torch.ops import rdb as rdb_mod
from s2sr_tpu_torch.ops.rdb import pack_rdb_weights, rdb_reference
from torch_threads import one_torch_thread  # noqa: F401

RDB_CU = Path(rdb_mod.__file__).resolve().parent.parent / "csrc" / "rdb.cu"
TILE, HALO = 16, 5
CINS, COUTS = (64, 96, 128, 160, 192), (32, 32, 32, 32, 64)
WGS, KQ, SLOT = 2, 4, 64 * 128
NBUF = rdb_mod.RING_SLOTS_BF16
SMEM_LIMIT = 232448


@pytest.fixture(scope="module")
def rdb_params():
    """One RDB at the kernel's widths: the model's init (normal ·
    sqrt(2 / fan_in) · 0.1) with every kernel ×8, so x1..x4 move the
    output, and nonzero biases."""
    rng = np.random.default_rng(21)
    p = {}
    for k in range(1, 6):
        cin, cout = CINS[k - 1], COUTS[k - 1]
        p[f"conv{k}"] = {
            "kernel": (rng.normal(size=(3, 3, cin, cout))
                       * np.sqrt(2.0 / (9 * cin)) * 0.1 * 8).astype(np.float32),
            "bias": rng.normal(0, 0.05, cout).astype(np.float32)}
    return p


def torch_weights(p, dtype):
    kernels = [torch.from_numpy(np.transpose(p[f"conv{k}"]["kernel"],
                                             (3, 2, 0, 1)).copy())
               for k in range(1, 6)]
    biases = [torch.from_numpy(p[f"conv{k}"]["bias"]) for k in range(1, 6)]
    return pack_rdb_weights(kernels, biases, dtype)


def bf16(a):
    """float32 values rounded to bf16 (to nearest, ties to even)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def side(j):
    """Region side of source j (x: j = 0) and of stage j's output."""
    return TILE + 2 * (HALO - j)


def wg_mt(s):
    """64-row M tiles each warpgroup runs in stage s (both the same)."""
    return -(-(-(-side(s) ** 2 // 64)) // WGS)


def src_steps(j):
    """k-steps (16 bf16 values of K) of source j: four a tap for x's 64
    channels, two for x1..x4's 32."""
    return 36 if j == 0 else 18


def src_layout():
    """Per source j: (byte offset after the ring, region side, 16-byte
    chunks a pixel), all in bf16; and the sources' bytes."""
    out, off = [], 0
    for j in range(5):
        ch = 64 if j == 0 else 32
        out.append((off, side(j), ch * 2 // 16))
        off += side(j) ** 2 * ch * 2
    return out, off


def slab_plan():
    """Every slab in the kernel's order as (byte offset in the stream,
    bytes), each stage's first slab, and the stream's length."""
    slabs, first, off = [], [], 0
    for s in range(1, 6):
        n = -(-sum(src_steps(j) for j in range(s)) // KQ)
        first.append(len(slabs))
        qb = COUTS[s - 1] * 128
        slabs += [(off + k * qb, qb) for k in range(n)]
        off += n * qb
    return slabs, first, off


def wg_macs_per_tile():
    """``wg_macs_per_tile``: each stage's 2·wg_mt 64-row tiles, 9 Cin × Cout."""
    return sum(WGS * wg_mt(s) * 64 * 9 * CINS[s - 1] * COUTS[s - 1]
               for s in range(1, 6))


def rot(p, c, cq):
    """Byte offset of 16-byte chunk c of pixel p in a source of cq chunks a
    pixel (``rot<CQ>``): 8 / cq pixels a 128-byte line, chunk c of pixel p
    at bank group (p + 8 / cq · c) % 8."""
    return (p * cq // 8) * 128 + ((p + 8 // cq * c) % 8) * 16


class Ring:
    """The B ring: NBUF slots of SLOT bytes, the first NBUF slabs copied in
    at the start; ``release(g)``: every consumer has read slab g
    (``ring_release``), and the producer copies slab g + NBUF into its
    slot. A copy over a slab not yet released, or a read of a slot that
    holds another slab, fails."""

    def __init__(self, stream, plan):
        self.mem = np.zeros(NBUF * SLOT, np.uint8)
        self.tag = [-1] * NBUF
        self.stream, self.plan, self.released = stream, plan, []
        for g in range(min(NBUF, len(plan))):
            self.issue(g)

    def issue(self, g):
        slot = g % NBUF
        assert self.tag[slot] < 0 or self.tag[slot] in self.released, \
            "a slab overwritten before read"
        off, n = self.plan[g]
        self.mem[slot * SLOT:slot * SLOT + n] = self.stream[off:off + n]
        self.tag[slot] = g

    def release(self, g):
        assert g == len(self.released), f"slab {g} released out of turn"
        self.released.append(g)
        if g + NBUF < len(self.plan):
            self.issue(g + NBUF)

    def b(self, g, kk, n):
        """k-step kk of slab g as wgmma reads it: (16, n) bf16 values as
        float32."""
        assert self.tag[g % NBUF] == g, "the slot holds another slab"
        rows, kb = np.arange(n)[:, None], np.arange(32)[None, :]
        addr = (g % NBUF) * SLOT + kk * 32 + (rows // 8) * 1024 + (rows % 8) * 128 + kb
        raw = np.ascontiguousarray(self.mem[addr ^ (((addr >> 7) & 7) << 4)])
        return (raw.view("<u2").astype(np.uint32) << 16).view(np.float32).T


def emulate_wg_rdb(x, stream, bias, mask=None, round_stores=True):
    """``rdb_wg_kernel`` in numpy, block by block: float32 sums; with
    ``round_stores`` x1..x4 and the output rounded to bf16 where the
    kernel stores them, else kept in float32 (the float32 block). x must
    hold bf16 values. Returns the output and the multiply-adds each block
    executed."""
    bsz, h, w, _ = x.shape
    layout, nbytes = src_layout()
    plan, first, length = slab_plan()
    assert len(stream) == length
    rnd = bf16 if round_stores else (lambda a: a)
    out = np.zeros_like(x)
    macs = set()
    co64 = np.arange(64)
    for b in range(bsz):
        for oy0 in range(0, h, TILE):
            for ox0 in range(0, w, TILE):
                ring = Ring(stream, plan)
                mem = np.full(nbytes // 2, np.nan, np.float32)      # by 2 bytes
                r0 = side(0)
                p0 = np.arange(r0 * r0)
                gy, gx = oy0 - HALO + p0 // r0, ox0 - HALO + p0 % r0
                ins = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                xt = np.zeros((r0 * r0, 64), np.float32)
                xt[ins] = x[b, gy[ins], gx[ins]]
                at = rot(p0[:, None], co64[None, :] // 8, 8) + 2 * (co64 % 8)
                mem[at // 2] = xt
                done = 0
                for s in range(1, 6):
                    rs, cout = side(s), COUTS[s - 1]
                    npix = rs * rs
                    tiles = [wg + WGS * m for m in range(wg_mt(s))
                             for wg in range(WGS)]
                    rows = (np.array(tiles)[:, None] * 64
                            + np.arange(64)[None, :]).reshape(-1)
                    pix = np.minimum(rows, npix - 1)
                    py, px = pix // rs, pix % rs
                    acc = np.zeros((rows.size, cout), np.float32)
                    s0, t = first[s - 1], 0
                    for j in range(s):
                        base, rj, cq = layout[j]
                        nk = src_steps(j)
                        spt, d = nk // 9, s - 1 - j
                        sp0 = (py + d) * rj + px + d
                        for k in range(nk):
                            tt = t + k
                            g = s0 + tt // KQ
                            tap, cc = divmod(k, spt)
                            pa = sp0 + (tap // 3) * rj + tap % 3
                            # lanes 0-15: chunk 2cc of rows 0-15, 16-31: 2cc + 1
                            a = np.concatenate(
                                [mem[(base + rot(pa, 2 * cc + e, cq))[:, None] // 2
                                     + np.arange(8)] for e in (0, 1)], 1)
                            assert not np.isnan(a).any()
                            acc += a @ ring.b(g, tt % KQ, cout)
                            done += rows.size * 16 * cout
                            # wgmma_wait<1>: the step before has completed
                            if tt % KQ == 0 and tt > 0:
                                ring.release(g - 1)
                        t += nk
                    ring.release(s0 + (t - 1) // KQ)       # the stage's last
                    ok = rows < npix
                    ry, rx = rows[ok] // rs, rows[ok] % rs
                    v = acc[ok] + bias[(s - 1) * 32:(s - 1) * 32 + cout]
                    co = np.arange(cout)
                    if s < 5:
                        hs = HALO - s
                        gy, gx = oy0 - hs + ry, ox0 - hs + rx
                        inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                        mk = np.zeros(ry.size, np.float32)
                        mk[inside] = (mask[b, gy[inside], gx[inside]]
                                      if mask is not None else 1.0)
                        val = np.where(v >= 0, v, np.float32(0.2) * v) * mk[:, None]
                        val[~inside] = 0.0
                        addr = (layout[s][0] + rot(rows[ok][:, None], co[None, :] // 8, 4)
                                + 2 * (co % 8))
                        mem[addr // 2] = rnd(val)
                    else:
                        gy, gx = oy0 + ry, ox0 + rx
                        keep = (gy < h) & (gx < w)
                        xp = (ry + HALO) * r0 + rx + HALO
                        xin = mem[(rot(xp[:, None], co[None, :] // 8, 8)
                                   + 2 * (co % 8)) // 2]
                        mk = (mask[b, gy[keep], gx[keep]][:, None]
                              if mask is not None else np.float32(1.0))
                        res = (v[keep] * np.float32(0.2) + xin[keep]) * mk
                        out[b, gy[keep], gx[keep]] = rnd(res)
                assert ring.released == list(range(len(plan)))  # each slab once
                macs.add(done)
    return out, macs.pop()


def _image(shape, masked, seed):
    """bf16-valued x (zero outside the mask's rectangle) and the mask."""
    x = bf16(np.random.default_rng(seed).normal(0, 0.5, (*shape, 64)))
    mask = None
    if masked:
        b, h, w = shape
        mask = np.zeros(shape, np.float32)
        mask[:, :h - 5, :w - 4] = 1
        x = x * mask[..., None]
    return x, mask


def _stream(w):
    return rdb_mod.pack_rdb_wg(w).numpy()


@pytest.mark.parametrize("masked", [False, True])
def test_wg_kernel_emulation_matches_reference(rdb_params, masked):
    """The bf16 kernel's data movement, emulated on a ragged 2×2-tile image
    with float32 stores, gives the float32 plain version within rtol 1e-4
    / atol 1e-5 (summation order); each block executes the kernel's count
    of multiply-adds."""
    x, mask = _image((1, 18, 21), masked, 22)
    w, b = torch_weights(rdb_params, torch.bfloat16)
    got, macs = emulate_wg_rdb(x, _stream(w), b.numpy(), mask,
                               round_stores=False)
    want = rdb_reference(torch.from_numpy(x), w, b,
                         None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert macs == wg_macs_per_tile()


@pytest.mark.parametrize("masked", [False, True])
def test_wg_kernel_emulation_bf16_stores(rdb_params, masked):
    """As the kernel stores: x1..x4 and the output rounded to bf16, every
    sum in float32. Against the float32 plain version on the same bf16
    values, within 2% of the largest change the block makes (max |out −
    x|): a bf16 store is off by half an ulp (2⁻⁹ relative), and the
    stages carry x1..x4's roundings on. The output's own rounding is up
    to half an ulp of x, so it is taken out by rounding the reference
    too."""
    x, mask = _image((1, 18, 21), masked, 23)
    w, b = torch_weights(rdb_params, torch.bfloat16)
    got, _ = emulate_wg_rdb(x, _stream(w), b.numpy(), mask)
    want = rdb_reference(torch.from_numpy(x), w, b,
                         None if mask is None else torch.from_numpy(mask)).numpy()
    change = np.abs(want - x).max()
    assert change > 0.1                      # the block moves x
    err = np.abs(got - bf16(want)).max()
    assert err <= 0.02 * change, (err, change)
    if masked:
        assert not got[:, 13:].any() and not got[:, :, 17:].any()


def test_wg_kernel_emulation_matches_pallas_v4_interpret(rdb_params):
    """The emulation against the JAX package's ``rdb_pallas_v4`` in
    interpret mode, float32, one ragged shape of two tiles a side."""
    x, _ = _image((1, 20, 18), False, 24)
    # the port's kernel reads bf16 weights: JAX's get the same values
    w, b = torch_weights(rdb_params, torch.bfloat16)
    kernels, biases = rdb_mod.unpack_rdb_weights(w, b)
    pb = {f"conv{k}": {"kernel": kernels[k - 1].permute(2, 3, 1, 0).numpy(),
                       "bias": biases[k - 1].numpy()} for k in range(1, 6)}
    packed, b14, b5 = pack_rdb_weights_v2(jax.tree.map(jnp.asarray, pb),
                                          dtype=jnp.float32)
    want = np.asarray(rdb_pallas_v4(jnp.asarray(x), packed, b14, b5,
                                    interpret=True, tile=16))
    got, _ = emulate_wg_rdb(x, _stream(w), b.numpy(), round_stores=False)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_slab_index_is_a_permutation_of_w_bytes():
    """Every byte of the five bf16 convs once; padding only in the last
    slab of stages 2 and 4, whose 54 and 90 k-steps are not whole slabs
    of 4; a byte lands where the descriptor reads it."""
    idx = rdb_mod.slab_index_wg()
    n_w = sum(9 * c * o for c, o in zip(CINS, COUTS))
    real = idx[idx >= 0]
    assert sorted(real.tolist()) == list(range(2 * n_w))
    plan, first, length = slab_plan()
    assert idx.numel() == length
    pad = np.zeros(length, bool)
    for s in range(1, 6):
        steps = sum(src_steps(j) for j in range(s))
        n_slab = -(-steps // KQ)
        if steps % KQ:
            off, qb = plan[first[s - 1] + n_slab - 1]
            n = COUTS[s - 1]
            # the last slab's k-steps steps % KQ.. of every row
            for r in range(n):
                for kk in range(steps % KQ, KQ):
                    for c in (2 * kk, 2 * kk + 1):
                        pad[off + r * 128 + (c ^ (r % 8)) * 16:][:16] = True
    assert np.array_equal((idx < 0).numpy(), pad)
    assert int(pad.sum()) == 2 * 2 * 32 * 32     # stages 2 and 4, 2 steps each
    # stage 3 (after 9 + 14 slabs of 32 rows): k-step 37 is x1's tap 0,
    # channels 16..31 (conv 3's 80..95), in slab 9 at k-step 1; output
    # channel 5, value 3: bytes 6, 7 of its 32
    w = torch.randn(n_w).bfloat16().float()
    stream = rdb_mod.pack_rdb_wg(w)
    assert stream.dtype == torch.uint8 and stream.numel() == length
    n, i, kb = 5, 3, 6
    at = (23 + 9) * 32 * 128 + n * 128 + ((2 * 1 + kb // 16) ^ (n % 8)) * 16 + kb % 16
    got = stream[at:at + 2].view(torch.bfloat16).float().item()
    off3 = 9 * (64 * 32 + 96 * 32)
    assert got == w[off3 + (64 + 16 + i) * 32 + n].item()


def _source_int(pattern: str) -> int:
    return int(re.search(pattern, RDB_CU.read_text()).group(1).replace(",", ""))


def test_shared_memory_plan_fits_and_matches_the_source():
    """x and x1..x4 in bf16 take 200,704 bytes; with the ring of
    ``NBUF_BF16`` slots of 8 KB, 1024 of alignment and two barriers a slot
    the block has 226,352 of its 232,448; eight slots would not fit. The
    plan equals ``csrc/rdb.cu``'s constants (which phase kernel holds to
    the built library)."""
    plan = rdb_mod.rdb_wg_smem_plan()
    layout, sources = src_layout()
    assert plan["sources"] == sources == 200_704
    assert plan["total"] == 1024 + NBUF * SLOT + sources + 2 * NBUF * 8
    assert plan["total"] == 226_352 <= SMEM_LIMIT
    assert 1024 + 8 * SLOT + sources + 2 * 8 * 8 == 267_392 > SMEM_LIMIT
    assert _source_int(r"constexpr int NBUF_BF16 = (\d+);") == NBUF
    assert _source_int(r"constexpr int SLOT = 64 \* (\d+);") * 64 == SLOT
    assert _source_int(r"wg_smem_bytes<KBF>\(\) == (\d+)") == plan["total"]
    assert _source_int(r"wg_src_off<KBF>\(5\) == (\d+)") == sources
    for v in ("226,352", "200,704", "232,448", "267,392"):
        assert v in RDB_CU.read_text()


def two_wavefront_share(layout):
    """Share of the ldmatrix phases (8 lanes: 8 pixels of a warp's rows at
    one chunk) of all five stages' k-steps that take two wavefronts or
    more: distinct 16-byte addresses in one bank group, by count over the
    kernel's tiles, taps and chunks (lanes on one address share it).
    ``layout``: "rot" (the kernel's) or "swz" (rdb_tc_kernel's XOR
    swizzle)."""
    worse = total = 0
    lanes = np.arange(32)
    for s in range(1, 6):
        rs = side(s)
        npix = rs * rs
        rows = (np.arange(WGS * wg_mt(s))[:, None, None] * 64
                + np.arange(4)[None, :, None] * 16 + (lanes & 15))
        pix = np.minimum(rows, npix - 1)
        for j in range(s):
            rj, d = side(j), s - 1 - j
            cq = 8 if j == 0 else 4
            for tap in range(9):
                p = (pix // rs + d + tap // 3) * rj + pix % rs + d + tap % 3
                for cc in range(src_steps(j) // 9):
                    c = 2 * cc + (lanes >> 4)
                    if layout == "rot":
                        at = rot(p, c, cq) // 16
                    else:
                        q = p * cq + c
                        at = q ^ ((q >> 3) & 7)
                    a = at.reshape(-1, 4, 8)                 # phases of 8 lanes
                    same_bank = (a[..., :, None] % 8) == (a[..., None, :] % 8)
                    other = a[..., :, None] != a[..., None, :]
                    worse += int((same_bank & other).any(axis=(-1, -2)).sum())
                    total += a.shape[0] * 4
    return worse / total


def test_x_layout_two_wavefront_share():
    """``rot``: x's 8 chunks a pixel fill a 128-byte line, chunk c of pixel
    p at bank group (p + c) % 8, so an ldmatrix phase of 8 consecutive
    pixels hits 8 bank groups from any first pixel; over the kernel's own
    phases two wavefronts are left only where a phase crosses a region
    row: 12.2%, under the bound 15% stated here (and quoted in
    csrc/rdb.cu), against 27.1% with rdb_tc_kernel's XOR swizzle (whose
    x1..x4 hold two pixels a line). An unswizzled x would put chunk c of
    every pixel in one bank group."""
    for first in range(64):
        for chunk in range(8):
            banks = rot(np.arange(first, first + 8), chunk, 8) // 16 % 8
            assert len(set(banks.tolist())) == 8
    share = two_wavefront_share("rot")
    assert share < 0.15
    assert share == pytest.approx(0.122, abs=0.002)
    assert two_wavefront_share("swz") == pytest.approx(0.271, abs=0.002)
    assert "12.2%" in RDB_CU.read_text()


def test_executed_over_useful():
    """64-row M tiles, the same number for both warpgroups: 1.48 of the
    block's useful multiply-adds, as for the int8 kernels (1.434 for
    rdb_tc_kernel's 16-row tiles); the kernel's tile-steps, 2,340."""
    useful = 256 * 9 * sum(c * n for c, n in zip(CINS, COUTS))
    assert wg_macs_per_tile() / useful == pytest.approx(1.4808, abs=1e-4)
    steps = sum(WGS * wg_mt(s) * sum(src_steps(j) for j in range(s))
                for s in range(1, 6))
    assert steps == 2340


def test_packed_once_a_body_and_again_after_an_inplace_change(rdb_params):
    """``rdb``'s bf16 slabs and ``rdb_mma``'s fragments are packed once
    for a weight tensor, again when it is changed in place (its version)
    and for another tensor."""
    w, _ = torch_weights(rdb_params, torch.bfloat16)
    calls = []

    def pack(t):
        calls.append(t)
        return rdb_mod.pack_rdb_wg(t)

    cache = type(rdb_mod._WG_PACKS)()
    first = rdb_mod._packed(cache, w, pack)
    assert rdb_mod._packed(cache, w, pack) is first and len(calls) == 1
    w.mul_(0.5)
    again = rdb_mod._packed(cache, w, pack)
    assert len(calls) == 2 and again is not first
    assert torch.equal(again, rdb_mod.pack_rdb_wg(w))
    other = w.clone()
    rdb_mod._packed(cache, other, pack)
    assert len(calls) == 3
    assert rdb_mod._packed(cache, w, pack) is again and len(calls) == 3


def test_rdb_mma_cpu_plain_and_refuses_other_devices(rdb_params):
    """``v4_mma``'s wrapper: on the CPU its plain version, no launch
    counted; another device raises."""
    w, b = torch_weights(rdb_params, torch.bfloat16)
    x = torch.from_numpy(_image((1, 9, 10), False, 25)[0]).bfloat16()
    n0 = rdb_mod.LAUNCHES_MMA
    assert torch.equal(rdb_mod.rdb_mma(x, w, b), rdb_reference(x, w, b))
    assert rdb_mod.LAUNCHES_MMA == n0
    with pytest.raises(RuntimeError, match="unsupported device"):
        rdb_mod.rdb_mma(x.to("meta"), w.to("meta"), b.to("meta"))
