"""The port's int8-mixed trunk (``s2sr_tpu_torch.models.rrdbnet_int8``,
``ops/rdb.py::rdb_i8``) against the JAX package's
``s2sr_tpu/models/rrdbnet_int8.py``, on the CPU.

Weights and inputs come from numpy seeds and go to both packages; JAX's
quantized tree is carried to the port (``qbody_from_jax``) wherever a
test compares forwards, so both quantize with the same scales. On the
CPU the wrapper runs its plain version; the CUDA kernel's data movement
(``wgmma`` tiles, the B ring, the descriptor's swizzle) is emulated in
numpy here (:func:`emulate_wg_rdb`, shared with the full-W8A8 kernel's
test) and the kernel itself is held against the plain version on the card
by ``chip_smoke.py`` (phase kernel).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.models import engine as jax_engine_mod
from s2sr_tpu.models import registry as jax_registry
from s2sr_tpu.models import rrdbnet_int8 as jq
from s2sr_tpu.models.weights import save_params
from s2sr_tpu_torch.models import engine as engine_mod
from s2sr_tpu_torch.models import registry
from s2sr_tpu_torch.models import rrdbnet_int8 as tq
from s2sr_tpu_torch.models.rrdbnet import RRDBNet
from s2sr_tpu_torch.models.weights import params_from_jax
from s2sr_tpu_torch.ops import rdb as rdb_mod

from test_torch_engine import TINY, jax_tree_one_block
from test_torch_rdb import torch_weights
from torch_threads import one_torch_thread  # noqa: F401


def unscaled_tree(seed: int):
    """A one-block JAX tree without the 0.1 scaling of the init (plain
    Kaiming): the trunk then moves the output, so a wrong int8 trunk
    shows (with the scaling, the output is ~1e-2 and the trunk's share
    ~1e-7)."""
    tree = jax_tree_one_block(np.random.default_rng(seed))
    convs = [c for r in tree["body"].values() for c in r.values()]
    convs += [c for k, c in tree.items() if k != "body"]
    for conv in convs:
        conv["kernel"] = conv["kernel"] * 10
    return tree


def port_model(tree, dtype):
    model = RRDBNet(num_block=1, dtype=dtype)
    model.load_state_dict(params_from_jax(tree))
    return model.pack()


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def rdb_tree(seed: int):
    """One RDB's convs (HWIO) at kernel scale ×10, nonzero biases."""
    rng = np.random.default_rng(seed)
    return {f"conv{k}": {
        "kernel": (rng.normal(size=(3, 3, 64 + 32 * (k - 1), 32 if k < 5 else 64))
                   * np.sqrt(2.0 / (9 * (64 + 32 * (k - 1))))).astype(np.float32),
        "bias": rng.normal(0, 0.05, 32 if k < 5 else 64).astype(np.float32)}
        for k in range(1, 6)}


def torch_p(p):
    return {k: {n: torch.from_numpy(v) for n, v in c.items()}
            for k, c in p.items()}


def mixed_qp(p, x):
    """JAX's mixed quantization of one RDB with the scale max|x| / 127, as
    numpy: wx8 (3, 3, 64, 192) int8, deq (192,), qm ()."""
    s_act = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-12) / 127.0
    wx = jq._pack_rdb_kernels(to_jax(p))[0]
    w8, sw = jq._quantize_kernel(wx)
    return {"wx8": np.asarray(w8), "deq": np.asarray(sw * s_act, np.float32),
            "qm": np.asarray(1.0 / s_act, np.float32)}


def test_quantized_weights_and_quant_bit_equal_jax():
    """Bit-equal: every packed kernel's int8 weights and scales, and the
    activation quantizer on values that land on half steps (round half to
    even), clamp and zero."""
    p = rdb_tree(1)
    for want, got in zip(jq._pack_rdb_kernels(to_jax(p)),
                         tq._pack_rdb_kernels(torch_p(p))):
        assert np.array_equal(np.asarray(want), got.numpy())
        w8, s = jq._quantize_kernel(want)
        t8, ts = tq._quantize_kernel(got)
        assert t8.dtype == torch.int8
        assert np.array_equal(np.asarray(w8), t8.numpy())
        assert np.array_equal(np.asarray(s), ts.numpy())
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(0, 1, 4000),
                        (2 * np.arange(-70, 70) + 1) / 4.0,   # ·2 = k + 0.5
                        [0.0, -0.0, 500.0, -500.0]]).astype(np.float32)
    for qm in (np.float32(2.0), np.float32(37.25)):
        want = np.asarray(jq._quant(jnp.asarray(x), jnp.asarray(qm)))
        got = tq._quant(torch.from_numpy(x), qm)
        assert got.dtype == torch.int8
        assert np.array_equal(want, got.numpy())


def test_calibration_and_quantize_body_match_jax():
    """Activation scales within rtol 1e-5 of JAX's (float32 convs summed in
    another order); given JAX's scales, both quantized bodies bit-equal."""
    tree = unscaled_tree(3)
    calib = np.random.default_rng(4).random((1, 32, 32, 3)).astype(np.float32)
    want = jq.calibrate_act_scales(to_jax(tree), jnp.asarray(calib))
    model = port_model(tree, torch.float32)
    got = tq.calibrate_act_scales(model, torch.from_numpy(calib))
    assert got.shape == (1, 3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    scales = torch.from_numpy(np.array(want))
    for jfn, tfn in ((jq.quantize_body_mixed, tq.quantize_body_mixed),
                     (jq.quantize_body, tq.quantize_body)):
        jflat = jax.tree.leaves(jax.tree.map(
            np.asarray, jfn(to_jax(tree), jnp.asarray(want))))
        tflat = jax.tree.leaves(jax.tree.map(
            lambda t: t.numpy(), tfn(model, scales)))
        assert len(jflat) == len(tflat)
        for a, b in zip(jflat, tflat):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_int32_product_bit_equal_jax():
    """The int8 conv's sums (float32 on integer values in the port,
    int32 in JAX) equal exactly, at the extremes too."""
    rng = np.random.default_rng(5)
    x8 = rng.integers(-127, 128, (2, 9, 11, 64)).astype(np.int8)
    x8[0, :3, :3] = 127
    w8 = rng.integers(-127, 128, (3, 3, 64, 192)).astype(np.int8)
    w8[..., 0] = 127
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(w8), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = rdb_mod.conv_i8_int(torch.from_numpy(x8).float().permute(0, 3, 1, 2),
                              torch.from_numpy(w8).permute(3, 2, 0, 1))
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got.astype(np.int64), np.asarray(want).astype(np.int64))
    assert np.abs(got).max() == 127 * 127 * 9 * 64


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rdb_i8_reference_matches_jax_mixed(dtype, masked):
    """``rdb_i8_reference`` against JAX's ``_rdb_packed_mixed`` on the same
    x and quantized x conv: float32 within 1e-5 absolute (conv order), bf16
    within 0.05 of max |out − x| (the frameworks round their bf16 convs in
    other places)."""
    p = rdb_tree(6)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 0.5, (2, 14, 19, 64)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((2, 14, 19, 1), np.float32)
        mask[0, :11, :15] = mask[1, :14, :9] = 1
        x = x * mask
    qp = mixed_qp(p, x)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jq._rdb_packed_mixed(
        jnp.asarray(x, jdt), to_jax(p), to_jax(qp), jdt,
        None if mask is None else jnp.asarray(mask, jdt))).astype(np.float32)
    got = tq._rdb_packed_mixed(
        torch.from_numpy(x).to(tdt), torch_p(p),
        {k: torch.from_numpy(np.array(v)) for k, v in qp.items()}, tdt,
        None if mask is None else torch.from_numpy(mask)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        change = np.abs(want - x).max()
        assert np.abs(got - want).max() <= 0.05 * change


@pytest.mark.parametrize("mode", ["mixed", "full"])
def test_rrdbnet_apply_int8_matches_jax(mode):
    """The whole forward with JAX's quantized tree carried over, float32:
    within 1e-4 of the output's scale, and the trunk engaged (a zeroed
    tree moves the output by more than 1e-3). The bound is not summation
    order alone: an ulp of difference in a conv input can move round(x·qm)
    across a half step, one quantization step at that pixel (3.4e-5 of the
    scale measured when written)."""
    tree = unscaled_tree(8)
    rng = np.random.default_rng(9)
    x = rng.random((1, 20, 24, 3)).astype(np.float32)
    calib = rng.random((1, 32, 32, 3)).astype(np.float32)
    jbody = jq.quantize_rrdbnet(to_jax(tree), jnp.asarray(calib), mode=mode)
    want = np.asarray(jq.rrdbnet_apply_int8(to_jax(tree), jbody, jnp.asarray(x),
                                            dtype=jnp.float32, mode=mode))
    model = port_model(tree, torch.float32)
    qbody = tq.qbody_from_jax(jax.tree.map(np.asarray, jbody))
    got = tq.rrdbnet_apply_int8(model, qbody, torch.from_numpy(x),
                                mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    dead = tq.rrdbnet_apply_int8(
        model, jax.tree.map(torch.zeros_like, qbody), torch.from_numpy(x),
        mode=mode).numpy()
    assert np.abs(dead - got).max() > 1e-3


def test_unknown_int8_modes_refused():
    """An unknown int8 mode raises, in quantizing and in the forward."""
    tree = unscaled_tree(10)
    model = port_model(tree, torch.float32)
    with pytest.raises(ValueError, match="unknown int8 mode"):
        tq.quantize_rrdbnet(model, torch.rand(1, 8, 8, 3), mode="w4")
    with pytest.raises(ValueError, match="unknown int8 mode"):
        tq.rrdbnet_apply_int8(model, {}, torch.rand(1, 8, 8, 3), mode="w4")


# --- the int8 kernels' data movement, emulated in numpy ---------------------
#
# rdb_i8_kernel and rdb_w8a8_kernel (csrc/rdb.cu) run only on the card
# (chip_smoke.py, phase kernel). Here every address they compute is followed
# in numpy: the input tile quantized into swizzled 4-chunk pixels; per stage
# two warpgroups of 64-row M tiles (tile w + 2m), each row's A gathered as
# ldmatrix.x4 returns it from the per-lane tap addresses; B read from the
# ring's slot through the 128-byte swizzle of the wgmma descriptor's address
# (start = slot + (k-step % 4)·32); the ring filled by whole-slab copies from
# the packed streams in slab order, a slot refilled with slab g + NBUF once
# slab g is released, and every read checked against the slab the slot
# holds. s8 sums are exact integers, dequantized per source; bf16 products
# and x1..x4 are kept in float32, so the result is the float32 block.

TC_TILE, TC_HALO = 16, 5
COUTS = (32, 32, 32, 32, 64)
CINS = (64, 96, 128, 160, 192)
# stage s's output channel 0 in every packed kernel ([a5|a4|a3|a2|a1])
COLS = (160, 128, 96, 64, 0)
WGS, KQ, NBUF, SLOT = 2, 4, 8, 64 * 128
SMEM_LIMIT = 232448


def side(j):
    """Region side of source j (x: j = 0) and of stage j's output."""
    return TC_TILE + 2 * (TC_HALO - j)


def wg_mt(s):
    """64-row M tiles each warpgroup runs in stage s (both the same)."""
    return -(-(-(-side(s) ** 2 // 64)) // WGS)


def src_layout(full):
    """Per source j: (byte offset after the ring, region side, channels,
    bytes a value): x in int8, x1..x4 in bf16 (rdb_i8) or int8 (full)."""
    out, off = [], 0
    for j in range(5):
        ch, nb = (64 if j == 0 else 32), (1 if j == 0 or full else 2)
        out.append((off, side(j), ch, nb))
        off += side(j) ** 2 * ch * nb
    return out, off


def src_steps(j, full):
    """k-steps (32 bytes of K) of source j: two a tap, one for full's x_j."""
    return 9 if j > 0 and full else 18


def parts(s, full):
    """Stage s's parts as (stream, sources): rdb_i8 x from wq (0), then
    x1..x_{s-1} from wf (1); full W8A8 all its sources from wq."""
    if full:
        return [(0, list(range(s)))]
    return [(0, [0])] + ([(1, list(range(1, s)))] if s > 1 else [])


def slab_plan(full):
    """Every slab in the kernel's order as (stream, byte offset, bytes),
    each (stage, part)'s first slab, and each stream's length."""
    slabs, first, off = [], {}, [0, 0]
    for s in range(1, 6):
        for i, (stream, srcs) in enumerate(parts(s, full)):
            n = -(-sum(src_steps(j, full) for j in srcs) // KQ)
            first[(s, i)] = len(slabs)
            qb = COUTS[s - 1] * 128
            slabs += [(stream, off[stream] + k * qb, qb) for k in range(n)]
            off[stream] += n * qb
    return slabs, first, off


def wg_macs_per_tile():
    """``wg_macs_per_tile``: each stage's 2·wg_mt 64-row tiles, 9 Cin × Cout."""
    return sum(WGS * wg_mt(s) * 64 * 9 * CINS[s - 1] * COUTS[s - 1]
               for s in range(1, 6))


class Ring:
    """The B ring: NBUF slots of SLOT bytes, 1024-aligned, the first NBUF
    slabs copied in at the start; ``release(g)``: every consumer has read
    slab g (``ring_release``), and the producer warp copies slab g + NBUF
    into its slot. A copy over a slab with steps still to read, or a read
    of a slot that holds another slab, fails."""

    def __init__(self, streams, plan):
        self.mem = np.zeros(NBUF * SLOT, np.uint8)
        self.tag = [-1] * NBUF
        self.streams, self.plan, self.released = streams, plan, []
        for g in range(min(NBUF, len(plan))):
            self.issue(g)

    def issue(self, g):
        slot = g % NBUF
        assert self.tag[slot] < 0 or self.tag[slot] in self.released, \
            "a slab overwritten before read"
        stream, off, n = self.plan[g]
        self.mem[slot * SLOT:slot * SLOT + n] = self.streams[stream][off:off + n]
        self.tag[slot] = g

    def release(self, g):
        """Every consumer has read slab g: it must be the next slab."""
        assert g == len(self.released), f"slab {g} released out of turn"
        self.released.append(g)
        if g + NBUF < len(self.plan):
            self.issue(g + NBUF)

    def b(self, g, kk, n, s8):
        """k-step kk of slab g as wgmma reads it: (K, n), int64 for s8, the
        bf16 values as float32 (16 a row) otherwise."""
        assert self.tag[g % NBUF] == g, "the slot holds another slab"
        rows, kb = np.arange(n)[:, None], np.arange(32)[None, :]
        addr = (g % NBUF) * SLOT + kk * 32 + (rows // 8) * 1024 + (rows % 8) * 128 + kb
        raw = np.ascontiguousarray(self.mem[addr ^ (((addr >> 7) & 7) << 4)])
        if s8:
            return raw.view(np.int8).astype(np.int64).T
        u16 = raw.view("<u2").astype(np.uint32) << 16
        return u16.view(np.float32).T


def rot(p, c, cq):
    """Byte offset of 16-byte chunk c of pixel p in a source of cq chunks a
    pixel (``rot<CQ>``): 8 / cq pixels a 128-byte line, chunk c of pixel p
    at bank group (p + 8 / cq · c) % 8."""
    return (p * cq // 8) * 128 + ((p + 8 // cq * c) % 8) * 16


def emulate_wg_rdb(x, streams, deq, qm, bias, full, mask=None):
    """``rdb_i8_kernel`` (``full`` False; ``qm`` x's multiplier, ``deq``
    the x conv's 192 factors) or ``rdb_w8a8_kernel`` (``qm`` five
    multipliers, ``deq`` 640) in numpy, block by block. ``streams``: the
    packed (wq, wf) as uint8. Returns the output and the multiply-adds
    each block executed."""
    bsz, h, w, _ = x.shape
    layout, nbytes = src_layout(full)
    plan, first, lengths = slab_plan(full)
    assert [len(t) for t in streams] == lengths[:len(streams)]
    qms = np.atleast_1d(np.float32(qm))
    deq_off = np.cumsum((0, 192, 160, 128, 96))
    out = np.zeros_like(x)
    xq = np.clip(np.round(x * qms[0]), -127, 127).astype(np.int64)
    macs = set()
    for b in range(bsz):
        for oy0 in range(0, h, TC_TILE):
            for ox0 in range(0, w, TC_TILE):
                ring = Ring(streams, plan)
                mem8 = np.full(nbytes, -999, np.int64)              # by byte
                memf = np.full(nbytes // 2, np.nan, np.float32)    # by 2 bytes
                r0 = side(0)
                for p in range(r0 * r0):
                    gy, gx = oy0 - TC_HALO + p // r0, ox0 - TC_HALO + p % r0
                    inside = 0 <= gy < h and 0 <= gx < w
                    for c in range(8):
                        at = rot(p, c // 2, 4) + 8 * (c % 2)
                        mem8[at:at + 8] = xq[b, gy, gx, 8 * c:8 * c + 8] \
                            if inside else 0
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
                    for i, (_, srcs) in enumerate(parts(s, full)):
                        s0, t = first[(s, i)], 0
                        for j in srcs:
                            base, rj, ch, nb = layout[j]
                            nk, s8, cq = src_steps(j, full), nb == 1, ch * nb // 16
                            spt, d = nk // 9, s - 1 - j
                            sp0 = (py + d) * rj + px + d
                            isum = np.zeros((rows.size, cout), np.int64)
                            for k in range(nk):
                                tt = t + k
                                g = s0 + tt // KQ
                                tap, cc = divmod(k, spt)
                                pa = sp0 + (tap // 3) * rj + tap % 3
                                # lanes 0-15: chunk 2cc of rows 0-15, 16-31: 2cc + 1
                                if s8:
                                    a = np.concatenate(
                                        [mem8[base + rot(pa, 2 * cc + e, cq)[:, None]
                                              + np.arange(16)] for e in (0, 1)], 1)
                                    assert (a != -999).all()
                                    isum += a @ ring.b(g, tt % KQ, cout, True)
                                else:
                                    a = np.concatenate(
                                        [memf[(base + rot(pa, 2 * cc + e, cq))[:, None] // 2
                                              + np.arange(8)] for e in (0, 1)], 1)
                                    assert not np.isnan(a).any()
                                    acc += a @ ring.b(g, tt % KQ, cout, False)
                                done += rows.size * a.shape[1] * cout
                                # wgmma_wait<1>: the step before has completed
                                if tt % KQ == 0 and tt > 0:
                                    ring.release(g - 1)
                            if s8:
                                col = COLS[s - 1] + (deq_off[j] if full else 0)
                                acc = acc + isum.astype(np.float32) * deq[col:col + cout]
                            t += nk
                        ring.release(s0 + (t - 1) // KQ)       # the part's last
                    for r, p in enumerate(rows):
                        if p >= npix:
                            continue
                        ry, rx = divmod(int(p), rs)
                        v = acc[r] + bias[(s - 1) * 32:(s - 1) * 32 + cout]
                        co = np.arange(cout)
                        if s < 5:
                            hs = TC_HALO - s
                            gy, gx = oy0 - hs + ry, ox0 - hs + rx
                            ins = 0 <= gy < h and 0 <= gx < w
                            mk = np.float32((mask[b, gy, gx] if mask is not None
                                             else 1.0) if ins else 0.0)
                            val = np.where(v >= 0, v, np.float32(0.2) * v) * mk
                            if full:
                                q8 = np.clip(np.round(val * qms[s]), -127, 127)
                                addr = layout[s][0] + rot(p, co // 16, 2) + co % 16
                                mem8[addr] = q8 if ins else 0
                            else:
                                addr = layout[s][0] + rot(p, co // 8, 4) + 2 * (co % 8)
                                memf[addr // 2] = val if ins else 0.0
                        else:
                            gy, gx = oy0 + ry, ox0 + rx
                            if gy >= h or gx >= w:
                                continue
                            mk = np.float32(mask[b, gy, gx] if mask is not None
                                            else 1.0)
                            out[b, gy, gx] = (v * np.float32(0.2) + x[b, gy, gx]) * mk
                assert ring.released == list(range(len(plan)))  # each slab once
                macs.add(done)
    return out, macs.pop()


def _as_u8(t):
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("masked", [False, True])
def test_i8_kernel_emulation_matches_reference(masked):
    """The int8-mixed kernel's data movement (x quantized into swizzled
    4-chunk pixels; 64-row warpgroup tiles with per-lane ldmatrix tap
    addresses; x's s8 slabs and x1..x4's bf16 slabs from their packers,
    streamed through the ring in slab order and read through the
    descriptor's swizzle; the stage → packed-column map of deq; the
    residual from x), emulated on a ragged 2×2-tile image in float32 with
    bf16-valued weights, gives the float32 plain version within rtol 1e-4
    / atol 1e-5 (summation order); each block executes the kernel's
    count of multiply-adds."""
    p = rdb_tree(11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(1, 18, 21, 64)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((1, 18, 21), np.float32)
        mask[:, :13, :17] = 1
        x = x * mask[..., None]
    qp = mixed_qp(p, x)
    w, b = torch_weights(p, torch.bfloat16)
    wx8 = torch.from_numpy(qp["wx8"])
    deq = torch.from_numpy(qp["deq"])
    streams = (_as_u8(rdb_mod.pack_rdb_i8_fragments(wx8)),
               _as_u8(rdb_mod.pack_rdb_i8_bf16(w)))
    got, macs = emulate_wg_rdb(x, streams, qp["deq"], qp["qm"], b.numpy(),
                               False, mask)
    want = rdb_mod.rdb_i8_reference(
        torch.from_numpy(x), w, b, wx8, deq, float(qp["qm"]),
        None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert macs == wg_macs_per_tile()


@pytest.mark.parametrize("full", [False, True])
def test_int8_kernels_shared_memory_fits(full):
    """The B ring (8 slots of 8 KB), x and x1..x4 and the ring's barriers
    fit the 232,448 bytes a block may have, as ``wg_smem_plan`` (the
    kernel source's layout, which phase kernel holds to the built
    library) counts them: rdb_i8's ring fits the 75,008 bytes its
    sources leave."""
    plan = rdb_mod.wg_smem_plan(full)
    layout, sources = src_layout(full)
    assert plan["sources"] == sources and plan["ring"] == NBUF * SLOT
    assert plan["total"] == 1024 + NBUF * SLOT + sources + 2 * NBUF * 8
    assert plan["total"] <= SMEM_LIMIT
    assert sources == (100352 if full else 157440)
    assert plan["ring"] + plan["align"] + plan["barriers"] <= SMEM_LIMIT - sources


def two_wavefront_share(full, layout):
    """Share of the ldmatrix phases (8 lanes: 8 pixels of a warp's rows at
    one chunk) of all five stages' k-steps that take two wavefronts or
    more: distinct 16-byte addresses in one bank group, by count over the
    kernel's tiles, taps and chunks (lanes on one address share it).
    ``layout``: "rot" (the int8 kernels') or "swz" (rdb_tc_kernel's XOR
    swizzle)."""
    worse = total = 0
    for s in range(1, 6):
        rs = side(s)
        npix = rs * rs
        tiles = WGS * wg_mt(s)
        for j in range(s):
            rj, d = side(j), s - 1 - j
            nb = 1 if j == 0 or full else 2
            cq = (64 if j == 0 else 32) * nb // 16
            spt = src_steps(j, full) // 9
            lanes = np.arange(32)
            rows = (np.arange(tiles)[:, None, None] * 64
                    + np.arange(4)[None, :, None] * 16 + (lanes & 15))
            pix = np.minimum(rows, npix - 1)
            for tap in range(9):
                p = ((pix // rs + d + tap // 3) * rj + pix % rs + d + tap % 3)
                for cc in range(spt):
                    c = 2 * cc + (lanes >> 4)
                    if layout == "rot":
                        at = rot(p, c, cq) // 16
                    else:
                        q = p * cq + c
                        at = q ^ ((q >> 3) & 7)
                    for ph in range(4):
                        a = at[..., 8 * ph:8 * ph + 8].reshape(-1, 8)
                        for row in a:
                            u = np.unique(row)
                            worse += np.bincount(u % 8).max() > 1
                            total += 1
    return worse / total


@pytest.mark.parametrize("full", [False, True])
def test_int8_kernels_source_layout(full):
    """``rot``, the resident sources' layout: every chunk of every pixel at
    its own 16 bytes (a bijection onto the buffer), and an ldmatrix phase
    (8 consecutive pixels, one chunk) on 8 bank groups from any first
    pixel, where the XOR swizzle of rdb_tc_kernel takes two wavefronts
    from an odd one. Over the kernel's own phases (rdb_i8's, or
    rdb_w8a8's if ``full``) two wavefronts are left only where a phase
    crosses a region row: 13.4% and 12.2% of them, against 47.8% and
    50.7% with the XOR swizzle (counted here, quoted in csrc/rdb.cu)."""
    npix = 26 * 26
    for cq in (2, 4):
        p, c = np.meshgrid(np.arange(npix), np.arange(cq), indexing="ij")
        at = rot(p, c, cq)
        assert sorted(at.ravel().tolist()) == list(range(0, npix * cq * 16, 16))
        for first in range(64):
            for chunk in range(cq):
                banks = rot(np.arange(first, first + 8), chunk, cq) // 16 % 8
                assert len(set(banks.tolist())) == 8
    q = np.arange(1, 9) * 4                 # 8 pixels from an odd one, chunk 0
    assert len(set(((q ^ ((q >> 3) & 7)) % 8).tolist())) < 8
    want = (0.122, 0.507) if full else (0.134, 0.478)
    assert two_wavefront_share(full, "rot") == pytest.approx(want[0], abs=0.005)
    assert two_wavefront_share(full, "swz") == pytest.approx(want[1], abs=0.005)


def test_i8_executed_over_useful():
    """64-row M tiles, the same number for both warpgroups: 1.48 of the
    block's useful multiply-adds (1.42 if the tiles were split exactly,
    1.434 for rdb_tc_kernel's 16-row tiles)."""
    useful = 256 * 9 * sum(c * n for c, n in zip(CINS, COUTS))
    assert wg_macs_per_tile() / useful == pytest.approx(1.4808, abs=1e-4)
    exact = sum(-(-side(s) ** 2 // 64) * 64 * 9 * CINS[s - 1] * COUTS[s - 1]
                for s in range(1, 6))
    assert exact / useful == pytest.approx(1.423, abs=1e-3)


def test_i8_fragments_roundtrip_and_layout():
    """The x conv's s8 slab index and x1..x4's bf16 byte index are
    permutations of what each packer reads (every weight once, an exact
    round trip, the rest padding), and a byte lands where wgmma's
    descriptor reads it: stage 2's k-step 1 (tap 0, channels 32..63),
    output channel n at byte kb of its 32 is logical chunk 2 + kb // 16 of
    row n, stored at chunk (2 + kb // 16) ^ (n % 8)."""
    idx = rdb_mod.slab_index_i8()
    real = idx[idx >= 0]
    assert sorted(real.tolist()) == list(range(9 * 64 * 192))
    wx8 = torch.randint(-127, 128, (3, 3, 64, 192), dtype=torch.int8)
    slabs = rdb_mod.pack_rdb_i8_fragments(wx8)
    assert slabs.dtype == torch.int8 and slabs.numel() == idx.numel()
    assert (slabs[idx < 0] == 0).all()
    back = torch.empty(9 * 64 * 192, dtype=torch.int8)
    back[real] = slabs[idx >= 0]
    assert torch.equal(back.view(3, 3, 64, 192), wx8)
    # stage 1's 5 slabs of 32 rows come first
    n, kb = 5, 17
    at = 5 * 32 * 128 + n * 128 + ((2 + kb // 16) ^ (n % 8)) * 16 + kb % 16
    assert int(slabs[at]) == int(wx8[0, 0, 32 + kb, 128 + n])
    with pytest.raises(ValueError, match="int8"):
        rdb_mod.pack_rdb_i8_fragments(wx8.float())
    # x1..x4's rows: two bytes of every weight of conv s that reads x_j
    bidx = rdb_mod.slab_index_i8_bf16()
    breal = bidx[bidx >= 0]
    assert breal.numel() == len(set(breal.tolist()))
    offs = np.cumsum([0] + [9 * c * o for c, o in zip(CINS, COUTS)])
    want = set()
    for s in range(2, 6):
        cin, cout = CINS[s - 1], COUTS[s - 1]
        v = np.arange(9 * cin * cout).reshape(9, cin, cout)[:, 64:] + offs[s - 1]
        want |= set((2 * v).ravel().tolist()) | set((2 * v + 1).ravel().tolist())
    assert set(breal.tolist()) == want
    w = torch.randn(int(offs[-1])).bfloat16().float()
    bslabs = rdb_mod.pack_rdb_i8_bf16(w)
    assert bslabs.dtype == torch.uint8 and bslabs.numel() == bidx.numel()
    # stage 3's part (after stage 2's 5 slabs): x1's 18 k-steps, then x2's;
    # step 19 is x2's tap 0, channels 16..31 (conv 3's 112..127), in slab
    # 4 at k-step 3; output channel 3, value 5: bytes 10, 11 of its 32
    n, i, kb = 3, 5, 10
    at = (5 + 4) * 32 * 128 + n * 128 + ((2 * 3 + kb // 16) ^ (n % 8)) * 16 + kb % 16
    got = bslabs[at:at + 2].view(torch.bfloat16).float().item()
    val = w[int(offs[2]) + (64 + 32 + 16 + i) * 32 + n].item()
    assert got == val


def test_rdb_i8_wrapper_cpu_plain_and_refuses_other_devices():
    """On the CPU the wrapper is its plain version and counts no launch;
    another device raises."""
    p = rdb_tree(13)
    x = np.random.default_rng(14).normal(0, 0.5, (1, 9, 10, 64)).astype(np.float32)
    qp = mixed_qp(p, x)
    w, b = torch_weights(p, torch.bfloat16)
    wx8 = torch.from_numpy(qp["wx8"])
    deq = torch.from_numpy(qp["deq"])
    xt = torch.from_numpy(x).bfloat16()
    n0 = rdb_mod.LAUNCHES_I8
    got = rdb_mod.rdb_i8(xt, w, b, wx8, deq, float(qp["qm"]))
    assert torch.equal(got, rdb_mod.rdb_i8_reference(xt, w, b, wx8, deq,
                                                     float(qp["qm"])))
    assert rdb_mod.LAUNCHES_I8 == n0
    with pytest.raises(RuntimeError, match="unsupported device"):
        rdb_mod.rdb_i8(xt.to("meta"), w, b, wx8, deq, 1.0)


# --- the int8 engine ----------------------------------------------------------

@pytest.fixture(scope="module")
def int8_engines(tmp_path_factory):
    """'rrdb_tiny' (one unscaled block) registered in both registries; the
    JAX and the port's int8 engines on one .npz."""
    d = tmp_path_factory.mktemp("int8")
    save_params(unscaled_tree(15), d / "rrdb_tiny.npz")
    jax_registry.MODELS["rrdb_tiny"] = dict(TINY)
    registry.MODELS["rrdb_tiny"] = dict(TINY)
    kw = dict(weights_dir=d, tile_size=32, dtype="int8", pad_probe=False)
    yield (jax_engine_mod.SREngine("rrdb_tiny", **kw),
           engine_mod.SREngine("rrdb_tiny", device="cpu", **kw), d)
    jax_registry.MODELS.pop("rrdb_tiny", None)
    registry.MODELS.pop("rrdb_tiny", None)


def test_int8_engine_quantizes_as_jax(int8_engines):
    """The engine calibrates on JAX's input (synthetic 256², BGR): its
    scales within rtol 1e-5 of JAX's, ``precision`` "int8", bf16 compute,
    every RDB on the int8 path."""
    jeng, eng, _ = int8_engines
    assert eng.quantized and eng.precision == "int8"
    assert eng.dtype == torch.bfloat16 and eng.model.quantized
    jqm = np.asarray(jeng._qbody["rdb2"]["qm"])
    tqm = np.array([eng.model.body[0].rdb2.qm], np.float32)
    np.testing.assert_allclose(tqm, jqm, rtol=1e-5)
    n0 = rdb_mod.LAUNCHES
    img = np.random.default_rng(16).integers(0, 256, (20, 24, 3)).astype(np.uint8)
    out = eng.enhance(img)
    assert out.shape == (80, 96, 3) and out.dtype == np.uint8
    assert rdb_mod.LAUNCHES == n0


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) / 255 - b.astype(np.float64) / 255) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(1.0 / mse)


def test_int8_engine_tracks_jax(int8_engines):
    """The port's int8 engine against JAX's on the same (unscaled) weights,
    each calibrating itself: PSNR of the port's uint8 against JAX's above
    40 dB (the two frameworks' bf16 convs round in other places: their
    bf16 engines agree at 48.7 dB here, their int8 engines at 52.1 dB when
    written), and int8's loss against each package's own float32 engine
    above JAX's 35 dB bar and within 1 dB of JAX's (44.4 and 44.2 dB)."""
    jeng, eng, d = int8_engines
    img = np.random.default_rng(17).integers(0, 256, (40, 36, 3)).astype(np.uint8)
    got = eng.enhance_serving(img)
    want = np.asarray(jeng.enhance_serving(img))
    assert _psnr(got, want) > 40
    kw = dict(weights_dir=d, tile_size=32, dtype="float32", pad_probe=False)
    loss = _psnr(got, engine_mod.SREngine("rrdb_tiny", device="cpu", **kw)
                 .enhance_serving(img))
    jloss = _psnr(want, np.asarray(jax_engine_mod.SREngine("rrdb_tiny", **kw)
                                   .enhance_serving(img)))
    assert loss > 35 and abs(loss - jloss) < 1.0


@pytest.mark.parametrize("mode", ["mixed", "full"])
def test_int8_bucket_bit_equal_to_unpadded(mode):
    """quant(0) = 0: the masked 64-multiple bucket computes the unpadded
    int8 forward bit for bit, in float32 (on the CPU torch's bf16
    ``conv_first`` is not shape-invariant, so the bf16 engine's bucket is
    held bit for bit on the card, ``chip_smoke.py`` phase main)."""
    tree = unscaled_tree(20)
    model = port_model(tree, torch.float32)
    qbody = tq.quantize_rrdbnet(model, torch.rand(1, 32, 32, 3,
                                generator=torch.Generator().manual_seed(0)),
                                mode=mode)
    x = np.random.default_rng(21).random((1, 21, 27, 3)).astype(np.float32)
    xp = np.zeros((1, 64, 64, 3), np.float32)
    xp[:, :21, :27] = x
    mask = np.zeros((1, 64, 64, 1), np.float32)
    mask[:, :21, :27] = 1.0
    exact = tq.rrdbnet_apply_int8(model, qbody, torch.from_numpy(x), mode=mode)
    bucket = tq.rrdbnet_apply_int8(model, qbody, torch.from_numpy(xp),
                                   mask=torch.from_numpy(mask), mode=mode)
    assert torch.equal(bucket[:, :84, :108], exact)


def test_int8_serving_equals_exact_path(int8_engines):
    """``enhance_serving`` (fixed windows in power-of-two chunks) equals
    ``enhance`` byte for byte on the int8 engine: a bucketed image and a
    halo-tiled one."""
    _, eng, _ = int8_engines
    rng = np.random.default_rng(18)
    for shape in ((50, 42, 3), (72, 80, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        assert np.array_equal(eng.enhance_serving(img), eng.enhance(img))


def test_int8_coalesced_serving_matches_individual(int8_engines):
    """Coalesced int8 serving equals each image served alone, byte for
    byte (bucketed and tiled images mixed)."""
    _, eng, _ = int8_engines
    rng = np.random.default_rng(19)
    imgs = [rng.integers(0, 256, (40, 40, 3)).astype(np.uint8),
            rng.integers(0, 256, (50, 42, 3)).astype(np.uint8),
            rng.integers(0, 256, (72, 80, 3)).astype(np.uint8)]
    many = eng.enhance_serving_many(imgs)
    for img, out in zip(imgs, many):
        assert np.array_equal(out, eng.enhance_serving(img))


def test_int8_engine_cached_and_swinir_refused(int8_engines, tmp_path):
    """``get_engine`` caches the int8 engine by key beside the bf16 one;
    SwinIR refuses int8 with JAX's message."""
    _, _, d = int8_engines
    a = engine_mod.get_engine("rrdb_tiny", weights_dir=str(d), dtype="int8",
                              pad_probe=False, device="cpu")
    b = engine_mod.get_engine("rrdb_tiny", weights_dir=str(d), dtype="int8",
                              pad_probe=False, device="cpu")
    c = engine_mod.get_engine("rrdb_tiny", weights_dir=str(d),
                              dtype="bfloat16", pad_probe=False, device="cpu")
    assert a is b and a is not c and a.quantized and not c.quantized
    for key in [k for k in engine_mod._ENGINE_CACHE if k[0] == "rrdb_tiny"]:
        del engine_mod._ENGINE_CACHE[key]
    with pytest.raises(ValueError, match="dtype='int8' is only supported "
                                         "for rrdbnet"):
        engine_mod.SREngine("swinir_x4", weights_dir=tmp_path, dtype="int8",
                            device="cpu")
