"""The port's int8-mixed trunk (``s2sr_tpu_torch.models.rrdbnet_int8``,
``ops/rdb.py::rdb_i8``) against the JAX package's
``s2sr_tpu/models/rrdbnet_int8.py``, on the CPU.

Weights and inputs come from numpy seeds and go to both packages; JAX's
quantized tree is carried to the port (``qbody_from_jax``) wherever a
test compares forwards, so both quantize with the same scales. On the
CPU the wrapper runs its plain version; the CUDA kernel's indexing is
emulated in numpy here and the kernel itself is held against the plain
version on the card by ``chip_smoke.py`` (phase kernel).
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
from test_torch_rdb import _swz, _unpack_b_slabs, torch_weights
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


# --- the int8 kernel's indexing, emulated in numpy --------------------------

TC_TILE, TC_HALO = 16, 5
COUTS = (32, 32, 32, 32, 64)


def _i8_layout():
    """Byte offsets of x (int8, 64 bytes a pixel) and x1..x4 (bf16) in the
    int8 kernel's shared memory (``tc_off(j, true)``)."""
    out, off = [], 0
    for j in range(5):
        side, ch = TC_TILE + 2 * (TC_HALO - j), 64 if j == 0 else 32
        out.append((off, side, ch))
        off += side * side * ch * (1 if j == 0 else 2)
    return out, off


def _unpack_q_slabs(wq: np.ndarray, cout: int) -> np.ndarray:
    """A stage's s8 B fragments (``[18][Cout/16][lane][16]``) read back as
    ``mma.m16n8k32`` reads them: lane 4g + t's byte 8h + 4a + e is row
    16a + 4t + e of column 16n + 8h + g."""
    pk = wq.reshape(18, cout // 16, 32, 16)
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    out = np.zeros((18, 32, cout), np.int64)
    for n in range(cout // 16):
        for h in range(2):
            for a in range(2):
                for e in range(4):
                    out[:, 16 * a + 4 * t + e, 16 * n + 8 * h + g] = \
                        pk[:, n, :, 8 * h + 4 * a + e]
    return out


def emulate_i8_rdb(x, wf, wq, deq, qm, bias, mask=None):
    """``rdb_i8_kernel`` in numpy, tile by tile: x quantized on load into
    its swizzled 4-chunk pixels, every k32 slab's A gathered as ldmatrix.x4
    returns it from the per-lane tap addresses, int64 sums dequantized by
    the stage's columns of ``deq``, then x1..x4's bf16 slabs (in float32)
    from the bf16 fragments past x's rows, and the residual read from x."""
    bsz, h, w, _ = x.shape
    layout, nbytes = _i8_layout()
    cins = (64, 96, 128, 160, 192)
    cols = (160, 128, 96, 64, 0)
    bslabs, qslabs, off, qoff = [], [], 0, 0
    for cin, cout in zip(cins, COUTS):
        n = 9 * cin * cout
        bslabs.append(_unpack_b_slabs(wf[off:off + n], cin, cout))
        qslabs.append(_unpack_q_slabs(wq[qoff:qoff + 576 * cout], cout))
        off += n
        qoff += 576 * cout
    lanes = np.arange(32)
    out = np.zeros_like(x)
    xq = np.clip(np.round(x * np.float32(qm)), -127, 127).astype(np.int64)
    for b in range(bsz):
        for oy0 in range(0, h, TC_TILE):
            for ox0 in range(0, w, TC_TILE):
                mem8 = np.full(layout[1][0], -999, np.int64)
                mem = np.full(nbytes // 2, np.nan, np.float32)  # by 2 bytes
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
                    d = deq[cols[s - 1]:cols[s - 1] + cout]
                    for mt in range((npix + 15) // 16):
                        pix = np.minimum(mt * 16 + lanes % 16, npix - 1)
                        py, px = pix // rs, pix % rs
                        iacc = np.zeros((16, cout), np.int64)
                        sp0 = (py + s - 1) * r0 + px + s - 1
                        k = 0
                        for tap in range(9):
                            toff = (tap // 3) * r0 + tap % 3
                            for c in range(2):
                                q = (sp0 + toff) * 4 + 2 * c + lanes // 16
                                rows = mem8[(_swz(q) * 16)[:, None] + np.arange(16)]
                                tile_a = np.concatenate([rows[:16], rows[16:]], 1)
                                assert (tile_a != -999).all()
                                iacc += tile_a @ qslabs[s - 1][k]
                                k += 1
                        acc = iacc.astype(np.float32) * d
                        k = 36                     # past x's bf16 rows
                        for j in range(1, s):
                            base, rj, cj = layout[j]
                            spj = (py + s - 1 - j) * rj + px + s - 1 - j
                            for tap in range(9):
                                toff = (tap // 3) * rj + tap % 3
                                for c in range(cj // 16):
                                    q = (spj + toff) * (cj // 8) + 2 * c + lanes // 16
                                    addr = base + _swz(q) * 16
                                    rows = mem[(addr // 2)[:, None] + np.arange(8)]
                                    tile_a = np.concatenate([rows[:16], rows[16:]], 1)
                                    acc += tile_a @ bslabs[s - 1][k]
                                    k += 1
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
                                mk = (mask[b, gy, gx] if mask is not None
                                      else 1.0) if ins else 0.0
                                val = np.where(v >= 0, v, 0.2 * v) * mk
                                for co in range(cout):
                                    addr = (layout[s][0] + _swz(p * 4 + co // 8) * 16
                                            + 2 * (co % 8))
                                    mem[addr // 2] = val[co] if ins else 0.0
                            else:
                                gy, gx = oy0 + ry, ox0 + rx
                                if gy >= h or gx >= w:
                                    continue
                                mk = mask[b, gy, gx] if mask is not None else 1.0
                                out[b, gy, gx] = (v * 0.2 + x[b, gy, gx]) * mk
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_i8_kernel_emulation_matches_reference(masked):
    """The int8 kernel's indexing (x quantized into swizzled 4-chunk
    pixels, per-lane ldmatrix tap addresses for k32 slabs, the s8
    B-fragment packer, the stage → packed-column map of deq, x1..x4's bf16
    slabs after x's rows, the residual from x), emulated on a 2×2-tile
    image in float32, gives the float32 plain version within rtol 1e-4 /
    atol 1e-5 (summation order)."""
    p = rdb_tree(11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(1, 18, 21, 64)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((1, 18, 21), np.float32)
        mask[:, :13, :17] = 1
        x = x * mask[..., None]
    qp = mixed_qp(p, x)
    w, b = torch_weights(p)
    wf = w[rdb_mod.fragment_index()].numpy()
    wx8 = torch.from_numpy(qp["wx8"])
    wq = rdb_mod.pack_rdb_i8_fragments(wx8)
    deq = torch.from_numpy(qp["deq"])
    got = emulate_i8_rdb(x, wf, wq.numpy().astype(np.int64), qp["deq"],
                         qp["qm"], b.numpy(), mask)
    want = rdb_mod.rdb_i8_reference(
        torch.from_numpy(x), w, b, wx8, deq, float(qp["qm"]),
        None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_i8_fragments_roundtrip_and_layout():
    """The s8 fragment index is a permutation (exact round trip) and
    puts each weight where m16n8k32 reads it."""
    idx = rdb_mod.fragment_index_i8()
    assert sorted(idx.tolist()) == list(range(9 * 64 * 192))
    wx8 = torch.randint(-127, 128, (3, 3, 64, 192), dtype=torch.int8)
    frag = rdb_mod.pack_rdb_i8_fragments(wx8)
    back = torch.empty_like(frag)
    back[idx] = frag
    assert torch.equal(back.view(3, 3, 64, 192), wx8)
    # stage 1 (packed columns 160..191), slab 0, lane 4g + t of n16 block
    # 0: bytes 8h + 4a + e are row 16a + 4t + e of column 160 + 8h + g
    g, t = 5, 3
    flat = wx8.reshape(576, 192)
    want = [int(flat[16 * a + 4 * t + e, 160 + 8 * h + g])
            for h in (0, 1) for a in (0, 1) for e in range(4)]
    assert frag[(4 * g + t) * 16:][:16].tolist() == want
    with pytest.raises(ValueError, match="int8"):
        rdb_mod.pack_rdb_i8_fragments(wx8.float())


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
