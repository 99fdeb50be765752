"""Port's RDB ablation ladder (``s2sr_tpu_torch.ops.rdb_ladder`` and
``s2sr_tpu_torch.bench.rdb_ladder``) against the JAX package's Pallas
rungs ``rdb_pallas`` (v1), ``rdb_pallas_v2`` and ``rdb_pallas_v3``
(interpret mode) and their packers.

On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those versions on the card by
``chip_smoke.py`` (phase ladder).
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.ops.pallas import fused_rdb as jax_rdb
from s2sr_tpu_torch.bench import rdb_ladder as bench
from s2sr_tpu_torch.ops import rdb_ladder as lad
from s2sr_tpu_torch.ops.rdb import pack_rdb_weights, rdb_reference
from torch_threads import one_torch_thread  # noqa: F401

JAX_PACK = {"v1": jax_rdb.pack_rdb_weights, "v2": jax_rdb.pack_rdb_weights_v2,
            "v3": jax_rdb.pack_rdb_weights_v3}
# v1 has one tile (64); the delta-form rungs run at tile 32 here
JAX_RUNG = {"v1": jax_rdb.rdb_pallas,
            "v2": functools.partial(jax_rdb.rdb_pallas_v2, tile=32),
            "v3": functools.partial(jax_rdb.rdb_pallas_v3, tile=32)}
PORT_PACK = lad.PACKERS
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module")
def rdb_params():
    """One RDB at the kernel's widths with plain Kaiming weights (the
    model's init without its 0.1 scale, so x1..x4 move the output) and
    nonzero biases."""
    rng = np.random.default_rng(3)
    p = {}
    for k in range(1, 6):
        cin, cout = 64 + 32 * (k - 1), 32 if k < 5 else 64
        p[f"conv{k}"] = {
            "kernel": (rng.normal(size=(3, 3, cin, cout))
                       * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
            "bias": rng.normal(0, 0.05, cout).astype(np.float32)}
    return p


def torch_kernels(p):
    kernels = [torch.from_numpy(np.transpose(p[f"conv{k}"]["kernel"],
                                             (3, 2, 0, 1)).copy())
               for k in range(1, 6)]
    biases = [torch.from_numpy(p[f"conv{k}"]["bias"]) for k in range(1, 6)]
    return kernels, biases


def flat(packed):
    blocks, b14, b5 = packed
    return (*blocks, b14, b5)


def jax_rung(p, rung, x, dtype):
    jp = JAX_PACK[rung](jax.tree.map(jnp.asarray, p), dtype=JAX_DTYPE[dtype])
    out = JAX_RUNG[rung](jnp.asarray(x, JAX_DTYPE[dtype]), *jp,
                         interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rung", lad.RUNGS)
def test_packers_equal_jax(rdb_params, rung, dtype):
    want = flat(JAX_PACK[rung](jax.tree.map(jnp.asarray, rdb_params),
                               dtype=JAX_DTYPE[dtype]))
    got = flat(PORT_PACK[rung](*torch_kernels(rdb_params), dtype))
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(1, 32, 32), (2, 70, 50), (1, 12, 12)])
@pytest.mark.parametrize("rung", lad.RUNGS)
def test_reference_matches_jax_rung(rdb_params, rung, shape):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 0.5, (*shape, 64)).astype(np.float32)
    want = jax_rung(rdb_params, rung, x, torch.float32)
    packed = PORT_PACK[rung](*torch_kernels(rdb_params), torch.float32)
    got = lad.REFERENCES[rung](torch.from_numpy(x), packed)
    # fp32, the same staged products (v1's zero rows included); only
    # their summation order differs
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("rung", lad.RUNGS)
def test_bf16_reference_tracks_jax_rung(rdb_params, rung):
    rng = np.random.default_rng(9)
    x = rng.normal(0, 0.5, (1, 24, 20, 64)).astype(np.float32)
    want = jax_rung(rdb_params, rung, x, torch.bfloat16)
    packed = PORT_PACK[rung](*torch_kernels(rdb_params), torch.bfloat16)
    got = lad.REFERENCES[rung](torch.from_numpy(x).bfloat16(), packed)
    # both round at the same places (every product and slot add in v2/v3;
    # p1..p4 and x_k in v1), but XLA on the CPU may skip a rounding
    # (excess precision), so allow a few bf16 ulps at |v| < 2
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -5)


@pytest.mark.parametrize("rung", lad.RUNGS)
def test_reference_matches_rdb_reference(rdb_params, rung):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 19, 23, 64)).astype(np.float32))
    kernels, biases = torch_kernels(rdb_params)
    w, b = pack_rdb_weights(kernels, biases, torch.float32)
    want = rdb_reference(x, w, b)
    got = lad.REFERENCES[rung](x, PORT_PACK[rung](kernels, biases,
                                                  torch.float32))
    assert (want - x).abs().max() > 0.3          # the block does work
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("rung", lad.RUNGS)
def test_pack_from_flat_weights(rdb_params, rung):
    kernels, biases = torch_kernels(rdb_params)
    w, b = pack_rdb_weights(kernels, biases, torch.bfloat16)
    got = flat(lad.pack_ladder_weights(w, b, rung, torch.bfloat16))
    want = flat(PORT_PACK[rung](kernels, [bb.bfloat16().float()
                                          for bb in biases], torch.bfloat16))
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


@pytest.mark.parametrize("rung", lad.RUNGS)
def test_cpu_wrapper_takes_plain_path(rdb_params, rung):
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(0, 0.5, (1, 18, 22, 64)).astype(np.float32))
    packed = PORT_PACK[rung](*torch_kernels(rdb_params), torch.float32)
    before = dict(lad.LAUNCHES)
    got = lad.WRAPPERS[rung](x, packed)
    assert lad.LAUNCHES == before == {"v1": 0, "v2": 0, "v3": 0}
    assert torch.equal(got, lad.REFERENCES[rung](x, packed))


@pytest.mark.parametrize("rung", lad.RUNGS)
def test_wrapper_refuses_other_devices(rdb_params, rung):
    blocks, b14, b5 = PORT_PACK[rung](*torch_kernels(rdb_params),
                                      torch.float32)
    packed = (tuple(t.to("meta") for t in blocks), b14.to("meta"),
              b5.to("meta"))
    x = torch.empty(1, 4, 4, 64, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        lad.WRAPPERS[rung](x, packed)


def test_pack_rejects_wrong_widths():
    with pytest.raises(ValueError, match="conv1"):
        lad.pack_rdb_weights_v3([torch.zeros(16, 32, 3, 3)] * 5,
                                [torch.zeros(16)] * 5, torch.float32)


def test_v1_packer_zero_rows(rdb_params):
    """v1 carries x and the growth buffer at 128 lanes: the rows of x's
    pad lanes and of x_k..x4 in stage k's weights are zero, the rest are
    the conv kernels' rows."""
    (wx, *wg), _, _ = lad.pack_rdb_weights_v1(*torch_kernels(rdb_params),
                                              torch.float32)
    rows = lambda w: w.reshape(3, 3, 128, -1)                  # noqa: E731
    assert not rows(wx)[:, :, 64:].any() and rows(wx)[:, :, :64].abs().min() > 0
    for k, w in enumerate(wg, start=2):
        assert not rows(w)[:, :, 32 * (k - 1):].any()
        assert rows(w)[:, :, :32 * (k - 1)].abs().min() > 0


def test_ladder_runs_on_cpu(capsys):
    assert bench.main(["--device", "cpu", "--shape", "1,24,20",
                       "--chain", "2", "--runs", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    checks = {ln["check"]: ln for ln in lines if "check" in ln}
    assert set(checks) == {"v1_exact", "v2_exact", "v3_exact", "v4_exact"}
    assert all(c["max_err"] < c["tolerance"] == 1e-4 for c in checks.values())
    rows = [ln for ln in lines if "variant" in ln]
    assert [r["variant"] for r in rows] == ["plain", "v1", "v2", "v3", "v4"]
    for r in rows:
        assert r["shape"] == [1, 24, 20] and r["chain"] == 2
        assert r["device"] == "cpu" and r["card"] == "cpu"
        assert r["ms_per_chain"] > 0 and r["tf_s"] > 0
        assert r["ms_per_launch"] == pytest.approx(r["ms_per_chain"] / 2)


@pytest.mark.parametrize("variants", ["v4t9", "v4_no_fill", "v4_no_acc",
                                      "v4_serialdma"])
def test_ladder_refuses_unported_variants(variants, capsys):
    """The JAX ladder's v4 staging knobs, once refused as unknown: v4t9
    is refused with the shared-memory bytes that rule it out, v4_no_fill
    (no defined output) on the CPU; v4_no_acc and v4_serialdma run their
    plain versions on the CPU and emit one line each."""
    args = ["--device", "cpu", "--variants", variants, "--shape", "1,10,12",
            "--chain", "1", "--runs", "1"]
    if variants in ("v4t9", "v4_no_fill"):
        with pytest.raises(SystemExit):
            bench.main(args)
        err = capsys.readouterr().err
        assert "unknown" not in err
        want = (("200,704", "232,448", "31,744", "278,784")
                if variants == "v4t9" else ("no defined output", "card"))
        assert all(w in err for w in want), err
        return
    assert bench.main(args) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["variant"] for ln in lines] == [variants]
    assert lines[0]["shape"] == [1, 10, 12] and lines[0]["card"] == "cpu"
    assert lines[0]["ms_per_launch"] > 0


def test_ladder_runs_v1_alone(capsys):
    assert bench.main(["--device", "cpu", "--variants", "v1", "--shape",
                       "1,10,14", "--chain", "1", "--runs", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("check") or ln["variant"] for ln in lines] == ["v1_exact",
                                                                 "v1"]


# --- the JAX ladder's int8 and Winograd variants -----------------------------
#
# scripts/bench_kernels.py keeps these formulas as closures in main(); they
# are rebuilt here in jax.numpy from its lines (i8 and i8mix call the JAX
# package's own blocks with the ladder's scales).

def _jax_quantized(p):
    from s2sr_tpu.models import rrdbnet_int8 as jq

    ws = jq._pack_rdb_kernels(p)
    return ws, [jq._quantize_kernel(w) for w in ws]


def _conv_i32(x8, w8):
    return jax.lax.conv_general_dilated(
        x8, w8, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)


def jax_i8(p, x):
    """``bench_kernels.py:165-181``."""
    from s2sr_tpu.models import rrdbnet_int8 as jq

    _, q = _jax_quantized(p)
    s_act = jnp.full((5,), 1.0 / 127.0, jnp.float32)
    qp = {"w8": tuple(w for w, _ in q),
          "deq": tuple(d * s_act[i] for i, (_, d) in enumerate(q)),
          "qm": 1.0 / s_act,
          "b": tuple(p[f"conv{k}"]["bias"].astype(jnp.float32)
                     for k in range(1, 6))}
    return jq._rdb_packed_i8(x, qp, jnp.bfloat16)


def jax_i8mix(p, x):
    """``bench_kernels.py:314-354``: the mixed block, qm 127, deq s_w/127."""
    from s2sr_tpu.models import rrdbnet_int8 as jq

    _, q = _jax_quantized(p)
    wx8, sx_w = q[0]
    qp = {"wx8": wx8, "deq": (sx_w / 127.0).astype(jnp.float32),
          "qm": jnp.float32(127.0)}
    return jq._rdb_packed_mixed(x, p, qp, jnp.bfloat16)


def jax_i8fast(p, x):
    """``bench_kernels.py:183-219``."""
    _, q = _jax_quantized(p)
    w8s = [w for w, _ in q]
    deq_b = [(d / 127.0).astype(jnp.bfloat16) for _, d in q]
    qm_b = jnp.bfloat16(127.0)
    b_b = [p[f"conv{k}"]["bias"].astype(jnp.bfloat16) for k in range(1, 6)]

    def conv_i8f(x8, w8, d):
        return _conv_i32(x8, w8).astype(jnp.bfloat16) * d

    def quant_b(t):
        return jnp.clip(jnp.round(t * qm_b), -127, 127).astype(jnp.int8)

    def lrelu(t):
        return jnp.where(t >= 0, t, t * jnp.bfloat16(0.2))

    g = 32
    acc = conv_i8f(quant_b(x), w8s[0], deq_b[0])
    for k in range(1, 5):
        xk = quant_b(lrelu(acc[..., -g:] + b_b[k - 1]))
        acc = acc[..., :-g] + conv_i8f(xk, w8s[k], deq_b[k])
    x5 = acc + b_b[4]
    return x5 * jnp.bfloat16(0.2) + x


def jax_i8acc(p, x):
    """``bench_kernels.py:221-277``."""
    ws, _ = _jax_quantized(p)
    s192 = jnp.zeros((192,), jnp.float32)
    for wk in ws:
        co = wk.shape[-1]
        s192 = s192.at[:co].max(jnp.max(jnp.abs(wk), axis=(0, 1, 2)))
    s192 = jnp.maximum(s192, 1e-12) / 127.0
    w8s = [jnp.clip(jnp.round(wk / s192[:wk.shape[-1]]), -127, 127)
           .astype(jnp.int8) for wk in ws]
    s_a = 1.0 / 127.0
    d192 = (s192 * s_a).astype(jnp.float32)
    b_f = [p[f"conv{k}"]["bias"].astype(jnp.float32) for k in range(1, 6)]

    def quant_a(t):
        q = jnp.round(t.astype(jnp.float32) * (1.0 / s_a))
        return jnp.clip(q, -127, 127).astype(jnp.int8)

    g = 32

    def tail(acc32, k):
        co = acc32.shape[-1]
        t = acc32[..., -g:].astype(jnp.float32) * d192[co - g:co]
        t = t + b_f[k]
        return quant_a(jnp.where(t >= 0, t, t * 0.2))

    acc = _conv_i32(quant_a(x), w8s[0])
    for k in range(1, 5):
        acc = acc[..., :-g] + _conv_i32(tail(acc, k - 1), w8s[k])
    x5 = acc.astype(jnp.float32) * d192[:64] + b_f[4]
    return (x5 * 0.2).astype(jnp.bfloat16) + x


def jax_i8noq(p, x):
    """``bench_kernels.py:279-312``."""
    ws, _ = _jax_quantized(p)
    w8n = [jnp.clip(jnp.round(wk * 64), -127, 127).astype(jnp.int8)
           for wk in ws]
    g = 32
    acc = _conv_i32(x.astype(jnp.int8), w8n[0]).astype(jnp.bfloat16)
    for k in range(1, 5):
        xk = acc[..., -g:].astype(jnp.int8)
        acc = acc[..., :-g] + _conv_i32(xk, w8n[k]).astype(jnp.bfloat16)
    return acc * jnp.bfloat16(1e-4) + x


def jax_wino(p, x, dtype=jnp.bfloat16):
    """``bench_kernels.py:356-425``."""
    bt = jnp.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0],
                    [0, 1, 0, -1]], jnp.float32)
    gw = jnp.array([[1, 0, 0], [.5, .5, .5], [.5, -.5, .5], [0, 0, 1]],
                   jnp.float32)
    at = jnp.array([[1, 1, 1, 0], [0, 1, -1, -1]], jnp.float32)

    def wino_conv(t, u):
        n, hh, ww, c = t.shape
        tp = jnp.pad(t, ((0, 0), (1, 1), (1, 1), (0, 0)))
        th, tw = hh // 2, ww // 2
        d = jnp.stack([tp[:, r:r + 2 * th:2, s:s + 2 * tw:2, :]
                       for r in range(4) for s in range(4)])
        d = d.reshape(4, 4, n, th, tw, c)
        btd = bt.astype(dtype)
        v = jnp.einsum("ur,rsnhwc->usnhwc", btd, d)
        v = jnp.einsum("usnhwc,vs->uvnhwc", v, btd)
        m_ = jnp.einsum("uvnhwc,uvco->uvnhwo", v, u)
        atd = at.astype(dtype)
        y = jnp.einsum("iu,uvnhwo->ivnhwo", atd, m_)
        y = jnp.einsum("ivnhwo,jv->nhiwjo", y, atd)
        return y.reshape(n, hh, ww, u.shape[-1])

    from s2sr_tpu.models.rrdbnet import _lrelu, packed_prefix_kernels

    us = [jnp.einsum("ur,rsco,vs->uvco", gw, wk.astype(jnp.float32), gw)
          .astype(dtype) for wk in packed_prefix_kernels(p)]
    bs = [p[f"conv{k}"]["bias"].astype(dtype) for k in range(1, 6)]
    g = 32
    acc = wino_conv(x, us[0])
    for k in range(1, 5):
        xk = _lrelu(acc[..., -g:] + bs[k - 1])
        acc = acc[..., :-g] + wino_conv(xk, us[k])
    x5 = acc + bs[4]
    return x5 * jnp.asarray(0.2, dtype) + x


JAX_VARIANTS = {"i8": jax_i8, "i8mix": jax_i8mix, "i8fast": jax_i8fast,
                "i8acc": jax_i8acc, "i8noq": jax_i8noq, "wino": jax_wino}


@pytest.mark.parametrize("name", list(JAX_VARIANTS))
def test_int8_and_wino_variants_match_jax(rdb_params, name):
    """Each int8 and Winograd variant of the port's ladder (bf16, on the
    CPU: the wrappers' plain versions) against its JAX formula on the same
    bf16 x: bit for bit, but ``i8mix``, whose x1..x4 convs are bf16 convs
    that the frameworks round in other places (within 0.05 of max |out −
    x|, the mixed block's bound; one value of 21,504 one bf16 ulp apart
    when written). XLA:CPU keeps JAX's bf16 rounding points in
    ``i8fast``'s chain here, so no quantization step of slack is
    needed."""
    x = np.random.default_rng(5).normal(0, 0.5, (2, 12, 14, 64))
    xb = torch.from_numpy(x.astype(np.float32)).bfloat16()
    got = bench.variant_fns([name], *torch_kernels(rdb_params),
                            torch.bfloat16, "cpu")[name](xb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(JAX_VARIANTS[name](
        jax.tree.map(jnp.asarray, rdb_params),
        jnp.asarray(xb.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    change = np.abs(want - xb.float().numpy()).max()
    assert change > 0.3
    tol = 0.05 * change if name == "i8mix" else 0.0
    assert np.abs(got - want).max() <= tol


def test_xla_int8_is_xla_conversion():
    """``i8noq``'s casts follow XLA's float → int8 conversion, found here
    on the CPU: truncate toward zero, clamp to [-128, 127], NaN to 0."""
    v = np.array([300.7, -300.7, 127.9, -128.9, -129.5, 2.9, -2.9, 1e6,
                  -1e6, np.nan, np.inf, -np.inf, 0.5, -0.5], np.float32)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jnp.asarray(v, dt).astype(jnp.int8))
        got = bench.xla_int8(torch.from_numpy(v).to(tdt))
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), want)


def test_ladder_runs_int8_variants_on_cpu(capsys):
    """A ``--device cpu`` run of the new variants at a tiny shape: only
    ``wino`` is gated (within 1e-3 in float32, JAX's gate), and every
    variant gives its line."""
    names = ["xla", "xp", "i8", "i8fast", "i8acc", "i8noq", "i8mix", "wino"]
    assert bench.main(["--device", "cpu", "--variants", ",".join(names),
                       "--shape", "1,8,10", "--chain", "1", "--runs",
                       "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    checks = [ln for ln in lines if "check" in ln]
    assert [c["check"] for c in checks] == ["wino_close"]
    assert checks[0]["max_err"] < checks[0]["tolerance"] == 1e-3
    rows = [ln for ln in lines if "variant" in ln]
    assert [r["variant"] for r in rows] == names
    assert all(r["shape"] == [1, 8, 10] and r["ms_per_chain"] > 0
               for r in rows)
