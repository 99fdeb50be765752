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


@pytest.mark.parametrize("variants", ["xla", "v4t9", "i8", "plain,wino"])
def test_ladder_refuses_unported_variants(variants, capsys):
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--variants", variants])
    assert "unknown" in capsys.readouterr().err


def test_ladder_runs_v1_alone(capsys):
    assert bench.main(["--device", "cpu", "--variants", "v1", "--shape",
                       "1,10,14", "--chain", "1", "--runs", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("check") or ln["variant"] for ln in lines] == ["v1_exact",
                                                                 "v1"]
