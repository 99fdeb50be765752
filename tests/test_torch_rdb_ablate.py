"""The v4 kernel's staging knobs in the port (``ops/rdb.py::rdb_ablated``,
``rdb_no_acc_reference``; ``bench/rdb_ladder.py``'s ``v4_*`` variants)
against the JAX package's ``rdb_pallas_v4`` knobs in interpret mode.

The knobs: ``ablate="no_acc"`` (each stage overwrites the accumulator, so
it reads the previous source alone), ``ablate="no_fill"`` (no defined
output), ``prefetch=False`` and ``stage_taps=9`` (both the RDB's own
function). The weights are one RDB at the model's init scale ×8, so the
block moves x and ``no_acc`` lies far from the block: at the init scale
alone the match would say little. On the CPU the wrapper runs the plain
versions; ``chip_smoke.py`` (phase ladder) holds the kernel instances to
them on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.ops.pallas.fused_rdb import (pack_rdb_weights_v2,
                                           pack_rdb_weights_v3)
from s2sr_tpu.ops.pallas.fused_rdb_v4 import rdb_pallas_v4
from s2sr_tpu_torch.bench import rdb_ladder as bench
from s2sr_tpu_torch.ops import rdb as rdb_mod
from s2sr_tpu_torch.ops.rdb import (pack_rdb_weights, rdb_ablated,
                                    rdb_no_acc_reference, rdb_reference)
from torch_threads import one_torch_thread  # noqa: F401

RDB_CU = Path(rdb_mod.__file__).resolve().parent.parent / "csrc" / "rdb.cu"
# (shape, JAX tile): one tile of a ragged image, and several with a batch
CASES = [((1, 40, 72), 64), ((2, 70, 50), 32)]
TOL = 1e-5


@pytest.fixture(scope="module")
def rdb_params():
    """One RDB at the kernel's widths: the model's init (normal ·
    sqrt(2 / fan_in) · 0.1) with every kernel ×8, nonzero biases."""
    rng = np.random.default_rng(5)
    p = {}
    for k in range(1, 6):
        cin, cout = 64 + 32 * (k - 1), 32 if k < 5 else 64
        p[f"conv{k}"] = {
            "kernel": (rng.normal(size=(3, 3, cin, cout))
                       * np.sqrt(2.0 / (9 * cin)) * 0.1 * 8).astype(np.float32),
            "bias": rng.normal(0, 0.05, cout).astype(np.float32)}
    return p


def torch_weights(p):
    kernels = [torch.from_numpy(np.transpose(p[f"conv{k}"]["kernel"],
                                             (3, 2, 0, 1)).copy())
               for k in range(1, 6)]
    biases = [torch.from_numpy(p[f"conv{k}"]["bias"]) for k in range(1, 6)]
    return pack_rdb_weights(kernels, biases, torch.float32)


def jax_v4(p, x, tile, **knobs):
    jp = jax.tree.map(jnp.asarray, p)
    packed, b14, b5 = pack_rdb_weights_v2(jp, dtype=jnp.float32)
    if knobs.get("stage_taps") == 9:
        packed9, _, _ = pack_rdb_weights_v3(jp, dtype=jnp.float32)
        packed = (packed[0],) + tuple(packed9[1:])     # v3's growth layouts
    return np.asarray(rdb_pallas_v4(jnp.asarray(x), packed, b14, b5,
                                    interpret=True, tile=tile, **knobs))


def inputs(shape, seed=7):
    return np.random.default_rng(seed).random((*shape, 64)).astype(np.float32)


@pytest.mark.parametrize("shape,tile", CASES)
def test_no_acc_reference_matches_jax_interpret(rdb_params, shape, tile):
    x = inputs(shape)
    want = jax_v4(rdb_params, x, tile, ablate="no_acc")
    w, b = torch_weights(rdb_params)
    got = rdb_no_acc_reference(torch.from_numpy(x), w, b).numpy()
    # float32, the same convs; only their summation order differs
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("shape,tile", CASES)
def test_no_acc_lies_far_from_the_block(rdb_params, shape, tile):
    """The control: at these weights the block moves x, and dropping the
    accumulate moves the output far beyond the match's tolerance."""
    x = torch.from_numpy(inputs(shape))
    w, b = torch_weights(rdb_params)
    full = rdb_reference(x, w, b)
    assert (full - x).abs().max().item() >= 1e-2
    assert (rdb_no_acc_reference(x, w, b) - full).abs().max().item() >= 1e-2


@pytest.mark.parametrize("knob", [{"prefetch": False}, {"stage_taps": 9}],
                         ids=["prefetch_false", "stage_taps_9"])
@pytest.mark.parametrize("shape,tile", CASES)
def test_jax_knobs_compute_the_rdb(rdb_params, shape, tile, knob):
    """``prefetch=False`` (``v4_serialdma``) and 9-tap staging (``v4t9``,
    which the port refuses) change how v4 stages, not what it computes:
    the port's ``rdb_reference``."""
    x = inputs(shape, seed=8)
    want = jax_v4(rdb_params, x, tile, **knob)
    w, b = torch_weights(rdb_params)
    got = rdb_reference(torch.from_numpy(x), w, b).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_no_acc_masked_bucket_equals_unpadded(rdb_params):
    """The masked path of the no_acc plain version (the kernel instance
    keeps the served epilogue's mask): a zero-padded, masked image equals
    the unpadded one on its rectangle, and is zero outside it."""
    x = torch.from_numpy(inputs((1, 21, 27), seed=9))
    w, b = torch_weights(rdb_params)
    want = rdb_no_acc_reference(x, w, b)
    xp = torch.zeros(1, 32, 32, 64)
    xp[:, :21, :27] = x
    mask = torch.zeros(1, 32, 32)
    mask[:, :21, :27] = 1
    got = rdb_no_acc_reference(xp, w, b, mask)
    torch.testing.assert_close(got[:, :21, :27], want, atol=1e-6, rtol=0)
    assert not got[:, 21:].any() and not got[:, :, 27:].any()


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_wrapper_runs_plain_versions(rdb_params, masked):
    x = torch.from_numpy(inputs((2, 18, 22), seed=10))
    mask = None
    if masked:
        mask = torch.zeros(2, 18, 22)
        mask[:, :15, :19] = 1
    w, b = torch_weights(rdb_params)
    before = dict(rdb_mod.LAUNCHES_ABLATED)
    full = rdb_reference(x, w, b, mask)
    assert torch.equal(rdb_ablated(x, w, b, "v4_serialdma", mask), full)
    assert torch.equal(rdb_ablated(x, w, b, "v4_no_acc", mask),
                       rdb_no_acc_reference(x, w, b, mask))
    assert rdb_mod.LAUNCHES_ABLATED == before


def test_no_fill_and_unknown_variants_raise(rdb_params):
    x = torch.zeros(1, 4, 4, 64)
    w, b = torch_weights(rdb_params)
    with pytest.raises(ValueError, match="no defined output"):
        rdb_ablated(x, w, b, "v4_no_fill")
    with pytest.raises(ValueError, match="unknown ablation"):
        rdb_ablated(x, w, b, "v4t9")
    with pytest.raises(RuntimeError, match="unsupported device"):
        rdb_ablated(x.to("meta"), w.to("meta"), b.to("meta"), "v4_no_acc")


def kernel_variants() -> dict:
    """``enum Variant`` of ``csrc/rdb.cu``: name → code."""
    body = re.search(r"enum Variant : int \{([^}]*)\}", RDB_CU.read_text())
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body.group(1))}


def test_variant_codes_match_the_kernel_source():
    """The codes are ``enum Variant``'s, and the instances they pick are
    the served ``wgmma`` kernel's (``rdb_wg_ablate_kernel<V>``, launched
    by ``launch_wg<V>``); the ``mma.sync`` design keeps none."""
    enum = kernel_variants()
    assert enum["SERVED"] == 0
    assert rdb_mod.ABLATIONS == {
        "v4_no_fill": enum["NO_FILL"], "v4_no_acc": enum["NO_ACC"],
        "v4_serialdma": enum["SERIAL_B"]}
    src = RDB_CU.read_text()
    for name in ("NO_FILL", "NO_ACC", "SERIAL_B"):
        assert f"case {name}: return launch_wg<{name}>(" in src
    assert "rdb_wg_ablate_kernel<V><<<" in src
    assert "rdb_tc_ablate_kernel" not in src


class FakeLib:
    """Records the arguments of ``s2sr_rdb_ablate_forward`` and returns
    ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def s2sr_rdb_ablate_forward(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.mark.parametrize("variant", sorted(rdb_mod.ABLATIONS))
def test_launch_passes_the_variant_code(rdb_params, variant, monkeypatch):
    monkeypatch.setattr(rdb_mod, "LAUNCHES_ABLATED",
                        dict.fromkeys(rdb_mod.ABLATIONS, 0))
    x = torch.zeros(2, 5, 7, 64, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    w, b = torch_weights(rdb_params)
    wf = rdb_mod.pack_rdb_wg(w)
    lib = FakeLib()
    rdb_mod._launch_ablated(lib, x, wf, b, None, out, variant, 1234)
    (args,) = lib.calls
    assert args == (x.data_ptr(), None, out.data_ptr(), wf.data_ptr(),
                    b.data_ptr(), 2, 5, 7, kernel_variants()[
                        {"v4_no_fill": "NO_FILL", "v4_no_acc": "NO_ACC",
                         "v4_serialdma": "SERIAL_B"}[variant]], 1234)
    assert rdb_mod.LAUNCHES_ABLATED[variant] == 1
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        rdb_mod._launch_ablated(FakeLib(98), x, wf, b, None, out, variant, 0)
    assert rdb_mod.LAUNCHES_ABLATED[variant] == 1


def test_v4t9_arithmetic():
    """The bytes of the refusal: the sources v4's kernel holds
    (``csrc/rdb.cu``'s x and x1..x4, also stated in its source) against
    the block's limit and the 9-tap copies."""
    n = bench.v4t9_bytes()
    assert n == {"held": 200_704, "free": 31_744, "side": 22,
                 "whole": 278_784, "per_warp": 9_216, "eight_warps": 73_728}
    src = RDB_CU.read_text()
    for v in ("200,704", "232,448", "278,784"):
        assert v in src
    msg = bench.v4t9_refusal()
    for v in ("200,704", "232,448", "31,744", "278,784", "73,728"):
        assert v in msg
