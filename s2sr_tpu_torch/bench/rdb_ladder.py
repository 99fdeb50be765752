"""The RDB ablation ladder: every fused-RDB formulation of the port, gated
for exactness and timed in chains on one card.

Port of ``scripts/bench_kernels.py``'s gate and timing. Variants:

- ``plain``: ``ops/rdb.py::rdb_reference`` (cuDNN convs), the counterpart
  of the JAX ladder's XLA variants ``xla`` / ``xp``;
- ``v1``, ``v2``, ``v3``: the K-packed concat rung and the delta-form
  rungs (``ops/rdb_ladder.py``): in bfloat16 ``v1`` and ``v3`` on the
  tensor cores (``csrc/rdb_ladder_tc.cu``), ``v2`` and the float32 gate
  on the CUDA cores (``csrc/rdb_ladder.cu``);
- ``v4``: ``ops/rdb.py::rdb``, the main path's kernel ``csrc/rdb.cu``
  (bf16 ``rdb_wg_kernel`` on ``wgmma``);
- ``v4_mma``: ``ops/rdb.py::rdb_mma``, the same block on the design it
  replaced (``rdb_tc_kernel``, ``mma.sync``), served by nothing: one call
  times both designs;
- the JAX ladder's int8 and Winograd variants (``scripts/bench_kernels.py``
  keeps them as closures in ``main()``; here they are importable
  functions): ``xla`` and ``xp`` (JAX's names for its XLA RDB, the port's
  ``plain``), ``i8`` (full W8A8, every activation scale 1/127: the kernel
  ``ops/rdb.py::rdb_w8a8``), ``i8mix`` (the mixed block, qm 127 and
  ``deq = s_w/127``: the kernel ``ops/rdb.py::rdb_i8``), ``i8fast``
  (quantization and dequantization in bf16), ``i8acc`` (joint per-channel
  scales, a raw int32 prefix accumulator), ``i8noq`` (a time-attribution
  ablation whose math is wrong on purpose) and ``wino`` (Winograd
  F(2×2, 3×3) as einsums). ``i8fast``, ``i8acc`` and ``i8noq`` take their
  int8 convs from ``ops/rdb.py::conv_i8_int`` (an int8 GEMM on the card)
  and run the rest as plain PyTorch, as XLA runs them in JAX;
- the JAX ladder's staging knobs of ``rdb_pallas_v4`` as time-attribution
  instances of ``v4``'s kernel (``ops/rdb.py::rdb_ablated``, never
  served): ``v4_no_fill`` (stages 1-4 skip their epilogue's stores and
  masking; no defined output, so ``--device cpu`` refuses it),
  ``v4_no_acc`` (each source's products overwrite the accumulator;
  ``rdb_no_acc_reference`` on the CPU) and ``v4_serialdma`` (each B slab
  copied only when the consumers reach it: no lookahead; the served
  math). ``v4t9``
  (9-tap growth staging) is refused with the shared-memory arithmetic
  that rules it out (:func:`v4t9_refusal`).

Each kernel variant is first gated in float32 at (1, 40, 72) against
``rdb_reference`` (max abs error < 1e-4; TF32 off), ``wino`` within 1e-3
(JAX's gate: the transforms round); the int8 variants have no gate, as
in JAX. Then a chain of
``--chain`` RDBs runs on one stream at ``--shape`` in bfloat16, ``--runs``
times back to back, each run fed the last one's output, timed with CUDA
events. One JSON line per variant: ``variant, shape, chain,
ms_per_chain, tf_s`` (useful TFLOP/s at 479,232 FLOP per pixel),
``compile_s`` (the first chain's seconds, kernel build included),
``ms_per_launch``, ``card``, and for the kernels the tiling and route and
the FLOP the kernel executes per output pixel (halo recompute included),
as the kernel source counts them.

``--device cpu`` runs the wrappers' plain versions (use a small
``--shape``): a check of the harness, not a measurement of a card.

Usage: python -m s2sr_tpu_torch.bench.rdb_ladder [--variants plain,v1,v2,v3,v4]
       (any of plain, v1..v4, xla, xp, i8, i8fast, i8acc, i8noq, i8mix, wino,
       v4_mma, v4_no_fill, v4_no_acc, v4_serialdma)
       [--runs 3] [--chain 12] [--shape 16,264,264] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models.weights import init_state_dict
from ..ops import rdb as rdb_mod
from ..ops import rdb_ladder as ladder_mod
from ..utils.precision import ieee_fp32

FLOP_PER_PIXEL = 2 * 9 * (64 * 192 + 32 * (160 + 128 + 96 + 64))
VARIANTS = ("plain", "v1", "v2", "v3", "v4")
INT8_VARIANTS = ("xla", "xp", "i8", "i8fast", "i8acc", "i8noq", "i8mix",
                 "wino")
# time-attribution instances of v4's kernel (ops/rdb.py::ABLATIONS)
ABLATION_VARIANTS = tuple(rdb_mod.ABLATIONS)
KNOWN = VARIANTS + INT8_VARIANTS + ("v4_mma",) + ABLATION_VARIANTS
# variants that launch a hand-written kernel on the card
KERNEL_VARIANTS = ("v1", "v2", "v3", "v4", "i8", "i8mix", "v4_mma") + ABLATION_VARIANTS
GATE_SHAPE = (1, 40, 72)
GATE_TOL = 1e-4
# float32 gates against rdb_reference: the kernel rungs, and Winograd's
# looser one (its transforms round)
GATES = {"v1": GATE_TOL, "v2": GATE_TOL, "v3": GATE_TOL, "v4": GATE_TOL,
         "wino": 1e-3}
G = 32
# the H100's shared memory a block may have, bytes
SMEM_BLOCK_MAX = 232_448


def v4t9_bytes() -> dict:
    """The shared-memory arithmetic that rules out ``v4t9``
    (``rdb_pallas_v4(stage_taps=9)``: a growth source's 9 taps staged side
    by side, K = 288) in v4's kernel, ``csrc/rdb.cu::rdb_wg_kernel`` (and
    in ``rdb_tc_kernel`` before it): tile 16, halo 5, source j's region
    16 + 2·(5 − j) pixels a side, x 64 and x1..x4 32 bf16 channels.
    ``held``: x and x1..x4; ``free``: what a block has left beside them;
    ``whole``: x1's 9 taps over stage 2's region; ``per_warp``: those of
    one 16-pixel M tile, for 8 warps."""
    def side(j):
        return 16 + 2 * (5 - j)

    held = sum(side(j) ** 2 * (64 if j == 0 else G) * 2 for j in range(5))
    per_warp = 16 * 9 * G * 2
    return {"held": held, "free": SMEM_BLOCK_MAX - held, "side": side(2),
            "whole": side(2) ** 2 * 9 * G * 2, "per_warp": per_warp,
            "eight_warps": 8 * per_warp}


def v4t9_refusal() -> str:
    """Why ``v4t9`` has no instance of v4's kernel (:func:`v4t9_bytes`)."""
    n = v4t9_bytes()
    ring = rdb_mod.rdb_wg_smem_plan()["total"] - n["held"]
    return (f"v4t9 has no instance of v4's kernel: rdb_wg_kernel holds x and "
            f"x1..x4 in {n['held']:,} B of the {SMEM_BLOCK_MAX:,} B of "
            f"shared memory a block may have, leaving {n['free']:,} B, "
            f"{ring:,} of them its B ring and barriers; a "
            f"9-tap copy of x1 over stage 2's {n['side']}x{n['side']} region "
            f"takes {n['whole']:,} B, and one of a 16-pixel M tile per warp "
            f"{n['per_warp']:,} B a warp, {n['eight_warps']:,} B for 8 "
            f"warps. Staging needs another tile or the delta form, another "
            f"kernel; 9-tap against 3-tap staging is on the ladder as v3 "
            f"against v2")


def card_name(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if device == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ladder_weights(seed: int = 0):
    """One RDB of the seeded ``realesrgan_x4`` init: five OIHW kernels and
    their (zero) biases."""
    sd = init_state_dict(num_block=1, seed=seed)
    return ([sd[f"body.0.rdb1.conv{k}.weight"] for k in range(1, 6)],
            [sd[f"body.0.rdb1.conv{k}.bias"] for k in range(1, 6)])


def jax_tree(kernels, biases) -> dict:
    """Five OIHW kernels and biases as one RDB of the JAX tree, float32:
    ``{"convK": {"kernel": HWIO, "bias"}}``."""
    return {f"conv{k}": {"kernel": kernels[k - 1].float().permute(2, 3, 1, 0),
                         "bias": biases[k - 1].float()} for k in range(1, 6)}


def _quantized_kernels(p: dict) -> tuple:
    """``_quantize_kernel`` of each packed kernel: ((w8, s_w), ...)."""
    from ..models.rrdbnet_int8 import _pack_rdb_kernels, _quantize_kernel

    return tuple(_quantize_kernel(w) for w in _pack_rdb_kernels(p))


def _conv_int(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """NHWC integer values ⊛ HWIO int8 kernel: the exact int32 sums as
    float32 (``conv_i8_int``: an int8 GEMM on the card)."""
    out = rdb_mod.conv_i8_int(x8.permute(0, 3, 1, 2), w8.permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1)


def xla_int8(t: torch.Tensor) -> torch.Tensor:
    """``t.astype(int8)`` as XLA converts a float: truncate toward zero,
    clamp to [-128, 127], NaN to 0 (not C's undefined cast)."""
    t = torch.nan_to_num(torch.trunc(t.float()), nan=0.0)
    return t.clamp(-128, 127).to(torch.int8)


def i8_params(p: dict) -> dict:
    """Variant ``i8`` (``bench_kernels.py:165-181``): one RDB quantized as
    ``quantize_body`` does, every activation scale 1/127; the ``qp`` of
    ``ops/rdb.py::rdb_w8a8``."""
    w8s, sws = zip(*_quantized_kernels(p))
    s_act = torch.full((5,), 1.0 / 127.0, dtype=torch.float32)
    return {"w8": tuple(w8s),
            "deq": tuple(d * s_act[i] for i, d in enumerate(sws)),
            "qm": 1.0 / s_act,
            "b": tuple(p[f"conv{k}"]["bias"].float() for k in range(1, 6))}


def i8mix_params(p: dict) -> tuple:
    """Variant ``i8mix`` (``bench_kernels.py:314-354``): the x conv's
    ``(wx8, deq = s_w/127, qm = 127)`` of ``ops/rdb.py::rdb_i8``."""
    wx8, sw = _quantized_kernels(p)[0]
    return wx8, (sw / 127.0).float(), 127.0


def i8fast_params(p: dict) -> dict:
    """Variant ``i8fast`` (``bench_kernels.py:183-219``): the int8 kernels,
    ``deq = s_w/127`` and the biases in bf16."""
    w8s, sws = zip(*_quantized_kernels(p))
    return {"w8": w8s,
            "deq": tuple((d / 127.0).to(torch.bfloat16) for d in sws),
            "b": tuple(p[f"conv{k}"]["bias"].to(torch.bfloat16)
                       for k in range(1, 6))}


def rdb_i8fast(x: torch.Tensor, q: dict) -> torch.Tensor:
    """``rdb_i8f``: the full-W8A8 block with quantization and
    dequantization in bf16 (``round(x·127)`` of a bf16 product, the int32
    sums rounded to bf16 and scaled in bf16); bf16 in and out."""
    qm = torch.tensor(127.0, dtype=torch.bfloat16, device=x.device)
    slope = torch.tensor(0.2, dtype=torch.bfloat16, device=x.device)

    def quant(t):
        return torch.round(t * qm).clamp(-127, 127)

    def conv(t8, k):
        return _conv_int(t8, q["w8"][k]).to(torch.bfloat16) * q["deq"][k]

    def lrelu(t):
        return torch.where(t >= 0, t, t * slope)

    acc = conv(quant(x), 0)
    for k in range(1, 5):
        xk = quant(lrelu(acc[..., -G:] + q["b"][k - 1]))
        acc = acc[..., :-G] + conv(xk, k)
    x5 = acc + q["b"][4]
    return x5 * slope + x


def i8acc_params(p: dict) -> dict:
    """Variant ``i8acc`` (``bench_kernels.py:221-277``): joint per-channel
    weight scales over the packed prefix lanes (lane c takes the largest
    |w| of every kernel that covers it), the kernels quantized with them,
    one activation scale 1/127, ``d192 = s192·s_a`` and float32 biases."""
    from ..models.rrdbnet_int8 import _pack_rdb_kernels

    ws = _pack_rdb_kernels(p)
    s192 = torch.zeros(192)
    for wk in ws:
        co = wk.shape[-1]
        s192[:co] = torch.maximum(s192[:co], wk.abs().amax(dim=(0, 1, 2)))
    s192 = torch.clamp(s192, min=1e-12) / 127.0
    w8s = tuple(torch.round(wk / s192[:wk.shape[-1]]).clamp(-127, 127)
                .to(torch.int8) for wk in ws)
    s_a = 1.0 / 127.0
    return {"w8": w8s, "d192": s192 * torch.tensor(s_a),
            "qa": torch.tensor(1.0 / s_a),
            "b": tuple(p[f"conv{k}"]["bias"].float() for k in range(1, 6))}


def rdb_i8acc(x: torch.Tensor, q: dict) -> torch.Tensor:
    """``rdb_i8acc``: the int32 sums of the five convs added in int32 (up
    to 5·127²·576 ≈ 4.6e7, past float32's exact integers) in the prefix
    accumulator, dequantized by ``d192`` only at each stage's 32-lane tail
    and the final 64 lanes; ``(x5·0.2)`` rounded to bf16, plus x."""
    d192, b = q["d192"], q["b"]

    def quant(t):
        return torch.round(t.float() * q["qa"]).clamp(-127, 127)

    def conv32(t8, k):
        return _conv_int(t8, q["w8"][k]).to(torch.int32)

    def tail(acc32, k):
        co = acc32.shape[-1]
        t = acc32[..., -G:].float() * d192[co - G:co] + b[k]
        return quant(torch.where(t >= 0, t, t * 0.2))

    acc = conv32(quant(x), 0)                           # int32, 192 lanes
    for k in range(1, 5):
        acc = acc[..., :-G] + conv32(tail(acc, k - 1), k)
    x5 = acc.float() * d192[:64] + b[4]
    return (x5 * 0.2).to(torch.bfloat16) + x


def i8noq_params(p: dict) -> tuple:
    """Variant ``i8noq`` (``bench_kernels.py:279-312``): each packed kernel
    times 64, rounded and clamped to int8."""
    from ..models.rrdbnet_int8 import _pack_rdb_kernels

    return tuple(torch.round(wk * 64).clamp(-127, 127).to(torch.int8)
                 for wk in _pack_rdb_kernels(p))


def rdb_i8noq(x: torch.Tensor, w8n: tuple) -> torch.Tensor:
    """``rdb_i8noq``: a time-attribution ablation whose math is wrong on
    purpose. The int8 convs with every quantization a bare cast
    (:func:`xla_int8`) and the accumulator in bf16; ``acc·1e-4 + x``."""
    def conv(t, k):
        return _conv_int(xla_int8(t).float(), w8n[k]).to(torch.bfloat16)

    acc = conv(x, 0)
    for k in range(1, 5):
        acc = acc[..., :-G] + conv(acc[..., -G:], k)
    return acc * torch.tensor(1e-4, dtype=torch.bfloat16) + x


# Winograd F(2×2, 3×3): input, kernel and output transforms
WINO_BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
WINO_G = ((1, 0, 0), (.5, .5, .5), (.5, -.5, .5), (0, 0, 1))
WINO_AT = ((1, 1, 1, 0), (0, 1, -1, -1))


def wino_u(wk: torch.Tensor, dtype) -> torch.Tensor:
    """An HWIO 3×3 kernel's Winograd transform ``G·w·Gᵀ`` (4, 4, Cin,
    Cout), in float32, rounded to ``dtype``."""
    gw = torch.tensor(WINO_G, dtype=torch.float32, device=wk.device)
    return torch.einsum("ur,rsco,vs->uvco", gw, wk.float(), gw).to(dtype)


def wino_conv(t: torch.Tensor, u: torch.Tensor, dtype) -> torch.Tensor:
    """3×3 SAME conv of NHWC ``t`` (even H and W) by Winograd: 4×4 input
    tiles at stride 2, ``Bᵀ·d·B``, 16 batched products with ``u``, then
    ``Aᵀ·m·A`` (``wino_conv`` of ``bench_kernels.py:382-397``)."""
    n, hh, ww, c = t.shape
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    th, tw = hh // 2, ww // 2
    d = torch.stack([tp[:, r:r + 2 * th:2, s:s + 2 * tw:2, :]
                     for r in range(4) for s in range(4)])
    d = d.reshape(4, 4, n, th, tw, c)
    btd = torch.tensor(WINO_BT, dtype=dtype, device=t.device)
    v = torch.einsum("ur,rsnhwc->usnhwc", btd, d)
    v = torch.einsum("usnhwc,vs->uvnhwc", v, btd)
    m = torch.einsum("uvnhwc,uvco->uvnhwo", v, u)
    atd = torch.tensor(WINO_AT, dtype=dtype, device=t.device)
    y = torch.einsum("iu,uvnhwo->ivnhwo", atd, m)
    y = torch.einsum("ivnhwo,jv->nhiwjo", y, atd)
    return y.reshape(n, hh, ww, -1)


def make_wino_rdb(p: dict, dtype):
    """Variant ``wino`` (``bench_kernels.py:356-425``): the packed-prefix
    RDB with every conv in :func:`wino_conv`, kernels transformed once,
    biases in ``dtype``."""
    from ..models.rrdbnet import _lrelu, packed_prefix_kernels

    us = tuple(wino_u(wk, dtype) for wk in packed_prefix_kernels(p))
    bs = tuple(p[f"conv{k}"]["bias"].to(dtype) for k in range(1, 6))

    def rdb_w(t):
        acc = wino_conv(t, us[0], dtype)
        for k in range(1, 5):
            xk = _lrelu(acc[..., -G:] + bs[k - 1])
            acc = acc[..., :-G] + wino_conv(xk, us[k], dtype)
        x5 = acc + bs[4]
        return x5 * torch.tensor(0.2, dtype=dtype, device=t.device) + t

    return rdb_w


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_on(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def variant_fns(variants, kernels, biases, dtype, device) -> dict:
    """name → one RDB on ``x`` with the variant's weights in ``dtype``."""
    w, b = (t.to(device) for t in rdb_mod.pack_rdb_weights(kernels, biases,
                                                           dtype))
    p = jax_tree(kernels, biases)
    fns = {}
    for name in variants:
        if name in ("plain", "xla", "xp"):
            fns[name] = lambda x: rdb_mod.rdb_reference(x, w, b)
        elif name == "v4":
            fns[name] = lambda x: rdb_mod.rdb(x, w, b)
        elif name == "v4_mma":
            fns[name] = lambda x: rdb_mod.rdb_mma(x, w, b)
        elif name in rdb_mod.ABLATIONS:
            fns[name] = (lambda x, name=name:
                         rdb_mod.rdb_ablated(x, w, b, name))
        elif name == "i8":
            qp = _on(i8_params(p), device)
            packed = None if device == "cpu" else rdb_mod.pack_rdb_w8a8(qp)
            fns[name] = (lambda x, qp=qp, packed=packed:
                         rdb_mod.rdb_w8a8(x, qp, packed=packed))
        elif name == "i8mix":
            wx8, deq, qm = _on(i8mix_params(p), device)
            fns[name] = (lambda x, wx8=wx8, deq=deq, qm=qm:
                         rdb_mod.rdb_i8(x, w, b, wx8, deq, qm))
        elif name in ("i8fast", "i8acc", "i8noq"):
            params = {"i8fast": i8fast_params, "i8acc": i8acc_params,
                      "i8noq": i8noq_params}[name](p)
            fn = {"i8fast": rdb_i8fast, "i8acc": rdb_i8acc,
                  "i8noq": rdb_i8noq}[name]
            fns[name] = (lambda x, fn=fn, q=_on(params, device): fn(x, q))
        elif name == "wino":
            fns[name] = make_wino_rdb(_on(p, device), dtype)
        else:
            blocks, b14, b5 = ladder_mod.pack_ladder_weights(w, b, name, dtype)
            packed = (tuple(t.to(device) for t in blocks), b14.to(device),
                      b5.to(device))
            # the tensor-core kernels' B images, packed once
            images = (ladder_mod.pack_tc_images(packed, name)
                      if device != "cpu" and dtype == torch.bfloat16
                      and name in ladder_mod.TC_RUNGS else None)
            fns[name] = (lambda x, fn=ladder_mod.WRAPPERS[name],
                         packed=packed, images=images: fn(x, packed, images))
    return fns


def kernel_info(name: str, shape, dtype, device: str) -> dict:
    """Tile and executed FLOP per output pixel (halo and padding included)
    of a kernel variant on the card; empty for ``plain`` or the CPU."""
    if device == "cpu" or name not in KERNEL_VARIANTS:
        return {}
    bsz, h, w = shape
    t = (rdb_mod.kernel_tiling(dtype) if name == "v4"
         or name in rdb_mod.ABLATIONS
         else rdb_mod.kernel_tiling_mma() if name == "v4_mma"
         else rdb_mod.kernel_tiling_w8a8() if name == "i8"
         else rdb_mod.kernel_tiling_i8() if name == "i8mix"
         else ladder_mod.kernel_tiling(name, dtype))
    tiles = bsz * math.ceil(h / t["tile"]) * math.ceil(w / t["tile"])
    executed = 2 * t.pop("macs_per_tile") * tiles / (bsz * h * w)
    return {**t, "executed_flop_per_pixel": executed,
            "executed_over_useful": executed / FLOP_PER_PIXEL}


def gate(fns32: dict, xs: torch.Tensor, w, b, emit) -> None:
    """Each gated variant in float32 against ``rdb_reference`` (TF32 off
    for every conv and product): max abs error under its :data:`GATES`
    tolerance."""
    with ieee_fp32():
        want = rdb_mod.rdb_reference(xs, w, b)
        for name, fn in fns32.items():
            err = (fn(xs) - want).abs().max().item()
            tol = GATES[name]
            emit({"check": f"{name}_exact" if tol == GATE_TOL
                  else f"{name}_close", "shape": list(xs.shape[:3]),
                  "max_err": err, "tolerance": tol})
            if not err < tol:
                raise AssertionError(f"{name} inexact on {xs.device}: {err}")


def sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def time_chain(fn, x, chain: int, runs: int, device: str):
    """(seconds of the first chain, ms per chain over ``runs`` chains fed
    back to back)."""
    def run(v):
        for _ in range(chain):
            v = fn(v)
        return v

    t0 = time.perf_counter()
    out = run(x)
    sync(device)
    first_s = time.perf_counter() - t0
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(runs):
            out = run(out)
        return first_s, (time.perf_counter() - t0) * 1e3 / runs
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        out = run(out)
    end.record()
    torch.cuda.synchronize()
    return first_s, start.elapsed_time(end) / runs


def ladder(variants=VARIANTS, shape=(16, 264, 264), chain: int = 12,
           runs: int = 3, device: str = "cuda", emit=None) -> list:
    """Gate and time ``variants``; returns (and emits) one dict per
    variant."""
    emit = emit or (lambda obj: print(json.dumps(obj), flush=True))
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("the ladder needs a CUDA device (or --device cpu)")
    card = card_name(device)
    kernels, biases = ladder_weights()
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.random((*GATE_SHAPE, 64)).astype(np.float32))
    w32, b32 = rdb_mod.pack_rdb_weights(kernels, biases, torch.float32)
    gate(variant_fns([v for v in variants if v in GATES], kernels, biases,
                     torch.float32, device),
         xs.to(device), w32.to(device), b32.to(device), emit)
    x = torch.from_numpy(rng.random((*shape, 64)).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
    useful = math.prod(shape) * FLOP_PER_PIXEL * chain
    lines = []
    for name, fn in variant_fns(variants, kernels, biases, torch.bfloat16,
                                device).items():
        first_s, ms = time_chain(fn, x, chain, runs, device)
        line = {"variant": name, "device": device, "shape": list(shape),
                "chain": chain, "runs": runs, "ms_per_chain": ms,
                "ms_per_launch": ms / chain, "tf_s": useful / ms / 1e9,
                "compile_s": first_s, "card": card,
                **kernel_info(name, shape, torch.bfloat16, device)}
        emit(line)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ",".join(KNOWN))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--chain", type=int, default=12)
    ap.add_argument("--shape", default="16,264,264", help="B,H,W")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    variants = [v for v in args.variants.split(",") if v]
    if "v4t9" in variants:
        ap.error(v4t9_refusal())
    if "v4_no_fill" in variants and args.device == "cpu":
        ap.error("v4_no_fill reads shared memory that nothing wrote: it has "
                 "no defined output and no plain version, so it runs only on "
                 "the card")
    unknown = sorted(set(variants) - set(KNOWN))
    if unknown or not variants:
        ap.error(f"unknown variants {unknown}: the port has "
                 f"{','.join(KNOWN)}")
    shape = tuple(int(v) for v in args.shape.split(","))
    if len(shape) != 3:
        ap.error("--shape is B,H,W")
    ladder(variants, shape, args.chain, args.runs, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
