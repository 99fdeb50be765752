"""The int8 (W8A8) quantized RRDBNet trunk: the port of
``s2sr_tpu/models/rrdbnet_int8.py``.

Engine ``dtype="int8"`` (the ``precision="int8"`` / ``"turbo"`` request
field) serves the **mixed** formulation: only the packed 64→192 x conv of
each residual dense block runs in int8, the four growth convs stay in the
model dtype. On the card every such block runs in the int8 instance of
the fused RDB kernel (``ops/rdb.py::rdb_i8``); on the CPU in its plain
version. The **full** formulation (all five convs W8A8, JAX's measured
harness) is reached, as in JAX, through ``quantize_rrdbnet(mode="full")``
and ``rrdbnet_apply_int8(mode="full")``: on the card every block runs the
all-int8 kernel ``ops/rdb.py::rdb_w8a8`` (its operands packed once per
quantized body and device), on the CPU ``rdb_w8a8_reference``.

Scheme, as in the JAX package:

- weights: per-output-channel symmetric int8 on the packed per-source
  kernels (:func:`_pack_rdb_kernels`), scale ``max|k| / 127`` over
  (kh, kw, cin);
- activations: per-tensor symmetric int8 with static scales, calibrated
  once per weight set by one float32 forward (:func:`calibrate_act_scales`),
  ``round(x·qm)`` half to even, clamped to ±127;
- the int8 products sum exactly and are dequantized by ``s_act·s_w[cout]``
  into the model dtype; biases, LeakyReLU, the prefix accumulator and the
  0.2 residuals are unchanged.

quant(0) = 0, so a zero-padded bucket with its mask computes the unpadded
int8 forward bit for bit, as in the float model.

Over the ``sp`` axis the int8 engines serve the band forward of
``rrdbnet.py::rrdbnet_bands`` as the float ones do: each quantized block
runs ``rdb_i8`` on its 5-row extended band and keeps the band's rows.
Full mode takes the band forward the same way, through
:func:`int8_rdb_fn` (``rdb_w8a8`` on each band's device).

Layouts follow the JAX package: kernels HWIO, activations NHWC, and a
quantized body (``qbody``) is a dict of stacked per-block tensors with
the JAX tree's keys, so :func:`qbody_from_jax` carries JAX's tree over
as it is. Parameters come from the port's :class:`~.rrdbnet.RRDBNet`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..ops.rdb import (pack_rdb_w8a8, pack_rdb_weights, quant_i8, rdb_i8,
                       rdb_i8_reference, rdb_w8a8)
from ..utils.precision import ieee_fp32
from .rrdbnet import RRDBNet, _conv, _lrelu, packed_prefix_kernels


def rdb_params(rdb) -> dict:
    """A ``ResidualDenseBlock``'s convs as the JAX tree has them:
    ``{"convK": {"kernel": HWIO float32, "bias": float32}}``."""
    return {f"conv{k}": {
        "kernel": getattr(rdb, f"conv{k}").weight.detach().float()
        .permute(2, 3, 1, 0),
        "bias": getattr(rdb, f"conv{k}").bias.detach().float()}
        for k in range(1, 6)}


def _rdbs(model: RRDBNet):
    """(block index, "rdbJ", module) over the trunk, in order."""
    for i, block in enumerate(model.body):
        for j in (1, 2, 3):
            yield i, f"rdb{j}", getattr(block, f"rdb{j}")


def _pack_rdb_kernels(p: dict) -> tuple:
    """The five per-source packed HWIO kernels in float32, columns in the
    prefix order ``[a5|a4|a3|a2|...]`` (:func:`.rrdbnet.packed_prefix_kernels`,
    the one definition of the layout)."""
    return tuple(w.float() for w in packed_prefix_kernels(p))


def _quantize_kernel(w: torch.Tensor) -> tuple:
    """Per-output-channel symmetric int8: ``(w8, scale[cout])``."""
    s = w.abs().amax(dim=(0, 1, 2)) / 127.0
    s = torch.clamp(s, min=1e-12)                   # all-zero channel guard
    w8 = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return w8, s.float()


def _conv_hwio(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 SAME conv of NHWC ``t`` with HWIO ``w``."""
    out = F.conv2d(t.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def _rdb_stats(x: torch.Tensor, p: dict) -> tuple:
    """float32 packed forward (NHWC) that also returns max|input| of each
    of the five convs."""
    g = p["conv1"]["kernel"].shape[-1]
    ws = _pack_rdb_kernels(p)
    maxes = [x.abs().amax()]
    acc = _conv_hwio(x, ws[0])
    for i in range(1, 5):
        xi = _lrelu(acc[..., -g:] + p[f"conv{i}"]["bias"])
        maxes.append(xi.abs().amax())
        acc = acc[..., :-g] + _conv_hwio(xi, ws[i])
    x5 = acc + p["conv5"]["bias"]
    return x5 * 0.2 + x, torch.stack(maxes)


@torch.no_grad()
def calibrate_act_scales(model: RRDBNet, x: torch.Tensor) -> torch.Tensor:
    """One float32 trunk forward on calibration input ``x`` (N, H, W, 3) in
    [0, 1], TF32 off; per-conv activation scales, shape (B, 3, 5)."""
    with ieee_fp32():
        x = x.float().to(model.conv_first.weight.device)
        feat = _conv(x.permute(0, 3, 1, 2), model.conv_first,
                     torch.float32).permute(0, 2, 3, 1)
        maxes = []
        for block in model.body:
            out, m1 = _rdb_stats(feat, rdb_params(block.rdb1))
            out, m2 = _rdb_stats(out, rdb_params(block.rdb2))
            out, m3 = _rdb_stats(out, rdb_params(block.rdb3))
            feat = out * 0.2 + feat
            maxes.append(torch.stack([m1, m2, m3]))
    return torch.clamp(torch.stack(maxes), min=1e-12) / 127.0


def _stack_blocks(per_block: list) -> dict:
    """[{rdbJ: {key: tensor or tuple}}] per block → stacked over blocks."""
    def stack(vals):
        if isinstance(vals[0], tuple):
            return tuple(torch.stack(v) for v in zip(*vals))
        return torch.stack(vals)

    return {r: {k: stack([blk[r][k] for blk in per_block])
                for k in per_block[0][r]} for r in per_block[0]}


@torch.no_grad()
def quantize_body(model: RRDBNet, act_scales: torch.Tensor) -> dict:
    """Full W8A8: per RDB the five int8 packed kernels ``w8``, folded
    dequantization factors ``deq[cout] = s_act·s_w``, inverse activation
    scales ``qm = 1/s_act`` and float32 biases ``b``."""
    blocks: list = [{} for _ in model.body]
    for i, name, rdb in _rdbs(model):
        p = rdb_params(rdb)
        s_act = act_scales[i, int(name[-1]) - 1]
        w8, deq, qm = [], [], []
        for k, w in enumerate(_pack_rdb_kernels(p)):
            k8, sw = _quantize_kernel(w)
            w8.append(k8)
            deq.append((sw * s_act[k]).float())
            qm.append((1.0 / s_act[k]).float())
        blocks[i][name] = {"w8": tuple(w8), "deq": tuple(deq),
                           "qm": torch.stack(qm),
                           "b": tuple(p[f"conv{k}"]["bias"]
                                      for k in range(1, 6))}
    return _stack_blocks(blocks)


@torch.no_grad()
def quantize_body_mixed(model: RRDBNet, act_scales: torch.Tensor) -> dict:
    """Mixed: only each RDB's packed 64→192 x conv is quantized —
    ``wx8`` (3, 3, 64, 192) int8, ``deq`` (192,), ``qm`` (scalar) per RDB,
    stacked over blocks."""
    blocks: list = [{} for _ in model.body]
    for i, name, rdb in _rdbs(model):
        s_act = act_scales[i, int(name[-1]) - 1]
        w8, sw = _quantize_kernel(_pack_rdb_kernels(rdb_params(rdb))[0])
        blocks[i][name] = {"wx8": w8, "deq": (sw * s_act[0]).float(),
                           "qm": (1.0 / s_act[0]).float()}
    return _stack_blocks(blocks)


def quantize_rrdbnet(model: RRDBNet, calib: torch.Tensor,
                     mode: str = "mixed") -> dict:
    """Calibrate and quantize in one step; ``calib`` (N, H, W, 3) in [0, 1]."""
    scales = calibrate_act_scales(model, calib)
    if mode == "mixed":
        return quantize_body_mixed(model, scales)
    if mode == "full":
        return quantize_body(model, scales)
    raise ValueError(f"unknown int8 mode {mode!r}")


def qbody_from_jax(tree) -> dict:
    """JAX's quantized tree (``quantize_rrdbnet``'s output as numpy leaves,
    e.g. through ``jax.tree.map(np.asarray, ...)``) as the port's."""
    if isinstance(tree, dict):
        return {k: qbody_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(qbody_from_jax(v) for v in tree)
    return torch.tensor(np.asarray(tree))


def _quant(x: torch.Tensor, qm) -> torch.Tensor:
    """``round(x·qm)`` clamped to ±127, int8 (NHWC)."""
    return quant_i8(x, qm).to(torch.int8)


def _rdb_packed_mixed(x: torch.Tensor, p: dict, qp: dict, dtype,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mixed RDB (NHWC; ``p`` :func:`rdb_params`, ``qp`` one RDB of
    :func:`quantize_body_mixed`): :func:`~..ops.rdb.rdb_i8_reference`."""
    kernels = [p[f"conv{k}"]["kernel"].permute(3, 2, 0, 1) for k in range(1, 6)]
    w, b = pack_rdb_weights(kernels, [p[f"conv{k}"]["bias"]
                                      for k in range(1, 6)], dtype)
    mk = None if mask is None else mask.reshape(*x.shape[:3]).float()
    return rdb_i8_reference(x.to(dtype), w, b, qp["wx8"], qp["deq"],
                            float(qp["qm"]), mk)


# full-W8A8 operands per quantized body (keyed by its first kernel) and
# device: packed once, not per launch
_W8A8_PACKS = WeakIdKeyDictionary()


def _w8a8_packs(qbody: dict, device) -> dict:
    """``{"rdbJ": W8A8Weights stacked over blocks}`` of a full-mode
    ``qbody`` on ``device``, packed on first use. A body changed in place
    after its first use on a device keeps its old operands there: pass
    a new body instead."""
    per_dev = _W8A8_PACKS.setdefault(qbody["rdb1"]["w8"][0], {})
    key = str(device)
    if key not in per_dev:
        per_dev[key] = {name: pack_rdb_w8a8({
            k: (tuple(t.to(device) for t in v) if isinstance(v, tuple)
                else v.to(device)) for k, v in q.items()})
            for name, q in qbody.items()}
    return per_dev[key]


def int8_rdb_fn(model: RRDBNet, qbody: dict, mode: str = "mixed"):
    """The ``rdb_fn(index, x, mask)`` hook of :meth:`RRDBNet.forward` and
    ``rrdbnet_bands`` that runs residual dense block ``index`` (0 ..
    3·blocks − 1) quantized: "mixed" in :func:`~..ops.rdb.rdb_i8` from
    ``model``'s packed float weights, "full" in
    :func:`~..ops.rdb.rdb_w8a8` (on a CUDA tensor the kernel, on the
    device the band lies on)."""
    if mode not in ("mixed", "full"):
        raise ValueError(f"unknown int8 mode {mode!r}")
    dtype = model.dtype
    rdbs = list(_rdbs(model))
    per_rdb = [{k: (tuple(t[i] for t in v) if isinstance(v, tuple) else v[i])
                for k, v in qbody[name].items()} for i, name, _ in rdbs]
    # x's multipliers as floats, read once (not one device sync a block)
    qms = ({name: q["qm"].tolist() for name, q in qbody.items()}
           if mode == "mixed" else None)

    def rdb_fn(index, out, mask_k):
        q, dev = per_rdb[index], out.device
        i, name, r = rdbs[index]
        if mode == "full":
            packed = (None if dev.type == "cpu"
                      else _w8a8_packs(qbody, dev)[name].block(i))
            return rdb_w8a8(out.contiguous(), q, mask_k, packed)
        if r.packed_dtype != dtype:
            raise RuntimeError(f"RDB weights packed for {r.packed_dtype}, "
                               f"model is {dtype}: call RRDBNet.pack()")
        return rdb_i8(out.contiguous(), r.w_packed, r.b_packed,
                      q["wx8"].to(dev), q["deq"].to(dev).contiguous(),
                      qms[name][i], mask_k)

    return rdb_fn


def rrdbnet_apply_int8(model: RRDBNet, qbody: dict, x: torch.Tensor,
                       up_sub_batch: int | None = None,
                       mask: torch.Tensor | None = None,
                       mode: str = "mixed") -> torch.Tensor:
    """Forward with the quantized trunk, in ``model.dtype``; the glue
    (conv_first, conv_body, upsample tail, masks, sub-batched tail) is the
    float model's, which must be packed. ``mode`` must match the one
    ``qbody`` was built with. The model is not changed.

    "mixed" runs every RDB in :func:`~..ops.rdb.rdb_i8`, "full" in
    :func:`~..ops.rdb.rdb_w8a8`: on the card their kernels (``rdb_w8a8``
    takes bfloat16 only), on the CPU their plain versions."""
    return model(x, mask=mask, up_sub_batch=up_sub_batch,
                 rdb_fn=int8_rdb_fn(model, qbody, mode))
