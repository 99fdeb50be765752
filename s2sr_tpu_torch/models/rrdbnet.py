"""RRDBNet (Real-ESRGAN generator) as a PyTorch ``nn.Module``.

The forward of ``s2sr_tpu/models/rrdbnet.py::rrdbnet_apply``: 23 (or 6)
residual-in-residual dense blocks of three RDBs each, LeakyReLU 0.2,
two phase-split ×2 upsample convs for ×4. Parameter names are those of
the released checkpoints (``conv_first``, ``body.N.rdbJ.convK``, ...),
so a ``.pth`` state dict loads as it is.

- Public layout is NHWC float in [0, 1] → NHWC float32, as in JAX.
  Inside, the trunk runs in channels-last NCHW, whose memory is NHWC: a
  ``permute`` hands each RDB a contiguous (B, H, W, 64) view at no cost.
- Every residual dense block goes through :func:`s2sr_tpu_torch.ops.rdb.rdb`
  (the fused kernel on CUDA tensors), with and without the mask; after
  :meth:`RRDBNet.quantize` (the int8-mixed trunk, ``rrdbnet_int8.py``)
  through :func:`~s2sr_tpu_torch.ops.rdb.rdb_i8` instead.
- ``dtype`` is the compute dtype (bf16 or fp32); weights are cast per
  conv and sums round where the reference's do.
- ``mask`` (N, H, W[, 1]) of 0/1 re-zeroes every conv input outside the
  true rectangle, so a zero-padded bucket computes exactly the unpadded
  forward on it.

:func:`rrdbnet_apply` is the functional, differentiable forward the
trainer runs: any width, on a param tree in the JAX package's layout
(HWIO kernels, the RRDB stack on a leading ``body`` axis), its residual
dense blocks in plain ``F.conv2d`` (the kernel has no backward, as JAX
training runs XLA's convs), each RRDB block optionally rematerialised.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.rdb import G, NF, pack_rdb_weights, rdb, rdb_i8
from ..utils.precision import ieee_fp32


def _lrelu(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t >= 0, t, t * torch.tensor(0.2, dtype=t.dtype,
                                                    device=t.device))


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """3×3 SAME conv in ``dtype``, bias added after the conv."""
    out = F.conv2d(x.to(dtype), conv.weight.to(dtype), padding=1)
    return out + conv.bias.to(dtype).view(1, -1, 1, 1)


def _nearest_x2(t: torch.Tensor) -> torch.Tensor:
    return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _up_conv_fused(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """``conv3×3(nearest_×2(x))`` as one low-res conv C → 4C plus a ×2
    pixel shuffle: each output phase (dy, dx) sees combinations of the
    original taps (``rrdbnet.py::_up_conv_fused``)."""
    w = conv.weight.to(dtype).permute(2, 3, 1, 0)      # HWIO (3, 3, Cin, Cout)
    cin, cout = w.shape[2], w.shape[3]
    zero = torch.zeros_like(w[0])
    rows = {0: [w[0], w[1] + w[2], zero], 1: [zero, w[0] + w[1], w[2]]}

    def combine_cols(wr, dx):                           # wr: (3kx, Cin, Cout)
        zero_c = torch.zeros_like(wr[0])
        if dx == 0:
            return torch.stack([wr[0], wr[1] + wr[2], zero_c], 0)
        return torch.stack([zero_c, wr[0] + wr[1], wr[2]], 0)

    phases = []
    for dy in (0, 1):
        stacked = torch.stack(rows[dy], 0)
        for dx in (0, 1):
            phases.append(torch.stack(
                [combine_cols(stacked[ky], dx) for ky in range(3)], 0))
    w4 = torch.stack(phases, dim=-1).reshape(3, 3, cin, cout * 4)
    out = F.conv2d(x.to(dtype), w4.permute(3, 2, 0, 1), padding=1)
    out = out + conv.bias.to(dtype).repeat_interleave(4).view(1, -1, 1, 1)
    return F.pixel_shuffle(out, 2)                      # channel c*4+dy*2+dx


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int = NF, num_grow_ch: int = G):
        super().__init__()
        for k in range(1, 6):
            cin = num_feat + (k - 1) * num_grow_ch
            cout = num_grow_ch if k < 5 else num_feat
            setattr(self, f"conv{k}", nn.Conv2d(cin, cout, 3, padding=1))
        # kernel weights, filled by pack(); buffers so .to() moves them
        self.register_buffer("w_packed", None, persistent=False)
        self.register_buffer("b_packed", None, persistent=False)
        self.packed_dtype: torch.dtype | None = None
        # the int8 x conv, set by quantize(): HWIO weights, dequantization
        # factors, x's quantization multiplier
        self.register_buffer("wx8", None, persistent=False)
        self.register_buffer("deq", None, persistent=False)
        self.qm: float | None = None

    def pack(self, dtype: torch.dtype) -> None:
        """Pack the five convs' weights for the kernel in ``dtype``."""
        convs = [getattr(self, f"conv{k}") for k in range(1, 6)]
        self.w_packed, self.b_packed = pack_rdb_weights(
            [c.weight for c in convs], [c.bias for c in convs], dtype)
        self.packed_dtype = dtype

    def quantize(self, wx8: torch.Tensor, deq: torch.Tensor, qm) -> None:
        """Run the x conv in int8 from now on: ``wx8`` (3, 3, 64, 192) int8
        HWIO, ``deq`` (192,) float32, ``qm`` (one RDB of
        ``rrdbnet_int8.quantize_body_mixed``)."""
        dev = self.conv1.weight.device
        self.wx8 = wx8.to(dev).contiguous()
        self.deq = deq.to(dev, torch.float32).contiguous()
        self.qm = float(qm)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        """(B, H, W, 64) → same; ``mask`` float32 (B, H, W) or None."""
        if self.packed_dtype != x.dtype:
            raise RuntimeError(f"RDB weights packed for {self.packed_dtype}, "
                               f"input is {x.dtype}: call RRDBNet.pack()")
        if self.wx8 is not None:
            return rdb_i8(x.contiguous(), self.w_packed, self.b_packed,
                          self.wx8, self.deq, self.qm, mask)
        return rdb(x.contiguous(), self.w_packed, self.b_packed, mask)


class RRDB(nn.Module):
    def __init__(self, num_feat: int = NF, num_grow_ch: int = G):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)


class RRDBNet(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = NF, num_block: int = 23,
                 num_grow_ch: int = G, scale: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if num_feat != NF or num_grow_ch != G:
            raise ValueError(f"the fused RDB kernel is built for {NF} "
                             f"features and growth {G}")
        if scale not in (2, 4):
            raise ValueError(f"scale must be 2 or 4, got {scale}")
        self.scale = scale
        self.dtype = dtype
        self.quantized = False
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, padding=1)
        self.body = nn.ModuleList(RRDB(num_feat, num_grow_ch)
                                  for _ in range(num_block))
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, padding=1)

    def pack(self) -> "RRDBNet":
        """Pack every RDB's weights for the kernel in ``self.dtype``. Call
        after loading the weights, and again if they or ``dtype`` change;
        ``.to(device)`` moves the packed weights with the rest."""
        for block in self.body:
            for r in (block.rdb1, block.rdb2, block.rdb3):
                r.pack(self.dtype)
        return self

    def quantize(self, qbody: dict) -> "RRDBNet":
        """Serve the int8-mixed trunk of ``qbody``
        (``rrdbnet_int8.quantize_body_mixed``: stacked per block)."""
        for i, block in enumerate(self.body):
            for j in (1, 2, 3):
                q = qbody[f"rdb{j}"]
                getattr(block, f"rdb{j}").quantize(q["wx8"][i], q["deq"][i],
                                                   q["qm"][i])
        self.quantized = True
        return self

    def _upsample(self, f, m2=None, m4=None):
        dtype = self.dtype
        mtop = m4 if self.scale == 4 else m2
        f = _lrelu(_up_conv_fused(f, self.conv_up1, dtype))
        if m2 is not None:
            f = f * m2
        if self.scale == 4:
            f = _lrelu(_up_conv_fused(f, self.conv_up2, dtype))
            if m4 is not None:
                f = f * m4
        f = _lrelu(_conv(f, self.conv_hr, dtype))
        if mtop is not None:
            f = f * mtop
        return _conv(f, self.conv_last, dtype).float()

    @torch.no_grad()
    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                up_sub_batch: int | None = None, rdb_fn=None) -> torch.Tensor:
        """(N, H, W, C) float in [0, 1] → (N, sH, sW, C) float32. A float32
        model runs its convs in IEEE float32 (TF32 off), as JAX does.
        ``rdb_fn(index, x, mask)`` replaces the residual dense blocks
        (index 0 .. 3·blocks − 1; x NHWC, mask (N, H, W) or None)."""
        with ieee_fp32(self.dtype == torch.float32):
            return self._forward(x, mask, up_sub_batch, rdb_fn)

    def _forward(self, x, mask, up_sub_batch, rdb_fn=None):
        dtype = self.dtype
        n, h, w, _ = x.shape
        x = x.permute(0, 3, 1, 2)
        mk = mask_k = None
        if mask is not None:
            # cast once: a float32 mask would upcast every bf16 product
            mk = mask.reshape(n, 1, h, w).to(dtype)
            mask_k = mask.reshape(n, h, w).float().contiguous()

        def m(t):
            return t if mk is None else t * mk

        slope = torch.tensor(0.2, dtype=dtype, device=x.device)
        feat = m(_conv(x, self.conv_first, dtype))
        body = feat.contiguous(memory_format=torch.channels_last)
        for i, block in enumerate(self.body):
            out = body.permute(0, 2, 3, 1)                   # NHWC view
            for j, r in enumerate((block.rdb1, block.rdb2, block.rdb3)):
                out = (r(out, mask_k) if rdb_fn is None
                       else rdb_fn(3 * i + j, out, mask_k))
            body = (out.permute(0, 3, 1, 2) * slope + body).contiguous(
                memory_format=torch.channels_last)
        feat = m(feat + _conv(body, self.conv_body, dtype))

        m2 = m4 = None
        if mk is not None:
            m2 = _nearest_x2(mk)
            m4 = _nearest_x2(m2)
        if up_sub_batch and 0 < up_sub_batch < n:
            outs = []
            for i in range(0, n, up_sub_batch):
                sl = slice(i, i + up_sub_batch)
                outs.append(self._upsample(
                    feat[sl], None if m2 is None else m2[sl],
                    None if m4 is None else m4[sl]))
            out = torch.cat(outs, 0)
        else:
            out = self._upsample(feat, m2, m4)
        return out.permute(0, 2, 3, 1)


# --- the functional forward (training) -----------------------------------

class _Conv(NamedTuple):
    """One conv's OIHW weight and bias, as ``_conv`` reads them."""

    weight: torch.Tensor
    bias: torch.Tensor


def _oihw(p: dict) -> _Conv:
    """A JAX-layout conv ``{"kernel": HWIO, "bias"}`` as OIHW views."""
    return _Conv(p["kernel"].permute(3, 2, 0, 1), p["bias"])


def _pack_body(body: dict, dtype) -> list:
    """Per block and RDB, the per-source wide kernels of
    ``rrdbnet.py::_rdb_packed`` (``wx``: conv5..conv1's x slices → the
    accumulator ``[a5|a4|a3|a2|a1]``; ``w1``..``w4`` likewise) and the
    five biases, in ``dtype``, built once over the stacked block axis:
    casting and slicing commute, so these are the values a per-conv cast
    gives."""
    blocks = None
    for name, convs in body.items():
        k = {i: convs[f"conv{i}"]["kernel"].to(dtype).permute(0, 4, 3, 1, 2)
             for i in range(1, 6)}                  # (nb, O, I, 3, 3)
        g, nf = k[1].shape[1], k[1].shape[2]

        def wide(lo, hi, srcs):
            return torch.cat([k[i][:, :, lo:hi] for i in srcs], 1).unbind(0)

        ws = (wide(0, nf, (5, 4, 3, 2, 1)), wide(nf, nf + g, (5, 4, 3, 2)),
              wide(nf + g, nf + 2 * g, (5, 4, 3)),
              wide(nf + 2 * g, nf + 3 * g, (5, 4)),
              wide(nf + 3 * g, nf + 4 * g, (5,)))
        bs = [convs[f"conv{i}"]["bias"].to(dtype)[:, None, :, None, None]
              .unbind(0) for i in range(1, 6)]
        if blocks is None:
            blocks = [dict() for _ in ws[0]]
        for j, blk in enumerate(blocks):
            blk[name] = ([w[j] for w in ws], [b[j] for b in bs])
    return blocks


def _rdb_train(x: torch.Tensor, ws: list, bs: list, slope: float,
               mk=None) -> torch.Tensor:
    """One RDB (NCHW, in the weights' dtype) in ``_rdb_packed``'s order:
    the accumulator's 32-lane tail consumed per stage."""
    g = bs[0].shape[1]

    def lrelu(t):
        return torch.where(t >= 0, t, t * slope)

    def m(t):
        return t if mk is None else t * mk

    acc = F.conv2d(x, ws[0], padding=1)
    for k in range(1, 5):
        xk = m(lrelu(acc[:, -g:] + bs[k - 1]))
        acc = acc[:, :-g] + F.conv2d(xk, ws[k], padding=1)
    return m((acc + bs[4]) * slope + x)


def _rrdb_block(x: torch.Tensor, blk: dict, slope: float,
                mk=None) -> torch.Tensor:
    out = x
    for name in ("rdb1", "rdb2", "rdb3"):
        out = _rdb_train(out, *blk[name], slope, mk)
    return out * slope + x


def rrdbnet_apply(params: dict, x: torch.Tensor, scale: int = 4,
                  dtype: torch.dtype = torch.bfloat16, remat: bool = False,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """(N, H, W, C) float in [0, 1] → (N, sH, sW, C) float32 through the
    param tree ``params`` (the JAX layout: ``conv_first``, ``body`` with
    every leaf stacked over blocks, ``conv_body``, ``conv_up1``,
    ``conv_up2``, ``conv_hr``, ``conv_last``; HWIO kernels), differentiable
    in both. Each conv reads its input and weights in ``dtype``; float32
    runs with TF32 off. ``remat`` recomputes each RRDB block's
    activations in the backward pass instead of keeping them. ``mask``
    (N, H, W[, 1]) of 0/1 makes a zero-padded bucket compute the unpadded
    forward on the true rectangle."""
    with ieee_fp32(dtype == torch.float32):
        n, h, w, _ = x.shape
        xc = x.permute(0, 3, 1, 2)
        mk = None if mask is None else mask.reshape(n, 1, h, w).to(dtype)
        # 0.2 in the compute dtype, as JAX's weakly typed constant rounds
        slope = float(torch.tensor(0.2, dtype=dtype))

        def m(t):
            return t if mk is None else t * mk

        feat = m(_conv(xc, _oihw(params["conv_first"]), dtype))
        out = feat
        for blk in _pack_body(params["body"], dtype):
            if remat and torch.is_grad_enabled():
                out = checkpoint(_rrdb_block, out, blk, slope, mk,
                                 use_reentrant=False)
            else:
                out = _rrdb_block(out, blk, slope, mk)
        feat = m(feat + _conv(out, _oihw(params["conv_body"]), dtype))
        m2 = m4 = None
        if mk is not None:
            m2 = _nearest_x2(mk)
            m4 = _nearest_x2(m2)
        mtop = m4 if scale == 4 else m2
        f = _lrelu(_up_conv_fused(feat, _oihw(params["conv_up1"]), dtype))
        if m2 is not None:
            f = f * m2
        if scale == 4:
            f = _lrelu(_up_conv_fused(f, _oihw(params["conv_up2"]), dtype))
            if m4 is not None:
                f = f * m4
        f = _lrelu(_conv(f, _oihw(params["conv_hr"]), dtype))
        if mtop is not None:
            f = f * mtop
        out = _conv(f, _oihw(params["conv_last"]), dtype).float()
        return out.permute(0, 2, 3, 1)
