"""SwinIR (classical SR, Swin-transformer trunk) as a PyTorch ``nn.Module``.

The forward of ``s2sr_tpu/models/swinir.py::SwinIR.apply``: reflect-pad
to window multiples → shallow conv → LayerNorm → residual Swin groups
(blocks with window attention, relative-position bias and shifted
windows, then a 3×3 conv and the group residual) → LayerNorm → conv and
the long skip → conv + LeakyReLU → pixel-shuffle upsampler → conv.
Parameter names are the released checkpoints' (``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.attn.qkv``,
``conv_before_upsample.0``, ``upsample.{0,2}``, ...), so a ``.pth`` state
dict loads with ``load_state_dict``.

- Public layout is NHWC float in [0, 1] → NHWC float32, as in JAX; the
  trunk keeps tokens as a contiguous (B, H, W, C) map.
- Every Swin block goes through :mod:`s2sr_tpu_torch.ops.window_attention`:
  the whole block in one kernel (``FUSED_LEVEL = "block"``, the default)
  or attention in the kernel and the MLP in plain ``torch``
  (``"attn"``). ``S2SR_SWINIR_FUSED_LEVEL`` sets it, as in JAX. The
  kernels take every window-multiple width; the JAX package's window
  pairing (``WINDOW_GROUP``) is not ported: unpaired windows compute the
  same terms.
- ``dtype`` is the compute dtype (bf16 or fp32). Weights are rounded to
  it once (:meth:`SwinIR.pack` builds the kernels' tables); LayerNorm
  statistics are float32 in both.
- Padding to window multiples reflects like ``numpy.pad(mode="reflect")``
  for any pad, including a pad at least the side and a side of 1 (where
  ``F.pad(mode="reflect")`` raises).
- The DIV2K mean is subtracted before and added after, scaled by
  ``img_range`` (the weights were trained with it).

:func:`swinir_apply` is the functional, differentiable forward the
trainer runs on a param tree in the JAX package's layout: every block in
plain ``torch`` (the kernels have no backward; JAX training pins its XLA
attention, ``fused_attn="0"``), each residual group optionally
rematerialised.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.window_attention import (
    build_block_tables,
    gelu,
    layer_norm,
    relative_position_index,
    shift_mask,
    swin_block,
    window_attention,
)
from ..utils.precision import ieee_fp32
from .weights import tree_map

# "block": the whole Swin block in one kernel launch; "attn": the
# attention-only kernel, the MLP in plain torch
FUSED_LEVEL = os.environ.get("S2SR_SWINIR_FUSED_LEVEL", "block")

# Above this trunk area the upsample tail runs in haloed row strips,
# which bounds its (sH, sW, 64) activation; the strips equal the whole tail
TAIL_STRIP_AREA = 1280 * 1280
TAIL_STRIP = 128               # trunk rows per strip
_TAIL_PAD = 3                  # ≥ the tail's receptive field (2.75 px at x4)

DIV2K_MEAN = (0.4488, 0.4371, 0.4040)


def reflect_index(n: int, pad: int) -> torch.Tensor:
    """Indices of ``numpy.pad(arange(n), (0, pad), mode="reflect")``."""
    idx = torch.arange(n + pad)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = idx % period
    return torch.where(m < n, m, period - m)


def reflect_pad(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect-pad an NHWC tensor at the bottom and right, numpy style."""
    _, h, w, _ = x.shape
    if pad_h:
        x = x.index_select(1, reflect_index(h, pad_h).to(x.device))
    if pad_w:
        x = x.index_select(2, reflect_index(w, pad_w).to(x.device))
    return x


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype) -> torch.Tensor:
    """LayerNorm over the last dim, float32 statistics, output in ``dtype``
    (weights rounded to ``dtype`` first, as the reference casts them)."""
    return layer_norm(x.float(), norm.weight.to(dtype).float(),
                      norm.bias.to(dtype).float(), dtype).to(dtype)


def _linear(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    return x @ lin.weight.to(dtype).t() + lin.bias.to(dtype)


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """3×3 SAME conv of an NCHW tensor in ``dtype``, bias added after."""
    out = F.conv2d(x.to(dtype), conv.weight.to(dtype), padding=1)
    return out + conv.bias.to(dtype).view(1, -1, 1, 1)


def _nhwc_conv(t: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """The conv of an NHWC map, as an NHWC map."""
    out = _conv(t.permute(0, 3, 1, 2), conv, dtype)
    return out.permute(0, 2, 3, 1).contiguous()


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.tables: dict | None = None

    def pack(self, dtype: torch.dtype) -> None:
        """Build the kernels' tables in ``dtype`` on the weights' device."""
        self.tables = build_block_tables(dict(self.named_parameters()),
                                         self.heads, self.window, self.shift,
                                         dtype)

    def forward(self, x: torch.Tensor, level: str) -> torch.Tensor:
        """(B, H, W, C) → same, in the tables' dtype."""
        t = self.tables
        if t is None or t["dtype"] != x.dtype:
            raise RuntimeError("Swin block tables missing or built for "
                               "another dtype: call SwinIR.pack()")
        if level == "block":
            return swin_block(x, t)
        dtype = x.dtype
        y = x + window_attention(x, t)
        h = _linear(_layer_norm(y, self.norm2, dtype), self.mlp.fc1, dtype)
        h = gelu(h, dtype)
        return y + _linear(h, self.mlp.fc2, dtype)


class ResidualGroup(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: Swin blocks, a 3×3 conv, the
    residual."""

    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 mlp_ratio: float):
        super().__init__()
        self.residual_group = ResidualGroup(
            SwinBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2,
                      mlp_ratio) for i in range(depth))
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


class SwinIR(nn.Module):
    """Classical-SR SwinIR (SwinIR-M by default)."""

    def __init__(self, scale: int = 4, embed_dim: int = 180,
                 depths: Sequence[int] = (6,) * 6,
                 num_heads: Sequence[int] = (6,) * 6,
                 window_size: int = 8, mlp_ratio: float = 2.0,
                 num_feat: int = 64, img_range: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.scale = scale
        self.window_size = window_size
        self.img_range = img_range
        self.dtype = dtype
        dim = embed_dim
        self.conv_first = nn.Conv2d(3, dim, 3, padding=1)
        self.patch_embed = PatchEmbed(dim)
        self.layers = nn.ModuleList(
            RSTB(dim, d, h, window_size, mlp_ratio)
            for d, h in zip(depths, num_heads))
        self.norm = nn.LayerNorm(dim)
        self.conv_after_body = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(dim, num_feat, 3, padding=1), nn.LeakyReLU(inplace=True))
        ups: list = []
        s = scale
        while s > 1:
            if s % 2 == 0:
                ups += [nn.Conv2d(num_feat, 4 * num_feat, 3, padding=1),
                        nn.PixelShuffle(2)]
                s //= 2
            elif s == 3:
                ups += [nn.Conv2d(num_feat, 9 * num_feat, 3, padding=1),
                        nn.PixelShuffle(3)]
                s = 1
            else:
                raise ValueError(f"unsupported scale {scale}")
        self.upsample = nn.Sequential(*ups)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, padding=1)

    def blocks(self):
        return [b for layer in self.layers for b in layer.residual_group.blocks]

    def pack(self) -> "SwinIR":
        """Build every block's kernel tables in ``self.dtype`` on the
        weights' device. Call after loading the weights and after
        ``.to(device)``, and again if either changes."""
        for block in self.blocks():
            block.pack(self.dtype)
        return self

    def _tail(self, feat: torch.Tensor) -> torch.Tensor:
        """NCHW: conv_before_upsample → pixel-shuffle chain → conv_last."""
        dtype = self.dtype
        f = F.leaky_relu(_conv(feat, self.conv_before_upsample[0], dtype),
                         0.01)
        for m in self.upsample:
            f = (_conv(f, m, dtype) if isinstance(m, nn.Conv2d)
                 else F.pixel_shuffle(f, m.upscale_factor))
        return _conv(f, self.conv_last, dtype)

    def _tail_strips(self, feat: torch.Tensor) -> torch.Tensor:
        """The tail in row strips of ``TAIL_STRIP`` trunk rows with a
        ``_TAIL_PAD`` halo; strip windows are clamped inside the image so
        edge strips see the whole tail's zero padding. Equal to
        :meth:`_tail`."""
        h = feat.shape[2]
        pad, strip, sc = _TAIL_PAD, TAIL_STRIP, self.scale
        win = strip + 2 * pad
        outs = []
        for i in range(-(-h // strip)):
            start = min(max(i * strip - pad, 0), h - win)
            off = i * strip - start
            y = self._tail(feat[:, :, start:start + win])
            # the last strip's crop may run past its window: zero rows,
            # cut off below by [:h·sc]
            y = F.pad(y, (0, 0, 0, sc * strip))
            outs.append(y[:, :, off * sc:off * sc + sc * strip])
        return torch.cat(outs, 2)[:, :, :h * sc]

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] → (B, sH, sW, 3) float32. A float32 model
        runs its convs and products in IEEE float32 (TF32 off), as JAX
        does."""
        with ieee_fp32(self.dtype == torch.float32):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        level = FUSED_LEVEL
        if level not in ("block", "attn"):
            raise ValueError(f"fused level must be 'block' or 'attn', got "
                             f"{level!r}")
        dtype, w = self.dtype, self.window_size
        _, h0, w0, _ = x.shape
        x = reflect_pad(x.float(), (w - h0 % w) % w, (w - w0 % w) % w)
        mean = torch.tensor(DIV2K_MEAN, device=x.device)
        x = ((x - mean) * self.img_range).to(dtype)

        feat = _conv(x.permute(0, 3, 1, 2), self.conv_first, dtype)
        tokens = _layer_norm(feat.permute(0, 2, 3, 1), self.patch_embed.norm,
                             dtype).contiguous()
        for layer in self.layers:
            y = tokens
            for block in layer.residual_group.blocks:
                y = block(y, level)
            tokens = tokens + _nhwc_conv(y, layer.conv, dtype)
        body = _layer_norm(tokens, self.norm, dtype)
        feat = feat + _conv(body.permute(0, 3, 1, 2), self.conv_after_body,
                            dtype)

        h, ww = feat.shape[2:]
        if h * ww > TAIL_STRIP_AREA and h >= 2 * _TAIL_PAD + TAIL_STRIP:
            out = self._tail_strips(feat)
        else:
            out = self._tail(feat)
        out = out.permute(0, 2, 3, 1).float() / self.img_range + mean
        return out[:, :h0 * self.scale, :w0 * self.scale]


# --- the functional forward (training) -----------------------------------

def _ln(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics, output in ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps) * p["weight"].float()
           + p["bias"].float())
    return out.to(x.dtype)


def _lin(x: torch.Tensor, p: dict) -> torch.Tensor:
    return x @ p["weight"] + p["bias"]


def _conv_hwio(x: torch.Tensor, p: dict) -> torch.Tensor:
    """3×3 SAME conv of an NHWC map with a HWIO kernel, as NHWC."""
    out = F.conv2d(x.permute(0, 3, 1, 2), p["kernel"].permute(3, 2, 0, 1),
                   padding=1)
    return (out + p["bias"].view(1, -1, 1, 1)).permute(0, 2, 3, 1)


def _attention_train(x, p, heads: int, bias_idx, mask):
    """Window attention over (B·nW, N, C) windows, as JAX's unfused path
    computes it (windows unpaired: a pair's cross terms weigh exactly 0)."""
    bw, n, c = x.shape
    hd = c // heads
    qkv = _lin(x, p["qkv"]).reshape(bw, n, 3, heads, hd)
    q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    q = q * (hd ** -0.5)
    attn = q @ k.transpose(-1, -2)
    bias = p["relative_position_bias_table"][bias_idx]      # (N, N, heads)
    attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(-1, nw, heads, n, n)
                + mask[None, :, None].to(attn.dtype)).reshape(bw, heads, n, n)
    attn = torch.softmax(attn, -1).to(v.dtype)
    out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
    return _lin(out, p["proj"])


def _swin_block_train(x, p, h, w, heads, window, shift, bias_idx, mask):
    b, _, c = x.shape
    y = _ln(x, p["norm1"]).reshape(b, h, w, c)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    win = y.reshape(b, h // window, window, w // window, window, c)
    win = win.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)
    a = _attention_train(win, p["attn"], heads, bias_idx,
                         mask if shift else None)
    y = a.reshape(b, h // window, w // window, window, window, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + y.reshape(b, h * w, c)
    y = _ln(x, p["norm2"])
    y = _lin(F.gelu(_lin(y, p["mlp"]["fc1"]),
                    approximate="tanh" if x.dtype == torch.bfloat16
                    else "none"), p["mlp"]["fc2"])
    return x + y


def _rstb_train(x, layer, h, w, heads, window, bias_idx, mask):
    y = x
    for i, blk in enumerate(layer["blocks"]):
        y = _swin_block_train(y, blk, h, w, heads, window,
                              0 if i % 2 == 0 else window // 2,
                              bias_idx, mask)
    img = _conv_hwio(y.reshape(x.shape[0], h, w, -1), layer["conv"])
    return x + img.reshape(x.shape)


def swinir_apply(params: dict, x: torch.Tensor, scale: int = 4,
                 num_heads=(6,) * 6, window_size: int = 8,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 img_range: float = 1.0) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] → (B, sH, sW, 3) float32 through the JAX
    layout's SwinIR tree (``conv_first``, ``norm_embed``, ``layers`` of
    ``blocks`` and ``conv``, ``norm``, ``conv_after_body``,
    ``conv_before_upsample``, ``upsample``, ``conv_last``), differentiable
    in both. The tree is cast to ``dtype`` once, LayerNorm statistics are
    float32, GELU is tanh in bf16 and erf in float32; float32 runs with
    TF32 off. ``remat`` recomputes each residual group's activations in
    the backward pass."""
    with ieee_fp32(dtype == torch.float32):
        w = window_size
        _, h0, w0, _ = x.shape
        x = reflect_pad(x.float(), (w - h0 % w) % w, (w - w0 % w) % w)
        b, h, ww, _ = x.shape
        mean = torch.tensor(DIV2K_MEAN, device=x.device)
        x = ((x - mean) * img_range).to(dtype)
        if dtype != torch.float32:
            params = tree_map(lambda a: a.to(dtype), params)
        bias_idx = torch.from_numpy(relative_position_index(w)).to(x.device)
        mask = torch.from_numpy(shift_mask(h, ww, w, w // 2)).to(x.device)

        feat = _conv_hwio(x, params["conv_first"])
        tokens = _ln(feat.reshape(b, h * ww, -1), params["norm_embed"])
        for layer, heads in zip(params["layers"], num_heads):
            if remat and torch.is_grad_enabled():
                tokens = checkpoint(_rstb_train, tokens, layer, h, ww, heads,
                                    w, bias_idx, mask, use_reentrant=False)
            else:
                tokens = _rstb_train(tokens, layer, h, ww, heads, w,
                                     bias_idx, mask)
        body = _ln(tokens, params["norm"]).reshape(b, h, ww, -1)
        feat = feat + _conv_hwio(body, params["conv_after_body"])

        f = F.leaky_relu(_conv_hwio(feat, params["conv_before_upsample"]),
                         0.01)
        s = scale
        for up in params["upsample"]:
            factor = 2 if s % 2 == 0 else 3
            f = _conv_hwio(f, up).permute(0, 3, 1, 2)
            f = F.pixel_shuffle(f, factor).permute(0, 2, 3, 1)
            s = s // 2 if factor == 2 else 1
        out = _conv_hwio(f, params["conv_last"])
        out = out.float() / img_range + mean
        return out[:, :h0 * scale, :w0 * scale]
