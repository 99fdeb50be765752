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
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.window_attention import (
    build_block_tables,
    gelu,
    layer_norm,
    swin_block,
    window_attention,
)

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
        """(B, H, W, 3) in [0, 1] → (B, sH, sW, 3) float32."""
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
