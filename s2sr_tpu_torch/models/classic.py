"""Classic CNN SR family: EDSR, ESPCN, LapSRN as PyTorch ``nn.Module``s.

The port of ``s2sr_tpu/models/classic.py``, the reference's OpenCV-DNN
path (``cv2.dnn_superres`` with the released EDSR/ESPCN/LapSRN ``.pb``
graphs). The same forwards, dtypes and exact-padding masks:

- EDSR (bf16 by default): mean-shifted 255-domain input, residual blocks
  without BN, TF depth-to-space upsample stages (×3 one stage, ×2 and ×4
  stages of ×2), tail cast to float32 before the mean is added back.
- ESPCN (float32): 5×5/64 → 3×3/32 → 3×3/(C·s²) with tanh, depth-to-space.
- LapSRN (float32): per ×2 level 3×3 embeddings with LeakyReLU 0.2, a
  stride-2 transposed conv of the features and of the image, and a
  residual conv added to the upsampled image.

Public layout is NHWC float in [0, 1] → NHWC float32, as in JAX; inside,
NCHW. ``mask`` (N, H, W[, 1]) of 0/1 re-zeroes every conv input outside
the true rectangle, so a zero-padded bucket computes exactly the unpadded
forward there. Depth-to-space follows TF (depth index ``(dy·f + dx)·C +
c``), which is what the released graphs use and *not*
``F.pixel_shuffle``'s ``c·f² + dy·f + dx``. Parameter names follow the
JAX trees (``head``, ``body.N.conv1``, ``upsample.N``, ``levels.N.embed.M``,
...); :func:`s2sr_tpu_torch.models.weights.params_from_jax_classic`
carries a JAX tree over. The JAX package runs these convolutions in
XLA, outside any Pallas kernel; here they are PyTorch's own (cuDNN and,
for float32 on the CPU, oneDNN off: ``utils/precision.py::
invariant_convs``), whose rounding depends neither on the shape nor on
the batch, so the masked bucket and ``run_classic_sr_many`` give the
single unpadded image's values (cuDNN's by-shape algorithm choice broke
both on the card). A float32 model runs its convs in IEEE float32 (TF32
off), as JAX does.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.precision import ieee_fp32, invariant_convs

# 255-domain DIV2K mean (≡ 0.4488/0.4371/0.4040 · 255)
DIV2K_MEAN = (114.444, 111.4605, 103.02)


def _layout(x: torch.Tensor) -> torch.Tensor:
    """One memory layout per channel count, whatever the strides a mask
    product or a permute left: the convolution's algorithm follows the
    layout, and the masked bucket must take the unpadded image's.
    Channels-last for several channels; NCHW strides for one."""
    if x.shape[1] == 1:
        return x.squeeze(1).unsqueeze(1).contiguous()
    return x.contiguous(memory_format=torch.channels_last)


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """Stride-1 SAME conv in ``dtype`` (odd kernels), bias added after.
    On the CPU a single output channel is computed as the first of two:
    PyTorch's CPU conv takes a matrix-vector product for one channel,
    whose rounding depends on the image's width."""
    weight = conv.weight.to(dtype)
    cout, k = weight.shape[0], weight.shape[-1]
    if cout == 1 and x.device.type == "cpu":
        weight = torch.cat([weight, torch.zeros_like(weight)])
    out = F.conv2d(_layout(x.to(dtype)), weight, padding=k // 2)[:, :cout]
    return out + conv.bias.to(dtype).view(1, -1, 1, 1)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """TF ``depth_to_space`` on NCHW: input channel ``(dy·f + dx)·C + c``
    → output (c, y·f + dy, x·f + dx)."""
    n, cf, h, w = x.shape
    c = cf // (f * f)
    x = x.reshape(n, f, f, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, h * f, w * f)


def transposed_conv_x2(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """TF ``Conv2DBackpropInput``, stride 2, SAME: the adjoint of the
    forward SAME conv from the 2H × 2W result to ``x``. ``weight`` is the
    forward conv's HWIO kernel permuted to (O, I, kh, kw) =
    ``kernel.permute(3, 2, 0, 1)``, which is ``conv_transpose2d``'s
    (in, out, kh, kw). The full transposed conv is cropped at TF's SAME
    begin pad ``(k − 2) // 2`` (1 for k = 4), so any k and any H, W."""
    k = weight.shape[-1]
    h, w = x.shape[-2:]
    full = F.conv_transpose2d(_layout(x), weight.to(x.dtype), stride=2)
    pb = (k - 2) // 2
    return full[..., pb:pb + 2 * h, pb:pb + 2 * w]


def _repeat2d(mask: torch.Tensor, f: int) -> torch.Tensor:
    return mask.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)


def _lrelu(t: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(t, 0.2)


class _Classic(nn.Module):
    """Shared entry: NHWC in, NHWC float32 out, TF32 off in float32."""

    dtype: torch.dtype

    @torch.no_grad()
    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """(N, H, W, C) float in [0, 1] → (N, sH, sW, C) float32; ``mask``
        (N, H, W[, 1]) 0/1 or None."""
        n, h, w, _ = x.shape
        mk = None if mask is None else mask.reshape(n, 1, h, w).to(self.dtype)
        with ieee_fp32(self.dtype == torch.float32), \
                invariant_convs(x.device, self.dtype):
            out = self._forward(x.permute(0, 3, 1, 2), mk)
        return out.permute(0, 2, 3, 1).float()


class EDSR(_Classic):
    """EDSR in the released graph's 255 domain: the DIV2K mean subtracted
    at the input and added back at the output (buffer ``mean``), the
    engine's [0, 1] contract kept by scaling at the boundary."""

    def __init__(self, scale: int = 4, num_feat: int = 64,
                 num_blocks: int = 16, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.scale = scale
        self.num_feat = num_feat
        self.num_blocks = num_blocks
        self.num_ch = 3
        self.dtype = dtype
        nf = num_feat
        self.register_buffer("mean", torch.tensor(DIV2K_MEAN))
        self.head = nn.Conv2d(3, nf, 3)
        self.body = nn.ModuleList()
        for _ in range(num_blocks):
            block = nn.Module()
            block.conv1 = nn.Conv2d(nf, nf, 3)
            block.conv2 = nn.Conv2d(nf, nf, 3)
            self.body.append(block)
        self.body_conv = nn.Conv2d(nf, nf, 3)
        self.factors = []
        s = scale
        while s > 1:
            factor = 3 if s == 3 else 2
            self.factors.append(factor)
            s //= factor
        self.upsample = nn.ModuleList(nn.Conv2d(nf, nf * f * f, 3)
                                      for f in self.factors)
        self.tail = nn.Conv2d(nf, 3, 3)

    def _forward(self, x, mk):
        dtype = self.dtype
        mean = self.mean.view(1, 3, 1, 1)

        def m(t):
            return t if mk is None else t * mk

        # x·255 − mean in float32, then the cast; the mask after it
        x = m((x.float() * 255.0 - mean).to(dtype))
        feat = m(_conv(x, self.head, dtype))
        h = feat
        for block in self.body:
            y = _conv(m(F.relu(_conv(h, block.conv1, dtype))), block.conv2,
                      dtype)
            h = m(h + y)
        feat = m(feat + _conv(h, self.body_conv, dtype))
        for up, factor in zip(self.upsample, self.factors):
            # masking the channel-expanded conv at LR zeroes every
            # subpixel of an out-of-region pixel; the mask is then the
            # nearest-upscaled one
            feat = depth_to_space(m(_conv(feat, up, dtype)), factor)
            if mk is not None:
                mk = _repeat2d(mk, factor)
        out = _conv(feat, self.tail, dtype)
        return (out.float() + mean) / torch.tensor(255.0, device=out.device)


class ESPCN(_Classic):
    """ESPCN (5×5 → 3×3 → 3×3 + depth-to-space, tanh hidden). The released
    graphs are luma (``num_ch`` 1); the pipeline wraps them in YCrCb."""

    def __init__(self, scale: int = 4, num_ch: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.num_ch = num_ch
        self.dtype = dtype
        self.conv1 = nn.Conv2d(num_ch, 64, 5)
        self.conv2 = nn.Conv2d(64, 32, 3)
        self.conv3 = nn.Conv2d(32, num_ch * scale * scale, 3)

    def _forward(self, x, mk):
        dtype = self.dtype

        def m(t):
            return t if mk is None else t * mk

        x = m(x.to(dtype))
        h = m(torch.tanh(_conv(x, self.conv1, dtype)))
        h = m(torch.tanh(_conv(h, self.conv2, dtype)))
        return depth_to_space(m(_conv(h, self.conv3, dtype)), self.scale)


def bilinear_up_weight(factor: int, channels: int) -> torch.Tensor:
    """The (C, C, 2f, 2f) diagonal bilinear ``conv_transpose2d`` weight
    (JAX's ``_bilinear_up_kernel`` HWIO, permuted (3, 2, 0, 1))."""
    size = 2 * factor
    og = torch.arange(size, dtype=torch.float64)
    filt = 1 - (og - (factor - 0.5)).abs() / factor
    kern2d = torch.outer(filt, filt).float()
    weight = torch.zeros(channels, channels, size, size)
    for c in range(channels):
        weight[c, c] = kern2d
    return weight


class LapSRN(_Classic):
    """Progressive ×2 pyramid (levels = log2(scale), scale 2, 4 or 8).
    ``levels.N.up_feat`` / ``up_img`` hold ``conv_transpose2d`` weights
    (in, out, kh, kw)."""

    def __init__(self, scale: int = 4, num_feat: int = 64,
                 depth_per_level: int = 5, num_ch: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if scale not in (2, 4, 8):
            raise ValueError(f"LapSRN scale must be 2, 4 or 8, got {scale}")
        self.scale = scale
        self.num_levels = int(math.log2(scale))
        self.num_feat = num_feat
        self.depth = depth_per_level
        self.num_ch = num_ch
        self.dtype = dtype
        nf, c = num_feat, num_ch
        self.head = nn.Conv2d(c, nf, 3)
        self.levels = nn.ModuleList()
        for _ in range(self.num_levels):
            level = nn.Module()
            level.embed = nn.ModuleList(nn.Conv2d(nf, nf, 3)
                                        for _ in range(depth_per_level))
            level.up_feat = nn.Parameter(bilinear_up_weight(2, nf))
            level.res = nn.Conv2d(nf, c, 3)
            level.up_img = nn.Parameter(bilinear_up_weight(2, c))
            self.levels.append(level)

    def _forward(self, x, mk):
        dtype = self.dtype

        def m(t):
            return t if mk is None else t * mk

        x = m(x.to(dtype))
        feat = m(_lrelu(_conv(x, self.head, dtype)))
        img = x
        for level in self.levels:
            h = feat
            for embed in level.embed:
                h = m(_lrelu(_conv(h, embed, dtype)))
            # the transposed convs spread border values into the pad
            # region: the mask is re-applied at the doubled resolution
            if mk is not None:
                mk = _repeat2d(mk, 2)
            feat = m(transposed_conv_x2(h, level.up_feat.to(dtype)))
            residual = _conv(feat, level.res, dtype)
            img = m(transposed_conv_x2(img, level.up_img.to(dtype))
                    + residual)
        return img


def init_classic_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Deterministic init in place, with JAX ``classic.py``'s
    distributions (conv weights normal · sqrt(2 / fan_in), zero biases;
    LapSRN's transposed convs stay bilinear) from a ``torch.Generator``
    seeded ``seed``. Its numbers differ from the JAX package's."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            cout, cin, kh, kw = mod.weight.shape
            with torch.no_grad():
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                                 * math.sqrt(2.0 / (kh * kw * cin)))
                mod.bias.zero_()
    return model


def build_classic_model(name: str, config: dict, seed: int = 0):
    """The registry entry's model (EDSR bf16, ESPCN and LapSRN float32),
    initialised from ``seed``."""
    family = config["family"]
    scale = config["scale"]
    if family == "edsr":
        model = EDSR(scale=scale, num_feat=config.get("channels", 256),
                     num_blocks=config.get("blocks", 32))
    elif family == "espcn":
        model = ESPCN(scale=scale, num_ch=config.get("num_ch", 3))
    elif family == "lapsrn":
        model = LapSRN(scale=scale, num_ch=config.get("num_ch", 3))
    else:
        raise ValueError(f"not a classic model family: {family}")
    return init_classic_(model, seed)
