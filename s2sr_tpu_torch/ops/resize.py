"""Integer-factor bicubic upscale matching ``cv2.resize INTER_CUBIC``,
in PyTorch (the port of ``s2sr_tpu/ops/resize.py``).

Used by the classic models' luma path: the reference's
``cv2.dnn_superres`` upscales Cr/Cb with INTER_CUBIC while the network
handles luma. cv2's bicubic uses the kernel with a = −0.75, centre
sampling (``src = (dst + 0.5)/s − 0.5``) and replicated borders; at an
integer factor the fractional phases repeat, so the resize is a bank of
``s`` 4-tap filters per axis, here a gather and a weighted sum on the
tensor's device. The arithmetic is the JAX package's: source
coordinates in float64, weights and the weighted sum in float32, taps in
the order −1, 0, +1, +2. The division is by a 0-dim tensor, a true
division on the card too (a CUDA division by a Python scalar multiplies
by its reciprocal).

:func:`resize_pil_bicubic_u8` is PIL's ``Image.resize(BICUBIC)`` of a
uint8 image in Resample.c's integer arithmetic, on the host: the OCR
evaluation's bicubic retry (``cli/ocr_eval.py``) without PIL, which the
card's machine lacks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_weights(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """(4, n) float32 weights for fractional offsets ``t`` ∈ [0, 1):
    taps at −1, 0, +1, +2 relative to floor(src)."""
    d = torch.stack([t + 1.0, t, 1.0 - t, 2.0 - t])
    ad = d.abs()
    # |d|³ rounded once to float32 (a cube in float32 rounds twice);
    # numpy's float32 power, which the JAX package runs, is within an
    # ulp of it, and the same on the card and the CPU
    cube = (ad.double() ** 3).float()
    sq = ad * ad
    near = (a + 2.0) * cube - (a + 3.0) * sq + 1.0
    far = a * (cube - 5.0 * sq + 8.0 * ad - 4.0)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(ad <= 1.0, near, torch.where(ad < 2.0, far, zero))


def _upscale_axis(img: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    img = img.movedim(axis, 0)
    n = img.shape[0]
    dev = img.device
    dst = torch.arange(n * s, dtype=torch.float64, device=dev)
    src = (dst + 0.5) / torch.tensor(float(s), dtype=torch.float64,
                                     device=dev) - 0.5
    base = torch.floor(src)
    w = _cubic_weights((src - base).float())                 # (4, n·s)
    taps = torch.arange(-1, 3, device=dev)[:, None]
    idx = (base.long()[None, :] + taps).clamp(0, n - 1)      # (4, n·s)
    gathered = img[idx].float()                              # (4, n·s, ...)
    w = w.reshape(w.shape + (1,) * (img.dim() - 1))
    out = w[0] * gathered[0]
    for k in range(1, 4):
        out = out + w[k] * gathered[k]
    return out.movedim(0, axis)


def upscale_cubic(img: torch.Tensor, s: int) -> torch.Tensor:
    """(H, W[, C]) float → (H·s, W·s[, C]) float32, cv2 INTER_CUBIC."""
    return _upscale_axis(_upscale_axis(img, s, 0), s, 1)


# --- jax.image.resize ---------------------------------------------------

def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic with a = −0.5 (JAX's ``_fill_keys_cubic_kernel``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=256)
def _weight_mat(n_in: int, n_out: int, method: str,
                device: torch.device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of one axis, as JAX's
    ``compute_weight_mat`` with ``antialias=True``: sample positions
    ``(i + 0.5)/scale − 0.5``, the kernel widened by ``1/scale`` when
    downsampling, columns normalised by their sum (0 where the sum is at
    most 1000·eps) and zeroed where the sample lies outside the input.
    Made once per shape, method and device (never written to)."""
    inv = float(torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32))
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _KERNELS[method]((sample[None, :] - src[:, None]).abs() / kscale)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@functools.lru_cache(maxsize=256)
def _nearest_index(n_in: int, n_out: int,
                   device: torch.device) -> torch.Tensor:
    """JAX's ``floor(float32((i + 0.5)·n_in / n_out))`` (torch's
    ``nearest-exact``, not ``nearest``)."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * float(n_in) / float(n_out)
    return torch.floor(pos).long()


def resize_jax(img: torch.Tensor, shape, method: str) -> torch.Tensor:
    """``jax.image.resize(img, (..., h, w, C), method, antialias=True)`` on
    (..., H, W, C) float32 → (..., h, w, C), ``shape`` = (h, w), for
    ``method`` "linear", "cubic" or "nearest". An axis whose size does not
    change is left as it is, as in JAX. The two axes' weights are applied
    as two IEEE float32 products (JAX's ``precision=HIGHEST``)."""
    from ..utils.precision import ieee_fp32

    h_out, w_out = shape
    h_in, w_in = img.shape[-3], img.shape[-2]
    dev = img.device
    if method == "nearest":
        if h_out != h_in:
            img = img.index_select(-3, _nearest_index(h_in, h_out, dev))
        if w_out != w_in:
            img = img.index_select(-2, _nearest_index(w_in, w_out, dev))
        return img
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    img = img.float()
    with ieee_fp32():
        if h_out != h_in:
            wh = _weight_mat(h_in, h_out, method, dev)
            img = torch.einsum("...hwc,hH->...Hwc", img, wh)
        if w_out != w_in:
            ww = _weight_mat(w_in, w_out, method, dev)
            img = torch.einsum("...hwc,wW->...hWc", img, ww)
    return img


# --- PIL's Image.resize(..., BICUBIC) ------------------------------------

# Resample.c keeps its 8-bit coefficients in fixed point with this many
# fraction bits (32 − 8 − 2)
_PIL_PRECISION_BITS = 22


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's ``bicubic_filter`` (a = −0.5) in float64, its
    operations in its order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _pil_coeffs(n_in: int, n_out: int) -> tuple:
    """Resample.c's ``precompute_coeffs`` (box 0..n_in) and
    ``normalize_coeffs_8bpc`` for one axis → (first source index (n_out,),
    int64 weights (n_out, ksize) in 22-bit fixed point, 0 past each
    output's taps)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    # (int) of C truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      n_in) - xmin
    taps = np.arange(ksize)
    w = _pil_bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
                     * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(n_out)
    for k in range(ksize):              # C's running sum, tap by tap
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww != 0.0, ww, 1.0)[:, None],
                 w)
    fixed = w * (1 << _PIL_PRECISION_BITS)
    fixed = np.trunc(np.where(fixed < 0, fixed - 0.5, fixed + 0.5))
    return xmin, fixed.astype(np.int64)


def _pil_pass(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One of Resample.c's 8-bit passes along ``axis``: each sum starts at
    2²¹, is shifted right by 22 and clipped to uint8."""
    n_in = img.shape[axis]
    xmin, k = _pil_coeffs(n_in, n_out)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], n_in - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)       # (n_in, ...)
    acc = np.full((n_out,) + src.shape[1:], 1 << (_PIL_PRECISION_BITS - 1),
                  np.int64)
    kk = k.reshape(k.shape + (1,) * (src.ndim - 1))
    for t in range(k.shape[1]):
        acc += src[idx[:, t]] * kk[:, t]
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_pil_bicubic_u8(img: np.ndarray, shape) -> np.ndarray:
    """PIL's ``Image.fromarray(img).resize((w, h), Image.BICUBIC)`` of a
    uint8 L (H, W) or RGB (H, W, 3) image, byte for byte, on the host:
    ``shape`` = (h, w). Resample.c's integer arithmetic (a = −0.5,
    support 2 widened by the scale when reducing, coefficients normalised
    and fixed to 22 bits rounding half away from zero), the horizontal
    pass first into a clipped uint8 image, then the vertical; an axis
    whose size does not change is not resampled, as in PIL."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"want a uint8 (H, W) or (H, W, C) image, got "
                         f"{img.dtype} {img.shape}")
    h_out, w_out = shape
    if w_out != img.shape[1]:
        img = _pil_pass(img, w_out, 1)
    if h_out != img.shape[0]:
        img = _pil_pass(img, h_out, 0)
    return img
