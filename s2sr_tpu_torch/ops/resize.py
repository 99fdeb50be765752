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
"""

from __future__ import annotations

import functools

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
