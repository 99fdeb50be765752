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
