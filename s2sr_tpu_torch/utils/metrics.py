"""Image quality metrics (PSNR / SSIM) in numpy (the port of
``s2sr_tpu/utils/metrics.py``).

Used by the golden-file test strategy (SURVEY §4: "PSNR-identical tiles
vs reference Real-ESRGAN per BASELINE") and the eval CLI.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _sep_filter(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' filtering of a 2-D image with 1-D kernel k."""
    out = sliding_window_view(img, len(k), axis=0) @ k
    out = sliding_window_view(out, len(k), axis=1) @ k
    return out


def _ssim_plane(a: np.ndarray, b: np.ndarray, peak: float,
                win: int, sigma: float) -> float:
    k = _gaussian_kernel(win, sigma)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a = _sep_filter(a, k)
    mu_b = _sep_filter(b, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = _sep_filter(a * a, k) - mu_aa
    var_b = _sep_filter(b * b, k) - mu_bb
    cov = _sep_filter(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * cov + c2)
    den = (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 255.0,
         win: int = 11, sigma: float = 1.5) -> float:
    """Standard windowed SSIM (Wang et al. 2004: 11×11 Gaussian σ=1.5),
    computed per channel and averaged."""
    a = np.asarray(a, np.float32).astype(np.float64)
    b = np.asarray(b, np.float32).astype(np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    if min(a.shape[0], a.shape[1]) < win:
        return ssim_global(a, b, peak)
    return float(np.mean([
        _ssim_plane(a[..., c], b[..., c], peak, win, sigma)
        for c in range(a.shape[2])
    ]))


def ssim_global(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Single-global-window SSIM — a cheap smoke gate only. It is NOT the
    standard windowed SSIM (use :func:`ssim` for that) and will pass
    images windowed SSIM would fail."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    var_a, var_b = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(((2 * mu_a * mu_b + c1) * (2 * cov + c2))
                 / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)))
