"""Real-ESRGAN second-order degradation, batched on the tensor's device
(the port of ``s2sr_tpu/training/degradation.py``).

The two-stage chain of the published x4 fine-tuning recipe:

  stage 1: blur (mixed kernel) → random resize → noise (gaussian or
           shot, maybe gray) → JPEG
  stage 2: blur (p = 0.8) → random resize → noise
  → area mean to LR → {sinc, JPEG} in random order (final sinc p = 0.8)

Every op is split in two halves. A ``draw_*`` half takes a
``torch.Generator`` and the device and returns the random values of a
batch, one per sample (tensors with a leading batch axis); a
``*_from_draws`` half computes the op from given values. The JAX package
draws with ``jax.random``, which torch cannot reproduce, so its draws can
be fed to the second half to get its numbers; the quirks of its draws are
kept:

- the noise's σ and the shot noise's λ come from one uniform u; the
  gaussian and the shot noise share the colour field, and the gray field
  is a separate array; only one of the two noises reaches a sample;
- iso families pin σ₂ = σ₁ and θ = 0; β is 1 for families 0–1, ``betag``
  for 2–3 and ``betap`` for 4–5; plateau is 1/(1 + ρ^β);
- the resize scale is a discrete ladder (``RESIZE_LADDER``) and the
  method one of three, down (or up) and back to the canvas through
  ``ops/resize.py::resize_jax`` (``jax.image.resize``);
- stage 2 blurs with probability 0.8, outside its stage.

A batch is computed as a batch: the blur kernels as one grouped conv, each
resize branch once for the samples that drew it (which reads the branch
counts back to the host: one sync per stage), the noise and JPEG as one
tensor op each; constants reach the device once (``ops/resize.py`` and
``ops/jpeg.py`` keep theirs per device).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.jpeg import jpeg_degrade
from ..ops.resize import resize_jax
from ..utils.precision import ieee_fp32

KERNEL_SIZE = 21


@dataclass(frozen=True)
class StageConfig:
    # blur-kernel family probabilities, in order:
    # iso / aniso / generalized_iso / generalized_aniso /
    # plateau_iso / plateau_aniso  (published kernel_list + probs)
    kernel_probs: Tuple[float, ...] = (0.45, 0.25, 0.12, 0.03, 0.12, 0.03)
    sinc_prob: float = 0.1           # replace the blur kernel by sinc
    blur_sigma: Tuple[float, float] = (0.2, 3.0)
    betag_range: Tuple[float, float] = (0.5, 4.0)
    betap_range: Tuple[float, float] = (1.0, 2.0)
    resize_prob: Tuple[float, float, float] = (0.2, 0.7, 0.1)  # up/down/keep
    resize_range: Tuple[float, float] = (0.15, 1.5)
    gaussian_noise_prob: float = 0.5  # else poisson
    noise_range: Tuple[float, float] = (1.0, 30.0)      # /255 gaussian σ
    poisson_scale_range: Tuple[float, float] = (0.05, 3.0)
    gray_noise_prob: float = 0.4
    jpeg_range: Tuple[float, float] = (30.0, 95.0)


@dataclass(frozen=True)
class DegradationConfig:
    """Published second-order recipe (x4plus finetune config)."""
    stage1: StageConfig = field(default_factory=StageConfig)
    stage2: StageConfig = field(default_factory=lambda: StageConfig(
        sinc_prob=0.1,
        blur_sigma=(0.2, 1.5),
        resize_prob=(0.3, 0.4, 0.3),
        resize_range=(0.3, 1.2),
        noise_range=(1.0, 25.0),
        poisson_scale_range=(0.05, 2.5),
    ))
    second_blur_prob: float = 0.8
    final_sinc_prob: float = 0.8
    final_sinc_cutoff: Tuple[float, float] = (np.pi / 3, np.pi)


# Discrete scale ladder spanning the published continuous ranges.
RESIZE_LADDER = (0.15, 0.3, 0.5, 0.75, 1.0, 1.2, 1.5)
_METHODS = ("linear", "cubic", "nearest")   # the recipe's interp pool


# --- draws ------------------------------------------------------------

def _uniform(n: int, lo: float, hi: float, gen, device) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)``'s arithmetic on a
    torch uniform: ``max(lo, u·(hi − lo) + lo)`` in float32."""
    return _scale_uniform(torch.rand(n, generator=gen, device=device), lo, hi)


def _scale_uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # the bounds and their difference rounded to float32, as JAX's are;
    # Python floats, so nothing is copied to the device
    lo32 = float(np.float32(lo))
    span = float(np.float32(hi) - np.float32(lo))
    return torch.clamp(u * span + lo32, min=lo32)


@functools.lru_cache(maxsize=64)
def _cumulative(probs: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.cumsum(np.asarray(probs, np.float64)),
                        dtype=torch.float32, device=device)


def _choice(probs, n: int, gen, device) -> torch.Tensor:
    """n indices drawn with probabilities ``probs`` (a zero never
    drawn)."""
    probs = tuple(float(p) for p in probs)
    cum = _cumulative(probs, torch.device(device))
    total = float(np.float32(np.sum(probs)))
    u = torch.rand(n, generator=gen, device=device) * total
    return torch.searchsorted(cum, u, right=True).clamp(max=len(cum) - 1)


def _bernoulli(p: float, n: int, gen, device) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=device) < p


# --- kernel synthesis ---------------------------------------------------

def bessel_j1(x: torch.Tensor) -> torch.Tensor:
    """J₁(x) in float32 via the Numerical-Recipes rational/asymptotic
    split (the JAX package's ``_bessel_j1``)."""
    ax = x.abs()
    # |x| < 8: rational approximation
    y = x * x
    num = x * (72362614232.0 + y * (-7895059235.0 + y * (
        242396853.1 + y * (-2972611.439 + y * (
            15704.48260 + y * -30.16036606)))))
    den = 144725228442.0 + y * (2300535178.0 + y * (
        18583304.74 + y * (99447.43394 + y * (376.9991397 + y))))
    small = num / den
    # |x| >= 8: asymptotic form
    safe = torch.where(ax > 1e-8, ax, torch.ones_like(ax))
    z = 8.0 / safe
    y2 = z * z
    xx = ax - 2.356194491
    p1 = 1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4 + y2 * (
        0.2457520174e-5 + y2 * -0.240337019e-6)))
    p2 = 0.04687499995 + y2 * (-0.2002690873e-3 + y2 * (
        0.8449199096e-5 + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6)))
    big = torch.sqrt(0.636619772 / safe) * (
        torch.cos(xx) * p1 - z * torch.sin(xx) * p2)
    big = big * torch.sign(x)
    return torch.where(ax < 8.0, small, big)


@functools.lru_cache(maxsize=8)
def _grid(size: int, device: torch.device) -> tuple:
    """(yy, xx) float32 (size, size): offsets from the kernel's centre
    (made once per device, never written to)."""
    ar = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    return torch.meshgrid(ar, ar, indexing="ij")


def sinc_kernel(cutoff: torch.Tensor, size: int = KERNEL_SIZE) -> torch.Tensor:
    """2-D circular low-pass (sinc) kernels, (n,) cutoffs ωc →
    (n, size, size), each summing to 1: the ringing model."""
    yy, xx = _grid(size, cutoff.device)
    r = torch.sqrt(xx * xx + yy * yy)
    c = cutoff.float().reshape(-1, 1, 1)
    k = torch.where(r < 1e-8, c * c / (4 * math.pi),
                    c * bessel_j1(c * r) / (2 * math.pi * r))
    return k / k.sum((-2, -1), keepdim=True)


def draw_mixed_blur_kernel(cfg: StageConfig, n: int, gen,
                           device) -> dict:
    """The values of n mixed blur kernels: σ₁, σ₂, θ, β_g, β_p, the family
    (0–5, by ``kernel_probs``), the sinc replacement and its cutoff."""
    lo, hi = cfg.blur_sigma
    return {
        "sig1": _uniform(n, lo, hi, gen, device),
        "sig2": _uniform(n, lo, hi, gen, device),
        "theta": _uniform(n, -np.pi, np.pi, gen, device),
        "betag": _uniform(n, *cfg.betag_range, gen, device),
        "betap": _uniform(n, *cfg.betap_range, gen, device),
        "fam": _choice(cfg.kernel_probs, n, gen, device),
        "use_sinc": _bernoulli(cfg.sinc_prob, n, gen, device),
        "cutoff": _uniform(n, np.pi / 3, np.pi, gen, device),
    }


def mixed_blur_kernel_from_draws(sig1, sig2, theta, betag, betap, fam,
                                 use_sinc, cutoff,
                                 size: int = KERNEL_SIZE) -> torch.Tensor:
    """(n, size, size) kernels from the draws: every family a function of
    ρ = xᵀΣ⁻¹x, generalized Gaussian exp(−½ρ^β) (β = 1: Gaussian) or
    plateau 1/(1 + ρ^β), normalised; a sinc where ``use_sinc``."""
    def col(t):
        return torch.as_tensor(t).reshape(-1, 1, 1)

    sig1, sig2, theta, betag, betap = (
        col(t).float() for t in (sig1, sig2, theta, betag, betap))
    fam, use_sinc, cutoff = col(fam), col(use_sinc), torch.as_tensor(cutoff)
    yy, xx = _grid(size, sig1.device)
    iso = fam % 2 == 0
    s2 = torch.where(iso, sig1, sig2)
    th = torch.where(iso, torch.zeros_like(theta), theta)
    beta = torch.where(fam < 2, torch.ones_like(betag),
                       torch.where(fam < 4, betag, betap))
    c, s = torch.cos(th), torch.sin(th)
    xr = c * xx + s * yy
    yr = -s * xx + c * yy
    rho_b = ((xr / sig1) ** 2 + (yr / s2) ** 2) ** beta
    k = torch.where(fam >= 4, 1.0 / (1.0 + rho_b), torch.exp(-0.5 * rho_b))
    k = k / k.sum((-2, -1), keepdim=True)
    return torch.where(use_sinc, sinc_kernel(cutoff, size), k)


def blur_with_kernel(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) ⊛ per-sample (B, k, k) kernels, depthwise with reflect
    padding (the published filter2D semantics): one grouped conv of
    B·3 groups, IEEE float32."""
    b, h, w, c = img.shape
    k = kernel.shape[-1]
    pad = k // 2
    x = F.pad(img.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect")
    x = x.reshape(1, b * c, h + 2 * pad, w + 2 * pad)
    wt = kernel.to(img.dtype).reshape(b, 1, k, k).repeat_interleave(c, 0)
    with ieee_fp32():
        out = F.conv2d(x, wt, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


# --- random resize on a fixed canvas ------------------------------------

def resize_probs(cfg: StageConfig) -> np.ndarray:
    """The probability of each ``RESIZE_LADDER`` factor: the up/down/keep
    mix over ``resize_range``, spread evenly over the factors it holds."""
    ladder = np.asarray(RESIZE_LADDER)
    lo, hi = cfg.resize_range
    up_ok = (ladder > 1.0) & (ladder <= hi)
    dn_ok = (ladder < 1.0) & (ladder >= lo)
    p_up, p_dn, p_keep = cfg.resize_prob
    probs = (p_up * up_ok / max(up_ok.sum(), 1)
             + p_dn * dn_ok / max(dn_ok.sum(), 1)
             + p_keep * (ladder == 1.0))
    return probs / probs.sum()


def draw_random_resize(cfg: StageConfig, n: int, gen, device) -> dict:
    """The ladder index ``fi`` and the method index ``mi`` of n
    samples."""
    return {"fi": _choice(resize_probs(cfg), n, gen, device),
            "mi": torch.randint(0, len(_METHODS), (n,), generator=gen,
                                device=device)}


def random_resize_from_draws(img: torch.Tensor, fi, mi) -> torch.Tensor:
    """Each sample resized by its ladder factor and method to
    ``max(round(side·factor), 1)`` and back to the canvas; the samples of
    one branch (``fi·3 + mi``) in one call."""
    _, h, w, _ = img.shape
    branch = (torch.as_tensor(fi) * len(_METHODS)
              + torch.as_tensor(mi)).to(img.device)
    # one read back to the host for the groups' sizes; the samples of
    # each group are a slice of the branch order, on the device
    order = torch.argsort(branch, stable=True)
    counts = torch.bincount(branch, minlength=len(RESIZE_LADDER)
                            * len(_METHODS)).tolist()
    out, start = img, 0
    for br, count in enumerate(counts):
        idx, start = order[start:start + count], start + count
        factor = RESIZE_LADDER[br // len(_METHODS)]
        if not count or factor == 1.0:
            continue
        method = _METHODS[br % len(_METHODS)]
        hh = max(int(round(h * factor)), 1)
        ww = max(int(round(w * factor)), 1)
        mid = resize_jax(img.index_select(0, idx), (hh, ww), method)
        out = out.index_copy(0, idx, resize_jax(mid, (h, w), method))
    return out


# --- noise --------------------------------------------------------------

def draw_random_noise(cfg: StageConfig, shape, gen, device) -> dict:
    """The noise of a (B, H, W) batch: gaussian or shot, colour or gray,
    the uniform u behind both σ and λ, the colour field (B, H, W, 3) and
    the gray field (B, H, W)."""
    b = shape[0]
    return {"gauss": _bernoulli(cfg.gaussian_noise_prob, b, gen, device),
            "gray": _bernoulli(cfg.gray_noise_prob, b, gen, device),
            "u": torch.rand(b, generator=gen, device=device),
            "field_c": torch.randn((*shape, 3), generator=gen,
                                   device=device),
            "field_g": torch.randn(shape, generator=gen, device=device)}


def random_noise_from_draws(img: torch.Tensor, cfg: StageConfig, gauss, gray,
                            u, field_c, field_g) -> torch.Tensor:
    """``img`` plus gaussian noise of σ = U(noise_range)/255, or the
    gaussian approximation of shot noise √(x/255)·λ with λ =
    U(poisson_scale_range) from the same u; gray noise takes one field
    for the three channels (the shot noise's from the channel mean)."""
    def col(t):
        return torch.as_tensor(t).reshape(-1, 1, 1, 1)

    gauss, gray, u = col(gauss), col(gray), col(u)
    field_c = torch.as_tensor(field_c)
    field_g = torch.as_tensor(field_g)[..., None]
    # XLA turns JAX's divisions by the constant 255 into products with
    # its float32 reciprocal: the same here, for the same roundings
    inv255 = 1.0 / 255.0
    sigma = _scale_uniform(u, *cfg.noise_range) * inv255
    gn = torch.where(gray, field_g * sigma, field_c * sigma)
    lam = _scale_uniform(u, *cfg.poisson_scale_range)
    x = img.clamp(0.0, 1.0)
    shot = torch.where(
        gray, field_g * torch.sqrt(x.mean(-1, keepdim=True) * inv255) * lam,
        field_c * torch.sqrt(x * inv255) * lam)
    return img + torch.where(gauss, gn, shot)


# --- the full chain -----------------------------------------------------

def draw_stage(cfg: StageConfig, shape, gen, device, blur: bool = True) -> dict:
    """One stage's draws for a (B, H, W) batch: its blur kernel (when
    ``blur``), resize, noise and JPEG quality ``q``."""
    b = shape[0]
    d = {"resize": draw_random_resize(cfg, b, gen, device),
         "noise": draw_random_noise(cfg, shape, gen, device),
         "q": _uniform(b, *cfg.jpeg_range, gen, device)}
    if blur:
        d["blur"] = draw_mixed_blur_kernel(cfg, b, gen, device)
    return d


def _stage(img: torch.Tensor, cfg: StageConfig, d: dict) -> torch.Tensor:
    """Blur (when drawn), resize, noise; the JPEG is the caller's."""
    if "blur" in d:
        img = blur_with_kernel(img, mixed_blur_kernel_from_draws(**d["blur"]))
    img = random_resize_from_draws(img, **d["resize"])
    return random_noise_from_draws(img, cfg, **d["noise"])


def draw_second_order(shape, cfg: DegradationConfig, gen, device) -> dict:
    """Every draw of the chain for a (B, H, W) HR batch."""
    b = shape[0]
    return {
        "stage1": draw_stage(cfg.stage1, shape, gen, device),
        "blur2": draw_mixed_blur_kernel(cfg.stage2, b, gen, device),
        "use_blur2": _bernoulli(cfg.second_blur_prob, b, gen, device),
        "stage2": draw_stage(cfg.stage2, shape, gen, device, blur=False),
        "cutoff": _uniform(b, *cfg.final_sinc_cutoff, gen, device),
        "use_sinc": _bernoulli(cfg.final_sinc_prob, b, gen, device),
        "order": _bernoulli(0.5, b, gen, device),
    }


def second_order_from_draws(hr: torch.Tensor, scale: int,
                            cfg: DegradationConfig, d: dict) -> torch.Tensor:
    """(B, H, W, 3) HR in [0, 1] → (B, H/scale, W/scale, 3) LR through the
    chain on the draws ``d`` (:func:`draw_second_order`'s layout)."""
    b, h, w, _ = hr.shape

    def per_sample(flag):
        return torch.as_tensor(flag, device=hr.device).reshape(-1, 1, 1, 1)

    # stage 1
    img = _stage(hr.float(), cfg.stage1, d["stage1"])
    img = jpeg_degrade(img.clamp(0.0, 1.0), d["stage1"]["q"])
    # stage 2: blur with probability second_blur_prob
    blurred = blur_with_kernel(img, mixed_blur_kernel_from_draws(**d["blur2"]))
    img = torch.where(per_sample(d["use_blur2"]), blurred, img)
    img = _stage(img, cfg.stage2, d["stage2"])
    # final resize to LR + {sinc, JPEG} in random order
    lr = img.reshape(b, h // scale, scale, w // scale, scale, 3).mean((2, 4))
    sk = sinc_kernel(torch.as_tensor(d["cutoff"], device=hr.device))
    use_sinc = per_sample(d["use_sinc"])
    q2 = d["stage2"]["q"]

    def sinc(x):
        return torch.where(use_sinc, blur_with_kernel(x, sk), x)

    sinc_then_jpeg = jpeg_degrade(sinc(lr).clamp(0.0, 1.0), q2)
    jpeg_then_sinc = sinc(jpeg_degrade(lr.clamp(0.0, 1.0), q2))
    lr = torch.where(per_sample(d["order"]), sinc_then_jpeg, jpeg_then_sinc)
    return lr.clamp(0.0, 1.0)


def second_order_degrade(hr: torch.Tensor, scale: int,
                         cfg: DegradationConfig = DegradationConfig(),
                         gen: torch.Generator | None = None) -> torch.Tensor:
    """(B, H, W, 3) HR in [0, 1] → (B, H/scale, W/scale, 3) LR through the
    two-stage chain, its draws from ``gen`` on ``hr``'s device. H and W
    must be multiples of 16·scale (JPEG blocks at both resolutions)."""
    b, h, w, _ = hr.shape
    if h % (16 * scale) or w % (16 * scale):
        raise ValueError(f"second_order_degrade needs H, W multiples of "
                         f"16·scale = {16 * scale}, got {h}x{w}")
    d = draw_second_order((b, h, w), cfg, gen, hr.device)
    return second_order_from_draws(hr, scale, cfg, d)
