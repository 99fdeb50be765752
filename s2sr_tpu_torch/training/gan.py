"""Second-stage (GAN) fine-tuning: discriminator, perceptual and
adversarial losses (the port of ``s2sr_tpu/training/gan.py``).

- :class:`UNetDiscriminator`: the U-Net discriminator shape used by
  Real-ESRGAN (conv down ×3, conv up ×3 with skip adds), without spectral
  norm, on a param tree in the JAX layout (HWIO kernels), NHWC in and
  out. JAX's ``"SAME"`` padding of a stride-2 3×3 conv on an even side is
  (0, 1), not (1, 1): it is padded so here.
- Relativistic-average GAN losses (generator and discriminator), with
  softplus.
- A perceptual loss on the generator's own frozen ``conv_first``
  features (an offline stand-in for VGG).
- :func:`make_gan_train_step` (one G+D step per call) and
  :func:`make_device_pool_gan_step` (``chunk`` steps per call, each batch
  sampled on the pool's device), each over a (dp, sp) mesh when given one
  (run in every rank: ``parallel/comm.py::launch``). Under ``sp`` G and D
  run on the rank's band of H: every stride-1 conv exchanges a 1-row halo
  (``comm.halo_exchange``); a stride-2 "SAME" conv, padded (0, 1), needs
  only the next band's first row, so the HR bands are multiples of 8 rows
  (D's three stride-2 stages); ``_up2`` and the skip adds are per pixel.

One step, in JAX's order: G's loss (pixel + perceptual + adversarial)
and its gradient with respect to G's leaves only; G updated by the L1
trainer's Adam (``make_optimizer(base)``: cosine and EMA as configured);
D's loss on G's pre-update ``sr``, detached, and D updated by a plain
Adam at ``lr_d``. D runs in IEEE float32 (TF32 off), as JAX's float32
params and inputs do; G in the base config's dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.weights import tree_flatten, tree_to_torch, tree_unflatten
from ..parallel import comm
from ..utils.precision import ieee_fp32
from .train import Adam, TrainConfig, band_unit, make_optimizer, \
    make_pool_sampler, model_apply, rank_batch

SLOPE = 0.2


def _conv(x: torch.Tensor, p: dict, stride: int = 1, sp=None) -> torch.Tensor:
    """NCHW conv with an HWIO kernel and JAX's "SAME" padding: (1, 1) at
    stride 1, (0, 1) at stride 2 on an even side. ``sp``: an axis whose
    ranks hold bands of H (an even number of rows each): H's padding
    rows are the neighbours' halo rows, zero at the image's edges."""
    k = p["kernel"].permute(3, 2, 0, 1)
    if sp is None or sp.size == 1:
        x = F.pad(x, (1, 1, 1, 1) if stride == 1 else (0, 1, 0, 1))
    else:
        x = comm.halo_exchange(x, 1, sp, dim=2)
        # stride 2 reads the row below the band only
        x = F.pad(x if stride == 1 else x[:, :, 1:],
                  (1, 1) if stride == 1 else (0, 1))
    return F.conv2d(x, k, p["bias"], stride=stride)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, SLOPE * x)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 (NCHW)."""
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


@dataclass
class GanConfig:
    base: TrainConfig = None
    num_feat_d: int = 32
    pixel_weight: float = 1.0
    perceptual_weight: float = 1.0
    gan_weight: float = 0.1
    lr_d: float = 1e-4

    def __post_init__(self):
        if self.base is None:
            self.base = TrainConfig()


class UNetDiscriminator:
    """U-Net discriminator (Real-ESRGAN's architecture family), NHWC, on
    a JAX-layout param tree."""

    def __init__(self, num_feat: int = 32):
        self.num_feat = num_feat

    def init(self, gen: torch.Generator, device="cpu") -> dict:
        """Kaiming-normal kernels from ``gen`` (drawn on its device, then
        moved to ``device``), zero biases; float32."""
        nf = self.num_feat

        def conv_p(cin, cout, k=3):
            w = torch.randn((k, k, cin, cout), generator=gen,
                            device=gen.device) * math.sqrt(2.0 / (k * k * cin))
            return {"kernel": w.to(device),
                    "bias": torch.zeros(cout, device=device)}

        return {
            "conv0": conv_p(3, nf),
            "down1": conv_p(nf, nf * 2),
            "down2": conv_p(nf * 2, nf * 4),
            "down3": conv_p(nf * 4, nf * 8),
            "up3": conv_p(nf * 8, nf * 4),
            "up2": conv_p(nf * 4, nf * 2),
            "up1": conv_p(nf * 2, nf),
            "out0": conv_p(nf, nf),
            "out1": conv_p(nf, 1),
        }

    def apply(self, params: dict, x: torch.Tensor,
              band=None) -> torch.Tensor:
        """(N, H, W, 3) → (N, H, W, 1) float32 logits, IEEE float32.
        ``band`` (``comm.Band``): ``x`` is this rank's band of H, whose
        rows and start are multiples of 8."""
        h, w = x.shape[1], x.shape[2]
        if h % 8 or w % 8:
            raise ValueError(
                f"UNetDiscriminator needs H,W multiples of 8 (3 stride-2 "
                f"stages with skip adds), got {h}x{w} — use a crop_hr "
                f"(crop_lr x scale) that is a multiple of 8")
        sp = None if band is None else band.axis
        if band is not None and band.start % 8:
            raise ValueError(f"a discriminator band starts on a multiple of "
                             f"8 rows, got {band.start}")
        with ieee_fp32():
            x = x.float().permute(0, 3, 1, 2)
            x0 = _lrelu(_conv(x, params["conv0"], sp=sp))
            d1 = _lrelu(_conv(x0, params["down1"], stride=2, sp=sp))
            d2 = _lrelu(_conv(d1, params["down2"], stride=2, sp=sp))
            d3 = _lrelu(_conv(d2, params["down3"], stride=2, sp=sp))
            u3 = _lrelu(_conv(_up2(d3), params["up3"], sp=sp)) + d2
            u2 = _lrelu(_conv(_up2(u3), params["up2"], sp=sp)) + d1
            u1 = _lrelu(_conv(_up2(u2), params["up1"], sp=sp)) + x0
            out = _conv(_lrelu(_conv(u1, params["out0"], sp=sp)),
                        params["out1"], sp=sp)
        return out.permute(0, 2, 3, 1)


def disc_params_from_jax(tree, device="cpu") -> dict:
    """A JAX discriminator tree (numpy leaves) → the port's, float32 on
    ``device``."""
    return tree_to_torch(tree, device)


def perceptual_features(gen_params: dict, x: torch.Tensor,
                        sp=None) -> torch.Tensor:
    """Shallow generator features as a frozen perceptual embedding: the
    SR net's ``conv_first`` with its params detached (the gradient still
    flows through ``x``), float32; ``sp`` as :func:`_conv`'s."""
    p = {k: v.detach().float() for k, v in gen_params["conv_first"].items()}
    with ieee_fp32():
        feat = _conv(x.float().permute(0, 3, 1, 2), p, sp=sp)
    return _lrelu(feat).permute(0, 2, 3, 1)


def _gan_step_parts(config: GanConfig, mesh=None):
    """The step, the discriminator and the two optimizers, shared by the
    per-call and the device-pool trainers. With a mesh of more than one
    device the step runs in every rank on the global batch: each rank
    keeps its (dp, sp) slice (the HR band a multiple of 8 rows), every
    mean of the losses, the relativistic losses' logit means included, is
    taken over the global batch (an all-reduce in the forward and in the
    backward), and G's and D's gradients are averaged over the ranks."""
    base = config.base
    rm = comm.for_mesh(mesh)
    axis = None if rm is None else rm.world
    # LR rows per band unit: whole G units whose HR rows are multiples of 8
    unit = math.lcm(band_unit(base), 8 // math.gcd(8, base.scale))

    def batch_mean(t):
        return comm.global_mean(t, axis)

    disc = UNetDiscriminator(config.num_feat_d)
    g_tx = make_optimizer(base)   # honours base.lr_decay_steps and the EMA
    d_tx = Adam(TrainConfig(learning_rate=config.lr_d))   # plain Adam

    def losses(g_tree, d_tree, lr_batch, hr_batch, band) -> tuple:
        hr_band = None if band is None else band.scaled(base.scale)
        sp = None if band is None else band.axis
        sr = model_apply(base, g_tree, lr_batch, band)
        pixel = batch_mean(torch.abs(sr - hr_batch))
        perceptual = batch_mean(torch.abs(
            perceptual_features(g_tree, sr, sp)
            - perceptual_features(g_tree, hr_batch, sp)))
        # one forward of D on each of sr and hr serves both losses: D's
        # loss reads the same logits as on sr detached, since G's
        # gradient is taken with respect to G's leaves alone
        logits_fake = disc.apply(d_tree, sr, hr_band)
        logits_real = disc.apply(d_tree, hr_batch, hr_band)
        mean_fake, mean_real = batch_mean(logits_fake), batch_mean(logits_real)
        # relativistic average GAN, generator side
        adv = 0.5 * (
            batch_mean(F.softplus(-(logits_fake - mean_real)))
            + batch_mean(F.softplus(logits_real - mean_fake)))
        g_loss = (config.pixel_weight * pixel
                  + config.perceptual_weight * perceptual
                  + config.gan_weight * adv)
        # discriminator side, on the pre-update sr
        d_loss = 0.5 * (
            batch_mean(F.softplus(-(logits_real - mean_fake)))
            + batch_mean(F.softplus(logits_fake - mean_real)))
        return g_loss, d_loss, pixel, adv

    def step(g_params, d_params, g_opt, d_opt, lr_batch, hr_batch):
        lr_batch, hr_batch, band = rank_batch(lr_batch, hr_batch, rm,
                                              base.scale, unit)
        g_leaves, g_struct = tree_flatten(g_params)
        d_leaves, d_struct = tree_flatten(d_params)
        g_leaves = [p.detach().requires_grad_(True) for p in g_leaves]
        d_leaves = [p.detach().requires_grad_(True) for p in d_leaves]
        # IEEE float32 for D and the float32 parts of G, forward and
        # backward; a bfloat16 G is unaffected
        with ieee_fp32():
            g_loss, d_loss, pixel, adv = losses(
                tree_unflatten(g_struct, g_leaves),
                tree_unflatten(d_struct, d_leaves), lr_batch, hr_batch, band)
            g_grads = torch.autograd.grad(g_loss, g_leaves,
                                          retain_graph=True,
                                          allow_unused=True)
            d_grads = torch.autograd.grad(d_loss, d_leaves)
        # a leaf the forward never reads (conv_up2 at ×2) has zero gradient
        g_grads = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(g_leaves, g_grads)]
        d_grads = list(d_grads)
        # the losses are global on every rank: no reduction
        scalars = [t.detach() for t in (g_loss, d_loss, pixel, adv)]
        if rm is not None:
            ng = len(g_grads)
            flat = comm.all_reduce_mean(g_grads + d_grads, rm.world)
            g_grads, d_grads = flat[:ng], flat[ng:]
        g_params, g_opt = g_tx.update(g_grads, g_opt, g_params)
        d_params, d_opt = d_tx.update(d_grads, d_opt, d_params)
        metrics = dict(zip(("g_loss", "d_loss", "pixel", "adv"), scalars))
        return g_params, d_params, g_opt, d_opt, metrics

    return step, disc, g_tx, d_tx


def make_gan_train_step(config: GanConfig, mesh=None):
    """→ ``(step, disc, g_tx, d_tx)``; ``step(g_params, d_params, g_opt,
    d_opt, lr, hr)`` → ``(g_params, d_params, g_opt, d_opt, metrics)``,
    the metrics (``g_loss``, ``d_loss``, ``pixel``, ``adv``) tensors on the
    batch's device. With a mesh, run it in every rank with the global
    batch (:func:`_gan_step_parts`)."""
    return _gan_step_parts(config, mesh)


def make_device_pool_gan_step(config: GanConfig, crop_lr: int, batch: int,
                              chunk: int, mesh=None, blur_sigma: float = 0.0,
                              noise_std: float = 0.0,
                              jpeg_range: Optional[Tuple[float, float]] = None):
    """The GAN twin of ``train.py::make_device_pool_train_step``: ``chunk``
    G+D steps per call, each batch sampled on the pool's device (blur,
    noise and JPEG knobs; no second-order chain, as in JAX).

    → ``(run, disc, g_tx, d_tx)``; ``run(g_params, d_params, g_opt, d_opt,
    pool, gen, draws=None)`` → ``(g_params, d_params, g_opt, d_opt,
    metrics)``, each metric stacked ``(chunk,)``; ``draws[i]`` replaces
    step i's draws from ``gen``."""
    step, disc, g_tx, d_tx = _gan_step_parts(config, mesh)
    sampler = make_pool_sampler(config.base.scale, crop_lr, batch,
                                blur_sigma, noise_std, jpeg_range)

    def run(g_params, d_params, g_opt, d_opt, pool, gen, draws=None):
        ms = []
        for i in range(chunk):
            d = sampler.draw(pool, gen) if draws is None else draws[i]
            lr_b, hr_b = sampler.from_draws(pool, **d)
            g_params, d_params, g_opt, d_opt, m = step(
                g_params, d_params, g_opt, d_opt, lr_b, hr_b)
            ms.append(m)
        metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        return g_params, d_params, g_opt, d_opt, metrics

    run.sampler = sampler
    return run, disc, g_tx, d_tx
