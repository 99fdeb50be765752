"""Training steps for RRDBNet and SwinIR (the port of
``s2sr_tpu/training/train.py``): the L1 (or Charbonnier) objective of
first-stage Real-ESRGAN fine-tuning, Adam with an optional cosine decay,
and an optional weight EMA.

- Params are a tree in the JAX package's layout (nested dicts and lists
  of float32 tensors; HWIO kernels, the RRDB stack on a leading ``body``
  axis), so a tree carries across to and from the JAX package and its
  ``.npz`` (``models/weights.py``). The forward is
  ``models/rrdbnet.py::rrdbnet_apply`` or ``models/swinir.py::swinir_apply``:
  plain ``F.conv2d`` and ``torch`` ops under autograd. The serving
  kernels have no backward; JAX training runs XLA's convolutions and its
  unfused attention likewise.
- The optimizer is Adam as optax computes it (b1 0.9, b2 0.999, eps 1e-8
  outside the square root, bias correction by count), its step size
  optax's closed-form ``cosine_decay_schedule(lr, decay, alpha=0.02)``
  at the count before the increment, and the EMA
  ``ema = d·ema + (1 − d)·new_params`` initialised to the params. Its
  state is explicit (:class:`OptState`): moments, count, schedule count,
  EMA.
- A chunked step is a plain loop of K steps; the device-pool step draws
  each batch on the device from a ``torch.Generator``
  (:func:`make_pool_sampler`).
- A float32 step runs forward and backward with TF32 off.
- With a mesh of more than one device the steps run in every rank of it
  (``parallel/comm.py::launch``). Each rank is given the whole global
  batch, as JAX's replicated key draws it, and keeps its (dp, sp) slice
  (:func:`rank_batch`, JAX's ``batch_sharding``): N over ``dp``, and H
  over ``sp`` as bands of rows (the HR band ``scale`` times the LR
  band's rows; SwinIR's in whole window rows), the forward exchanging
  halo rows with the neighbouring bands before every conv. The loss is
  the global batch's mean on every rank (an all-reduce of its sums,
  unequal bands weighted by their pixels), so each rank's gradient is
  its share of the global gradient times the number of ranks, and the
  mean of the gradients over every rank is the global gradient. Params,
  Adam state and the pool are replicated; each step is the one-device
  step on the global batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from ..models.rrdbnet import rrdbnet_apply
from ..models.swinir import swinir_apply
from ..models.weights import (
    init_state_dict,
    init_swinir_state_dict,
    rrdbnet_tree,
    swinir_tree,
    tree_flatten,
    tree_map,
    tree_to_torch,
    tree_unflatten,
)
from ..parallel import comm
from ..parallel.mesh import window_sharding
from ..utils.precision import ieee_fp32

B1, B2, EPS = 0.9, 0.999, 1e-8
COSINE_ALPHA = 0.02


@dataclass
class TrainConfig:
    # "rrdbnet" (the flagship CNN) or "swinir" (the registry's transformer)
    family: str = "rrdbnet"
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    # swinir-family shape (ignored for rrdbnet)
    embed_dim: int = 60
    depths: Tuple[int, ...] = (2, 2)
    heads: Tuple[int, ...] = (4, 4)
    window: int = 8
    scale: int = 4
    learning_rate: float = 1e-4
    charbonnier_eps: float = 0.0     # 0 → plain L1
    dtype: str = "bfloat16"
    # > 0: cosine-decay the LR to 2% over this many steps
    lr_decay_steps: int = 0
    # recompute each RRDB block (SwinIR: each residual group) on backward
    remat: bool = False
    # > 0: keep an exponential moving average of the weights
    ema_decay: float = 0.0


@dataclass
class OptState:
    """Adam's state: its step count (int32), the first and second moments
    (trees like the params), the schedule's count (cosine decay only) and
    the weight EMA (``ema_decay > 0`` only)."""

    count: torch.Tensor
    mu: dict
    nu: dict
    schedule_count: Optional[torch.Tensor] = None
    ema: Optional[dict] = None

    def to(self, device) -> "OptState":
        def move(t):
            return None if t is None else tree_map(lambda a: a.to(device), t)

        return OptState(*(move(getattr(self, f)) for f in
                          ("count", "mu", "nu", "schedule_count", "ema")))


def ema_params(opt_state: OptState):
    """The EMA weight tree, or None when the state carries no EMA."""
    return opt_state.ema


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < 2 ** 31 - 1, count + 1, count)


def cosine_lr(learning_rate: float, decay_steps: int,
              count: torch.Tensor) -> torch.Tensor:
    """optax's ``cosine_decay_schedule(lr, decay_steps, alpha=0.02)`` at
    ``count``, in float32."""
    c = torch.minimum(count.float(),
                      torch.tensor(float(decay_steps), device=count.device))
    cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
    return learning_rate * ((1 - COSINE_ALPHA) * cosine + COSINE_ALPHA)


class Adam:
    """``optax.adam`` (with ``cosine_decay_schedule`` when
    ``lr_decay_steps > 0``, chained with the weight EMA when
    ``ema_decay > 0``) on param trees."""

    def __init__(self, config: TrainConfig):
        self.learning_rate = config.learning_rate
        self.decay_steps = config.lr_decay_steps
        self.ema_decay = config.ema_decay

    def init(self, params) -> OptState:
        dev = tree_flatten(params)[0][0].device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return OptState(
            count=zero.clone(), mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
            schedule_count=zero.clone() if self.decay_steps > 0 else None,
            ema=(tree_map(lambda p: p.detach().clone(), params)
                 if self.ema_decay > 0 else None))

    @torch.no_grad()
    def update(self, grads: list, state: OptState, params) -> tuple:
        """One step from ``grads`` (the params' leaves' gradients, in
        :func:`tree_flatten` order) → ``(params, state)``, both new."""
        p, struct = tree_flatten(params)
        m = tree_flatten(state.mu)[0]
        v = tree_flatten(state.nu)[0]
        g = list(grads)
        fe = torch
        m = fe._foreach_add(fe._foreach_mul(g, 1 - B1), fe._foreach_mul(m, B1))
        v = fe._foreach_add(fe._foreach_mul(fe._foreach_mul(g, g), 1 - B2),
                            fe._foreach_mul(v, B2))
        count = _safe_increment(state.count)
        c = count.float()
        bc1 = 1 - torch.pow(torch.tensor(B1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(B2, device=c.device), c)
        den = fe._foreach_add(fe._foreach_sqrt(fe._foreach_div(v, bc2)), EPS)
        u = fe._foreach_div(fe._foreach_div(m, bc1), den)
        sched = state.schedule_count
        if sched is not None:
            step = -1 * cosine_lr(self.learning_rate, self.decay_steps, sched)
            u = fe._foreach_mul(u, step)
            sched = _safe_increment(sched)
        else:
            u = fe._foreach_mul(u, -self.learning_rate)
        new_p = fe._foreach_add(p, u)
        ema = state.ema
        if ema is not None:
            d = self.ema_decay
            ema = tree_unflatten(struct, fe._foreach_add(
                fe._foreach_mul(tree_flatten(ema)[0], d),
                fe._foreach_mul(new_p, 1.0 - d)))
        return tree_unflatten(struct, new_p), OptState(
            count=count, mu=tree_unflatten(struct, m),
            nu=tree_unflatten(struct, v), schedule_count=sched, ema=ema)


def make_optimizer(config: TrainConfig) -> Adam:
    return Adam(config)


def _dtype(config: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


def model_apply(config: TrainConfig, params, x: torch.Tensor,
                band=None) -> torch.Tensor:
    """Family-dispatched differentiable forward: (B, h, w, 3) in [0, 1] →
    (B, sh, sw, 3) float32; ``band`` (``comm.Band``): ``x`` is this
    rank's band of H."""
    dtype = _dtype(config)
    if config.family == "rrdbnet":
        return rrdbnet_apply(params, x, scale=config.scale, dtype=dtype,
                             remat=config.remat, band=band)
    if config.family == "swinir":
        return swinir_apply(params, x, scale=config.scale,
                            num_heads=config.heads,
                            window_size=config.window, dtype=dtype,
                            remat=config.remat, band=band)
    raise ValueError(f"unknown model family {config.family!r}")


def loss_from_pred(pred: torch.Tensor, hr_batch: torch.Tensor,
                   config: TrainConfig, axis=None) -> torch.Tensor:
    """Charbonnier (or plain L1) pixel loss of a prediction; with ``axis``
    the mean over every rank's pixels."""
    diff = pred - hr_batch
    if config.charbonnier_eps > 0:
        return comm.global_mean(
            torch.sqrt(diff * diff + config.charbonnier_eps ** 2), axis)
    return comm.global_mean(torch.abs(diff), axis)


def loss_fn(params, lr_batch, hr_batch, config: TrainConfig, band=None,
            axis=None) -> torch.Tensor:
    return loss_from_pred(model_apply(config, params, lr_batch, band),
                          hr_batch, config, axis)


def loss_and_grads(params, lr_batch, hr_batch, config: TrainConfig,
                   band=None, axis=None) -> tuple:
    """→ (loss, the gradients of the params' leaves in
    :func:`tree_flatten` order); float32 with TF32 off. ``band`` and
    ``axis`` as :func:`loss_fn`'s (a rank's slice of the global batch)."""
    leaves, struct = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with ieee_fp32(config.dtype != "bfloat16"):
        loss = loss_fn(tree_unflatten(struct, leaves), lr_batch, hr_batch,
                       config, band, axis)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the forward never reads (conv_up2 at ×2) has zero gradient
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), grads


def batch_sharding(mesh):
    """(N, H, W, C): N over dp, H over sp (both optional in the mesh)."""
    return window_sharding(mesh)


def dp_slice(batch: torch.Tensor, dp) -> torch.Tensor:
    """This rank's slice of a global batch along ``dp`` (a
    ``comm.Axis``)."""
    n = batch.shape[0]
    if n % dp.size:
        raise ValueError(f"batch {n} not divisible by dp={dp.size}")
    k = n // dp.size
    return batch[dp.index * k:(dp.index + 1) * k]


def band_unit(config: TrainConfig) -> int:
    """LR rows per unit of an ``sp`` band: a window row for SwinIR."""
    return config.window if config.family == "swinir" else 1


def rank_batch(lr_batch: torch.Tensor, hr_batch: torch.Tensor, rm,
               scale: int, unit: int = 1) -> tuple:
    """This rank's (dp, sp) slice of a global batch → ``(lr, hr, band)``:
    N over ``dp``; H over ``sp``, the LR band's rows ``[a, b)``
    (``comm.band_of`` in ``unit`` rows) and the HR band's ``[s·a, s·b)``.
    ``band`` is the LR ``comm.Band``, None without ``sp`` (or a rank
    mesh)."""
    if rm is None:
        return lr_batch, hr_batch, None
    lr_b, hr_b = (dp_slice(t, rm.axis("dp")) for t in (lr_batch, hr_batch))
    sp = rm.axis("sp")
    if sp.size == 1:
        return lr_b, hr_b, None
    band = comm.band_of(lr_b.shape[1], sp, unit)
    return (lr_b[:, band.start:band.stop],
            hr_b[:, band.start * scale:band.stop * scale], band)


def _one_step(config, tx, params, opt_state, lr_b, hr_b, rm=None) -> tuple:
    lr_b, hr_b, band = rank_batch(lr_b, hr_b, rm, config.scale,
                                  band_unit(config))
    loss, grads = loss_and_grads(params, lr_b, hr_b, config, band,
                                 None if rm is None else rm.world)
    if rm is not None:
        # the loss is the global mean on every rank, so each rank holds
        # its share of the gradient times the number of ranks
        grads = comm.all_reduce_mean(grads, rm.world)
    params, opt_state = tx.update(grads, opt_state, params)
    return params, opt_state, loss


def make_train_step(config: TrainConfig, mesh=None):
    """→ ``(step, tx)``; ``step(params, opt_state, lr_batch, hr_batch)``
    → ``(params, opt_state, loss)``, the loss a tensor on the batch's
    device. With a mesh of more than one device, run it in every rank
    with the global batch (N over ``dp``, H over ``sp``): the loss is the
    global mean on every rank."""
    tx = make_optimizer(config)
    rm = comm.for_mesh(mesh)

    def step(params, opt_state, lr_batch, hr_batch):
        return _one_step(config, tx, params, opt_state, lr_batch, hr_batch,
                         rm)

    return step, tx


def make_chunked_train_step(config: TrainConfig, mesh=None):
    """→ ``(run, tx)``; ``run(params, opt_state, lr_chunk, hr_chunk)`` runs
    K steps over chunks with a leading steps axis (K, N, h, w, 3) →
    ``(params, opt_state, losses)``, the K losses stacked. A mesh splits
    N and H, as :func:`make_train_step`'s does."""
    tx = make_optimizer(config)
    rm = comm.for_mesh(mesh)

    def run(params, opt_state, lr_chunk, hr_chunk):
        losses = []
        for lr_b, hr_b in zip(lr_chunk, hr_chunk):
            params, opt_state, loss = _one_step(config, tx, params,
                                                opt_state, lr_b, hr_b, rm)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return run, tx


class PoolSampler:
    """Batches cropped on the device from a scene pool (P, H, W, 3)
    float32 in [0, 1]: uniform scene, uniform offset, 0.5 vertical and
    horizontal flips, the area-×scale downsample, then the optional
    gaussian blur, gaussian noise and per-sample JPEG quality on the LR;
    or, with ``second_order`` (a ``DegradationConfig``), the LR made from
    the HR crops by the two-stage Real-ESRGAN chain
    (``training/degradation.py``) in place of all of those.
    :meth:`draw` takes the random values from a ``torch.Generator``;
    :meth:`from_draws` builds the batch from given values (JAX's draws of
    ``jax.random.split(key, 6)`` can be fed to it)."""

    def __init__(self, scale: int, crop_lr: int, batch: int,
                 blur_sigma: float = 0.0, noise_std: float = 0.0,
                 jpeg_range: Optional[Tuple[float, float]] = None,
                 second_order=None):
        self.scale, self.crop_lr, self.batch = scale, crop_lr, batch
        self.crop_hr = crop_lr * scale
        self.blur_sigma, self.noise_std = blur_sigma, noise_std
        self.jpeg_range = jpeg_range
        self.second_order = second_order

    def draw(self, pool: torch.Tensor, gen: torch.Generator) -> dict:
        """Scene index, offsets, flips, noise and quality of one batch."""
        n, h, w, _ = pool.shape
        b, dev = self.batch, pool.device
        d = {"idx": torch.randint(0, n, (b,), generator=gen, device=dev),
             "ys": torch.randint(0, h - self.crop_hr + 1, (b,),
                                 generator=gen, device=dev),
             "xs": torch.randint(0, w - self.crop_hr + 1, (b,),
                                 generator=gen, device=dev),
             "flips": torch.rand((b, 2), generator=gen, device=dev) < 0.5}
        if self.noise_std > 0:
            c = self.crop_lr
            d["noise"] = torch.randn((b, c, c, 3), generator=gen, device=dev)
        if self.second_order is not None:
            from .degradation import draw_second_order

            ch = self.crop_hr
            d["degrade"] = draw_second_order((b, ch, ch), self.second_order,
                                             gen, dev)
            return d
        if self.jpeg_range is not None:
            lo, hi = self.jpeg_range
            d["q"] = lo + (hi - lo) * torch.rand((b,), generator=gen,
                                                 device=dev)
        return d

    def from_draws(self, pool: torch.Tensor, idx, ys, xs, flips, noise=None,
                   q=None, degrade=None) -> tuple:
        """→ (lr (B, c, c, 3), hr (B, c·s, c·s, 3)) float32. ``degrade``:
        the chain's draws (``degradation.py::draw_second_order``'s
        layout), with ``second_order`` only."""
        from ..ops.blur import gaussian_blur
        from ..ops.jpeg import jpeg_degrade

        dev, ch, s, c = pool.device, self.crop_hr, self.scale, self.crop_lr
        idx, ys, xs, flips = (torch.as_tensor(a, device=dev)
                              for a in (idx, ys, xs, flips))
        ar = torch.arange(ch, device=dev)
        rows = torch.where(flips[:, :1], ch - 1 - ar, ar) + ys[:, None]
        cols = torch.where(flips[:, 1:], ch - 1 - ar, ar) + xs[:, None]
        hr = pool[idx[:, None, None], rows[:, :, None], cols[:, None, :]]
        if self.second_order is not None:
            from .degradation import second_order_from_draws

            return second_order_from_draws(hr, s, self.second_order,
                                           degrade), hr
        lr = hr.reshape(self.batch, c, s, c, s, 3).mean((2, 4))
        if self.blur_sigma > 0:
            lr = gaussian_blur(lr, self.blur_sigma)
        if self.noise_std > 0:
            lr = lr + self.noise_std * torch.as_tensor(noise, device=dev)
        if self.jpeg_range is not None:
            lr = jpeg_degrade(lr.clamp(0.0, 1.0), torch.as_tensor(q, device=dev))
        return lr, hr

    def __call__(self, pool: torch.Tensor, gen: torch.Generator) -> tuple:
        return self.from_draws(pool, **self.draw(pool, gen))


def make_pool_sampler(scale: int, crop_lr: int, batch: int,
                      blur_sigma: float = 0.0, noise_std: float = 0.0,
                      jpeg_range: Optional[Tuple[float, float]] = None,
                      second_order=None) -> PoolSampler:
    """The device-side batch sampler shared by the trainers. JPEG needs
    ``crop_lr`` a multiple of 16 (4:2:0 blocks), and so does
    ``second_order`` (a ``DegradationConfig``: the two-stage Real-ESRGAN
    chain, which replaces the blur, noise and JPEG knobs; JPEG blocks at
    both stages' resolutions)."""
    if jpeg_range is not None and crop_lr % 16:
        raise ValueError("jpeg_range needs crop_lr a multiple of 16 "
                         f"(4:2:0 blocks), got {crop_lr}")
    if second_order is not None and crop_lr % 16:
        raise ValueError("second_order needs crop_lr a multiple of 16 "
                         f"(JPEG blocks at both stages), got {crop_lr}")
    return PoolSampler(scale, crop_lr, batch, blur_sigma, noise_std,
                       jpeg_range, second_order)


def make_device_pool_train_step(config: TrainConfig, crop_lr: int, batch: int,
                                chunk: int, mesh=None, blur_sigma: float = 0.0,
                                noise_std: float = 0.0,
                                jpeg_range: Optional[Tuple[float, float]] = None,
                                second_order=None):
    """→ ``(run, tx)``; ``run(params, opt_state, pool, gen, draws=None)``
    runs ``chunk`` steps, each on a batch sampled on the pool's device
    (from ``gen``, or from ``draws[i]``, a dict of
    :meth:`PoolSampler.from_draws`'s arguments) → ``(params, opt_state,
    losses)``. With a mesh every rank draws the whole ``batch`` from a
    generator seeded alike and keeps its (dp, sp) slice."""
    tx = make_optimizer(config)
    rm = comm.for_mesh(mesh)
    sampler = make_pool_sampler(config.scale, crop_lr, batch, blur_sigma,
                                noise_std, jpeg_range,
                                second_order=second_order)

    def run(params, opt_state, pool, gen, draws=None):
        losses = []
        for i in range(chunk):
            d = sampler.draw(pool, gen) if draws is None else draws[i]
            lr_b, hr_b = sampler.from_draws(pool, **d)
            params, opt_state, loss = _one_step(config, tx, params,
                                                opt_state, lr_b, hr_b, rm)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    run.sampler = sampler
    return run, tx


def init_params(config: TrainConfig, seed: int = 0, device="cuda") -> dict:
    """The seeded random init (``models/weights.py``) as a JAX-layout
    tree of float32 tensors on ``device``."""
    if config.family == "swinir":
        sd = init_swinir_state_dict(
            scale=config.scale, embed_dim=config.embed_dim,
            depths=config.depths, num_heads=config.heads,
            window_size=config.window, seed=seed)
        tree = swinir_tree(sd, config.depths)
    else:
        tree = rrdbnet_tree(init_state_dict(
            num_feat=config.num_feat, num_block=config.num_block,
            num_grow_ch=config.num_grow_ch, seed=seed))
    return tree_to_torch(tree, device)


def init_training(config: TrainConfig, seed: int = 0,
                  device="cuda") -> Tuple[dict, OptState]:
    from ..models.engine import resolve_device

    params = init_params(config, seed, resolve_device(device))
    return params, make_optimizer(config).init(params)


def restore_flexible(mgr, config: TrainConfig, device="cuda") -> tuple:
    """Restore from a checkpoint whose LR-schedule kind or EMA presence may
    differ from ``config``'s → ``(params, opt_state, step,
    opt_restored)``. Params always restore. On a template mismatch the
    checkpoint is read with the schedule and/or the EMA flipped, its Adam
    moments and count (and its EMA, when both carry one) are carried into
    a fresh optimizer state for ``config``, and ``opt_restored`` is
    False."""
    params, opt_state = init_training(config, device=device)
    try:
        p, o, step = mgr.restore(params, opt_state)
        return p, o, step, True
    except ValueError:                   # opt-state tree mismatch
        pass
    flip_decay = {"lr_decay_steps": 0 if config.lr_decay_steps else 1}
    flip_ema = {"ema_decay": 0.0 if config.ema_decay else 0.999}
    for alt in (replace(config, **flip_decay), replace(config, **flip_ema),
                replace(config, **flip_decay, **flip_ema)):
        tx_alt = make_optimizer(alt)
        try:
            p, o_alt, step = mgr.restore(params, tx_alt.init(params))
        except ValueError:
            continue
        fresh = make_optimizer(config).init(p)
        fresh.count, fresh.mu, fresh.nu = o_alt.count, o_alt.mu, o_alt.nu
        if fresh.ema is not None and o_alt.ema is not None:
            fresh.ema = o_alt.ema
        return p, fresh, step, False
    raise ValueError(
        "checkpoint optimizer state matches no known template "
        "(tried ±cosine schedule, ±weight EMA)")
