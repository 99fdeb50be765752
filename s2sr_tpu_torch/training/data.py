"""Training data on the host: HR/LR pair sampling and a prefetching
iterator (the port of ``s2sr_tpu/training/data.py``).

:class:`PairSampler` draws from ``np.random.default_rng(seed)`` in the
JAX package's order, so one seed gives both packages the same batches.
Its degradation is the area-average ×s downsample, then optionally a
gaussian blur, gaussian noise and a real JPEG round trip at a per-image
quality (``tiles/jpeg.py::jpeg_roundtrip``, libjpeg-turbo's arithmetic
on the host). :func:`prefetch` keeps batches ahead of the device on a
producer thread, each copied through pinned memory.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils import setup_logging

logger = setup_logging("s2sr_tpu_torch.data")


def area_downsample(hr: np.ndarray, scale: int) -> np.ndarray:
    """Area-average ×scale downsample of one (H, W, C) image (the training
    degradation; the sampler applies its batched form)."""
    h, w, c = hr.shape
    return hr.reshape(h // scale, scale, w // scale, scale, c).mean((1, 3))


class PairSampler:
    """Random HR crops and their synthetic LR counterparts."""

    def __init__(
        self,
        hr_images: Optional[List[np.ndarray]] = None,
        crop_lr: int = 64,
        scale: int = 4,
        batch_size: int = 8,
        blur_sigma: float = 0.0,
        noise_std: float = 0.0,
        jpeg_range: Optional[Tuple[float, float]] = None,
        seed: int = 0,
    ):
        self.hr_images = hr_images or []
        crop_hr = crop_lr * scale
        for i, im in enumerate(self.hr_images):
            if im.shape[0] < crop_hr or im.shape[1] < crop_hr:
                raise ValueError(
                    f"HR image {i} is {im.shape[0]}x{im.shape[1]} but the "
                    f"HR crop needs {crop_hr}x{crop_hr} "
                    f"(crop_lr {crop_lr} x scale {scale})")
        self.crop_lr = crop_lr
        self.scale = scale
        self.batch_size = batch_size
        self.blur_sigma = blur_sigma
        self.noise_std = noise_std
        self.jpeg_range = jpeg_range
        self.rng = np.random.default_rng(seed)
        self._synth_counter = 0

    @classmethod
    def from_directory(cls, directory: Path | str, **kwargs) -> "PairSampler":
        from ..pipelines.io import load_rgb

        images = [load_rgb(p)[0] for p in sorted(Path(directory).glob("*.tif"))]
        if not images:
            raise FileNotFoundError(f"no .tif files in {directory}")
        return cls(hr_images=images, **kwargs)

    def _hr_source(self) -> np.ndarray:
        if self.hr_images:
            return self.hr_images[self.rng.integers(len(self.hr_images))]
        from ..fetch.synthetic import synthetic_fields

        self._synth_counter += 1
        size = self.crop_lr * self.scale * 2
        return synthetic_fields(size=(size, size), seed=self._synth_counter)

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        """→ (lr [B, c, c, 3], hr [B, c·s, c·s, 3]) float32 in [0, 1]."""
        s = self.scale
        crop_hr = self.crop_lr * s
        hrs = []
        for _ in range(self.batch_size):
            src = self._hr_source()
            y = self.rng.integers(0, src.shape[0] - crop_hr + 1)
            x = self.rng.integers(0, src.shape[1] - crop_hr + 1)
            crop = src[y:y + crop_hr, x:x + crop_hr].astype(np.float32) / 255.0
            if self.rng.random() < 0.5:          # hflip
                crop = crop[:, ::-1]
            if self.rng.random() < 0.5:          # vflip
                crop = crop[::-1]
            hrs.append(crop)
        hr = np.stack(hrs)
        lr = hr.reshape(self.batch_size, self.crop_lr, s,
                        self.crop_lr, s, 3).mean(axis=(2, 4))
        if self.blur_sigma > 0:
            # the device sampler's kernel and borders (cv2 auto ksize,
            # reflect-101)
            from ..ops.blur import auto_ksize, gaussian_kernel_1d

            ksize = auto_ksize(self.blur_sigma)
            k = gaussian_kernel_1d(ksize, self.blur_sigma)
            pad = ksize // 2

            def blur1(im: np.ndarray) -> np.ndarray:
                xp = np.pad(im, ((pad, pad), (0, 0), (0, 0)), mode="reflect")
                x = sum(xp[i:i + im.shape[0]] * k[i] for i in range(ksize))
                xp = np.pad(x, ((0, 0), (pad, pad), (0, 0)), mode="reflect")
                return sum(xp[:, i:i + im.shape[1]] * k[i]
                           for i in range(ksize))

            lr = np.stack([blur1(im) for im in lr])
        if self.noise_std > 0:
            lr = lr + self.rng.normal(0, self.noise_std, lr.shape)
        if self.jpeg_range is not None:
            from ..tiles.jpeg import jpeg_roundtrip

            lo, hi = self.jpeg_range
            out = []
            for im in lr:
                # round to nearest, so the integer quality tracks the
                # device sampler's continuous uniform
                q = int(round(self.rng.uniform(lo, hi)))
                u8 = np.clip(np.round(im * 255.0), 0, 255).astype(np.uint8)
                out.append(jpeg_roundtrip(u8, q).astype(np.float32) / 255.0)
            lr = np.stack(out)
        return lr.astype(np.float32), hr


def prefetch(
    sampler: PairSampler,
    steps: int,
    buffer_size: int = 2,
    device="cuda",
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Iterator of ``steps`` (lr, hr) batches on ``device``, sampled ahead
    of consumption by a producer thread; on CUDA each is copied from
    pinned memory without blocking. A producer error is raised in the
    consumer; a consumer that stops early releases the producer."""
    from ..models.engine import resolve_device

    dev = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def to_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    def producer() -> None:
        try:
            for _ in range(steps):
                if stop.is_set():
                    return
                lr, hr = sampler.sample()
                if not _put((to_device(lr), to_device(hr))):
                    return
            _put(None)
        except BaseException as exc:  # surface in the consumer
            _put(exc)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                return
            if isinstance(batch, BaseException):
                raise batch
            yield batch
    finally:
        stop.set()
        thread.join(timeout=5.0)
