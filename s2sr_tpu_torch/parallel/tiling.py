"""Batched halo tiling: whole-image SR through fixed-size windows.

The port of ``s2sr_tpu/parallel/tiling.py``: the same window placement
(edge windows re-expanded inward, so every window has one static
shape), the same overlap-crop stitch in which later windows win, and
the 64-multiple bucket + mask construction of the exact small-image
path.

Window-placement math: for tile pitch T and halo p, the window start of
row/column i is ``max(min(i*T + T + 2p, size) - (T+2p), 0)`` and every
window is ``(min(H, T+2p), min(W, T+2p))``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from . import spatial

ModelFn = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class TilePlan:
    """Static description of the halo-window decomposition of one image."""

    height: int
    width: int
    tile: int           # grid pitch
    pad: int            # halo
    scale: int
    ny: int
    nx: int
    win_h: int
    win_w: int

    @classmethod
    def for_image(cls, height: int, width: int, tile: int = 256,
                  pad: int = 10, scale: int = 4) -> "TilePlan":
        return cls(
            height=height, width=width, tile=tile, pad=pad, scale=scale,
            ny=math.ceil(height / tile), nx=math.ceil(width / tile),
            win_h=min(height, tile + 2 * pad),
            win_w=min(width, tile + 2 * pad),
        )

    @property
    def num_windows(self) -> int:
        return self.ny * self.nx

    def starts(self) -> np.ndarray:
        """(N, 2) array of (y, x) window starts, row-major."""
        sy = np.array([
            max(min(i * self.tile + self.tile + 2 * self.pad, self.height)
                - self.win_h, 0)
            for i in range(self.ny)
        ])
        sx = np.array([
            max(min(j * self.tile + self.tile + 2 * self.pad, self.width)
                - self.win_w, 0)
            for j in range(self.nx)
        ])
        grid = np.stack(np.meshgrid(sy, sx, indexing="ij"), axis=-1)
        return grid.reshape(-1, 2).astype(np.int32)

    def keep_size(self) -> Tuple[int, int]:
        """Static (keep_h, keep_w) of the region every window contributes
        after halo cropping — shared by :func:`tiled_apply` and
        :meth:`stitch_host`, whose byte-equality rests on it."""
        s = self.scale
        return (self.win_h * s - (self.pad * s if self.ny > 1 else 0),
                self.win_w * s - (self.pad * s if self.nx > 1 else 0))

    def crop_boxes(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(crop_offsets, dest_starts)`` per window: where the kept
        region begins inside the scaled window output, and where it lands
        in the full output image."""
        s = self.scale
        p = self.pad * s
        starts = self.starts()
        crop_off = []
        dest = []
        for idx in range(self.num_windows):
            iy, ix = divmod(idx, self.nx)
            y1, x1 = starts[idx]
            oy1, ox1 = int(y1) * s, int(x1) * s
            cy = p if iy > 0 else 0
            cx = p if ix > 0 else 0
            crop_off.append((cy, cx))
            dest.append((oy1 + cy, ox1 + cx))
        return (np.asarray(crop_off, np.int32), np.asarray(dest, np.int32))

    def stitch_host(self, outs: np.ndarray) -> np.ndarray:
        """Crop-and-place window outputs on host, in window order."""
        s = self.scale
        keep_h, keep_w = self.keep_size()
        crop_off, dest = self.crop_boxes()
        canvas = np.zeros((self.height * s, self.width * s,
                           outs.shape[-1]), outs.dtype)
        for i in range(self.num_windows):
            cy, cx = crop_off[i]
            dy, dx = dest[i]
            canvas[dy:dy + keep_h, dx:dx + keep_w] = \
                outs[i][cy:cy + keep_h, cx:cx + keep_w]
        return canvas


def extract_windows(img: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Gather (N, win_h, win_w, C) halo windows from an (H, W, C) image."""
    return torch.stack([img[y:y + plan.win_h, x:x + plan.win_w]
                        for y, x in plan.starts().tolist()])


def tiled_apply(
    model_fn,
    img: torch.Tensor,
    tile: int = 256,
    pad: int = 10,
    scale: int = 4,
    batch_size: int = 16,
    mesh=None,
    band_unit: int = 1,
) -> torch.Tensor:
    """Whole-image SR via batched halo windows. ``img``: (H, W, C) float.

    ``model_fn`` maps (B, win_h, win_w, C) → (B, s·win_h, s·win_w, C).
    Windows run in ``batch_size`` chunks, the last one padded with
    repeats of the last window (stitching reads only the first N
    outputs).

    With a mesh the chunks go round-robin over its ``dp`` devices
    (``Mesh.axis_devices``): chunk k runs on replica k mod dp, on that
    replica's device, and the stitch runs on the mesh's first device.
    ``model_fn`` is then one callable for every replica or a sequence of
    one per replica. JAX splits each chunk over dp instead; whole chunks
    keep every forward at the one-device batch, so a convolution library
    that picks its algorithm by batch size picks the same one, and the
    stitched output equals the one-device output bit for bit.

    With ``sp > 1`` a replica is the ``sp`` group of its ``dp``
    coordinate (``Mesh.sp_group``): each chunk's windows are split over H
    into the group's bands (``spatial.band_bounds``, in ``band_unit``
    rows), band j on the group's device j, and the replica's callable
    maps that list of bands to the list of their outputs (the halo
    exchange is its own, ``parallel/spatial.py``); the outputs are joined
    on the group's first device. JAX's counterpart shards the window
    batch's H over ``sp`` (``tiling.py:195-203``)."""
    fns, groups = _replicas(model_fn, mesh, img.device)
    h, w, c = img.shape
    plan = TilePlan.for_image(h, w, tile=tile, pad=pad, scale=scale)
    crop_off, dest = plan.crop_boxes()
    n = plan.num_windows
    s = plan.scale

    windows = extract_windows(img, plan)
    n_chunks = math.ceil(n / batch_size)
    n_padded = n_chunks * batch_size
    if n_padded != n:
        fill = windows[-1:].expand(n_padded - n, *windows.shape[1:])
        windows = torch.cat([windows, fill], 0)
    outs = []
    for i, k in enumerate(range(0, n_padded, batch_size)):
        r = i % len(fns)
        outs.append(_run_replica(fns[r], windows[k:k + batch_size], groups[r],
                                band_unit))
    outputs = torch.cat([o.to(groups[0][0]) for o in outs], 0)[:n]

    keep_h, keep_w = plan.keep_size()
    canvas = torch.zeros((h * s, w * s, c), dtype=outputs.dtype,
                         device=outputs.device)
    for i in range(n):
        cy, cx = crop_off[i].tolist()
        dy, dx = dest[i].tolist()
        canvas[dy:dy + keep_h, dx:dx + keep_w] = \
            outputs[i, cy:cy + keep_h, cx:cx + keep_w]
    return canvas


def _run_replica(fn, batch: torch.Tensor, group, band_unit: int = 1):
    """``fn`` on ``batch`` on one replica: its one device, or the bands of
    its ``sp`` group (a list in, a list out), joined on the group's first
    device."""
    if len(group) == 1:
        return fn(batch.to(group[0]))
    bounds = spatial.band_bounds(batch.shape[1], len(group), band_unit)
    return spatial.gather(fn(spatial.split(batch, bounds, group)), group[0])


def _replicas(model_fn, mesh, device) -> tuple:
    """(one callable per dp replica, the devices of each replica: its
    ``sp`` group)."""
    groups = ([(device,)] if mesh is None else
              [mesh.sp_group(d) for d in range(mesh.axis_size("dp"))])
    fns = (list(model_fn) if isinstance(model_fn, (list, tuple))
           else [model_fn] * len(groups))
    if len(fns) != len(groups):
        raise ValueError(f"{len(fns)} model functions for {len(groups)} "
                         "dp replicas")
    return fns, groups


def bucket_pad(img: np.ndarray, mult: int = 64):
    """Zero-pad a host (H, W, C) array to the next ``mult``-multiple
    bucket. Returns ``(padded, mask)`` with mask (hb, wb, 1) float32,
    1 inside the true rectangle."""
    h, w = img.shape[:2]
    hb, wb = -(-h // mult) * mult, -(-w // mult) * mult
    padded = np.zeros((hb, wb) + img.shape[2:], img.dtype)
    padded[:h, :w] = img
    mask = np.zeros((hb, wb, 1), np.float32)
    mask[:h, :w] = 1.0
    return padded, mask


def sr_whole_image(
    model_fn: ModelFn,
    img: torch.Tensor,
    tile: int = 256,
    pad: int = 10,
    scale: int = 4,
    batch_size: int = 16,
) -> torch.Tensor:
    """Tile only when ``H·W > tile²·4``, else one pass."""
    h, w, _ = img.shape
    if h * w > tile * tile * 4:
        return tiled_apply(model_fn, img, tile=tile, pad=pad, scale=scale,
                           batch_size=batch_size)
    return model_fn(img[None])[0]
