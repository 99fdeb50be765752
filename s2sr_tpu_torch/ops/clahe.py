"""CLAHE (contrast-limited adaptive histogram equalisation), cv2's
integer algorithm, in PyTorch (the port of ``s2sr_tpu/ops/clahe.py``).

1. pad the image to tile multiples with reflect-101,
2. 256-bin histogram per tile,
3. clip at ``max(int(clip·tilePixels/256), 1)``; redistribute the
   clipped mass evenly (integer division) and the remainder to bins
   ``0, step, 2·step…`` with ``step = max(256 // residual, 1)``,
4. LUT = ``round(cdf · 255 / tilePixels)``,
5. per-pixel bilinear blend of the 4 surrounding tile LUTs with
   replicate edges. Even tile sizes take the half-tile region form of
   the blend (fixed neighbour LUTs per region, weights ``r/th``), odd
   ones the per-pixel form — the same split and expressions as the JAX
   package, so the float roundings agree.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _blend(v00, v01, v10, v11, xa, ya):
    top = v00 * (1.0 - xa) + v01 * xa
    bot = v10 * (1.0 - xa) + v11 * xa
    return top * (1.0 - ya) + bot * ya


def _pad2d(x: torch.Tensor, ph: int, pw: int, mode: str) -> torch.Tensor:
    """Bottom/right pad of an (H, W) tensor (numpy's reflect == torch's
    reflect; edge == replicate)."""
    if ph == 0 and pw == 0:
        return x
    return F.pad(x[None, None].float(), (0, pw, 0, ph), mode=mode)[0, 0]


def clahe_u8(channel: torch.Tensor, clip_limit: float = 2.5,
             tiles_y: int = 8, tiles_x: int = 8) -> torch.Tensor:
    """cv2.createCLAHE(clipLimit, (tiles_x, tiles_y)).apply for uint8 (H, W)."""
    h, w = channel.shape
    th = -(-h // tiles_y)
    tw = -(-w // tiles_x)
    ph, pw = th * tiles_y - h, tw * tiles_x - w
    padded = _pad2d(channel, ph, pw, "reflect").to(torch.int64)

    tile_pixels = th * tw
    clip = max(int(clip_limit * tile_pixels / 256.0), 1)

    n_tiles = tiles_y * tiles_x
    tiles = padded.reshape(tiles_y, th, tiles_x, tw).permute(0, 2, 1, 3)
    tiles = tiles.reshape(n_tiles, tile_pixels)
    ids = torch.arange(n_tiles, device=channel.device)[:, None] * 256 + tiles
    hist = torch.bincount(ids.reshape(-1), minlength=n_tiles * 256)
    hist = hist.reshape(n_tiles, 256).to(torch.int32)

    excess = (hist - clip).clamp(min=0).sum(dim=1, keepdim=True)
    hist = hist.clamp(max=clip)
    batch = excess // 256
    residual = excess - batch * 256
    hist = hist + batch
    idx = torch.arange(256, device=channel.device)[None, :]
    step = (256 // residual.clamp(min=1)).clamp(min=1)
    bump = (idx % step == 0) & (idx // step < residual)
    hist = hist + bump.to(torch.int32)

    cdf = torch.cumsum(hist, dim=1).float()
    lut = torch.round(cdf * (255.0 / tile_pixels)).clamp(0, 255)  # (T, 256)

    if th % 2 == 0 and tw % 2 == 0:
        out = _apply_luts_regions(channel, lut, tiles_y, tiles_x, th, tw)
    else:
        dev = channel.device
        ys = torch.arange(h, dtype=torch.float32, device=dev)
        xs = torch.arange(w, dtype=torch.float32, device=dev)
        tyf = ys / th - 0.5
        txf = xs / tw - 0.5
        ty1f = torch.floor(tyf)
        tx1f = torch.floor(txf)
        ya = (tyf - ty1f)[:, None]
        xa = (txf - tx1f)[None, :]
        ty1i = ty1f.to(torch.int64)
        tx1i = tx1f.to(torch.int64)
        ty2 = (ty1i + 1).clamp(0, tiles_y - 1)
        tx2 = (tx1i + 1).clamp(0, tiles_x - 1)
        ty1 = ty1i.clamp(0, tiles_y - 1)
        tx1 = tx1i.clamp(0, tiles_x - 1)
        v = channel.to(torch.int64)
        flat = lut.reshape(-1)

        def look(ty, tx):
            tile_id = ty[:, None] * tiles_x + tx[None, :]
            return flat[tile_id * 256 + v]

        out = _blend(look(ty1, tx1), look(ty1, tx2), look(ty2, tx1),
                     look(ty2, tx2), xa, ya)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def _apply_luts_regions(channel: torch.Tensor, lut: torch.Tensor,
                        tiles_y: int, tiles_x: int,
                        th: int, tw: int) -> torch.Tensor:
    """Region-wise LUT application (even tile sizes): shifted by half a
    tile, the image splits into th×tw regions whose 4 neighbour LUTs are
    fixed and whose blend weights are ``r/th``, ``c/tw``."""
    h, w = channel.shape
    py, px = th // 2, tw // 2
    nby = -(-(h + py) // th)
    nbx = -(-(w + px) // tw)
    xp = F.pad(channel[None, None].float(),
               (px, nbx * tw - w - px, py, nby * th - h - py),
               mode="replicate")[0, 0].to(torch.int64)
    regions = xp.reshape(nby, th, nbx, tw).permute(0, 2, 1, 3)
    regions = regions.reshape(nby * nbx, th * tw)

    dev = channel.device
    t1y = torch.from_numpy(np.clip(np.arange(nby) - 1, 0, tiles_y - 1)).to(dev)
    t2y = torch.from_numpy(np.clip(np.arange(nby), 0, tiles_y - 1)).to(dev)
    t1x = torch.from_numpy(np.clip(np.arange(nbx) - 1, 0, tiles_x - 1)).to(dev)
    t2x = torch.from_numpy(np.clip(np.arange(nbx), 0, tiles_x - 1)).to(dev)
    L = lut.reshape(tiles_y, tiles_x, 256)
    quads = [L[ty][:, tx].reshape(nby * nbx, 256)
             for ty, tx in ((t1y, t1x), (t1y, t2x), (t2y, t1x), (t2y, t2x))]
    vals = [torch.gather(q, 1, regions) for q in quads]

    ya = (torch.arange(th, dtype=torch.float32, device=dev) / th)[:, None]
    xa = (torch.arange(tw, dtype=torch.float32, device=dev) / tw)[None, :]
    ya = ya.expand(th, tw).reshape(-1)
    xa = xa.expand(th, tw).reshape(-1)
    out = _blend(*vals, xa, ya)
    out = out.reshape(nby, nbx, th, tw).permute(0, 2, 1, 3)
    out = out.reshape(nby * th, nbx * tw)
    return out[py:py + h, px:px + w]
