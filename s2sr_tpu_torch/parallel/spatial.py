"""The ``sp`` axis: H split into bands, with halo rows exchanged between
neighbouring bands (the port's stand-in for the conv halos GSPMD inserts
in the JAX package).

- :func:`band_bounds` is the band plan: H split into ``n`` bands as even
  as they go, in units of ``unit`` rows (1 for RRDBNet, a window row for
  SwinIR, 8 rows for the GAN discriminator's three stride-2 convs). An
  uneven split gives the first bands one unit more (JAX's GSPMD pads the
  last shard instead; the values are the same), and rows short of a
  whole unit join the last band.
- The in-process exchange serving uses: the bands of one replica are
  tensors on the devices of its ``sp`` group (:meth:`Mesh.sp_group`),
  which may all be one device. :func:`extend` copies ``k`` halo rows from
  the neighbours onto a band's device; :func:`halo_apply` runs one layer
  over every band on its extended band and keeps the band's rows;
  :func:`roll_up` and :func:`roll_down` move ``k`` rows across bands as a
  cyclic roll of the whole image by ``∓k`` does (a shifted Swin block).
  Each layer is issued for every band before the next layer starts, so
  bands on different GPUs run concurrently and each copy waits only for
  its neighbour's previous layer.

Rows that lie beyond the image are never made up: a band at the image's
edge is not extended there, so a conv's zero padding stays the image's.
The rows a layer computes near an extended band's outer edge are wrong
(they miss their own neighbours) and are thrown away.

The ranks' exchange (training) is ``parallel/comm.py::halo_exchange``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def band_bounds(h: int, n: int, unit: int = 1) -> Tuple[Tuple[int, int], ...]:
    """``n`` bands ``(start, stop)`` covering rows ``[0, h)`` from the top,
    each a whole number of ``unit`` rows, as even as they go (the first
    ``(h // unit) mod n`` bands one unit taller); rows short of a whole
    unit at the bottom join the last band."""
    if n < 1 or unit < 1:
        raise ValueError(f"bands need n >= 1 and unit >= 1, got {n}, {unit}")
    q, r = divmod(h // unit, n)
    if q == 0:
        raise ValueError(f"H of {h} rows has {h // unit} units of {unit} "
                         f"rows: too few for {n} bands")
    out, start = [], 0
    for j in range(n):
        stop = start + (q + (j < r)) * unit
        out.append((start, stop))
        start = stop
    out[-1] = (out[-1][0], h)
    return tuple(out)


def split(x: torch.Tensor, bounds, devices: Sequence, dim: int = 1) -> list:
    """The bands of ``x`` along ``dim``, band j on ``devices[j]``."""
    return [x.narrow(dim, a, b - a).to(dev)
            for (a, b), dev in zip(bounds, devices)]


def gather(parts: Sequence[torch.Tensor], device, dim: int = 1):
    """The bands ``parts`` joined along ``dim`` on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim)


def _rows(parts, j: int, k: int, dim: int, above: bool) -> list:
    """Up to ``k`` rows next to band j, from the bands above it (their
    last rows) or below it (their first rows), on band j's device, in
    image order."""
    dev, got, need = parts[j].device, [], k
    order = range(j - 1, -1, -1) if above else range(j + 1, len(parts))
    for i in order:
        if need == 0:
            break
        n = parts[i].shape[dim]
        take = min(need, n)
        got.append(parts[i].narrow(dim, n - take if above else 0, take)
                   .to(dev))
        need -= take
    return got[::-1] if above else got


def extend(parts: Sequence[torch.Tensor], j: int, k: int,
           dim: int = 1) -> tuple:
    """Band j with up to ``k`` neighbour rows above and below it (fewer at
    the image's edges) → ``(extended, rows_above, rows_below)``."""
    top = _rows(parts, j, k, dim, above=True)
    bot = _rows(parts, j, k, dim, above=False)
    ext = torch.cat(top + [parts[j]] + bot, dim) if top or bot else parts[j]
    return (ext, sum(t.shape[dim] for t in top),
            sum(t.shape[dim] for t in bot))


def halo_apply(fn: Callable, parts: Sequence[torch.Tensor], k: int,
               dim: int = 1, scale: int = 1, extra: Sequence = ()) -> list:
    """``fn(extended_band, j, *extended_extras)`` over every band on its
    ``k``-row extended band, keeping the band's own rows of the result
    (``scale`` result rows per input row). ``extra`` holds lists of
    per-band tensors (a mask) extended alike, or None entries."""
    ext = [extend(parts, j, k, dim) for j in range(len(parts))]
    more = [[None if e is None else extend(e, j, k, dim)[0] for e in extra]
            for j in range(len(parts))]
    out = []
    for j, (x, top, _) in enumerate(ext):
        y = fn(x, j, *more[j])
        out.append(y.narrow(dim, top * scale, parts[j].shape[dim] * scale))
    return out


def roll_up(parts: Sequence[torch.Tensor], k: int, dim: int = 1) -> list:
    """Every band as the whole image rolled by ``-k`` rows holds it: band j
    without its first ``k`` rows, then band j+1's first ``k`` (the last
    band takes band 0's). Bands of at least ``k`` rows."""
    n = len(parts)
    return [torch.cat([p.narrow(dim, k, p.shape[dim] - k),
                       parts[(j + 1) % n].narrow(dim, 0, k).to(p.device)],
                      dim) for j, p in enumerate(parts)]


def roll_down(parts: Sequence[torch.Tensor], k: int, dim: int = 1) -> list:
    """The inverse of :func:`roll_up`: band j−1's last ``k`` rows (the
    first band takes the last band's), then band j without its last ``k``."""
    return [torch.cat([parts[j - 1].narrow(dim, parts[j - 1].shape[dim] - k,
                                           k).to(p.device),
                       p.narrow(dim, 0, p.shape[dim] - k)], dim)
            for j, p in enumerate(parts)]

