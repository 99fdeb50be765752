"""Segmentation primitives in PyTorch (scipy.ndimage / cv2 equivalents).

The port of ``s2sr_tpu/vectors/ops.py``: the same functions under the
same names, on the device of their input tensor. Each keeps the JAX
function's semantics:

- :func:`gaussian_filter`: scipy's kernel (truncate 4.0, reflect mode),
  the taps summed in the JAX function's order as explicit shifted sums;
  eager PyTorch rounds each multiply and each add on its own, on the
  CPU and on the card, and never runs a convolution (no TF32);
- :func:`binary_close` / :func:`binary_open`: cv2 ellipse kernels, with
  the ``valid`` rectangle taking cv2's constant border values;
- :func:`fill_holes`: border flood of the complement;
- :func:`distance_transform`: jump flooding with wrap-around rolls and
  the strictly-closer rule over the 8 offsets in the JAX order;
- :func:`connected_components`: each 8-connected component labelled with
  its smallest flat index + 1, by min-label relaxation with pointer
  jumping (any algorithm that computes that quantity gives the same
  labels);
- :func:`watershed_uniform` / :func:`watershed_gradient`: the JAX
  functions' synchronous min-label passes, ties to the smaller label.

``lax.while_loop`` keeps its convergence test on the device; here each
test is a host read. The loops are fixpoints (one more pass changes
nothing), so they test every ``check_every`` passes: 1 on the CPU,
:data:`CHECK_EVERY_CUDA` on the card. :data:`PASSES` holds the passes
each loop ran in its last call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# passes between convergence tests on the card (each test is a sync)
CHECK_EVERY_CUDA = 16
# passes run by each fixpoint loop in its last call
PASSES: dict = {}


def _check_every(t: torch.Tensor) -> int:
    return CHECK_EVERY_CUDA if t.device.type == "cuda" else 1


def _fixpoint(name: str, state: torch.Tensor, step, done) -> torch.Tensor:
    """Run ``step`` until ``done(new, old)`` holds on a tested pass;
    record the passes run under ``name``."""
    every = _check_every(state)
    passes = 0
    while True:
        for _ in range(every - 1):
            state = step(state)
            passes += 1
        new = step(state)
        passes += 1
        if done(new, state):
            PASSES[name] = passes
            return new
        state = new


def _symmetric_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """numpy 'symmetric' padding (edge sample repeated) as gather indices,
    reflecting as often as the pad needs."""
    i = torch.arange(-lo, n + hi, device=device)
    j = torch.remainder(i, 2 * n)
    return torch.where(j >= n, 2 * n - 1 - j, j)


# --- gaussian (scipy.ndimage semantics) --------------------------------

def _scipy_gauss_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _tap_sum(xp: torch.Tensor, k: np.ndarray, n: int, dim: int) -> torch.Tensor:
    out = None
    for i, kv in enumerate(k.tolist()):
        term = xp.narrow(dim, i, n) * kv
        out = term if out is None else out + term
    return out


def gaussian_filter(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter (2-D, mode='reflect') equivalent."""
    k = _scipy_gauss_kernel(sigma)
    radius = (k.shape[0] - 1) // 2
    h, w = img.shape
    x = img.to(torch.float32)
    xp = x.index_select(0, _symmetric_index(h, radius, radius, x.device))
    x = _tap_sum(xp, k, h, 0)
    xp = x.index_select(1, _symmetric_index(w, radius, radius, x.device))
    return _tap_sum(xp, k, w, 1)


# --- morphology (cv2 semantics) ----------------------------------------

def ellipse_kernel(size: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (size, size))."""
    r = size // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = abs(i - r)
        if r > 0:
            dx = int(round(r * math.sqrt(max(0.0, 1.0 - (dy * dy) * inv_r2))))
        else:
            dx = 0
        kernel[i, max(r - dx, 0):min(r + dx + 1, size)] = 1
    return kernel


def _shift_reduce(x: torch.Tensor, kernel: np.ndarray, fill, op) -> torch.Tensor:
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    h, w = x.shape
    xp = torch.full((h + 2 * ph, w + 2 * pw), fill, dtype=x.dtype,
                    device=x.device)
    xp[ph:ph + h, pw:pw + w] = x
    out = None
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j]:
                win = xp[i:i + h, j:j + w]
                out = win if out is None else op(out, win)
    return out


def _dilate_once(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    return _shift_reduce(x, kernel, 0, torch.maximum)


def _erode_once(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    return _shift_reduce(x, kernel, 1, torch.minimum)


def _where_valid(x: torch.Tensor, valid, fill: int) -> torch.Tensor:
    if valid is None:
        return x
    return torch.where(valid, x, torch.full_like(x, fill))


def binary_close(mask: torch.Tensor, kernel_size: int = 5,
                 iterations: int = 2,
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """cv2.morphologyEx(MORPH_CLOSE, ellipse): dilate×n then erode×n.

    With ``valid`` (bool mask of the true image rectangle inside a
    shape-bucketed frame), pixels outside it take cv2's BORDER_CONSTANT
    values (0 for dilate, 1 for erode), so results on the valid
    rectangle match cv2 on the unpadded crop."""
    kernel = ellipse_kernel(kernel_size)
    x = mask.to(torch.uint8)
    for _ in range(iterations):
        x = _dilate_once(_where_valid(x, valid, 0), kernel)
    for _ in range(iterations):
        x = _erode_once(_where_valid(x, valid, 1), kernel)
    return _where_valid(x, valid, 0)


def binary_open(mask: torch.Tensor, kernel_size: int = 5,
                iterations: int = 2,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    kernel = ellipse_kernel(kernel_size)
    x = mask.to(torch.uint8)
    for _ in range(iterations):
        x = _erode_once(_where_valid(x, valid, 1), kernel)
    for _ in range(iterations):
        x = _dilate_once(_where_valid(x, valid, 0), kernel)
    return _where_valid(x, valid, 0)


# --- hole filling ------------------------------------------------------

_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.binary_fill_holes equivalent: flood the complement
    from the border (4-connected, scipy's default structure); anything
    unreached is a hole and is filled."""
    inv = mask == 0
    border = torch.zeros_like(inv)
    border[0, :] = True
    border[-1, :] = True
    border[:, 0] = True
    border[:, -1] = True
    inv_u8 = inv.to(torch.uint8)

    def step(reach):
        return torch.minimum(_dilate_once(reach, _CROSS), inv_u8)

    reach = _fixpoint("fill_holes", (border & inv).to(torch.uint8), step,
                      torch.equal)
    return (mask.bool() | ((reach == 0) & inv)).to(torch.uint8)


# --- distance transform (jump flooding) --------------------------------

def distance_transform(mask: torch.Tensor) -> torch.Tensor:
    """Euclidean distance to the nearest zero pixel by jump flooding:
    log2(n) gather passes over (y, x) seeds, exactly the JAX function's
    passes (rolls wrap around; a candidate is taken only if strictly
    closer, offsets in row-major order)."""
    h, w = mask.shape
    dev = mask.device
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    big = 1 << 20
    inside = mask > 0
    sy = torch.where(inside, big, yy)
    sx = torch.where(inside, big, xx)
    far = torch.tensor(1e18, dtype=torch.float32, device=dev)

    def dist2(cy, cx):
        dy = (cy - yy).to(torch.float32)
        dx = (cx - xx).to(torch.float32)
        return torch.where(cy >= big, far, dy * dy + dx * dx)

    steps = []
    step = 1 << max(h, w).bit_length()
    while step >= 1:
        steps.append(step)
        step //= 2
    for step in steps:
        best = dist2(sy, sx)
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                cy = torch.roll(sy, (dy, dx), (0, 1))
                cx = torch.roll(sx, (dy, dx), (0, 1))
                d = dist2(cy, cx)
                take = d < best
                best = torch.where(take, d, best)
                sy = torch.where(take, cy, sy)
                sx = torch.where(take, cx, sx)
    return torch.sqrt(dist2(sy, sx))


# --- connected components ---------------------------------------------

def _min_neighbours(lab: torch.Tensor, fill: int) -> torch.Tensor:
    """Min of ``lab`` over each pixel and its 8 neighbours (``fill``
    outside the frame)."""
    h, w = lab.shape
    lp = torch.full((h + 2, w + 2), fill, dtype=lab.dtype, device=lab.device)
    lp[1:-1, 1:-1] = lab
    best = lab
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            best = torch.minimum(best, lp[dy:dy + h, dx:dx + w])
    return best


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """8-connected labelling: each component gets its smallest flat index
    + 1, background 0 (the JAX function's output; use
    :func:`renumber_labels` for compact ids).

    Each pass takes the min over the 8-neighbourhood, then jumps every
    label to its target's label: labels stay flat indices of pixels of
    the same component and only fall, so the fixpoint is the
    component's minimum, reached in far fewer passes than the plain
    relaxation."""
    h, w = mask.shape
    inside = mask > 0
    idx = torch.arange(h * w, dtype=torch.int64, device=mask.device).view(h, w)
    big = h * w + 1
    lab0 = torch.where(inside, idx, big)

    def step(lab):
        new = torch.where(inside, _min_neighbours(lab, big), big)
        flat = new.reshape(-1)
        jumped = flat[torch.where(inside, new, 0).reshape(-1)].view(h, w)
        return torch.where(inside, torch.minimum(new, jumped), big)

    labels = _fixpoint("connected_components", lab0, step, torch.equal)
    return torch.where(inside, labels + 1, 0).to(torch.int32)


def renumber_labels(labels: np.ndarray) -> np.ndarray:
    """Compact nonzero labels to 1..N (host-side, vectorized)."""
    unique = np.unique(labels)
    compact = np.cumsum(unique > 0).astype(np.int32)  # 0 stays 0
    return compact[np.searchsorted(unique, labels)]


# --- watershed (uniform-image flooding) --------------------------------

_BIG = 1 << 30


def _spread(lab: torch.Tensor, allowed: torch.Tensor | None) -> torch.Tensor:
    """One synchronous pass: every unassigned (allowed) pixel adopts the
    smallest label among its 8 neighbours."""
    current = torch.where(lab > 0, lab, _BIG)
    best = _min_neighbours(current, _BIG)
    unassigned = lab == _BIG
    if allowed is not None:
        unassigned = unassigned & allowed
    return torch.where(unassigned & (best < _BIG), best, lab)


def _watershed_init(markers: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    m = markers.to(torch.int32)
    lab0 = torch.where(m > 0, m, _BIG)
    return torch.where(inside | (m > 0), lab0, -1)


def _watershed_out(lab: torch.Tensor) -> torch.Tensor:
    lab = torch.where(lab >= _BIG, 0, lab)
    return torch.where(lab < 0, 0, lab)


def watershed_uniform(markers: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Flood marker labels geodesically through ``mask`` until it is
    covered: the JAX function's synchronous passes, ties at equidistant
    fronts to the smaller label.

    ``markers``: int, 0 = unassigned; ``mask``: flood region (>0)."""
    lab = _fixpoint("watershed_uniform",
                    _watershed_init(markers, mask > 0),
                    lambda lab: _spread(lab, None), torch.equal)
    return _watershed_out(lab)


# --- v2 additions: sobel, maximum filter, gradient watershed -----------

def sobel_gradient(img: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude from scipy-style Sobel filters (reflect mode)."""
    x = img.to(torch.float32)
    h, w = x.shape
    xp = x.index_select(0, _symmetric_index(h, 1, 1, x.device))
    xp = xp.index_select(1, _symmetric_index(w, 1, 1, x.device))

    def s(dy, dx):
        return xp[dy:dy + h, dx:dx + w]

    gx = ((s(0, 2) + 2 * s(1, 2) + s(2, 2))
          - (s(0, 0) + 2 * s(1, 0) + s(2, 0)))
    gy = ((s(2, 0) + 2 * s(2, 1) + s(2, 2))
          - (s(0, 0) + 2 * s(0, 1) + s(0, 2)))
    return torch.sqrt(gx * gx + gy * gy)


def maximum_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """scipy.ndimage.maximum_filter (square window, reflect mode)."""
    lo = size // 2
    hi = size - 1 - lo
    x = img.to(torch.float32)
    h, w = x.shape
    xp = x.index_select(0, _symmetric_index(h, lo, hi, x.device))
    x = xp[0:h]
    for i in range(1, size):
        x = torch.maximum(x, xp[i:i + h])
    xp = x.index_select(1, _symmetric_index(w, lo, hi, x.device))
    x = xp[:, 0:w]
    for i in range(1, size):
        x = torch.maximum(x, xp[:, i:i + w])
    return x


def watershed_gradient(markers: torch.Tensor, gradient: torch.Tensor,
                       mask: torch.Tensor, levels: int = 64) -> torch.Tensor:
    """Marker-driven watershed on a gradient surface: the gradient
    quantised into ``levels`` bands, labels spread geodesically through
    each band lowest-first with the synchronous passes of
    :func:`watershed_uniform`."""
    inside = mask > 0
    g = gradient.to(torch.float32)
    gmin = torch.min(g)
    gmax = torch.max(g)
    span = torch.clamp(gmax - gmin, min=1e-12)
    q = torch.clamp(((g - gmin) / span * (levels - 1)).to(torch.int32),
                    0, levels - 1)
    lab = _watershed_init(markers, inside)
    total = 0
    for level in range(levels):
        allowed = inside & (q <= level)
        lab = _fixpoint("watershed_gradient", lab,
                        lambda lab: _spread(lab, allowed), torch.equal)
        total += PASSES["watershed_gradient"]
    PASSES["watershed_gradient"] = total
    return _watershed_out(lab)


def _quantile_linear(sorted_vals: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(method="linear")`` on already sorted float32 values
    (no 2**24 element limit, unlike ``torch.quantile``)."""
    n = sorted_vals.shape[0]
    pos = q * (n - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    lo_v = sorted_vals[low.to(torch.int64)]
    hi_v = sorted_vals[high.to(torch.int64)]
    return lo_v * lw + hi_v * hw


def kmeans_1d(values: torch.Tensor, k: int, iters: int = 25,
              seed: int = 42) -> torch.Tensor:
    """Lloyd's k-means on a 1-D feature (the management-zone
    clustering), quantile-initialised. Returns labels ordered so cluster
    ids are sorted by centroid value."""
    vals = values.reshape(-1).to(torch.float32)
    qs = (torch.arange(k, device=vals.device, dtype=torch.float32) + 0.5) / k
    centers = _quantile_linear(torch.sort(vals).values, qs)
    ones = torch.ones_like(vals)
    for _ in range(iters):
        assign = torch.argmin(torch.abs(vals[:, None] - centers[None, :]), dim=1)
        sums = torch.zeros(k, dtype=torch.float32, device=vals.device)
        sums.index_add_(0, assign, vals)
        counts = torch.zeros(k, dtype=torch.float32, device=vals.device)
        counts.index_add_(0, assign, ones)
        centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                              centers)
    order = torch.argsort(centers)
    rank = torch.argsort(order)
    assign = torch.argmin(torch.abs(vals[:, None] - centers[None, :]), dim=1)
    return rank[assign]
