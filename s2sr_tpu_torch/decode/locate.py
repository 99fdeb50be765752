"""QR locating: binarization on the card + finder-pattern geometry.

The port of ``s2sr_tpu/decode/locate.py``. The adaptive binarizer (the
JAX package's jitted ``_binarize_device``) runs in torch on ``device``,
the card unless the caller asks for the CPU. Everything after
binarization is host-side numpy, copied as it is: 1:1:3:1:1 finder
scanning (zxing/jsQR ratio method), triple ordering, alignment
refinement, and a 4-point homography sample.

The threshold is float32 arithmetic whose every rounding decides a pixel
that lies on it, so the device part repeats XLA's order of operations on
the CPU, where the JAX package's tests run it: each 8×8 block's sum in
row-major order, and each cumulative sum as XLA's rewrite of a long
cumulative reduce-window computes it (sequential within chunks of 16,
the chunk totals scanned the same way, then each chunk's exclusive
prefix added). Additions alone, in a fixed order: the card and the CPU
give the same bits, and the same bits as jitted JAX.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..models.engine import resolve_device
from .qr_tables import MAX_VERSION


# ---------------------------------------------------------------------------
# binarization (device)
# ---------------------------------------------------------------------------


_BLOCK = 8              # hybrid-binarizer block edge, pixels
_MIN_DYNAMIC = 24.0     # below this block contrast: no local threshold
_SCAN_CHUNK = 16        # XLA's base length for a long cumulative sum


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumulative sum along the last axis, in XLA's
    order (see the module docstring)."""
    n = x.shape[-1]
    if n <= _SCAN_CHUNK:
        cols = [x[..., 0]]
        for k in range(1, n):
            cols.append(cols[-1] + x[..., k])
        return torch.stack(cols, -1)
    nc = -(-n // _SCAN_CHUNK)
    pad = torch.nn.functional.pad(x, (0, nc * _SCAN_CHUNK - n))
    inner = _cumsum_last(pad.reshape(*x.shape[:-1], nc, _SCAN_CHUNK))
    prefix = _cumsum_last(inner[..., -1].contiguous())
    excl = torch.nn.functional.pad(prefix[..., :-1], (1, 0))
    out = inner + excl[..., None]
    return out.reshape(*x.shape[:-1], nc * _SCAN_CHUNK)[..., :n]


def _cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    return _cumsum_last(x.movedim(axis, -1)).movedim(-1, axis)


def _binarize_device(gray: torch.Tensor) -> torch.Tensor:
    """zxing-style hybrid block binarizer on ``gray``'s device.

    Per 8×8 block: average / min / max. Low-contrast blocks (a big
    solid area, e.g. a finder core) get blackpoint ``min/2`` so they
    cannot claim a local threshold; the per-pixel threshold is the 5×5
    block-neighbourhood mean of blackpoints, which pulls the decision
    boundary in from the nearest region that actually has both tones.
    A plain mean threshold erodes any dark region wider than its
    window — this formulation is what makes 3-module finder cores
    survive.
    """
    h, w = gray.shape
    nb_h, nb_w = h // _BLOCK, w // _BLOCK
    blocks = gray.reshape(nb_h, _BLOCK, nb_w, _BLOCK).permute(0, 2, 1, 3) \
        .reshape(nb_h, nb_w, _BLOCK * _BLOCK)
    total = blocks[..., 0]
    for k in range(1, _BLOCK * _BLOCK):
        total = total + blocks[..., k]
    avg = total / float(_BLOCK * _BLOCK)
    mn = blocks.amin(-1)
    mx = blocks.amax(-1)
    blackpoint = torch.where(mx - mn > _MIN_DYNAMIC, avg, mn / 2.0)

    # 5×5 block smoothing via integral image (clamped window at edges)
    pad = torch.nn.functional.pad
    ii = pad(_cumsum(_cumsum(blackpoint, 0), 1), (1, 0, 1, 0))
    ones = pad(_cumsum(_cumsum(torch.ones_like(blackpoint), 0), 1),
               (1, 0, 1, 0))
    dev = gray.device
    y0 = torch.clamp(torch.arange(nb_h, device=dev) - 2, 0, nb_h)
    y1 = torch.clamp(torch.arange(nb_h, device=dev) + 3, 0, nb_h)
    x0 = torch.clamp(torch.arange(nb_w, device=dev) - 2, 0, nb_w)
    x1 = torch.clamp(torch.arange(nb_w, device=dev) + 3, 0, nb_w)

    def box(m):
        return m[y1][:, x1] - m[y0][:, x1] - m[y1][:, x0] + m[y0][:, x0]

    thr_blocks = box(ii) / box(ones)
    thr = thr_blocks.repeat_interleave(_BLOCK, 0) \
        .repeat_interleave(_BLOCK, 1)
    return gray <= thr


def binarize(image: np.ndarray, pad_mode: str = "white",
             device="cuda") -> np.ndarray:
    """uint8 H×W[×3] image → bool dark-module map (host array).

    Gray is computed on the host in float32; the thresholding runs on
    ``device`` (one copy back of the bool map). ``pad_mode``: the image
    is padded to a 256-multiple bucket, as the JAX package pads it for
    its executable cache; the pad is part of the answer (it decides the
    edge blocks' thresholds). ``"white"`` makes the padding read as a
    QR quiet zone; ``"edge"`` replicates the border instead (for OCR on
    dark-background plates, where a white pad injects a false edge into
    the boundary blocks).
    """
    img = np.asarray(image)
    if img.ndim == 3:
        gray = img[..., :3].astype(np.float32) @ np.array(
            [0.299, 0.587, 0.114], np.float32)
    else:
        gray = img.astype(np.float32)
    h, w = gray.shape
    hp = max(256, -(-h // 256) * 256)
    wp = max(256, -(-w // 256) * 256)
    if pad_mode == "edge":
        pad = np.pad(gray, ((0, hp - h), (0, wp - w)), mode="edge")
    else:
        pad = np.full((hp, wp), 255.0, np.float32)
        pad[:h, :w] = gray
    dev = resolve_device(device)
    out = _binarize_device(torch.from_numpy(pad).to(dev)).cpu().numpy()
    return out[:h, :w]


# ---------------------------------------------------------------------------
# finder patterns
# ---------------------------------------------------------------------------


def _ratio_ok(runs: list[int], tol: float = 0.55) -> float | None:
    """Check 1:1:3:1:1; return module size estimate or None."""
    total = sum(runs)
    if total < 7 or min(runs) == 0:
        return None
    ms = total / 7.0
    expected = (1, 1, 3, 1, 1)
    for r, e in zip(runs, expected):
        if abs(r - e * ms) > tol * ms * e:
            return None
    return ms


def _scan_rows(b: np.ndarray, row_step: int = 2
               ) -> list[tuple[float, float, float]]:
    """Row-wise 1:1:3:1:1 candidates → (x, y, module_size).

    Fully vectorised: run-length-encodes every scanned row in one pass
    (transitions of the flattened image with row-boundary sentinels)
    and ratio-tests all 5-run windows at once. ``row_step=2`` halves
    the work — a finder's 3-module core spans ≥4 rows at any decodable
    module size, so every true centre still gets ≥2 supporting rows.
    """
    rows = b[::row_step]
    n, w = rows.shape
    a = rows.astype(np.int8)
    # transitions within rows; row starts are implicit run starts
    flat = a.ravel()
    change = np.flatnonzero(np.diff(flat)) + 1
    row_starts = np.arange(1, n) * w
    starts = np.unique(np.concatenate([[0], change, row_starts]))
    lengths = np.diff(np.append(starts, n * w))
    vals = flat[starts]
    row_of = starts // w

    if len(starts) < 5:
        return []
    # windows of 5 consecutive runs, entirely within one row, dark-first
    L = np.lib.stride_tricks.sliding_window_view(lengths, 5)
    S = starts[: len(L)]
    ok = (vals[: len(L)] == 1) & (row_of[: len(L)] == row_of[4: 4 + len(L)])
    total = L.sum(axis=1)
    ms = total / 7.0
    expected = np.array([1, 1, 3, 1, 1])
    ok &= (np.abs(L - expected * ms[:, None])
           <= 0.55 * ms[:, None] * expected).all(axis=1)
    # below ~1.2 px/module nothing decodes (the multi-scale ladder finds
    # such codes at a finer scale instead); this drops the vast majority
    # of noise-image false windows
    ok &= total >= 9
    idx = np.flatnonzero(ok)
    cx = (S[idx] % w + L[idx, 0] + L[idx, 1] + L[idx, 2] / 2.0).astype(float)
    cy = (row_of[idx] * row_step).astype(float)
    return list(zip(cx.tolist(), cy.tolist(), ms[idx].tolist()))


def _cross_check(line: np.ndarray, c0: int, ms_hint: float
                 ) -> tuple[float, float] | None:
    """Walk outward from ``c0`` along ``line`` (must be dark there),
    collect the 1:1:3:1:1 runs, and return (module_size,
    refined_center) — the center of the middle dark run — or None."""
    n = len(line)
    if not (0 <= c0 < n and line[c0]):
        return None
    lo = c0
    while lo > 0 and line[lo - 1]:
        lo -= 1
    hi = c0
    while hi < n - 1 and line[hi + 1]:
        hi += 1
    runs = [0, 0, hi - lo + 1, 0, 0]
    cap = 4 * max(ms_hint, runs[2] / 3.0)
    i = lo - 1
    for k in (1, 0):
        want_dark = k == 0
        while i >= 0 and bool(line[i]) == want_dark and runs[k] < cap:
            runs[k] += 1
            i -= 1
        if runs[k] >= cap:
            return None
    i = hi + 1
    for k in (3, 4):
        want_dark = k == 4
        while i < n and bool(line[i]) == want_dark and runs[k] < cap:
            runs[k] += 1
            i += 1
        if runs[k] >= cap:
            return None
    ms = _ratio_ok(runs)
    if ms is None:
        return None
    return ms, (lo + hi + 1) / 2.0


def find_finder_patterns(b: np.ndarray) -> list[tuple[float, float, float]]:
    """Cross-checked, clustered finder centres → [(x, y, module_size)],
    strongest (most supporting scanlines) first."""
    raw = _scan_rows(b)
    if len(raw) > 8000:
        # textured/noise images can emit tens of thousands of ratio
        # coincidences; true finders produce the LARGEST module sizes
        # with many supporting rows, so keep the biggest-ms slice
        raw.sort(key=lambda c: -c[2])
        raw = raw[:8000]
    clusters: list[list[float]] = []   # sum_x, sum_y, sum_ms, weight
    for x, y, ms in raw:
        v = _cross_check(b[:, int(x)], int(y), ms)
        if v is None:
            continue
        ms_v, cy = v
        hline = b[int(cy)]
        h_ = _cross_check(hline, int(x), ms)
        if h_ is None:
            continue
        ms_h, cx = h_
        # diagonal sanity: the three centre modules must be dark
        d = int(round(ms / 2))
        yy, xx = int(cy), int(cx)
        if 0 <= yy - d and yy + d < b.shape[0] and 0 <= xx - d \
                and xx + d < b.shape[1]:
            if not (b[yy - d, xx - d] and b[yy + d, xx + d]):
                continue
        ms = (ms_v + ms_h) / 2.0
        for cl in clusters:
            w_ = cl[3]
            if abs(cl[0] / w_ - cx) < 2 * ms and abs(cl[1] / w_ - cy) < 2 * ms:
                cl[0] += cx
                cl[1] += cy
                cl[2] += ms
                cl[3] += 1
                break
        else:
            clusters.append([cx, cy, ms, 1.0])
    out = [(c[0] / c[3], c[1] / c[3], c[2] / c[3], c[3]) for c in clusters
           if c[3] >= 2]
    out.sort(key=lambda c: -c[3])
    return [(x, y, ms) for x, y, ms, _ in out]


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _order_triple(p1, p2, p3):
    """Return (top_left, top_right, bottom_left) in image coords
    (y down): TL is opposite the longest side; TR chosen so the frame
    is right-handed."""
    pts = [np.array(p[:2]) for p in (p1, p2, p3)]
    d = [np.linalg.norm(pts[(i + 1) % 3] - pts[(i + 2) % 3]) for i in range(3)]
    tl_i = int(np.argmax(d))
    tl = pts[tl_i]
    a, b = [pts[i] for i in range(3) if i != tl_i]
    # cross((a-tl),(b-tl)) > 0 (y down) → a is TR, b is BL
    va, vb = a - tl, b - tl
    cr = va[0] * vb[1] - va[1] * vb[0]
    tr, bl = (a, b) if cr > 0 else (b, a)
    return tl, tr, bl


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """4-point homography mapping src (module coords) → dst (pixels)."""
    A = []
    for (u, v), (x, y) in zip(src, dst):
        A.append([u, v, 1, 0, 0, 0, -u * x, -v * x, -x])
        A.append([0, 0, 0, u, v, 1, -u * y, -v * y, -y])
    A = np.asarray(A, np.float64)
    _, _, vt = np.linalg.svd(A)
    H = vt[-1].reshape(3, 3)
    return H / H[2, 2]


def _refine_alignment(b: np.ndarray, est: np.ndarray, ms: float
                      ) -> np.ndarray:
    """Search a window around the estimated alignment centre for the
    dark 1:1:1 core; fall back to the estimate."""
    h, w = b.shape
    r = int(round(3 * ms))
    x0, y0 = int(est[0]), int(est[1])
    best, best_d = None, 1e18
    for y in range(max(1, y0 - r), min(h - 1, y0 + r + 1)):
        for x in range(max(1, x0 - r), min(w - 1, x0 + r + 1)):
            if not b[y, x]:
                continue
            # horizontal dark run centred at x should be ~1 module,
            # flanked by light runs of ~1 module
            lx = x
            while lx > 0 and b[y, lx - 1]:
                lx -= 1
            rx = x
            while rx < w - 1 and b[y, rx + 1]:
                rx += 1
            dark = rx - lx + 1
            if dark > 2.5 * ms or dark < 0.4 * ms:
                continue
            # continuous-coordinate convention (pixel i spans [i, i+1)):
            # run lx..rx centers at (lx+rx+1)/2, row y at y+0.5 — same
            # convention as _cross_check's (lo+hi+1)/2 finder centers
            cx = (lx + rx + 1) / 2.0
            cy = y + 0.5
            d = (cx - est[0]) ** 2 + (cy - est[1]) ** 2
            if d < best_d:
                best, best_d = np.array([cx, cy]), d
    return best if best is not None else est


def _ms_along(b: np.ndarray, center: np.ndarray, toward: np.ndarray
              ) -> float | None:
    """Module size measured along the center→toward direction: walk out
    of the finder core and time the 1.5/2.5/3.5-module transitions.
    Axis-aligned scanline estimates inflate by 1/cos(θ) under rotation;
    this direction-aware measure does not."""
    h, w = b.shape
    d = toward - center
    norm = float(np.hypot(d[0], d[1]))
    if norm < 1e-6:
        return None
    step = d / norm

    def walk(sgn: float) -> float | None:
        # expect: dark core → light ring → dark ring; return t at the
        # dark ring's outer edge (3.5 modules from center)
        t = 0.0
        state = 0            # 0 in-core, 1 in light ring, 2 in dark ring
        while t < norm:
            x = center + step * (t * sgn)
            xi, yi = int(x[0]), int(x[1])
            if not (0 <= xi < w and 0 <= yi < h):
                return None
            dark = bool(b[yi, xi])
            if state == 0 and not dark:
                state = 1
            elif state == 1 and dark:
                state = 2
            elif state == 2 and not dark:
                return t
            t += 0.5
        return None

    t_fwd = walk(1.0)
    t_back = walk(-1.0)
    ts = [t for t in (t_fwd, t_back) if t is not None]
    if not ts:
        return None
    return float(np.mean(ts)) / 3.5


def extract_matrices(b: np.ndarray):
    """Yield (module_matrix, corner_list) candidates from a binarized
    image, most promising triple first."""
    finders = find_finder_patterns(b)
    if len(finders) < 3:
        return
    h, w = b.shape
    tried = 0
    for combo in itertools.combinations(finders[:6], 3):
        if tried >= 4:
            break
        mss = [c[2] for c in combo]
        if max(mss) > 2.0 * min(mss):
            continue
        tl, tr, bl = _order_triple(*combo)
        ms = float(np.mean(mss))
        d_top = np.linalg.norm(tr - tl)
        d_left = np.linalg.norm(bl - tl)
        if not 0.5 < d_top / max(d_left, 1e-6) < 2.0:
            continue
        tried += 1

        # direction-aware module size (rotation-proof); scanline ms as
        # fallback when the walk fails
        ms_t = _ms_along(b, tl, tr)
        ms_l = _ms_along(b, tl, bl)
        dir_ms = [m for m in (ms_t, ms_l) if m]
        ms_est = float(np.mean(dir_ms)) if dir_ms else ms
        dim0 = int(round((d_top + d_left) / (2 * ms_est))) + 7

        def snap(d):
            return max(21, min(4 * MAX_VERSION + 17,
                               (d - 17 + 2) // 4 * 4 + 17))

        dims = []
        for cand in (snap(dim0), snap(dim0) - 4, snap(dim0) + 4):
            if 21 <= cand <= 4 * MAX_VERSION + 17 and cand not in dims:
                dims.append(cand)

        for dim in dims:
            n_mod = dim - 7.0
            u = (tr - tl) / n_mod
            v = (bl - tl) / n_mod
            if dim > 21:
                est = tl + (u + v) * (dim - 10)
                p4 = _refine_alignment(b, est, ms)
                mod4 = (dim - 6.5, dim - 6.5)
            else:
                p4 = tl + (u + v) * n_mod
                mod4 = (dim - 3.5, dim - 3.5)

            src = np.array([(3.5, 3.5), (dim - 3.5, 3.5), (3.5, dim - 3.5),
                            mod4], np.float64)
            dst = np.array([tl, tr, bl, p4], np.float64)
            try:
                H = _homography(src, dst)
            except np.linalg.LinAlgError:
                continue

            jj, ii = np.meshgrid(np.arange(dim) + 0.5, np.arange(dim) + 0.5)
            pts = np.stack([jj.ravel(), ii.ravel(), np.ones(dim * dim)])
            mapped = H @ pts
            xs = mapped[0] / mapped[2]
            ys = mapped[1] / mapped[2]
            # under the continuous convention the pixel containing
            # coordinate x is floor(x), not round(x) (round = floor(x+.5)
            # would skew every sample half a pixel down-right)
            xi = np.clip(np.floor(xs).astype(int), 0, w - 1)
            yi = np.clip(np.floor(ys).astype(int), 0, h - 1)
            oob = ((xs < -1) | (xs > w) | (ys < -1) | (ys > h))
            if oob.mean() > 0.05:
                continue
            matrix = b[yi, xi].reshape(dim, dim)

            corners_mod = np.array([(0, 0), (dim, 0), (dim, dim), (0, dim)],
                                   np.float64)
            cpts = np.concatenate([corners_mod.T, np.ones((1, 4))])
            cm = H @ cpts
            corners = [(float(x / z), float(y / z))
                       for x, y, z in zip(cm[0], cm[1], cm[2])]
            yield matrix, corners
