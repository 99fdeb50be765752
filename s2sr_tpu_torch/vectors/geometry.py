"""Polygon geometry toolkit (GEOS/shapely replacement), in numpy.

The port's copy of ``s2sr_tpu/vectors/geometry.py``: the same code, so
the port's polygons equal the JAX package's on the same labels.

The reference leans on shapely/GEOS for polygonisation and cleanup
(``server/app/vector_extraction.py:386-532``); GEOS is absent in this
image, so the framework carries the needed subset:

- :func:`mask_to_rings` — exact pixel-edge boundary tracing of a binary
  region (the ``rasterio.features.shapes`` equivalent): directed
  edge-chaining with inside-on-the-left orientation; outer rings and
  holes separated by orientation/containment,
- :func:`simplify_ring` — Douglas-Peucker (the ``preserve_topology``
  guarantee is approximated: output keeps ≥4 points and is drawn from
  input vertices),
- shoelace area/perimeter, centroid, WKT formatting,
- :func:`rasterize_polygon` — scanline fill (rasterio.mask equivalent).

Coordinates are (x, y) pairs; pixel-space tracing uses pixel corners so
areas are exact pixel counts.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Ring = np.ndarray  # (N, 2) closed (first == last)


# --- ring tracing ------------------------------------------------------

def mask_to_rings(mask: np.ndarray) -> List[Ring]:
    """Trace all boundary rings of a binary mask in pixel-corner coords.

    Each ring is closed and oriented with the region interior on its
    left while walking (exteriors CCW in (x, up-y) terms; holes CW).
    Diagonal pinch points split into separate rings (4-connected
    boundary topology), matching shapely ``buffer(0)`` on the
    self-touching connectivity=8 shapes rasterio emits. v1's
    ``labels_to_polygons`` then keeps the largest piece per label
    (the reference's MultiPolygon→largest rule,
    ``vector_extraction.py:504-506``); v2 and zones keep every piece,
    as the reference does there (``vector_extraction_v2.py:875,692``).
    """
    mask = np.asarray(mask, bool)
    padded = np.pad(mask, 1)
    h, w = mask.shape

    # Directed edges, inside kept on the left (image coords: y down).
    # key: start vertex -> (end vertex)
    nxt: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}

    def add(a: Tuple[int, int], b: Tuple[int, int]) -> None:
        nxt.setdefault(a, []).append(b)

    inside = padded[1:-1, 1:-1]
    up = padded[:-2, 1:-1]
    down = padded[2:, 1:-1]
    left = padded[1:-1, :-2]
    right = padded[1:-1, 2:]

    ys, xs = np.nonzero(inside & ~up)       # top edges: walk +x
    for y, x in zip(ys, xs):
        add((x, y), (x + 1, y))
    ys, xs = np.nonzero(inside & ~down)     # bottom edges: walk −x
    for y, x in zip(ys, xs):
        add((x + 1, y + 1), (x, y + 1))
    ys, xs = np.nonzero(inside & ~left)     # left edges: walk −y (up)
    for y, x in zip(ys, xs):
        add((x, y + 1), (x, y))
    ys, xs = np.nonzero(inside & ~right)    # right edges: walk +y (down)
    for y, x in zip(ys, xs):
        add((x + 1, y), (x + 1, y + 1))

    rings: List[Ring] = []
    while nxt:
        start = next(iter(nxt))
        ring = [start]
        current = start
        prev_dir: Optional[Tuple[int, int]] = None
        while True:
            candidates = nxt.get(current)
            if not candidates:
                break
            if len(candidates) == 1 or prev_dir is None:
                target = candidates[0]
            else:
                # pinch vertex: prefer the sharpest right turn so rings
                # stay simple (no through-crossing)
                def turn_score(cand):
                    dx, dy = cand[0] - current[0], cand[1] - current[1]
                    px, py = prev_dir
                    cross = px * dy - py * dx
                    dot = px * dx + py * dy
                    return math.atan2(cross, dot)
                target = max(candidates, key=turn_score)
            candidates.remove(target)
            if not candidates:
                del nxt[current]
            prev_dir = (target[0] - current[0], target[1] - current[1])
            current = target
            ring.append(current)
            if current == start:
                break
        if len(ring) >= 4 and ring[0] == ring[-1]:
            rings.append(np.asarray(ring, np.float64))
    return rings


def _collapse_collinear(ring: Ring) -> Ring:
    """Drop redundant vertices on straight pixel-edge runs."""
    if len(ring) < 4:
        return ring
    pts = ring[:-1]
    keep = []
    n = len(pts)
    for i in range(n):
        a, b, c = pts[i - 1], pts[i], pts[(i + 1) % n]
        cross = (b[0] - a[0]) * (c[1] - b[1]) - (b[1] - a[1]) * (c[0] - b[0])
        if cross != 0:
            keep.append(pts[i])
    if len(keep) < 3:
        return ring
    keep.append(keep[0])
    return np.asarray(keep)


def ring_area(ring: Ring) -> float:
    """Signed shoelace area ((x, y) convention; sign encodes orientation)."""
    x, y = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = ring[1:, 0], ring[1:, 1]
    return 0.5 * float(np.sum(x * y2 - x2 * y))


def ring_perimeter(ring: Ring) -> float:
    d = np.diff(ring, axis=0)
    return float(np.sqrt((d**2).sum(axis=1)).sum())


def ring_centroid(ring: Ring) -> Tuple[float, float]:
    x, y = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = ring[1:, 0], ring[1:, 1]
    cross = x * y2 - x2 * y
    a = cross.sum() / 2.0
    if abs(a) < 1e-12:
        return float(ring[:, 0].mean()), float(ring[:, 1].mean())
    cx = float(((x + x2) * cross).sum() / (6.0 * a))
    cy = float(((y + y2) * cross).sum() / (6.0 * a))
    return cx, cy


def simplify_ring(ring: Ring, tolerance: float) -> Ring:
    """Douglas-Peucker on a closed ring; always returns a closed ring
    with ≥4 points."""
    if tolerance <= 0 or len(ring) <= 4:
        return ring
    pts = ring[:-1]
    # anchor at the two most distant points to stabilise closed-ring DP
    far = int(np.argmax(((pts - pts[0]) ** 2).sum(axis=1)))
    part1 = _dp(np.vstack([pts[:far + 1]]), tolerance)
    part2 = _dp(np.vstack([pts[far:], pts[:1]]), tolerance)
    out = np.vstack([part1[:-1], part2[:-1]])
    if len(out) < 3:
        return ring
    return np.vstack([out, out[:1]])


def _dp(points: np.ndarray, tol: float) -> np.ndarray:
    if len(points) < 3:
        return points
    a, b = points[0], points[-1]
    ab = b - a
    norm = np.hypot(*ab)
    if norm == 0:
        d = np.hypot(*(points - a).T)
    else:
        ap = points - a
        d = np.abs(ab[0] * ap[:, 1] - ab[1] * ap[:, 0]) / norm
    i = int(np.argmax(d))
    if d[i] <= tol:
        return np.vstack([a, b])
    left = _dp(points[:i + 1], tol)
    right = _dp(points[i:], tol)
    return np.vstack([left[:-1], right])


# --- polygons (exterior + holes) ---------------------------------------

class Polygon:
    """Minimal polygon: exterior ring + holes, (x, y) float coords."""

    def __init__(self, exterior: Ring, holes: Optional[List[Ring]] = None):
        self.exterior = np.asarray(exterior, np.float64)
        self.holes = [np.asarray(h, np.float64) for h in (holes or [])]

    @property
    def area(self) -> float:
        return abs(ring_area(self.exterior)) - sum(
            abs(ring_area(h)) for h in self.holes)

    @property
    def length(self) -> float:
        return ring_perimeter(self.exterior) + sum(
            ring_perimeter(h) for h in self.holes)

    @property
    def is_empty(self) -> bool:
        return len(self.exterior) < 4 or abs(ring_area(self.exterior)) < 1e-12

    def simplify(self, tolerance: float) -> "Polygon":
        return Polygon(
            simplify_ring(self.exterior, tolerance),
            [simplify_ring(h, tolerance) for h in self.holes],
        )

    def transform(self, fn) -> "Polygon":
        def apply(ring):
            x, y = fn(ring[:, 0], ring[:, 1])
            return np.stack([np.asarray(x), np.asarray(y)], axis=-1)
        return Polygon(apply(self.exterior), [apply(h) for h in self.holes])

    def contains_point(self, px: float, py: float) -> bool:
        """Inside the exterior AND outside every hole (shapely
        semantics — a point inside an interior ring is NOT contained)."""
        if not _point_in_ring(self.exterior, px, py):
            return False
        return not any(_point_in_ring(h, px, py) for h in self.holes)

    def to_geojson(self) -> dict:
        def coords(ring):
            return [[float(x), float(y)] for x, y in ring]
        return {
            "type": "Polygon",
            "coordinates": [coords(self.exterior)] + [coords(h) for h in self.holes],
        }

    @property
    def wkt(self) -> str:
        def ring_str(ring):
            return "(" + ", ".join(f"{x:g} {y:g}" for x, y in ring) + ")"
        rings = [ring_str(self.exterior)] + [ring_str(h) for h in self.holes]
        return "POLYGON (" + ", ".join(rings) + ")"


def _point_in_ring(ring: Ring, px: float, py: float) -> bool:
    x, y = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    crosses = ((y > py) != (y2 > py)) & (
        px < (x2 - x) * (py - y) / (y2 - y + 1e-300) + x)
    return bool(np.sum(crosses) % 2)


def rings_to_polygons(rings: List[Ring]) -> List[Polygon]:
    """Group traced rings into polygons: image-coord CW rings (area<0 in
    (x, up-y) convention... here: inside-left tracing makes exteriors
    have negative shoelace sign in image coords) vs holes, holes matched
    to the containing exterior."""
    if not rings:
        return []
    # with y-down image coords and inside-on-left walking, exterior
    # rings come out clockwise in (x, y): signed area > 0
    exteriors = [r for r in rings if ring_area(r) > 0]
    holes = [r for r in rings if ring_area(r) <= 0]
    polys = [Polygon(e) for e in exteriors]
    for hole in holes:
        hx, hy = hole[0]
        # assign to the smallest exterior containing the hole's vertex
        candidates = [p for p in polys
                      if _point_in_ring(p.exterior, hx + 1e-9, hy + 1e-9)]
        if candidates:
            smallest = min(candidates, key=lambda p: abs(ring_area(p.exterior)))
            smallest.holes.append(hole)
    return polys


def mask_to_polygons(mask: np.ndarray) -> List[Polygon]:
    """Binary mask → polygons with holes, pixel-corner coords."""
    rings = [_collapse_collinear(r) for r in mask_to_rings(mask)]
    return rings_to_polygons(rings)


def iter_label_masks(labels: np.ndarray):
    """Yield ``(label, bbox_mask, (y0, x0))`` per nonzero label.

    One O(P log P) pass instead of the naive per-label full-image
    compare: at full-res v2 extraction (r5 bench, 16.8 MPix × 1064
    labels) the `labels == v` loop alone was ~17G element ops and
    dominated wall time. Tracing inside each label's bounding box is
    equivalent — `mask_to_polygons` coordinates just need the (x0, y0)
    offset added back.
    """
    ys, xs = np.nonzero(labels)
    if ys.size == 0:
        return
    vals = labels[ys, xs]
    order = np.argsort(vals, kind="stable")
    vals_s, ys_s, xs_s = vals[order], ys[order], xs[order]
    bounds = np.searchsorted(vals_s, np.unique(vals_s))
    bounds = np.append(bounds, vals_s.size)
    for i in range(bounds.size - 1):
        lo, hi = bounds[i], bounds[i + 1]
        label = int(vals_s[lo])
        yy, xx = ys_s[lo:hi], xs_s[lo:hi]
        y0, y1 = int(yy.min()), int(yy.max())
        x0, x1 = int(xx.min()), int(xx.max())
        sub = np.zeros((y1 - y0 + 1, x1 - x0 + 1), bool)
        sub[yy - y0, xx - x0] = True
        yield label, sub, (y0, x0)


# --- rasterisation (scanline) ------------------------------------------

def rasterize_polygon(
    polygon_coords: Sequence[Sequence[Sequence[float]]],
    shape: Tuple[int, int],
    transform_inv,
) -> np.ndarray:
    """GeoJSON polygon coordinates → boolean mask of *shape*.

    ``transform_inv`` maps world (x, y) → pixel (col, row) (use
    ``~geotiff.transform``). Even-odd scanline fill over all rings —
    the rasterio.features.geometry_mask equivalent used by the AOI crop
    (``vector_extraction.py:118-166``).
    """
    h, w = shape
    out = np.zeros((h, w), bool)
    rings_px = []
    for ring in polygon_coords:
        arr = np.asarray(ring, np.float64)
        col, row = transform_inv * (arr[:, 0], arr[:, 1])
        rings_px.append(np.stack([np.asarray(col), np.asarray(row)], axis=-1))

    edges = []
    for ring in rings_px:
        for i in range(len(ring) - 1):
            (x1, y1), (x2, y2) = ring[i], ring[i + 1]
            if y1 != y2:
                edges.append((x1, y1, x2, y2))
    if not edges:
        return out
    edges_arr = np.asarray(edges)
    for row in range(h):
        yc = row + 0.5
        x1, y1, x2, y2 = edges_arr.T
        crosses = (y1 <= yc) != (y2 <= yc)
        if not crosses.any():
            continue
        xs = x1[crosses] + (yc - y1[crosses]) * (
            x2[crosses] - x1[crosses]) / (y2[crosses] - y1[crosses])
        xs = np.sort(xs)
        for i in range(0, len(xs) - 1, 2):
            a = max(int(math.ceil(xs[i] - 0.5)), 0)
            b = min(int(math.floor(xs[i + 1] - 0.5)), w - 1)
            if b >= a:
                out[row, a:b + 1] = True
    return out
