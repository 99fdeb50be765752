"""From-scratch printed-text OCR for the plate-scan flow.

The reference runs Tesseract.js in the browser
(``client/src/app/services/qr-ocr.service.ts:113-152``); this image has
no Tesseract binary and installs are not possible, so serial extraction
from non-QR plates needs an in-repo recognizer (VERDICT r2 #3). Scope
is deliberately the reference's actual use case — machine-printed
serial plates (uppercase letters, digits, separators), not handwriting:

1. grayscale → the zxing-style hybrid binarizer already used by the QR
   locator (:func:`.locate.binarize`), both polarities;
2. connected components → character candidate boxes, size-filtered;
3. boxes clustered into text lines by vertical overlap, sorted by x,
   word gaps detected from the inter-character gap distribution;
4. each glyph normalised to a fixed cell and matched by normalised
   cross-correlation against an atlas of DejaVu glyphs (Sans, Mono and
   Serif × regular/bold) — per-character confidence is the correlation
   score.

The port of ``s2sr_tpu/decode/ocr.py``. The JAX package renders its
atlas with PIL at run time; the card's machine has no PIL, so the port
loads the glyphs PIL rendered (the same six faces at 64 px, thresholded
at 96 and cropped tight), committed bit-packed in ``glyphs.npz`` and
written by ``tests/fixtures_torch/make_fixtures.py``, and computes the
templates from them as the JAX package does. Binarization runs on
``device`` (:func:`.locate.binarize`); the rest is host numpy.

Output matches the ``_try_ocr`` dict contract of
:mod:`.service` so the serial extractor and the
SR-enhance retry policy work unchanged.

Accuracy envelope (``scripts/ocr_eval.py``, 10 serial plates per
condition, char accuracy by SequenceMatcher):

- DejaVu Sans 48px (atlas face): 1.00 char / 1.00 exact-string;
- serif faces 48px: 0.95-0.96 char, 0.6-0.8 exact;
- additive noise σ=20 / ±3° rotation: 0.95-0.99 char — robust;
- 20px renders: 0.80 — usable but degraded (cell resampling);
- tiny bitmap fonts (PIL's ~11px default): 0.13 — BELOW the floor.

So: machine-printed plates at plate-photo resolution work; for
arbitrary fonts/sizes in the wild, pytesseract (installed in the
Docker image, ``Dockerfile:11,20``) is the engine of record and this
recognizer is the no-dependency fallback.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

CHARSET = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-"
CELL_H, CELL_W = 24, 18


def _resample_to_cell(patch: np.ndarray) -> np.ndarray:
    """bool ink patch → (CELL_H, CELL_W) float in [0,1], aspect kept."""
    h, w = patch.shape
    scale = min((CELL_H - 2) / h, (CELL_W - 2) / w)
    th = max(1, int(round(h * scale)))
    tw = max(1, int(round(w * scale)))
    ys = np.clip((np.arange(th) + 0.5) * h / th - 0.5, 0, h - 1)
    xs = np.clip((np.arange(tw) + 0.5) * w / tw - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    p = patch.astype(np.float32)
    interp = (p[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
              + p[np.ix_(y1, x0)] * fy * (1 - fx)
              + p[np.ix_(y0, x1)] * (1 - fy) * fx
              + p[np.ix_(y1, x1)] * fy * fx)
    cell = np.zeros((CELL_H, CELL_W), np.float32)
    oy = (CELL_H - th) // 2
    ox = (CELL_W - tw) // 2
    cell[oy:oy + th, ox:ox + tw] = interp
    return cell


def _normalise(cell: np.ndarray) -> np.ndarray:
    v = cell - cell.mean()
    n = np.sqrt((v * v).sum())
    return v / n if n > 1e-6 else v


GLYPHS = Path(__file__).resolve().parent / "glyphs.npz"


def pack_glyphs(patches: list, labels: list) -> dict:
    """Cropped bool glyph patches → the arrays of ``glyphs.npz``: the
    row-major bits of every patch packed end to end, each patch's shape,
    and its label."""
    flat = np.concatenate([np.asarray(p, bool).ravel() for p in patches])
    return {"bits": np.packbits(flat),
            "shapes": np.array([np.shape(p) for p in patches], np.int32),
            "labels": np.array(labels)}


def unpack_glyphs(arrays) -> list:
    """The bool patches of :func:`pack_glyphs`' arrays."""
    shapes = np.asarray(arrays["shapes"])
    sizes = shapes.prod(axis=1)
    flat = np.unpackbits(arrays["bits"], count=int(sizes.sum())).astype(bool)
    ends = np.cumsum(sizes)
    return [flat[e - n:e].reshape(s)
            for e, n, s in zip(ends, sizes, shapes)]


@functools.lru_cache(maxsize=1)
def _atlas():
    """(templates (N, CELL_H·CELL_W), labels (N,)) or None without the
    glyph file."""
    if not GLYPHS.exists():  # pragma: no cover - committed with the package
        return None
    with np.load(GLYPHS) as arrays:
        patches = unpack_glyphs(arrays)
        labels = np.asarray(arrays["labels"])
    if not patches:
        return None
    templates = [_normalise(_resample_to_cell(p)).ravel() for p in patches]
    return np.stack(templates), labels


def available() -> bool:
    return _atlas() is not None


def _components(mask: np.ndarray):
    """Connected components (8-conn) → list of (y0, y1, x0, x1) boxes."""
    from scipy import ndimage

    lab, n = ndimage.label(mask, structure=np.ones((3, 3), int))
    boxes = []
    for sl in ndimage.find_objects(lab):
        if sl is None:
            continue
        boxes.append((sl[0].start, sl[0].stop, sl[1].start, sl[1].stop))
    return lab, boxes


def _group_lines(boxes):
    """Cluster boxes into text lines by vertical-overlap chaining."""
    boxes = sorted(boxes, key=lambda b: (b[0], b[2]))
    lines: list[list] = []
    for b in boxes:
        y0, y1 = b[0], b[1]
        placed = False
        for line in lines:
            ly0 = min(x[0] for x in line)
            ly1 = max(x[1] for x in line)
            inter = min(y1, ly1) - max(y0, ly0)
            if inter > 0.5 * min(y1 - y0, ly1 - ly0):
                line.append(b)
                placed = True
                break
        if not placed:
            lines.append([b])
    lines.sort(key=lambda line: min(b[0] for b in line))
    for line in lines:
        line.sort(key=lambda b: b[2])
    return lines


def _classify(mask: np.ndarray, box, templates, labels):
    y0, y1, x0, x1 = box
    patch = mask[y0:y1, x0:x1]
    cell = _normalise(_resample_to_cell(patch)).ravel()
    scores = templates @ cell
    best = int(np.argmax(scores))
    return labels[best], float(np.clip(scores[best], 0.0, 1.0))


def _scan_polarity(mask: np.ndarray):
    h, w = mask.shape
    _, boxes = _components(mask)
    min_h = max(6, h // 100)

    def keep_tall(b):
        bh, bw = b[1] - b[0], b[3] - b[2]
        return (bh >= min_h and bw <= 3.0 * bh and bw >= 2
                and bh <= 0.9 * h
                and np.count_nonzero(mask[b[0]:b[1], b[2]:b[3]]) >= 8)

    tall = [b for b in boxes if keep_tall(b)]

    def keep_flat(b):
        # wide-flat glyphs (dash/underscore) legitimately sit under the
        # height floor — a 48px-font dash is ~4-6px tall; dropping it
        # silently turned "SN-4821" into the two words "SN 4821"
        # (scripts/ocr_eval.py found 8/10 serials hitting this). Noise
        # specks are roundish, so demand a dash-like aspect (2-8× wider
        # than tall); scan-line/underline FRAGMENTS share that aspect,
        # so additionally require (ADVICE r4) the box's vertical center
        # to sit inside some tall glyph's extent (dashes ride mid-line;
        # underlines hang below the baseline) and near-solid ink (a
        # printed dash is a filled bar, streak fragments are sparse).
        bh, bw = b[1] - b[0], b[3] - b[2]
        if not (bh < min_h and 2 * bh <= bw <= 8 * bh
                and bw >= 6 and bh >= 2):
            return False
        cy = 0.5 * (b[0] + b[1])
        if not any(t[0] <= cy <= t[1] for t in tall):
            return False
        ink = np.count_nonzero(mask[b[0]:b[1], b[2]:b[3]])
        return ink >= 8 and ink >= 0.6 * bh * bw

    boxes = tall + [b for b in boxes if keep_flat(b)]
    if not boxes:
        return [], 0.0
    atlas = _atlas()
    if atlas is None:
        return [], 0.0
    templates, labels = atlas
    words = []
    for line in _group_lines(boxes):
        if len(line) < 2:        # single isolated blobs: likely noise
            continue
        heights = [b[1] - b[0] for b in line]
        med_h = float(np.median(heights))
        # keep wide-flat boxes (dashes) that fail the height floor
        line = [b for b in line
                if (b[1] - b[0]) > 0.35 * med_h
                or (b[3] - b[2]) >= 1.3 * (b[1] - b[0])]
        if len(line) < 2:
            continue
        gaps = [line[i + 1][2] - line[i][3] for i in range(len(line) - 1)]
        widths = [b[3] - b[2] for b in line]
        space_at = float(np.median(widths)) * 0.55
        chars = []
        confs = []
        text = ""
        for i, b in enumerate(line):
            ch, conf = _classify(mask, b, templates, labels)
            text += ch
            confs.append(conf)
            if i < len(gaps) and gaps[i] > space_at:
                chars.append((text, confs))
                text, confs = "", []
        if text:
            chars.append((text, confs))
        for text, confs in chars:
            if not text:
                continue
            words.append({"text": text,
                          "confidence": float(np.mean(confs) * 100.0)})
    mean_conf = (float(np.mean([w["confidence"] for w in words]))
                 if words else 0.0)
    return words, mean_conf


def ocr_image(image: np.ndarray, device="cuda") -> dict:
    """uint8 H×W[×3] image → ``{"available", "text", "confidence",
    "words"}`` (the service/_try_ocr contract); binarization on
    ``device``."""
    if not available():
        return {"available": False, "text": "", "confidence": 0.0,
                "words": [], "reason": "glyph atlas unavailable (no glyph file)"}
    from .locate import binarize

    img = np.asarray(image)
    if img.ndim == 3:
        img = (img[..., :3].astype(np.float32)
               @ np.array([0.299, 0.587, 0.114], np.float32))
    else:
        img = img.astype(np.float32)
    # 3×3 box smoothing: sensor noise otherwise exceeds the hybrid
    # binarizer's per-block contrast floor and speckles flat regions
    p = np.pad(img, 1, mode="edge")
    img = sum(p[dy:dy + img.shape[0], dx:dx + img.shape[1]]
              for dy in range(3) for dx in range(3)) / 9.0

    # edge-replicate bucket padding: a white pad would inject a false
    # edge into the boundary blocks on dark-background plates
    dark = binarize(img.astype(np.uint8), pad_mode="edge",
                    device=device)  # True where ink
    best_words: list = []
    best_conf = 0.0
    best_score = -1.0
    for mask in (dark, ~dark):
        words, conf = _scan_polarity(mask)
        # confidence-weighted character count: background-junk
        # components in the wrong polarity fragment into many words but
        # match templates poorly
        score = sum(len(w["text"]) * w["confidence"] for w in words)
        if score > best_score:
            best_words, best_conf, best_score = words, conf, score
    text = " ".join(w["text"] for w in best_words)
    return {"available": True, "text": text, "confidence": best_conf,
            "words": best_words, "engine": "s2sr-builtin"}
