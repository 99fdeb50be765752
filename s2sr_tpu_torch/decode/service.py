"""Decode orchestration: QR (+optional OCR) with SR-enhance retry.

Server-side rebuild of the reference client's scan flow
(`client/src/app/enhance/enhance.component.ts:251-359`): try to read
the uploaded photo as-is; when nothing decodes (or the read is
low-quality per :func:`..decode.serial.should_retry_with_enhancement`),
run the image through the Real-ESRGAN engine and try again.

OCR: the reference uses Tesseract.js in the browser. A server
Tesseract is not bundled, so the flow uses the in-repo printed-text
recognizer (:mod:`.ocr` — binarize → connected components → glyph
template matching against the committed DejaVu atlas) whenever
``pytesseract`` is absent; the explicit ``{"available": false}``
marker remains only for a package missing its glyph file.

The port of ``s2sr_tpu/decode/service.py``: the same rules and result
dict; the binarizations of the QR and OCR passes run on ``device``, and
``enhance_fn`` is the caller's (the server binds the card's
``realesrgan_x4`` engine on its runner).
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np

from .qr_decode import QRResult, decode_qr
from .serial import extract_serial, should_retry_with_enhancement

logger = logging.getLogger(__name__)

EnhanceFn = Callable[[np.ndarray], np.ndarray]


def _try_ocr(image: np.ndarray, device="cuda") -> dict:
    try:
        import pytesseract  # type: ignore
        from PIL import Image

        data = pytesseract.image_to_data(
            Image.fromarray(image), output_type=pytesseract.Output.DICT)
        words = [
            {"text": t, "confidence": float(c)}
            for t, c in zip(data["text"], data["conf"])
            if t.strip() and float(c) >= 0
        ]
        text = " ".join(w["text"] for w in words)
        conf = (sum(w["confidence"] for w in words) / len(words)
                if words else 0.0)
        return {"available": True, "text": text, "confidence": conf,
                "words": words, "engine": "tesseract"}
    except ImportError:
        pass
    except Exception as exc:  # noqa: BLE001 — OCR failure is non-fatal
        logger.warning("tesseract OCR failed, using builtin: %s", exc)
    try:
        from .ocr import ocr_image

        return ocr_image(image, device=device)
    except Exception as exc:  # noqa: BLE001
        return {"available": False, "text": "", "confidence": 0.0,
                "words": [], "reason": str(exc)}


def _qr_dict(r: QRResult) -> dict:
    return {
        "text": r.text, "version": r.version, "ec_level": r.ec_level,
        "mask": r.mask, "errors_corrected": r.errors_corrected,
        "inverted": r.inverted, "mirrored": r.mirrored,
        "location": r.location,
    }


def decode_with_retry(image: np.ndarray, *, enhance_fn: EnhanceFn | None = None,
                      try_ocr: bool = True, device="cuda") -> dict:
    """Full scan flow: QR → OCR → serial, with one SR-enhanced retry.

    ``enhance_fn`` maps an (H, W, 3) uint8 image to an upscaled uint8
    image (the server passes the Real-ESRGAN engine); ``None`` disables
    the retry leg. The scans binarize on ``device``.
    """
    image = np.asarray(image)
    attempts: list[dict] = []

    def scan(img: np.ndarray, stage: str) -> dict:
        qr = decode_qr(img, device=device)
        serial = None
        if qr is not None:
            serial = extract_serial(qr.text) or (
                qr.text if qr.text.strip() else None)
        # OCR is the heaviest per-request work on the 1-core box; run it
        # lazily, only when the QR path did not already yield the serial
        # (the reference client returns immediately on jsQR success too,
        # enhance.component.ts:279-288)
        if try_ocr and serial is None:
            ocr = _try_ocr(img, device=device)
        else:
            ocr = {"available": False, "text": "", "confidence": 0.0,
                   "words": [], "reason": (
                       "skipped: QR provided the serial" if serial
                       else "disabled")}
        if serial is None and ocr["available"]:
            serial = extract_serial(ocr["text"], ocr["words"])
        rec = {"stage": stage,
               "qr": _qr_dict(qr) if qr else None,
               "ocr_confidence": ocr["confidence"],
               "ocr_available": ocr["available"],
               "serial": serial}
        attempts.append(rec)
        return {"qr": qr, "ocr": ocr, "serial": serial}

    first = scan(image, "original")
    # A successful QR read returns immediately — the reference client
    # never retries after jsQR succeeds (enhance.component.ts:279-288);
    # the short-serial retry rule applies to OCR-sourced reads only.
    retry = first["qr"] is None and should_retry_with_enhancement(
        first["ocr"]["confidence"], first["serial"])
    # Bound the enhance retry: x4 SR then re-scanning a huge photo can
    # transiently need multi-GB buffers on the 1-core box; plate photos
    # are small. Beyond 4 MPix keep the first-pass answer.
    if retry and image.shape[0] * image.shape[1] > 4_000_000:
        logger.info("decode: skipping SR retry (image > 4 MPix)")
        retry = False

    best = first
    enhanced = False
    if retry and enhance_fn is not None:
        logger.info("decode: retrying with SR enhancement")
        try:
            up = np.asarray(enhance_fn(image))
            enhanced = True
            second = scan(up, "enhanced")
            # the retry may only improve the answer: never prefer a
            # serial-less enhanced pass over a first pass that already
            # extracted a serial (confidence alone doesn't outrank a hit)
            if second["qr"] is not None:
                second_better = True
            elif second["serial"] is not None and first["serial"] is None:
                second_better = True
            elif first["serial"] is not None and second["serial"] is None:
                second_better = False
            else:
                second_better = (second["ocr"]["confidence"]
                                 > first["ocr"]["confidence"])
            if second_better:
                best = second
        except Exception as exc:  # noqa: BLE001 — keep the first-pass answer
            logger.error("decode enhancement retry failed: %s", exc)
            attempts.append({"stage": "enhanced", "error": str(exc)})

    return {
        "qr": _qr_dict(best["qr"]) if best["qr"] else None,
        "serial": best["serial"],
        "ocr": {k: v for k, v in best["ocr"].items() if k != "words"},
        "retried_with_enhancement": enhanced,
        "attempts": attempts,
    }
