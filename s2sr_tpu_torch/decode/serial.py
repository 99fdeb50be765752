"""VIN/serial extraction + enhance-retry policy.

Behavioral port of the reference client's text post-processing
(`client/src/app/services/qr-ocr.service.ts:161-284`): normalize OCR
text, regex out serial candidates, score by length/charset/word
confidence, and decide whether a low-quality read warrants an
SR-enhanced retry. These rules ARE the spec (plate-reading policy), so
the constants match the reference.

A copy of the JAX package's ``decode/serial.py`` (the port imports
nothing of that package).
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass
class SerialCandidate:
    text: str
    confidence: float
    length: int


SERIAL_RE = re.compile(r"[A-Z0-9][A-Z0-9-]{8,18}[A-Z0-9]")
ALNUM_RE = re.compile(r"[A-Z0-9]{10,20}")


def extract_serial(text: str,
                   words: list[dict] | None = None) -> str | None:
    """Best serial/PIN candidate from raw OCR text, or ``None``.

    ``words`` entries are ``{"text": str, "confidence": float}`` like
    Tesseract word output; used for a small confidence boost.
    """
    normalized = re.sub(r"\s+", " ",
                        re.sub(r"[^A-Z0-9\s\n-]", "",
                               text.upper())).strip()

    matches = SERIAL_RE.findall(normalized)
    alpha_matches = ALNUM_RE.findall(normalized.replace("-", ""))
    candidates = list(dict.fromkeys(matches + alpha_matches))
    if not candidates:
        return None

    scored: list[SerialCandidate] = []
    for cand in candidates:
        clean = cand.replace("-", "")
        n = len(clean)
        score = 0.0
        if 14 <= n <= 17:          # VIN-length sweet spot
            score += 50
        elif 10 <= n <= 20:
            score += 30
        has_letters = bool(re.search(r"[A-Z]", clean))
        has_numbers = bool(re.search(r"[0-9]", clean))
        if has_letters and has_numbers:
            score += 20
        if clean.isdigit():        # dates / plain numbers
            score -= 20
        if words:
            matching = [w for w in words
                        if cand in w["text"].upper()
                        or w["text"].upper() in cand]
            if matching:
                avg = sum(w["confidence"] for w in matching) / len(matching)
                score += avg / 10
        scored.append(SerialCandidate(cand, score, n))

    scored.sort(key=lambda c: -c.confidence)
    return scored[0].text if scored else None


def should_retry_with_enhancement(confidence: float,
                                  serial: str | None) -> bool:
    """Reference retry policy (`qr-ocr.service.ts:261-284`): retry when
    no serial found, OCR confidence < 60, or the serial is < 10 chars
    after removing hyphens."""
    if serial is None:
        return True
    if confidence < 60:
        return True
    if len(serial.replace("-", "")) < 10:
        return True
    return False
