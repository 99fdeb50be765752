"""QR decode/encode + serial extraction: the port of the JAX package's
``decode/`` (the server-side rebuild of the reference client's QR/OCR
flow, ``client/src/app/services/qr-ocr.service.ts``).

The adaptive binarizer runs in torch on the card (:mod:`.locate`), the
bit-level work (finder patterns, perspective sampling, Reed-Solomon
correction, segment parsing) and the OCR's matching are host numpy, and
the retry-with-SR-enhancement policy drives the port's Real-ESRGAN
engine (:mod:`.service`).
"""

from .qr_decode import decode_qr
from .qr_encode import encode_qr
from .serial import extract_serial, should_retry_with_enhancement
from .service import decode_with_retry

__all__ = [
    "decode_qr",
    "decode_with_retry",
    "encode_qr",
    "extract_serial",
    "should_retry_with_enhancement",
]
