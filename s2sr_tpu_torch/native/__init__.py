"""Native (C++) host components, loaded with ``ctypes``: the PNG tile
encoder ``pngenc.cc`` (the JAX package's ``s2sr_tpu/native``).

:func:`load` builds it on first use through the port's build cache
(``ops/_build.py::build_host``: ``g++``, keyed by the source's hash, into
the git-ignored build directory, never into this package): against
libpng and zlib, or, where libpng does not build, against zlib alone
(the same chunks; ``s2sr_png_backend()`` says which). Every consumer has
a pure-Python fallback; :func:`png_encoder` says which encoder runs and,
for the pure one, why the native one did not load (``/api/runtime``
reports it).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "pngenc.cc"
# libpng + zlib first; then zlib alone (a machine without libpng's headers)
FLAG_SETS = (("-lpng", "-lz"), ("-DS2SR_PNG_ZLIB_ONLY", "-lz"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_attempted = False
_error = ""


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on demand; None if it does not
    build or load (the reason: :func:`png_encoder`)."""
    global _lib, _attempted, _error
    with _lock:
        if _attempted:
            return _lib
        _attempted = True
        from ..ops._build import build_host

        errors = []
        for flags in FLAG_SETS:
            try:
                lib = ctypes.CDLL(str(build_host(SOURCE, flags)))
            except (RuntimeError, OSError) as exc:
                errors.append(f"{' '.join(flags)}: {exc}")
                continue
            lib.s2sr_png_encode.restype = ctypes.c_int
            lib.s2sr_png_encode.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.s2sr_png_backend.restype = ctypes.c_char_p
            lib.s2sr_png_backend.argtypes = []
            _lib = lib
            break
        _error = "\n".join(errors)
        return _lib


def png_encoder() -> dict:
    """``{"png_encoder": "native" | "pure", "png_encoder_reason": ...}``:
    the native encoder's backend (libpng or zlib) and the builds that
    failed before it, or why it did not load."""
    lib = load()
    if lib is None:
        return {"png_encoder": "pure",
                "png_encoder_reason":
                f"native encoder did not build or load: {_error}"}
    backend = lib.s2sr_png_backend().decode()
    reason = f"built from {SOURCE.name} against {backend}"
    if _error:
        reason += f" (after: {_error})"
    return {"png_encoder": "native", "png_encoder_reason": reason}
