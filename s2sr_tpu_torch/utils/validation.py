"""Request and settings validation without pydantic.

The JAX package validates request bodies and settings with pydantic v2
models in lax mode; the card's machine has no pydantic. Here a model is
a plain dataclass whose annotations name ``int``, ``float``, ``bool``,
``str`` or ``Optional[...]`` of one of them, and :func:`parse` fills it
from a dict with pydantic v2's lax coercions for those types:

- int: ints; bools (as 0/1); finite floats without a fractional part
  inside int64; strings of ASCII digits after ``strip()``, with an
  optional sign, single underscores between digits and an all-zero
  fraction (``"4.0"``);
- float: ints, bools, floats, and strings ``float()`` parses;
- bool: bools; the ints and floats 0 and 1; the strings 0, off, f,
  false, n, no and 1, on, t, true, y, yes in any case, unstripped;
- str: strings only;
- ``None`` only where the annotation is ``Optional``.

Keys the model does not declare are ignored. A failure raises
:class:`ValidationError`, whose text names every field at fault.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

_INT_STR = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")
_TRUE = frozenset(("1", "on", "t", "true", "y", "yes"))
_FALSE = frozenset(("0", "off", "f", "false", "n", "no"))
_INT64 = 2 ** 63


class ValidationError(ValueError):
    """Coercion failures of one model: ``errors`` holds (field, message,
    value) triples; the text has pydantic's layout."""

    def __init__(self, model: str, errors: list):
        self.errors = errors
        plural = "s" if len(errors) > 1 else ""
        lines = [f"{len(errors)} validation error{plural} for {model}"]
        for name, message, value in errors:
            lines += [name, f"  {message} [input_value={value!r}, "
                            f"input_type={type(value).__name__}]"]
        super().__init__("\n".join(lines))


def _to_int(v):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValueError("Input should be a finite number")
        if v % 1:
            raise ValueError("Input should be a valid integer, got a number "
                             "with a fractional part")
        if not -_INT64 <= v < _INT64:
            raise ValueError("Unable to parse input string as an integer, "
                             "exceeded maximum size")
        return int(v)
    if isinstance(v, str):
        s = v.strip()
        if not _INT_STR.fullmatch(s):
            raise ValueError("Input should be a valid integer, unable to "
                             "parse string as an integer")
        return int(s.partition(".")[0])
    raise ValueError("Input should be a valid integer")


def _to_float(v):
    if isinstance(v, (bool, int, float)):
        try:
            return float(v)
        except OverflowError:
            raise ValueError("Input should be a valid number") from None
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            raise ValueError("Input should be a valid number, unable to "
                             "parse string as a number") from None
    raise ValueError("Input should be a valid number")


def _to_bool(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _TRUE | _FALSE:
        return v.lower() in _TRUE
    if isinstance(v, float):
        raise ValueError("Input should be a valid boolean")
    raise ValueError("Input should be a valid boolean, unable to interpret "
                     "input")


def _to_str(v):
    if isinstance(v, str):
        return v
    raise ValueError("Input should be a valid string")


_COERCE = {"int": _to_int, "float": _to_float, "bool": _to_bool,
           "str": _to_str}


def coerce(kind: str, value):
    """``value`` as the annotation ``kind`` names (``"int"``,
    ``"Optional[str]"``, ...); ValueError with pydantic's message."""
    if kind.startswith("Optional[") and kind.endswith("]"):
        if value is None:
            return None
        kind = kind[len("Optional["):-1]
    return _COERCE[kind](value)


def parse(cls, data: dict):
    """An instance of the dataclass ``cls`` from ``data``'s declared keys."""
    values, errors = {}, []
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        try:
            values[f.name] = coerce(f.type, data[f.name])
        except ValueError as exc:
            errors.append((f.name, str(exc), data[f.name]))
    if errors:
        raise ValidationError(cls.__name__, errors)
    return cls(**values)


@dataclasses.dataclass
class VectorRequest:
    """``POST /api/vectors``: the JAX server's pydantic model, same
    fields, defaults and lax coercions (through :func:`parse`)."""

    aoi_path: Optional[str] = None
    raster_path: Optional[str] = None
    ndvi_threshold: float = 0.3
    min_area_ha: float = 0.1
    max_area_ha: float = 500.0
    simplify_tolerance_m: float = 5.0
