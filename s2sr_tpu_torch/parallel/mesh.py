"""The device-mesh spec of ``Settings.mesh_shape`` (the port's copy of
``s2sr_tpu/parallel/mesh.py::parse_mesh_shape``).

A mesh over more than one device (dp/sp/pp/tp/FSDP on
``torch.distributed``) is not ported yet (ROADMAP queue 1 item 16): the
engine serves a spec whose axes multiply to one device, which JAX serves
identically on one chip, and refuses any other.
"""

from __future__ import annotations

import math
from typing import Tuple


def parse_mesh_shape(spec: str) -> Tuple[Tuple[str, int], ...]:
    """Parse ``"dp=4,sp=2"`` → (("dp", 4), ("sp", 2))."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, n = part.partition("=")
        out.append((name.strip(), int(n)))
    return tuple(out)


def check_single_device(spec: str) -> None:
    """Raise unless ``spec`` is empty or its axes multiply to 1."""
    if spec and math.prod(n for _, n in parse_mesh_shape(spec)) != 1:
        raise ValueError(
            f"mesh_shape {spec!r} spans more than one device: multi-device "
            "serving is not ported yet (ROADMAP queue 1 item 16)")
