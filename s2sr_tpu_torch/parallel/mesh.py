"""The device-mesh spec of ``Settings.mesh_shape`` and ``--mesh`` (the
port of ``s2sr_tpu/parallel/mesh.py::parse_mesh_shape`` and
``build_mesh``).

A mesh over more than one device (dp/sp/pp/tp/FSDP on
``torch.distributed``) is not ported yet (ROADMAP queue 1 item 16): the
engine and the trainer take a spec whose axes multiply to one device,
which JAX runs identically on one chip, and refuse any other.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch


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


@dataclass(frozen=True)
class Mesh:
    """A mesh of one device: its axis names and sizes (all 1)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device


def build_mesh(spec: str = "", device="cuda") -> Mesh:
    """The one-device mesh of ``spec`` (empty: ``dp=1``) on ``device``;
    a spec over more than one device raises."""
    check_single_device(spec)
    axes = parse_mesh_shape(spec) or (("dp", 1),)
    return Mesh(tuple(n for n, _ in axes), tuple(k for _, k in axes),
                torch.device(device))
