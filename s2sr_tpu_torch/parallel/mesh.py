"""The device mesh of ``Settings.mesh_shape`` and ``--mesh`` (the port of
``s2sr_tpu/parallel/mesh.py``).

A :class:`Mesh` names its axes, their sizes and one ``torch.device`` per
grid point, row-major:

- ``dp`` — the data axis: halo windows in serving, the batch in training;
- ``pp`` — the pipeline axis: stages of the RRDB trunk
  (``parallel/pipeline.py``);
- ``tp`` — the tensor axis: weights and Adam moments stored in slices of
  their last dim (``parallel/tensor.py``);
- ``sp`` — the spatial split of H inside a serving window or a training
  crop: each device holds one band of rows and exchanges halo rows with
  the bands above and below before every conv or block that reaches
  across the band's edge (``parallel/spatial.py``, the port's stand-in
  for GSPMD's conv halos).

Serving runs one process with one model replica per ``dp`` group; a group
is the ``sp`` devices of one ``dp`` coordinate (:meth:`Mesh.sp_group`),
one band each (``parallel/tiling.py``, ``models/engine.py``). Training
runs one ``torch.distributed`` rank per mesh device (``parallel/comm.py``);
a rank's ``sp`` coordinate (``comm.rank_mesh(mesh).axis("sp").index``)
is its band. A mesh may name one device more than once: ranks, replicas
or bands that share one card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

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


@dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes, and the devices of the grid, row-major."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} and shape {self.shape}")
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"mesh {self.shape} needs {math.prod(self.shape)}"
                             f" devices, got {len(self.devices)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first device: where a serving mesh stitches and runs whole
        images below the engage area."""
        return self.devices[0]

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; 1 for an axis the mesh lacks."""
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def rank_of(self, coords: dict) -> int:
        """The row-major index of ``coords`` (missing axes at 0)."""
        rank = 0
        for name, n in zip(self.axis_names, self.shape):
            rank = rank * n + coords.get(name, 0)
        return rank

    def axis_devices(self, name: str = "dp") -> Tuple[torch.device, ...]:
        """The devices along axis ``name`` with every other coordinate 0:
        one per ``dp`` replica of a serving mesh."""
        return tuple(self.devices[self.rank_of({name: i})]
                     for i in range(self.axis_size(name)))

    def sp_group(self, dp: int = 0) -> Tuple[torch.device, ...]:
        """The devices of ``dp`` replica ``dp``'s ``sp`` group, one per band
        from the top of H down (every other coordinate 0)."""
        return tuple(self.devices[self.rank_of({"dp": dp, "sp": j})]
                     for j in range(self.axis_size("sp")))

    def key(self) -> tuple:
        """Structural identity (axes, sizes, devices), for caches."""
        return (self.axis_names, self.shape,
                tuple(str(d) for d in self.devices))


def build_mesh(spec: str = "", devices: Optional[Sequence] = None,
               device="cuda") -> Mesh:
    """The mesh of ``spec`` (empty: every device on ``dp``). ``devices``
    defaults to the visible GPUs for ``device="cuda"`` (a spec that needs
    more raises, as JAX's does) and to ``"cpu"`` named as often as the
    spec needs for ``device="cpu"``. An explicit list may name one device
    more than once."""
    axes = parse_mesh_shape(spec)
    total = math.prod(n for _, n in axes) if axes else None
    if devices is None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available; pass device='cpu' "
                                   "to build a mesh on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev] * (total or 1)
    devices = [torch.device(d) for d in devices]
    if not axes:
        axes = (("dp", len(devices)),)
        total = len(devices)
    if total > len(devices):
        raise ValueError(f"mesh {spec} needs {total} devices, have "
                         f"{len(devices)}")
    return Mesh(tuple(n for n, _ in axes), tuple(k for _, k in axes),
                tuple(devices[:total]))


@dataclass(frozen=True)
class Sharding:
    """How an array splits over ``mesh``: ``spec[i]`` names the axis that
    splits dim i, or None (JAX's ``PartitionSpec`` entries); an empty spec
    replicates."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def window_sharding(mesh: Optional[Mesh]) -> Optional[Sharding]:
    """A (N, h, w, C) window batch: N over dp, H over sp."""
    if mesh is None:
        return None
    return Sharding(mesh, ("dp" if "dp" in mesh.axis_names else None,
                           "sp" if "sp" in mesh.axis_names else None,
                           None, None))


def replicated(mesh: Optional[Mesh]) -> Optional[Sharding]:
    if mesh is None:
        return None
    return Sharding(mesh, ())
