"""SPMD ranks over ``torch.distributed``: the port's stand-in for what
GSPMD and ``shard_map`` do in the JAX package.

- :func:`launch` starts one rank per mesh device with the **spawn**
  method (fork is unsafe once CUDA is initialised), each in a process
  group met through a ``file://`` rendezvous in a temporary directory, and
  returns every rank's result. The backend is an explicit argument:
  ``"nccl"`` (one rank per GPU; more ranks than GPUs raise) or ``"gloo"``
  (the CPU, or ranks that share a GPU). A rank that raises or dies fails
  the launch with its traceback, and the launch has a deadline. The
  kernels are built in the launching process before any rank starts, so
  ranks never race on the build directory.
- :func:`rank_mesh` is a rank's view of a mesh: its coordinates, its
  device and one process group per axis (the ranks that differ from it
  along that axis only).
- The collectives the port needs, autograd-aware where a gradient
  crosses them: :func:`all_gather_cat` (backward: a reduce-scatter of the
  sum), :func:`all_reduce_sum` (backward: the same all-reduce),
  :func:`ring_shift` (backward: the reverse shift),
  :func:`halo_exchange` (the ``sp`` bands' halo rows; backward: the
  halo's gradient added into the sender's edge rows), and
  :func:`all_reduce_mean` for gradients after the backward.

gloo has CUDA support for only some collectives, so under gloo every
CUDA tensor is staged through pinned host memory here, and nowhere else
(:func:`_host`).
"""

from __future__ import annotations

import itertools
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..utils import setup_logging
from .mesh import Mesh

logger = setup_logging("s2sr_tpu_torch.comm")

BACKENDS = ("nccl", "gloo")


def check_backend(devices: Sequence[torch.device], backend: str) -> None:
    """Raise unless ``backend`` can run one rank on each of ``devices``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "nccl":
        return
    if any(d.type != "cuda" for d in devices):
        raise ValueError("nccl runs on CUDA devices only; pass --backend gloo "
                         "(backend='gloo') for ranks on the CPU")
    gpus = {(d.index or 0) for d in devices}
    if len(gpus) < len(devices):
        raise ValueError(
            f"nccl runs one rank per GPU: {len(devices)} ranks on "
            f"{len(gpus)} GPU(s); pass --backend gloo (backend='gloo') for "
            "ranks that share a GPU")


def _rank_entry(rank, world, init, backend, devices, collective_timeout, fn,
                args, results):
    """One rank: join the group, run ``fn(rank, *args)``, report."""
    try:
        dev = devices[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank,
                                timeout=timedelta(seconds=collective_timeout))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:                      # reported to the launcher
        results.put((rank, False, traceback.format_exc()))


def launch(fn, mesh: Mesh, args: tuple = (), backend: str = "gloo",
           timeout: Optional[float] = 120.0) -> list:
    """Run ``fn(rank, *args)`` in one spawned process per device of
    ``mesh`` (rank i on ``mesh.devices[i]``), in one process group →
    the ranks' results, by rank. ``fn`` and its results must pickle, and
    a script that launches must guard its main (the ranks import it
    again). Raises with the first failing rank's traceback, or
    ``TimeoutError`` when ``timeout`` seconds pass first (None: a run of
    any length, as training's); every rank is stopped either way. A
    collective that waits ``timeout`` seconds (600 without one) fails its
    rank."""
    check_backend(mesh.devices, backend)
    world = mesh.size
    if any(d.type == "cuda" for d in mesh.devices):
        from ..ops._build import build_all

        build_all()                        # once, before any rank starts
    logger.info("launch: backend %s, world %d, devices %s", backend, world,
                ",".join(str(d) for d in mesh.devices))
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="s2sr_dist_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True, args=(
        r, world, f"file://{os.path.join(tmp, 'rendezvous')}", backend,
        mesh.devices, timeout or 600.0, fn, args, results))
        for r in range(world)]
    out: dict = {}
    deadline = time.monotonic() + (timeout or float("inf"))
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} died (exit code "
                        f"{procs[dead[0]].exitcode}) without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} gave "
                        f"no result within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, min(60.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]


# --- a rank's view of the mesh -------------------------------------------

@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the global ranks along it (in
    coordinate order), this rank's coordinate, and their process group
    (None for an axis of one rank)."""

    name: str
    ranks: tuple
    index: int
    group: object = None
    stage: bool = False      # gloo with a CUDA device: host staging

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True)
class RankMesh:
    """This rank's axes of a mesh, and the axis of every rank."""

    rank: int
    axes: dict
    world: Axis

    def axis(self, name: str) -> Axis:
        """Axis ``name``, or a one-rank axis when the mesh lacks it."""
        return self.axes.get(name) or Axis(name, (self.rank,), 0)


_RANK_MESHES: dict = {}


def rank_mesh(mesh: Mesh) -> RankMesh:
    """This rank's view of ``mesh`` (cached per mesh; the first call is
    collective: every rank creates every axis group in the same order)."""
    key = mesh.key()
    if key in _RANK_MESHES:
        return _RANK_MESHES[key]
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {mesh.size} devices runs one rank per device: start "
            "them with parallel.comm.launch (cli.train --mesh does)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != mesh.size:
        raise ValueError(f"mesh of {mesh.size} devices in a world of "
                         f"{world} ranks")
    stage = (dist.get_backend() == "gloo"
             and mesh.devices[rank].type == "cuda")
    axes = {}
    for name, size in zip(mesh.axis_names, mesh.shape):
        others = [n for n in mesh.axis_names if n != name]
        for combo in itertools.product(*(range(mesh.axis_size(o))
                                         for o in others)):
            at = dict(zip(others, combo))
            ranks = tuple(mesh.rank_of({**at, name: i}) for i in range(size))
            group = dist.new_group(list(ranks)) if size > 1 else None
            if rank in ranks:
                axes[name] = Axis(name, ranks, ranks.index(rank), group,
                                  stage)
    rm = RankMesh(rank, axes,
                  Axis("world", tuple(range(world)), rank,
                       dist.group.WORLD if world > 1 else None, stage))
    _RANK_MESHES[key] = rm
    return rm


def axis_of(rm: Optional[RankMesh], name: str) -> Axis:
    """Axis ``name`` of ``rm``; a one-rank axis without a rank mesh."""
    return rm.axis(name) if rm is not None else Axis(name, (0,), 0)


def for_mesh(mesh: Optional[Mesh]) -> Optional[RankMesh]:
    """None for no mesh or a one-device mesh (nothing to communicate),
    else :func:`rank_mesh`."""
    if mesh is None or mesh.size == 1:
        return None
    return rank_mesh(mesh)


# --- collectives ---------------------------------------------------------

def _host(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``t`` as the collective sees it: staged into pinned host memory
    under gloo for a CUDA tensor, else itself (contiguous)."""
    t = t.contiguous()
    if not (axis.stage and t.is_cuda):
        return t
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def _all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, a new tensor on ``t``'s device;
    half types are summed in float32 (gloo sums no half type)."""
    if axis.size == 1:
        return t.clone()
    half = t.dtype in (torch.bfloat16, torch.float16)
    buf = _host(t.float() if half else t, axis)
    if buf is t:
        buf = t.clone()
    dist.all_reduce(buf, group=axis.group)
    return buf.to(t.device, t.dtype)


def _all_gather(t: torch.Tensor, axis: Axis) -> list:
    """Every rank's ``t`` along ``axis``, in coordinate order."""
    buf = _host(t, axis)
    parts = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(parts, buf, group=axis.group)
    return [p.to(t.device) for p in parts]


def all_reduce_mean(tensors: list, axis: Axis, mean: bool = True) -> list:
    """The mean (or with ``mean=False`` the sum) over ``axis`` of each
    tensor of ``tensors``, in one collective (no autograd: for gradients
    after the backward)."""
    if axis.size == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    flat = _all_reduce(flat, axis)
    if mean:
        flat = flat / axis.size
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (JAX's ``psum``); its gradient is
    the same sum of the gradients."""
    return x if axis.size == 1 else _AllReduceSum.apply(x, axis)


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dim, *shards):
        ctx.axis, ctx.dim = axis, dim
        ctx.shapes = [s.shape for s in shards]
        flat = torch.cat([s.reshape(-1) for s in shards])
        parts = _all_gather(flat, axis)
        outs, off = [], 0
        for s in shards:
            n = s.numel()
            outs.append(torch.cat([p[off:off + n].view(s.shape)
                                   for p in parts], dim))
            off += n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        axis, dim = ctx.axis, ctx.dim
        rows = torch.stack([
            torch.cat([g.chunk(axis.size, dim)[j].reshape(-1) for g in grads])
            for j in range(axis.size)])
        # a reduce-scatter as an all-reduce and this rank's row: gloo's
        # reduce-scatter differs between releases
        mine = _all_reduce(rows, axis)[axis.index]
        out, off = [], 0
        for shape in ctx.shapes:
            n = shape.numel()
            out.append(mine[off:off + n].view(shape))
            off += n
        return (None, None, *out)


def all_gather_cat(tensors: list, axis: Axis, dim: int = -1) -> list:
    """Each tensor's slices from every rank along ``axis``, concatenated
    on ``dim`` in coordinate order (JAX's tiled ``all_gather``), in one
    collective; the gradient of each slice is the sum over ``axis`` of its
    part of the gathered gradient (a reduce-scatter)."""
    if axis.size == 1 or not tensors:
        return list(tensors)
    return list(_GatherCat.apply(axis, dim, *tensors))


def _shift(x: torch.Tensor, axis: Axis, step: int) -> torch.Tensor:
    n = axis.size
    dst = axis.ranks[(axis.index + step) % n]
    src = axis.ranks[(axis.index - step) % n]
    send = _host(x, axis)
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst),
                                   dist.P2POp(dist.irecv, recv, src)])
    for r in reqs:
        r.wait()
    return recv.to(x.device)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, step):
        ctx.axis, ctx.step = axis, step
        return _shift(x, axis, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -ctx.step), None, None


def ring_shift(x: torch.Tensor, axis: Axis, step: int = 1) -> torch.Tensor:
    """Coordinate i's ``x`` at coordinate i+step (mod the axis size): JAX's
    ``ppermute`` over the ring. The gradient travels back, i+step → i."""
    return x if axis.size == 1 else _RingShift.apply(x, axis, step)


def _trade(sends: dict, recvs: dict, axis: Axis) -> dict:
    """Point-to-point over ``axis``: ``sends[c]`` to coordinate c, into
    ``recvs[c]`` (shaped like what c sends) from coordinate c → the
    received tensors on each one's device, by coordinate."""
    ops, bufs = [], {}
    for c, t in sends.items():
        ops.append(dist.P2POp(dist.isend, _host(t, axis), axis.ranks[c]))
    for c, like in recvs.items():
        bufs[c] = torch.empty_like(_host(like, axis))
        ops.append(dist.P2POp(dist.irecv, bufs[c], axis.ranks[c]))
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    return {c: b.to(recvs[c].device) for c, b in bufs.items()}


def _edges(x: torch.Tensor, k: int, dim: int) -> tuple:
    n = x.shape[dim]
    return x.narrow(dim, 0, k), x.narrow(dim, n - k, k)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, axis, dim):
        ctx.k, ctx.axis, ctx.dim = k, axis, dim
        i, n = axis.index, axis.size
        first, last = _edges(x, k, dim)
        sends, recvs = {}, {}
        if i > 0:
            sends[i - 1], recvs[i - 1] = first, last
        if i < n - 1:
            sends[i + 1], recvs[i + 1] = last, first
        got = _trade(sends, recvs, axis)
        zero = torch.zeros_like(first)
        return torch.cat([got.get(i - 1, zero), x, got.get(i + 1, zero)],
                         dim)

    @staticmethod
    def backward(ctx, g):
        k, axis, dim = ctx.k, ctx.axis, ctx.dim
        i, n = axis.index, axis.size
        rows = g.shape[dim] - 2 * k
        g_top, g_mid, g_bot = (g.narrow(dim, 0, k), g.narrow(dim, k, rows),
                               g.narrow(dim, k + rows, k))
        sends, recvs = {}, {}
        if i > 0:
            sends[i - 1], recvs[i - 1] = g_top, g_top
        if i < n - 1:
            sends[i + 1], recvs[i + 1] = g_bot, g_bot
        got = _trade(sends, recvs, axis)
        out = g_mid.clone()
        if i > 0:
            out.narrow(dim, 0, k).add_(got[i - 1])
        if i < n - 1:
            out.narrow(dim, rows - k, k).add_(got[i + 1])
        return out, None, None, None


def halo_exchange(x: torch.Tensor, k: int, axis: Axis,
                  dim: int = 1) -> torch.Tensor:
    """This rank's band ``x`` with ``k`` rows of each ``axis`` neighbour
    along ``dim``: the last ``k`` rows of the band above, then ``x``, then
    the first ``k`` of the band below. A band at the image's edge gets
    ``k`` zero rows there, the zero padding of a SAME conv, so a conv with
    no padding along ``dim`` gives the band's rows of the whole image's
    conv. The gradient of the received rows is sent back and added into
    the sender's edge rows. Every band needs at least ``k`` rows; with one
    band this is zero padding."""
    if x.shape[dim] < k:
        raise ValueError(f"a band of {x.shape[dim]} rows cannot send a "
                         f"{k}-row halo")
    return _HaloExchange.apply(x, k, axis, dim)


@dataclass(frozen=True)
class Band:
    """This rank's band of H: rows ``[start, stop)`` of ``height``, one of
    the bands of ``axis`` (``sp``)."""

    axis: Axis
    start: int
    stop: int
    height: int

    def scaled(self, s: int) -> "Band":
        """The same band at ``s`` times the resolution."""
        return Band(self.axis, self.start * s, self.stop * s, self.height * s)


def band_of(h: int, axis: Axis, unit: int = 1) -> Band:
    """This rank's band of ``h`` rows along ``axis``
    (``parallel/spatial.py::band_bounds``)."""
    from .spatial import band_bounds

    start, stop = band_bounds(h, axis.size, unit)[axis.index]
    return Band(axis, start, stop, h)


def global_mean(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The mean of every element of ``t`` over every rank of ``axis``
    (bands of unequal size weighted by their elements), on every rank;
    its gradient reaches each rank's elements through the sum's
    all-reduce. ``t.mean()`` without an axis."""
    if axis is None or axis.size == 1:
        return t.mean()
    count = _all_reduce(torch.tensor(float(t.numel()), device=t.device),
                        axis)
    return all_reduce_sum(t.sum(), axis) / count
