"""GPipe pipelining of the RRDB trunk over a ``pp`` mesh axis (the port
of ``s2sr_tpu/parallel/pipeline.py``).

The trunk's blocks split into contiguous stages, one per ``pp`` rank,
and microbatches stream through JAX's fill/steady/drain schedule: on
every tick each rank ring-shifts its last output one stage on
(``comm.ring_shift``, JAX's ``ppermute``), stage 0 takes the next
microbatch instead, every stage runs its blocks, and the last stage
keeps the microbatch that finishes. Every rank computes on every tick
and issues the same collectives in the same order, forward and backward
(the backward of each shift sends the gradient one stage back), so the
ranks cannot wait on each other out of turn. A final sum over ``pp``
replicates the last stage's buffer.

- ``dp`` splits each microbatch's batch; the ``pp`` ring stays within a
  ``dp`` slice, and the slices are gathered at the end.
- ``sp`` replicates the batch, as JAX's ``shard_map`` does
  (``pipeline.py:180``: microbatches over ``dp`` alone): the ranks of one
  ``sp`` group compute the same stage on the whole of H.
- ``tp``: :func:`shard_stage` stores a rank's stage as its slice of each
  weight's output channels, 1/|tp| of the stage; given such a stage, the
  trunk all-gathers it over ``tp`` once per call. Given the whole body, a
  rank uses its stage's blocks as they are and ``tp`` replicates.
- A ragged block count (23 is prime) pads the stage stacks with zeros
  and masks the padded slots by position: a zero-weight RRDB is not an
  identity (its residual is ``x·0.2 + x``), so a padded slot is skipped.

The blocks are ``models/rrdbnet.py``'s trainable ``_rrdb_block``, so a
stage is the sequential trunk's arithmetic on its blocks. Under
``torch.no_grad()`` on CUDA (the serving forward) each residual dense
block runs the fused ``rdb`` kernel instead, as the engine's do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.rrdbnet import _oihw, _pack_body, _rrdb_block, rrdbnet_apply
from ..models.weights import tree_flatten, tree_map, tree_unflatten
from ..ops.rdb import pack_rdb_weights, rdb
from . import comm
from .mesh import Mesh
from .tensor import local_slice


def _pad_body_to_stages(body_params, num_stages: int):
    """Pad the stacked block axis to a multiple of ``num_stages`` and
    reshape it to a leading stage axis: every leaf (nb, ...) →
    (num_stages, nb_pad // num_stages, ...). Returns ``(staged,
    counts)``, ``counts[i]`` the number of real blocks in stage i (the
    padded slots hold zeros and are masked out by position)."""
    nb = tree_flatten(body_params)[0][0].shape[0]
    nb_pad = -(-nb // num_stages) * num_stages
    per = nb_pad // num_stages

    def prep(leaf):
        if nb_pad != nb:
            pad = leaf.new_zeros((nb_pad - nb,) + tuple(leaf.shape[1:]))
            leaf = torch.cat([leaf, pad], 0)
        return leaf.reshape((num_stages, per) + tuple(leaf.shape[1:]))

    counts = [min(max(nb - i * per, 0), per) for i in range(num_stages)]
    return tree_map(prep, body_params), counts


@dataclass(frozen=True)
class StageShard:
    """One rank's stored stage of a pipelined trunk (:func:`shard_stage`):
    ``params`` its blocks (leaves (per, ...)), each leaf that ``sliced``
    marks (in ``tree_flatten`` order) cut to this rank's ``tp`` slice of
    its output channels; ``count`` the stage's real blocks."""

    params: dict
    count: int
    sliced: tuple


def _tp_divides(leaf, tp: int) -> bool:
    return tp > 1 and leaf.ndim >= 2 and leaf.shape[-1] >= tp \
        and leaf.shape[-1] % tp == 0


def shard_stage(body_params, mesh: Mesh) -> StageShard:
    """This rank's stage of the stacked trunk ``body_params``, stored as
    :func:`pipeline_trunk_apply` takes it over ``tp``: the blocks of its
    ``pp`` coordinate, each leaf whose output channels divide by |tp| cut
    to its ``tp`` slice (JAX's ``P("pp", ..., "tp")``). Run in a launched
    mesh (``comm.launch``)."""
    rm = comm.for_mesh(mesh)
    num_stages, tp = mesh.axis_size("pp"), mesh.axis_size("tp")
    pp_i = comm.axis_of(rm, "pp").index
    tp_i = comm.axis_of(rm, "tp").index
    staged, counts = _pad_body_to_stages(body_params, num_stages)
    leaves, struct = tree_flatten(tree_map(lambda a: a[pp_i], staged))
    sliced = tuple(_tp_divides(t, tp) for t in leaves)
    return StageShard(tree_unflatten(struct, [
        local_slice(t, tp, tp_i) if f else t.contiguous()
        for t, f in zip(leaves, sliced)]), counts[pp_i], sliced)


def _stage_fn(stage, count: int, dtype, kernel: bool):
    """The first ``count`` blocks of ``stage`` (leaves (per, ...)) as one
    function of NCHW features in ``dtype``."""
    slope = float(torch.tensor(0.2, dtype=dtype))
    if not kernel:
        blocks = _pack_body(stage, dtype)[:count]

        def run(h):
            for blk in blocks:
                h = _rrdb_block(h, blk, slope)
            return h

        return run

    packed = [[pack_rdb_weights(
        [_oihw({"kernel": stage[r][f"conv{k}"]["kernel"][i],
                "bias": stage[r][f"conv{k}"]["bias"][i]}).weight
         for k in range(1, 6)],
        [stage[r][f"conv{k}"]["bias"][i] for k in range(1, 6)], dtype)
        for r in ("rdb1", "rdb2", "rdb3")] for i in range(count)]

    def run_kernel(h):
        x = h.permute(0, 2, 3, 1).contiguous()
        s = torch.tensor(0.2, dtype=dtype, device=x.device)
        for blk in packed:
            out = x
            for w, b in blk:
                out = rdb(out, w, b)
            x = out * s + x
        return x.permute(0, 3, 1, 2)

    return run_kernel


def _check_split(b: int, num_stages: int, dp: int, num_micro):
    if num_micro is None:
        # the largest divisor of the batch ≤ the stage count
        num_micro = max(d for d in range(1, min(b, num_stages) + 1)
                        if b % d == 0)
    if b % num_micro:
        raise ValueError(f"batch {b} not divisible by num_micro {num_micro}")
    if (b // num_micro) % dp:
        raise ValueError(
            f"microbatch size {b // num_micro} not divisible by dp={dp}")
    return num_micro


def pipeline_trunk_apply(body_params, feat: torch.Tensor, mesh: Mesh, *,
                         num_micro: int | None = None,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The RRDB trunk over the mesh's ``pp`` axis, run in every rank of
    ``mesh`` with the same ``feat``.

    ``body_params``: the whole stacked trunk (every rank cuts its stage
    from it), or this rank's :class:`StageShard`, whose ``tp`` slices are
    all-gathered once per call. ``feat``: (B, H, W, C) post-``conv_first``
    features; ``num_micro`` microbatches must divide B (default: the
    largest divisor of B up to |pp|), and |dp| the microbatch. Returns on
    every rank the (B, H, W, C) the sequential trunk gives, in ``dtype``;
    differentiable in ``body_params`` and ``feat``. A mesh of one device
    runs the stages' code without a collective: the sequential
    reference."""
    if "pp" not in mesh.axis_names:
        raise ValueError("mesh has no 'pp' axis")
    num_stages = mesh.axis_size("pp")
    dp = mesh.axis_size("dp")
    b = feat.shape[0]
    m = _check_split(b, num_stages, dp, num_micro)
    rm = comm.for_mesh(mesh)
    pp_ax = comm.axis_of(rm, "pp")
    stage_idx = pp_ax.index
    if isinstance(body_params, StageShard):
        # one gather over tp brings back the stage's whole weights
        count = body_params.count
        leaves, struct = tree_flatten(body_params.params)
        whole = iter(comm.all_gather_cat(
            [t for t, f in zip(leaves, body_params.sliced) if f],
            comm.axis_of(rm, "tp")))
        stage = tree_unflatten(struct, [
            next(whole) if f else t
            for t, f in zip(leaves, body_params.sliced)])
    else:
        staged, counts = _pad_body_to_stages(body_params, num_stages)
        stage = tree_map(lambda a: a[stage_idx], staged)
        count = counts[stage_idx]
    run = _stage_fn(stage, count, dtype,
                    kernel=not torch.is_grad_enabled() and feat.is_cuda)

    x = feat.permute(0, 3, 1, 2).to(dtype)
    micro = x.reshape((m, b // m) + tuple(x.shape[1:]))
    if dp > 1:
        k = b // m // dp
        i = comm.axis_of(rm, "dp").index
        micro = micro[:, i * k:(i + 1) * k]
    first = torch.tensor(stage_idx == 0, device=x.device)
    h_prev = torch.zeros_like(micro[0])
    outs = []
    for t in range(m + num_stages - 1):
        h_in = comm.ring_shift(h_prev, pp_ax)
        # stage 0 takes microbatch t; the others what the shift brought
        h_out = run(torch.where(first, micro[min(t, m - 1)], h_in))
        if t >= num_stages - 1:          # the last stage drains t − (S−1)
            outs.append(h_out)
        h_prev = h_out
    keep = 1.0 if stage_idx == num_stages - 1 else 0.0
    out = comm.all_reduce_sum(torch.stack(outs) * keep, pp_ax)
    if dp > 1:
        out = comm.all_gather_cat([out], comm.axis_of(rm, "dp"), dim=1)[0]
    return out.reshape((b,) + tuple(x.shape[1:])).permute(0, 2, 3, 1)


def rrdbnet_pipeline_apply(params, x: torch.Tensor, mesh: Mesh, *,
                           num_micro: int | None = None,
                           dtype: torch.dtype = torch.float32,
                           scale: int = 4) -> torch.Tensor:
    """The whole RRDBNet forward with its trunk pipelined over ``pp``
    (:func:`pipeline_trunk_apply`); head and tail run on every rank, as
    ``models/rrdbnet.py::rrdbnet_apply`` runs them. (B, h, w, 3) →
    (B, s·h, s·w, 3) float32 on every rank."""

    def trunk(feat):
        return pipeline_trunk_apply(
            params["body"], feat.permute(0, 2, 3, 1), mesh,
            num_micro=num_micro, dtype=dtype).permute(0, 3, 1, 2)

    return rrdbnet_apply(params, x, scale=scale, dtype=dtype, trunk=trunk)


def make_pp_train_step(config, mesh: Mesh, *, num_micro: int | None = None):
    """Training step whose forward pipelines the trunk over ``pp``, run in
    every rank of ``mesh`` with the same params and global batch. The
    backward streams back through the pipeline (each shift's gradient
    goes one stage back). Composes with ``dp`` as
    :func:`pipeline_trunk_apply` does; the params are whole on every rank,
    so ``tp`` replicates the stage. Each rank's objective is the loss
    over the mesh size, and the gradients are summed over every rank: the
    gradient of the one-device loss, which the collectives' backwards
    route to the ranks that hold each part.

    → ``(step, tx)`` with ``step(params, opt_state, lr, hr) -> (params,
    opt_state, loss)``, as ``training.train.make_train_step``. RRDBNet
    family only: the stages are RRDB blocks."""
    from ..training.train import _dtype, loss_from_pred, make_optimizer
    from ..utils.precision import ieee_fp32

    if config.family != "rrdbnet":
        raise ValueError("pp pipelining stages RRDB blocks; family must "
                         f"be rrdbnet, got {config.family!r}")
    dtype = _dtype(config)
    tx = make_optimizer(config)
    rm = comm.for_mesh(mesh)

    def step(params, opt_state, lr_batch, hr_batch):
        leaves, struct = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with ieee_fp32(dtype == torch.float32):
            pred = rrdbnet_pipeline_apply(
                tree_unflatten(struct, leaves), lr_batch, mesh,
                num_micro=num_micro, dtype=dtype, scale=config.scale)
            loss = loss_from_pred(pred, hr_batch, config)
            grads = torch.autograd.grad(loss / mesh.size, leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if rm is not None:
            grads = comm.all_reduce_mean(grads, rm.world, mean=False)
        params, opt_state = tx.update(grads, opt_state, tree_unflatten(
            struct, [p.detach() for p in leaves]))
        return params, opt_state, loss.detach()

    return step, tx
