"""Weights and Adam moments stored in slices of their output channels
over ``tp`` (the port of ``s2sr_tpu/parallel/tensor.py``).

Every leaf whose last dim (the HWIO kernel's, or a bias's, output
channels) is at least |tp| and divides by it is stored as this rank's
1/|tp| slice of that dim; everything else (three-channel convs, Adam's
count) replicates. Adam's ``mu``/``nu`` and the EMA mirror the params, so
with the batch over ``dp`` this is the ZeRO-3/FSDP layout: each rank
holds 1/|tp| of the model and of its optimizer.

JAX leaves the collectives to GSPMD, which partitions each conv's output
channels. The port's step (:func:`make_fsdp_train_step`) all-gathers the
weights over ``tp`` before the forward, runs forward and backward on the
rank's (dp, sp) slice of the batch (JAX shards it by ``batch_sharding``:
N over ``dp``, H over ``sp`` as bands with halo exchanges, as the L1
step's), reduce-scatters the weight gradients over ``tp`` and means them
over ``dp`` and ``sp``, and updates Adam (elementwise, no global-norm
clipping) and the EMA on the local slices only. Params, ``mu`` and
``nu`` stay sliced between steps.
"""

from __future__ import annotations

from ..models.weights import tree_flatten, tree_map, tree_unflatten
from . import comm
from .mesh import Mesh, Sharding


def _shardable(shape, size: int) -> bool:
    return len(shape) >= 1 and shape[-1] >= size and shape[-1] % size == 0


def _map_state(fn, tree, *rest):
    """``fn`` over a param tree's leaves (and ``rest``'s), or over an
    ``OptState``'s trees (``count`` and ``schedule_count`` are scalars and
    replicate)."""
    from ..training.train import OptState

    if isinstance(tree, OptState):
        fields = ("count", "mu", "nu", "schedule_count", "ema")
        return OptState(*(None if getattr(tree, f) is None else tree_map(
            fn, getattr(tree, f), *(getattr(r, f) for r in rest))
            for f in fields))
    return tree_map(fn, tree, *rest)


def tp_shardings(tree, mesh: Mesh, axis: str = "tp"):
    """A :class:`~.mesh.Sharding` per leaf of ``tree`` (params or an
    ``OptState``): the last dim over ``axis`` where it divides, else
    replicated."""
    size = mesh.axis_size(axis)

    def spec(leaf):
        shape = tuple(leaf.shape)
        if _shardable(shape, size):
            return Sharding(mesh, (None,) * (len(shape) - 1) + (axis,))
        return Sharding(mesh, ())

    return _map_state(spec, tree)


def local_slice(leaf, size: int, index: int):
    """Slice ``index`` of ``size`` of ``leaf``'s last dim."""
    c = leaf.shape[-1] // size
    return leaf[..., index * c:(index + 1) * c].contiguous()


def shard_tree(tree, mesh: Mesh, axis: str = "tp"):
    """This rank's slice of every leaf :func:`tp_shardings` marks (the
    rest as it is), in a launched mesh (``comm.launch``)."""
    size = mesh.axis_size(axis)
    index = comm.axis_of(comm.for_mesh(mesh), axis).index
    return _map_state(lambda leaf, sh: local_slice(leaf, size, index)
                      if sh.spec else leaf, tree, tp_shardings(tree, mesh,
                                                               axis))


def gather_tree(local, template, mesh: Mesh, axis: str = "tp"):
    """The whole leaves of a tree sliced by :func:`shard_tree` (the
    ``template`` gives their shapes), all-gathered over ``axis`` in one
    collective; differentiable in the slices."""
    leaves, struct = tree_flatten(local)
    flags = [bool(sh.spec) for sh in
             tree_flatten(tp_shardings(template, mesh, axis))[0]]
    whole = iter(comm.all_gather_cat(
        [t for t, f in zip(leaves, flags) if f],
        comm.axis_of(comm.for_mesh(mesh), axis)))
    return tree_unflatten(struct, [next(whole) if f else t
                                   for t, f in zip(leaves, flags)])


def make_fsdp_train_step(config, mesh: Mesh, params, opt_state):
    """dp×tp ("ZeRO-3/FSDP") training step, run in every rank of
    ``mesh`` (``comm.launch``). ``params``/``opt_state`` are whole
    templates: their shapes mark the leaves that are sliced.

    → ``(step, tx)`` with ``step(params, opt_state, lr, hr) -> (params,
    opt_state, loss)``: ``params``/``opt_state`` this rank's slices
    (:func:`shard_tree`), and so are the outputs; ``lr``/``hr`` the global
    batch (every rank passes all of it and keeps its (dp, sp) slice); the
    loss the global mean, on every rank."""
    import torch

    from ..training.train import (_dtype, band_unit, loss_fn, make_optimizer,
                                  rank_batch)
    from ..utils.precision import ieee_fp32

    tx = make_optimizer(config)
    rm = comm.for_mesh(mesh)
    tp, dp = comm.axis_of(rm, "tp"), comm.axis_of(rm, "dp")
    sp = comm.axis_of(rm, "sp")
    world = rm.world if rm else tp
    flags = [bool(sh.spec) for sh in
             tree_flatten(tp_shardings(params, mesh))[0]]

    def step(p, s, lr_batch, hr_batch):
        leaves, struct = tree_flatten(p)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        sharded = iter(comm.all_gather_cat(
            [t for t, f in zip(leaves, flags) if f], tp))
        whole = [next(sharded) if f else t for t, f in zip(leaves, flags)]
        lr_b, hr_b, band = rank_batch(lr_batch, hr_batch, rm, config.scale,
                                      band_unit(config))
        with ieee_fp32(_dtype(config) == torch.float32):
            # the global mean on every rank: each rank's gradient is its
            # (dp, sp) share times the number of (dp, sp) slices
            loss = loss_fn(tree_unflatten(struct, whole), lr_b, hr_b, config,
                           band, None if rm is None else world)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        # the gather's backward summed the |tp| equal gradients of each
        # slice: their mean over tp, then the mean over dp and over sp
        part = comm.all_reduce_mean(
            [g / tp.size for g, f in zip(grads, flags) if f], dp)
        part = iter(comm.all_reduce_mean(part, sp))
        # replicated leaves: every tp rank holds its slice's share, so the
        # mean over every rank is the mean over dp and sp, and keeps them
        # equal everywhere
        rest = iter(comm.all_reduce_mean(
            [g for g, f in zip(grads, flags) if not f], world))
        grads = [next(part) if f else next(rest) for f in flags]
        p, s = tx.update(grads, s, tree_unflatten(struct, [
            t.detach() for t in leaves]))
        return p, s, loss.detach()

    return step, tx
