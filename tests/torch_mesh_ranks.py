"""Rank programs of the port's multi-device tests (``parallel/comm.py``
launches them, one gloo rank per mesh device on the CPU).

This module imports only ``torch`` and the port: the spawned ranks never
load JAX. Each program runs every scenario of its test file, in the same
order on every rank (the collectives pair up by order), and returns numpy
results to the test; the JAX side runs in the test process.
"""

from __future__ import annotations

import numpy as np
import torch

from s2sr_tpu_torch.models.weights import tree_to_numpy, tree_to_torch
from s2sr_tpu_torch.parallel import comm
from s2sr_tpu_torch.parallel.mesh import build_mesh


def launch_async(program, mesh, args: tuple, timeout: float = 120.0):
    """``comm.launch`` of ``program`` from a thread → a future of the
    ranks' results, so that the ranks run while the test process computes
    JAX's side."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    future = pool.submit(comm.launch, program, mesh, args=args,
                         timeout=timeout)
    pool.shutdown(wait=False)
    return future


def _state(params_np, config):
    from s2sr_tpu_torch.training.train import make_optimizer

    params = tree_to_torch(params_np)
    return params, make_optimizer(config).init(params)


def _opt_np(o):
    return {"count": int(o.count), "mu": tree_to_numpy(o.mu),
            "nu": tree_to_numpy(o.nu),
            "ema": None if o.ema is None else tree_to_numpy(o.ema)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- tests/test_torch_parallel_pp_tp.py: four ranks ------------------------

def pp_tp_program(rank: int, cases: dict) -> dict:
    torch.set_num_threads(1)         # four ranks beside the test's workers
    from s2sr_tpu_torch.models.rrdbnet import rrdbnet_apply
    from s2sr_tpu_torch.parallel.pipeline import (make_pp_train_step,
                                                  pipeline_trunk_apply,
                                                  rrdbnet_pipeline_apply,
                                                  shard_stage)
    from s2sr_tpu_torch.parallel.tensor import (gather_tree,
                                                make_fsdp_train_step,
                                                shard_tree)
    from s2sr_tpu_torch.training.train import TrainConfig, make_train_step

    out = {}
    one = build_mesh("pp=1", device="cpu")
    with torch.no_grad():
        for name in ("trunk", "ragged", "dp_pp", "pp_tp", "dp_pp_tp"):
            c = cases[name]
            body, feat = tree_to_torch(c["body"]), _t(c["feat"])
            mesh = build_mesh(c["mesh"], device="cpu")
            # meshes with a tp axis store each rank's stage in tp slices
            stored = shard_stage(body, mesh) if "tp" in c["mesh"] else body
            got = pipeline_trunk_apply(stored, feat, mesh,
                                       num_micro=c["num_micro"])
            want = pipeline_trunk_apply(body, feat, one)
            out[name] = {"got": got.numpy(), "sequential": want.numpy()}
            if stored is not body:
                out[name]["stored_shape"] = tuple(
                    stored.params["rdb1"]["conv5"]["kernel"].shape)

        c = cases["full_model"]
        params, x = tree_to_torch(c["params"]), _t(c["x"])
        out["full_model"] = {
            "got": rrdbnet_pipeline_apply(
                params, x, build_mesh(c["mesh"], device="cpu"),
                dtype=torch.float32, scale=4).numpy(),
            "apply": rrdbnet_apply(params, x, scale=4,
                                   dtype=torch.float32).numpy()}

        c = cases["tp_forward"]
        mesh = build_mesh(c["mesh"], device="cpu")
        params, x = tree_to_torch(c["params"]), _t(c["x"])
        local = shard_tree(params, mesh)
        whole = gather_tree(local, params, mesh)
        out["tp_forward"] = {
            "local_shape": tuple(local["conv_first"]["kernel"].shape),
            "last_local_shape": tuple(local["conv_last"]["kernel"].shape),
            "got": rrdbnet_apply(whole, x, scale=2,
                                 dtype=torch.float32).numpy(),
            "replicated": rrdbnet_apply(params, x, scale=2,
                                        dtype=torch.float32).numpy()}

    for name in ("tp_step", "fsdp"):
        c = cases[name]
        config = TrainConfig(**c["config"])
        mesh = build_mesh(c["mesh"], device="cpu")
        params, opt = _state(c["params"], config)
        lr, hr = _t(c["lr"]), _t(c["hr"])
        step, _ = make_fsdp_train_step(config, mesh, params, opt)
        p1, o1, loss = step(shard_tree(params, mesh), shard_tree(opt, mesh),
                            lr, hr)
        ref, _ = make_train_step(config)
        rp, _, rloss = ref(params, opt, lr, hr)
        out[name] = {
            "loss": float(loss), "ref_loss": float(rloss),
            "params": tree_to_numpy(gather_tree(p1, params, mesh)),
            "ref_params": tree_to_numpy(rp),
            "shapes": {"p": tuple(p1["conv_first"]["kernel"].shape),
                       "mu": tuple(o1.mu["conv_first"]["kernel"].shape),
                       "nu": tuple(o1.nu["conv_first"]["kernel"].shape),
                       "conv_last": tuple(p1["conv_last"]["kernel"].shape)}}

    c = cases["pp_step"]
    config = TrainConfig(**c["config"])
    params, opt = _state(c["params"], config)
    lr, hr = _t(c["lr"]), _t(c["hr"])
    step, _ = make_pp_train_step(config, build_mesh(c["mesh"], device="cpu"))
    p1, o1, loss = step(params, opt, lr, hr)
    ref, _ = make_train_step(config)
    rp, _, rloss = ref(params, opt, lr, hr)
    out["pp_step"] = {"loss": float(loss), "ref_loss": float(rloss),
                      "params": tree_to_numpy(p1),
                      "ref_params": tree_to_numpy(rp)}
    return out


# --- tests/test_torch_parallel_train.py: two ranks ------------------------

def train_program(rank: int, cases: dict) -> dict:
    torch.set_num_threads(1)
    from s2sr_tpu_torch.training import gan as pg
    from s2sr_tpu_torch.training import train as pt

    mesh = build_mesh("dp=2", device="cpu")
    out = {}
    for name in ("l1", "swinir"):
        c = cases[name]
        config = pt.TrainConfig(**c["config"])
        params, opt = _state(c["params"], config)
        lr, hr = _t(c["lr"]), _t(c["hr"])
        res = {}
        for label, m in (("mesh", mesh), ("one", None)):
            step, _ = pt.make_train_step(config, m)
            p1, o1, loss = step(params, opt, lr, hr)
            res[label] = {"loss": float(loss), "params": tree_to_numpy(p1)}
        out[name] = res

    c = cases["chunked"]
    config = pt.TrainConfig(**c["config"])
    params, opt = _state(c["params"], config)
    res = {}
    for label, m in (("mesh", mesh), ("one", None)):
        run, _ = pt.make_chunked_train_step(config, m)
        p1, o1, losses = run(params, opt, _t(c["lr"]), _t(c["hr"]))
        res[label] = {"losses": losses.numpy(), "params": tree_to_numpy(p1),
                      "opt": _opt_np(o1)}
    out["chunked"] = res

    c = cases["pool"]
    config = pt.TrainConfig(**c["config"])
    params, opt = _state(c["params"], config)
    pool = _t(c["pool"])
    draws = [{k: _t(v) for k, v in d.items()} for d in c["draws"]]
    res = {}
    for label, m in (("mesh", mesh), ("one", None)):
        run, _ = pt.make_device_pool_train_step(
            config, c["crop"], c["batch"], len(draws), mesh=m, **c["knobs"])
        p1, o1, losses = run(params, opt, pool, None, draws=draws)
        res[label] = {"losses": losses.numpy(), "params": tree_to_numpy(p1),
                      "opt": _opt_np(o1)}
    # its own draws: every rank seeds its generator alike
    run, _ = pt.make_device_pool_train_step(config, c["crop"], c["batch"], 2,
                                            mesh=mesh, **c["knobs"])
    _, _, losses = run(params, opt, pool, torch.Generator().manual_seed(3))
    res["own_draws_losses"] = losses.numpy()
    out["pool"] = res

    c = cases["gan"]
    gcfg = pg.GanConfig(base=pt.TrainConfig(**c["config"]),
                        num_feat_d=c["num_feat_d"])
    res = {}
    for label, m in (("mesh", mesh), ("one", None)):
        g, go = _state(c["g"], gcfg.base)
        d = tree_to_torch(c["d"])
        do = pt.make_optimizer(pt.TrainConfig(learning_rate=gcfg.lr_d)).init(d)
        step = pg.make_gan_train_step(gcfg, m)[0]
        g1, d1, go1, do1, metrics = step(g, d, go, do, _t(c["lr"]),
                                         _t(c["hr"]))
        res[label] = {"g": tree_to_numpy(g1), "d": tree_to_numpy(d1),
                      "ema": tree_to_numpy(go1.ema),
                      "metrics": {k: float(v) for k, v in metrics.items()}}
        pdraws = [{k: _t(v) for k, v in dd.items()} for dd in c["draws"]]
        run = pg.make_device_pool_gan_step(gcfg, c["crop"], c["batch"],
                                           len(pdraws), mesh=m,
                                           **c["knobs"])[0]
        g, go = _state(c["g"], gcfg.base)
        g2, d2, _, _, pm = run(g, tree_to_torch(c["d"]), go, do,
                               _t(c["pool"]), None, draws=pdraws)
        res[label]["pool"] = {"g": tree_to_numpy(g2), "d": tree_to_numpy(d2),
                              "metrics": {k: v.numpy()
                                          for k, v in pm.items()}}
    out["gan"] = res
    return out


# --- tests/test_torch_gan.py: two ranks -----------------------------------

def gan_mesh_steps(rank: int, config: dict) -> dict:
    """One G+D step of a fresh GAN over dp=2 and over sp=2 (two bands of
    the 16-row HR crops) → their g_loss by mesh."""
    torch.set_num_threads(1)
    from s2sr_tpu_torch.training import gan as pg
    from s2sr_tpu_torch.training import train as pt

    gcfg = pg.GanConfig(base=pt.TrainConfig(**config), num_feat_d=8)
    g, go = pt.init_training(gcfg.base, seed=0, device="cpu")
    d = pg.UNetDiscriminator(8).init(torch.Generator().manual_seed(1))
    do = pt.make_optimizer(pt.TrainConfig(learning_rate=gcfg.lr_d)).init(d)
    hr = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(2))
    lr = hr.reshape(2, 8, 2, 8, 2, 3).mean((2, 4))
    out = {}
    for spec in ("dp=2", "sp=2"):
        step = pg.make_gan_train_step(gcfg, build_mesh(spec, device="cpu"))[0]
        out[spec] = float(step(g, d, go, do, lr, hr)[4]["g_loss"])
    return out


# --- tests/test_torch_sp.py: four ranks -----------------------------------

def _halo_chain(x, ws, sp=None):
    """Two 3×3 convs (NCHW, no bias), each with a 1-row halo over ``sp``."""
    import torch.nn.functional as F

    for w in ws:
        if sp is None:
            x = F.conv2d(x, w, padding=1)
        else:
            x = F.conv2d(comm.halo_exchange(x, 1, sp, dim=2), w,
                         padding=(0, 1))
        x = torch.tanh(x)
    return x


def sp_program(rank: int, cases: dict) -> dict:
    """Every scenario of ``tests/test_torch_sp.py`` that runs over ranks:
    the float64 halo gradient over the ``sp`` axis, then the L1, chunked,
    SwinIR, FSDP and GAN steps over ``dp=2,sp=2`` (FSDP over
    ``dp=1,sp=2,tp=2``), each beside the one-device step."""
    torch.set_num_threads(1)
    from s2sr_tpu_torch.parallel.tensor import (gather_tree,
                                                make_fsdp_train_step,
                                                shard_tree)
    from s2sr_tpu_torch.training import gan as pg
    from s2sr_tpu_torch.training import train as pt

    mesh = build_mesh("dp=2,sp=2", device="cpu")
    rm = comm.rank_mesh(mesh)
    sp = rm.axis("sp")
    out = {}

    c = cases["halo"]
    x = _t(c["x"]).requires_grad_(True)
    ws = [_t(w).requires_grad_(True) for w in c["ws"]]
    r = _t(c["r"])
    band = comm.band_of(x.shape[2], sp)
    xb = x.detach()[:, :, band.start:band.stop].clone().requires_grad_(True)
    wb = [w.detach().clone().requires_grad_(True) for w in ws]
    yb = _halo_chain(xb, wb, sp)
    (yb * r[:, :, band.start:band.stop]).sum().backward()
    (_halo_chain(x, ws) * r).sum().backward()
    out["halo"] = {
        "band": (band.start, band.stop),
        "y": yb.detach().numpy(),
        "y_one": _halo_chain(x.detach(), [w.detach() for w in ws])[
            :, :, band.start:band.stop].numpy(),
        "gx": xb.grad.numpy(),
        "gx_one": x.grad[:, :, band.start:band.stop].numpy(),
        "gw": [comm.all_reduce_sum(w.grad, sp).numpy() for w in wb],
        "gw_one": [w.grad.numpy() for w in ws]}

    for name in ("l1", "l1_odd", "swinir"):
        c = cases[name]
        config = pt.TrainConfig(**c["config"])
        params, opt = _state(c["params"], config)
        lr, hr = _t(c["lr"]), _t(c["hr"])
        res = {}
        for label, m in (("mesh", mesh), ("one", None)):
            step, _ = pt.make_train_step(config, m)
            p1, _, loss = step(params, opt, lr, hr)
            res[label] = {"loss": float(loss), "params": tree_to_numpy(p1)}
        out[name] = res

    c = cases["chunked"]
    config = pt.TrainConfig(**c["config"])
    params, opt = _state(c["params"], config)
    res = {}
    for label, m in (("mesh", mesh), ("one", None)):
        run, _ = pt.make_chunked_train_step(config, m)
        p1, o1, losses = run(params, opt, _t(c["lr"]), _t(c["hr"]))
        res[label] = {"losses": losses.numpy(), "params": tree_to_numpy(p1),
                      "opt": _opt_np(o1)}
    out["chunked"] = res

    c = cases["fsdp"]
    config = pt.TrainConfig(**c["config"])
    fmesh = build_mesh(c["mesh"], device="cpu")
    params, opt = _state(c["params"], config)
    lr, hr = _t(c["lr"]), _t(c["hr"])
    step, _ = make_fsdp_train_step(config, fmesh, params, opt)
    p1, o1, loss = step(shard_tree(params, fmesh), shard_tree(opt, fmesh),
                        lr, hr)
    ref, _ = pt.make_train_step(config)
    rp, _, rloss = ref(params, opt, lr, hr)
    out["fsdp"] = {"loss": float(loss), "ref_loss": float(rloss),
                   "params": tree_to_numpy(gather_tree(p1, params, fmesh)),
                   "ref_params": tree_to_numpy(rp),
                   "mu_shape": tuple(o1.mu["conv_first"]["kernel"].shape)}

    c = cases["gan"]
    gcfg = pg.GanConfig(base=pt.TrainConfig(**c["config"]),
                        num_feat_d=c["num_feat_d"])
    res = {}
    for label, m in (("mesh", mesh), ("one", None)):
        g, go = _state(c["g"], gcfg.base)
        d = tree_to_torch(c["d"])
        do = pt.make_optimizer(pt.TrainConfig(learning_rate=gcfg.lr_d)).init(d)
        step = pg.make_gan_train_step(gcfg, m)[0]
        g1, d1, go1, _, metrics = step(g, d, go, do, _t(c["lr"]),
                                       _t(c["hr"]))
        res[label] = {"g": tree_to_numpy(g1), "d": tree_to_numpy(d1),
                      "ema": tree_to_numpy(go1.ema),
                      "metrics": {k: float(v) for k, v in metrics.items()}}
    out["gan"] = res
    return out

