"""The port's trainers over a ``dp=2`` mesh against the JAX package's
sharded steps (``tests/test_training.py``'s sharded tests): the L1 step,
the chunked step, the device-pool step (fed JAX's draws), SwinIR's step
and the GAN step, each also against the port's own one-device step; then
``cli.train --mesh dp=2 --backend gloo`` against the one-device CLI, and
the backend's refusals. The ``sp`` cases of those tests (dp=2,sp=2) are
in ``tests/test_torch_sp.py``.

The port's side runs in two gloo ranks on the CPU, started once for the
module (``tests/torch_mesh_ranks.py::train_program``); every rank is
given the global batch and keeps its ``dp`` slice. The JAX side runs here
on two virtual CPU devices, while the ranks run.

Tolerances: sharded against one-device at JAX's own (loss rel 1e-5;
params atol 1e-5, rtol 1e-4); the port against JAX at
``tests/test_torch_train.py``'s and ``tests/test_torch_gan.py``'s
one-step tolerances (loss rel 1e-5, params 1e-5; the discriminator by
``assert_disc_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from s2sr_tpu.training import gan as jg
from s2sr_tpu.training import train as jt
from s2sr_tpu_torch.models.weights import tree_to_torch
from s2sr_tpu_torch.parallel import comm
from s2sr_tpu_torch.parallel.mesh import build_mesh

from test_torch_gan import METRICS, RRDB, assert_disc_close, gan_states, \
    leaf_rel
from test_torch_train import jax_draws, jax_state, max_diff, np_tree, rel
from torch_mesh_ranks import launch_async, train_program
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(num_feat=8, num_block=1, num_grow_ch=4, scale=2,
            dtype="float32", learning_rate=1e-3)
SWIN = dict(family="swinir", embed_dim=16, depths=(1, 1), heads=(2, 2),
            window=4, scale=2, dtype="float32", learning_rate=1e-3)
KNOBS = dict(blur_sigma=1.0, noise_std=0.02, jpeg_range=(30.0, 95.0))


def _jmesh():
    return Mesh(np.array(jax.devices()[:2]), ("dp",))


def _batch(n, h, seed, s=2):
    rng = np.random.default_rng(seed)
    return (rng.random((n, h, h, 3), dtype=np.float32),
            rng.random((n, h * s, h * s, 3), dtype=np.float32))


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, kw, (n, h) in (("l1", TINY, (8, 16)), ("swinir", SWIN, (4, 8))):
        lr, hr = _batch(n, h, 1)
        out[name] = {"config": kw, "lr": lr, "hr": hr,
                     "params": np_tree(jax_state(jt.TrainConfig(**kw))[0])}
    chunks = [_batch(4, 8, s) for s in range(2)]
    out["chunked"] = {"config": TINY,
                      "params": out["l1"]["params"],
                      "lr": np.stack([c[0] for c in chunks]),
                      "hr": np.stack([c[1] for c in chunks])}
    pool_cfg = dict(TINY, lr_decay_steps=3, ema_decay=0.5)
    pool = np.random.default_rng(9).random((3, 44, 44, 3), dtype=np.float32)
    key = jax.random.PRNGKey(5)
    out["pool"] = {
        "config": pool_cfg, "knobs": KNOBS, "crop": 16, "batch": 4,
        "key": key, "pool": pool,
        "params": np_tree(jax_state(jt.TrainConfig(**pool_cfg))[0]),
        "draws": [jax_draws(k, 3, 44, 32, 4, 16, KNOBS["jpeg_range"])
                  for k in jax.random.split(key, 2)]}
    rng = np.random.default_rng(1)
    hr = rng.random((4, 32, 32, 3), dtype=np.float32)
    (jp, _, jd, _), _ = gan_states(jt.TrainConfig(**RRDB), 8)
    out["gan"] = {"config": RRDB, "num_feat_d": 8, "g": np_tree(jp),
                  "d": np_tree(jd), "hr": hr,
                  "lr": hr.reshape(4, 16, 2, 16, 2, 3).mean((2, 4)),
                  "knobs": KNOBS, "crop": 16, "batch": 4, "pool": pool,
                  "draws": out["pool"]["draws"]}
    return out


@pytest.fixture(scope="module")
def launched(cases):
    """One spawn of two ranks for the module, running in the background."""
    sent = {k: {kk: vv for kk, vv in v.items() if kk != "key"}
            for k, v in cases.items()}
    return launch_async(train_program, build_mesh("dp=2", device="cpu"),
                        (sent,))


@pytest.fixture(scope="module")
def jax_side(cases, launched):
    """JAX's sharded steps on every case, run while the ranks run."""
    out = {name: _jax_sharded_step(cases[name]) for name in ("l1", "swinir")}
    c = cases["chunked"]
    run, tx = jt.make_chunked_train_step(jt.TrainConfig(**c["config"]),
                                         mesh=_jmesh())
    params = jax.tree.map(jnp.asarray, c["params"])
    out["chunked"] = run(params, tx.init(params), c["lr"], c["hr"])
    c = cases["pool"]
    run, tx = jt.make_device_pool_train_step(
        jt.TrainConfig(**c["config"]), c["crop"], c["batch"], 2,
        mesh=_jmesh(), **c["knobs"])
    params = jax.tree.map(jnp.asarray, c["params"])
    out["pool"] = run(params, tx.init(params), jnp.asarray(c["pool"]),
                      c["key"])
    c = cases["gan"]
    jcfg = jt.TrainConfig(**c["config"])
    (jp, jo, jd, jdo), _ = gan_states(jcfg, 8)
    jmesh = _jmesh()
    bsh = jt.batch_sharding(jmesh)
    jstep = jg.make_gan_train_step(jg.GanConfig(base=jcfg, num_feat_d=8),
                                   jmesh)[0]
    out["gan"] = (jd, jstep(jp, jd, jo, jdo, jax.device_put(c["lr"], bsh),
                            jax.device_put(c["hr"], bsh)))
    return out


@pytest.fixture(scope="module")
def port(launched, jax_side):
    """Every rank's results."""
    return launched.result()


def _params_close(a, b):
    """JAX's sharded-vs-unsharded bound on two numpy trees."""
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(x, y, atol=1e-5, rtol=1e-4)


def _check_sharded(got):
    """The mesh run against the one-device run, and equal on both ranks."""
    assert got[0]["mesh"]["loss"] == pytest.approx(got[0]["one"]["loss"],
                                                   rel=1e-5)
    _params_close(got[0]["mesh"]["params"], got[0]["one"]["params"])
    for a, b in zip(jax.tree.leaves(got[0]["mesh"]["params"]),
                    jax.tree.leaves(got[1]["mesh"]["params"])):
        np.testing.assert_array_equal(a, b)


def _jax_sharded_step(c):
    config = jt.TrainConfig(**c["config"])
    mesh = _jmesh()
    bsh, repl = jt.batch_sharding(mesh), NamedSharding(mesh, P())
    params = jax.tree.map(jnp.asarray, c["params"])
    step, tx = jt.make_train_step(config, mesh)
    p, _, loss = step(jax.device_put(params, repl),
                      jax.device_put(tx.init(params), repl),
                      jax.device_put(c["lr"], bsh),
                      jax.device_put(c["hr"], bsh))
    return p, float(loss)


@pytest.mark.parametrize("name", ["l1", "swinir"])
def test_sharded_step_matches_unsharded_and_jax(port, jax_side, name):
    """``make_train_step`` over dp=2 (RRDBNet, and SwinIR: its window
    partition sees whole images on each rank)."""
    got = [r[name] for r in port]
    _check_sharded(got)
    jp, jl = jax_side[name]
    assert rel(got[0]["mesh"]["loss"], jl) <= 1e-5
    assert max_diff(jp, tree_to_torch(got[0]["mesh"]["params"])) <= 1e-5


def test_chunked_step_sharded(port, jax_side):
    got = [r["chunked"] for r in port]
    np.testing.assert_allclose(got[0]["mesh"]["losses"],
                               got[0]["one"]["losses"], rtol=1e-5, atol=1e-7)
    _params_close(got[0]["mesh"]["params"], got[0]["one"]["params"])
    assert got[0]["mesh"]["opt"]["count"] == 2
    np.testing.assert_array_equal(got[0]["mesh"]["losses"],
                                  got[1]["mesh"]["losses"])
    jp, _, jl = jax_side["chunked"]
    assert rel(got[0]["mesh"]["losses"], np.asarray(jl)) <= 1e-5
    assert max_diff(jp, tree_to_torch(got[0]["mesh"]["params"])) <= 1e-5


def test_device_pool_train_step_sharded(port, jax_side):
    """The pool step over dp=2 on JAX's draws: every rank builds the whole
    batch and keeps its half; the cosine schedule and the EMA advance as
    on one device."""
    got = [r["pool"] for r in port]
    np.testing.assert_allclose(got[0]["mesh"]["losses"],
                               got[0]["one"]["losses"], rtol=1e-5, atol=1e-7)
    _params_close(got[0]["mesh"]["params"], got[0]["one"]["params"])
    _params_close(got[0]["mesh"]["opt"]["ema"], got[0]["one"]["opt"]["ema"])
    own = got[0]["own_draws_losses"]
    assert own.shape == (2,) and np.all(np.isfinite(own))
    np.testing.assert_array_equal(own, got[1]["own_draws_losses"])
    jp, jo, jl = jax_side["pool"]
    assert rel(got[0]["mesh"]["losses"], np.asarray(jl)) <= 1e-5
    assert max_diff(jp, tree_to_torch(got[0]["mesh"]["params"])) <= 1e-5
    assert max_diff(jt.ema_params(jo),
                    tree_to_torch(got[0]["mesh"]["opt"]["ema"])) <= 1e-5


def test_gan_step_sharded(port, cases, jax_side):
    """One G+D step over dp=2: the relativistic losses' logit means are
    over the global batch, and G's and D's gradients are averaged; then
    the pool GAN step over dp=2 against one device on the same draws."""
    c = cases["gan"]
    got = [r["gan"] for r in port]
    mesh, one = got[0]["mesh"], got[0]["one"]
    for k in METRICS:
        assert mesh["metrics"][k] == pytest.approx(one["metrics"][k],
                                                   rel=1e-5), k
        np.testing.assert_allclose(mesh["pool"]["metrics"][k],
                                   one["pool"]["metrics"][k], rtol=1e-5)
    _params_close(mesh["g"], one["g"])
    _params_close(mesh["pool"]["g"], one["pool"]["g"])
    # D by test_torch_gan.py's rule: out1's bias has a gradient of zero up
    # to rounding, and Adam's step on it takes either sign
    assert_disc_close(c["d"], one["d"], tree_to_torch(mesh["d"]), 1e-4)
    assert_disc_close(c["d"], one["pool"]["d"],
                      tree_to_torch(mesh["pool"]["d"]), 2e-4)
    for a, b in zip(jax.tree.leaves(mesh["d"]),
                    jax.tree.leaves(got[1]["mesh"]["d"])):
        np.testing.assert_array_equal(a, b)
    jd, (jp1, jd1, jo1, _, jm) = jax_side["gan"]
    for k in METRICS:
        assert rel(mesh["metrics"][k], float(jm[k])) <= 1e-5, k
    assert max(leaf_rel(jp1, tree_to_torch(mesh["g"])).values()) <= 1e-5
    assert max(leaf_rel(jt.ema_params(jo1),
                        tree_to_torch(mesh["ema"])).values()) <= 1e-5
    assert_disc_close(jd, jd1, tree_to_torch(mesh["d"]), 1e-4)


def test_cli_train_mesh_matches_one_device(tmp_path):
    """``cli.train --mesh dp=2 --backend gloo --device cpu`` (it spawns its
    own two ranks) logs the one-device run's losses; rank 0 alone writes
    the checkpoint and the log."""
    from s2sr_tpu_torch.cli import train as cli

    args = ["--device", "cpu", "--blocks", "1", "--feat", "8", "--grow",
            "4", "--batch", "4", "--pool", "2", "--crop", "8", "--steps",
            "4", "--chunk", "2"]
    logs = {}
    for label, extra in (("one", []),
                         ("mesh", ["--mesh", "dp=2", "--backend", "gloo"])):
        log = tmp_path / f"{label}.losses"
        cli.main(args + extra + ["--ckpt-dir", str(tmp_path / label),
                                 "--loss-log", str(log)])
        logs[label] = np.loadtxt(log)
    assert logs["mesh"].shape == (4,)
    np.testing.assert_allclose(logs["mesh"], logs["one"], rtol=1e-5)
    assert sorted(p.name for p in (tmp_path / "mesh").iterdir()) == ["4"]


def test_backend_refusals():
    """No fallback: nccl refuses CPU ranks and more ranks than GPUs, naming
    --backend gloo; an unknown backend is refused; a mesh step outside a
    launched rank says how to start the ranks."""
    from s2sr_tpu_torch.training import train as pt

    with pytest.raises(ValueError, match="--backend gloo"):
        comm.check_backend(build_mesh("dp=2", device="cpu").devices, "nccl")
    with pytest.raises(ValueError, match="--backend gloo"):
        comm.check_backend([torch.device("cuda", 0)] * 2, "nccl")
    comm.check_backend([torch.device("cuda", 0), torch.device("cuda", 1)],
                       "nccl")
    with pytest.raises(ValueError, match="backend must be"):
        comm.check_backend([torch.device("cpu")], "mpi")
    with pytest.raises(RuntimeError, match="comm.launch"):
        pt.make_train_step(pt.TrainConfig(**TINY),
                           build_mesh("dp=2", device="cpu"))
