"""The port's pipeline (``parallel/pipeline.py``) and tensor-axis
sharding (``parallel/tensor.py``) against the JAX package's, one test for
each of ``tests/test_parallel_pp_tp.py``'s.

The port's side runs in four gloo ranks on the CPU, started once for the
module (``tests/torch_mesh_ranks.py::pp_tp_program`` runs every
scenario); the JAX side runs here on the virtual CPU devices, on the same
mesh shape, while the ranks run (one compile per function). Meshes are
capped at four ranks on both sides: JAX's tp=8 becomes tp=4, its 2×4
dp×pp 2×2, its 4×2 pp×tp 2×2, its 2×4 dp×tp 2×2 and its 2×2×2 dp×pp×tp
2×2×1.

Tolerances: the port's sharded result against its one-device result at
JAX's own (atol 1e-6 for forwards; loss 1e-6 and params 1e-5 for a
step); the port against JAX at ``tests/test_torch_train.py``'s one-step
tolerance (params 1e-5, loss rel 1e-6) and, for forwards, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from s2sr_tpu.models.rrdbnet import rrdbnet_apply
from s2sr_tpu.parallel.pipeline import (pipeline_trunk_apply,
                                        rrdbnet_pipeline_apply)
from s2sr_tpu.parallel.tensor import shard_tree
from s2sr_tpu_torch.models.weights import (init_state_dict, rrdbnet_tree,
                                           tree_to_torch)
from s2sr_tpu_torch.parallel import pipeline as ppipe
from s2sr_tpu_torch.parallel.mesh import build_mesh
from s2sr_tpu_torch.training import train as pt

from test_torch_train import max_diff, np_tree, rel
from torch_mesh_ranks import launch_async, pp_tp_program
from torch_threads import one_torch_thread  # noqa: F401

STEP = dict(num_feat=16, num_grow_ch=8, scale=2, dtype="float32")


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _jmesh_of(spec):
    """JAX's mesh of a port mesh spec such as ``"dp=2,pp=2"``."""
    axes = [a.split("=") for a in spec.split(",")]
    return _jmesh(tuple(int(n) for _, n in axes), tuple(k for k, _ in axes))


def _init(nb, seed):
    """The port's seeded init in the JAX layout (numpy leaves, keys in
    JAX's order): no JAX compile."""
    return np_tree(rrdbnet_tree(init_state_dict(
        num_feat=16, num_block=nb, num_grow_ch=8, seed=seed)))


def _trunk_case(nb, key, feat_shape, mesh, num_micro, seed):
    rng = np.random.default_rng(seed)
    return {"body": _init(nb, key)["body"], "mesh": mesh,
            "num_micro": num_micro,
            "feat": rng.random(feat_shape).astype(np.float32)}


def _step_case(nb, mesh, seed):
    rng = np.random.default_rng(seed)
    return {"config": dict(num_block=nb, **STEP), "mesh": mesh,
            "params": _init(nb, seed),
            "lr": rng.random((4, 8, 8, 3)).astype(np.float32),
            "hr": rng.random((4, 16, 16, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(7)
    return {
        "trunk": _trunk_case(8, 0, (4, 12, 12, 16), "pp=4", None, 1),
        "ragged": _trunk_case(5, 1, (2, 8, 8, 16), "pp=4", 2, 2),
        "dp_pp": _trunk_case(8, 2, (8, 8, 8, 16), "dp=2,pp=2", 2, 3),
        "pp_tp": _trunk_case(8, 4, (4, 10, 10, 16), "pp=2,tp=2", None, 4),
        "dp_pp_tp": _trunk_case(4, 5, (4, 8, 8, 16), "dp=2,pp=2,tp=1", 2, 5),
        "full_model": {"params": _init(4, 2), "mesh": "pp=4",
                       "x": rng.random((4, 10, 10, 3)).astype(np.float32)},
        "tp_forward": {"params": _init(2, 3), "mesh": "tp=4",
                       "x": rng.random((2, 12, 12, 3)).astype(np.float32)},
        "tp_step": _step_case(2, "tp=4", 8),
        "fsdp": _step_case(2, "dp=2,tp=2", 9),
        "pp_step": _step_case(4, "pp=4", 10),
    }


@pytest.fixture(scope="module")
def launched(cases):
    """One spawn of four ranks for the module, running in the background."""
    return launch_async(pp_tp_program, build_mesh("dp=4", device="cpu"),
                        (cases,))


def _jax_run(c, make_step, steps):
    """JAX's step from ``make_step(config)`` on the case's params (Adam's
    state at its init) and batch → (params, loss); ``steps`` caches the
    jitted step per config."""
    from s2sr_tpu.training.train import TrainConfig

    key = (make_step, tuple(sorted(c["config"].items())))
    if key not in steps:
        steps[key] = make_step(TrainConfig(**c["config"]))
    step, tx = steps[key]
    params = jax.tree.map(jnp.asarray, c["params"])
    p, _, loss = step(params, tx.init(params), jnp.asarray(c["lr"]),
                      jnp.asarray(c["hr"]))
    return p, float(loss)


@pytest.fixture(scope="module")
def jax_side(cases, launched):
    """JAX's result for every case, computed while the ranks run; each
    function under jit (one compile, no eager dispatch of every op)."""
    from s2sr_tpu.parallel.pipeline import make_pp_train_step
    from s2sr_tpu.training.train import make_train_step

    out = {}
    for name in ("trunk", "ragged", "dp_pp", "pp_tp", "dp_pp_tp"):
        c, jmesh = cases[name], _jmesh_of(cases[name]["mesh"])
        out[name] = np.asarray(jax.jit(lambda b, f: pipeline_trunk_apply(
            b, f, jmesh, num_micro=c["num_micro"], dtype=jnp.float32))(
            jax.tree.map(jnp.asarray, c["body"]), jnp.asarray(c["feat"])))
    c, pp4 = cases["full_model"], _jmesh((4,), ("pp",))
    out["full_model"] = np.asarray(jax.jit(
        lambda p, v: rrdbnet_pipeline_apply(p, v, pp4, dtype=jnp.float32,
                                            scale=4))(
        jax.tree.map(jnp.asarray, c["params"]), jnp.asarray(c["x"])))
    c = cases["tp_forward"]
    jmesh = _jmesh((4,), ("tp",))
    sharded = shard_tree(jax.tree.map(jnp.asarray, c["params"]), jmesh)
    out["tp_forward_spec"] = sharded["conv_first"]["kernel"].sharding.spec
    out["tp_forward"] = np.asarray(jax.jit(lambda p, v: rrdbnet_apply(
        p, v, scale=2, dtype=jnp.float32))(sharded, jnp.asarray(c["x"])))
    steps = {}
    for name in ("tp_step", "fsdp", "pp_step"):
        out[name] = _jax_run(cases[name], make_train_step, steps)
    out["pp_step_pp"] = _jax_run(
        cases["pp_step"], lambda cfg: make_pp_train_step(cfg, pp4), steps)
    return out


@pytest.fixture(scope="module")
def port(launched, jax_side):
    """Every rank's results."""
    return launched.result()


def _check_trunk(port, jax_side, name):
    """The port's pipeline against its sequential trunk, and against
    JAX's pipeline on the same mesh shape (which
    ``tests/test_parallel_pp_tp.py`` holds to JAX's sequential trunk)."""
    got, jgot = port[0][name], jax_side[name]
    np.testing.assert_allclose(got["got"], got["sequential"], atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got["got"], jgot, atol=1e-5, rtol=0)
    for r in port[1:]:                         # replicated on every rank
        np.testing.assert_array_equal(r[name]["got"], got["got"])


def test_pipeline_trunk_matches_sequential(port, jax_side):
    """4-stage pipeline over 8 blocks == the sequential trunk."""
    _check_trunk(port, jax_side, "trunk")


def test_pipeline_ragged_blocks_pad_identity(port, cases, jax_side):
    """5 blocks over 4 stages: the padded slots are masked by position (a
    zero-weight RRDB is x·0.2 + x, not an identity)."""
    staged, counts = ppipe._pad_body_to_stages(
        tree_to_torch(cases["ragged"]["body"]), 4)
    assert counts == [2, 2, 1, 0]
    assert tuple(staged["rdb1"]["conv1"]["kernel"].shape[:2]) == (4, 2)
    _check_trunk(port, jax_side, "ragged")


def test_pipeline_full_model_matches_apply(port, jax_side):
    got, jgot = port[0]["full_model"], jax_side["full_model"]
    assert got["got"].shape == jgot.shape == (4, 40, 40, 3)
    np.testing.assert_allclose(got["got"], got["apply"], atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got["got"], jgot, atol=1e-5, rtol=0)


def test_tp_sharded_forward_matches_replicated(port, jax_side):
    """Output-channel slices over tp=4: each rank holds 1/4 of each
    divisible leaf; the gathered forward equals the replicated one."""
    assert jax_side["tp_forward_spec"] == (None, None, None, "tp")
    jgot = jax_side["tp_forward"]
    for r in port:
        got = r["tp_forward"]
        assert got["local_shape"] == (3, 3, 3, 4)          # 16 / 4
        assert got["last_local_shape"] == (3, 3, 16, 3)    # 3 % 4: replicated
        np.testing.assert_allclose(got["got"], got["replicated"], atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(got["got"], jgot, atol=1e-5, rtol=0)


def _check_step(got, jax_step):
    jp, jl = jax_step
    assert got["loss"] == pytest.approx(got["ref_loss"], abs=1e-6)
    assert max_diff(got["ref_params"], tree_to_torch(got["params"])) <= 1e-5
    assert rel(got["loss"], jl) <= 1e-6
    assert max_diff(jp, tree_to_torch(got["params"])) <= 1e-5


def test_tp_train_step_with_sharded_params_and_opt_state(port, jax_side):
    """tp-sliced params AND Adam mu/nu: one step runs, the loss is
    finite and the updated params keep their slices."""
    for r in port:
        got = r["tp_step"]
        assert np.isfinite(got["loss"])
        assert got["shapes"]["p"] == got["shapes"]["mu"] == (3, 3, 3, 4)
    _check_step(port[0]["tp_step"], jax_side["tp_step"])


def test_pipeline_composes_with_dp(port, jax_side):
    """dp×pp: the trunk pipelines over pp while each microbatch splits
    over dp."""
    _check_trunk(port, jax_side, "dp_pp")


def test_pipeline_dp_rejects_indivisible_microbatch(cases):
    body = cases["trunk"]["body"]
    feat = np.zeros((3, 8, 8, 16), np.float32)
    with pytest.raises(ValueError, match="not divisible by dp"):
        pipeline_trunk_apply(jax.tree.map(jnp.asarray, body),
                             jnp.asarray(feat), _jmesh((2, 2), ("dp", "pp")),
                             num_micro=3, dtype=jnp.float32)
    import torch

    with pytest.raises(ValueError, match="not divisible by dp"):
        ppipe.pipeline_trunk_apply(tree_to_torch(body), torch.zeros(3, 8, 8,
                                                                    16),
                                   build_mesh("dp=2,pp=2", device="cpu"),
                                   num_micro=3)


def test_pipeline_tp_weight_sharding_matches_sequential(port, jax_side):
    """pp×tp: stage weights stored in tp slices and gathered per stage."""
    for r in port:                  # 8 blocks / 2 stages; 16 channels / 2
        assert r["pp_tp"]["stored_shape"] == (4, 3, 3, 48, 8)
    _check_trunk(port, jax_side, "pp_tp")


def test_pipeline_3d_dp_pp_tp_matches_sequential(port, jax_side):
    """Batch over dp, depth over pp, weights over tp on one 3-axis mesh."""
    for r in port:                  # 4 blocks / 2 stages; tp=1 keeps all
        assert r["dp_pp_tp"]["stored_shape"] == (2, 3, 3, 48, 16)
    _check_trunk(port, jax_side, "dp_pp_tp")


def test_pp_train_step_matches_sequential_step(port, jax_side):
    """One step through the pipelined forward (the backward runs back
    through the ring) gives the sequential step's loss and params."""
    got = port[0]["pp_step"]
    _check_step(got, jax_side["pp_step"])
    jp, jl = jax_side["pp_step_pp"]
    assert rel(got["loss"], jl) <= 1e-6
    assert max_diff(jp, tree_to_torch(got["params"])) <= 1e-5
    for r in port[1:]:
        assert r["pp_step"]["loss"] == got["loss"]


def test_pp_train_step_rejects_non_rrdb_family():
    from s2sr_tpu.parallel.pipeline import make_pp_train_step
    from s2sr_tpu.training.train import TrainConfig

    with pytest.raises(ValueError, match="rrdbnet"):
        make_pp_train_step(TrainConfig(family="swinir"),
                           _jmesh((4,), ("pp",)))
    with pytest.raises(ValueError, match="rrdbnet"):
        ppipe.make_pp_train_step(pt.TrainConfig(family="swinir"),
                                 build_mesh("pp=4", device="cpu"))


def test_fsdp_dp_tp_step_matches_unsharded(port, jax_side):
    """dp×tp: batch over dp, weights and Adam moments over tp; one step
    gives the unsharded step's params and loss, and params and mu stay
    sliced on every rank."""
    for r in port:
        got = r["fsdp"]["shapes"]
        assert got["p"] == got["mu"] == got["nu"] == (3, 3, 3, 8)
        assert got["conv_last"] == (3, 3, 16, 3)
    _check_step(port[0]["fsdp"], jax_side["fsdp"])
