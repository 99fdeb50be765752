"""The port's device mesh and multi-device serving against the JAX
package's: ``parallel/mesh.py`` (specs, device grids, the shardings'
specs, the ``sp`` groups), ``parallel/tiling.py::tiled_apply`` over a
``dp`` mesh against JAX's over ``build_mesh("dp=8")``
(``tests/test_tiling.py``'s sharded tests), and ``SREngine`` /
``get_engine`` with a mesh of two CPU devices against JAX's mesh engine
over two, RRDBNet and SwinIR.

Serving runs in this process: one model replica per ``dp`` device, whole
chunks each, so the mesh's output equals the one-device output byte for
byte. Against JAX: the tiling's float output within 1e-6, the engines'
uint8 output at ``tests/test_torch_engine.py``'s bound (|diff| ≤ 1 on at
most 0.1% of the bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2sr_tpu.models import engine as jax_engine_mod
from s2sr_tpu.models import registry as jax_registry
from s2sr_tpu.models.weights import save_params
from s2sr_tpu.parallel import mesh as jax_mesh_mod
from s2sr_tpu.parallel import tiled_apply as jax_tiled_apply
from s2sr_tpu.training import train as jt
from s2sr_tpu_torch.models import engine as engine_mod
from s2sr_tpu_torch.models import registry
from s2sr_tpu_torch.parallel import mesh as mesh_mod
from s2sr_tpu_torch.parallel.tiling import tiled_apply
from s2sr_tpu_torch.training import train as pt

from test_tiling import mock_model_jax
from test_torch_engine import TINY, assert_bytes_close, jax_tree_one_block
from test_torch_swinir import DEPTHS, DIM, HEADS, WIN, jax_tree
from torch_threads import one_torch_thread  # noqa: F401


def test_build_mesh_and_shardings_match_jax():
    m = mesh_mod.build_mesh("dp=2,pp=2", device="cpu")
    assert m.axis_names == ("dp", "pp") and m.shape == (2, 2)
    assert m.devices == (torch.device("cpu"),) * 4 and m.size == 4
    assert m.rank_of({"dp": 1, "pp": 1}) == 3 and m.rank_of({"dp": 1}) == 2
    assert m.axis_devices("dp") == (torch.device("cpu"),) * 2
    assert m.axis_size("tp") == 1
    assert mesh_mod.build_mesh("", device="cpu").shape == (1,)
    two = [torch.device("cpu"), torch.device("cpu")]
    assert mesh_mod.build_mesh("", devices=two).shape == (2,)
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        mesh_mod.build_mesh("dp=4", devices=two)
    for spec in ("dp=8", "dp=4,sp=2", "pp=2,tp=4"):
        jm = jax_mesh_mod.build_mesh(spec)
        pm = mesh_mod.build_mesh(spec, device="cpu")
        assert jm.axis_names == pm.axis_names
        assert tuple(jax_mesh_mod.window_sharding(jm).spec) == \
            mesh_mod.window_sharding(pm).spec
        assert tuple(jax_mesh_mod.replicated(jm).spec) == \
            mesh_mod.replicated(pm).spec
        assert pt.batch_sharding(pm).spec == tuple(
            jt.batch_sharding(jm).spec)
    assert mesh_mod.window_sharding(None) is None
    assert mesh_mod.replicated(None) is None


def test_sp_mesh_groups_and_coords_match_jax():
    """An sp mesh: JAX's axis names and shape; each dp replica's sp group
    in row-major order; every device's coordinates."""
    jm = jax_mesh_mod.build_mesh("dp=2,sp=2")
    devs = [torch.device(f"cuda:{i}") for i in range(4)]
    m = mesh_mod.build_mesh("dp=2,sp=2", devices=devs)
    assert m.axis_names == jm.axis_names == ("dp", "sp")
    assert m.shape == tuple(jm.devices.shape) == (2, 2)
    assert m.sp_group(0) == tuple(devs[:2]) and m.sp_group(1) == tuple(
        devs[2:])
    # JAX's grid: dp replica i holds devices 2i, 2i+1 along sp
    assert [[d.id for d in row] for row in jm.devices] == [[0, 1], [2, 3]]
    assert [[m.rank_of({"dp": i, "sp": j}) for j in range(2)]
            for i in range(2)] == [[d.id for d in row] for row in jm.devices]
    assert m.axis_devices("dp") == (devs[0], devs[2])
    one = mesh_mod.Mesh(("sp",), (2,), (torch.device("cpu"),) * 2)
    assert one.sp_group() == (torch.device("cpu"),) * 2
    assert mesh_mod.build_mesh("dp=2,sp=1", device="cpu").sp_group(1) == (
        torch.device("cpu"),)


def test_tiled_apply_sharded_matches_jax():
    """dp=2 replicas, whole chunks round-robin: equal to one device and
    to JAX's tiling sharded over dp=8."""
    img = np.random.default_rng(0).random((96, 96, 3)).astype(np.float32)
    want = np.asarray(jax_tiled_apply(
        lambda b: mock_model_jax(b, 2), jnp.asarray(img), tile=32, pad=4,
        scale=2, batch_size=8, mesh=jax_mesh_mod.build_mesh("dp=8")))
    calls = [0, 0]

    def replica(i):
        def fn(b):
            calls[i] += 1
            return torch.from_numpy(np.array(mock_model_jax(
                jnp.asarray(b.numpy()), 2)))
        return fn

    mesh = mesh_mod.build_mesh("dp=2", device="cpu")
    x = torch.from_numpy(img)
    got = tiled_apply([replica(0), replica(1)], x, tile=32, pad=4, scale=2,
                      batch_size=2, mesh=mesh)
    one = tiled_apply(replica(0), x, tile=32, pad=4, scale=2, batch_size=2)
    # 9 windows, 5 chunks of 2: chunks 0, 2, 4 on replica 0, 1 and 3 on
    # replica 1; then 5 on the one-device run
    assert calls == [3 + 5, 2]
    assert torch.equal(got, one)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(ValueError, match="3 model functions for 2"):
        tiled_apply([replica(0)] * 3, x, tile=32, pad=4, scale=2, mesh=mesh)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A one-block RRDBNet and a small SwinIR in both registries, one
    ``.npz`` each for both packages."""
    d = tmp_path_factory.mktemp("weights")
    save_params(jax_tree_one_block(np.random.default_rng(0)),
                d / "rrdb_tiny.npz")
    save_params(jax_tree(2, seed=1), d / "swinir_tiny.npz")
    swin = {"family": "swinir", "scale": 2, "embed_dim": DIM,
            "depths": DEPTHS, "num_heads": HEADS, "window_size": WIN,
            "description": "test"}
    for reg in (jax_registry.MODELS, registry.MODELS):
        reg["rrdb_tiny"] = dict(TINY)
        reg["swinir_tiny"] = dict(swin)
    yield d
    for reg in (jax_registry.MODELS, registry.MODELS):
        reg.pop("rrdb_tiny", None)
        reg.pop("swinir_tiny", None)


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("model, kw, shape", [
    ("rrdb_tiny", dict(tile_size=32, tile_pad=10, batch_size=2,
                       pad_probe=False), (72, 64)),
    ("swinir_tiny", dict(tile_size=16, exact_area=0, batch_size=4),
     (52, 48)),
])
def test_engine_sharded_matches_unsharded_and_jax(tiny, model, kw, shape):
    """An engine over dp=2 CPU replicas gives the one-device engine's
    bytes, tiled path and serving path, with both replicas used, and JAX's
    mesh engine's on the same shape (dp=2). The SwinIR replicas keep the swin_block path that
    JAX's mesh engine turns off (a Pallas custom call GSPMD cannot
    split): held to JAX's at the SwinIR engine tests' bound."""
    kw = dict(kw, weights_dir=tiny, dtype="float32")
    img = _image(shape, 3)
    mesh = mesh_mod.build_mesh("dp=2", device="cpu")
    eng = engine_mod.SREngine(model, device="cpu", mesh=mesh, **kw)
    assert eng._serving_parts(img)[1]["kind"] == "tiled"
    one = engine_mod.SREngine(model, device="cpu", **kw)
    got = eng.enhance(img)
    assert np.array_equal(got, one.enhance(img))
    assert min(eng.replica_forwards) > 0
    before = list(eng.replica_forwards)
    served = eng.enhance_serving(img)
    assert np.array_equal(served, one.enhance_serving(img))
    assert all(a > b for a, b in zip(eng.replica_forwards, before))
    jeng = jax_engine_mod.SREngine(model, mesh=jax_mesh_mod.build_mesh(
        "dp=2"), **kw)
    assert_bytes_close(got, jeng.enhance(img))


def test_get_engine_mesh_shape(tiny, monkeypatch):
    """``Settings.mesh_shape`` builds the mesh on the engine's device; the
    mesh is part of the cache key; below the engage area the image runs
    whole on the first device."""
    from s2sr_tpu_torch.config import settings as settings_mod

    monkeypatch.setenv("MESH_SHAPE", "dp=2")
    settings_mod.get_settings.cache_clear()
    try:
        eng = engine_mod.get_engine("rrdb_tiny", weights_dir=str(tiny),
                                    dtype="float32", device="cpu",
                                    tile_size=32, pad_probe=False)
        assert eng.mesh.shape == (2,) and len(eng.replicas) == 2
        assert engine_mod.get_engine(
            "rrdb_tiny", weights_dir=str(tiny), dtype="float32",
            device="cpu", tile_size=32, pad_probe=False) is eng
        eng.enhance(_image((8, 8), 1))
        assert eng.replica_forwards == [1, 0]
        plain = engine_mod.get_engine(
            "rrdb_tiny", weights_dir=str(tiny), dtype="float32",
            device="cpu", tile_size=32, pad_probe=False,
            mesh=mesh_mod.build_mesh("dp=1", device="cpu"))
        assert plain is not eng and len(plain.replicas) == 1
    finally:
        monkeypatch.delenv("MESH_SHAPE")
        settings_mod.get_settings.cache_clear()
