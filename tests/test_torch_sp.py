"""The ``sp`` axis of the port (H split into bands with halo exchanges:
``parallel/spatial.py``, ``parallel/comm.py::halo_exchange``) against
the JAX package's sharded functions, on the CPU.

Serving runs in this process, the bands of a replica on CPU devices:
``tiled_apply`` over ``dp=2,sp=2`` against JAX's over
``build_mesh("dp=4,sp=2")`` (``tests/test_torch_mesh.py``'s bound) and
against the port's one device (bit-equal with oneDNN off; within 1e-6
of the output's largest value with it on); the RRDBNet and SwinIR
engines over ``dp=2,sp=2`` on windows of an odd height (uneven bands)
against one device (byte-equal) and against JAX's mesh engine at
``assert_bytes_close``, and below the engage area (``enhance`` whole on
the first device); the int8 engine over ``sp=2`` against its one
device; the Swin block's plain version on rolled bands against the whole
image.

Training runs in one spawn of four gloo ranks
(``tests/torch_mesh_ranks.py::sp_program``): the float64 halo gradient
against the unsharded conv chain's; the L1 step (even and uneven
bands), the chunked step (K = 2), SwinIR at ``h = w = 8`` and a GAN step
over ``dp=2,sp=2``, and FSDP over ``dp=1,sp=2,tp=2``, each against JAX's
sharded step (FSDP: JAX's unsharded step, which JAX's own FSDP over that
mesh misses by 5.4e-4 on the CPU) and the port's one-device step at
``tests/test_training.py``'s tolerances (loss rel 1e-5; params atol 1e-5
and rtol 1e-4, SwinIR rtol 1e-5 and atol 1e-6; the GAN at
``tests/test_torch_gan.py``'s). JAX runs on the conftest's virtual CPU
devices while the ranks run. Then ``cli.train --mesh dp=1,sp=2`` against
the one-device CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from s2sr_tpu.models import engine as jax_engine_mod
from s2sr_tpu.parallel import mesh as jax_mesh_mod
from s2sr_tpu.parallel import tiled_apply as jax_tiled_apply
from s2sr_tpu.training import gan as jg
from s2sr_tpu.training import train as jt
from s2sr_tpu_torch.models import engine as engine_mod
from s2sr_tpu_torch.models.weights import tree_to_torch
from s2sr_tpu_torch.ops import window_attention as wa
from s2sr_tpu_torch.parallel import spatial
from s2sr_tpu_torch.parallel.mesh import build_mesh
from s2sr_tpu_torch.parallel.tiling import tiled_apply

from test_tiling import mock_model_jax
from test_torch_engine import assert_bytes_close
from test_torch_gan import METRICS, RRDB, assert_disc_close, gan_states, \
    leaf_rel
from test_torch_mesh import _image, tiny  # noqa: F401  (fixture)
from test_torch_train import jax_state, max_diff, np_tree, rel
from torch_mesh_ranks import launch_async, sp_program
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(num_feat=8, num_block=1, num_grow_ch=4, scale=2,
            dtype="float32", learning_rate=1e-3)
SWIN = dict(family="swinir", embed_dim=16, depths=(1, 1), heads=(2, 2),
            window=4, scale=2, dtype="float32", learning_rate=1e-3)
FSDP = dict(num_feat=16, num_block=2, num_grow_ch=8, scale=2,
            dtype="float32")


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _batch(n, h, seed, s=2):
    rng = np.random.default_rng(seed)
    return (rng.random((n, h, h, 3), dtype=np.float32),
            rng.random((n, h * s, h * s, 3), dtype=np.float32))


# --- the band plan and the in-process exchange ------------------------------

def test_band_bounds():
    """Even as they go, in units; leftover rows join the last band; too
    few units for the bands are refused."""
    assert spatial.band_bounds(264, 2) == ((0, 132), (132, 264))
    assert spatial.band_bounds(13, 2) == ((0, 7), (7, 13))
    assert spatial.band_bounds(10, 3) == ((0, 4), (4, 7), (7, 10))
    assert spatial.band_bounds(288, 2, 8) == ((0, 144), (144, 288))
    assert spatial.band_bounds(52, 2, 4) == ((0, 28), (28, 52))
    assert spatial.band_bounds(45, 2, 4) == ((0, 24), (24, 45))
    assert spatial.band_bounds(24, 2, 8) == ((0, 16), (16, 24))
    with pytest.raises(ValueError, match="too few"):
        spatial.band_bounds(7, 2, 4)
    x = torch.arange(10.0).reshape(1, 10, 1)
    parts = spatial.split(x, spatial.band_bounds(10, 3), ["cpu"] * 3)
    ext, top, bot = spatial.extend(parts, 1, 5)
    assert (top, bot) == (4, 3) and ext.flatten().tolist() == list(range(10))
    assert torch.equal(spatial.gather(spatial.roll_up(parts, 2), "cpu"),
                       torch.roll(x, -2, 1))
    assert torch.equal(spatial.gather(spatial.roll_down(parts, 2), "cpu"),
                       torch.roll(x, 2, 1))


def _torch_mock(b: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """``mock_model_jax`` in torch: a 3×3 box filter (zero padding, a
    depthwise conv) and a nearest ×scale."""
    c = b.shape[-1]
    k = torch.full((c, 1, 3, 3), 1.0 / 9.0)
    acc = F.conv2d(b.permute(0, 3, 1, 2), k, padding=1, groups=c)
    acc = acc.permute(0, 2, 3, 1)
    return acc.repeat_interleave(scale, 1).repeat_interleave(scale, 2)


def test_tiled_apply_dp_sp_matches_jax():
    """dp=2 replicas of sp=2 bands (the CPU named four times): chunks
    round-robin, each chunk's windows split over H, a 1-row halo for the
    box filter. Equal to JAX's tiling over dp=4,sp=2 within 1e-6, and to
    the port's one device: bit-equal with oneDNN off, within 1e-6 of the
    output's largest value with it on."""
    img = np.random.default_rng(0).random((96, 96, 3)).astype(np.float32)
    want = np.asarray(jax_tiled_apply(
        lambda b: mock_model_jax(b, 2), jnp.asarray(img), tile=32, pad=5,
        scale=2, batch_size=8, mesh=jax_mesh_mod.build_mesh("dp=4,sp=2")))
    calls = [0, 0]
    seen = []

    def replica(i):
        def fn(bands):
            calls[i] += 1
            seen.append([tuple(b.shape) for b in bands])
            return spatial.halo_apply(lambda t, j: _torch_mock(t), bands, 1,
                                      scale=2)
        return fn

    mesh = build_mesh("dp=2,sp=2", device="cpu")
    x = torch.from_numpy(img)
    kw = dict(tile=32, pad=5, scale=2, batch_size=2)
    got = tiled_apply([replica(0), replica(1)], x, mesh=mesh, **kw)
    one = tiled_apply(_torch_mock, x, **kw)
    assert calls == [3, 2]
    # windows of 42 rows: two bands of 21
    assert seen[0] == [(2, 21, 42, 3), (2, 21, 42, 3)]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert float((got - one).abs().max()) <= 1e-6 * float(one.abs().max())
    with torch.backends.mkldnn.flags(enabled=False):
        got = tiled_apply([replica(0), replica(1)], x, mesh=mesh, **kw)
        one = tiled_apply(_torch_mock, x, **kw)
    assert torch.equal(got, one)


# --- serving -----------------------------------------------------------------

ENGINES = [
    # windows of 51 rows: bands of 26 and 25
    ("rrdb_tiny", dict(tile_size=31, tile_pad=10, batch_size=2,
                       pad_probe=False), (72, 64)),
    # windows of 52 rows, 13 window rows: bands of 28 and 24
    ("swinir_tiny", dict(tile_size=20, exact_area=0, batch_size=4),
     (60, 56)),
]


@pytest.mark.parametrize("model, kw, shape", ENGINES)
def test_engine_dp_sp_matches_one_device_and_jax(tiny, model, kw, shape):
    """An engine over dp=2,sp=2 (four CPU devices): the tiled path and the
    serving path give the one-device engine's bytes, both replicas used;
    and JAX's mesh engine's over dp=2,sp=2 at ``assert_bytes_close``.
    RRDBNet's serving path also takes a bucketed small image through
    masked bands."""
    kw = dict(kw, weights_dir=tiny, dtype="float32")
    img = _image(shape, 3)
    mesh = build_mesh("dp=2,sp=2", device="cpu")
    eng = engine_mod.SREngine(model, device="cpu", mesh=mesh, **kw)
    assert [len(g) for g in eng.replica_groups] == [2, 2]
    one = engine_mod.SREngine(model, device="cpu", **kw)
    got = eng.enhance(img)
    assert np.array_equal(got, one.enhance(img))
    assert min(eng.replica_forwards) > 0
    assert np.array_equal(eng.enhance_serving(img), one.enhance_serving(img))
    if model == "rrdb_tiny":
        small = _image((20, 30), 4)
        assert np.array_equal(eng.enhance_serving(small),
                              one.enhance_serving(small))
    jeng = jax_engine_mod.SREngine(model, mesh=jax_mesh_mod.build_mesh(
        "dp=2,sp=2"), **kw)
    assert_bytes_close(got, jeng.enhance(img))


@pytest.mark.parametrize("model, kw, shape", [
    ("rrdb_tiny", dict(tile_size=31, tile_pad=10, batch_size=2,
                       pad_probe=False), (20, 30)),
    # the default exact area (SWINIR_EXACT_AREA): nearly every request
    ("swinir_tiny", dict(tile_size=20, batch_size=4), (30, 26)),
])
def test_engine_dp_sp_below_engage_area(tiny, model, kw, shape):
    """Over dp=2,sp=2, ``enhance`` of an image below the engage area runs
    it whole on the mesh's first device, and ``enhance_serving`` gives the
    one-device bytes too (RRDBNet's bucket in masked bands, SwinIR's exact
    path whole): two forwards, both on replica 0."""
    kw = dict(kw, weights_dir=tiny, dtype="float32")
    img = _image(shape, 6)
    eng = engine_mod.SREngine(model, device="cpu", mesh=build_mesh(
        "dp=2,sp=2", device="cpu"), **kw)
    one = engine_mod.SREngine(model, device="cpu", **kw)
    assert shape[0] * shape[1] <= eng.engage_area
    assert np.array_equal(eng.enhance(img), one.enhance(img))
    assert np.array_equal(eng.enhance_serving(img), one.enhance_serving(img))
    assert eng.replica_forwards == [2, 0]


def test_int8_engine_sp_matches_one_device(tiny):
    """The int8-mixed engine over sp=2: every residual dense block's int8
    instance on its 5-row extended band; the tiled and the serving path
    against the one-device int8 engine (the CPU's bf16 convs round by
    shape, so at ``assert_bytes_close``)."""
    kw = dict(weights_dir=tiny, dtype="int8", tile_size=31, tile_pad=10,
              batch_size=2, pad_probe=False, device="cpu")
    eng = engine_mod.SREngine("rrdb_tiny", mesh=build_mesh(
        "sp=2", device="cpu"), **kw)
    one = engine_mod.SREngine("rrdb_tiny", **kw)
    assert eng.quantized and eng.precision == "int8"
    img = _image((72, 64), 5)
    assert_bytes_close(eng.enhance(img), one.enhance(img))
    assert_bytes_close(eng.enhance_serving(img), one.enhance_serving(img))
    assert eng.replica_forwards[0] > 0


@pytest.mark.parametrize("mlp", [True, False])
@pytest.mark.parametrize("nb", [2, 3])
def test_swin_block_reference_on_bands(mlp, nb):
    """A shifted block on rolled bands (``rolled=True``, ``last`` on the
    last band) equals the whole image's, unrolled again; the unshifted
    block needs no roll."""
    from test_torch_window_attention import jax_block, tables

    heads, win, c = 2, 4, 12
    for shift in (0, win // 2):
        t = tables(jax_block(shift, c=c, heads=heads, win=win, hidden=24),
                   shift, heads=heads, win=win)
        x = torch.randn(2, 28, 12, c, generator=torch.Generator()
                        .manual_seed(nb))
        fn = wa.swin_block_reference if mlp else wa.window_attention_reference
        want = fn(x, t)
        parts = spatial.split(x, spatial.band_bounds(28, nb, win),
                              ["cpu"] * nb)
        if shift:
            parts = spatial.roll_up(parts, shift)
        outs = [fn(p, t, rolled=bool(shift), last=j == nb - 1)
                for j, p in enumerate(parts)]
        if shift:
            outs = spatial.roll_down(outs, shift)
        got = spatial.gather(outs, "cpu")
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max()), shift
    # the band's last row is not the image's: other masks
    assert not torch.equal(fn(x, t, rolled=True, last=False),
                           fn(x, t, rolled=True, last=True))


# --- training over ranks -----------------------------------------------------

@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(4)
    out = {"halo": {"x": rng.random((2, 3, 11, 6)),
                    "ws": [rng.normal(size=(4, 3, 3, 3)),
                           rng.normal(size=(2, 4, 3, 3))],
                    "r": rng.random((2, 2, 11, 6))}}
    tiny = np_tree(jax_state(jt.TrainConfig(**TINY))[0])
    for name, (n, h) in (("l1", (8, 16)), ("l1_odd", (4, 13))):
        lr, hr = _batch(n, h, 1)
        out[name] = {"config": TINY, "lr": lr, "hr": hr, "params": tiny}
    # tests/test_training.py::test_swinir_sharded_matches_unsharded's case:
    # JAX's init and _data(batch=4, h=8, w=8)
    lr, hr = _batch(4, 8, 0)
    out["swinir"] = {"config": SWIN, "lr": lr, "hr": hr, "params": np_tree(
        jt.init_training(jt.TrainConfig(**SWIN))[0])}
    chunks = [_batch(4, 8, s) for s in range(2)]
    out["chunked"] = {"config": TINY, "params": out["l1"]["params"],
                      "lr": np.stack([c[0] for c in chunks]),
                      "hr": np.stack([c[1] for c in chunks])}
    lr, hr = _batch(4, 8, 9)
    out["fsdp"] = {"config": FSDP, "mesh": "dp=1,sp=2,tp=2", "lr": lr,
                   "hr": hr,
                   "params": np_tree(jax_state(jt.TrainConfig(**FSDP))[0])}
    hr = rng.random((4, 32, 32, 3), dtype=np.float32)
    states = gan_states(jt.TrainConfig(**RRDB), 8)[0]
    jp, _, jd, _ = states
    out["gan"] = {"config": RRDB, "num_feat_d": 8, "g": np_tree(jp),
                  "d": np_tree(jd), "hr": hr,
                  "lr": hr.reshape(4, 16, 2, 16, 2, 3).mean((2, 4)),
                  "jax": states}
    return out


@pytest.fixture(scope="module")
def launched(cases):
    """One spawn of four ranks for the module, running in the background
    (JAX's states stay here)."""
    sent = {k: {kk: vv for kk, vv in v.items() if kk != "jax"}
            for k, v in cases.items()}
    return launch_async(sp_program, build_mesh("dp=4", device="cpu"),
                        (sent,))


def _sharded(mesh, *arrays):
    bsh = jt.batch_sharding(mesh)
    return [jax.device_put(a, bsh) for a in arrays]


@pytest.fixture(scope="module")
def jax_side(cases, launched):
    """JAX's sharded steps over dp=2,sp=2 (FSDP over dp=1,sp=2,tp=2), run
    while the ranks run."""
    mesh = _jmesh((2, 2), ("dp", "sp"))
    repl = NamedSharding(mesh, P())
    out = {}
    for name in ("l1", "swinir"):
        c = cases[name]
        step, tx = jt.make_train_step(jt.TrainConfig(**c["config"]), mesh)
        params = jax.tree.map(jnp.asarray, c["params"])
        p, _, loss = step(jax.device_put(params, repl),
                          jax.device_put(tx.init(params), repl),
                          *_sharded(mesh, c["lr"], c["hr"]))
        out[name] = (p, float(loss))
    c = cases["chunked"]
    run, tx = jt.make_chunked_train_step(jt.TrainConfig(**c["config"]),
                                         mesh=mesh)
    params = jax.tree.map(jnp.asarray, c["params"])
    out["chunked"] = run(params, tx.init(params), c["lr"], c["hr"])
    # FSDP against JAX's unsharded step: JAX's own FSDP step over
    # dp=1,sp=2,tp=2 on these virtual CPU devices is 5.4e-4 (relative)
    # from its unsharded loss, while over sp=2 or tp=2 alone it is exact
    c = cases["fsdp"]
    step, tx = jt.make_train_step(jt.TrainConfig(**c["config"]))
    params = jax.tree.map(jnp.asarray, c["params"])
    p, _, loss = step(params, tx.init(params), c["lr"], c["hr"])
    out["fsdp"] = (p, float(loss))
    c = cases["gan"]
    jcfg = jt.TrainConfig(**c["config"])
    jp, jo, jd, jdo = c["jax"]
    jstep = jg.make_gan_train_step(jg.GanConfig(base=jcfg, num_feat_d=8),
                                   mesh)[0]
    out["gan"] = (jd, jstep(jp, jd, jo, jdo,
                            *_sharded(mesh, c["lr"], c["hr"])))
    return out


@pytest.fixture(scope="module")
def port(launched, jax_side):
    """Every rank's results."""
    return launched.result()


def _params_close(a, b, atol=1e-5, rtol=1e-4):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(x, y, atol=atol, rtol=rtol)


def test_halo_exchange_gradient_float64(port):
    """Two convs with a 1-row halo each over sp=2 (bands of 6 and 5 rows
    of 11): the band's forward and its input's gradient are the whole
    chain's rows, and the weights' gradients summed over the bands are
    the whole chain's, in float64."""
    bands = sorted({r["halo"]["band"] for r in port})
    assert bands == [(0, 6), (6, 11)]
    for r in port:
        h = r["halo"]
        np.testing.assert_allclose(h["y"], h["y_one"], rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(h["gx"], h["gx_one"], rtol=1e-12,
                                   atol=1e-12)
        for a, b in zip(h["gw"], h["gw_one"]):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["l1", "swinir"])
def test_train_step_dp_sp_matches_unsharded_and_jax(port, jax_side, name):
    """``make_train_step`` over dp=2,sp=2: every rank ends with the
    one-device step's params and loss, and with JAX's sharded step's."""
    atol, rtol = (1e-6, 1e-5) if name == "swinir" else (1e-5, 1e-4)
    got = port[0][name]
    assert got["mesh"]["loss"] == pytest.approx(got["one"]["loss"], rel=1e-5)
    _params_close(got["mesh"]["params"], got["one"]["params"], atol, rtol)
    for r in port[1:]:
        for a, b in zip(jax.tree.leaves(got["mesh"]["params"]),
                        jax.tree.leaves(r[name]["mesh"]["params"])):
            np.testing.assert_array_equal(a, b)
    jp, jl = jax_side[name]
    assert rel(got["mesh"]["loss"], jl) <= 1e-5
    assert max_diff(jp, tree_to_torch(got["mesh"]["params"])) <= 1e-5


def test_train_step_uneven_bands(port):
    """LR crops of 13 rows: bands of 7 and 6 (HR 14 and 12), the loss
    weighted by each band's pixels, equal to the one-device step."""
    got = port[0]["l1_odd"]
    assert got["mesh"]["loss"] == pytest.approx(got["one"]["loss"], rel=1e-5)
    _params_close(got["mesh"]["params"], got["one"]["params"])


def test_chunked_step_dp_sp(port, jax_side):
    got = [r["chunked"] for r in port]
    np.testing.assert_allclose(got[0]["mesh"]["losses"],
                               got[0]["one"]["losses"], rtol=1e-5, atol=1e-7)
    _params_close(got[0]["mesh"]["params"], got[0]["one"]["params"])
    assert got[0]["mesh"]["opt"]["count"] == 2
    for r in got[1:]:
        np.testing.assert_array_equal(got[0]["mesh"]["losses"],
                                      r["mesh"]["losses"])
    jp, _, jl = jax_side["chunked"]
    assert rel(got[0]["mesh"]["losses"], np.asarray(jl)) <= 1e-5
    assert max_diff(jp, tree_to_torch(got[0]["mesh"]["params"])) <= 1e-5


def test_fsdp_dp_sp_tp_step(port, jax_side):
    """FSDP over dp=1,sp=2,tp=2: the batch's H over sp, weights and Adam
    moments over tp; the gathered params equal the one-device step's and
    JAX's unsharded step's (JAX's FSDP step over this mesh is 5.4e-4 from
    its own unsharded loss on the virtual CPU devices; over sp=2 or tp=2
    alone it equals it)."""
    got = port[0]["fsdp"]
    assert all(r["fsdp"]["mu_shape"] == (3, 3, 3, 8) for r in port)
    assert got["loss"] == pytest.approx(got["ref_loss"], rel=1e-5)
    _params_close(got["params"], got["ref_params"])
    jp, jl = jax_side["fsdp"]
    assert rel(got["loss"], jl) <= 1e-5
    assert max_diff(jp, tree_to_torch(got["params"])) <= 1e-5


def test_gan_step_dp_sp(port, cases, jax_side):
    """One G+D step over dp=2,sp=2: G and D on the rank's band (HR bands
    of 16 rows), every loss mean and the relativistic logit means over
    the global batch; against one device and JAX's sharded step, D by
    ``assert_disc_close``."""
    c = cases["gan"]
    mesh, one = port[0]["gan"]["mesh"], port[0]["gan"]["one"]
    for k in METRICS:
        assert mesh["metrics"][k] == pytest.approx(one["metrics"][k],
                                                   rel=1e-5), k
    _params_close(mesh["g"], one["g"])
    assert_disc_close(c["d"], one["d"], tree_to_torch(mesh["d"]), 1e-4)
    for r in port[1:]:
        for a, b in zip(jax.tree.leaves(mesh["d"]),
                        jax.tree.leaves(r["gan"]["mesh"]["d"])):
            np.testing.assert_array_equal(a, b)
    jd, (jp1, jd1, jo1, _, jm) = jax_side["gan"]
    for k in METRICS:
        assert rel(mesh["metrics"][k], float(jm[k])) <= 1e-5, k
    assert max(leaf_rel(jp1, tree_to_torch(mesh["g"])).values()) <= 1e-5
    assert max(leaf_rel(jt.ema_params(jo1),
                        tree_to_torch(mesh["ema"])).values()) <= 1e-5
    assert_disc_close(jd, jd1, tree_to_torch(mesh["d"]), 1e-4)


def test_cli_train_sp_matches_one_device(tmp_path):
    """``cli.train --mesh dp=1,sp=2 --backend gloo --device cpu`` (two
    ranks, each an 8-row band of the 16-row crops) logs the one-device
    run's losses; rank 0 alone writes the checkpoint."""
    from s2sr_tpu_torch.cli import train as cli

    args = ["--device", "cpu", "--blocks", "1", "--feat", "8", "--grow",
            "4", "--batch", "2", "--pool", "2", "--crop", "16", "--steps",
            "2", "--chunk", "2"]
    logs = {}
    for label, extra in (("one", []),
                         ("mesh", ["--mesh", "dp=1,sp=2", "--backend",
                                   "gloo"])):
        log = tmp_path / f"{label}.losses"
        cli.main(args + extra + ["--ckpt-dir", str(tmp_path / label),
                                 "--loss-log", str(log)])
        logs[label] = np.loadtxt(log)
    assert logs["mesh"].shape == (2,)
    np.testing.assert_allclose(logs["mesh"], logs["one"], rtol=1e-5)
    assert sorted(p.name for p in (tmp_path / "mesh").iterdir()) == ["2"]
