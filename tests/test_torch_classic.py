"""The classic SR family (EDSR, ESPCN, LapSRN) of the port against the
JAX package: the models on the same seeded weights (carried over by
``params_from_jax_classic``), the exact-padding bucket, the luma path's
cubic resize and YCrCb, the ``.pb`` converters and the GraphDef
executor on the JAX tests' in-test graphs, and the serving pipeline.

Sizes are small: EDSR with 2 blocks of 16 features, LapSRN with depth 2,
images of at most 48 px (64 where a bucket must be on the grid)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s2sr_tpu.models import classic as jclassic
from s2sr_tpu_torch.models import classic
from s2sr_tpu_torch.models.weights import params_from_jax_classic
from test_graph_executor import (GB, _edsr_wired_graph, _k,
                                 _lapsrn_wired_graph)
from test_pb_reader import _edsr_graph, _lapsrn_graph, const_node

F32_TOL = 1e-5          # of max |out|
BF16_TOL = 0.05         # EDSR bf16, of max |out|
SIZES = {"grid": (32, 48), "odd": (13, 17)}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def seeded_tree(jmodel, seed: int = 0):
    """A tree of JAX's structure (``eval_shape`` of its init: nothing is
    computed) filled from a seeded numpy generator: kernels normal ·
    sqrt(2 / fan_in), biases normal · 0.05, and LapSRN's transposed-conv
    kernels random too, so a flipped or transposed kernel shows (the
    bilinear init is symmetric)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))

    def fill(s):
        std = np.sqrt(2.0 / np.prod(s.shape[:-1])) if len(s.shape) > 1 \
            else 0.05
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return jax.tree.map(fill, shapes)


def pair(family: str, scale: int, num_ch: int = 3, dtype="float32",
         seed: int = 0):
    """(JAX model, its numpy tree, the port's model on the same weights)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if family == "edsr":
        jm = jclassic.EDSR(scale, num_feat=16, num_blocks=2, dtype=jdt)
        tm = classic.EDSR(scale, num_feat=16, num_blocks=2, dtype=tdt)
    elif family == "espcn":
        jm = jclassic.ESPCN(scale, num_ch=num_ch)
        tm = classic.ESPCN(scale, num_ch=num_ch)
    else:
        jm = jclassic.LapSRN(scale, num_feat=8, depth_per_level=2,
                             num_ch=num_ch)
        tm = classic.LapSRN(scale, num_feat=8, depth_per_level=2,
                            num_ch=num_ch)
    tree = seeded_tree(jm, seed)
    tm.load_state_dict(params_from_jax_classic(tree, family))
    return jm, tree, tm.eval()


CASES = ([("edsr", s, 3, dt) for s in (2, 3, 4)
          for dt in ("float32", "bfloat16")]
         + [("espcn", s, c, "float32") for s in (2, 3, 4) for c in (1, 3)]
         + [("lapsrn", s, c, "float32") for s in (2, 4, 8) for c in (1, 3)])


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("family,scale,num_ch,dtype", CASES)
def test_classic_model_matches_jax(family, scale, num_ch, dtype, size):
    jm, tree, tm = pair(family, scale, num_ch, dtype)
    h, w = SIZES[size]
    x = np.random.default_rng(1).random((1, h, w, num_ch)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, h * scale, w * scale, num_ch)
    assert got.dtype == np.float32
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


MASK_CASES = ([("edsr", s, 3) for s in (2, 3, 4)]
              + [("espcn", s, c) for s in (2, 3, 4) for c in (1, 3)]
              + [("lapsrn", s, c) for s in (2, 4, 8) for c in (1, 3)])


@pytest.mark.parametrize("family,scale,num_ch", MASK_CASES)
def test_masked_bucket_equals_unpadded_float32(family, scale, num_ch):
    """The 64-multiple bucket with its 0/1 mask computes exactly the
    unpadded forward on the true region: 0 differences in float32 (the
    JAX package pins the same; the bf16 bucket is checked on the card)."""
    _, _, tm = pair(family, scale, num_ch, "float32", seed=2)
    h, w = 21, 27
    x = torch.from_numpy(np.random.default_rng(3).random(
        (1, h, w, num_ch)).astype(np.float32))
    want = tm(x)
    xp = F.pad(x, (0, 0, 0, 64 - w, 0, 64 - h))
    mask = torch.zeros(1, 64, 64, 1)
    mask[:, :h, :w] = 1
    got = tm(xp, mask)[:, :h * scale, :w * scale]
    assert int((got != want).sum()) == 0


def test_depth_to_space_is_tf_order_not_pixel_shuffle():
    x = np.random.default_rng(4).random((2, 5, 7, 12)).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = classic.depth_to_space(t, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jclassic._depth_to_space(jnp.asarray(x), 2)))
    assert not np.array_equal(
        got, F.pixel_shuffle(t, 2).permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_lapsrn_bilinear_init_matches_jax(scale):
    """The port's own init keeps JAX's bilinear transposed-conv kernels
    (permuted for conv_transpose2d)."""
    tm = classic.build_classic_model(
        f"lapsrn_x{scale}", {"family": "lapsrn", "scale": scale}, seed=0)
    want = np.transpose(np.asarray(jclassic._bilinear_up_kernel(2, 64)),
                        (3, 2, 0, 1))
    for level in tm.levels:
        np.testing.assert_array_equal(level.up_feat.detach().numpy(), want)
    assert len(tm.levels) == int(np.log2(scale))


# --- the luma path's resize and colour ---------------------------------

@pytest.mark.parametrize("scale", [2, 3, 4, 8])
def test_upscale_cubic_matches_jax(scale):
    from s2sr_tpu.ops.resize import upscale_cubic as jupscale
    from s2sr_tpu_torch.ops.resize import upscale_cubic

    rng = np.random.default_rng(scale)
    for shape in ((11, 13, 2), (7, 9)):
        img = rng.random(shape).astype(np.float32)
        got = upscale_cubic(torch.from_numpy(img), scale).numpy()
        want = jupscale(img, scale)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-6


def test_ycrcb_matches_jax():
    from s2sr_tpu.ops import color as jcolor
    from s2sr_tpu_torch.ops import color

    rgb = np.random.default_rng(5).random((11, 13, 3)).astype(np.float32)
    ycc = color.rgb_to_ycrcb_f32(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jcolor.rgb_to_ycrcb_f32(rgb))
    assert np.abs(ycc - want).max() <= 1e-6
    back = color.ycrcb_to_rgb_f32(torch.from_numpy(want)).numpy()
    assert np.abs(back - np.asarray(jcolor.ycrcb_to_rgb_f32(want))).max() \
        <= 1e-6


# --- .pb converters and the GraphDef executor ---------------------------

def assert_trees_equal(got, want):
    got_l, got_def = jax.tree.flatten(got)
    want_l, want_def = jax.tree.flatten(np_tree(want))
    assert got_def == want_def
    for a, b in zip(got_l, want_l):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def espcn_wired_graph(tmp_path, rng, scale, num_ch=1):
    g = GB()
    c1 = g.conv("x", _k(rng, 5, 5, num_ch, 64), _k(rng, 64))
    t1 = g.unary("Tanh", c1)
    c2 = g.conv(t1, _k(rng, 3, 3, 64, 32), _k(rng, 32))
    t2 = g.unary("Tanh", c2)
    c3 = g.conv(t2, _k(rng, 3, 3, 32, num_ch * scale * scale),
                _k(rng, num_ch * scale * scale))
    g.d2s(c3, scale)
    return g.write(tmp_path / f"espcn_x{scale}.pb")


def espcn_const_graph(tmp_path, rng, scale):
    arrs = [("w1", (5, 5, 3, 64)), ("w2", (3, 3, 64, 32)),
            ("w3", (3, 3, 32, 3 * scale * scale)), ("b1", (64,)),
            ("b2", (32,)), ("b3", (3 * scale * scale,))]
    p = tmp_path / f"espcn_const_x{scale}.pb"
    p.write_bytes(b"".join(const_node(n, rng.random(s).astype(np.float32))
                           for n, s in arrs))
    return p


GRAPHS = {
    "edsr_const_x2": (lambda t, r: _write(t, "e.pb", _edsr_graph(r, 16, 2, 2)),
                      "edsr", 2),
    "lapsrn_const_x4": (lambda t, r: _write(t, "l.pb",
                                            _lapsrn_graph(r, 8, 3, 2)),
                        "lapsrn", 4),
    "lapsrn_const_shared_x8": (lambda t, r: _write(
        t, "l8.pb", _lapsrn_graph(r, 8, 2, 1)), "lapsrn", 8),
    "espcn_const_x3": (lambda t, r: espcn_const_graph(t, r, 3), "espcn", 3),
    **{f"edsr_wired_x{s}": (lambda t, r, s=s: _edsr_wired_graph(
        t, r, feat=12, blocks=2, scale=s), "edsr", s) for s in (2, 3, 4)},
    **{f"lapsrn_wired_x{s}": (lambda t, r, s=s: _lapsrn_wired_graph(
        t, r, 6, 9, feat=8, depth=2, scale=s), "lapsrn", s)
       for s in (2, 4, 8)},
    **{f"espcn_wired_x{s}": (lambda t, r, s=s: espcn_wired_graph(t, r, s),
                             "espcn", s) for s in (2, 3, 4)},
}


def _write(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    return p


def convert_both(family, path, scale):
    from s2sr_tpu.models import pb_reader as jpb
    from s2sr_tpu_torch.models import pb_reader as pb

    fn = f"convert_{family}_pb"
    return getattr(pb, fn)(path, scale), getattr(jpb, fn)(path, scale)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pb_converters_equal_jax(tmp_path, graph):
    make, family, scale = GRAPHS[graph]
    path = make(tmp_path, np.random.default_rng(6))
    got, want = convert_both(family, path, scale)
    if family == "edsr":
        (got, cfg), (want, jcfg) = got, want
        assert sorted(cfg) == sorted(jcfg)
        for k in cfg:
            np.testing.assert_array_equal(cfg[k], jcfg[k])
    assert_trees_equal(got, want)


def test_pb_reader_constants_and_audit_equal_jax(tmp_path):
    from s2sr_tpu.models import pb_reader as jpb
    from s2sr_tpu_torch.models import pb_reader as pb

    rng = np.random.default_rng(7)
    p = _write(tmp_path, "g.pb", _edsr_graph(rng, 16, 2, 3))
    got, want = pb.read_graphdef_constants(p), jpb.read_graphdef_constants(p)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert pb._shape_audit(pb._ordered_convs(got)) == \
        jpb._shape_audit(jpb._ordered_convs(want))
    bad = _write(tmp_path, "bad.pb", const_node(
        "w", rng.random((3, 3, 7, 7)).astype(np.float32)))
    with pytest.raises(ValueError, match="head"):
        pb.convert_edsr_pb(bad, 2)


WIRED = [g for g in sorted(GRAPHS) if "wired" in g]


@pytest.mark.parametrize("graph", WIRED)
def test_execute_graphdef_matches_jax_and_models(tmp_path, graph):
    """The port's executor within 1e-5 of JAX's on the same file, and the
    port's model on the converted weights within 1e-5 of the executor
    (EDSR in float32: the graph's 255 domain, the mean from the graph)."""
    from s2sr_tpu.models.graph_executor import execute_graphdef as jexec
    from s2sr_tpu_torch.models.graph_executor import execute_graphdef

    make, family, scale = GRAPHS[graph]
    path = make(tmp_path, np.random.default_rng(8))
    rng = np.random.default_rng(9)
    if family == "edsr":
        x = (rng.random((1, 9, 11, 3)) * 255).astype(np.float32)
    else:
        x = rng.random((1, 6, 9, 1)).astype(np.float32)
    want = jexec(path, {"x": x})
    got = execute_graphdef(path, {"x": x}, device="cpu").numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()

    tree, _ = convert_both(family, path, scale)
    mean = None
    if family == "edsr":
        tree, cfg = tree
        mean = cfg["mean"]
        model = classic.EDSR(scale, num_feat=12, num_blocks=2,
                             dtype=torch.float32)
        x_in = x / 255.0
    elif family == "espcn":
        model, x_in = classic.ESPCN(scale, num_ch=1), x
    else:
        model = classic.LapSRN(scale, num_feat=8, depth_per_level=2,
                               num_ch=1)
        x_in = x
    model.load_state_dict(params_from_jax_classic(tree, family, mean=mean))
    out = model(torch.from_numpy(x_in)).numpy()
    if family == "edsr":
        out = out * 255.0
    assert np.abs(out - got).max() <= F32_TOL * np.abs(got).max()


def test_execute_graphdef_conv_ops_match_jax(tmp_path):
    """Stride-2 SAME Conv2D (uneven pads) and a transposed conv to an odd
    output shape, against JAX's executor."""
    from s2sr_tpu.models.graph_executor import execute_graphdef as jexec
    from s2sr_tpu_torch.models.graph_executor import execute_graphdef

    rng = np.random.default_rng(10)
    g = GB()
    c1 = g.conv("x", _k(rng, 3, 3, 3, 8), _k(rng, 8), stride=1)
    r1 = g.unary("Relu", c1)
    c2 = g.conv(r1, _k(rng, 3, 3, 8, 8), _k(rng, 8), stride=2)
    l1 = g.unary("LeakyRelu", c2)
    up = g.tconv(l1, _k(rng, 4, 4, 8, 8), [1, 13, 11, 8], stride=2)
    g.binary("Maximum", up, g.const(np.zeros(8)))
    p = g.write(tmp_path / "ops.pb")
    x = rng.random((1, 13, 11, 3)).astype(np.float32)
    want = jexec(p, {"x": x})
    got = execute_graphdef(p, {"x": x}, device="cpu").numpy()
    assert got.shape == want.shape == (1, 13, 11, 8)
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


# --- the pipeline -------------------------------------------------------

@pytest.fixture
def weights_env(tmp_path, monkeypatch):
    """Both packages' settings read ``weights_dir`` from the environment;
    both registries serve EDSR at 16 features and 2 blocks."""
    from s2sr_tpu.config import settings as jsettings
    from s2sr_tpu.models import registry as jregistry
    from s2sr_tpu_torch.config import settings
    from s2sr_tpu_torch.models import registry
    from s2sr_tpu_torch.pipelines import super_resolution as sr

    wdir = tmp_path / "weights"
    wdir.mkdir()
    monkeypatch.setenv("WEIGHTS_DIR", str(wdir))
    for reg in (jregistry, registry):
        for s in (2, 3, 4):
            monkeypatch.setitem(reg.MODELS, f"edsr_x{s}", {
                "family": "edsr", "scale": s, "channels": 16, "blocks": 2})
    for mod in (jsettings, settings):
        mod.get_settings.cache_clear()
    sr._MODEL_CACHE.clear()
    yield wdir
    for mod in (jsettings, settings):
        mod.get_settings.cache_clear()
    sr._MODEL_CACHE.clear()


def test_create_sr_model_loads_pb_npz_and_caches(weights_env, tmp_path):
    """A dropped .pb is converted (EDSR's features, blocks and graph mean;
    LapSRN's luma head); a .npz in JAX's layout loads; the cache returns
    the same module until a weight file changes; no file: seeded init."""
    import os

    from s2sr_tpu.models.weights import save_params as jsave
    from s2sr_tpu_torch.pipelines.super_resolution import create_sr_model

    rng = np.random.default_rng(11)
    _edsr_wired_graph(weights_env, rng, feat=12, blocks=2, scale=2,
                      mean=(0.45, 0.44, 0.40))
    _lapsrn_wired_graph(weights_env, rng, 6, 9, feat=8, depth=2, scale=4)
    edsr = create_sr_model("edsr", 2, device="cpu")
    assert (edsr.num_feat, edsr.num_blocks) == (12, 2)
    assert edsr.dtype == torch.bfloat16
    # a mean ≤ 1 is scaled to the graph's 255 domain, as JAX does
    np.testing.assert_allclose(edsr.mean.numpy(),
                               np.float32([0.45, 0.44, 0.40]) * 255.0)
    assert create_sr_model("edsr", 2, device="cpu") is edsr
    lap = create_sr_model("lapsrn", 4, device="cpu")
    assert lap.num_ch == 1 and len(lap.levels) == 2

    jm, tree, _ = pair("espcn", 2, 3)
    jsave(tree, weights_env / "espcn_x2.npz")
    esp = create_sr_model("espcn", 2, device="cpu")
    np.testing.assert_array_equal(
        esp.conv1.weight.detach().numpy(),
        np.transpose(tree["conv1"]["kernel"], (3, 2, 0, 1)))
    os.utime(weights_env / "espcn_x2.npz", ns=(1, 1))
    assert create_sr_model("espcn", 2, device="cpu") is not esp
    rand = create_sr_model("espcn", 3, device="cpu")
    assert rand.num_ch == 3 and float(rand.conv1.weight.detach().abs().sum()) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_sr_model("espcn", 3)


SERVE_CASES = [("espcn", 2, 1), ("lapsrn", 4, 1), ("edsr", 3, 3)]


@pytest.mark.parametrize("family,scale,num_ch", SERVE_CASES)
def test_run_classic_sr_and_many_match_jax(family, scale, num_ch):
    """uint8 within 1 of JAX's ``run_classic_sr`` (the luma path for a
    1-channel model), and ``run_classic_sr_many`` over mixed sizes (three
    buckets, one of them on the grid) byte-equal to one image at a time."""
    from s2sr_tpu.pipelines import super_resolution as jsr
    from s2sr_tpu_torch.pipelines import super_resolution as sr

    jm, tree, tm = pair(family, scale, num_ch, "float32", seed=12)
    rng = np.random.default_rng(13)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((40, 46), (21, 13), (40, 46), (64, 64), (17, 30))]
    singles = [sr.run_classic_sr(tm, img) for img in imgs]
    for img, got in zip(imgs, singles):
        want = jsr.run_classic_sr(jm, tree, img)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want).max() <= 1
    many = sr.run_classic_sr_many(tm, imgs)
    for a, b in zip(many, singles):
        np.testing.assert_array_equal(a, b)


def test_process_sentinel2_sr_metadata_matches_jax(weights_env, tmp_path):
    """The same weights (a JAX .npz) through both pipelines: the same
    metadata keys and values (timing aside), the same sidecar keys and
    files, the GeoTIFF's transform divided by the scale, pixels within
    EDSR's bf16 tolerance."""
    import json

    from s2sr_tpu.fetch.synthetic import synthetic_scene
    from s2sr_tpu.geo import read_geotiff
    from s2sr_tpu.models.weights import save_params as jsave
    from s2sr_tpu.pipelines.super_resolution import \
        process_sentinel2_sr as jprocess
    from s2sr_tpu_torch.pipelines.super_resolution import process_sentinel2_sr

    _, tree, _ = pair("edsr", 2, seed=14)
    jsave(tree, weights_env / "edsr_x2.npz")
    scene = tmp_path / "scene.tif"
    synthetic_scene(scene, size=(24, 20), seed=3)
    want = jprocess(scene, tmp_path / "jax", scale=2, model="edsr")
    got = process_sentinel2_sr(scene, tmp_path / "torch", scale=2,
                               model="edsr", device="cpu")
    assert sorted(got) == sorted(want)
    strip = lambda m: {k: v for k, v in m.items() if k != "timing"}
    assert strip(got["sr_metadata"]) == strip(want["sr_metadata"])
    assert [s["name"] for s in got["sr_metadata"]["timing"]["stages"]] == \
        [s["name"] for s in want["sr_metadata"]["timing"]["stages"]]
    assert got["sr_metadata"]["output_size"] == [40, 48]
    side = json.loads((tmp_path / "torch" / "scene_sr_metadata.json")
                      .read_text())
    assert sorted(side) == sorted(want) and side["input"] == str(scene)
    for key in ("sr_tif", "sr_png"):
        assert Path(got["outputs"][key]).name == \
            Path(want["outputs"][key]).name
    a, b = read_geotiff(got["outputs"]["sr_tif"]), \
        read_geotiff(want["outputs"]["sr_tif"])
    assert tuple(a.transform) == tuple(b.transform)
    assert a.data.shape == b.data.shape == (48, 40, 3)
    diff = np.abs(a.data.astype(int) - b.data.astype(int))
    assert diff.max() <= BF16_TOL * 255
