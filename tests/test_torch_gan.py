"""The port's GAN trainer (``s2sr_tpu_torch/training/gan.py``) against
the JAX package's on the CPU, float32, tiny shapes: the U-Net
discriminator on carried weights, one G+D step of a 2-block RRDBNet, a
chunk-2 device-pool GAN step fed JAX's draws, and SwinIR's G+D step on
``tests/test_training.py``'s tiny SwinIR shape. Each JAX function is
compiled once."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from s2sr_tpu.training import gan as jg
from s2sr_tpu.training import train as jt
from s2sr_tpu_torch.models.weights import train_state_from_jax, tree_flatten
from s2sr_tpu_torch.training import gan as pg
from s2sr_tpu_torch.training import train as pt
from test_torch_train import jax_draws, jax_state, max_diff, np_tree, rel
from torch_threads import one_torch_thread  # noqa: F401

RRDB = dict(num_feat=16, num_block=2, num_grow_ch=8, scale=2,
            dtype="float32", learning_rate=1e-3, lr_decay_steps=4,
            ema_decay=0.9)
METRICS = ("g_loss", "d_loss", "pixel", "adv")


def leaf_rel(jtree, ptree) -> dict:
    """Per leaf (JAX's key path): max |Δ| over the leaf's max |value|."""
    paths = jax.tree_util.tree_flatten_with_path(np_tree(jtree))[0]
    leaves = tree_flatten(ptree)[0]
    assert len(paths) == len(leaves)
    return {jax.tree_util.keystr(p): float(
        np.abs(a - b.detach().numpy()).max() / max(np.abs(a).max(), 1e-30))
        for (p, a), b in zip(paths, leaves)}


def assert_disc_close(jd0, jd1, pd1, lr_d):
    """D's kernels within 1e-5 of JAX's relative to each kernel's largest
    value, and its biases within 1e-5 of the tree's: a bias starts at 0
    and after a step or two is of Adam's step size, and Adam divides its
    gradient (a sum over the image, with cancellation) by the gradient's
    own scale, which turns roundings in it into relative errors of ~1e-5
    of that step. ``out1``'s bias apart: the relativistic losses do not
    change when every logit moves by the same amount, so its gradient is
    zero up to rounding and Adam's step on it has either sign; both stay
    within one step per update of their start."""
    errs = leaf_rel(jd1, pd1)
    scale = max(np.abs(a).max() for a in jax.tree.leaves(np_tree(jd1)))
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(np_tree(jd1))[0],
            tree_flatten(pd1)[0]):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            assert errs[name] <= 1e-5, name
        elif name != "['out1']['bias']":
            assert np.abs(a - b.detach().numpy()).max() <= 1e-5 * scale, name
    start = np.asarray(jd0["out1"]["bias"])
    for b in (np.asarray(jd1["out1"]["bias"]),
              pd1["out1"]["bias"].detach().numpy()):
        assert np.abs(b - start).max() <= lr_d * (1 + 1e-3)


def gan_states(jcfg, nf_d, seed=0):
    """JAX's G and D with their optimizer states, and the port's copies."""
    jp, jo = jax_state(jcfg, seed)
    disc = jg.UNetDiscriminator(nf_d)
    jd = jax.jit(disc.init)(jax.random.PRNGKey(seed + 1))
    jdo = optax.adam(1e-4).init(jd)
    pp, po = train_state_from_jax(np_tree(jp), np_tree(jo))
    pd_, pdo = train_state_from_jax(np_tree(jd), np_tree(jdo))
    return (jp, jo, jd, jdo), (pp, po, pd_, pdo)


def test_discriminator_matches_jax_and_refuses_odd_sides():
    disc = jg.UNetDiscriminator(8)
    params = jax.jit(disc.init)(jax.random.PRNGKey(1))
    x = np.random.default_rng(0).random((2, 16, 24, 3), dtype=np.float32)
    want = np.asarray(jax.jit(disc.apply)(params, jnp.asarray(x)))
    pdisc = pg.UNetDiscriminator(8)
    got = pdisc.apply(pg.disc_params_from_jax(np_tree(params)),
                      torch.from_numpy(x))
    assert got.shape == want.shape == (2, 16, 24, 1)
    assert rel(got.numpy(), want) <= 1e-5
    for shape in ((1, 12, 16, 3), (1, 16, 20, 3)):
        with pytest.raises(ValueError, match="multiples of 8"):
            pdisc.apply(pg.disc_params_from_jax(np_tree(params)),
                        torch.zeros(shape))
    # the port's own init: the JAX tree's shapes, zero biases
    own = pdisc.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v["kernel"].shape) for k, v in own.items()} == {
        k: tuple(v["kernel"].shape) for k, v in params.items()}
    assert all(float(v["bias"].abs().max()) == 0 for v in own.values())


def test_gan_step_matches_jax():
    """One G+D step of a 2-block RRDBNet with the cosine decay and the
    EMA on G: G's params, its EMA, D's params and the four metrics."""
    jcfg, pcfg = jt.TrainConfig(**RRDB), pt.TrainConfig(**RRDB)
    (jp, jo, jd, jdo), (pp, po, pd_, pdo) = gan_states(jcfg, 8)
    rng = np.random.default_rng(1)
    hr = rng.random((2, 32, 32, 3), dtype=np.float32)
    lr = hr.reshape(2, 16, 2, 16, 2, 3).mean((2, 4))
    jstep = jg.make_gan_train_step(jg.GanConfig(base=jcfg, num_feat_d=8))[0]
    jp1, jd1, jo1, _, jm = jstep(jp, jd, jo, jdo, lr, hr)
    pstep = pg.make_gan_train_step(pg.GanConfig(base=pcfg, num_feat_d=8))[0]
    pp1, pd1, po1, pdo1, pm = pstep(pp, pd_, po, pdo, torch.from_numpy(lr),
                                    torch.from_numpy(hr))
    for k in METRICS:
        assert rel(float(pm[k]), float(jm[k])) <= 1e-5, k
    assert max(leaf_rel(jp1, pp1).values()) <= 1e-5
    assert max(leaf_rel(jt.ema_params(jo1), po1.ema).values()) <= 1e-5
    assert_disc_close(jd, jd1, pd1, 1e-4)
    assert int(po1.count) == int(pdo1.count) == 1
    assert int(po1.schedule_count) == 1


def test_device_pool_gan_step_matches_jax_draws():
    """Two G+D steps per call, each batch cropped, blurred, noised and
    JPEG'd on the pool's device from JAX's draws (no second-order chain:
    JAX's GAN sampler takes none)."""
    jcfg, pcfg = jt.TrainConfig(**RRDB), pt.TrainConfig(**RRDB)
    knobs = dict(blur_sigma=1.0, noise_std=0.02, jpeg_range=(30.0, 95.0))
    crop, batch, chunk = 16, 2, 2
    pool = np.random.default_rng(9).random((3, 44, 44, 3), dtype=np.float32)
    key = jax.random.PRNGKey(5)
    draws = [jax_draws(k, 3, 44, 32, batch, crop, knobs["jpeg_range"])
             for k in jax.random.split(key, chunk)]
    (jp, jo, jd, jdo), (pp, po, pd_, pdo) = gan_states(jcfg, 8, seed=2)
    jrun = jg.make_device_pool_gan_step(
        jg.GanConfig(base=jcfg, num_feat_d=8), crop, batch, chunk, **knobs)[0]
    jp1, jd1, _, _, jm = jrun(jp, jd, jo, jdo, jnp.asarray(pool), key)
    prun = pg.make_device_pool_gan_step(
        pg.GanConfig(base=pcfg, num_feat_d=8), crop, batch, chunk, **knobs)[0]
    pp1, pd1, _, _, pm = prun(pp, pd_, po, pdo, torch.from_numpy(pool),
                              None, draws=draws)
    for k in METRICS:
        assert pm[k].shape == (chunk,)
        assert rel(pm[k].numpy(), np.asarray(jm[k])) <= 1e-5, k
    assert max(leaf_rel(jp1, pp1).values()) <= 1e-5
    assert_disc_close(jd, jd1, pd1, 2e-4)
    # its own draws from a generator; a second-order sampler is refused
    # by the L1 trainer's rule (crop a multiple of 16) only
    *_, again = prun(pp1, pd1, po, pdo, torch.from_numpy(pool),
                     torch.Generator().manual_seed(0))
    assert all(torch.isfinite(again[k]).all() for k in METRICS)
    assert prun.sampler.second_order is None


def test_swinir_gan_step_matches_jax():
    """``tests/test_training.py``'s tiny SwinIR (dim 16, depths (1, 1),
    window 4, ×2) at JAX's default learning rate 1e-4: the key bias's
    gradient is zero up to rounding (see test_torch_train.py), so G is
    held in absolute terms, as the L1 SwinIR step is."""
    kw = dict(family="swinir", embed_dim=16, depths=(1, 1), heads=(2, 2),
              window=4, scale=2, dtype="float32", learning_rate=1e-4)
    jcfg, pcfg = jt.TrainConfig(**kw), pt.TrainConfig(**kw)
    (jp, jo, jd, jdo), (pp, po, pd_, pdo) = gan_states(jcfg, 4)
    rng = np.random.default_rng(3)
    lr = rng.random((2, 8, 8, 3), dtype=np.float32)
    hr = rng.random((2, 16, 16, 3), dtype=np.float32)
    jstep = jg.make_gan_train_step(jg.GanConfig(base=jcfg, num_feat_d=4))[0]
    jp1, jd1, _, _, jm = jstep(jp, jd, jo, jdo, lr, hr)
    pstep = pg.make_gan_train_step(pg.GanConfig(base=pcfg, num_feat_d=4))[0]
    pp1, pd1, _, _, pm = pstep(pp, pd_, po, pdo, torch.from_numpy(lr),
                               torch.from_numpy(hr))
    for k in METRICS:
        assert rel(float(pm[k]), float(jm[k])) <= 1e-5, k
    assert max_diff(jp1, pp1) <= 1e-5
    assert_disc_close(jd, jd1, pd1, 1e-4)


def test_mesh_of_more_than_one_device_refused():
    """A one-device mesh, dp=2 and sp=2 (two gloo ranks on the CPU: one
    step each, the same loss on both ranks and on both meshes) train;
    the sp step is no longer refused."""
    from s2sr_tpu_torch.parallel import comm
    from s2sr_tpu_torch.parallel.mesh import Mesh, build_mesh

    from torch_mesh_ranks import gan_mesh_steps

    cfg = pg.GanConfig(base=pt.TrainConfig(**RRDB))
    one = Mesh(("dp",), (1,), (torch.device("cpu"),))
    assert pg.make_gan_train_step(cfg, one)[1].num_feat == 32
    losses = comm.launch(gan_mesh_steps, build_mesh("dp=2", device="cpu"),
                         args=(RRDB,), timeout=120)
    assert losses[0] == losses[1] and np.isfinite(losses[0]["dp=2"])
    assert losses[0]["sp=2"] == pytest.approx(losses[0]["dp=2"], rel=1e-5)
