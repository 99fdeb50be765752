"""The port's trainer (``s2sr_tpu_torch.training``) against the JAX
package's on the CPU, float32, tiny shapes (``tests/test_training.py``'s
``num_feat=8, num_block=1, num_grow_ch=4, scale=2``): the same params and
batches through one ``make_train_step`` then three chunked steps with the
cosine decay and the EMA, the device-pool step fed JAX's draws, SwinIR's
step, a JAX state carried across mid-run; then the port on its own:
``restore_flexible`` across each template flip, resume equal bit for bit
to an unbroken run, and the checkpoint's keep policy."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.training import train as jt
from s2sr_tpu_torch.models.weights import (
    init_state_dict,
    init_swinir_state_dict,
    rrdbnet_tree,
    swinir_tree,
    train_state_from_jax,
    tree_flatten,
)
from s2sr_tpu_torch.training import train as pt
from s2sr_tpu_torch.training.checkpoint import CheckpointManager
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(num_feat=8, num_block=1, num_grow_ch=4, scale=2,
            dtype="float32", learning_rate=1e-3)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_state(jcfg, seed=0):
    """Params from numpy (the port's seeded init, perturbed) and JAX's
    optimizer state for them."""
    if jcfg.family == "swinir":
        tree = swinir_tree(init_swinir_state_dict(
            scale=jcfg.scale, embed_dim=jcfg.embed_dim, depths=jcfg.depths,
            num_heads=jcfg.heads, window_size=jcfg.window, seed=seed),
            jcfg.depths)
    else:
        tree = rrdbnet_tree(init_state_dict(
            num_feat=jcfg.num_feat, num_block=jcfg.num_block,
            num_grow_ch=jcfg.num_grow_ch, seed=seed))
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: (a + rng.normal(0, 0.02, np.shape(a)))
                        .astype(np.float32), tree)
    params = jax.tree.map(jnp.asarray, tree)
    return params, jt.make_optimizer(jcfg).init(params)


def batches(k, n=2, c=8, s=2, seed=1):
    rng = np.random.default_rng(seed)
    hr = rng.random((k, n, c * s, c * s, 3), dtype=np.float32)
    lr = hr.reshape(k, n, c, s, c, s, 3).mean((3, 5))
    return lr, hr


def max_diff(jtree, ptree):
    a = jax.tree.leaves(np_tree(jtree))
    b = tree_flatten(ptree)[0]
    assert len(a) == len(b)
    return max(float(np.abs(x - y.detach().numpy()).max())
               for x, y in zip(a, b))


def rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() \
        / np.abs(np.asarray(b, np.float64)).max()


@pytest.mark.parametrize("decay,ema", [(4, 0.9), (0, 0.0)])
def test_step_and_chunked_match_jax(decay, ema):
    kw = dict(TINY, lr_decay_steps=decay, ema_decay=ema)
    jcfg, pcfg = jt.TrainConfig(**kw), pt.TrainConfig(**kw)
    jp, jo = jax_state(jcfg)
    pp, po = train_state_from_jax(np_tree(jp), np_tree(jo))
    assert (po.schedule_count is not None) == (decay > 0)
    assert (po.ema is not None) == (ema > 0)
    lr, hr = batches(4)
    jstep, _ = jt.make_train_step(jcfg)
    jp, jo, jl = jstep(jp, jo, lr[0], hr[0])
    pstep, _ = pt.make_train_step(pcfg)
    pp, po, pl = pstep(pp, po, torch.from_numpy(lr[0]),
                       torch.from_numpy(hr[0]))
    assert rel(float(pl), float(jl)) <= 1e-6
    assert max_diff(jp, pp) <= 1e-5
    jrun, _ = jt.make_chunked_train_step(jcfg)
    prun, _ = pt.make_chunked_train_step(pcfg)
    jp, jo, jls = jrun(jp, jo, lr[1:], hr[1:])
    pp, po, pls = prun(pp, po, torch.from_numpy(lr[1:]),
                       torch.from_numpy(hr[1:]))
    assert pls.shape == (3,)
    assert rel(pls.numpy(), np.asarray(jls)) <= 1e-6
    assert max_diff(jp, pp) <= 1e-5
    if ema:
        assert max_diff(jt.ema_params(jo), pt.ema_params(po)) <= 1e-5
    else:
        assert pt.ema_params(po) is None
    # the moments and counts as JAX keeps them
    _, jpo = train_state_from_jax(np_tree(jp), np_tree(jo))
    assert int(po.count) == int(jpo.count) == 4
    assert max_diff(jax.tree.map(jnp.asarray, np_tree(
        [s for s in jax.tree.leaves(jo, is_leaf=lambda x: hasattr(x, "mu"))
         if hasattr(s, "mu")][0].nu)), po.nu) <= 1e-7


def jax_draws(key, n_scenes, hw, crop_hr, batch, c, jpeg_range):
    """The values JAX's pool sampler draws from ``key``
    (``train.py::make_pool_sampler``)."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    d = {
        "idx": np.asarray(jax.random.randint(k1, (batch,), 0, n_scenes)),
        "ys": np.asarray(jax.random.randint(k2, (batch,), 0,
                                            hw - crop_hr + 1)),
        "xs": np.asarray(jax.random.randint(k3, (batch,), 0,
                                            hw - crop_hr + 1)),
        "flips": np.asarray(jax.random.bernoulli(k4, shape=(batch, 2))),
        "noise": np.asarray(jax.random.normal(k5, (batch, c, c, 3))),
        "q": np.asarray(jax.random.uniform(k6, (batch,),
                                           minval=jpeg_range[0],
                                           maxval=jpeg_range[1])),
    }
    return {k: np.array(v) for k, v in d.items()}      # writable copies


def test_device_pool_step_matches_jax_draws():
    kw = dict(TINY, lr_decay_steps=3, ema_decay=0.5)
    jcfg, pcfg = jt.TrainConfig(**kw), pt.TrainConfig(**kw)
    knobs = dict(blur_sigma=1.0, noise_std=0.02, jpeg_range=(30.0, 95.0))
    crop, batch, chunk = 16, 2, 2
    rng = np.random.default_rng(9)
    pool = rng.random((3, 44, 44, 3), dtype=np.float32)
    key = jax.random.PRNGKey(5)
    draws = [jax_draws(k, 3, 44, 32, batch, crop, knobs["jpeg_range"])
             for k in jax.random.split(key, chunk)]
    sample = jax.jit(jt.make_pool_sampler(2, crop, batch, **knobs))
    psample = pt.make_pool_sampler(2, crop, batch, **knobs)
    ppool = torch.from_numpy(pool)
    for k, d in zip(jax.random.split(key, chunk), draws):
        jl, jh = (np.asarray(a) for a in sample(jnp.asarray(pool), k))
        pl, ph = psample.from_draws(ppool, **d)
        np.testing.assert_allclose(ph.numpy(), jh, rtol=0, atol=1e-6)
        np.testing.assert_allclose(pl.numpy(), jl, rtol=0, atol=1e-6)
    jp, jo = jax_state(jcfg)
    pp, po = train_state_from_jax(np_tree(jp), np_tree(jo))
    jrun, _ = jt.make_device_pool_train_step(jcfg, crop, batch, chunk,
                                             **knobs)
    jp, jo, jls = jrun(jp, jo, jnp.asarray(pool), key)
    prun, _ = pt.make_device_pool_train_step(pcfg, crop, batch, chunk,
                                             **knobs)
    pp, po, pls = prun(pp, po, ppool, None, draws=draws)
    assert rel(pls.numpy(), np.asarray(jls)) <= 1e-5
    assert max_diff(jp, pp) <= 1e-5
    # its own draws: the generator's stream, shapes and ranges
    g = torch.Generator().manual_seed(0)
    d = psample.draw(ppool, g)
    assert d["idx"].max() < 3 and d["ys"].max() <= 44 - 32
    assert d["q"].min() >= 30 and d["q"].max() <= 95
    _, _, again = prun(pp, po, ppool, torch.Generator().manual_seed(1))
    assert again.shape == (chunk,) and torch.isfinite(again).all()


def test_pool_sampler_refusals():
    from s2sr_tpu_torch.training.degradation import DegradationConfig

    with pytest.raises(ValueError, match="multiple of 16"):
        pt.make_pool_sampler(2, 8, 2, second_order=DegradationConfig())
    with pytest.raises(ValueError, match="multiple of 16"):
        pt.make_pool_sampler(2, 8, 2, jpeg_range=(30, 95))


def test_swinir_step_matches_jax():
    """JAX's default learning rate 1e-4: the key bias's gradient is zero
    up to rounding, and Adam's first step turns rounding-sized gradients
    into steps of up to lr·|g|/(|g| + 1e-8)."""
    kw = dict(family="swinir", embed_dim=12, depths=(1,), heads=(2,),
              window=4, scale=2, dtype="float32", learning_rate=1e-4)
    jcfg, pcfg = jt.TrainConfig(**kw), pt.TrainConfig(**kw)
    jp, jo = jax_state(jcfg)
    pp, po = train_state_from_jax(np_tree(jp), np_tree(jo))
    lr, hr = batches(1)
    jstep, _ = jt.make_train_step(jcfg)
    jp, jo, jl = jstep(jp, jo, lr[0], hr[0])
    pstep, _ = pt.make_train_step(pcfg)
    pp, po, pl = pstep(pp, po, torch.from_numpy(lr[0]),
                       torch.from_numpy(hr[0]))
    assert rel(float(pl), float(jl)) <= 1e-5
    assert max_diff(jp, pp) <= 1e-5


def test_jax_state_carried_across_mid_run():
    """Two JAX steps, the state carried across, the port's third step
    equal to JAX's third."""
    kw = dict(TINY, lr_decay_steps=5, ema_decay=0.8)
    jcfg, pcfg = jt.TrainConfig(**kw), pt.TrainConfig(**kw)
    jp, jo = jax_state(jcfg, seed=2)
    lr, hr = batches(3, seed=3)
    jstep, _ = jt.make_train_step(jcfg)
    for i in range(2):
        jp, jo, _ = jstep(jp, jo, lr[i], hr[i])
    pp, po = train_state_from_jax(np_tree(jp), np_tree(jo))
    assert int(po.count) == 2 and int(po.schedule_count) == 2
    jp, jo, jl = jstep(jp, jo, lr[2], hr[2])
    pstep, _ = pt.make_train_step(pcfg)
    pp, po, pl = pstep(pp, po, torch.from_numpy(lr[2]),
                       torch.from_numpy(hr[2]))
    assert rel(float(pl), float(jl)) <= 1e-6
    assert max_diff(jp, pp) <= 1e-5
    assert max_diff(jt.ema_params(jo), po.ema) <= 1e-5


def port_run(cfg, params, opt, lr, hr):
    run, _ = pt.make_chunked_train_step(cfg)
    return run(params, opt, torch.from_numpy(lr), torch.from_numpy(hr))


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(tree_flatten(a)[0], tree_flatten(b)[0]))


@pytest.mark.parametrize("flip", ["decay_off", "decay_on", "ema_off",
                                  "ema_on"])
def test_restore_flexible_template_flips(tmp_path, flip):
    base = dict(TINY, lr_decay_steps=0 if flip == "decay_on" else 6,
                ema_decay=0.0 if flip == "ema_on" else 0.9)
    saved = pt.TrainConfig(**base)
    new = replace(saved, **{"decay_off": {"lr_decay_steps": 0},
                            "decay_on": {"lr_decay_steps": 6},
                            "ema_off": {"ema_decay": 0.0},
                            "ema_on": {"ema_decay": 0.9}}[flip])
    params, opt = pt.init_training(saved, seed=3, device="cpu")
    lr, hr = batches(2)
    params, opt, _ = port_run(saved, params, opt, lr, hr)
    mgr = CheckpointManager(tmp_path)
    assert mgr.save(2, params, opt)
    p, o, step = pt.restore_flexible(mgr, saved, device="cpu")[:3]
    assert step == 2 and same(p, params) and same(o.mu, opt.mu)
    assert pt.restore_flexible(mgr, saved, device="cpu")[3] is True
    p, o, step, ok = pt.restore_flexible(mgr, new, device="cpu")
    assert step == 2 and ok is False and same(p, params)
    assert same(o.mu, opt.mu) and same(o.nu, opt.nu)
    assert int(o.count) == 2
    assert (o.schedule_count is not None) == (new.lr_decay_steps > 0)
    if o.schedule_count is not None:
        assert int(o.schedule_count) == 0      # a fresh schedule, as in JAX
    if flip == "ema_off":
        assert o.ema is None
    elif flip == "ema_on":
        assert same(o.ema, params)          # a fresh EMA starts at params
    else:
        assert same(o.ema, opt.ema)
    # a different model is no template at all
    with pytest.raises(ValueError):
        pt.restore_flexible(mgr, replace(saved, num_block=2), device="cpu")


def test_resume_equals_unbroken_run(tmp_path):
    cfg = pt.TrainConfig(**dict(TINY, lr_decay_steps=6, ema_decay=0.7))
    lr, hr = batches(6, seed=4)
    p0, o0 = pt.init_training(cfg, seed=1, device="cpu")
    p_full, o_full, l_full = port_run(cfg, p0, o0, lr, hr)
    p, o, l1 = port_run(cfg, p0, o0, lr[:3], hr[:3])
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(3, p, o)
    p, o, step, ok = pt.restore_flexible(mgr, cfg, device="cpu")
    assert step == 3 and ok
    p, o, l2 = port_run(cfg, p, o, lr[3:], hr[3:])
    assert torch.equal(torch.cat([l1, l2]), l_full)
    assert same(p, p_full) and same(o.mu, o_full.mu)
    assert same(o.nu, o_full.nu) and same(o.ema, o_full.ema)
    assert torch.equal(o.count, o_full.count)
    assert torch.equal(o.schedule_count, o_full.schedule_count)


def test_checkpoint_keep_policy_and_interval(tmp_path):
    cfg = pt.TrainConfig(**TINY)
    p, o = pt.init_training(cfg, device="cpu")
    mgr = CheckpointManager(tmp_path / "k", max_to_keep=2,
                            save_interval_steps=2)
    assert mgr.latest_step is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(p, o)
    assert mgr.save(1, p, o)                 # the first save always lands
    assert not mgr.save(3, p, o)             # off the interval
    assert mgr.save(4, p, o) and mgr.save(6, p, o)
    assert not mgr.save(6, p, o)             # not after the latest
    assert mgr.all_steps() == [4, 6] and mgr.latest_step == 6
    assert not list((tmp_path / "k").glob(".tmp-*"))
    _, _, step = mgr.restore(p, o, step=4)
    assert step == 4
    mgr.wait()
    mgr.close()
