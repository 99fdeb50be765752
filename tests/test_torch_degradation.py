"""The port's second-order Real-ESRGAN degradation
(``s2sr_tpu_torch/training/degradation.py``) and ``ops/resize.py::
resize_jax`` against the JAX package on the CPU, on JAX's own draws.

JAX draws with ``jax.random`` (threefry), which torch cannot reproduce, so
:func:`jax_chain_draws` repeats the JAX chain's ``jax.random.split`` tree
and returns the values each op draws, in the port's draw layout; fed to
the port's ``*_from_draws`` halves they must give JAX's real
``second_order_degrade(key, ...)``, which checks the helper too. Shapes
are small (64² HR at ×4) and each JAX function is compiled once."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.training import degradation as jd
from s2sr_tpu.training import train as jt
from s2sr_tpu_torch.ops.resize import resize_jax
from s2sr_tpu_torch.training import degradation as pd
from s2sr_tpu_torch.training import train as pt
from test_torch_train_ops import _near_half_blocks
from torch_threads import one_torch_thread  # noqa: F401

SCALE, HR = 4, 64
CFG_J, CFG_P = jd.DegradationConfig(), pd.DegradationConfig()


# --- JAX's draws, by its split tree -------------------------------------

def jax_kernel_draws(key, cfg):
    """``degradation.py::mixed_blur_kernel``'s draws."""
    ks = jax.random.split(key, 8)
    u = jax.random.uniform
    lo, hi = cfg.blur_sigma
    return {"sig1": u(ks[0], minval=lo, maxval=hi),
            "sig2": u(ks[1], minval=lo, maxval=hi),
            "theta": u(ks[2], minval=-np.pi, maxval=np.pi),
            "betag": u(ks[3], minval=cfg.betag_range[0],
                       maxval=cfg.betag_range[1]),
            "betap": u(ks[6], minval=cfg.betap_range[0],
                       maxval=cfg.betap_range[1]),
            "fam": jax.random.choice(ks[4], 6, p=jnp.asarray(cfg.kernel_probs)),
            "use_sinc": jax.random.bernoulli(ks[5], cfg.sinc_prob),
            "cutoff": u(ks[7], minval=np.pi / 3, maxval=np.pi)}


def jax_noise_draws(key, cfg, hw):
    """``random_noise``'s: σ and λ from one uniform, one key for both
    fields."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {"gauss": jax.random.bernoulli(k1, cfg.gaussian_noise_prob),
            "gray": jax.random.bernoulli(k2, cfg.gray_noise_prob),
            "u": jax.random.uniform(k3),
            "field_c": jax.random.normal(k4, (*hw, 3)),
            "field_g": jax.random.normal(k4, hw)}


def jax_stage_draws(key, cfg, hw, blur=True):
    """``_stage``'s (its blur key split off even when unused) and the
    quality drawn from the key it returns."""
    kb, kr, kn, kj = jax.random.split(key, 4)
    k1, k2, _ = jax.random.split(kr, 3)
    d = {"resize": {
            "fi": jax.random.choice(k1, len(jd.RESIZE_LADDER),
                                    p=jnp.asarray(pd.resize_probs(cfg))),
            "mi": jax.random.randint(k2, (), 0, len(jd._METHODS))},
         "noise": jax_noise_draws(kn, cfg, hw),
         "q": jax.random.uniform(kj, minval=cfg.jpeg_range[0],
                                 maxval=cfg.jpeg_range[1])}
    if blur:
        d["blur"] = jax_kernel_draws(kb, cfg)
    return d


def jax_chain_draws(key, cfg, hw):
    """``second_order_degrade``'s draws in ``draw_second_order``'s
    layout."""
    k1, k2, k3, k4, k5, k6, k7 = jax.random.split(key, 7)
    lo, hi = cfg.final_sinc_cutoff
    return {"stage1": jax_stage_draws(k1, cfg.stage1, hw),
            "blur2": jax_kernel_draws(k2, cfg.stage2),
            "use_blur2": jax.random.bernoulli(k3, cfg.second_blur_prob),
            "stage2": jax_stage_draws(k4, cfg.stage2, hw, blur=False),
            "cutoff": jax.random.uniform(k5, minval=lo, maxval=hi),
            "use_sinc": jax.random.bernoulli(k6, cfg.final_sinc_prob),
            "order": jax.random.bernoulli(k7, 0.5)}


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


# --- resize_jax -----------------------------------------------------------

# XLA recomputes the float32 sample positions (i + 0.5)/scale − 0.5 in
# each fusion that reads them, some through fused multiply-adds, so its
# weights carry up to ~2e-6 of rounding that no fixed float32 order
# repeats (the ×1.5 branch at 64: 1.5e-6 of max); every other branch is
# within 1e-6
RESIZE_TOL = 2e-6


@pytest.mark.parametrize("side", [64, 45])
@pytest.mark.parametrize("method", jd._METHODS)
def test_resize_jax_matches_jax_on_every_ladder_branch(method, side):
    """Each of the 7 ladder factors of ``method``: the resize to the
    branch's size and the one back, each from the same input as JAX's
    (one compile of all seven)."""
    rng = np.random.default_rng(side)
    x = rng.random((side, side + 3, 3), dtype=np.float32)
    sizes = [(max(int(round(side * f)), 1), max(int(round((side + 3) * f)), 1))
             for f in jd.RESIZE_LADDER]

    def branches(im):
        out = []
        for hh, ww in sizes:
            mid = jax.image.resize(im, (hh, ww, 3), method=method)
            out.append((mid, jax.image.resize(mid, im.shape, method=method)))
        return out

    for factor, (hw, (mid, back)) in zip(
            jd.RESIZE_LADDER, zip(sizes, jax.jit(branches)(jnp.asarray(x)))):
        got_mid = resize_jax(torch.from_numpy(x), hw, method)
        got_back = resize_jax(torch.from_numpy(np.array(mid)),
                              (side, side + 3), method)
        assert got_mid.shape == mid.shape and got_back.shape == back.shape
        assert rel_err(got_mid, mid) <= RESIZE_TOL, (factor, "down/up")
        assert rel_err(got_back, back) <= RESIZE_TOL, (factor, "back")
        if method == "nearest":        # a gather: the same values
            np.testing.assert_array_equal(got_mid.numpy(), np.asarray(mid))
    # a batch is resized per image
    xb = np.stack([x, x[::-1]])
    got = resize_jax(torch.from_numpy(xb), (20, 9), method).numpy()
    for im, g in zip(xb, got):
        np.testing.assert_array_equal(
            g, resize_jax(torch.from_numpy(im.copy()), (20, 9), method).numpy())


# --- kernels ------------------------------------------------------------

def test_bessel_and_sinc_match_jax():
    """J₁ within 2e-6 of JAX's: near |x| = 8 the rational form cancels in
    float32, and both sit ~1.7e-6 from scipy's float64 J₁ there, in
    rounding that differs with the order of operations; the kernels built
    from it within 1e-6."""
    from scipy.special import j1

    x = np.linspace(-40, 40, 4001, dtype=np.float32)
    want = np.asarray(jax.jit(jd._bessel_j1)(jnp.asarray(x)))
    got = pd.bessel_j1(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 2e-6
    assert np.abs(got - j1(x.astype(np.float64))).max() < 5e-6
    cut = np.array([np.pi / 3, 1.1, 2.0, np.pi], np.float32)
    want = np.asarray(jax.jit(jax.vmap(jd.sinc_kernel))(jnp.asarray(cut)))
    got = pd.sinc_kernel(torch.from_numpy(cut)).numpy()
    assert got.shape == (4, 21, 21)
    assert np.abs(got - want).max() <= 1e-6


def test_mixed_blur_kernel_matches_jax_for_every_family_and_sinc():
    """256 keys of the published stage-1 config (one compile): every
    family and the sinc replacement among them."""
    cfg = CFG_J.stage1
    keys = jax.random.split(jax.random.PRNGKey(11), 256)
    draws, want = jax.jit(jax.vmap(lambda k: (
        jax_kernel_draws(k, cfg), jd.mixed_blur_kernel(k, cfg))))(keys)
    d = to_torch(draws)
    assert set(d["fam"][~d["use_sinc"]].tolist()) == set(range(6))
    assert d["use_sinc"].any()
    err = np.abs(pd.mixed_blur_kernel_from_draws(**d).numpy()
                 - np.asarray(want)).max((1, 2))
    sinc = d["use_sinc"].numpy()
    assert err[~sinc].max() <= 1e-6
    # a sinc at a cutoff near π samples J₁ near 8, where the two J₁ differ
    # by up to 2e-6 (test_bessel_and_sinc_match_jax)
    assert err[sinc].max() <= 2e-6
    # and on the port's own draws: normalised kernels of every family
    d = pd.draw_mixed_blur_kernel(CFG_P.stage1, 512,
                                  torch.Generator().manual_seed(0), "cpu")
    k = pd.mixed_blur_kernel_from_draws(**d)
    assert set(d["fam"].tolist()) == set(range(6))
    assert torch.allclose(k.sum((1, 2)), torch.ones(512), atol=1e-5)


# --- noise ----------------------------------------------------------------

@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
@pytest.mark.parametrize("gauss", [True, False], ids=["gaussian", "shot"])
def test_random_noise_on_the_same_fields(gauss, gray, monkeypatch):
    """JAX's ``random_noise`` with its two normal fields replaced by given
    ones (its uniform and bernoulli draws its own) against the port on the
    same fields and draws: within one float32 rounding at the image's
    scale (2^-23; most values equal). XLA contracts some of the products
    and sums into fused multiply-adds, fusion by fusion, which the port's
    elementwise ops do not."""
    cfg = jd.StageConfig(gaussian_noise_prob=float(gauss),
                         gray_noise_prob=float(gray))
    rng = np.random.default_rng(5)
    img = rng.random((24, 16, 3), dtype=np.float32)
    img[0, 0] = [-0.1, 1.2, 0.5]               # the clip of the shot noise
    fields = {3: rng.standard_normal((24, 16, 3)).astype(np.float32),
              2: rng.standard_normal((24, 16)).astype(np.float32)}
    key = jax.random.PRNGKey(3)
    u = float(jax.random.uniform(jax.random.split(key, 4)[2]))
    monkeypatch.setattr(jax.random, "normal",
                        lambda k, shape: jnp.asarray(fields[len(shape)]))
    want = np.asarray(jax.jit(lambda k, x: jd.random_noise(k, x, cfg))(
        key, jnp.asarray(img)))
    got = pd.random_noise_from_draws(
        torch.from_numpy(img)[None], cfg, gauss=torch.tensor([gauss]),
        gray=torch.tensor([gray]), u=torch.tensor([u]),
        field_c=torch.from_numpy(fields[3])[None],
        field_g=torch.from_numpy(fields[2])[None])[0].numpy()
    assert np.abs(got - want).max() <= np.finfo(np.float32).eps
    assert np.abs(got - img).max() > 1e-4           # the noise is there


# --- the chain ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sampled():
    """JAX's pool sampler with the chain (batch 4, LR crop 16 at ×4: four
    keys of ``second_order_degrade`` at 64² HR), its per-sample chain draws,
    its crop draws and stage 1's output before its JPEG; one compile."""
    rng = np.random.default_rng(7)
    pool = rng.random((3, 96, 96, 3), dtype=np.float32)
    key = jax.random.PRNGKey(31)
    batch = 4
    sample = jt.make_pool_sampler(SCALE, 16, batch, second_order=CFG_J)

    def run(pool_, key_):
        k1, k2, k3, k4, k5, _ = jax.random.split(key_, 6)
        crop = {"idx": jax.random.randint(k1, (batch,), 0, 3),
                "ys": jax.random.randint(k2, (batch,), 0, 96 - HR + 1),
                "xs": jax.random.randint(k3, (batch,), 0, 96 - HR + 1),
                "flips": jax.random.bernoulli(k4, shape=(batch, 2))}
        keys = jax.random.split(k5, batch)
        chain = jax.vmap(lambda k: jax_chain_draws(k, CFG_J, (HR, HR)))(keys)
        lr, hr = sample(pool_, key_)
        stage1 = jax.vmap(lambda k, x: jd._stage(
            jax.random.split(k, 7)[0], x, CFG_J.stage1)[0])(keys, hr)
        return lr, hr, crop, chain, stage1

    lr, hr, crop, chain, stage1 = jax.jit(run)(jnp.asarray(pool), key)
    return {"pool": pool, "lr": np.asarray(lr), "hr": np.asarray(hr),
            "crop": {k: np.array(v) for k, v in crop.items()},
            "chain": to_torch(chain), "stage1": np.asarray(stage1)}


def test_stage1_before_jpeg_matches_jax(jax_sampled):
    """Stage 1 (blur, resize, noise) of the four keys, before its JPEG."""
    s = jax_sampled
    got = pd._stage(torch.from_numpy(s["hr"]), CFG_P.stage1,
                    s["chain"]["stage1"])
    assert np.abs(got.numpy() - s["stage1"]).max() <= 1e-5


def jpeg_inputs(hr: torch.Tensor, d: dict) -> tuple:
    """The port's two JPEG inputs of the chain on ``hr`` with draws ``d``:
    stage 1's (HR) and the final one (LR), clipped."""
    img = pd._stage(hr, CFG_P.stage1, d["stage1"]).clamp(0, 1)
    x = pd.jpeg_degrade(img, d["stage1"]["q"])
    k2 = pd.mixed_blur_kernel_from_draws(**d["blur2"])
    x = torch.where(d["use_blur2"].reshape(-1, 1, 1, 1),
                    pd.blur_with_kernel(x, k2), x)
    x = pd._stage(x, CFG_P.stage2, d["stage2"])
    b = x.shape[0]
    lr = x.reshape(b, HR // SCALE, SCALE, HR // SCALE, SCALE, 3).mean((2, 4))
    sinc = torch.where(d["use_sinc"].reshape(-1, 1, 1, 1), pd.blur_with_kernel(
        lr, pd.sinc_kernel(d["cutoff"])), lr)
    final = torch.where(d["order"].reshape(-1, 1, 1, 1), sinc, lr)
    return img, final.clamp(0, 1)


def assert_jpeg_rule(got, want, hr, d):
    """Outputs differ by more than 1e-5 only where a JPEG rounding tie
    allows it: in a 16×16 LR block that holds a coefficient within 1e-4
    of a tie, or anywhere in a sample whose stage-1 JPEG (at HR, spread
    by the blurs and resizes after it) holds one; fewer than 1% of values
    in all."""
    diff = np.abs(got - want) > 1e-5
    assert diff.sum() < got.size // 100
    first, final = jpeg_inputs(hr, d)
    for i in np.nonzero(diff.any((1, 2, 3)))[0]:
        q1, q2 = float(d["stage1"]["q"][i]), float(d["stage2"]["q"][i])
        if _near_half_blocks(first[i].numpy(), q1):
            continue
        bad = _near_half_blocks(final[i].numpy(), q2)
        n = got.shape[1] // 16
        for by, bx in zip(*np.nonzero(diff[i].reshape(n, 16, n, 16, 3)
                                      .any((1, 3, 4)))):
            assert (by, bx) in bad, (i, by, bx)


def test_second_order_chain_matches_jax(jax_sampled):
    """The chain on JAX's HR crops and JAX's draws against JAX's LR: four
    keys of ``second_order_degrade`` at 64² HR, ×4."""
    s = jax_sampled
    hr = torch.from_numpy(s["hr"])
    got = pd.second_order_from_draws(hr, SCALE, CFG_P, s["chain"]).numpy()
    assert got.shape == s["lr"].shape == (4, 16, 16, 3)
    assert_jpeg_rule(got, s["lr"], hr, s["chain"])
    # the chain degrades: the LR is not the area mean
    clean = s["hr"].reshape(4, 16, 4, 16, 4, 3).mean((2, 4))
    assert np.abs(got - clean).mean() > 0.01


def test_pool_sampler_second_order_matches_jax(jax_sampled):
    s = jax_sampled
    sampler = pt.make_pool_sampler(SCALE, 16, 4, second_order=CFG_P)
    pool = torch.from_numpy(s["pool"])
    lr, hr = sampler.from_draws(pool, **s["crop"], degrade=s["chain"])
    np.testing.assert_array_equal(hr.numpy(), s["hr"])
    assert_jpeg_rule(lr.numpy(), s["lr"], hr, s["chain"])
    # its own draws: shapes, a finite LR in [0, 1]
    lr2, hr2 = sampler(pool, torch.Generator().manual_seed(0))
    assert lr2.shape == (4, 16, 16, 3) and hr2.shape == (4, 64, 64, 3)
    assert torch.isfinite(lr2).all() and 0 <= lr2.min() and lr2.max() <= 1


def test_draw_frequencies_match_the_configured_probabilities():
    """4096 draws of a generator: the kernel families and the resize
    branches within 3σ of ``StageConfig``'s probabilities."""
    n = 4096
    gen = torch.Generator().manual_seed(4)
    for cfg in (CFG_P.stage1, CFG_P.stage2):
        fam = pd.draw_mixed_blur_kernel(cfg, n, gen, "cpu")["fam"]
        rs = pd.draw_random_resize(cfg, n, gen, "cpu")
        branch = rs["fi"] * 3 + rs["mi"]
        p_branch = np.repeat(pd.resize_probs(cfg), 3) / 3
        for counts, p in ((torch.bincount(fam, minlength=6), cfg.kernel_probs),
                          (torch.bincount(branch, minlength=21), p_branch)):
            p = np.asarray(p)
            sigma = np.sqrt(n * p * (1 - p))
            assert (np.abs(counts.numpy() - n * p) <= 3 * sigma + 1e-9).all()


def test_second_order_degrade_draws_and_refuses_bad_sides():
    hr = torch.rand(2, HR, HR, 3, generator=torch.Generator().manual_seed(1))
    lr = pd.second_order_degrade(hr, SCALE, CFG_P,
                                 torch.Generator().manual_seed(2))
    assert lr.shape == (2, 16, 16, 3) and torch.isfinite(lr).all()
    with pytest.raises(ValueError, match="multiples of 16"):
        pd.second_order_degrade(hr[:, :48], SCALE, CFG_P,
                                torch.Generator().manual_seed(2))
