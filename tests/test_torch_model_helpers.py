"""The port's small public model helpers against the JAX package's:
``models/rrdbnet.py::num_parameters`` and ``models/swinir.py::
window_partition`` / ``window_reverse``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2sr_tpu.models import registry
from s2sr_tpu.models import rrdbnet as jrrdb
from s2sr_tpu.models import swinir as jswin
from s2sr_tpu_torch.models import rrdbnet as prrdb
from s2sr_tpu_torch.models import swinir as pswin
from s2sr_tpu_torch.models.weights import (params_from_jax,
                                           params_from_jax_swinir,
                                           rrdbnet_tree, swinir_tree)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape,w", [((2, 16, 24, 5), 4), ((1, 16, 8, 3), 8),
                                     ((3, 6, 9, 2), 3)])
def test_window_partition_and_reverse_match_jax(shape, w):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jswin.window_partition(jnp.asarray(x), w))
    got = pswin.window_partition(torch.from_numpy(x), w)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    b, h, ww, _ = shape
    back = pswin.window_reverse(got, w, h, ww)
    assert np.array_equal(back.numpy(), np.asarray(
        jswin.window_reverse(jnp.asarray(want), w, h, ww)))
    assert torch.equal(back, torch.from_numpy(x))


def zeros_tree(init):
    """A JAX model's tree of its init's shapes, as numpy zeros (no init
    is run)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def test_num_parameters_realesrgan_x4():
    cfg = registry.MODELS["realesrgan_x4"]
    tree = zeros_tree(jrrdb.RRDBNet(
        num_feat=cfg["channels"], num_block=cfg["blocks"],
        num_grow_ch=cfg["growth"], scale=cfg["scale"]).init)
    want = jrrdb.num_parameters(tree)
    sd = params_from_jax(tree)
    # RealESRGAN_x4plus's published size
    assert want == 16_697_987
    assert prrdb.num_parameters(rrdbnet_tree(sd)) == want
    assert prrdb.num_parameters(sd) == want


def test_num_parameters_swinir_x4():
    cfg = registry.MODELS["swinir_x4"]
    tree = zeros_tree(jswin.SwinIR(
        scale=cfg["scale"], embed_dim=cfg["embed_dim"], depths=cfg["depths"],
        num_heads=cfg["num_heads"], window_size=cfg["window_size"]).init)
    want = jrrdb.num_parameters(tree)
    sd = params_from_jax_swinir(tree)
    assert prrdb.num_parameters(swinir_tree(sd, cfg["depths"])) == want
    assert prrdb.num_parameters(sd) == want
