"""The port's ``cli/eval_trained.py`` on the CPU against the JAX script's
own steps on the same params.

A seeded JAX train state (``training/train.py::init_training``, one RRDB
block at the ``rdb`` kernel's widths, 64 features and growth 32: the
port's ``RRDBNet`` serves no other) is carried across with
``train_state_from_jax`` and saved through the port's
``CheckpointManager``; ``eval_trained.main`` scores it on one 16² LR
scene. The init's convs are taken to plain Kaiming scale first (see
:func:`exercised`): at its ESRGAN ×0.1 scale the output stays near 1e-5,
truncates to an all-zero uint8 image on both sides and would hold nothing
of the forward to JAX's. The JAX rows follow ``scripts/eval_trained.py``:
JAX's ``save_params``, ``SREngine(bgr_order=False).enhance``,
``area_downsample``, ``cv2.resize(INTER_CUBIC)``, ``psnr`` / ``ssim``.

- float32: the port's uint8 output within 1 of JAX's on at most 1e-3 of
  the values (``test_torch_engine.py``'s rule), engine PSNR within 0.01
  dB, SSIM within 1e-4;
- bfloat16: the port's uint8 output above 40 dB PSNR against JAX's (the
  bar ``test_torch_int8.py::test_int8_engine_tracks_jax`` holds engines
  to; the two frameworks' bf16 convs round in other places), engine
  PSNR within 0.1 dB;
- bicubic PSNR within 1e-5 dB of cv2's, in both.
"""

import ast
import json
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest

from s2sr_tpu.fetch.synthetic import synthetic_fields as jax_fields
from s2sr_tpu.models.engine import SREngine as JaxEngine
from s2sr_tpu.models.weights import save_params as jax_save_params
from s2sr_tpu.training import train as jax_train
from s2sr_tpu.training.data import area_downsample as jax_area_downsample
from s2sr_tpu.utils.metrics import psnr as jax_psnr
from s2sr_tpu.utils.metrics import ssim as jax_ssim
from s2sr_tpu_torch.cli import eval_trained
from s2sr_tpu_torch.models.engine import SREngine
from s2sr_tpu_torch.models.weights import tree_to_numpy, train_state_from_jax
from s2sr_tpu_torch.training.checkpoint import CheckpointManager
from s2sr_tpu_torch.training.train import (TrainConfig, init_training,
                                           restore_flexible)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FEAT, BLOCKS, GROW = 64, 1, 32
EVAL = 16
SEED = 100_000
BF16_MIN_PSNR = 40.0     # port vs JAX uint8, test_torch_int8.py's bar
MIN_LEVELS, MIN_STD = 50, 10.0   # a uint8 output that is not degenerate


@pytest.fixture(autouse=True)
def probe_caches(tmp_path, monkeypatch):
    """Both engines' halo-probe sidecars under the test's directory."""
    monkeypatch.setenv("S2SR_TORCH_CACHE", str(tmp_path / "torch_cache"))
    monkeypatch.setenv("S2SR_JAX_CACHE", str(tmp_path / "jax_cache" / "x"))


def jax_config(**kw):
    return jax_train.TrainConfig(num_feat=FEAT, num_block=BLOCKS,
                                 num_grow_ch=GROW, **kw)


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def exercised(params: dict) -> dict:
    """``params`` with every conv but ``conv_last`` ×10 (undoing
    ``RRDBNet.init``'s ESRGAN ×0.1, so plain Kaiming) and ``conv_last``'s
    bias at 0.5: on the eval's 16² scene JAX's float32 output spans about
    160 uint8 levels (std about 34, none saturated), and zeroing
    ``conv_body`` moves about 94% of its values by more than 1
    (:func:`test_params_exercise_the_trunk`)."""
    out = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 10 if path[-1].key == "kernel" else a, params)
    out["conv_last"] = {"kernel": params["conv_last"]["kernel"],
                        "bias": params["conv_last"]["bias"] + 0.5}
    return out


@pytest.fixture(scope="module")
def state():
    """A seeded JAX (params, optax state) with numpy leaves, for the
    eval's own optimizer config (cosine schedule, no EMA); jitted, one
    compile in place of one per eager op; the params :func:`exercised`."""
    cfg = jax_config(lr_decay_steps=1)
    params, opt = as_numpy(
        jax.jit(lambda: jax_train.init_training(cfg, seed=3))())
    return exercised(params), opt


@pytest.fixture(scope="module")
def ckpt(state, tmp_path_factory):
    return port_checkpoint(tmp_path_factory.mktemp("ckpt"), state)


def port_checkpoint(path: Path, state, step: int = 7) -> Path:
    CheckpointManager(path).save(step, *train_state_from_jax(*state))
    return path


def jax_report_keys() -> dict:
    """``report``'s keys in ``scripts/eval_trained.py``, the ``config``
    dict's keys under its own."""
    src = ROOT / "scripts" / "eval_trained.py"
    for node in ast.walk(ast.parse(src.read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "report"
                        for t in node.targets)):
            return {k.value: (sorted(kk.value for kk in v.keys)
                              if isinstance(v, ast.Dict) else None)
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no report dict in scripts/eval_trained.py")


def keys_of(report: dict) -> dict:
    return {k: sorted(v) if k == "config" else None
            for k, v in report.items()}


def eval_scene():
    """The script's held-out scene ``SEED`` at LR ``EVAL``: (HR, LR) uint8."""
    hr = jax_fields(size=(EVAL * 4,) * 2, seed=SEED)
    lr = np.clip(np.round(jax_area_downsample(hr.astype(np.float32), 4)),
                 0, 255).astype(np.uint8)
    return hr, lr


def jax_enhance(params: dict, wdir: Path, dtype: str, lr: np.ndarray):
    """The JAX script's engine on ``params`` (without the halo probe,
    which sets the tiled path's pad: a 16² scene takes the bucket)."""
    jax_save_params(params, wdir / "realesrgan_x4.npz")
    jeng = JaxEngine("realesrgan_x4", weights_dir=wdir, dtype=dtype,
                     bgr_order=False, pad_probe=False)
    assert jeng.pretrained
    assert lr.shape[0] * lr.shape[1] <= jeng.engage_area
    return np.asarray(jeng.enhance(lr))


def assert_not_degenerate(u8: np.ndarray):
    assert len(np.unique(u8)) > MIN_LEVELS and u8.std() > MIN_STD, (
        len(np.unique(u8)), u8.std())


def run_port(out: Path, ckpt: Path, dtype: str) -> dict:
    eval_trained.main(["--ckpt-dir", str(ckpt), "--cpu", "--feat", str(FEAT),
                       "--blocks", str(BLOCKS), "--grow", str(GROW),
                       "--eval-size", str(EVAL), "--eval-scenes", "1",
                       "--dtype", dtype, "--out", str(out)])
    return json.loads(out.read_text())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_trained_matches_jax_script(tmp_path, state, ckpt, dtype):
    rep = run_port(tmp_path / "eval.json", ckpt, dtype)
    assert keys_of(rep) == jax_report_keys()
    assert rep["platform"] == "cpu" and rep["ckpt_step"] == 7
    assert rep["config"]["dtype"] == dtype

    # the JAX script's steps on the same params
    wdir = tmp_path / "jax_weights"
    hr, lr = eval_scene()
    want = jax_enhance(state[0], wdir, dtype, lr)
    assert_not_degenerate(want)
    bi = cv2.resize(lr, hr.shape[1::-1], interpolation=cv2.INTER_CUBIC)
    (row,) = rep["scenes"]
    assert row["seed"] == SEED
    assert abs(row["bicubic_psnr"] - jax_psnr(bi, hr)) <= 1e-5
    assert abs(row["bicubic_ssim"] - jax_ssim(bi, hr)) <= 1e-5

    # the port's engine on the file JAX wrote, as the CLI builds it
    got = SREngine("realesrgan_x4", weights_dir=wdir, dtype=dtype,
                   bgr_order=False, pad_probe=False, device="cpu").enhance(lr)
    assert got.shape == want.shape == hr.shape and got.dtype == np.uint8
    jpsnr = jax_psnr(want, hr)
    if dtype == "float32":
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        assert abs(row["engine_psnr"] - jpsnr) <= 0.01
        assert abs(row["engine_ssim"] - jax_ssim(want, hr)) <= 1e-4
    else:
        assert jax_psnr(got, want) > BF16_MIN_PSNR
        assert abs(row["engine_psnr"] - jpsnr) <= 0.1
    assert row["engine_psnr"] == jax_psnr(got, hr)
    assert rep["mean"]["engine_psnr"] == row["engine_psnr"]
    assert rep["beats_bicubic"] == (row["engine_psnr"] > row["bicubic_psnr"])


def test_params_exercise_the_trunk(tmp_path, state):
    """The compared output depends on the trunk: the float32 output with
    ``conv_body`` zeroed (the trunk's sum left out of ``feat``) differs by
    more than 1 on over half the values. The port's engine runs both
    (the other tests hold it to JAX's on the same params)."""
    _, lr = eval_scene()
    off = dict(state[0], conv_body={k: np.zeros_like(v) for k, v
                                    in state[0]["conv_body"].items()})
    outs = []
    for name, params in (("on", state[0]), ("off", off)):
        jax_save_params(params, tmp_path / name / "realesrgan_x4.npz")
        outs.append(SREngine("realesrgan_x4", weights_dir=tmp_path / name,
                             dtype="float32", bgr_order=False,
                             pad_probe=False, device="cpu").enhance(lr))
    want, got = outs
    assert_not_degenerate(want)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff > 1).mean() > 0.5, (diff > 1).mean()


def test_ema_checkpoint_restores_through_the_mismatch_path(tmp_path, state):
    """A checkpoint with a weight EMA and a constant LR (the eval's config
    has neither), as ``train_demo --ema-decay`` writes, restores its params
    bit for bit through ``restore_flexible``'s mismatch path, which the
    eval calls."""
    ema_cfg = jax_config(lr_decay_steps=0, ema_decay=0.999)
    opt = as_numpy(jax_train.make_optimizer(ema_cfg).init(state[0]))
    path = port_checkpoint(tmp_path / "ema", (state[0], opt))
    cfg = TrainConfig(num_feat=FEAT, num_block=BLOCKS, num_grow_ch=GROW,
                      lr_decay_steps=1)
    with pytest.raises(ValueError):           # the template differs
        CheckpointManager(path).restore(*init_training(cfg, device="cpu"))
    params, opt, step, restored = restore_flexible(CheckpointManager(path),
                                                   cfg, device="cpu")
    assert step == 7 and restored is False and opt.ema is None
    got = tree_to_numpy(params)
    assert jax.tree.structure(got) == jax.tree.structure(state[0])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state[0])):
        np.testing.assert_array_equal(a, b)


def test_engine_sizes_the_model_from_the_weights(tmp_path, state):
    """``realesrgan_x4.npz`` holding one block serves one block (the
    registry's 23 is not used); a width the kernel lacks is refused."""
    jax_save_params(state[0], tmp_path / "w" / "realesrgan_x4.npz")
    eng = SREngine("realesrgan_x4", weights_dir=tmp_path / "w",
                   dtype="float32", bgr_order=False, pad_probe=False,
                   device="cpu")
    assert eng.pretrained and len(eng.model.body) == BLOCKS
    narrow = TrainConfig(num_feat=8, num_block=BLOCKS, num_grow_ch=4,
                         lr_decay_steps=1)
    path = tmp_path / "narrow"
    CheckpointManager(path).save(7, *init_training(narrow, device="cpu"))
    with pytest.raises(ValueError, match="built for 64 features"):
        eval_trained.main(["--ckpt-dir", str(path), "--cpu", "--feat", "8",
                           "--blocks", str(BLOCKS), "--grow", "4",
                           "--eval-size", str(EVAL), "--eval-scenes", "1",
                           "--out", str(tmp_path / "narrow.json")])


def test_bicubic_stand_in_against_cv2():
    """The port's bicubic (``upscale_cubic`` rounded to uint8) against
    ``cv2.resize(INTER_CUBIC)`` on the eval's own three 192² LR scenes:
    off by at most 1, on at most 1e-5 of the values, bicubic PSNR within
    1e-5 dB (the docstring of ``cli/eval_trained.py`` quotes the
    measured shares)."""
    import torch

    from s2sr_tpu_torch.ops.resize import upscale_cubic

    for seed in (SEED, SEED + 1, SEED + 2):
        hr = jax_fields(size=(768, 768), seed=seed)
        lr = np.clip(np.round(jax_area_downsample(hr.astype(np.float32), 4)),
                     0, 255).astype(np.uint8)
        want = cv2.resize(lr, (768, 768), interpolation=cv2.INTER_CUBIC)
        got = upscale_cubic(torch.from_numpy(lr).float(), 4)
        got = got.round().clamp(0, 255).to(torch.uint8).numpy()
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-5, seed
        assert abs(jax_psnr(got, hr) - jax_psnr(want, hr)) <= 1e-5, seed
