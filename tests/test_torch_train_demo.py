"""The port's ``cli/train_demo.py`` on the CPU at a tiny size: the device
pipeline with the second-order chain, 2 L1 and 2 GAN steps, the EMA and
the degraded evaluation; then a GAN-only run on the host pipeline
(``PairSampler`` + ``prefetch``, one step per call) warm-started from the
first run's checkpoint, which checkpoints the post-GAN params. The JSON
report has the keys of ``scripts/train_demo.py``'s, read from its source
(running the JAX script would compile its whole trainer)."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from s2sr_tpu_torch.cli import train_demo
from s2sr_tpu_torch.training.checkpoint import CheckpointManager
from torch_threads import one_torch_thread  # noqa: F401

TINY = ["--cpu", "--batch", "2", "--crop", "16", "--feat", "8", "--blocks",
        "1", "--grow", "4", "--pool", "2", "--eval-size", "16",
        "--eval-scenes", "1"]


def jax_report_keys() -> dict:
    """``report``'s keys in the JAX script, a nested dict's keys under
    its own."""
    src = Path(__file__).resolve().parent.parent / "scripts" / "train_demo.py"
    for node in ast.walk(ast.parse(src.read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "report"
                        for t in node.targets)):
            return {k.value: (sorted(kk.value for kk in v.keys)
                              if isinstance(v, ast.Dict) else None)
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no report dict in scripts/train_demo.py")


def keys_of(report: dict) -> dict:
    return {k: sorted(v) if isinstance(v, dict) and k in (
        "config", "degradation") else None for k, v in report.items()}


def test_train_demo_cpu_report_and_checkpoints(tmp_path, capsys):
    out = tmp_path / "demo.json"
    train_demo.main(TINY + [
        "--steps", "2", "--chunk", "2", "--gan-steps", "2",
        "--second-order", "--eval-degraded", "--ema-decay", "0.9",
        "--ckpt-dir", str(tmp_path / "l1"), "--out", str(out)])
    log = capsys.readouterr().out
    rep = json.loads(out.read_text())
    assert keys_of(rep) == jax_report_keys()
    assert rep["platform"] == "cpu"
    assert rep["degradation"]["second_order"] is True
    assert rep["config"]["l1_steps"] == 2 and rep["config"]["gan_steps"] == 2
    assert np.isfinite([rep["l1_loss_first"], rep["l1_loss_last"]]).all()
    assert len(rep["gan_metrics_every10"]) == 1
    assert set(rep["gan_metrics_every10"][0]) == {"g_loss", "d_loss",
                                                  "pixel", "adv"}
    for leg in ("bicubic", "bicubic_degraded", "model_init", "after_l1",
                "after_l1_ema", "after_l1_degraded", "after_gan"):
        assert np.isfinite(rep[leg]["psnr"]), leg
    assert "saved L1 params+opt" in log and "GAN: 2 steps" in log
    assert CheckpointManager(tmp_path / "l1").latest_step == 2

    # GAN only, per call on the host pipeline, from the L1 checkpoint
    out2 = tmp_path / "gan.json"
    train_demo.main(TINY + [
        "--steps", "0", "--pipeline", "host", "--chunk", "1",
        "--gan-steps", "1", "--init-ckpt", str(tmp_path / "l1"),
        "--ckpt-dir", str(tmp_path / "gan"), "--out", str(out2)])
    log = capsys.readouterr().out
    rep = json.loads(out2.read_text())
    assert keys_of(rep) == jax_report_keys()
    assert rep["l1_loss_first"] is None and rep["after_gan"] is not None
    assert "warm-start params from" in log
    assert CheckpointManager(tmp_path / "gan").latest_step == 3
