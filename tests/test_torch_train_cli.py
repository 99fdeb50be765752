"""The port's training entry points on the CPU: ``cli.train`` (both
pipelines, the degradations, resume) and ``cli.evaluate`` in child
processes, ``convert_weights --from-ckpt`` exporting a checkpoint bit for
bit as the ``.npz`` both packages load."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--blocks", "1",
        "--feat", "8", "--grow", "4", "--batch", "2", "--pool", "2"]


def child(module: str, *args, cwd: Path) -> str:
    out = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                         cwd=cwd, capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
                              "HOME": str(cwd)})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cli_train_device_then_resume_host(tmp_path):
    ck = tmp_path / "ck"
    out = child("s2sr_tpu_torch.cli.train", *TINY, "--steps", "2",
                "--chunk", "2", "--crop", "8", "--ckpt-dir", ck,
                "--ema-decay", "0.9", cwd=tmp_path)
    assert "pipeline=device" in out and "device=cpu" in out
    assert "step 2/2: loss" in out and "saved checkpoint at step 2" in out
    out = child("s2sr_tpu_torch.cli.train", *TINY, "--steps", "2",
                "--pipeline", "host", "--crop", "16", "--jpeg", "30,95",
                "--blur-sigma", "1.0", "--noise-std", "0.01",
                "--ema-decay", "0.9", "--ckpt-dir", ck, "--resume",
                cwd=tmp_path)
    assert "resumed from step 2" in out and "schedule kind" not in out
    assert "step 4: loss" in out and "saved checkpoint at step 4" in out
    assert sorted(p.name for p in ck.iterdir()) == ["2", "4"]


def test_convert_weights_from_ckpt_roundtrip(tmp_path, capsys):
    """A checkpoint's params (and its EMA) exported bit for bit; JAX's
    loader reads the same arrays."""
    from s2sr_tpu.models.weights import load_params as jload
    from s2sr_tpu_torch.cli import convert_weights
    from s2sr_tpu_torch.models.weights import (load_npz_tree, load_params,
                                               tree_flatten, tree_to_numpy)
    from s2sr_tpu_torch.training import CheckpointManager, TrainConfig
    from s2sr_tpu_torch.training.train import (init_training,
                                               make_train_step)

    import torch

    cfg = TrainConfig(num_feat=64, num_block=1, num_grow_ch=32,
                      dtype="float32", lr_decay_steps=3, ema_decay=0.9)
    params, opt = init_training(cfg, seed=4, device="cpu")
    step, _ = make_train_step(cfg)
    rng = np.random.default_rng(0)
    hr = torch.from_numpy(rng.random((1, 32, 32, 3), dtype=np.float32))
    params, opt, _ = step(params, opt, hr[:, ::4, ::4], hr)
    CheckpointManager(tmp_path / "ck").save(1, params, opt)
    for ema, tree in ((False, params), (True, opt.ema)):
        out = tmp_path / f"x4_{ema}.npz"
        argv = ["--from-ckpt", str(tmp_path / "ck"), "--blocks", "1",
                "-o", str(out)] + (["--ema"] if ema else [])
        convert_weights.main(argv)
        assert ("params_ema" if ema else "(params)") in capsys.readouterr().out
        want = tree_flatten(tree_to_numpy(tree))[0]
        got = tree_flatten(load_npz_tree(out))[0]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        jtree = jload(out)
        for a, b in zip(tree_flatten(jtree)[0], want):
            assert np.array_equal(np.asarray(a), b)
        sd = load_params(out)
        assert sd["body.0.rdb1.conv1.weight"].shape == (32, 64, 3, 3)
    convert_weights.main(["--from-ckpt", str(tmp_path / "ck"), "--blocks",
                          "1", "--model-name", "mine"])
    assert (tmp_path / "ck" / "mine.npz").exists()
    with pytest.raises(SystemExit) as exc:
        convert_weights.main(["--from-ckpt", str(tmp_path / "ck")])
    assert "differs" in str(exc.value.code) or "template" in str(exc.value.code)


def test_cli_evaluate_equals_jax(tmp_path, monkeypatch):
    from s2sr_tpu.cli import evaluate as jeval
    from s2sr_tpu_torch.geo import GeoTiff, write_geotiff
    from s2sr_tpu_torch.tiles.png import encode_png

    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-4, 5, a.shape), 0, 255
                ).astype(np.uint8)
    for name, img in (("a", a), ("b", b)):
        (tmp_path / f"{name}.png").write_bytes(encode_png(img))
        write_geotiff(GeoTiff(data=img), tmp_path / f"{name}.tif")
        tile = tmp_path / f"t{name}" / "12" / "3"
        tile.mkdir(parents=True)
        (tile / "4.png").write_bytes(encode_png(img))
        (tile / "5.png").write_bytes(encode_png(a))
    import contextlib
    import io

    from s2sr_tpu_torch.cli import evaluate as peval

    def run(main, pair):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([str(tmp_path / p) for p in pair])
        return json.loads(buf.getvalue())

    def jmain(argv):
        monkeypatch.setattr(sys, "argv", ["evaluate", *argv])
        jeval.main()

    for pair in (("a.png", "b.png"), ("a.tif", "b.tif"), ("a.png", "a.png"),
                 ("ta", "tb")):
        assert run(peval.main, pair) == run(jmain, pair), pair
    got = child("s2sr_tpu_torch.cli.evaluate", "ta", "tb", cwd=tmp_path)
    assert json.loads(got) == run(jmain, ("ta", "tb"))
