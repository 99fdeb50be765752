"""The port's remaining CLIs against the JAX package: ``sr_cli`` (modes
edsr, realesrgan and farm, with ``--tile``), ``convert_weights`` (a
``.pth`` to JAX's ``.npz``; ``--from-ckpt`` without a checkpoint
refused) and ``warmup``
(``ops/_build.py::build_all`` and each hot path once), on the CPU."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from s2sr_tpu_torch.models.weights import init_state_dict
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    """A work directory for both packages' settings (``weights_dir`` from
    the environment) and EDSR at 16 features and 2 blocks in both
    registries."""
    from s2sr_tpu.config import settings as jsettings
    from s2sr_tpu.models import registry as jregistry
    from s2sr_tpu_torch.config import settings
    from s2sr_tpu_torch.models import registry
    from s2sr_tpu_torch.pipelines import super_resolution as sr

    monkeypatch.chdir(tmp_path)
    (tmp_path / "weights").mkdir()
    monkeypatch.setenv("WEIGHTS_DIR", str(tmp_path / "weights"))
    for reg in (jregistry, registry):
        monkeypatch.setitem(reg.MODELS, "edsr_x4", {
            "family": "edsr", "scale": 4, "channels": 16, "blocks": 2})
    for mod in (jsettings, settings):
        mod.get_settings.cache_clear()
    sr._MODEL_CACHE.clear()
    yield tmp_path
    for mod in (jsettings, settings):
        mod.get_settings.cache_clear()
    sr._MODEL_CACHE.clear()


def scene(path: Path, size=(24, 20), seed=3) -> Path:
    from s2sr_tpu_torch.fetch.synthetic import synthetic_scene

    synthetic_scene(path, size=size, seed=seed)
    return path


def test_sr_cli_edsr_matches_jax(cli_env, monkeypatch, capsys):
    """``--mode edsr --tile``: the same files, metadata and tiles as the
    JAX CLI on the same .npz weights; pixels within EDSR's bf16
    tolerance (0.05 of 255)."""
    import jax

    from s2sr_tpu.cli import sr_cli as jsr_cli
    from s2sr_tpu.geo import read_geotiff
    from s2sr_tpu.models.classic import EDSR
    from s2sr_tpu.models.weights import save_params
    from s2sr_tpu_torch.cli import sr_cli

    save_params(EDSR(4, 16, 2).init(jax.random.PRNGKey(3)),
                cli_env / "weights" / "edsr_x4.npz")
    tif = scene(cli_env / "scene.tif")
    zooms = ["--min-zoom", "12", "--max-zoom", "13"]
    sr_cli.main([str(tif), "-o", "torch", "--mode", "edsr", "--tile",
                 "--device", "cpu", *zooms])
    out = capsys.readouterr().out
    assert "SR complete" in out and "Tiles: z12-13" in out
    monkeypatch.setattr(sys, "argv", ["sr_cli", str(tif), "-o", "jax",
                                      "--mode", "edsr", "--tile", *zooms])
    jsr_cli.main()
    for d in ("torch", "jax"):
        assert (cli_env / d / "scene_sr_x4.png").exists()
    meta = [json.loads((cli_env / d / "scene_sr_metadata.json").read_text())
            for d in ("torch", "jax")]
    strip = lambda m: {k: v for k, v in m["sr_metadata"].items()
                       if k != "timing"}
    assert strip(meta[0]) == strip(meta[1])
    a = read_geotiff(cli_env / "torch" / "scene_sr_x4.tif")
    b = read_geotiff(cli_env / "jax" / "scene_sr_x4.tif")
    assert a.data.shape == b.data.shape == (96, 80, 3)
    assert np.abs(a.data.astype(int) - b.data.astype(int)).max() <= 0.05 * 255
    tiles = lambda d: sorted(p.relative_to(d).as_posix()
                             for p in d.rglob("*.png"))
    assert tiles(cli_env / "torch" / "tiles") == \
        tiles(cli_env / "jax" / "tiles") != []


@pytest.mark.parametrize("mode", ["realesrgan", "farm"])
def test_sr_cli_engine_modes(cli_env, mode, monkeypatch, capsys):
    """``realesrgan`` (the WOW pipeline) and ``farm`` on a one-block
    random-init ``realesrgan_x4`` (the kernel's widths) at a 24×20 scene,
    with tiles."""
    from s2sr_tpu_torch.cli import sr_cli
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.models import registry

    monkeypatch.setitem(registry.MODELS, "realesrgan_x4", dict(
        registry.MODELS["realesrgan_x4"], blocks=1))
    monkeypatch.setattr(engine_mod, "_ENGINE_CACHE", {})

    tif = scene(cli_env / "scene.tif")
    sr_cli.main([str(tif), "-o", "out", "--mode", mode, "--tile",
                 "--device", "cpu", "--min-zoom", "12", "--max-zoom", "12"])
    out = capsys.readouterr().out
    assert "SR complete" in out and "Tiles: z12-12" in out
    assert list((cli_env / "out" / "tiles").rglob("*.png"))


def tiny_pth(path: Path, wrap: str = "params_ema") -> Path:
    sd = init_state_dict(num_feat=64, num_block=2, seed=5)
    g = torch.Generator().manual_seed(6)
    sd = {k: v + 0.01 * torch.randn(v.shape, generator=g)
          for k, v in sd.items()}
    torch.save({wrap: sd}, path)
    return path


@pytest.mark.parametrize("wrap", ["params_ema", "params"])
def test_convert_weights_npz_equals_jax(tmp_path, wrap, capsys):
    """The .npz the port writes from a .pth has JAX's keys and values,
    and the port's engine loads it as the same state dict."""
    from s2sr_tpu.models.weights import convert_checkpoint as jconvert
    from s2sr_tpu_torch.cli import convert_weights
    from s2sr_tpu_torch.models.weights import load_params

    pth = tiny_pth(tmp_path / "model.pth", wrap)
    convert_weights.main([str(pth), "-o", str(tmp_path / "port.npz")])
    assert "Converted" in capsys.readouterr().out
    jconvert(pth, tmp_path / "jax.npz")
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in got.files:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    sd = torch.load(pth, weights_only=True)[wrap]
    loaded = load_params(tmp_path / "port.npz")
    assert sorted(loaded) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


def test_convert_weights_from_ckpt_refused(tmp_path, capsys):
    """``--from-ckpt`` on a directory without a training checkpoint exits
    non-zero and writes nothing; no source at all is a usage error."""
    from s2sr_tpu_torch.cli import convert_weights

    for argv in (["--from-ckpt", str(tmp_path)],
                 ["--from-ckpt", str(tmp_path), "--family", "swinir",
                  "--ema"]):
        with pytest.raises(SystemExit) as exc:
            convert_weights.main(argv)
        assert exc.value.code not in (0, None)
        assert "no checkpoints" in str(exc.value.code)
    assert not list(tmp_path.iterdir())
    with pytest.raises(SystemExit) as exc:
        convert_weights.main([])
    assert exc.value.code == 2


def test_build_all_host_library_cached(tmp_path, monkeypatch):
    """Without CUDA, ``build_all`` builds the native PNG encoder alone
    into the build directory, then finds it cached."""
    from s2sr_tpu_torch import native
    from s2sr_tpu_torch.ops import _build

    monkeypatch.setenv("S2SR_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_attempted", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    first = _build.build_all()
    assert list(first) == ["pngenc"]
    assert first["pngenc"]["cached"] is False
    monkeypatch.setattr(native, "_attempted", False)
    monkeypatch.setattr(native, "_lib", None)
    second = _build.build_all()
    native_built = first["pngenc"]["encoder"] == "native"
    assert second["pngenc"]["cached"] is native_built
    assert second["pngenc"]["encoder"] == first["pngenc"]["encoder"]
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == [
        "matmul_chain", "rdb", "rdb_ladder", "rdb_ladder_tc",
        "window_attention"]


def test_warmup_on_cpu_tiny_engine(tmp_path, monkeypatch, capsys):
    """``warmup`` on the CPU with a one-block RRDBNet (the kernel's widths)
    and ``--full-size 0``: the build line, the JAX package's "warmed"
    lines in its order, the launch line and the end line."""
    from s2sr_tpu_torch.cli import warmup
    from s2sr_tpu_torch.models import engine as engine_mod
    from s2sr_tpu_torch.models import registry

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("S2SR_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setitem(registry.MODELS, "tiny_x4", dict(
        registry.MODELS["realesrgan_x4"], blocks=1))
    monkeypatch.setattr(engine_mod, "_ENGINE_CACHE", {})
    warmup.main(["--models", "tiny_x4", "--full-size", "0",
                 "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    warmed = [ln.rsplit(" (", 1)[0].strip() for ln in lines if "warmed" in ln]
    assert warmed == ["warmed kernel libraries (1)",
                      "warmed tiny_x4: masked-bucket serving",
                      "warmed WOW + farm enhancement chains (2048^2)",
                      "warmed tile warp",
                      "warmed vector mask + segmentation chains"]
    assert any("pngenc in" in ln for ln in lines)
    assert lines[-2] == ("kernel launches: rdb 0, rdb_f32 0, rdb_i8 0, "
                         "swin_block 0, window_attention 0")
    assert lines[-1].startswith("warmup done in ")
    engine = engine_mod._ENGINE_CACHE[next(iter(engine_mod._ENGINE_CACHE))]
    assert engine.chunks_dispatched == 1
