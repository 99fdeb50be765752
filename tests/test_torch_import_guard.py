"""``s2sr_tpu_torch`` and ``chip_smoke.py`` import with ``jax``,
``s2sr_tpu``, ``PIL``, ``pydantic``, ``requests`` and ``cv2`` blocked
(the card's machine has none of the last four: the fetch clients speak
``urllib``), and no source line imports ``jax`` or ``s2sr_tpu``. The decode package's OCR builds its
templates from the committed glyph file without PIL."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "s2sr_tpu_torch"


def all_modules():
    import s2sr_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(
        s2sr_tpu_torch.__path__, "s2sr_tpu_torch."))


def test_modules_import_with_jax_blocked():
    mods = all_modules()
    assert {"s2sr_tpu_torch.ops.rdb", "s2sr_tpu_torch.ops.window_attention",
            "s2sr_tpu_torch.models.swinir", "s2sr_tpu_torch.ops.rdb_ladder",
            "s2sr_tpu_torch.bench.rdb_ladder", "s2sr_tpu_torch.ops.matmul_chain",
            "s2sr_tpu_torch.bench.mxu", "s2sr_tpu_torch.bench.peak",
            "s2sr_tpu_torch.utils.files", "s2sr_tpu_torch.utils.validation",
            "s2sr_tpu_torch.pipelines.farm_sr", "s2sr_tpu_torch.cli.farm_sr",
            "s2sr_tpu_torch.fetch.smart_fetch", "s2sr_tpu_torch.geo.warp",
            "s2sr_tpu_torch.tiles.mercator", "s2sr_tpu_torch.tiles.pyramid",
            "s2sr_tpu_torch.tiles.tiling", "s2sr_tpu_torch.server.http",
            "s2sr_tpu_torch.server.jobs", "s2sr_tpu_torch.server.persistence",
            "s2sr_tpu_torch.server.app", "s2sr_tpu_torch.cli.serve",
            "s2sr_tpu_torch.models.rrdbnet_int8", "s2sr_tpu_torch.tiles.jpeg",
            "s2sr_tpu_torch.parallel.mesh", "s2sr_tpu_torch.parallel.comm",
            "s2sr_tpu_torch.parallel.tensor",
            "s2sr_tpu_torch.parallel.pipeline",
            "s2sr_tpu_torch.parallel.spatial",
            "s2sr_tpu_torch.vectors", "s2sr_tpu_torch.vectors.ops",
            "s2sr_tpu_torch.vectors.geometry",
            "s2sr_tpu_torch.vectors.extraction",
            "s2sr_tpu_torch.vectors.synthetic",
            "s2sr_tpu_torch.tiles.bmp", "s2sr_tpu_torch.tiles.gif",
            "s2sr_tpu_torch.tiles.webp", "s2sr_tpu_torch.tiles.tiff",
            "s2sr_tpu_torch.tiles.jpeg_arith",
            "s2sr_tpu_torch.vectors.extraction_v2",
            "s2sr_tpu_torch.pipelines.generate_vectors",
            "s2sr_tpu_torch.cli.generate_vectors",
            "s2sr_tpu_torch.cli.vectors_v2",
            "s2sr_tpu_torch.decode", "s2sr_tpu_torch.decode.galois",
            "s2sr_tpu_torch.decode.qr_tables",
            "s2sr_tpu_torch.decode.qr_decode",
            "s2sr_tpu_torch.decode.qr_encode",
            "s2sr_tpu_torch.decode.serial", "s2sr_tpu_torch.decode.locate",
            "s2sr_tpu_torch.decode.ocr", "s2sr_tpu_torch.decode.service",
            "s2sr_tpu_torch.tiles.zstd", "s2sr_tpu_torch.tiles.ccitt",
            "s2sr_tpu_torch.tiles.lab",
            "s2sr_tpu_torch.fetch.client", "s2sr_tpu_torch.fetch.multiband",
            "s2sr_tpu_torch.geo.cog", "s2sr_tpu_torch.native",
            "s2sr_tpu_torch.utils.retry",
            "s2sr_tpu_torch.pipelines.esrgan_tiles",
            "s2sr_tpu_torch.cli.fetch", "s2sr_tpu_torch.cli.fetch_scene",
            "s2sr_tpu_torch.cli.multiband", "s2sr_tpu_torch.cli.tile",
            "s2sr_tpu_torch.cli.esrgan_tiles",
            "s2sr_tpu_torch.ops.resize", "s2sr_tpu_torch.models.classic",
            "s2sr_tpu_torch.models.pb_reader",
            "s2sr_tpu_torch.models.graph_executor",
            "s2sr_tpu_torch.pipelines.super_resolution",
            "s2sr_tpu_torch.cli.sr_cli", "s2sr_tpu_torch.cli.convert_weights",
            "s2sr_tpu_torch.cli.warmup",
            "s2sr_tpu_torch.training", "s2sr_tpu_torch.training.train",
            "s2sr_tpu_torch.training.data",
            "s2sr_tpu_torch.training.checkpoint",
            "s2sr_tpu_torch.cli.train", "s2sr_tpu_torch.cli.evaluate",
            "s2sr_tpu_torch.ops.jpeg", "s2sr_tpu_torch.utils.metrics",
            "s2sr_tpu_torch.training.degradation",
            "s2sr_tpu_torch.training.gan", "s2sr_tpu_torch.cli.train_demo",
            } <= set(mods) and len(mods) >= 119
    code = "\n".join([
        "import sys",
        "for name in ('jax', 'jaxlib', 's2sr_tpu', 'PIL', 'pydantic',"
        " 'requests', 'cv2'):",
        "    sys.modules[name] = None",
        "import importlib",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "for p in chip_smoke.PHASES:",
        "    getattr(chip_smoke, 'phase_' + p)",
        "from s2sr_tpu_torch.ops import _build",
        "assert _build.lib_path('rdb').name.startswith('librdb_')",
        "assert _build.lib_path('window_attention').name.startswith("
        "'libwindow_attention_')",
        "assert _build.lib_path('rdb_ladder').name.startswith("
        "'librdb_ladder_')",
        "assert 'ladder' in chip_smoke.PHASES",
        "assert 'rdb_ladder' in chip_smoke.KERNEL_SOURCES",
        "assert _build.lib_path('matmul_chain').name.startswith("
        "'libmatmul_chain_')",
        "assert 'mxu' in chip_smoke.PHASES",
        "assert 'matmul_chain' in chip_smoke.KERNEL_SOURCES",
        "assert 'server' in chip_smoke.PHASES",
        "assert 'vectors' in chip_smoke.PHASES",
        "assert 'decode' in chip_smoke.PHASES",
        "assert 'fetch' in chip_smoke.PHASES",
        "assert {'classic', 'warmup'} <= set(chip_smoke.PHASES)",
        "assert 'train' in chip_smoke.PHASES",
        "from s2sr_tpu_torch.training import train",
        "assert train.make_pool_sampler(2, 16, 2).crop_hr == 32",
        "from s2sr_tpu_torch.ops._build import build_all",
        "from s2sr_tpu_torch.fetch import client, smart_fetch",
        "assert smart_fetch.STAC_URL == client.EARTH_SEARCH",
        "from s2sr_tpu_torch.decode.ocr import _atlas",
        "assert _atlas()[0].shape == (222, 432)",
        "from s2sr_tpu_torch.ops import rdb",
        "assert callable(rdb.rdb_i8) and rdb.LAUNCHES_I8 == 0",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|s2sr_tpu)(?:[.\s]|$)",
                     re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PKG.rglob("*.py"),
                                         ROOT / "chip_smoke.py"]))
def test_no_jax_or_reference_imports(path):
    src = (ROOT / path).read_text()
    assert not _IMPORT.findall(src), path
    assert "importlib.import_module(\"s2sr_tpu.\"" not in src


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Run alone, or here without CUDA, the smoke script fails and prints
    no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
