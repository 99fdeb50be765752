"""``s2sr_tpu_torch`` and ``chip_smoke.py`` import with ``jax`` and
``s2sr_tpu`` blocked, and no source line imports either."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

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
            "s2sr_tpu_torch.bench.rdb_ladder"} <= set(mods) and len(mods) >= 29
    code = "\n".join([
        "import sys",
        "for name in ('jax', 'jaxlib', 's2sr_tpu', 'PIL', 'pydantic'):",
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
