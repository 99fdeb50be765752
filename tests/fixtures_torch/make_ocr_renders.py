"""Write ``s2sr_tpu_torch/decode/ocr_eval_renders.npz``: the clean renders
of ``scripts/ocr_eval.py::render`` that the port's ``cli/ocr_eval.py``
reads in its place (the card's machine has no PIL).

One render per serial of the script's ``SERIALS`` for each (font, size,
rotation) of the port's ``CONDITIONS``, drawn by the script's own
``render`` with no noise (a clean render depends only on its text; the
port adds the seeded noise as the script does). Each array is named by
``render_key(font, size, rot, serial index)``.

Run from the repository root, where PIL, the DejaVu fonts and the JAX
package are installed:

    python tests/fixtures_torch/make_ocr_renders.py
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

DEJAVU = "/usr/share/fonts/truetype/dejavu"


def jax_script():
    """``scripts/ocr_eval.py`` as a module (it pins JAX to the CPU)."""
    spec = importlib.util.spec_from_file_location(
        "ocr_eval_script", ROOT / "scripts" / "ocr_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def font_arg(font: str) -> str:
    """The script's ``font`` argument for a condition's face name."""
    return font if font == "default" else f"{DEJAVU}/{font}.ttf"


def clean_renders(script) -> dict:
    from s2sr_tpu_torch.cli.ocr_eval import CONDITIONS, render_key

    return {render_key(font, size, rot, i): script.render(
                text, font_arg(font), size, rot=rot)
            for font, size, rot in CONDITIONS
            for i, text in enumerate(script.SERIALS)}


def main() -> None:
    from s2sr_tpu_torch.cli.ocr_eval import RENDERS

    np.savez_compressed(RENDERS, **clean_renders(jax_script()))


if __name__ == "__main__":
    main()
