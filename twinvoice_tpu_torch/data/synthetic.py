"""The helpers of ``twinvoice_tpu.data.synthetic`` (copied): the ROC date,
the two QR payloads of a TW e-invoice, labelme shapes of ground-truth boxes
and the training-font registry (:func:`train_fonts`). ``render_invoice`` and
``heldout_fonts`` are not ported yet (``ROADMAP.md``, queue 1)."""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path
from typing import Dict, List, Tuple

BUNDLED_FONTS = Path(__file__).resolve().parents[1] / "ocr" / "fonts" / "ttf"

_DEJAVU = "/usr/share/fonts/truetype/dejavu"
_SYSTEM_FONTS = ("DejaVuSansMono.ttf", "DejaVuSans.ttf", "DejaVuSerif.ttf",
                 "DejaVuSansMono-Bold.ttf", "DejaVuSans-Bold.ttf")
# the two *Display.ttf supplements render no basic-latin glyphs: excluded
_MPL_FONTS = ("DejaVuSans-Oblique.ttf", "DejaVuSans-BoldOblique.ttf",
              "DejaVuSansMono-Oblique.ttf", "DejaVuSansMono-BoldOblique.ttf",
              "DejaVuSerif-Bold.ttf", "DejaVuSerif-Italic.ttf",
              "DejaVuSerif-BoldItalic.ttf")


def _package_dir(name: str) -> str:
    """A package's directory, found without importing it ('' if absent)."""
    try:
        spec = importlib.util.find_spec(name)
    except (ImportError, ValueError):
        return ""
    if spec is None or not spec.submodule_search_locations:
        return ""
    return list(spec.submodule_search_locations)[0]


def train_fonts() -> List[str]:
    """The training typefaces, in the JAX registry's order
    (``twinvoice_tpu/data/synthetic.py:train_fonts``): five DejaVu files from
    the system's font directory, seven from matplotlib's, Atkinson
    Hyperlegible Next from mujoco and gymnasium's Minecraft. Each candidate
    is the copy bundled under ``ocr/fonts/ttf`` if there is one (the twelve
    DejaVu files and Atkinson, whose licences are stated beside them), else
    the JAX package's own path where that file exists. The held-out families
    are never listed."""
    mpl = _package_dir("matplotlib")
    mpl = os.path.join(mpl, "mpl-data", "fonts", "ttf") if mpl else ""
    mujoco = _package_dir("mujoco")
    gym = _package_dir("gymnasium")
    cands = [(f, os.path.join(_DEJAVU, f)) for f in _SYSTEM_FONTS]
    cands += [(f, os.path.join(mpl, f) if mpl else "") for f in _MPL_FONTS]
    atk = "AtkinsonHyperlegibleNext[wght].ttf"
    cands.append((atk, os.path.join(mujoco, "experimental", "studio", "assets", atk) if mujoco else ""))
    cands.append(("Minecraft.ttf", os.path.join(gym, "envs", "toy_text", "font", "Minecraft.ttf")
                  if gym else ""))
    out = []
    for name, own in cands:
        bundled = BUNDLED_FONTS / name
        if bundled.is_file():
            out.append(str(bundled))
        elif own and os.path.exists(own):
            out.append(own)
    return out


def iso_to_roc(date_iso: str) -> str:
    """``2025-09-09`` → ``1140909`` (ROC calendar)."""
    y, m, d = date_iso.split("-")
    return f"{int(y) - 1911}{int(m):02d}{int(d):02d}"


def header_qr_payload(invoice_no: str, date_iso: str, amount: int = 0) -> str:
    """Realistic header-QR payload: number + ROC date + random-looking tail."""
    return f"{invoice_no}{iso_to_roc(date_iso)}1234:{amount:08x}:0:0:0:AAAA/BBBBCCCC=="


def items_qr_payload(items: List[dict]) -> str:
    body = ":".join(f"{it['name']}:{it['qty']}:{it['price']}" for it in items)
    return "**" + body


def labelme_shapes(boxes: Dict[str, Tuple[int, int, int, int]]) -> List[dict]:
    """Ground-truth boxes → labelme polygon shapes (for ``data.labelme``)."""
    shapes = []
    for label, (x1, y1, x2, y2) in boxes.items():
        shapes.append(
            {"label": label, "points": [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]}
        )
    return shapes
