"""Synthetic Taiwanese e-invoices (``twinvoice_tpu.data.synthetic``)
without Pillow, FreeType or OpenCV: :func:`render_invoice` draws a
receipt-like page with the three text fields at known positions and the two
real QR codes (header and TEXT items, ``qr.encode``), and returns the
ground-truth boxes; the ROC date, the QR payloads, labelme shapes of the
boxes, and the font registries (:func:`train_fonts`, :func:`heldout_fonts`).

The pages equal the JAX package's byte for byte: the text through
``ocr.fonts.truetype`` (FreeType and raqm as Pillow 12.1 runs them) and
``ops.host_pildraw`` (Pillow's drawing), the stylised values through
``ops.host_image``'s 2×2 morphology and ``ops.host_warp``'s
``warpAffine``, the dot-matrix print through ``ocr.torchocr.data.dot_matrix``.
"""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

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


# the held-out typefaces, in the JAX registry's order: (file, package, path in it)
_HELDOUT = (
    ("STIXGeneral.ttf", "matplotlib", ("mpl-data", "fonts", "ttf")),
    ("STIXGeneralBol.ttf", "matplotlib", ("mpl-data", "fonts", "ttf")),
    ("cmr10.ttf", "matplotlib", ("mpl-data", "fonts", "ttf")),
    ("cmss10.ttf", "matplotlib", ("mpl-data", "fonts", "ttf")),
    ("freesansbold.ttf", "pygame", ()),
    ("sans.ttf", "pygame", ("examples", "data")),
    ("PlayfairDisplaySemibold.ttf", "pygame", ("tests", "fixtures", "fonts")),
)


def heldout_fonts() -> List[str]:
    """The held-out typefaces the gauntlet's font tier draws with, never
    trained on, in the JAX registry's order
    (``twinvoice_tpu/data/synthetic.py:heldout_fonts``): STIX General and
    its bold, Computer Modern Roman and Sans (matplotlib), FreeSans Bold,
    Liberation Sans and Playfair Display Semibold (pygame). Each is the
    copy bundled under ``ocr/fonts/ttf`` where there is one (all but
    Liberation Sans, whose licence is not stated), else the package's own
    file where it exists; only where none exists at all, the training
    fonts, as JAX's falls back."""
    out = []
    for name, package, sub in _HELDOUT:
        bundled = BUNDLED_FONTS / name
        if bundled.is_file():
            out.append(str(bundled))
            continue
        root = _package_dir(package)
        own = os.path.join(root, *sub, name) if root else ""
        if own and os.path.exists(own):
            out.append(own)
    return out or train_fonts()


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


def _draw_stylized_value(img, text, font, xy, line_h, rng, stylize):
    """Draw ``text`` through a random typography transform and paste it at
    ``xy`` on ``img`` (an RGB ``host_pildraw.Image``). → the ground-truth box
    (x1, y1, x2, y2) of the pasted ink.

    Each effect is scaled by ``stylize``: tracking (0..4 px a character),
    weight (a 2×2 erosion, bolder, or dilation, lighter), a slant shear
    within ±0.30 and a horizontal stretch ×(0.78..1.35).
    """
    from twinvoice_tpu_torch.ops.host_image import dilate2x2, erode2x2
    from twinvoice_tpu_torch.ops.host_pildraw import Draw, Image
    from twinvoice_tpu_torch.ops.host_warp import warp_affine_u8

    x, y = xy
    tracking = int(round(rng.uniform(0, 4) * stylize * (rng.uniform() < 0.5)))
    # render onto a generous grayscale tile (white paper, black ink)
    pad = 8
    est_w = int(sum(font.getlength(ch) for ch in text)
                + tracking * len(text) + 2 * pad + 8)
    tile = Image.new("L", (est_w, line_h + 2 * pad + 8), 255)
    td = Draw(tile)
    cx = pad
    for ch in text:
        td.text((cx, pad), ch, fill=0, font=font)
        cx += font.getlength(ch) + tracking
    t = tile.array

    r = rng.uniform()
    if r < 0.35 * stylize:
        t = erode2x2(t)       # ink spreads: bolder
    elif r < 0.6 * stylize:
        t = dilate2x2(t)      # ink shrinks: lighter
    shear = rng.uniform(-0.30, 0.30) * stylize
    sx = 1.0 + rng.uniform(-0.22, 0.35) * stylize
    h0, w0 = t.shape
    m = np.array([[sx, shear, abs(shear) * h0], [0, 1, 0]], np.float32)
    w1 = int(w0 * sx + abs(shear) * h0 + 2)
    t = warp_affine_u8(t, m, (w1, h0), value=255)

    ys, xs = np.where(t < 200)
    if len(xs) == 0:  # degenerate; fall back to plain drawing
        Draw(img).text((x, y), text, fill=(20, 20, 20), font=font)
        return (x, y, int(x + font.getlength(text)), y + line_h)
    # columns cropped to the ink, rows kept at the cursor band (pad ..
    # pad + line_h ↔ image rows y .. y + line_h): the box convention
    # (x, y, x + text width, y + line_h) of the unstylised values
    x0i, x1i = xs.min(), xs.max() + 1
    t = t[pad : pad + line_h, x0i:x1i]
    # composite: multiply ink onto the (noisy paper) background
    region = img.crop((x, y, x + t.shape[1], y + t.shape[0])).array
    if region.shape[:2] != t.shape:  # clipped at the page edge
        t = t[: region.shape[0], : region.shape[1]]
    ink = (t.astype(np.float32) / 255.0)[..., None]
    out = (region.astype(np.float32) * ink + 20.0 * (1 - ink)).astype(np.uint8)
    img.paste(Image.fromarray(out), (x, y))
    return (x, y, x + t.shape[1], y + t.shape[0])


GT_INK_MARGIN = 3  # px of whitespace an annotator leaves around the ink


def _ink_anchor_v(img, box, y_cursor, line_h):
    """Re-anchor a ground-truth box's vertical extent on the visible ink
    (rows of Pillow's luma < 128 in the box's columns, ± GT_INK_MARGIN), as
    a person drawing labelme polygons around visible text would; a box
    over no ink keeps the cursor band."""
    x1, _, x2, _ = box
    w, h = img.size
    ry1 = max(0, y_cursor - 6)
    ry2 = min(h, y_cursor + line_h + 8)
    region = img.crop((x1, ry1, min(x2, w), ry2)).convert("L").array
    ys = np.where((region < 128).any(axis=1))[0]
    if len(ys) == 0:  # degenerate: keep the cursor band
        return box
    ny1 = max(0, ry1 + int(ys.min()) - GT_INK_MARGIN)
    ny2 = min(h, ry1 + int(ys.max()) + 1 + GT_INK_MARGIN)
    return (x1, ny1, x2, ny2)


def render_invoice(
    invoice_no: str = "AB12345678",
    date_iso: str = "2025-09-09",
    amount: int = 120,
    items: Optional[List[dict]] = None,
    size: Tuple[int, int] = (440, 640),
    seed: int = 0,
    font_path: Optional[str] = None,
    font_size: int = 22,
    layout_jitter: float = 0.0,
    stylize: float = 0.0,
    gt_anchor: str = "ink",
    dot_print: bool = False,
):
    """→ (RGB ``host_pildraw.Image``, field → (x1, y1, x2, y2) ground-truth
    boxes), the JAX package's page and boxes.

    ``font_path``/``font_size`` select the value typeface (default
    DejaVuSansMono 22); the CJK labels are drawn in Pillow's default font.
    ``layout_jitter`` ∈ [0, 1] randomises the field positions and order;
    ``stylize`` ∈ [0, 1] draws each value through
    :func:`_draw_stylized_value` (0 keeps the plain rendering).
    ``dot_print`` re-prints the drawn text through the dot-matrix printhead
    (``ocr.torchocr.data.dot_matrix``, pitch 2) before the QR codes are
    pasted. ``gt_anchor``: "ink" (default) anchors each box's vertical
    extent on the rendered ink ± GT_INK_MARGIN (:func:`_ink_anchor_v`);
    "cursor" keeps the (x, y, x + text width, y + line_h) band.
    A font file that does not exist raises ``FileNotFoundError``.
    """
    from twinvoice_tpu_torch.ocr.fonts.truetype import FreeTypeFont
    from twinvoice_tpu_torch.ops.host_pildraw import Draw, Image
    from twinvoice_tpu_torch.qr.encode import render_qr

    if items is None:
        items = [{"name": "синt", "qty": 1, "price": amount}]

    w, h = size
    rng = np.random.default_rng(seed)
    bg = np.full((h, w, 3), 245, np.uint8)
    bg += rng.integers(0, 8, bg.shape, dtype=np.uint8)  # paper noise
    img = Image.fromarray(bg)
    draw = Draw(img)

    boxes: Dict[str, Tuple[int, int, int, int]] = {}
    font = FreeTypeFont(font_path or str(BUNDLED_FONTS / "DejaVuSansMono.ttf"), font_size)
    line_h = int(font_size * 1.2)

    def value_line(label_text, value_text, x, y):
        """CJK label in the small default font (cosmetic), Latin/digit value
        in the print font: the ground-truth box covers the value."""
        draw.text((x - 90, y + 6), label_text, fill=(20, 20, 20))
        if stylize > 0:
            box = _draw_stylized_value(img, value_text, font, (x, y),
                                       line_h, rng, float(stylize))
        else:
            draw.text((x, y), value_text, fill=(20, 20, 20), font=font)
            tw = draw.textlength(value_text, font=font)
            box = (x, y, int(x + tw), y + line_h)
        if gt_anchor == "ink":
            box = _ink_anchor_v(img, box, y, line_h)
        return box

    j = float(np.clip(layout_jitter, 0.0, 1.0))
    x0 = 120 + int(rng.integers(-30, 60) * j)
    y0 = 55 + int(rng.integers(-20, 80) * j)
    gap = 40 + int(rng.integers(-8, 30) * j)
    order = ["invoice_no", "date", "total_amount"]
    if j > 0 and rng.uniform() < 0.5 * j:
        rng.shuffle(order)
    texts = {
        "invoice_no": ("發票號碼", f"{invoice_no[:2]}-{invoice_no[2:]}"),
        "date": ("日期", date_iso),
        "total_amount": ("總計", str(amount)),
    }
    draw.text((150, 20), "電子發票證明聯", fill=(10, 10, 10))
    for i, field in enumerate(order):
        label, value = texts[field]
        boxes[field] = value_line(label, value, x0, y0 + i * gap)

    if dot_print:
        from twinvoice_tpu_torch.ocr.torchocr.data import dot_matrix

        gray = img.convert("L").array.astype(np.float32)
        # pitch 2: the values' cap heights are 13-19 px (font sizes 18-27),
        # 6.5-9.5 dots a glyph, a 9-pin draft printhead
        dotted = dot_matrix(gray, rng, pitch=2).astype(np.uint8)
        img = Image.fromarray(np.stack([dotted] * 3, axis=-1))

    q1 = Image.fromarray(render_qr(header_qr_payload(invoice_no, date_iso, amount),
                                   module_px=4)).convert("RGB")
    q2 = Image.fromarray(render_qr(items_qr_payload(items), module_px=4)).convert("RGB")
    img.paste(q1, (20, h - q1.size[1] - 20))
    img.paste(q2, (w - q2.size[0] - 20, h - q2.size[1] - 20))

    return img, boxes
