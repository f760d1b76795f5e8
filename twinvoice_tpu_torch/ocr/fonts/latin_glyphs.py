"""A parametric Latin and digit stroke typeface: the port's copy of
``twinvoice_tpu/ocr/fonts/latin_glyphs.py``.

Glyphs are stroke polylines in a 0–100 em square (the CJK stroke font's
mini-language, ``strokefont``), and a :class:`LatinStyle` bundle of
typeface-level parameters (weight, width, slant, stroke contrast, serifs,
tracking) is sampled once a line by :func:`sample_style`, so each training
line is set in one coherent synthetic typeface. :func:`draw_char` and
:func:`draw_text` draw with the caller's drawing object (Pillow's
``ImageDraw``) and import nothing; their output is the JAX package's byte
for byte.

Coordinates: x 0–100 (an advance of ~100 before the style's x-scale), y 0
at the top to 100 on the baseline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

Stroke = Tuple
Glyph = List[Stroke]

# ------------------------------------------------------------------ glyphs
# ("h", x0, y, x1) horizontal · ("v", x, y0, y1) vertical ·
# ("l", x0, y0, x1, y1) line · ("p", (x,y), ...) polyline

GLYPHS: Dict[str, Glyph] = {
    "A": [("p", (10, 100), (50, 0), (90, 100)), ("h", 27, 68, 73)],
    "B": [("v", 15, 0, 100),
          ("p", (15, 0), (68, 0), (84, 12), (84, 38), (68, 50), (15, 50)),
          ("p", (15, 50), (72, 50), (89, 62), (89, 88), (72, 100), (15, 100))],
    "C": [("p", (87, 18), (74, 5), (46, 0), (21, 10), (11, 35), (11, 65),
           (21, 90), (46, 100), (74, 95), (87, 82))],
    "D": [("v", 15, 0, 100),
          ("p", (15, 0), (58, 0), (84, 14), (90, 50), (84, 86), (58, 100),
           (15, 100))],
    "E": [("v", 15, 0, 100), ("h", 15, 0, 85), ("h", 15, 50, 75),
          ("h", 15, 100, 85)],
    "F": [("v", 15, 0, 100), ("h", 15, 0, 85), ("h", 15, 50, 73)],
    "G": [("p", (87, 18), (74, 5), (46, 0), (21, 10), (11, 35), (11, 65),
           (21, 90), (46, 100), (74, 96), (87, 80), (87, 56), (60, 56))],
    "H": [("v", 15, 0, 100), ("v", 85, 0, 100), ("h", 15, 50, 85)],
    "I": [("v", 50, 0, 100), ("h", 30, 0, 70), ("h", 30, 100, 70)],
    "J": [("p", (78, 0), (78, 78), (68, 96), (46, 100), (26, 94), (16, 78))],
    "K": [("v", 15, 0, 100), ("p", (85, 0), (15, 56)),
          ("p", (38, 44), (86, 100))],
    "L": [("v", 15, 0, 100), ("h", 15, 100, 85)],
    "M": [("p", (10, 100), (10, 0), (50, 62), (90, 0), (90, 100))],
    "N": [("p", (15, 100), (15, 0), (85, 100), (85, 0))],
    "O": [("p", (50, 0), (24, 8), (11, 35), (11, 65), (24, 92), (50, 100),
           (76, 92), (89, 65), (89, 35), (76, 8), (50, 0))],
    "P": [("v", 15, 0, 100),
          ("p", (15, 0), (68, 0), (87, 14), (87, 41), (68, 55), (15, 55))],
    "Q": [("p", (50, 0), (24, 8), (11, 35), (11, 65), (24, 92), (50, 100),
           (76, 92), (89, 65), (89, 35), (76, 8), (50, 0)),
          ("l", 62, 72, 93, 103)],
    "R": [("v", 15, 0, 100),
          ("p", (15, 0), (68, 0), (87, 14), (87, 41), (68, 55), (15, 55)),
          ("p", (48, 55), (88, 100))],
    "S": [("p", (84, 14), (68, 3), (42, 0), (20, 10), (15, 28), (26, 42),
           (60, 52), (79, 62), (85, 78), (75, 94), (48, 100), (22, 96),
           (11, 82))],
    "T": [("h", 10, 0, 90), ("v", 50, 0, 100)],
    "U": [("p", (15, 0), (15, 74), (25, 94), (50, 100), (75, 94), (85, 74),
           (85, 0))],
    "V": [("p", (10, 0), (50, 100), (90, 0))],
    "W": [("p", (8, 0), (28, 100), (50, 32), (72, 100), (92, 0))],
    "X": [("l", 13, 0, 87, 100), ("l", 87, 0, 13, 100)],
    "Y": [("p", (10, 0), (50, 48), (90, 0)), ("v", 50, 48, 100)],
    "Z": [("p", (13, 0), (87, 0), (13, 100), (87, 100))],
    "0": [("p", (50, 0), (27, 8), (16, 35), (16, 65), (27, 92), (50, 100),
           (73, 92), (84, 65), (84, 35), (73, 8), (50, 0))],
    "1": [("p", (30, 18), (52, 0), (52, 100))],
    "2": [("p", (16, 22), (26, 6), (50, 0), (74, 6), (83, 24), (77, 44),
           (16, 100), (87, 100))],
    "3": [("p", (16, 12), (36, 0), (64, 0), (81, 12), (81, 34), (64, 47),
           (42, 47)),
          ("p", (42, 47), (68, 47), (86, 61), (86, 86), (67, 100), (36, 100),
           (15, 88))],
    "4": [("p", (62, 100), (62, 0), (11, 72), (90, 72))],
    "5": [("p", (81, 0), (23, 0), (17, 46), (46, 38), (69, 42), (84, 59),
           (84, 80), (69, 97), (41, 100), (17, 88))],
    "6": [("p", (77, 6), (55, 0), (31, 10), (17, 38), (15, 68), (26, 94),
           (52, 100), (74, 92), (83, 72), (76, 53), (52, 45), (29, 53),
           (17, 68))],
    "7": [("p", (13, 0), (87, 0), (40, 100))],
    "8": [("p", (50, 0), (29, 6), (21, 22), (29, 39), (50, 45), (71, 39),
           (79, 22), (71, 6), (50, 0)),
          ("p", (50, 45), (26, 53), (16, 72), (26, 92), (50, 100), (74, 92),
           (84, 72), (74, 53), (50, 45))],
    "9": [("p", (23, 94), (45, 100), (69, 90), (83, 62), (85, 32), (74, 6),
           (48, 0), (26, 8), (17, 28), (24, 47), (48, 55), (71, 47),
           (83, 32))],
    "-": [("h", 25, 52, 75)],
    ".": [("p", (46, 92), (54, 92), (54, 100), (46, 100), (46, 92))],
    "/": [("l", 72, 0, 28, 100)],
    ":": [("p", (46, 30), (54, 30), (54, 38), (46, 38), (46, 30)),
          ("p", (46, 78), (54, 78), (54, 86), (46, 86), (46, 78))],
    ",": [("p", (54, 90), (52, 100), (44, 108))],
    "$": [("p", (82, 20), (66, 9), (42, 6), (22, 15), (17, 31), (28, 44),
           (60, 53), (78, 62), (83, 77), (74, 91), (48, 95), (24, 91),
           (13, 79)),
          ("v", 50, 0, 12), ("v", 50, 90, 102)],
    "#": [("l", 42, 6, 32, 95), ("l", 68, 6, 58, 95),
          ("h", 17, 35, 85), ("h", 13, 68, 81)],
    "*": [("v", 50, 22, 78), ("l", 27, 36, 73, 64), ("l", 73, 36, 27, 64)],
    "(": [("p", (68, -2), (48, 20), (41, 50), (48, 80), (68, 102))],
    ")": [("p", (32, -2), (52, 20), (59, 50), (52, 80), (32, 102))],
}

# advance width (em units, before style x-scale) for narrow glyphs
ADVANCE: Dict[str, float] = {
    "I": 66, "J": 82, "1": 72, ".": 45, ",": 45, ":": 45, "-": 72,
    "(": 58, ")": 58, "/": 70, " ": 55,
}


@dataclass
class LatinStyle:
    """One coherent synthetic typeface, sampled per line."""

    weight: float = 6.0       # stroke width, % of em
    width: float = 1.0        # horizontal scale (condensed … expanded)
    slant: float = 0.0        # x += slant · (100 − y)/100 · em  (italic)
    contrast: float = 1.0     # horizontal-stroke weight ÷ vertical weight
    serif: float = 0.0        # serif length, % of em (0 = sans)
    tracking: float = 0.10    # inter-glyph gap as a fraction of advance
    digit_width: float = 1.0  # extra x-scale for digits (tabular vs narrow)


def sample_style(rng) -> LatinStyle:
    """Draw a random typeface from the style continuum.

    Two coherent families rather than independent knobs: a 40% "serif
    book face" mode couples thin strokes + high stroke contrast + serifs
    (the STIX/Computer-Modern shape class the held-out tier measures),
    and the rest is the grotesque/sans continuum."""
    if rng.random() < 0.4:  # serif book face
        return LatinStyle(
            weight=float(rng.uniform(3.0, 6.0)),
            width=float(rng.uniform(0.82, 1.12)),
            slant=float(rng.uniform(0.0, 0.2)) if rng.random() < 0.3 else 0.0,
            contrast=float(rng.uniform(0.35, 0.65)),
            serif=float(rng.uniform(4.0, 9.0)),
            tracking=float(rng.uniform(0.04, 0.18)),
            digit_width=float(rng.uniform(0.85, 1.05)),
        )
    return LatinStyle(
        weight=float(rng.uniform(3.2, 10.5)),
        width=float(rng.uniform(0.72, 1.18)),
        slant=float(rng.uniform(-0.06, 0.22)) if rng.random() < 0.35 else 0.0,
        contrast=float(rng.uniform(0.45, 1.0)) if rng.random() < 0.4 else 1.0,
        serif=float(rng.uniform(4.0, 9.0)) if rng.random() < 0.2 else 0.0,
        tracking=float(rng.uniform(0.04, 0.22)),
        digit_width=float(rng.uniform(0.85, 1.1)),
    )


def _stroke_direction(pts) -> str:
    dx = abs(pts[-1][0] - pts[0][0])
    dy = abs(pts[-1][1] - pts[0][1])
    return "h" if dx > 1.6 * dy else ("v" if dy > 1.6 * dx else "d")


def _as_points(st: Stroke):
    if st[0] == "h":
        _, a, y, b = st
        return [(a, y), (b, y)]
    if st[0] == "v":
        _, x, a, b = st
        return [(x, a), (x, b)]
    if st[0] == "l":
        _, a, b, c, d = st
        return [(a, b), (c, d)]
    return list(st[1:])


def draw_char(draw, xy, ch: str, size: int, fill=0,
              style: LatinStyle = LatinStyle()) -> float:
    """Draw one glyph at pixel pos ``xy`` (top-left of the em box).
    Returns the advance in pixels."""
    adv = ADVANCE.get(ch, 100.0)
    if ch not in GLYPHS:   # space & anything unknown: advance only
        return size * (adv / 100.0) * style.width * (1 + style.tracking)
    x0, y0 = xy
    s = size / 100.0
    xs = style.width * (style.digit_width if ch.isdigit() else 1.0)
    w_v = max(1, int(round(size * style.weight / 100.0)))
    w_h = max(1, int(round(w_v * style.contrast)))
    for st in GLYPHS[ch]:
        pts100 = _as_points(st)
        wd = w_h if _stroke_direction(pts100) == "h" else w_v
        pts = [
            (x0 + (px * xs + style.slant * (100.0 - py)) * s, y0 + py * s)
            for px, py in pts100
        ]
        if len(pts) == 1:
            pts = pts * 2
        draw.line(pts, fill=fill, width=wd, joint="curve")
        if style.serif > 0 and st[0] == "v":
            ser = style.serif * s * 10.0 / 10.0  # px
            for px, py in (pts[0], pts[-1]):
                draw.line([(px - ser, py), (px + ser, py)], fill=fill,
                          width=w_h)
    return size * (adv / 100.0) * xs * (1 + style.tracking)


def draw_text(draw, xy, text: str, size: int, fill=0,
              style: LatinStyle = LatinStyle()) -> float:
    """Draw a line in one synthetic typeface. Returns total advance (px)."""
    x, y = xy
    for ch in text:
        x += draw_char(draw, (x, y), ch, size, fill=fill, style=style)
    return x - xy[0]


def coverage() -> frozenset:
    return frozenset(GLYPHS) | {" "}
