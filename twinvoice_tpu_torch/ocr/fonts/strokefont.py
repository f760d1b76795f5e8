"""The stroke font's glyph resolver: the port of the data half of
``twinvoice_tpu/ocr/fonts/strokefont.py`` (``glyph_strokes``, ``has_glyph``,
``coverage``), copied so that the port's CJK charset is the JAX package's.

Glyphs are stroke polylines in a 0–100 em square; complex characters are
composed from radical components placed into sub-boxes (``tw_glyphs``).
Stroke mini-language (coordinates 0–100, y down):
  ("h", x0, y, x1)          horizontal line
  ("v", x, y0, y1)          vertical line
  ("l", x0, y0, x1, y1)     straight line
  ("p", (x,y), (x,y), ...)  polyline

The drawing half (``draw_char``, ``draw_text``, ``render_char``,
``render_text``) is the JAX module's too. ``draw_char`` and ``draw_text``
draw with the caller's drawing object (``ops/host_pildraw.Draw`` in the
port, Pillow's ``ImageDraw`` where the JAX package draws) and import
nothing; ``render_char`` and ``render_text`` draw on ``host_pildraw``, with
Pillow's pixels and without Pillow.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np

from twinvoice_tpu_torch.ocr.fonts.tw_glyphs import COMPONENTS, COMPOSE

Stroke = Tuple
Glyph = List[Stroke]


def _scale_strokes(strokes: Glyph, box: Tuple[float, float, float, float]) -> Glyph:
    x0, y0, x1, y1 = box
    sx, sy = (x1 - x0) / 100.0, (y1 - y0) / 100.0

    def m(x, y):
        return (x0 + x * sx, y0 + y * sy)

    out: Glyph = []
    for s in strokes:
        if s[0] == "h":
            _, a, y, b = s
            out.append(("p",) + (m(a, y), m(b, y)))
        elif s[0] == "v":
            _, x, a, b = s
            out.append(("p",) + (m(x, a), m(x, b)))
        elif s[0] == "l":
            _, a, b, c, d = s
            out.append(("p",) + (m(a, b), m(c, d)))
        else:  # "p"
            out.append(("p",) + tuple(m(x, y) for x, y in s[1:]))
    return out


def _is_raw_stroke(e) -> bool:
    """COMPOSE entries may mix (component, box) placements with raw strokes."""
    if e[0] in ("h", "v", "l") and not isinstance(e[1], tuple):
        return True
    return e[0] == "p" and isinstance(e[1], tuple) and len(e[1]) == 2


@lru_cache(maxsize=None)
def glyph_strokes(ch: str) -> Tuple[Stroke, ...]:
    """Resolve a character to absolute strokes in the 0-100 em square."""
    if ch in COMPONENTS:
        return tuple(_scale_strokes(COMPONENTS[ch], (0, 0, 100, 100)))
    if ch in COMPOSE:
        out: Glyph = []
        for e in COMPOSE[ch]:
            if _is_raw_stroke(e):
                out.extend(_scale_strokes([e], (0, 0, 100, 100)))
            else:
                part, box = e
                out.extend(_scale_strokes(list(glyph_strokes(part)), box))
        return tuple(out)
    raise KeyError(ch)


def has_glyph(ch: str) -> bool:
    try:
        glyph_strokes(ch)
        return True
    except KeyError:
        return False


@lru_cache(maxsize=1)
def coverage() -> frozenset:
    """All single characters this font can draw."""
    out = set()
    for k in list(COMPONENTS) + list(COMPOSE):
        if len(k) == 1 and has_glyph(k):
            out.add(k)
    return frozenset(out)


def draw_char(draw, xy, ch: str, size: int, fill=0, weight: float = 6.5,
              style_rng=None, jitter: float = 0.03):
    """Draw one glyph with Pillow's ``ImageDraw`` ``draw`` at pixel
    position ``xy`` (top-left).

    ``style_rng``/``jitter``: style randomization. Given a numpy Generator,
    each stroke gets a correlated offset (whole-stroke translation, as a
    component's placement varies), each point a smaller independent wobble,
    and each stroke its own width multiplier, so the recognizer sees CJK
    shape classes rather than one font's exact rendering. ``jitter`` is in
    em fractions (0.03 ≈ 3% of the em square).
    """
    x0, y0 = xy
    s = size / 100.0
    w = max(1, int(round(size * weight / 100.0)))
    for st in glyph_strokes(ch):
        if style_rng is not None:
            j = jitter * size
            dx, dy = style_rng.normal(0.0, j, 2)          # stroke offset
            wobble = style_rng.normal(0.0, 0.4 * j, (len(st) - 1, 2))
            pts = [
                (x0 + px * s + dx + wx, y0 + py * s + dy + wy)
                for (px, py), (wx, wy) in zip(st[1:], wobble)
            ]
            wi = max(1, int(round(w * float(style_rng.uniform(0.7, 1.35)))))
        else:
            pts = [(x0 + px * s, y0 + py * s) for px, py in st[1:]]
            wi = w
        if len(pts) == 1:
            pts = pts * 2
        draw.line(pts, fill=fill, width=wi, joint="curve")


def draw_text(draw, xy, text: str, size: int, fill=0, ascii_font=None,
              spacing: float = 0.08, weight: float = 6.5,
              style_rng=None, jitter: float = 0.03):
    """Draw mixed ASCII/CJK text: CJK via this stroke font, everything else
    via the given PIL font (or PIL default). Returns total advance width.
    ``style_rng``/``jitter``: see :func:`draw_char`."""
    x, y = xy
    for ch in text:
        if has_glyph(ch):
            draw_char(draw, (x, y), ch, size, fill=fill, weight=weight,
                      style_rng=style_rng, jitter=jitter)
            x += size * (1.0 + spacing)
        else:
            if ascii_font is not None:
                draw.text((x, y), ch, fill=fill, font=ascii_font)
                adv = draw.textlength(ch, font=ascii_font)
            else:
                draw.text((x, y), ch, fill=fill)
                adv = draw.textlength(ch)
            x += adv
    return x - xy[0]


def render_char(ch: str, size: int = 64, pad: int = 4) -> np.ndarray:
    """One glyph → uint8 grayscale (size+2pad)² image, dark on light."""
    from twinvoice_tpu_torch.ops.host_pildraw import Draw, Image

    img = Image.new("L", (size + 2 * pad, size + 2 * pad), 255)
    draw_char(Draw(img), (pad, pad), ch, size)
    return img.array


def render_text(text: str, size: int = 48, pad: int = 6,
                ascii_font=None, weight: float = 6.5) -> np.ndarray:
    """Text line → uint8 grayscale image sized to content. ``ascii_font``:
    an ``ocr.fonts.truetype.FreeTypeFont`` for the characters the stroke
    font lacks."""
    from twinvoice_tpu_torch.ops.host_pildraw import Draw, Image

    w = int(size * 1.2 * (len(text) + 1)) + 2 * pad
    img = Image.new("L", (w, size + 2 * pad), 255)
    adv = draw_text(Draw(img), (pad, pad), text, size,
                    ascii_font=ascii_font, weight=weight)
    return img.array[:, : int(adv) + 2 * pad]
