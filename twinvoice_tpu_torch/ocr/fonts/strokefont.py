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
``render_text``) draws with Pillow, which the card's machine lacks; it stays
in the JAX package with the line renderers that call it, so training lines
are rendered there, on the host, into an npz.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

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
