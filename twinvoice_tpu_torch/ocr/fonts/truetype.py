"""TrueType text without Pillow or FreeType: Pillow 12.1's ``FreeTypeFont``
as the training renderers use it.

``csrc/host_truetype.cpp`` (built at first use by ``_build.build_host``)
rebuilds what Pillow 12.1.0 does through FreeType 2.14.1 and raqm 0.10.3
with HarfBuzz 12.3.0:

- the sfnt tables (``cmap`` formats 4 and 12, ``head``, ``hhea``, ``hmtx``,
  ``maxp``, ``loca``, ``glyf`` with composites, ``cvt``, ``fpgm``, ``prep``)
  and the nominal size request Pillow makes (``FT_Request_Size``);
- the TrueType bytecode interpreter as FreeType runs it by default:
  version 40 in its backward-compatibility mode, where moves along x are
  ignored and the phantom points keep the linear advance;
- FreeType's auto-hinter (``autofit``), which FreeType runs instead on a
  face with no font program (``fpgm``): of the training fonts Atkinson
  Hyperlegible Next and gymnasium's Minecraft, and Pillow's default font.
  Its Latin writing system in the normal mode: the style metrics (standard
  widths from "o", blue zones from the Latin blue strings, the x-height
  scale), segments, edges, stem fitting, the serif and interpolated edges,
  the strong and weak point alignment, the hinted advance, the non-base
  characters, the dot separation of FreeType 2.14's adjustment database
  for "i" and "j", and a serif near a base that is not its neighbour left
  unhinted, as the library leaves it. Glyphs that no script covers (the
  default font's ``.notdef``, which the invoice's CJK labels draw) take
  FreeType's fallback style, its CJK writing system (stems widened to at
  least 54/64 px and fitted, the remaining edges interpolated), here with
  no blue zones;
- FreeType's smooth rasteriser (24.8 cells, the conic DDA, the non-zero
  fill rule); a glyph flagged ``OVERLAP_SIMPLE`` or ``OVERLAP_COMPOUND``
  (Playfair Display) is rendered 4× oversampled and averaged, as
  ``ft_smooth_raster_overlap`` does;
- layout as raqm and HarfBuzz do it for single-script runs: FreeType's
  unhinted advances (``hb-ft``'s default load flags) and the GPOS pair
  kerning of the default features, the only lookups that fire on these
  renderers' strings (``tests/test_torch_truetype.py`` probes it), or,
  where GPOS has no ``kern`` feature, the legacy ``kern`` table (FreeSans
  Bold), each pair's value split between the two glyphs; or, for
  ``layout_engine="basic"`` (Pillow's ``Layout.BASIC``, which its default
  font uses), the hinted advances of ``FT_Load_Glyph``;
- Pillow's ``font_render``: the text box from the hinted glyphs' pixel
  boxes, anchor ``"la"``, a ``start`` rounded to 26.6 and each glyph drawn
  at its pen position's nearest pixel, overlapping coverage merged as alpha
  over (``t + s - t·s/255`` with Pillow's rounded division).

:func:`load_default` is Pillow's ``ImageFont.load_default()``: the Aileron
subset Pillow embeds, bundled as ``ttf/Aileron-Regular.ttf``.

A missing font file raises ``FileNotFoundError`` with its path.
"""

from __future__ import annotations

import ctypes
import os
import threading
from functools import lru_cache
from pathlib import Path
from typing import Tuple

import numpy as np

from twinvoice_tpu_torch import _build

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "host_truetype.cpp"

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile the TrueType library unless it is built already. → its path."""
    return _build.build_host(SOURCE, "hosttruetype", "TrueType engine")


def library() -> ctypes.CDLL:
    """The loaded TrueType library, built first if need be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.tt_open.argtypes = [ctypes.c_char_p, i64]
            lib.tt_open.restype = p
            lib.tt_close.argtypes = [p]
            lib.tt_close.restype = None
            lib.tt_set_size.argtypes = [p, i32]
            lib.tt_char_index.argtypes = [p, ctypes.c_uint32]
            lib.tt_autohinted.argtypes = [p]
            lib.tt_set_layout.argtypes = [p, i32]
            lib.tt_glyph_outline.argtypes = [p, i32, i32, p, p, i32, p, i32, p, p]
            lib.tt_glyph_bitmap.argtypes = [p, i32, i64, i64, p, i64, p]
            lib.tt_shape.argtypes = [p, p, i32, p, p, p]
            lib.tt_text_length.argtypes = [p, p, i32]
            lib.tt_text_length.restype = i64
            lib.tt_render_text.argtypes = [p, p, i32, ctypes.c_double, ctypes.c_double, p]
            lib.tt_take_mask.argtypes = [p, p, i64]
            _lib = lib
        return _lib


@lru_cache(maxsize=32)
def _font_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _codepoints(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-32-le"), np.uint32).copy()


class FreeTypeFont:
    """One face at one nominal pixel size, as ``ImageFont.truetype(path,
    size)`` makes it. Like Pillow's, each object holds its own hinting state
    (the font program runs once, the control value program at the size)."""

    def __init__(self, path, size: int, layout_engine: str = "raqm"):
        if layout_engine not in ("raqm", "basic"):
            raise ValueError(f"layout_engine must be 'raqm' or 'basic', not {layout_engine!r}")
        path = os.fspath(path)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"font file not found: {path}")
        self.path = path
        self.size = int(size)
        lib = library()
        data = _font_bytes(path)
        handle = lib.tt_open(data, len(data))
        if not handle:
            raise OSError(f"not a TrueType font: {path}")
        self._handle = ctypes.c_void_p(handle)
        self._lock = threading.Lock()
        lib.tt_set_size(self._handle, self.size)
        self.layout_engine = layout_engine
        if lib.tt_set_layout(self._handle, int(layout_engine == "basic")):
            raise NotImplementedError(f"the basic layout's 'kern' table is not ported: {path}")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None and _lib is not None:
            _lib.tt_close(handle)
            self._handle = None

    @property
    def autohinted(self) -> bool:
        """True where FreeType would auto-hint this face (no ``fpgm``)."""
        return bool(library().tt_autohinted(self._handle))

    def getlength(self, text: str) -> float:
        """The advance of ``text`` in pixels (1/64 precision), as Pillow's
        ``FreeTypeFont.getlength``."""
        cps = _codepoints(text)
        with self._lock:
            n = library().tt_text_length(self._handle, cps.ctypes.data, len(cps))
        return n / 64

    def getmask2(self, text: str, start: Tuple[float, float] = (0.0, 0.0)):
        """→ (uint8 (h, w) coverage mask, (x_offset, y_offset)), as Pillow's
        ``getmask2(text, "L", anchor="la", start=start)``."""
        cps = _codepoints(text)
        box = (ctypes.c_int * 4)()
        lib = library()
        with self._lock:
            if lib.tt_render_text(self._handle, cps.ctypes.data, len(cps), float(start[0]),
                                  float(start[1]), box):
                raise OSError(f"cannot render {text!r} with {self.path}")
            mask = np.zeros((max(box[1], 0), max(box[0], 0)), np.uint8)
            lib.tt_take_mask(self._handle, mask.ctypes.data, mask.size)
        return mask, (box[2], box[3])


DEFAULT_FONT = Path(__file__).resolve().parent / "ttf" / "Aileron-Regular.ttf"


@lru_cache(maxsize=8)
def load_default(size: int = None) -> FreeTypeFont:
    """Pillow's ``ImageFont.load_default(size)``: its Aileron Regular subset
    at ``size`` (10 when None) with the BASIC layout (hinted advances)."""
    return FreeTypeFont(DEFAULT_FONT, 10 if size is None else size, layout_engine="basic")
