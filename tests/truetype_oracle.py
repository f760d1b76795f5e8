"""FreeType and HarfBuzz as oracles for the port's TrueType engine.

Pillow's wheel carries the FreeType and HarfBuzz that its ``ImageFont``
renders with; this module loads both through ``ctypes`` (after importing
``PIL._imagingft``, which resolves them) so that tests can hold each stage of
``twinvoice_tpu_torch/csrc/host_truetype.cpp`` to the library: the hinted
outline in 26.6, the bitmap, the advances and the shaped glyph run. Only
tests import it.
"""

from __future__ import annotations

import ctypes
import glob
import os

import numpy as np

FT_LOAD_DEFAULT = 0
FT_LOAD_NO_HINTING = 1 << 1
FT_LOAD_RENDER = 1 << 2
FT_LOAD_NO_BITMAP = 1 << 3

_LIBS = {}


def _lib(stem: str) -> ctypes.CDLL:
    if stem not in _LIBS:
        import PIL
        import PIL._imagingft  # noqa: F401  (resolves the bundled libraries)

        root = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        path = sorted(glob.glob(os.path.join(root, f"lib{stem}-*.so*")))[0]
        _LIBS[stem] = ctypes.CDLL(path)
    return _LIBS[stem]


def freetype() -> ctypes.CDLL:
    return _lib("freetype")


def harfbuzz() -> ctypes.CDLL:
    return _lib("harfbuzz")


def freetype_version():
    ft = freetype()
    lib = ctypes.c_void_p()
    assert ft.FT_Init_FreeType(ctypes.byref(lib)) == 0
    a, b, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ft.FT_Library_Version(lib, ctypes.byref(a), ctypes.byref(b), ctypes.byref(c))
    ft.FT_Done_FreeType(lib)
    return a.value, b.value, c.value


class _Vec(ctypes.Structure):
    _fields_ = [("x", ctypes.c_long), ("y", ctypes.c_long)]


class _Outline(ctypes.Structure):
    _fields_ = [("n_contours", ctypes.c_ushort), ("n_points", ctypes.c_ushort),
                ("points", ctypes.POINTER(_Vec)), ("tags", ctypes.POINTER(ctypes.c_ubyte)),
                ("contours", ctypes.POINTER(ctypes.c_ushort)), ("flags", ctypes.c_int)]


class _Bitmap(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_uint), ("width", ctypes.c_uint), ("pitch", ctypes.c_int),
                ("buffer", ctypes.POINTER(ctypes.c_ubyte)), ("num_grays", ctypes.c_ushort),
                ("pixel_mode", ctypes.c_ubyte), ("palette_mode", ctypes.c_ubyte),
                ("palette", ctypes.c_void_p)]


class _Metrics(ctypes.Structure):
    _fields_ = [(n, ctypes.c_long) for n in ("width", "height", "horiBearingX", "horiBearingY",
                                             "horiAdvance", "vertBearingX", "vertBearingY",
                                             "vertAdvance")]


class _Generic(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("finalizer", ctypes.c_void_p)]


class _Slot(ctypes.Structure):
    _fields_ = [("library", ctypes.c_void_p), ("face", ctypes.c_void_p), ("next", ctypes.c_void_p),
                ("glyph_index", ctypes.c_uint), ("generic", _Generic), ("metrics", _Metrics),
                ("linearHoriAdvance", ctypes.c_long), ("linearVertAdvance", ctypes.c_long),
                ("advance", _Vec), ("format", ctypes.c_uint), ("bitmap", _Bitmap),
                ("bitmap_left", ctypes.c_int), ("bitmap_top", ctypes.c_int), ("outline", _Outline)]


class _BBox(ctypes.Structure):
    _fields_ = [("xMin", ctypes.c_long), ("yMin", ctypes.c_long), ("xMax", ctypes.c_long),
                ("yMax", ctypes.c_long)]


class _Face(ctypes.Structure):
    _fields_ = [("num_faces", ctypes.c_long), ("face_index", ctypes.c_long),
                ("face_flags", ctypes.c_long), ("style_flags", ctypes.c_long),
                ("num_glyphs", ctypes.c_long), ("family_name", ctypes.c_char_p),
                ("style_name", ctypes.c_char_p), ("num_fixed_sizes", ctypes.c_int),
                ("available_sizes", ctypes.c_void_p), ("num_charmaps", ctypes.c_int),
                ("charmaps", ctypes.c_void_p), ("generic", _Generic), ("bbox", _BBox),
                ("units_per_EM", ctypes.c_ushort), ("ascender", ctypes.c_short),
                ("descender", ctypes.c_short), ("height", ctypes.c_short),
                ("max_advance_width", ctypes.c_short), ("max_advance_height", ctypes.c_short),
                ("underline_position", ctypes.c_short), ("underline_thickness", ctypes.c_short),
                ("glyph", ctypes.POINTER(_Slot)), ("size", ctypes.c_void_p)]


class FtFace:
    """One FreeType face at a nominal pixel size, requested as Pillow does."""

    def __init__(self, path: str, size: int):
        ft = self.ft = freetype()
        self.lib = ctypes.c_void_p()
        assert ft.FT_Init_FreeType(ctypes.byref(self.lib)) == 0
        self.face = ctypes.POINTER(_Face)()
        ft.FT_New_Face.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
                                   ctypes.POINTER(ctypes.POINTER(_Face))]
        assert ft.FT_New_Face(self.lib, path.encode(), 0, ctypes.byref(self.face)) == 0
        req = (ctypes.c_long * 5)(0, 0, size * 64, 0, 0)  # NOMINAL, width 0, height
        assert ft.FT_Request_Size(self.face, req) == 0

    def close(self):
        self.ft.FT_Done_Face(self.face)
        self.ft.FT_Done_FreeType(self.lib)

    def glyph_index(self, ch: str) -> int:
        return self.ft.FT_Get_Char_Index(self.face, ctypes.c_ulong(ord(ch)))

    def load(self, gid: int, flags: int = FT_LOAD_DEFAULT):
        assert self.ft.FT_Load_Glyph(self.face, gid, flags) == 0
        return self.face.contents.glyph.contents

    def outline(self, gid: int, flags: int = FT_LOAD_DEFAULT):
        """→ (points (n, 2) int64 in 26.6, tags (n,) uint8, contour ends, flags)."""
        o = self.load(gid, flags).outline
        n = o.n_points
        pts = np.array([(o.points[i].x, o.points[i].y) for i in range(n)], np.int64).reshape(n, 2)
        tags = np.array([o.tags[i] for i in range(n)], np.uint8)
        ends = [o.contours[i] for i in range(o.n_contours)]
        return pts, tags, ends, o.flags

    def metrics(self, gid: int, flags: int = FT_LOAD_DEFAULT):
        s = self.load(gid, flags)
        m = s.metrics
        return dict(width=m.width, height=m.height, bx=m.horiBearingX, by=m.horiBearingY,
                    adv=m.horiAdvance, advance_x=s.advance.x, linear=s.linearHoriAdvance)

    def bitmap(self, gid: int, flags: int = FT_LOAD_DEFAULT):
        """→ (uint8 (rows, width) coverage, left, top) from FT_LOAD_RENDER."""
        s = self.load(gid, flags | FT_LOAD_RENDER)
        b = s.bitmap
        out = np.zeros((b.rows, b.width), np.uint8)
        for r in range(b.rows):
            row = ctypes.string_at(ctypes.addressof(b.buffer.contents) + r * b.pitch, b.width) \
                if b.width else b""
            out[r] = np.frombuffer(row, np.uint8)
        return out, s.bitmap_left, s.bitmap_top

    def get_advance(self, gid: int, flags: int = FT_LOAD_DEFAULT) -> int:
        v = ctypes.c_long()
        assert self.ft.FT_Get_Advance(self.face, gid, flags, ctypes.byref(v)) == 0
        return v.value
