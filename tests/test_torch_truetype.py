"""PyTorch port: the TrueType engine (``ocr/fonts/truetype.py`` on
``csrc/host_truetype.cpp``) against Pillow 12.1 and the FreeType and
HarfBuzz it renders with (``tests/truetype_oracle.py``).

What is held, byte for byte:

- every charset glyph of every training font at every size 10–29:
  ``getmask2``'s mask and offset and ``getlength`` against Pillow's, and a
  seeded sample's hinted outline in 26.6 and advance against
  ``FT_Load_Glyph``, its bitmap against ``FT_LOAD_RENDER``: the twelve
  DejaVu faces through the bytecode interpreter, Atkinson Hyperlegible
  Next and Minecraft (no ``fpgm``) through the auto-hinter;
- Pillow's default font (``load_default``: its Aileron subset, auto-hinted,
  with the BASIC layout's hinted advances): every printable ASCII
  character, and strings;
- seeded strings from ``make_batch``'s samplers, whole, at seeded
  fractional starts;
- the glyph run against HarfBuzz's ``hb_shape`` on FreeType's face (glyph
  ids, advances, offsets), and the probe of which GSUB and GPOS lookups of
  the default features can fire on the charset: the pair kerning only;
- which faces FreeType auto-hints (no ``fpgm``: Atkinson Hyperlegible Next,
  Minecraft and the default font), and the auto-hinted outline and advance
  of every printable ASCII character of those at every size 10–29.
"""

import ctypes
import os

import numpy as np
import pytest
from PIL import ImageFont

from tests import truetype_oracle as oracle
from twinvoice_tpu.data.synthetic import train_fonts as jax_train_fonts
from twinvoice_tpu_torch.data.synthetic import train_fonts
from twinvoice_tpu_torch.ocr.fonts import truetype
from twinvoice_tpu_torch.ocr.torchocr import data as D
from twinvoice_tpu_torch.ocr.torchocr.charset import CHARSET

FONTS = jax_train_fonts()
AUTOHINTED = [f for f in FONTS if "DejaVu" not in os.path.basename(f)] + [str(truetype.DEFAULT_FONT)]
SIZES = range(10, 30)
ASCII = "".join(chr(c) for c in range(0x20, 0x7F))


def _name(path):
    return os.path.basename(path)


def test_versions_and_registry():
    assert oracle.freetype_version() == (2, 14, 1)
    from PIL import features

    assert features.version("raqm") == "0.10.3" and features.version("harfbuzz") == "12.3.0"
    assert ImageFont.truetype(FONTS[0], 12).layout_engine == ImageFont.Layout.RAQM
    port = train_fonts()
    assert [_name(p) for p in port] == [_name(p) for p in FONTS]
    assert len(FONTS) == 14 and len(AUTOHINTED) == 3
    for mine, theirs in zip(port, FONTS):
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), mine


def test_missing_font_raises_with_its_path(tmp_path):
    path = str(tmp_path / "nowhere.ttf")
    with pytest.raises(FileNotFoundError, match="nowhere.ttf"):
        truetype.FreeTypeFont(path, 12)


def _pil_mask(font, text, start=(0.0, 0.0)):
    m, off = font.getmask2(text, "L", anchor="la", start=start)
    return np.array(m, np.uint8).reshape(m.size[1], m.size[0]), off


@pytest.mark.parametrize("path", FONTS, ids=_name)
def test_charset_glyphs_equal_pillow(path):
    """Each charset character alone at sizes 10–29: mask, offset, length."""
    for size in SIZES:
        pil, port = ImageFont.truetype(path, size), truetype.FreeTypeFont(path, size)
        for ch in CHARSET:
            want, woff = _pil_mask(pil, ch)
            got, goff = port.getmask2(ch)
            assert goff == woff and np.array_equal(got, want), (size, ch)
            assert port.getlength(ch) == pil.getlength(ch), (size, ch)


@pytest.mark.parametrize("path", FONTS, ids=_name)
def test_sampled_strings_equal_pillow(path):
    """20 strings from the line samplers, whole, each at three starts (0,
    a seeded fraction on x, a seeded fraction on both axes)."""
    rng = np.random.default_rng(abs(hash(_name(path))) % 2 ** 32)
    samplers = (D.random_field_text, D.random_hard_text)
    for i in range(20):
        text = samplers[i % 2](rng).upper()
        size = int(rng.integers(10, 30))
        pil, port = ImageFont.truetype(path, size), truetype.FreeTypeFont(path, size)
        for start in ((0.0, 0.0), (float(rng.random()), 0.0),
                      (float(rng.random()), float(rng.random()))):
            want, woff = _pil_mask(pil, text, start)
            got, goff = port.getmask2(text, start)
            assert goff == woff and np.array_equal(got, want), (text, size, start)
        assert port.getlength(text) == pil.getlength(text), text


def _outline(font, gid, hinted=True):
    lib = truetype.library()
    n_max = 512
    xy = np.zeros((n_max, 2), np.int64)
    tags = np.zeros(n_max, np.uint8)
    ends = np.zeros(64, np.int32)
    nc, adv = ctypes.c_int(), ctypes.c_int64()
    n = lib.tt_glyph_outline(font._handle, gid, int(hinted), xy.ctypes.data, tags.ctypes.data,
                             n_max, ends.ctypes.data, 64, ctypes.byref(nc), ctypes.byref(adv))
    assert 0 <= n <= n_max
    return xy[:n], tags[:n], list(ends[:nc.value]), adv.value


def _bitmap(font, gid):
    lib = truetype.library()
    box = (ctypes.c_int * 4)()
    buf = np.zeros(1 << 14, np.uint8)
    assert lib.tt_glyph_bitmap(font._handle, gid, 0, 0, buf.ctypes.data, buf.size, box) == 0
    return buf[:box[0] * box[1]].reshape(box[1], box[0]), box[2], box[3]


@pytest.mark.parametrize("path", FONTS, ids=_name)
def test_hinted_outlines_and_bitmaps_equal_freetype(path):
    """A seeded sample of (size, glyph): the interpreter's outline and
    advance, then the rasteriser's bitmap, against FreeType's."""
    rng = np.random.default_rng(7)
    for size in rng.choice(list(SIZES), 6, replace=False):
        ft, port = oracle.FtFace(path, int(size)), truetype.FreeTypeFont(path, int(size))
        try:
            for ch in rng.choice(list(CHARSET.strip()), 12, replace=False):
                gid = ft.glyph_index(ch)
                pts, tags, ends, _ = ft.outline(gid)
                xy, mtags, mends, adv = _outline(port, gid)
                assert np.array_equal(xy, pts) and np.array_equal(mtags, tags & 1), (size, ch)
                assert mends == ends and adv == ft.metrics(gid)["adv"], (size, ch)
                want, left, top = ft.bitmap(gid)
                got, gl, gt = _bitmap(port, gid)
                assert (gl, gt) == (left, top) and np.array_equal(got, want), (size, ch)
        finally:
            ft.close()


@pytest.mark.parametrize("path", FONTS + [str(truetype.DEFAULT_FONT)], ids=_name)
def test_autohinted_faces_are_freetypes(path):
    """FreeType auto-hints a face without a font program: the port flags
    exactly those (Atkinson, whose glyphs have no programs, Minecraft and
    Pillow's default font), whose hinted outlines move off the unhinted
    ones in x; for every face the port's hinted outline is FreeType's."""
    ft, port = oracle.FtFace(path, 17), truetype.FreeTypeFont(path, 17)
    try:
        assert port.autohinted == (path in AUTOHINTED)
        moved = False
        for ch in "0ABHMOSX":
            gid = ft.glyph_index(ch)
            hinted = ft.outline(gid)[0]
            plain = ft.outline(gid, oracle.FT_LOAD_NO_HINTING)[0]
            moved |= not np.array_equal(hinted[:, 0], plain[:, 0])
            assert np.array_equal(_outline(port, gid)[0], hinted), ch
        if port.autohinted:
            assert moved
    finally:
        ft.close()


def _ft_outline(ft, gid):
    """FreeType's hinted outline (26.6, (n, 2)) and advance, read in bulk."""
    s = ft.load(gid)
    o, n = s.outline, s.outline.n_points
    pts = ctypes.cast(o.points, ctypes.POINTER(ctypes.c_long * (2 * n))).contents if n else []
    return np.array(pts, np.int64).reshape(n, 2), s.metrics.horiAdvance


@pytest.mark.parametrize("path", AUTOHINTED, ids=_name)
def test_autohinted_outlines_equal_freetype(path):
    """The auto-hinter against FreeType's: every printable ASCII character
    at every size 10–29, the hinted outline in 26.6 and the advance."""
    for size in SIZES:
        ft, port = oracle.FtFace(path, size), truetype.FreeTypeFont(path, size)
        try:
            for ch in ASCII:
                gid = ft.glyph_index(ch)
                if not gid:
                    continue
                want, adv = _ft_outline(ft, gid)
                xy, _, _, got_adv = _outline(port, gid)
                assert np.array_equal(xy, want), (size, ch)
                assert got_adv == adv, (size, ch)
        finally:
            ft.close()


def test_default_font_equals_pillows():
    """Pillow's ``ImageFont.load_default()`` (size 10) and at other sizes:
    the BASIC layout's masks, offsets and lengths for every printable
    ASCII character and for strings, and ``ImageDraw``'s text with no font
    on "L" and "RGB"."""
    from PIL import Image, ImageDraw

    from twinvoice_tpu_torch.ops import host_pildraw

    import base64
    import inspect

    src = inspect.getsource(ImageFont.load_default)
    with open(truetype.DEFAULT_FONT, "rb") as f:
        assert f.read() == base64.b64decode(src.split('b"""')[1].split('"""')[0])
    rng = np.random.default_rng(23)
    for size in (None, 12, 17):
        pil = ImageFont.load_default(size)
        port = truetype.load_default(size)
        assert port.layout_engine == "basic" and pil.layout_engine == ImageFont.Layout.BASIC
        texts = list(ASCII) + ["".join(rng.choice(list(ASCII), int(rng.integers(2, 16))))
                               for _ in range(20)]
        for text in texts:
            want, woff = _pil_mask(pil, text)
            got, goff = port.getmask2(text)
            assert goff == woff and np.array_equal(got, want), (size, text)
            assert port.getlength(text) == pil.getlength(text), (size, text)
    for mode, fill in (("L", 40), ("RGB", (200, 30, 90))):
        im = Image.new(mode, (120, 24), 255 if mode == "L" else (255, 255, 255))
        ImageDraw.Draw(im).text((3.4, 5.7), "Total: NT$1,250", fill=fill)
        mine = host_pildraw.Image.new(mode, (120, 24), 255 if mode == "L" else (255, 255, 255))
        d = host_pildraw.Draw(mine)
        d.text((3.4, 5.7), "Total: NT$1,250", fill=fill)
        assert np.array_equal(mine.array, np.asarray(im))
        assert d.textlength("Total: NT$1,250") == ImageDraw.Draw(im).textlength("Total: NT$1,250")


class _Hb:
    """HarfBuzz's ``hb_shape`` on FreeType's face, as raqm calls it."""

    def __init__(self):
        hb = self.hb = oracle.harfbuzz()
        hb.hb_ft_font_create_referenced.restype = ctypes.c_void_p
        hb.hb_ft_font_create_referenced.argtypes = [ctypes.c_void_p]
        hb.hb_buffer_create.restype = ctypes.c_void_p
        for fn in ("hb_buffer_add_utf32", "hb_buffer_set_direction", "hb_buffer_set_script",
                   "hb_buffer_set_language", "hb_shape", "hb_buffer_get_length",
                   "hb_buffer_destroy", "hb_font_destroy"):
            getattr(hb, fn).argtypes = None
        hb.hb_buffer_get_glyph_infos.restype = ctypes.POINTER(ctypes.c_uint32 * 5)
        hb.hb_buffer_get_glyph_positions.restype = ctypes.POINTER(ctypes.c_int32 * 5)
        hb.hb_language_from_string.restype = ctypes.c_void_p
        hb.hb_buffer_get_glyph_infos.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        hb.hb_buffer_get_glyph_positions.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    def shape(self, ft_face, text):
        hb = self.hb
        font = hb.hb_ft_font_create_referenced(ft_face.face)
        buf = ctypes.c_void_p(hb.hb_buffer_create())
        cps = np.frombuffer(text.encode("utf-32-le"), np.uint32).copy()
        hb.hb_buffer_add_utf32(buf, cps.ctypes.data_as(ctypes.c_void_p), len(cps), 0, len(cps))
        hb.hb_buffer_set_direction(buf, 4)  # LTR
        latin = any(c.isalpha() for c in text)
        tag = b"Latn" if latin else b"Zyyy"
        hb.hb_buffer_set_script(buf, int.from_bytes(tag, "big"))
        hb.hb_buffer_set_language(buf, ctypes.c_void_p(hb.hb_language_from_string(b"c", -1)))
        hb.hb_shape(ctypes.c_void_p(font), buf, None, 0)
        n = hb.hb_buffer_get_length(buf)
        infos = hb.hb_buffer_get_glyph_infos(buf, None)
        poss = hb.hb_buffer_get_glyph_positions(buf, None)
        out = [(infos[i][0], poss[i][0], poss[i][2]) for i in range(n)]
        hb.hb_buffer_destroy(buf)
        hb.hb_font_destroy(ctypes.c_void_p(font))
        return out


def _port_shape(font, text):
    lib = truetype.library()
    cps = np.frombuffer(text.encode("utf-32-le"), np.uint32).copy()
    gids = np.zeros(len(cps), np.int32)
    adv = np.zeros(len(cps), np.int64)
    xoff = np.zeros(len(cps), np.int64)
    n = lib.tt_shape(font._handle, cps.ctypes.data, len(cps), gids.ctypes.data, adv.ctypes.data,
                     xoff.ctypes.data)
    return [(int(gids[i]), int(adv[i]), int(xoff[i])) for i in range(n)]


@pytest.mark.parametrize("path", FONTS, ids=_name)
def test_glyph_runs_equal_harfbuzz(path):
    """Seeded strings (Latin runs and digit-only runs, whose script is
    Common) shaped by HarfBuzz with FreeType's unhinted advances, and the
    kerning pairs that fire (A/V, T/., L/T)."""
    hb = _Hb()
    rng = np.random.default_rng(11)
    texts = ["AVAT", "T.", "LT", "Y,", "1/2", "2024-01-31", "$1,250"]
    texts += ["".join(rng.choice(list(CHARSET.strip()), int(rng.integers(2, 14))))
              for _ in range(30)]
    for size in (11, 24):
        ft, port = oracle.FtFace(path, size), truetype.FreeTypeFont(path, size)
        try:
            for text in texts:
                assert _port_shape(port, text) == hb.shape(ft, text), (size, text)
        finally:
            ft.close()


def _default_feature_lookups(font, table):
    """{(script, feature, lookup index, lookup type)} of HarfBuzz's default
    horizontal features whose first-glyph coverage meets the charset."""
    from fontTools.ttLib import TTFont

    t = TTFont(font)
    if table not in t:
        return set()
    cmap = t.getBestCmap()
    glyphs = {cmap[ord(c)] for c in CHARSET if ord(c) in cmap}
    default = {"abvm", "blwm", "ccmp", "locl", "mark", "mkmk", "rlig", "calt", "clig", "curs",
               "dist", "kern", "liga", "rclt", "rvrn"}
    tb = t[table].table
    fired = set()
    for sr in tb.ScriptList.ScriptRecord:
        if sr.ScriptTag not in ("DFLT", "latn") or sr.Script.DefaultLangSys is None:
            continue
        for fi in sr.Script.DefaultLangSys.FeatureIndex:
            fr = tb.FeatureList.FeatureRecord[fi]
            if fr.FeatureTag not in default:
                continue
            for li in fr.Feature.LookupListIndex:
                lk = tb.LookupList.Lookup[li]
                for st in lk.SubTable:
                    st = getattr(st, "ExtSubTable", st)
                    if getattr(st, "Format", None) == 3 and hasattr(st, "InputCoverage"):
                        cov = set(st.InputCoverage[0].glyphs)
                    elif hasattr(st, "Coverage"):
                        cov = set(st.Coverage.glyphs)
                    elif hasattr(st, "MarkCoverage"):
                        cov = set(st.MarkCoverage.glyphs)
                    elif hasattr(st, "mapping"):
                        cov = set(st.mapping)
                    elif hasattr(st, "ligatures"):
                        cov = set(st.ligatures)
                    else:
                        cov = set()
                    if cov & glyphs:
                        fired.add((sr.ScriptTag, fr.FeatureTag, li, lk.LookupType))
    return fired


@pytest.mark.parametrize("path", FONTS, ids=_name)
def test_probe_only_pair_kerning_fires(path):
    """No GSUB lookup of a default feature starts on a charset glyph, and of
    GPOS only the kern feature's pair adjustments (lookup type 2) do: what
    the engine's layout implements."""
    assert _default_feature_lookups(path, "GSUB") == set()
    gpos = _default_feature_lookups(path, "GPOS")
    assert all(feat == "kern" and kind == 2 for _, feat, _, kind in gpos), gpos
    kerned = {"DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSans-Oblique.ttf",
              "DejaVuSans-BoldOblique.ttf", "DejaVuSerif.ttf", "DejaVuSerif-Bold.ttf",
              "DejaVuSerif-Italic.ttf", "DejaVuSerif-BoldItalic.ttf",
              "AtkinsonHyperlegibleNext[wght].ttf"}
    assert bool(gpos) == (_name(path) in kerned)
