"""PyTorch port: the held-out fonts (``data.synthetic.heldout_fonts``) and
the TrueType engine on them, against Pillow 12.1 and the FreeType and
HarfBuzz it renders with (``tests/truetype_oracle.py``).

What is held, byte for byte, at the sizes ``render_invoice`` draws values
at (18–26):

- the registry: JAX's seven faces in JAX's order, the bundled copies equal
  to the packages' files, the six bundled ones alone where matplotlib and
  pygame are missing (the card's machine), the training fonts only where no
  candidate exists;
- each face's charset glyphs (``getmask2`` mask and offset, ``getlength``)
  and seeded invoice strings (numbers, dates, amounts) whole: STIX General
  and its bold and FreeSans Bold through the auto-hinter, Computer Modern
  Roman and Sans, Liberation Sans and Playfair Display through the
  bytecode interpreter (``ROLL``, Playfair's overlap flags rendered 4×
  oversampled);
- FreeSans Bold's legacy ``kern`` table (HarfBuzz applies it where GPOS has
  no ``kern`` feature): the kerned pairs of the charset, the glyph runs
  against ``hb_shape``; Playfair's default GSUB/GPOS features on the value
  strings against ``hb_shape``;
- the auto-hinted outlines of the charset against ``FT_Load_Glyph``, and
  Pillow's default font's ``.notdef`` (the CJK labels), which FreeType
  hints with its CJK writing system, at sizes 6–29.
"""

import os
import zlib

import numpy as np
import pytest
from PIL import ImageFont

from tests import truetype_oracle as oracle
from tests.test_torch_truetype import _Hb, _ft_outline, _outline, _pil_mask, _port_shape
from twinvoice_tpu.data.synthetic import heldout_fonts as jax_heldout_fonts
from twinvoice_tpu_torch.data import synthetic
from twinvoice_tpu_torch.ocr.fonts import truetype
from twinvoice_tpu_torch.ocr.torchocr.charset import CHARSET

FONTS = jax_heldout_fonts()
SIZES = range(18, 27)
CJK_LABELS = ("發票號碼", "日期", "總計", "電子發票證明聯", "測試品項")


def _name(path):
    return os.path.basename(path)


def value_strings(seed, n=12):
    """Invoice numbers, dates and amounts as ``make_base_cases`` draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        letters = "".join(rng.choice(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"), 2))
        digits = "".join(rng.choice(list("0123456789"), 8))
        out += [f"{letters}-{digits}",
                f"{rng.integers(2019, 2031)}-{rng.integers(1, 13):02d}-{rng.integers(1, 29):02d}",
                str(rng.integers(1, 99999))]
    return out


def test_registry_is_jaxs():
    port = synthetic.heldout_fonts()
    assert [_name(p) for p in port] == [_name(p) for p in FONTS]
    assert len(FONTS) == 7
    for mine, theirs in zip(port, FONTS):
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), mine
    assert [p for p in port if not p.startswith(str(synthetic.BUNDLED_FONTS))] == [
        p for p in FONTS if _name(p) == "sans.ttf"]


def test_registry_without_the_packages(monkeypatch, tmp_path):
    """The card's machine has neither matplotlib nor pygame: the six bundled
    faces; with nothing bundled either, the training fonts, as JAX's falls
    back."""
    monkeypatch.setattr(synthetic, "_package_dir", lambda name: "")
    got = synthetic.heldout_fonts()
    assert [_name(p) for p in got] == [_name(p) for p in FONTS if _name(p) != "sans.ttf"]
    assert all(os.path.isfile(p) for p in got)
    monkeypatch.setattr(synthetic, "BUNDLED_FONTS", tmp_path)
    assert synthetic.heldout_fonts() == synthetic.train_fonts()


@pytest.mark.parametrize("path", FONTS, ids=_name)
def test_glyphs_and_values_equal_pillow(path):
    """The charset alone and seeded invoice strings at sizes 18–26: mask,
    offset, length."""
    texts = list(CHARSET) + value_strings(zlib.crc32(_name(path).encode()))
    for size in SIZES:
        pil, port = ImageFont.truetype(path, size), truetype.FreeTypeFont(path, size)
        for text in texts[: len(CHARSET)] + texts[len(CHARSET) + (size % 3)::3]:
            want, woff = _pil_mask(pil, text)
            got, goff = port.getmask2(text)
            assert goff == woff and np.array_equal(got, want), (size, text)
            assert port.getlength(text) == pil.getlength(text), (size, text)


def _kerned_pairs(path, limit=40):
    from fontTools.ttLib import TTFont

    t = TTFont(path)
    cmap = t.getBestCmap()
    names = {cmap[ord(c)]: c for c in CHARSET.strip() if ord(c) in cmap}
    pairs = [a + b for (l, r), v in t["kern"].kernTables[0].kernTable.items()
             if v and l in names and r in names for a, b in [(names[l], names[r])]]
    return sorted(pairs)[:limit]


def test_freesans_legacy_kern_table():
    """FreeSans Bold has a ``kern`` table and no GPOS: HarfBuzz kerns from it,
    each pair's value split between the two glyphs' advances and the second's
    offset."""
    path = next(p for p in FONTS if _name(p) == "freesansbold.ttf")
    pairs = _kerned_pairs(path)
    assert len(pairs) >= 10
    hb = _Hb()
    for size in (18, 22, 26):
        pil, port = ImageFont.truetype(path, size), truetype.FreeTypeFont(path, size)
        ft = oracle.FtFace(path, size)
        kerned = 0
        try:
            for pair in pairs:
                text = pair + "1" + pair[::-1]
                assert port.getlength(pair) == pil.getlength(pair), (size, pair)
                kerned += pil.getlength(pair) != pil.getlength(pair[0]) + pil.getlength(pair[1])
                assert _port_shape(port, text) == hb.shape(ft, text), (size, text)
                want, woff = _pil_mask(pil, text)
                got, goff = port.getmask2(text)
                assert goff == woff and np.array_equal(got, want), (size, text)
        finally:
            ft.close()
        assert kerned >= len(pairs) // 2, (size, kerned)


@pytest.mark.parametrize("path", [p for p in FONTS if "Playfair" in p or "sans.ttf" in p],
                         ids=_name)
def test_shaped_runs_equal_harfbuzz(path):
    """The value strings shaped with every default feature (Playfair's
    ``ccmp``, ``locl``, ``rlig``, ``calt``, ``liga``, ``mark``, ``mkmk``;
    Liberation's GPOS ``kern``) as HarfBuzz shapes them."""
    hb = _Hb()
    for size in (18, 24):
        ft, port = oracle.FtFace(path, size), truetype.FreeTypeFont(path, size)
        try:
            for text in value_strings(3, 6):
                assert _port_shape(port, text) == hb.shape(ft, text), (size, text)
        finally:
            ft.close()


@pytest.mark.parametrize("path", [p for p in FONTS if truetype.FreeTypeFont(p, 12).autohinted],
                         ids=_name)
def test_autohinted_outlines_equal_freetype(path):
    """STIX General, its bold and FreeSans Bold have no font program: the
    auto-hinter's outline and advance of the charset at 18–26."""
    for size in SIZES:
        ft, port = oracle.FtFace(path, size), truetype.FreeTypeFont(path, size)
        try:
            for ch in CHARSET.strip():
                gid = ft.glyph_index(ch)
                want, adv = _ft_outline(ft, gid)
                xy, _, _, got_adv = _outline(port, gid)
                assert np.array_equal(xy, want) and got_adv == adv, (size, ch)
        finally:
            ft.close()


def test_default_font_notdef_equals_freetype_and_pillow():
    """The CJK labels are Pillow's default font's ``.notdef``: FreeType's
    CJK hinter (its fallback style) at sizes 6–29, and the labels' masks
    and lengths at Pillow's size 10."""
    path = str(truetype.DEFAULT_FONT)
    for size in range(6, 30):
        ft, port = oracle.FtFace(path, size), truetype.FreeTypeFont(path, size)
        try:
            want, adv = _ft_outline(ft, 0)
            xy, _, _, got_adv = _outline(port, 0)
            assert np.array_equal(xy, want) and got_adv == adv, size
        finally:
            ft.close()
    pil, port = ImageFont.load_default(), truetype.load_default()
    for text in CJK_LABELS:
        want, woff = _pil_mask(pil, text)
        got, goff = port.getmask2(text)
        assert goff == woff and np.array_equal(got, want), text
        assert port.getlength(text) == pil.getlength(text), text
