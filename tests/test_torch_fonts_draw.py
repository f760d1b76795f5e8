"""PyTorch port: the stroke fonts' drawing (``ocr/fonts/strokefont.py``'s
``draw_char``, ``draw_text``, ``render_char``, ``render_text``; the whole of
``ocr/fonts/latin_glyphs.py``) against the JAX package, with Pillow on the
CPU: every render byte for byte equal, and a style generator left in JAX's
state. The port's ``render_char`` and ``render_text`` draw on
``ops/host_pildraw`` without Pillow (Pillow's default font from
``ocr/fonts/truetype.load_default``). ``tests/test_torch_imports.py``
imports both modules with Pillow blocked."""

import numpy as np
import pytest
from PIL import Image, ImageDraw

from twinvoice_tpu.ocr.fonts import latin_glyphs as jlatin
from twinvoice_tpu.ocr.fonts import strokefont as jstroke
from twinvoice_tpu_torch.ocr import fonts as tfonts
from twinvoice_tpu_torch.ocr.fonts import latin_glyphs as tlatin
from twinvoice_tpu_torch.ocr.fonts import strokefont as tstroke

LINES = ("統一發票 AB-12345678", "奶茶 2 x 60 = 120", "電子發票證明聯", "Total: NT$1,250",
         "")


def test_render_char_over_the_coverage():
    cover = sorted(tstroke.coverage())
    assert cover == sorted(jstroke.coverage()) and len(cover) > 300
    for ch in cover:
        np.testing.assert_array_equal(tstroke.render_char(ch), jstroke.render_char(ch), err_msg=ch)
    np.testing.assert_array_equal(tstroke.render_char("票", size=23, pad=1),
                                  jstroke.render_char("票", size=23, pad=1))


@pytest.mark.parametrize("size", [20, 48])
def test_render_text(size):
    for text in LINES:
        np.testing.assert_array_equal(tfonts.render_text(text, size=size),
                                      jstroke.render_text(text, size=size))
        np.testing.assert_array_equal(tfonts.render_text(text, size=size, weight=9.0, pad=2),
                                      jstroke.render_text(text, size=size, weight=9.0, pad=2))


def test_styled_draw_text_and_generator_state():
    """``draw_text`` with a style generator: the same pixels, the advance and
    the generator's state afterwards."""
    for k, text in enumerate(LINES[:4]):
        imgs, states, advances = [], [], []
        for mod in (tstroke, jstroke):
            rng = np.random.default_rng(k)
            img = Image.new("L", (900, 60), 255)
            advances.append(mod.draw_text(ImageDraw.Draw(img), (4, 4), text, 40, fill=20,
                                          style_rng=rng, jitter=0.05))
            imgs.append(np.asarray(img))
            states.append(rng.bit_generator.state)
        np.testing.assert_array_equal(imgs[0], imgs[1])
        assert advances[0] == advances[1] and states[0] == states[1]


def test_latin_glyph_tables():
    assert tlatin.GLYPHS == jlatin.GLYPHS and tlatin.ADVANCE == jlatin.ADVANCE
    assert tlatin.coverage() == jlatin.coverage()
    assert tlatin.LatinStyle() == tlatin.LatinStyle(**vars(jlatin.LatinStyle()))


def test_latin_draw_text_under_50_styles():
    """``sample_style(np.random.default_rng(k))`` for k < 50: the same style
    and generator state, and the same line drawn in it."""
    text = "AB-12345678 2025/09/09 NT$1,250 (*) #7: Q.W.Z"
    for k in range(50):
        rngs = [np.random.default_rng(k), np.random.default_rng(k)]
        styles = [tlatin.sample_style(rngs[0]), jlatin.sample_style(rngs[1])]
        assert vars(styles[0]) == vars(styles[1]), k
        assert rngs[0].bit_generator.state == rngs[1].bit_generator.state
        out = []
        for mod, style in ((tlatin, styles[0]), (jlatin, jlatin.LatinStyle(**vars(styles[0])))):
            img = Image.new("L", (1400, 70), 255)
            adv = mod.draw_text(ImageDraw.Draw(img), (5, 8), text, 44, fill=10, style=style)
            out.append((np.asarray(img), adv))
        np.testing.assert_array_equal(out[0][0], out[1][0], err_msg=str(k))
        assert out[0][1] == out[1][1]
