"""The in-repo stroke fonts: the port's copies of ``twinvoice_tpu/ocr/fonts``
(``strokefont``, the Traditional-Chinese stroke font whose coverage gives the
recognizer's CJK charset, ``torchocr.charset.cjk_charset``; ``latin_glyphs``,
the parametric Latin typeface of the recognizer's training lines)."""

from twinvoice_tpu_torch.ocr.fonts.strokefont import (  # noqa: F401
    coverage,
    draw_text,
    glyph_strokes,
    has_glyph,
    render_char,
    render_text,
)
