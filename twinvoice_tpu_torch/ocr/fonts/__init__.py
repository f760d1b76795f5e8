"""The in-repo Traditional-Chinese stroke font: the port's copy of the
glyph data and resolver of ``twinvoice_tpu/ocr/fonts`` (``strokefont``),
which give the recognizer's CJK charset (``torchocr.charset.cjk_charset``)."""

from twinvoice_tpu_torch.ocr.fonts.strokefont import coverage, glyph_strokes, has_glyph  # noqa: F401
