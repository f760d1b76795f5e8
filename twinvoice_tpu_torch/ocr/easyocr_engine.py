"""EasyOCR-backed local engine (reference app_camera.py:73, 817-833): the
port of ``twinvoice_tpu/ocr/easyocr_engine.py``. Gated: without the
``easyocr`` package (or an injected reader) construction degrades to
unavailable and the fusion pipeline falls through to the next engine. The
port's own local engine is ``ocr.torchocr.TorchOcrEngine``.
"""

from __future__ import annotations

from twinvoice_tpu_torch.ocr.base import OcrResult
from twinvoice_tpu_torch.ocr.enhance import grayscale_for_ocr


class EasyOcrEngine:
    name = "easyocr"

    def __init__(self, languages=("ch_tra", "en"), reader=None):
        """``reader``: inject any object with EasyOCR's
        ``readtext(img, detail=0) -> list[str]`` surface (tests use a fake;
        deployments may pass a pre-warmed Reader to skip the model load)."""
        self._reader = reader
        if self._reader is None:
            try:
                import easyocr

                self._reader = easyocr.Reader(list(languages), gpu=False)
            except Exception:
                self._reader = None

    def available(self) -> bool:
        return self._reader is not None

    def read(self, image, mode: str = "text") -> OcrResult:
        if self._reader is None:
            return OcrResult("", self.name)
        try:
            gray = grayscale_for_ocr(image)
            words = self._reader.readtext(gray, detail=0)
            return OcrResult(" ".join(words), self.name)
        except Exception:
            return OcrResult("", self.name)
