"""Canned OCR engine for tests (``twinvoice_tpu.ocr.fake``)."""

from __future__ import annotations

from typing import Callable, Union

from twinvoice_tpu_torch.ocr.base import OcrResult


class FakeOcrEngine:
    """Returns scripted text.

    ``script`` can be a plain string (always returned), a list consumed in
    call order, or a callable ``(image, mode) -> str``.
    """

    def __init__(self, script: Union[str, list, Callable] = "", name: str = "fake"):
        self.name = name
        self._script = script
        self.calls = []

    def read(self, image, mode: str = "text") -> OcrResult:
        self.calls.append(mode)
        s = self._script
        if callable(s):
            return OcrResult(s(image, mode), self.name)
        if isinstance(s, list):
            return OcrResult(s.pop(0) if s else "", self.name)
        return OcrResult(s, self.name)
