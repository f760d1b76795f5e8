"""The OCR result type and the empty engine: the port's own copies of
``twinvoice_tpu/ocr/base.py:OcrResult`` and ``NullOcrEngine``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class OcrResult:
    text: str
    engine: str
    confidence: Optional[float] = None

    def __bool__(self):
        return bool(self.text)


class NullOcrEngine:
    """Always-empty engine (used when an optional backend is unavailable)."""

    name = "null"

    def read(self, image, mode: str = "text") -> OcrResult:
        return OcrResult("", self.name)
