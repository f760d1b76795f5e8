"""The OCR result type, the engine protocol and the empty engine: the
port's own copies of ``twinvoice_tpu/ocr/base.py``'s ``OcrResult``,
``OcrEngine`` and ``NullOcrEngine``. Every engine satisfies the one
protocol, so the fusion code, the tests' fakes and the recognizer are
interchangeable."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable


@dataclass
class OcrResult:
    text: str
    engine: str
    confidence: Optional[float] = None

    def __bool__(self):
        return bool(self.text)


@runtime_checkable
class OcrEngine(Protocol):
    """An OCR engine reads one crop and returns text ('' on failure)."""

    name: str

    def read(self, image, mode: str = "text") -> OcrResult:
        """``image``: a uint8 array (gray or RGB) or a PIL image; ``mode``:
        "text" | "amount" | "invoice" | "date"."""
        ...


class NullOcrEngine:
    """Always-empty engine (used when an optional backend is unavailable)."""

    name = "null"

    def read(self, image, mode: str = "text") -> OcrResult:
        return OcrResult("", self.name)
