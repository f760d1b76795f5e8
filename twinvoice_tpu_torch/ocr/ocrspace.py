"""OCR.space cloud engine — optional HTTP backend behind the OcrEngine
protocol, never on the hot path: the port of ``twinvoice_tpu/ocr/ocrspace.py``.

Reference behavior (app_camera.py:551-570): POST a base64 PNG to
``api.ocr.space/parse/image`` with language=chs, engine 2; empty string on
any failure. The API key comes from the argument or ``OCR_SPACE_API_KEY``,
the transport is injectable, and the per-mode enhancement
(:func:`~twinvoice_tpu_torch.ocr.enhance.enhance_for_ocr`) is applied
inside the engine. The PNG is written without an imaging library: the rows
filtered as Pillow's encoder filters them, deflated by ``zlib`` at Pillow's
settings and cut into IDAT chunks as Pillow cuts them.
"""

from __future__ import annotations

import base64
import os
import struct
import zlib
from typing import Callable, Optional

import numpy as np

from twinvoice_tpu_torch.ocr.base import OcrResult
from twinvoice_tpu_torch.ocr.enhance import enhance_for_ocr

API_URL = "https://api.ocr.space/parse/image"
API_KEY_ENV = "OCR_SPACE_API_KEY"

# Pillow's PNG save: zlib's default level and strategy, a 2¹⁵ window, memory
# level 9, one IDAT chunk per encoder buffer of max(64 KiB, 4·width) bytes
_PNG_LEVEL, _PNG_MEM_LEVEL, _PNG_BLOCK = 6, 9, 65536


def _distance(rows: np.ndarray) -> np.ndarray:
    """Pillow's per-row cost of filtered bytes: each byte's distance from 0
    modulo 256 (``v < 128 ? v : 256 − v``), summed."""
    v = rows.astype(np.int64)
    return np.where(v < 128, v, 256 - v).sum(axis=1)


def filter_rows_like_pillow(gray: np.ndarray) -> bytes:
    """uint8 (H, W) → the PNG scanlines Pillow's encoder deflates: each row
    led by its filter byte, the filter the first of None, Up, Sub and Paeth
    (Pillow's order; Average only under ``optimize``) whose bytes lie
    least far from zero, the row above the first taken as zeros."""
    h, w = gray.shape
    x = gray.astype(np.int64)
    above = np.vstack([np.zeros((1, w), np.int64), x[:-1]])
    left = np.hstack([np.zeros((h, 1), np.int64), x[:, :-1]])
    upleft = np.hstack([np.zeros((h, 1), np.int64), above[:, :-1]])
    pa, pb, pc = np.abs(above - upleft), np.abs(left - upleft), np.abs(left + above - 2 * upleft)
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, above, upleft))
    pred[:, 0] = above[:, 0]  # the first pixel's Paeth is Up (no left byte)
    cands = [(x - p) & 0xFF for p in (0, above, left, pred)]
    kinds = np.array([0, 2, 1, 4], np.uint8)  # None, Up, Sub, Paeth
    pick = np.argmin(np.stack([_distance(c) for c in cands]), axis=0)  # first minimum
    out = np.empty((h, w + 1), np.uint8)
    out[:, 0] = kinds[pick]
    for k, c in enumerate(cands):
        out[pick == k, 1:] = c[pick == k]
    return out.tobytes()


def encode_png_gray(gray: np.ndarray) -> bytes:
    """uint8 (H, W) → an 8-bit grayscale PNG laid out as Pillow's
    ``Image.fromarray(gray).save(buf, format="PNG")`` lays it out: IHDR, the
    IDAT chunks, IEND. The decoded pixels are Pillow's; the deflate stream
    is this interpreter's ``zlib`` at Pillow's settings (Pillow's wheels may
    deflate with another zlib build, which gives other bytes for the same
    data)."""
    gray = np.ascontiguousarray(gray, np.uint8)
    h, w = gray.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    z = zlib.compressobj(_PNG_LEVEL, zlib.DEFLATED, 15, _PNG_MEM_LEVEL)
    data = z.compress(filter_rows_like_pillow(gray)) + z.flush()
    block = max(_PNG_BLOCK, 4 * w)
    idat = b"".join(chunk(b"IDAT", data[i:i + block]) for i in range(0, len(data), block))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + idat + chunk(b"IEND", b""))


def _default_transport(payload: dict) -> dict:
    import requests

    return requests.post(API_URL, data=payload, timeout=30).json()


class OcrSpaceEngine:
    name = "ocr.space"

    def __init__(
        self,
        api_key: Optional[str] = None,
        transport: Optional[Callable[[dict], dict]] = None,
        language: str = "chs",
        engine: int = 2,
    ):
        self.api_key = api_key or os.environ.get(API_KEY_ENV, "")
        self.transport = transport or _default_transport
        self.language = language
        self.engine = engine

    def available(self) -> bool:
        return bool(self.api_key)

    def read(self, image, mode: str = "text") -> OcrResult:
        if not self.available():
            return OcrResult("", self.name)
        gray = enhance_for_ocr(image, mode=mode)
        payload = {
            "apikey": self.api_key,
            "language": self.language,
            "isOverlayRequired": False,
            "base64Image": "data:image/png;base64,"
            + base64.b64encode(encode_png_gray(gray)).decode(),
            "OCREngine": self.engine,
        }
        try:
            resp = self.transport(payload)
            text = resp["ParsedResults"][0]["ParsedText"]
            return OcrResult(text or "", self.name)
        except Exception:
            return OcrResult("", self.name)
