"""PyTorch port: the network OCR engines (``ocr/ocrspace.py``,
``ocr/easyocr_engine.py``) against the JAX package's with the same fakes:
the JAX package's ``tests/unit/test_ocrspace.py`` and
``test_easyocr_engine.py`` on both, every payload field equal, each PNG
decoded by Pillow to JAX's pixels with Pillow's own row filters (the deflate
bytes come from this interpreter's zlib, which need not be the zlib
Pillow's wheel deflates with), every array the EasyOCR reader sees equal.
Tolerance: none (OpenCV's IPP off in the JAX engines, as the port is
OpenCV's own code)."""

import base64
import io
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from twinvoice_tpu.ocr.easyocr_engine import EasyOcrEngine as JEasyOcrEngine
from twinvoice_tpu.ocr.ocrspace import OcrSpaceEngine as JOcrSpaceEngine
from twinvoice_tpu_torch.ocr import ocrspace
from twinvoice_tpu_torch.ocr.easyocr_engine import EasyOcrEngine
from twinvoice_tpu_torch.ocr.ocrspace import OcrSpaceEngine
from twinvoice_tpu_torch.ops.host_image import PilPixels

IMG = Image.fromarray(np.full((20, 60, 3), 200, np.uint8))


@pytest.fixture(autouse=True)
def ipp_off():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _crop(seed, h=24, w=90):
    rng = np.random.default_rng(seed)
    crop = rng.integers(160, 256, (h, w, 3), dtype=np.uint8)
    crop[h // 4: 3 * h // 4, 5:w - 5:4] = rng.integers(0, 70, 3, dtype=np.uint8)
    return crop


def _chunks(png):
    i, out = 8, []
    while i < len(png):
        n = int.from_bytes(png[i:i + 4], "big")
        out.append((png[i + 4:i + 8], png[i + 8:i + 8 + n]))
        i += 12 + n
    return out


def _idat(png):
    return zlib.decompress(b"".join(d for t, d in _chunks(png) if t == b"IDAT"))


def _png(payload):
    head = "data:image/png;base64,"
    assert payload["base64Image"].startswith(head)
    return base64.b64decode(payload["base64Image"][len(head):])


class Recorder:
    def __init__(self, text="AB12345678"):
        self.payloads, self.text = [], text

    def __call__(self, payload):
        self.payloads.append(dict(payload))
        return {"ParsedResults": [{"ParsedText": self.text}]}


@pytest.mark.parametrize("mode", ["text", "amount", "invoice", "date"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_payload_equals_jax(mode, seed):
    crop = _crop(seed, 20 + 7 * seed, 60 + 31 * seed)
    jrec, trec = Recorder(), Recorder()
    j = JOcrSpaceEngine(api_key="k", transport=jrec).read(Image.fromarray(crop), mode=mode)
    for src in (Image.fromarray(crop), crop, PilPixels(crop)):
        t = OcrSpaceEngine(api_key="k", transport=trec).read(src, mode=mode)
        assert (t.text, t.engine) == (j.text, j.engine)
    want = jrec.payloads[0]
    for got in trec.payloads:
        assert {k: v for k, v in got.items() if k != "base64Image"} == {
            k: v for k, v in want.items() if k != "base64Image"}
        jpng, tpng = _png(want), _png(got)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(tpng))),
                              np.asarray(Image.open(io.BytesIO(jpng))))
        assert Image.open(io.BytesIO(tpng)).mode == "L"
        assert [t for t, _ in _chunks(tpng)] == [t for t, _ in _chunks(jpng)]
        assert _idat(tpng) == _idat(jpng)  # Pillow's filter on every row


@pytest.mark.parametrize("shape", [(1, 1), (1, 300), (300, 1), (3, 5), (70, 1300),
                                   (400, 700)])
@pytest.mark.parametrize("kind", ["random", "binary", "ramp", "flat"])
def test_png_rows_and_chunks_equal_pillow(shape, kind):
    """``encode_png_gray`` against ``Image.save(format="PNG")``: the same
    chunks (IDAT cut at max(64 KiB, 4·width)) and filtered rows, the same
    pixels decoded."""
    rng = np.random.default_rng(len(kind) * 7 + shape[0])
    h, w = shape
    g = {"random": lambda: rng.integers(0, 256, shape, dtype=np.uint8),
         "binary": lambda: ((rng.random(shape) < 0.3) * 255).astype(np.uint8),
         "ramp": lambda: np.clip(np.cumsum(rng.integers(-3, 4, shape), 1) + 128, 0,
                                 255).astype(np.uint8),
         "flat": lambda: np.full(shape, 7, np.uint8)}[kind]()
    buf = io.BytesIO()
    Image.fromarray(g).save(buf, format="PNG")
    ours = ocrspace.encode_png_gray(g)
    theirs = _chunks(buf.getvalue())
    assert [t for t, _ in _chunks(ours)] == [t for t, _ in theirs]
    assert [len(d) for t, d in _chunks(ours) if t != b"IDAT"] == [
        len(d) for t, d in theirs if t != b"IDAT"]
    assert _idat(ours) == _idat(buf.getvalue()) == ocrspace.filter_rows_like_pillow(g)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(ours))), g)


def test_reads_parsed_text():
    seen = {}

    def transport(payload):
        seen.update(payload)
        return {"ParsedResults": [{"ParsedText": "AB12345678"}]}

    eng = OcrSpaceEngine(api_key="k", transport=transport)
    out = eng.read(IMG, mode="text")
    assert out.text == "AB12345678" and out.engine == "ocr.space"
    assert seen["apikey"] == "k"
    assert seen["language"] == "chs" and seen["OCREngine"] == 2
    assert seen["isOverlayRequired"] is False
    assert seen["base64Image"].startswith("data:image/png;base64,")


def test_mode_changes_enhancement():
    payloads = []

    def transport(payload):
        payloads.append(payload["base64Image"])
        return {"ParsedResults": [{"ParsedText": "x"}]}

    eng = OcrSpaceEngine(api_key="k", transport=transport)
    eng.read(IMG, mode="text")    # Otsu-binarized
    eng.read(IMG, mode="amount")  # never binarized
    assert payloads[0] != payloads[1]


@pytest.mark.parametrize("reply", [{"bad": "shape"}, {"ParsedResults": []},
                                   {"ParsedResults": [{"ParsedText": None}]}, "boom"])
def test_failures_return_empty_as_jax(reply):
    def transport(payload):
        if reply == "boom":
            raise RuntimeError("network down")
        return reply

    j = JOcrSpaceEngine(api_key="k", transport=transport).read(IMG)
    t = OcrSpaceEngine(api_key="k", transport=transport).read(IMG)
    assert (t.text, t.engine) == (j.text, j.engine) == ("", "ocr.space")


def test_unavailable_without_key(monkeypatch):
    monkeypatch.delenv("OCR_SPACE_API_KEY", raising=False)
    eng = OcrSpaceEngine()
    assert not eng.available()
    assert eng.read(IMG).text == ""
    monkeypatch.setenv("OCR_SPACE_API_KEY", "from-env")
    assert OcrSpaceEngine().api_key == JOcrSpaceEngine().api_key == "from-env"
    assert (ocrspace.API_URL, ocrspace.API_KEY_ENV) == (
        "https://api.ocr.space/parse/image", "OCR_SPACE_API_KEY")


class FakeReader:
    def __init__(self, words=("統一編號", "AB-12345678")):
        self.words = list(words)
        self.calls = []

    def readtext(self, img, detail=0):
        assert detail == 0
        self.calls.append(np.array(img))
        return self.words


def test_easyocr_unavailable_without_reader():
    eng = EasyOcrEngine()  # no easyocr package here
    assert not eng.available() and not JEasyOcrEngine().available()
    assert eng.read(Image.new("RGB", (10, 10))).text == ""


@pytest.mark.parametrize("seed", [0, 1])
def test_easyocr_reader_sees_jax_arrays(seed):
    crop = _crop(seed + 10, 31, 77)
    jfake, tfake = FakeReader(), FakeReader()
    j = JEasyOcrEngine(reader=jfake).read(Image.fromarray(crop))
    for src in (Image.fromarray(crop), crop, PilPixels(crop)):
        t = EasyOcrEngine(reader=tfake).read(src)
        assert (t.text, t.engine) == (j.text, j.engine) == ("統一編號 AB-12345678", "easyocr")
    for seen in tfake.calls:
        assert seen.ndim == 2 and seen.dtype == np.uint8
        assert np.array_equal(seen, jfake.calls[0])


def test_easyocr_reader_exception_degrades_to_empty():
    class Boom:
        def readtext(self, img, detail=0):
            raise RuntimeError("ocr crashed")

    assert EasyOcrEngine(reader=Boom()).read(Image.new("RGB", (10, 10))).text == ""
    assert EasyOcrEngine(reader=FakeReader()).read(np.zeros((4, 4), np.uint8)).text == ""


def test_easyocr_in_the_extractors_fallback_chain():
    """A fake EasyOCR engine in the port's extractor gives JAX's fields."""
    from twinvoice_tpu.config import FusionConfig as JFusionConfig
    from twinvoice_tpu.fusion.extract import InvoiceExtractor as JExtractor
    from twinvoice_tpu_torch.config import FusionConfig
    from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor

    class GtSeg:
        def segment_pil(self, img):
            return {}, {"invoice_no": img, "date": None, "total_amount": None}

        def segment_array(self, page):
            return {}, {"invoice_no": page, "date": None, "total_amount": None}

    page = np.full((30, 80, 3), 230, np.uint8)
    cfg = dict(use_qr=False, auto_rotate=False)
    j = JExtractor(GtSeg(), None, [JEasyOcrEngine(reader=FakeReader(("XY-98765432",)))],
                   cfg=JFusionConfig(**cfg)).extract(Image.fromarray(page))
    t = InvoiceExtractor(GtSeg(), None, [EasyOcrEngine(reader=FakeReader(("XY-98765432",)))],
                         cfg=FusionConfig(**cfg)).extract(page)
    assert t[0] == j[0] and t[0]["invoice_no"] == "XY98765432"
