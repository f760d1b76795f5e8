"""PyTorch port: field fusion (``twinvoice_tpu_torch/fusion/``) against the JAX
package's ``InvoiceExtractor``, and the ``Segmenter``'s array entry points
against JAX's PIL ones.

Tolerance: none. ``extract`` and ``extract_batch`` return equal ``(meta,
items, qr_raw)`` (failures compared as ``(stage, error)``: their time stamps
and details differ run to run) with each package's stub segmenters returning
the same crops, stub QR scanners returning the same payloads and fake
engines (the cases of ``tests/unit/test_fusion.py`` and
``test_extract_batch.py``), and with both real OCR engines and QR pipelines
on rendered invoices. The array entry points give JAX's masks and crops on a
random base-width-8 U-Net at 64².
"""

import hashlib
import sys
import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from chip_smoke import NoFieldSegmenter, fusion_record
from tests.torch_port_cases import random_unet
from twinvoice_tpu.config import FusionConfig as JaxFusionConfig
from twinvoice_tpu.config import InferConfig as JaxInferConfig
from twinvoice_tpu.data.synthetic import render_invoice
from twinvoice_tpu.fusion import extract as jextract
from twinvoice_tpu.infer.pipeline import Segmenter as JaxSegmenter
from twinvoice_tpu.ocr.base import OcrResult as JaxOcrResult
from twinvoice_tpu.utils import tracing as jtracing
from twinvoice_tpu_torch import FIELDS
from twinvoice_tpu_torch.config import FusionConfig, InferConfig, UNetConfig
from twinvoice_tpu_torch.fusion import extract as textract
from twinvoice_tpu_torch.infer.pipeline import Segmenter
from twinvoice_tpu_torch.ocr.base import OcrResult
from twinvoice_tpu_torch.qr import detect as tdetect
from twinvoice_tpu_torch.utils import tracing as ttracing
from twinvoice_tpu_torch.weights import from_jax_params

GRID = 64


def _gray(image):
    """What an engine reads of a crop: a PIL crop's ``convert("L")`` (JAX),
    the gray array the port hands it."""
    return np.asarray(image.convert("L") if hasattr(image, "convert") else image)


class FakeEngine:
    """Scripted engine (``twinvoice_tpu.ocr.fake.FakeOcrEngine``'s rules) for
    either package: a string, a list consumed in call order, or a callable
    ``(gray crop, mode) -> str``."""

    def __init__(self, result_cls, script="", name="fake", batch=False):
        self.result_cls, self.name, self._script = result_cls, name, script
        self.calls = []
        if batch:
            self.read_batch = lambda images, modes=None: [
                self.read(im, m) if im is not None else None
                for im, m in zip(images, modes or ["text"] * len(images))]

    def read(self, image, mode="text"):
        self.calls.append(mode)
        s = self._script
        if callable(s):
            return self.result_cls(s(_gray(image), mode), self.name)
        if isinstance(s, list):
            return self.result_cls(s.pop(0) if s else "", self.name)
        return self.result_cls(s, self.name)


def _engines(make):
    """→ (JAX engines, port engines) from ``make(result_cls)``."""
    return make(JaxOcrResult), make(OcrResult)


class JaxStubSeg:
    """Returns fixed PIL crops of ``crops`` (field → RGB array or None)."""

    def __init__(self, crops, fail=False):
        self.crops = {f: None if c is None else Image.fromarray(c) for f, c in crops.items()}
        self.fail, self.single_calls, self.batch_calls = fail, 0, 0

    def segment_pil(self, im):
        self.single_calls += 1
        if self.fail:
            raise RuntimeError("segmenter down")
        return {}, dict(self.crops)

    def segment_pil_batch(self, ims, *, return_masks=True, gray_h2d=False, h2d_chunks=1):
        self.batch_calls += 1
        return [({} if return_masks else None, dict(self.crops)) for _ in ims]


class TorchStubSeg(JaxStubSeg):
    """The same crops, as arrays, through the port's entry points."""

    def __init__(self, crops, fail=False):
        super().__init__({}, fail)
        self.crops = dict(crops)

    segment_array = JaxStubSeg.segment_pil
    segment_array_batch = JaxStubSeg.segment_pil_batch


class StubQr:
    """Payloads by the page's pixel bytes (a PIL page and its array alike)."""

    def __init__(self, payloads=(), by_page=None, fail=False):
        self.payloads, self.by_page, self.fail = list(payloads), by_page or {}, fail

    def scan(self, image):
        if self.fail:
            raise ValueError("scanner down")
        key = hashlib.md5(np.asarray(image).tobytes()).hexdigest()
        return list(self.by_page.get(key, self.payloads))


def _page_key(page):
    return hashlib.md5(np.asarray(page).tobytes()).hexdigest()


def _pages(n, size=(64, 48), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8) for _ in range(n)]


def _luma_split_crop():
    """A 12×30 RGB crop of pixels whose Pillow and OpenCV lumas differ."""
    from twinvoice_tpu_torch.ops.host_image import pil_luma, rgb_to_gray

    px = np.random.default_rng(7).integers(0, 256, (500_000, 1, 3), dtype=np.uint8)
    px = px[pil_luma(px)[:, 0] != rgb_to_gray(px)[:, 0]]
    return np.ascontiguousarray(px[:360].reshape(12, 30, 3))


CROP = np.full((8, 8, 3), 200, np.uint8)
COLOUR = _luma_split_crop()
ALL = {f: CROP for f in FIELDS}
CFG = {"auto_rotate": False}


def _both(crops, qr, make_engines, cfg=CFG, fail_seg=False):
    """Equal extractors: (JAX, port, their segmenters, their engines)."""
    jeng, teng = _engines(make_engines)
    jseg, tseg = JaxStubSeg(crops, fail_seg), TorchStubSeg(crops, fail_seg)
    jex = jextract.InvoiceExtractor(jseg, qr, jeng, cfg=JaxFusionConfig(**cfg))
    tex = textract.InvoiceExtractor(tseg, qr, teng, cfg=FusionConfig(**cfg))
    return jex, tex, (jseg, tseg), (jeng, teng)


def _same(jres, tres):
    assert fusion_record(*tres) == fusion_record(*jres)


SINGLE_CASES = {
    "qr_wins": (ALL, StubQr(["AB123456781140909" + "x" * 10, "**奶茶:2:30"]),
                lambda r: [FakeEngine(r, "60")]),
    "ocr_priority": (ALL, StubQr([]), lambda r: [
        FakeEngine(r, lambda img, mode: "2025-03-05" if mode != "amount" else "100"),
        FakeEngine(r, lambda img, mode: "ab12345678" if mode != "amount" else "999")]),
    "amount_with_full_qr": (ALL, StubQr(["AB123456781140909tailtailtail"]),
                            lambda r: [FakeEngine(r, "777")]),
    "items_reconciled": (ALL, StubQr(["AB123456781140909xxxxxxxxxx", "**紅茶:1:22:鬆餅:1:22"]),
                         lambda r: [FakeEngine(r, "46")]),
    "no_crops": ({f: None for f in FIELDS}, StubQr([]),
                 lambda r: [FakeEngine(r, "XX11223344")]),
    "pillow_luma_reaches_engines": (
        {"invoice_no": COLOUR, "date": CROP, "total_amount": COLOUR}, StubQr([]),
        lambda r: [FakeEngine(r, lambda img, mode: f"{img.ndim}:{int(img.sum())}", batch=True),
                   FakeEngine(r, lambda img, mode: str(int(img.astype(int).sum() % 997)))]),
    "batch_engine_and_date": (ALL, StubQr(["XY98765432"]), lambda r: [
        FakeEngine(r, lambda img, mode: {"invoice": "x", "date": "on 2024/12/3 ok",
                                         "amount": "NT$ 1,250"}[mode], batch=True)]),
    "qr_scanner_fails": (ALL, StubQr(fail=True), lambda r: [FakeEngine(r, "5")]),
    "engine_fails": (ALL, StubQr([]), lambda r: [
        FakeEngine(r, lambda img, mode: 1 / 0 if mode == "amount" else "CD11223344"),
        FakeEngine(r, "8")]),
    "engines_in_order": (ALL, StubQr([]), lambda r: [
        FakeEngine(r, ["", "2025/1/1", "0"]), FakeEngine(r, ["zz88776655", "", "12"])]),
}


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_extract_equals_jax(case):
    crops, qr, make = SINGLE_CASES[case]
    jex, tex, _, (jeng, teng) = _both(crops, qr, make)
    page = _pages(1, seed=len(case))[0]
    jres, tres = jex.extract(Image.fromarray(page)), tex.extract(page)
    _same(jres, tres)
    assert [e.calls for e in teng] == [e.calls for e in jeng]
    if case == "no_crops":
        assert teng[0].calls == []  # engines never see a None crop
    if case in ("qr_scanner_fails", "engine_fails"):
        assert tres[0]["failures"] and fusion_record(*tres)["meta"]["failures"][0][0] in (
            "qr", "ocr")


def test_extract_segmenter_failure_is_logged():
    jex, tex, _, _ = _both(ALL, StubQr([]), lambda r: [FakeEngine(r, "1")], fail_seg=True)
    page = _pages(1, seed=3)[0]
    jres, tres = jex.extract(Image.fromarray(page)), tex.extract(page)
    _same(jres, tres)
    assert fusion_record(*tres)["meta"]["failures"] == [["segment", "RuntimeError"]]


def test_extract_cache_by_content():
    jex, tex, (jseg, tseg), _ = _both(ALL, StubQr([]), lambda r: [FakeEngine(r, "1")])
    page = _pages(1, seed=4)[0]
    for _ in range(2):
        _same(jex.extract(Image.fromarray(page)), tex.extract(page.copy()))
    assert tseg.single_calls == jseg.single_calls == 1
    assert tex.extract(Image.fromarray(page)) is tex.extract(page)  # PIL page: same key
    assert textract.image_content_key(page) == jextract.image_content_key(Image.fromarray(page))
    tex.clear_cache()
    tex.extract(page)
    assert tseg.single_calls == 2


@pytest.mark.parametrize("workers", [1, 4])
def test_extract_batch_equals_jax_and_single(workers):
    """extract_batch (the QR thread pool with workers > 1) against JAX's, and
    against the port's own extract; one segmenter call."""
    pages = _pages(3, seed=workers)
    qr = StubQr(by_page={_page_key(pages[0]): ["AB123456781140909" + "x" * 12],
                         _page_key(pages[2]): ["XY987654321131231" + "y" * 12,
                                               "**珍珠奶茶:2:60:深焙咖啡:1:80"]})
    make = lambda r: [FakeEngine(r, lambda img, mode: "140" if mode == "amount"  # noqa: E731
                                 else "CD11223344", batch=True)]
    cfg = dict(CFG, host_workers=workers)
    jex, tex, (jseg, tseg), _ = _both(ALL, qr, make, cfg)
    jres = jex.extract_batch([Image.fromarray(p) for p in pages])
    tres = tex.extract_batch(pages)
    for j, t in zip(jres, tres):
        _same(j, t)
    assert tseg.batch_calls == 1 and tseg.single_calls == 0
    _, tex1, _, _ = _both(ALL, qr, make, cfg)
    for p, t in zip(pages, tres):
        single = fusion_record(*tex1.extract(p))
        assert single == fusion_record(*t)


def test_extract_batch_cache_coherent_with_extract():
    pages = _pages(2, seed=9)
    jex, tex, (jseg, tseg), _ = _both(ALL, StubQr([]), lambda r: [FakeEngine(r, "77", batch=True)])
    jex.extract(Image.fromarray(pages[0]))
    tex.extract(pages[0])
    jres = jex.extract_batch([Image.fromarray(p) for p in pages])
    tres = tex.extract_batch(pages)
    for j, t in zip(jres, tres):
        _same(j, t)
    assert (tseg.single_calls, tseg.batch_calls) == (jseg.single_calls, jseg.batch_calls) == (1, 1)
    assert tex.extract_batch(pages[:1])[0] is tex.extract(pages[0])


def test_extract_batch_read_batch_failure_propagates():
    """extract_batch does not guard read_batch, in either package."""
    def broken(r):
        eng = FakeEngine(r, "1", batch=True)
        eng.read_batch = lambda images, modes=None: 1 / 0
        return [eng]

    jex, tex, _, _ = _both(ALL, StubQr([]), broken)
    with pytest.raises(ZeroDivisionError):
        jex.extract_batch([Image.fromarray(p) for p in _pages(2)])
    with pytest.raises(ZeroDivisionError):
        tex.extract_batch(_pages(2))


@pytest.mark.parametrize("box,turn", [((5, 10, 25, 30), 90), ((80, 10, 95, 30), -90),
                                      ((45, 10, 55, 30), 0), (None, 0)])
def test_auto_rotate_equals_pillow(box, turn):
    """Landscape pages with a stub locator: a quarter turn each way is
    Pillow's ``rotate(±90, expand=True)``; a centred or missing QR, and a
    portrait page, are left as they are."""
    page = _pages(1, size=(100, 50), seed=6)[0]
    regions = (lambda im: [box]) if box else (lambda im: [])
    got = textract.auto_rotate_by_qr(page, qr_regions_fn=regions)
    want = jextract.auto_rotate_by_qr(Image.fromarray(page), qr_regions_fn=regions)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == ((100, 50, 3) if turn else (50, 100, 3))
    portrait = _pages(1, size=(50, 100), seed=8)[0]
    assert textract.auto_rotate_by_qr(portrait, qr_regions_fn=lambda im: [(0, 0, 10, 10)]) is portrait


def test_auto_rotate_in_extract(monkeypatch):
    """The default locator on a landscape page with no QR: no turn, as JAX.
    With cv2 blocked in the port, a rendered invoice turned a quarter each
    way is turned back as JAX's cv2 locator turns it, by the numpy locator,
    with no warning and no skip: the scan stub reads the payloads only from
    the upright page."""
    page = _pages(1, size=(100, 50), seed=10)[0]
    make = lambda r: [FakeEngine(r, "3")]  # noqa: E731
    jex, tex, _, _ = _both(ALL, StubQr([]), make, cfg={"auto_rotate": True})
    _same(jex.extract(Image.fromarray(page)), tex.extract(page))
    invoice = np.asarray(render_invoice(seed=0)[0].convert("RGB"))
    payloads = ["AB123456781140909" + "x" * 10, "**奶茶:2:30"]
    qr = StubQr([], by_page={_page_key(invoice): payloads})
    for k in (1, -1):
        turned = np.ascontiguousarray(np.rot90(invoice, k))
        jex, _, _, _ = _both(ALL, qr, make, cfg={"auto_rotate": True})
        jres = jex.extract(Image.fromarray(turned))
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "cv2", None)
            tdetect.passes.clear()
            _, tex, _, _ = _both(ALL, qr, make, cfg={"auto_rotate": True})
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                tres = tex.extract(turned)
        _same(jres, tres)
        assert tres[2] == payloads  # read from the upright page
        assert not any(name.endswith("_skipped") for name in tdetect.passes)


def test_pages_must_be_rgb_uint8():
    _, tex, _, _ = _both(ALL, StubQr([]), lambda r: [])
    for bad in (np.zeros((8, 8), np.uint8), np.zeros((8, 8, 3), np.float32),
                np.zeros((8, 8, 4), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            tex.extract(bad)
    gray = Image.fromarray(np.full((8, 8), 90, np.uint8))
    assert textract.as_page(gray).shape == (8, 8, 3)


def test_fusion_config_and_timer_equal_jax():
    assert FusionConfig() == FusionConfig(**JaxFusionConfig().__dict__)
    jt, tt = jtracing.StageTimer(), ttracing.StageTimer()
    for stage, sec in (("b", 0.002), ("a", 0.5), ("b", 0.004), ("b", 0.001)):
        jt.record(stage, sec)
        tt.record(stage, sec)
    assert tt.report() == jt.report() and tt.stats() == jt.stats()
    tt.reset()
    assert tt.stats() == {} and len(tt.report().splitlines()) == 1


# -- both real OCR engines and QR pipelines on rendered invoices --------------


@pytest.fixture(scope="module")
def rendered():
    """Two rendered invoices and their ground-truth field boxes."""
    from twinvoice_tpu.data.synthetic import render_invoice

    out = []
    for kw in (dict(invoice_no="AB12345678", date_iso="2025-09-09", amount=120, seed=11),
               dict(invoice_no="QK80417265", date_iso="2024-12-31", amount=4580, seed=12,
                    layout_jitter=0.5)):
        img, boxes = render_invoice(**kw)
        out.append((np.asarray(img.convert("RGB")), boxes))
    return out


class _BoxSeg:
    """Crops at fixed boxes: PIL crops for JAX, array views for the port."""

    def __init__(self, boxes_by_page):
        self.boxes_by_page = boxes_by_page

    def _boxes(self, page):
        return self.boxes_by_page[_page_key(page)]

    def segment_pil(self, im):
        return {}, {f: im.crop(b) for f, b in self._boxes(im).items()}

    def segment_pil_batch(self, ims, **kw):
        return [self.segment_pil(im) for im in ims]

    def segment_array(self, page):
        return {}, {f: page[y1:y2, x1:x2] for f, (x1, y1, x2, y2) in self._boxes(page).items()}

    def segment_array_batch(self, pages, **kw):
        return [self.segment_array(p) for p in pages]


def test_real_engines_on_rendered_invoices(rendered):
    """JaxOcrEngine and the QR pipeline of each package on two invoices, on
    extract (QR on), extract_batch (QR off: the fields come from OCR) and the
    full-page fallback (a segmenter that finds no field, QR off)."""
    from twinvoice_tpu.ocr.jaxocr.engine import JaxOcrEngine
    from twinvoice_tpu.qr.detect import QrPipeline as JaxQrPipeline
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

    pages = [p for p, _ in rendered]
    seg = _BoxSeg({_page_key(p): b for p, b in rendered})
    jeng, teng = JaxOcrEngine(), TorchOcrEngine(device="cpu")
    jqr, tqr = JaxQrPipeline(), tdetect.QrPipeline()
    imgs = [Image.fromarray(p) for p in pages]
    routes = {"single": ({}, seg), "batch_noqr": ({"use_qr": False}, seg),
              "fallback": ({"use_qr": False}, NoFieldSegmenter())}
    for route, (kw, s) in routes.items():
        jex = jextract.InvoiceExtractor(s, jqr, [jeng], cfg=JaxFusionConfig(**kw))
        tex = textract.InvoiceExtractor(s, tqr, [teng], cfg=FusionConfig(**kw))
        if route.startswith("batch"):
            jres, tres = jex.extract_batch(imgs), tex.extract_batch(pages)
        else:
            jres = [jex.extract(im) for im in imgs]
            tres = [tex.extract(p) for p in pages]
        for (page, boxes), j, t in zip(rendered, jres, tres):
            _same(j, t)
        metas = [t[0] for t in tres]
        assert [m["invoice_no"] for m in metas] == ["AB12345678", "QK80417265"], route
        if route == "fallback":
            assert {m["source"] for m in metas} == {"full_page_ocr"}


# -- the Segmenter's array entry points against JAX's PIL ones --------------


@pytest.fixture(scope="module")
def seg_pair():
    jcfg, params, state = random_unet(3)
    jseg = JaxSegmenter(params, state, jcfg, JaxInferConfig(img_size=GRID),
                        dtype=jnp.float32)
    tp, ts = from_jax_params(params, state)
    tseg = Segmenter(tp, ts, UNetConfig(base_width=8), InferConfig(img_size=GRID),
                     dtype=torch.float32, device="cpu")
    return jseg, tseg


def _text_pages(seed, sizes):
    """Bright pages of several sizes with dark 'text' bars (crops not black)."""
    rng = np.random.default_rng(seed)
    out = []
    for w, h in sizes:
        page = np.full((h, w, 3), 235, np.uint8) + rng.integers(0, 20, (h, w, 3), dtype=np.uint8)
        for _ in range(6):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 16)
            page[y:y + rng.integers(3, 8), x:x + rng.integers(8, 16)] = rng.integers(0, 60)
        out.append(page)
    return out


SIZES = [(90, 120), (64, 64), (150, 70), (40, 200), (75, 75)]


def _assert_crops(jcrops, tcrops):
    assert set(jcrops) == set(tcrops) == set(FIELDS)
    for f in FIELDS:
        assert (jcrops[f] is None) == (tcrops[f] is None), f
        if jcrops[f] is not None:
            np.testing.assert_array_equal(np.asarray(tcrops[f]), np.asarray(jcrops[f]))


@pytest.mark.parametrize("gray_h2d,return_masks,chunks", [
    (False, True, 1), (True, False, 1), (True, False, 2), (False, False, 2), (False, True, 2)])
def test_segment_array_batch_equals_jax(seg_pair, gray_h2d, return_masks, chunks):
    """The OpenCV-branch prep in numpy; chunked or not (with masks the batch
    is never split, as in JAX), every crop and mask equal."""
    jseg, tseg = seg_pair
    pages = _text_pages(30, SIZES)
    kw = dict(gray_h2d=gray_h2d, return_masks=return_masks, h2d_chunks=chunks)
    jout = jseg.segment_pil_batch([Image.fromarray(p) for p in pages], **kw)
    tout = tseg.segment_array_batch(pages, **kw)
    n_ok = 0
    for (jm, jc), (tm, tc) in zip(jout, tout):
        assert (tm is None) == (not return_masks)
        if return_masks:
            for f in FIELDS:
                np.testing.assert_array_equal(tm[f], np.asarray(jm[f]))
        _assert_crops(jc, tc)
        n_ok += sum(c is not None for c in tc.values())
    assert 0 < n_ok < 3 * len(pages)  # both outcomes
    pil = tseg.segment_pil_batch([Image.fromarray(p) for p in pages], **kw)
    for (_, jc), (_, pc) in zip(jout, pil):
        _assert_crops(jc, pc)


def test_chunked_upload_is_one_call(seg_pair, monkeypatch):
    """h2d_chunks splits as np.linspace does, runs every chunk's prep, upload
    and dispatch before any fetch, and returns one call's results."""
    _, tseg = seg_pair
    pages = _text_pages(31, SIZES)
    one = tseg.segment_array_batch(pages, return_masks=False, gray_h2d=True)
    order = []
    run = tseg._run

    def spy(x, sizes, return_masks=True):
        order.append(("dispatch", x.shape[0]))
        return run(x, sizes, return_masks=return_masks)

    monkeypatch.setattr(tseg, "_run", spy)
    spans = []
    real_span = ttracing.trace_span

    def span(stage, timer=None):
        spans.append(stage)
        return real_span(stage, timer)

    monkeypatch.setattr(ttracing, "trace_span", span)
    chunked = tseg.segment_array_batch(pages, return_masks=False, gray_h2d=True, h2d_chunks=2)
    assert order == [("dispatch", 2), ("dispatch", 3)]
    assert spans == ["segment.prep", "segment.h2d", "segment.dispatch"] * 2 + ["segment.fetch"]
    for (_, a), (_, b) in zip(one, chunked):
        _assert_crops(a, b)


def test_segment_array_equals_jax(seg_pair):
    """Pillow's bicubic resize in numpy: masks and crops equal."""
    jseg, tseg = seg_pair
    for page in _text_pages(40, SIZES[:3]):
        jm, jc = jseg.segment_pil(Image.fromarray(page))
        tm, tc = tseg.segment_array(page)
        for f in FIELDS:
            np.testing.assert_array_equal(tm[f], np.asarray(jm[f]))
        _assert_crops(jc, tc)
