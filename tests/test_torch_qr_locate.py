"""PyTorch port: the QR locator (``twinvoice_tpu_torch/qr/locate.py``), the
host steps of the enhanced retry (``ops/host_image.py``: ``equalize_hist_u8``,
``resize_cubic_u8``, ``gray_to_rgb``) and the scan and auto-rotate that run
on them, against OpenCV and the JAX package.

Tolerances: none. The host steps are byte-equal to OpenCV's own code
(``resize_cubic_u8`` and ``enhance_qr_region`` with Intel IPP off: with it on,
OpenCV routes INTER_CUBIC to IPP, whose float sums round some exact .5 ties
the other way). The locator is ``cv2.QRCodeDetector``'s localisation, so
its boxes are JAX's (``detect_qr_regions``) on the fixture pages, on a sweep
of 82 pages (scales 0.40–0.80 in steps of 0.01 × two seeds) and on a
1600×1200 frame; with cv2 blocked in the port, every scan's payloads and
every turn are JAX's. OpenCV's locator draws from its per-thread generator,
so each JAX call is preceded by ``cv2.setRNGSeed(0)`` and each port call by
``locate.set_rng_seed(0)``. The quads themselves, the primitives and other
seeds are held in ``tests/test_torch_qr_cv.py``.
"""

import sys

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from twinvoice_tpu.fusion import extract as jextract
from twinvoice_tpu.qr import detect as jdetect
from twinvoice_tpu_torch.fusion import extract as textract
from twinvoice_tpu_torch.ops import host_image as hi
from twinvoice_tpu_torch.qr import detect as tdetect
from twinvoice_tpu_torch.qr import locate


@pytest.fixture
def no_ipp():
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(True)


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.qr_fixture()


SWEEP_SEEDS = (0, 5)
SWEEP_SCALES = tuple(round(0.40 + 0.01 * i, 2) for i in range(41))


def jax_seeded(fn, *args):
    """A JAX call that runs cv2's locator, from a generator seeded with 0."""
    cv2.setRNGSeed(0)
    return fn(*args)


def port_seeded(fn, *args):
    """The port's counterpart, from its locator's generator seeded with 0."""
    locate.set_rng_seed(0)
    return fn(*args)


@pytest.fixture(scope="module")
def sweep():
    """INTER_AREA downscales of the rendered pages of ``SWEEP_SEEDS``
    (``render_invoice(seed, layout_jitter=0.5)``, 640×440) at
    ``SWEEP_SCALES``: {(seed, scale): (page, cv2's boxes, JAX's
    native-decoder scan)}, and the true payloads."""
    from twinvoice_tpu.data.synthetic import header_qr_payload, items_qr_payload
    from twinvoice_tpu.data.synthetic import render_invoice

    scan = jdetect.QrPipeline(decoders=[jdetect.native_decode]).scan
    out = {}
    for seed in SWEEP_SEEDS:
        img, _ = render_invoice(seed=seed, layout_jitter=0.5)
        full = np.asarray(img.convert("RGB"))
        for sc in SWEEP_SCALES:
            page = cv2.resize(full, None, fx=sc, fy=sc, interpolation=cv2.INTER_AREA)
            out[seed, sc] = (page, jax_seeded(jdetect.detect_qr_regions, page),
                             jax_seeded(scan, page))
    truth = {header_qr_payload("AB12345678", "2025-09-09", 120),
             items_qr_payload([{"name": "синt", "qty": 1, "price": 120}])}
    return out, truth


def _images(seed, n=60):
    """uint8 images at odd sizes: noise, binary blocks (as a QR crop), narrow
    ranges, constants, and gray, RGB and 2-channel ones."""
    rng = np.random.default_rng(seed)
    for t in range(n):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        extra = [(), (3,), (2,)][t % 3]
        lo, hi_ = sorted(int(v) for v in rng.integers(0, 256, 2))
        img = rng.integers(lo, hi_ + 1, (h, w) + extra, dtype=np.uint8)
        if t % 5 == 0:
            img = np.where(rng.random((h, w) + extra) < 0.5, 0, 255).astype(np.uint8)
        if t % 11 == 0:
            img[:] = lo
        yield t, img


def test_equalize_hist_equals_cv2():
    for _, img in _images(0, 120):
        gray = img if img.ndim == 2 else np.ascontiguousarray(img[..., 0])
        np.testing.assert_array_equal(hi.equalize_hist_u8(gray), cv2.equalizeHist(gray))


def test_resize_cubic_equals_cv2(no_ipp):
    """fx = fy = 3 (the retry's), other up- and downscales, sizes given."""
    for t, img in _images(1):
        f = (3, 2, 1.7, 0.6, 4)[t % 5]
        want = cv2.resize(img, None, fx=f, fy=f, interpolation=cv2.INTER_CUBIC)
        np.testing.assert_array_equal(hi.resize_cubic_u8(img, fx=f, fy=f), want)
        size = (int(img.shape[1] * 1.5) + 1, int(img.shape[0] * 2.3) + 1)
        want = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)
        np.testing.assert_array_equal(hi.resize_cubic_u8(img, *size), want)


def test_gray_to_rgb_equals_cv2():
    gray = np.random.default_rng(2).integers(0, 256, (13, 7), dtype=np.uint8)
    np.testing.assert_array_equal(hi.gray_to_rgb(gray), cv2.cvtColor(gray, cv2.COLOR_GRAY2RGB))


def test_enhance_equals_jax_on_region_crops(fix, no_ipp):
    """JAX's ``enhance_qr_region`` (cv2) on every cv2 box of the fixture
    pages and the fixture's stored crops."""
    n = 0
    for page, boxes in zip(fix["pages"], fix["cv2_boxes"]):
        for x1, y1, x2, y2 in boxes:
            crop = page[y1:y2, x1:x2]
            np.testing.assert_array_equal(tdetect.enhance_qr_region(crop),
                                          jdetect.enhance_qr_region(crop))
            n += 1
    assert n >= 8
    assert chip_smoke.qr_enhance_check(fix) == 3


def test_locator_boxes_against_cv2(fix, sweep):
    """JAX's boxes (cv2's ``detectMulti``, then ``detect``), recomputed and as
    stored, are the port's on every fixture page and every sweep page."""
    for name, page, stored in zip(fix["names"], fix["pages"], fix["cv2_boxes"]):
        assert [list(b) for b in jax_seeded(jdetect.detect_qr_regions, page)] == stored, name
        assert [list(b) for b in port_seeded(tdetect.detect_qr_regions, page)] == stored, name
    for key, (page, cv2_boxes, _) in sweep[0].items():
        assert port_seeded(tdetect.detect_qr_regions, page) == [tuple(b) for b in cv2_boxes], key


def test_locator_downscales_large_frames_as_jax():
    """A 1600×1200 photo-like frame: the port calls its locator on the same
    grays as JAX calls cv2's (the INTER_AREA downscale to 800 px, then the
    full frame where that gives fewer than 2 boxes), and scales the boxes
    back as JAX does."""
    page = np.asarray(Image.fromarray(chip_smoke.qr_fixture()["portrait_0"]).resize((704, 1024)))
    frame = np.full((1200, 1600, 3), 120, np.uint8)
    frame[100:1124, 300:1004] = page
    jax_calls, port_calls = [], []
    jax_real, port_real = jdetect._detect_gray, tdetect.locate_qr_boxes
    jdetect._detect_gray = lambda gray, cv: jax_calls.append(gray.shape) or jax_real(gray, cv)
    tdetect.locate_qr_boxes = lambda gray: port_calls.append(gray.shape) or port_real(gray)
    try:
        want = jax_seeded(jdetect.detect_qr_regions, frame)
        boxes = port_seeded(tdetect.detect_qr_regions, frame)
    finally:
        jdetect._detect_gray, tdetect.locate_qr_boxes = jax_real, port_real
    assert port_calls == jax_calls and jax_calls[0] == (600, 800)
    assert boxes == [tuple(b) for b in want]


def test_scans_equal_jax_without_cv2(fix, monkeypatch):
    """The native-decoder scan on every fixture page with cv2 blocked in the
    port: payload sets equal to JAX's (stored and recomputed), the 0.45×
    pages through cv2's one box and its enhanced retry to JAX's one
    payload. With cv2 present, the default decoders' scan equals JAX's."""
    native = jdetect.QrPipeline(decoders=[jdetect.native_decode])
    assert [jax_seeded(native.scan, p) for p in fix["pages"]] == fix["jax_native"]
    default = tdetect.QrPipeline()
    for page, jax_default in zip(fix["pages"], fix["jax_default"]):
        assert sorted(port_seeded(default.scan, page)) == sorted(jax_default)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = chip_smoke.qr_scan_check(fix)
    for name in fix["names"]:
        if "x0.45" in name:
            assert got[name][1]["regions"] == 1 and got[name][1]["region_crop"] == 1
            assert got[name][1]["enhanced"] == 1


def test_turns_equal_jax_without_cv2(fix, monkeypatch):
    """Every landscape page, cv2 blocked in the port: the numpy locator's
    turn is JAX's (PIL pages, cv2's locator), recomputed and as stored."""
    want = {}
    for name, page in zip(fix["names"], fix["pages"]):
        if page.shape[1] > page.shape[0]:
            want[name] = np.asarray(jax_seeded(jextract.auto_rotate_by_qr, Image.fromarray(page)))
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert sorted(chip_smoke.qr_turn_check(fix)) == sorted(want)
    for name, page in zip(fix["names"], fix["pages"]):
        if name in want:
            np.testing.assert_array_equal(port_seeded(textract.auto_rotate_by_qr, page), want[name])


def test_scan_sweep_against_jax(sweep, monkeypatch):
    """82 pages, cv2 blocked in the port: on every page the port's payloads
    are JAX's, and within the truth."""
    pages, truth = sweep
    monkeypatch.setitem(sys.modules, "cv2", None)
    pipe = tdetect.QrPipeline(decoders=[tdetect.native_decode])
    for key, (page, _, want) in pages.items():
        got = port_seeded(pipe.scan, page)
        assert set(got) == set(want) and set(got) <= truth, (key, want, got)


def test_enhanced_retries_decode_as_jax_with_ipp_on(sweep):
    """Every region crop of the sweep (cv2's boxes, which are the port's):
    the port's ``enhance_qr_region`` (OpenCV's own INTER_CUBIC) and JAX's as
    it runs by default, through Intel IPP, decode to the same payloads,
    though their bytes differ."""
    assert cv2.ipp.useIPP()
    n = decoded = 0
    for page, cv2_boxes, _ in sweep[0].values():
        for x1, y1, x2, y2 in set(map(tuple, cv2_boxes)):
            crop = page[y1:y2, x1:x2]
            want = jdetect.native_decode(jdetect.enhance_qr_region(crop))
            assert tdetect.native_decode(tdetect.enhance_qr_region(crop)) == want
            n, decoded = n + 1, decoded + bool(want)
    assert (n, decoded) == (52, 48)
