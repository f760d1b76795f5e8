"""PyTorch port: the QR locator (``twinvoice_tpu_torch/qr/locate.py``), the
host steps of the enhanced retry (``ops/host_image.py``: ``equalize_hist_u8``,
``resize_cubic_u8``, ``gray_to_rgb``) and the scan and auto-rotate that run
on them, against OpenCV and the JAX package.

Tolerances: the host steps are byte-equal to OpenCV's own code
(``resize_cubic_u8`` and ``enhance_qr_region`` with Intel IPP off: with it on,
OpenCV routes INTER_CUBIC to IPP, whose float sums round some exact .5 ties
the other way); every box of ``cv2.QRCodeDetector`` on a fixture page has a
locator box with IoU ≥ 0.7, and the blank page none; the scan's payload set
is JAX's native-decoder scan's on every fixture page but the 0.55× one, with
cv2 blocked in the port; the turn of every landscape page is JAX's.

Where the scans part: the port's locator finds codes that cv2's misses,
and its region pass then reads both payloads where JAX's scan reads one.
The sweep below (scales 0.40–0.80 in steps of 0.01 × two seeds, 82 pages)
measures it: on every page JAX's payloads ⊆ the port's ⊆ the truth, and the
16 pages where the two differ are pinned (``SWEEP_PORT_READS_MORE``), each
one where the port's locator found more codes than cv2's. The fixture's
0.55× page is such a page. It also counts the enhanced retries whose decode
differs from JAX's with IPP on (none).
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
# (seed, scale) of the sweep's pages where the port's scan reads both
# payloads and JAX's one: the port's locator finds both codes there, cv2's
# one or none
SWEEP_PORT_READS_MORE = [(seed, sc) for seed in SWEEP_SEEDS
                         for sc in (0.43, 0.47, 0.51, 0.52, 0.53, 0.55, 0.56, 0.61)]


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
            out[seed, sc] = (page, jdetect.detect_qr_regions(page), scan(page))
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


def test_locator_boxes_against_cv2(fix):
    """Each box cv2 finds, recomputed now and as stored, is matched at IoU ≥
    0.7; the blank page gives none; on the 0.45× page the header's box is
    cv2's exactly (its enhanced retry decides JAX's scan there)."""
    for name, page, stored in zip(fix["names"], fix["pages"], fix["cv2_boxes"]):
        assert [list(b) for b in jdetect.detect_qr_regions(page)] == stored, name
        boxes = tdetect.detect_qr_regions(page)
        for want in stored:
            assert max(chip_smoke.box_iou(want, b) for b in boxes) >= chip_smoke.QR_IOU_MIN
        if name == "blank":
            assert boxes == []
        else:
            assert len(boxes) == 2, (name, boxes)  # both codes, where cv2 finds at most one
        if "x0.45" in name:
            assert tuple(stored[0]) in boxes


def test_locator_downscales_large_frames_as_jax():
    """A 1600×1200 photo-like frame: the locator runs on the INTER_AREA
    downscale to 800 px and scales the boxes back as JAX scales cv2's."""
    page = np.asarray(Image.fromarray(chip_smoke.qr_fixture()["portrait_0"]).resize((704, 1024)))
    frame = np.full((1200, 1600, 3), 120, np.uint8)
    frame[100:1124, 300:1004] = page
    calls = []
    real = locate.locate_qr_boxes
    tdetect.locate_qr_boxes = lambda gray: calls.append(gray.shape) or real(gray)
    try:
        boxes = tdetect.detect_qr_regions(frame)
    finally:
        tdetect.locate_qr_boxes = real
    assert calls == [(600, 800)]
    small = real(hi.resize_area_u8(hi.rgb_to_gray(frame), 800, 600))
    assert boxes == [(int(x1 * 2.0), int(y1 * 2.0), min(int(x2 * 2.0 + 1), 1600),
                      min(int(y2 * 2.0 + 1), 1200)) for x1, y1, x2, y2 in small]
    for want in jdetect.detect_qr_regions(frame):
        assert max(chip_smoke.box_iou(want, b) for b in boxes) >= chip_smoke.QR_IOU_MIN


def test_scans_equal_jax_without_cv2(fix, monkeypatch):
    """The native-decoder scan on every fixture page with cv2 blocked in the
    port: payload sets equal to JAX's (stored and recomputed), the 0.45×
    pages through the region pass and its enhanced retries to JAX's one
    payload. With cv2 present, the default decoders' scan equals JAX's."""
    want = [jdetect.QrPipeline(decoders=[jdetect.native_decode]).scan(p) for p in fix["pages"]]
    assert want == fix["jax_native"]
    default = tdetect.QrPipeline()
    for page, jax_default in zip(fix["pages"], fix["jax_default"]):
        assert sorted(default.scan(page)) == sorted(jax_default)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = chip_smoke.qr_scan_check(fix)
    for name in fix["names"]:
        if "x0.45" in name:
            assert got[name][1]["enhanced"] == 2 and got[name][1]["regions"] == 1


def test_turns_equal_jax_without_cv2(fix, monkeypatch):
    """Every landscape page, cv2 blocked in the port: the numpy locator's
    turn is JAX's (PIL pages, cv2's locator), recomputed and as stored."""
    want = {}
    for name, page in zip(fix["names"], fix["pages"]):
        if page.shape[1] > page.shape[0]:
            want[name] = np.asarray(jextract.auto_rotate_by_qr(Image.fromarray(page)))
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert sorted(chip_smoke.qr_turn_check(fix)) == sorted(want)
    for name, page in zip(fix["names"], fix["pages"]):
        if name in want:
            np.testing.assert_array_equal(textract.auto_rotate_by_qr(page), want[name])


def test_locator_pieces():
    """The finder ratio test, a code's corners and the grouping on a
    rendered code: its three finders at their centres, module 5 px, a vote a
    row through the 3-module core; one code, its box the code's extent."""
    from twinvoice_tpu_torch.qr.encode import render_qr

    img = render_qr("AB12345678" * 3, module_px=5)  # v3: 29 modules, a 20 px border
    assert locate.locate_qr_boxes(img) == [(20, 20, 165, 165)]
    fs = locate.find_finders(locate.binarize(img))
    found = {(f.x, f.y) for f in fs if f.module == 5.0 and f.votes == 15}
    assert {(37.5, 37.5), (147.5, 37.5), (37.5, 147.5)} <= found
    ok = locate._ratio_ok(np.array([[5, 5, 15, 5, 5], [5, 5, 2, 5, 5], [4, 1, 3, 1, 1]]))
    assert ok.tolist() == [True, False, False]
    assert locate.locate_qr_boxes(np.full((10, 10), 255, np.uint8)) == []


@pytest.mark.parametrize("scale", [0.6, 0.7])
def test_two_codes_side_by_side_stay_apart(fix, scale):
    """At 0.6× three finders of the two codes pass the geometry prefilter
    with more votes than either code's own; the timing-pattern read rejects
    them, so each box holds one code (a mixed one spans both)."""
    page = hi.resize_area_u8(fix["portrait_0"], fx=scale, fy=scale)
    boxes = tdetect.detect_qr_regions(page)
    assert len(boxes) == 2
    assert all(x2 - x1 < page.shape[1] / 3 for x1, _, x2, _ in boxes), boxes


def test_scan_sweep_against_jax(sweep, monkeypatch):
    """82 pages, cv2 blocked in the port: on every page JAX's payloads ⊆ the
    port's ⊆ the truth; they are equal but on ``SWEEP_PORT_READS_MORE``,
    each a page where the port's locator finds more codes than cv2's (the
    open gap)."""
    pages, truth = sweep
    monkeypatch.setitem(sys.modules, "cv2", None)
    pipe = tdetect.QrPipeline(decoders=[tdetect.native_decode])
    more = []
    for key, (page, cv2_boxes, want) in pages.items():
        got = set(pipe.scan(page))
        assert set(want) <= got <= truth, (key, want, got)
        if got != set(want):
            assert len(tdetect.detect_qr_regions(page)) > len(cv2_boxes), key
            more.append(key)
    assert more == SWEEP_PORT_READS_MORE


def test_enhanced_retries_decode_as_jax_with_ipp_on(sweep):
    """Every region crop of the sweep (the port's boxes and cv2's): the
    port's ``enhance_qr_region`` (OpenCV's own INTER_CUBIC) and JAX's as it
    runs by default, through Intel IPP, decode to the same payloads, though
    their bytes differ."""
    assert cv2.ipp.useIPP()
    n = decoded = 0
    for page, cv2_boxes, _ in sweep[0].values():
        boxes = set(map(tuple, cv2_boxes)) | set(tdetect.detect_qr_regions(page))
        for x1, y1, x2, y2 in boxes:
            crop = page[y1:y2, x1:x2]
            want = jdetect.native_decode(jdetect.enhance_qr_region(crop))
            assert tdetect.native_decode(tdetect.enhance_qr_region(crop)) == want
            n, decoded = n + 1, decoded + bool(want)
    assert n >= 180 and decoded >= 160
