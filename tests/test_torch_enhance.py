"""PyTorch port: the crop enhancement of the network OCR engines without
OpenCV (``ocr/enhance.py`` on ``ops/host_image.py``'s ``filter2d_3x3_u8``,
``clahe_u8``, ``rgb_to_ycrcb_u8``, ``ycrcb_to_rgb_u8``, with the existing
gray, INTER_CUBIC and Otsu) against ``cv2`` and the JAX package's
``twinvoice_tpu/ocr/enhance.py``.

Tolerance: none, with OpenCV's Intel IPP paths off (``cv2.ipp.setUseIPP(False)``),
where OpenCV runs its own code; the port is that code. With IPP on, as the
JAX package runs by default, IPP's INTER_CUBIC rounds some exact .5 ties the
other way: those bytes are counted, not required to be zero.
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from twinvoice_tpu.ocr import enhance as jenhance
from twinvoice_tpu_torch.ocr import enhance as tenhance
from twinvoice_tpu_torch.ops import host_image as hi

SHARPEN = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], np.float32)
# 1×1, thin, odd, sizes the 8×8 grid does not divide on one or both axes,
# and sizes it divides
SHAPES = [(1, 1), (1, 9), (9, 1), (2, 3), (7, 7), (8, 8), (16, 24), (17, 40), (40, 17),
          (33, 65), (64, 64), (71, 203), (120, 600)]
KINDS = ("random", "flat", "saturated", "sparse", "normal")


@pytest.fixture
def ipp_off():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _gray(rng, shape, kind):
    h, w = shape
    if kind == "random":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "flat":
        return np.full((h, w), int(rng.integers(0, 256)), np.uint8)
    if kind == "saturated":  # CLAHE's clip on two spikes
        return rng.choice(np.array([0, 255], np.uint8), (h, w))
    if kind == "sparse":
        return ((rng.random((h, w)) < 0.05) * 255).astype(np.uint8)
    return np.clip(rng.normal(170, 25, (h, w)), 0, 255).astype(np.uint8)


def _crop(rng, h, w):
    """An RGB field crop: light paper, dark strokes, colour noise."""
    crop = rng.integers(170, 256, (h, w, 3), dtype=np.uint8)
    for _ in range(max(1, w // 12)):
        x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
        crop[y:y + max(1, h // 2), x:x + 2] = rng.integers(0, 90, 3, dtype=np.uint8)
    return crop


@pytest.mark.parametrize("kind", KINDS)
def test_filter2d_sharpen_equals_cv2(kind, ipp_off):
    rng = np.random.default_rng(len(kind))
    for shape in SHAPES:
        g = _gray(rng, shape, kind)
        assert np.array_equal(hi.filter2d_3x3_u8(g, SHARPEN), cv2.filter2D(g, -1, SHARPEN)), shape
    k = np.array([[0, 1, 0], [2, -3, 2], [0, 1, 0]], np.float32)  # another whole kernel
    g = _gray(rng, (19, 23), kind)
    assert np.array_equal(hi.filter2d_3x3_u8(g, k), cv2.filter2D(g, -1, k))


def test_filter2d_refuses_fractional_kernels():
    with pytest.raises(ValueError):
        hi.filter2d_3x3_u8(np.zeros((4, 4), np.uint8), np.full((3, 3), 1 / 9))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("clip,tiles", [(4.0, (8, 8)), (2.0, (8, 8)), (0.5, (3, 5)),
                                        (40.0, (8, 8)), (1.0, (1, 1))])
def test_clahe_equals_cv2(kind, clip, tiles, ipp_off):
    rng = np.random.default_rng(int(clip * 10) + len(kind))
    for shape in SHAPES:
        g = _gray(rng, shape, kind)
        want = cv2.createCLAHE(clipLimit=clip, tileGridSize=tiles).apply(g)
        assert np.array_equal(hi.clahe_u8(g, clip, tiles), want), shape


def _rgb_block(red):
    """Every (G, B) pair at 16 red levels from ``red``: 2^20 pixels."""
    gb = np.arange(1 << 16, dtype=np.uint32)
    r = np.repeat(np.arange(red, red + 16, dtype=np.uint32), 1 << 16)
    g, b = np.tile(gb >> 8, 16), np.tile(gb & 255, 16)
    return np.stack([r, g, b], -1).astype(np.uint8).reshape(1024, 1024, 3)


@pytest.mark.parametrize("red", range(0, 256, 16))
def test_ycrcb_every_triple_both_ways(red, ipp_off):
    px = _rgb_block(red)
    assert np.array_equal(hi.rgb_to_ycrcb_u8(px), cv2.cvtColor(px, cv2.COLOR_RGB2YCrCb))
    assert np.array_equal(hi.ycrcb_to_rgb_u8(px), cv2.cvtColor(px, cv2.COLOR_YCrCb2RGB))


@pytest.mark.parametrize("ipp", [False, True])
def test_otsu_equals_cv2_threshold_otsu(ipp):
    """``cv2.threshold(g, 0, 255, cv2.THRESH_OTSU)`` (the enhancement's call:
    THRESH_BINARY | THRESH_OTSU) with IPP off and on."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        rng = np.random.default_rng(3)
        for kind in KINDS:
            for shape in SHAPES:
                g = _gray(rng, shape, kind)
                t, b = cv2.threshold(g, 0, 255, cv2.THRESH_OTSU)
                got_t, got_b = hi.otsu_threshold(g)
                assert got_t == t and np.array_equal(got_b, b), (kind, shape)
    finally:
        cv2.ipp.setUseIPP(was)


CROP_SHAPES = [(1, 1), (3, 17), (20, 60), (27, 151), (41, 233), (64, 64)]


@pytest.mark.parametrize("fn,kw", [("enhance_for_ocr", {"mode": "text"}),
                                   ("enhance_for_ocr", {"mode": "amount"}),
                                   ("enhance_for_ocr", {"mode": "invoice", "upscale": 2}),
                                   ("grayscale_for_ocr", {}), ("enhance_camera", {})])
def test_enhancement_equals_jax(fn, kw, ipp_off):
    """On PIL images (``convert("RGB")`` of an RGBA one too), on arrays and on
    ``PilPixels`` (what the extractor hands an engine)."""
    rng = np.random.default_rng(11)
    for h, w in CROP_SHAPES:
        crop = _crop(rng, h, w)
        rgba = np.dstack([crop, rng.integers(0, 256, (h, w), dtype=np.uint8)])
        want = getattr(jenhance, fn)(Image.fromarray(crop), **kw)
        for src in (Image.fromarray(crop), crop, hi.PilPixels(crop)):
            got = getattr(tenhance, fn)(src, **kw)
            assert got.dtype == np.uint8 and np.array_equal(got, want), (fn, h, w, type(src))
        assert np.array_equal(getattr(tenhance, fn)(Image.fromarray(rgba), **kw),
                              getattr(jenhance, fn)(Image.fromarray(rgba), **kw))


def test_gray_input_is_refused_as_cv2_refuses_it(ipp_off):
    gray = np.full((5, 7), 128, np.uint8)
    for fn in ("enhance_for_ocr", "grayscale_for_ocr", "enhance_camera"):
        with pytest.raises(cv2.error):
            getattr(jenhance, fn)(gray)
        with pytest.raises(ValueError):
            getattr(tenhance, fn)(gray)
    rgba = np.full((5, 7, 4), 90, np.uint8)  # cv2's RGB2GRAY takes 4 channels
    assert np.array_equal(tenhance.grayscale_for_ocr(rgba), jenhance.grayscale_for_ocr(rgba))


def test_ipp_on_bytes_counted():
    """With IPP on, as the JAX package runs by default, the bytes of JAX's
    enhancement that differ from the port's are counted (IPP's INTER_CUBIC
    ties; the sharpen, CLAHE, Otsu and the colour conversions agree)."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(True)
    try:
        rng = np.random.default_rng(5)
        differ = {"text": 0, "amount": 0}
        total = 0
        for _ in range(8):
            crop = _crop(rng, int(rng.integers(20, 48)), int(rng.integers(80, 240)))
            for mode in differ:
                a = jenhance.enhance_for_ocr(crop, mode=mode)
                b = tenhance.enhance_for_ocr(crop, mode=mode)
                assert a.shape == b.shape
                differ[mode] += int((a != b).sum())
                total += a.size
        assert np.array_equal(jenhance.enhance_camera(crop), tenhance.enhance_camera(crop))
        print(f"IPP on: bytes differing from the port's {differ} of {total} per mode")
    finally:
        cv2.ipp.setUseIPP(was)
