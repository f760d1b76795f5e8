"""PyTorch port: the numpy replacements of the OpenCV and Pillow calls on the
host paths (``ops/host_image.py``) against ``cv2`` and Pillow themselves.

Tolerance: none. Each replacement is bit-equal to its call on every case here
(gray, Otsu, linear and nearest resize, 2×2 erode, 3×3 Gaussian blur,
connected components with their stats and their order; INTER_AREA on its
three code paths, Pillow's luma and its default bicubic resize), including
1×N, N×1, empty and all-equal images, on 1 and 3 channels where the call
takes both.
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from twinvoice_tpu_torch.ops import host_image as hi


def _images(seed, shapes, kind="random"):
    rng = np.random.default_rng(seed)
    for h, w in shapes:
        if kind == "random":
            yield rng.integers(0, 256, (h, w), dtype=np.uint8)
        elif kind == "bimodal":
            lo, hi_ = int(rng.integers(0, 90)), int(rng.integers(150, 256))
            yield rng.choice([lo, hi_], (h, w)).astype(np.uint8)
        elif kind == "normal":
            yield np.clip(rng.normal(128, 40, (h, w)), 0, 255).astype(np.uint8)
        elif kind == "flat":
            yield np.full((h, w), int(rng.integers(0, 256)), np.uint8)


EDGE_SHAPES = [(1, 1), (1, 7), (1, 256), (7, 1), (300, 1), (2, 2), (3, 5)]
SHAPES = [(h, w) for h, w in np.random.default_rng(9).integers(1, 90, (40, 2))]


def test_rgb_to_gray_every_rgb_triple():
    """All 2^24 RGB triples, one red level a block."""
    levels = np.arange(256, dtype=np.uint8)
    for r in range(256):
        rgb = np.empty((256, 256, 3), np.uint8)
        rgb[..., 0] = r
        rgb[..., 1] = levels[:, None]
        rgb[..., 2] = levels[None, :]
        np.testing.assert_array_equal(hi.rgb_to_gray(rgb),
                                      cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("shape", EDGE_SHAPES + [(0, 5), (33, 64)])
def test_rgb_to_gray_shapes(shape):
    rgb = np.random.default_rng(1).integers(0, 256, shape + (3,), dtype=np.uint8)
    want = (np.zeros(shape, np.uint8) if 0 in shape
            else cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(hi.rgb_to_gray(rgb), want)


@pytest.mark.parametrize("kind", ["random", "bimodal", "normal", "flat"])
def test_otsu_threshold(kind):
    for img in _images(2, SHAPES + EDGE_SHAPES, kind):
        thr, binary = hi.otsu_threshold(img)
        want_thr, want = cv2.threshold(img, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        assert thr == want_thr, (img.shape, thr, want_thr)
        np.testing.assert_array_equal(binary, want)


def test_empty_images():
    """Otsu gives OpenCV's threshold 0 on an empty image; resize, erode and
    blur raise, as OpenCV does. (OpenCV's connected components crash on an
    empty image, so there is nothing to compare them with.)"""
    empty = np.zeros((0, 5), np.uint8)
    thr, binary = hi.otsu_threshold(empty)
    assert thr == cv2.threshold(empty, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)[0]
    assert binary.shape == empty.shape
    for port, ref in ((lambda a: hi.resize_linear_u8(a, 3, 3), lambda a: cv2.resize(a, (3, 3))),
                      (hi.erode2x2, lambda a: cv2.erode(a, np.ones((2, 2), np.uint8))),
                      (hi.gaussian_blur3, lambda a: cv2.GaussianBlur(a, (3, 3), 0.8))):
        with pytest.raises(cv2.error):
            ref(empty)
        with pytest.raises(ValueError, match="empty image"):
            port(empty)


def test_otsu_threshold_rendered_lines():
    from twinvoice_tpu.ocr.jaxocr.data import render_line

    rng = np.random.default_rng(3)
    for text in ("AB-12345678", "2025/09/09", "NT$1,250", "TOTAL 4580"):
        img = render_line(text, rng)
        assert hi.otsu_threshold(img)[0] == cv2.threshold(
            img, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)[0]


def _check_resize(img, width, height):
    got = hi.resize_linear_u8(img, width, height)
    want = cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(got, want, err_msg=f"{img.shape} -> {(height, width)}")


@pytest.mark.parametrize("h", [29, 30, 33, 45, 64, 100, 333])
def test_resize_height_downscale_to_the_row(h):
    """Crops taller than the 28-px row, at prepare_crop's width rule."""
    rng = np.random.default_rng(h)
    for w in (1, 2, 3, 17, 64, 255, 600):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        _check_resize(img, max(1, min(256, int(w * 28 / h))), 28)


@pytest.mark.parametrize("h", [1, 2, 3, 5, 9, 14, 20, 27])
def test_resize_height_upscale_to_the_row(h):
    """Crops shorter than the row (the vertical taps start before row 0)."""
    rng = np.random.default_rng(100 + h)
    for w in (1, 2, 5, 31, 90, 256):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        _check_resize(img, max(1, min(256, int(w * 28 / h))), 28)


def test_resize_every_output_width():
    """Output widths 1-256, from odd and even sources, down and up."""
    rng = np.random.default_rng(4)
    for src_w in (37, 120):
        img = rng.integers(0, 256, (45, src_w), dtype=np.uint8)
        for width in range(1, 257):
            for height in (28, 60):
                _check_resize(img, width, height)


@pytest.mark.parametrize("w", [1, 2, 3, 7, 8, 15, 16, 17, 33, 255, 400])
def test_resize_width_stretch(w):
    """The amount variant's x-stretch (height unchanged) and odd widths."""
    rng = np.random.default_rng(200 + w)
    for h in (1, 4, 28, 57):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        _check_resize(img, max(2, int(w * 1.12)), h)
        _check_resize(img, w, h)


def test_resize_flat_and_single_pixel():
    for img in _images(5, EDGE_SHAPES + [(40, 60)], "flat"):
        _check_resize(img, 256, 28)
        _check_resize(img, 1, 1)


def test_resize_nearest_is_the_x4_map_upsample():
    rng = np.random.default_rng(6)
    for h, w in ((1, 1), (10, 7), (160, 112)):
        x = rng.normal(0, 3, (h, w)).astype(np.float32)
        np.testing.assert_array_equal(
            hi.resize_nearest(x, 4),
            cv2.resize(x, (4 * w, 4 * h), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("kind", ["random", "bimodal", "flat"])
def test_erode2x2(kind):
    for img in _images(7, SHAPES + EDGE_SHAPES, kind):
        np.testing.assert_array_equal(hi.erode2x2(img),
                                      cv2.erode(img, np.ones((2, 2), np.uint8)))


@pytest.mark.parametrize("kind", ["random", "bimodal", "normal", "flat"])
def test_gaussian_blur3(kind):
    for img in _images(8, SHAPES + EDGE_SHAPES, kind):
        np.testing.assert_array_equal(hi.gaussian_blur3(img),
                                      cv2.GaussianBlur(img, (3, 3), 0.8))


def test_gaussian_blur3_prepared_rows():
    from twinvoice_tpu.ocr.jaxocr.data import render_line

    rng = np.random.default_rng(10)
    for text in ("AB12345678", "2024-12-31", "12,999"):
        img = render_line(text, rng, dot=True)
        np.testing.assert_array_equal(hi.gaussian_blur3(img),
                                      cv2.GaussianBlur(img, (3, 3), 0.8))


def _check_components(binary):
    n, labels, stats, _ = cv2.connectedComponentsWithStats(binary, connectivity=8)
    got_n, got_labels, got_stats = hi.connected_components_stats(binary)
    assert got_n == n
    np.testing.assert_array_equal(got_stats, stats)
    np.testing.assert_array_equal(got_labels, labels)  # same components, same order


@pytest.mark.parametrize("p", [0.05, 0.2, 0.45, 0.7])
def test_connected_components_random_maps(p):
    rng = np.random.default_rng(int(p * 100))
    for h, w in SHAPES + EDGE_SHAPES:
        _check_components((rng.random((h, w)) < p).astype(np.uint8))


@pytest.mark.parametrize("shape", [(640, 440), (448, 640), (1000, 800), (64, 1024)])
def test_connected_components_dilated_page_maps(shape):
    """Detector-like maps (specks dilated 3×13) at page sizes, as 0/1 and 0/255."""
    rng = np.random.default_rng(shape[0])
    for p in (0.002, 0.02, 0.1):
        m = cv2.dilate((rng.random(shape) < p).astype(np.uint8), np.ones((3, 13), np.uint8))
        _check_components(m)
        _check_components(m * 255)


@pytest.mark.parametrize("fill", [0, 1])
def test_connected_components_uniform_maps(fill):
    for shape in EDGE_SHAPES + [(50, 40)]:
        _check_components(np.full(shape, fill, np.uint8))


def test_resize_linear_three_channels():
    """The QR scan's last resort, ``cv2.resize(rgb, None, fx=2, fy=2)``, and
    sized calls on RGB."""
    rng = np.random.default_rng(11)
    for h, w in EDGE_SHAPES + [(640, 440), (33, 64)]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            hi.resize_linear_u8(img, fx=2, fy=2),
            cv2.resize(img, None, fx=2, fy=2, interpolation=cv2.INTER_LINEAR))
        for width, height in ((2 * w + 1, 3 * h), (max(1, w // 3), h + 5)):
            np.testing.assert_array_equal(
                hi.resize_linear_u8(img, width, height),
                cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR))


def _check_area(img, *, dsize=None, f=None):
    if dsize is not None:
        got = hi.resize_area_u8(img, *dsize)
        want = cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)
    else:
        got = hi.resize_area_u8(img, fx=f[0], fy=f[1])
        want = cv2.resize(img, None, fx=f[0], fy=f[1], interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape, (img.shape, dsize, f)
    np.testing.assert_array_equal(got, want, err_msg=f"{img.shape} {dsize} {f}")


AREA_SHAPES = [(640, 440), (480, 330), (101, 203), (64, 48), (31, 17), (7, 5),
               (2, 2), (1, 9), (9, 1)]


@pytest.mark.parametrize("channels", [0, 3])
def test_resize_area_integer_shrink(channels):
    """OpenCV's fast path: whole blocks (2×2 by a rounding shift, others by
    a float32 mean), and the partial cells where the output reaches past the
    last whole block (odd sizes at fx 0.5)."""
    rng = np.random.default_rng(12 + channels)
    for h, w in AREA_SHAPES:
        img = rng.integers(0, 256, (h, w) + ((channels,) if channels else ()), dtype=np.uint8)
        for f in ((0.5, 0.5), (0.25, 0.25), (1 / 3, 1 / 3), (0.5, 1.0), (1.0, 0.25)):
            if round(w * f[0]) and round(h * f[1]):
                _check_area(img, f=f)
        for kx, ky in ((2, 2), (3, 3), (2, 3), (4, 1)):
            if w >= kx and h >= ky:
                _check_area(img, dsize=(w // kx, h // ky))


@pytest.mark.parametrize("channels", [0, 3])
def test_resize_area_general_shrink(channels):
    """``resizeArea_``: non-integer shrinks on both axes, the QR pass's 0.75×
    among them."""
    rng = np.random.default_rng(14 + channels)
    for h, w in AREA_SHAPES:
        img = rng.integers(0, 256, (h, w) + ((channels,) if channels else ()), dtype=np.uint8)
        for f in ((0.75, 0.75), (0.6, 0.9), (0.3, 0.45)):
            if round(w * f[0]) and round(h * f[1]):
                _check_area(img, f=f)
        for width, height in ((max(1, 2 * w // 3), max(1, 4 * h // 5)), (max(1, w - 1), max(1, h - 2))):
            if (width, height) != (w, h):
                _check_area(img, dsize=(width, height))


@pytest.mark.parametrize("channels", [0, 3])
def test_resize_area_mixed_and_upscale(channels):
    """A scale below 1 on either axis: the linear machinery on INTER_AREA's
    taps (the segmenter's 440×640 → 512² grows x and shrinks y)."""
    rng = np.random.default_rng(16 + channels)
    for h, w in AREA_SHAPES:
        img = rng.integers(0, 256, (h, w) + ((channels,) if channels else ()), dtype=np.uint8)
        for dsize in ((512, 512), (64, 64), (2 * w + 3, max(1, h // 2)), (w + 1, h + 1), (37, 23)):
            _check_area(img, dsize=dsize)
        _check_area(img, f=(1.5, 0.8))


def test_resize_area_flat():
    for img in _images(18, EDGE_SHAPES + [(40, 60)], "flat"):
        _check_area(img, dsize=(512, 512))
        _check_area(img, f=(0.75, 0.75))
        if img.shape[0] >= 2 and img.shape[1] >= 2:
            _check_area(img, f=(0.5, 0.5))


def test_pil_luma_random_rgb():
    rng = np.random.default_rng(19)
    rgb = rng.integers(0, 256, (512, 768, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    np.testing.assert_array_equal(hi.pil_luma(rgb), want)
    assert (hi.rgb_to_gray(rgb) != want).any()  # the two lumas are not one


@pytest.mark.parametrize("shape", [(640, 440), (512, 512), (1000, 800), (31, 17),
                                   (5, 3), (1, 1), (300, 700)])
def test_resize_pil_bicubic(shape):
    """Pillow's default resize of an RGB image (bicubic), shrinking,
    growing and keeping each axis."""
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    h, w = shape
    for size in ((512, 512), (64, 64), (2 * w, h), (w, max(1, h // 2)), (17, 900)):
        np.testing.assert_array_equal(hi.resize_pil_bicubic(img, *size),
                                      np.asarray(Image.fromarray(img).resize(size)),
                                      err_msg=f"{shape} -> {size}")
