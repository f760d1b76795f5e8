"""PyTorch port: the QR locator (``twinvoice_tpu_torch/qr/locate.py``, built
on ``csrc/host_qrlocate.cpp``) against the installed OpenCV, step by step and
whole.

- The primitives, byte for byte (float32 bit for bit where they are float):
  ``adaptiveThreshold`` and its replicated-border Gaussian, k-means with
  k-means++ seeding after ``cv2.setRNGSeed`` (labels, centres, compactness
  and the generator's state afterwards), the flood fill, the convex hull,
  the contours and the INTER_LINEAR_EXACT resize.
- ``locate_qr_quads`` against ``detectMulti``, then ``detect`` (as the JAX
  scan calls them) on three sets of pages: the fixture's 14, the sweep's 82
  (INTER_AREA downscales 0.40–0.80×) and a held-out set (seeds 1–3 at 0.42,
  0.5, 0.6, 0.7, 0.85 and 1.0×, each 1.0× page turned a quarter, and a
  1600×1200 frame at full size and at 800 px). Before each call both
  generators are seeded with the same value (0, 7, 12345); the flag, the
  count, the order and JAX's int boxes must be cv2's and every corner within
  1e-3 px of cv2's float32.
- Two sequential runs of the sweep, in order and reversed, on one thread from
  the default state with no reseeding, against one cv2 detector.

The generator's state is read back by drawing from ``theRNG()`` through
``cv2.randu`` into int32 values below 2**16: each is the low 16 bits of one
``cv::RNG::next()``.
"""

import threading

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from twinvoice_tpu_torch.ops import host_image as hi
from twinvoice_tpu_torch.qr import locate

SEEDS = (0, 7, 12345)
TERM = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_COUNT, 10, 0.1)
HELD_SEEDS = (1, 2, 3)
HELD_SCALES = (0.42, 0.5, 0.6, 0.7, 0.85, 1.0)


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.qr_fixture()


def grays_of(fix):
    return {name: hi.rgb_to_gray(page) for name, page in zip(fix["names"], fix["pages"])}


@pytest.fixture(scope="module")
def page_sets(fix):
    """{"fixture" | "sweep" | "held_out": {name: uint8 gray page}}."""
    from twinvoice_tpu.data.synthetic import render_invoice

    sweep = {key: hi.rgb_to_gray(page) for key, page in chip_smoke.qr_sweep_pages(fix).items()}
    held = {}
    for seed in HELD_SEEDS:
        img, _ = render_invoice(seed=seed, layout_jitter=0.5)
        full = np.asarray(img.convert("RGB"))
        for sc in HELD_SCALES:
            page = full if sc == 1.0 else cv2.resize(full, None, fx=sc, fy=sc,
                                                     interpolation=cv2.INTER_AREA)
            held[f"s{seed}_x{sc}"] = cv2.cvtColor(page, cv2.COLOR_RGB2GRAY)
        held[f"s{seed}_rot90"] = np.ascontiguousarray(np.rot90(held[f"s{seed}_x1.0"]))
    page = np.asarray(Image.fromarray(fix["portrait_0"]).resize((704, 1024)))
    frame = np.full((1200, 1600, 3), 120, np.uint8)
    frame[100:1124, 300:1004] = page
    held["frame_1600"] = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
    held["frame_800"] = hi.resize_area_u8(held["frame_1600"], 800, 600)
    return {"fixture": grays_of(fix), "sweep": sweep, "held_out": held}


def cv2_quads(det, gray):
    """The JAX scan's locator calls (``twinvoice_tpu/qr/detect.py:_detect_gray``)."""
    ok, pts = det.detectMulti(gray)
    if not ok or pts is None:
        ok, pts = det.detect(gray)
        ok = bool(ok) and pts is not None
    return bool(ok), (np.asarray(pts, np.float32).reshape(-1, 4, 2) if ok else None)


def assert_quads_equal(got, want, where):
    why = chip_smoke.qr_quads_equal(got, [want[0], [] if want[1] is None else want[1].tolist()])
    assert why is None, (where, why)


def rng_draws(n=8):
    """The next ``n`` draws of cv2's generator on this thread, low 16 bits."""
    out = np.zeros(n, np.int32)
    cv2.randu(out, 0, 1 << 16)
    return out.tolist()


# ------------------------------------------------------------------ primitives

def test_gaussian_and_adaptive_threshold_equal_cv2(fix):
    """The fixture's pages, odd widths (the 8-, 4- and 1-lane tails of
    OpenCV's filter loops) and noise: the float32 Gaussian of
    ``adaptiveThreshold`` bit for bit, the threshold byte for byte."""
    rng = np.random.default_rng(0)
    images = list(grays_of(fix).values())[:6]
    images += [rng.integers(0, 256, (40, w), dtype=np.uint8) for w in (6, 12, 13, 198, 203, 205)]
    for g in images:
        want = cv2.GaussianBlur(g.astype(np.float32), (83, 83), 0, borderType=cv2.BORDER_REPLICATE)
        got = locate.gaussian_blur_replicate(g, 83)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        np.testing.assert_array_equal(
            locate.adaptive_threshold(g),
            cv2.adaptiveThreshold(g, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY, 83, 2))


@pytest.mark.parametrize("seed", SEEDS)
def test_kmeans_and_generator_equal_cv2(seed):
    """k-means++ over random float32 points (some on a half-pixel grid, as
    the locator's are), 1–6 clusters, 1–3 attempts: labels, centres and
    compactness cv2's, and the generator's next draws afterwards cv2's."""
    rng = np.random.default_rng(seed)
    for t in range(12):
        n = int(rng.integers(3, 200))
        k = int(rng.integers(1, min(n, 6) + 1))
        attempts = int(rng.integers(1, 4))
        pts = (rng.random((n, 2)) * 300).astype(np.float32)
        if t % 3 == 0:
            pts = np.round(pts * 2) / 2
        cv2.setRNGSeed(seed)
        locate.set_rng_seed(seed)
        c1, l1, ce1 = cv2.kmeans(pts, k, None, TERM, attempts, cv2.KMEANS_PP_CENTERS)
        c2, l2, ce2 = locate.kmeans_pp(pts, k, attempts)
        assert c1 == c2 and np.array_equal(l1.ravel(), l2) and np.array_equal(ce1, ce2), (t, n, k)
        assert rng_draws() == [locate.rng_next() & 0xFFFF for _ in range(8)], t


def test_generator_seeding_equals_cv2():
    """``set_rng_seed`` as ``cv2.setRNGSeed``, 0 as a fresh thread's state."""
    for seed in (0, 1, 7, 12345, 2**31 - 1):
        cv2.setRNGSeed(seed)
        locate.set_rng_seed(seed)
        assert rng_draws(16) == [locate.rng_next() & 0xFFFF for _ in range(16)]
    fresh = []
    t = threading.Thread(target=lambda: fresh.append((rng_draws(4), locate.rng_state())))
    t.start()
    t.join()
    locate.set_rng_seed(0)
    assert fresh[0][1] == locate.rng_state() == 0xFFFFFFFF
    assert fresh[0][0] == [locate.rng_next() & 0xFFFF for _ in range(4)]


def test_flood_fill_hull_and_contours_equal_cv2(fix):
    """The mask-only flood fill (fills accumulating in one mask), the convex
    hull of int and float points (point order included) and ``findContours``
    (RETR_TREE, CHAIN_APPROX_SIMPLE; contour and point order included) on the
    locator's blurred and thresholded pages."""
    rng = np.random.default_rng(3)
    for _ in range(30):
        img = np.where(rng.random((30, 40)) < 0.5, 0, 255).astype(np.uint8)
        mask = np.zeros((32, 42), np.uint8)
        for _ in range(3):
            seed = (int(rng.integers(0, 40)), int(rng.integers(0, 30)))
            got = locate.flood_fill_mask(img, mask, seed)
            cv2.floodFill(img.copy(), mask, seed, 255, 0, 0, cv2.FLOODFILL_MASK_ONLY)
            np.testing.assert_array_equal(got, mask)
    for t in range(120):
        n = int(rng.integers(1, 60))
        pts = rng.integers(0, 20, (n, 2)).astype(np.int32) if t % 2 else \
            (rng.random((n, 2)) * 50).astype(np.float32)
        if t % 5 == 0:
            pts = (np.round(pts / 4) * 4).astype(pts.dtype)
        np.testing.assert_array_equal(locate.convex_hull(pts),
                                      cv2.convexHull(pts.reshape(-1, 1, 2)).reshape(-1, 2))
    for g in list(grays_of(fix).values())[:4]:
        _, thr = cv2.threshold(cv2.blur(g, (3, 3)), 50, 255, cv2.THRESH_BINARY)
        want, _ = cv2.findContours(thr, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
        got = locate.find_contours(thr)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.reshape(-1, 2))


def test_resize_linear_exact_equals_cv2(fix):
    """INTER_LINEAR_EXACT up to the locator's 512-pixel side and back, other
    sizes, and an exact halving (INTER_AREA's 2×2 mean in OpenCV)."""
    for g in list(grays_of(fix).values())[:4]:
        h, w = g.shape
        for size in ((745, 512), (512, 745), (300, 200), (w // 2, h // 2), (w, h), (w + 1, h - 3)):
            np.testing.assert_array_equal(locate.resize_linear_exact(g, *size),
                                          cv2.resize(g, size, interpolation=cv2.INTER_LINEAR_EXACT))


# ---------------------------------------------------------------- the locator

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", ["fixture", "sweep", "held_out"])
def test_quads_equal_cv2(page_sets, which, seed):
    """``locate_qr_quads`` against ``detectMulti`` then ``detect`` on every page
    of the set, both generators seeded with ``seed`` before each call; the
    generators' next draws afterwards equal (the calls drew alike)."""
    det = cv2.QRCodeDetector()
    for name, gray in page_sets[which].items():
        cv2.setRNGSeed(seed)
        want = cv2_quads(det, gray)
        locate.set_rng_seed(seed)
        assert_quads_equal(locate.locate_qr_quads(gray), want, (which, name, seed))
        assert rng_draws(4) == [locate.rng_next() & 0xFFFF for _ in range(4)], (which, name)


@pytest.mark.parametrize("order", ["forward", "reversed"])
def test_sequential_sweep_equals_cv2(page_sets, order):
    """The sweep's pages one after another on a fresh thread, from the default
    state and never reseeded, against one cv2 detector: the two generators
    advance together (on the 0.40× pages the quads depend on the state)."""
    keys = sorted(page_sets["sweep"], key=lambda k: (k.split("_")[0], float(k.split("_")[1])))
    if order == "reversed":
        keys = keys[::-1]
    errors = []

    def run():
        det = cv2.QRCodeDetector()
        for key in keys:
            gray = page_sets["sweep"][key]
            want_ok, want = cv2_quads(det, gray)
            why = chip_smoke.qr_quads_equal(locate.locate_qr_quads(gray),
                                            [want_ok, [] if want is None else want.tolist()])
            if why:
                errors.append((key, why))

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert errors == []


def test_quads_depend_on_the_generator(page_sets):
    """On the 0.40× sweep pages cv2's quads change with the seed, and the
    port's with them."""
    det = cv2.QRCodeDetector()
    seen = set()
    for key in ("0_0.4", "5_0.4"):
        gray = page_sets["sweep"][key]
        for seed in range(12):
            cv2.setRNGSeed(seed)
            want = cv2_quads(det, gray)
            locate.set_rng_seed(seed)
            assert_quads_equal(locate.locate_qr_quads(gray), want, (key, seed))
            seen.add((key, None if want[1] is None else want[1].tobytes()))
    assert len(seen) > 2
