"""PyTorch port: ``ops.host_filter`` against OpenCV on seeded sweeps.

``gaussian_blur_u8`` is held byte for byte. The float32 functions are held
within 1e-4 absolute on values in 0..255 (a few float32 ulp there: OpenCV's
row filter adds its scalar tail without FMAs, and it filters a 13×13 kernel
through its DFT); each test prints its worst |Δ| beside the tolerance."""

import cv2
import numpy as np
import pytest

from twinvoice_tpu_torch.ops import host_filter as F

TOL = 1e-4


def sizes(rng, n):
    return [(int(rng.integers(17, 161)), int(rng.integers(23, 225))) for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_gaussian_blur_u8_byte_equal(seed):
    rng = np.random.default_rng(seed)
    for h, w in sizes(rng, 6):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for sigma in (2.0, float(rng.uniform(0.3, 3.0))):
            assert np.array_equal(F.gaussian_blur_u8(img, sigma),
                                  cv2.GaussianBlur(img, (0, 0), sigma))


def test_gaussian_taps_q8():
    """σ 2 (the clutter background's): ksize 13, the Q8 taps cv2 uses."""
    assert F.gaussian_taps_q8(13, 2.0).tolist() == [1, 2, 7, 16, 31, 45, 52, 45, 31, 16, 7, 2, 1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gaussian_blur_float_within_tol(dtype):
    rng = np.random.default_rng(1)
    worst = 0.0
    for h, w in sizes(rng, 8):
        x = rng.uniform(0, 255, (h, w, 3)).astype(dtype)
        for sigma in (float(rng.uniform(0.05, 2.2)), 0.6):
            d = np.abs(F.gaussian_blur_f32(x, sigma).astype(np.float64)
                       - cv2.GaussianBlur(x, (0, 0), sigma))
            worst = max(worst, float(d.max()))
    print(f"gaussian_blur_f32 ({np.dtype(dtype).name}) worst |Δ| {worst:.3g} (tolerance {TOL})")
    assert worst <= TOL


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 13])
def test_filter2d_within_tol(k):
    rng = np.random.default_rng(k)
    worst = 0.0
    for i, (h, w) in enumerate(sizes(rng, 4)):
        x = rng.uniform(0, 255, (h, w, 3)).astype(np.float32 if i % 2 == 0 else np.float64)
        ker = rng.uniform(0, 1, (k, k)).astype(np.float32)
        if i < 2:  # a motion kernel: a line, zero elsewhere
            ker = np.zeros((k, k), np.float32)
            ker[k // 2] = 1.0 / k
        ker /= ker.sum()
        d = np.abs(F.filter2d_f32(x, ker).astype(np.float64) - cv2.filter2D(x, -1, ker))
        worst = max(worst, float(d.max()))
    print(f"filter2d_f32 {k}×{k} worst |Δ| {worst:.3g} (tolerance {TOL})")
    assert worst <= TOL


def test_resize_cubic_f32_within_tol():
    """The blob field: 6×8 in [-1, 1] up to the frame; held at 255× its
    scale."""
    rng = np.random.default_rng(2)
    worst = 0.0
    for h, w in sizes(rng, 20) + [(745, 395), (584, 450)]:
        g = rng.uniform(-1, 1, (6, 8)).astype(np.float32)
        d = np.abs(F.resize_cubic_f32(g, w, h) - cv2.resize(g, (w, h), interpolation=cv2.INTER_CUBIC))
        worst = max(worst, float(d.max()))
    print(f"resize_cubic_f32 worst |Δ| {worst:.3g} on [-1, 1] (tolerance {TOL / 255:.3g})")
    assert worst <= TOL / 255


def test_rejects_what_it_does_not_port():
    with pytest.raises(ValueError):
        F.filter2d_f32(np.zeros((8, 8), np.float32), np.ones((15, 15), np.float32))
    with pytest.raises(ValueError):
        F.gaussian_blur_f32(np.zeros((8, 8), np.uint8), 1.0)
