"""PyTorch port: ``ops.host_filter`` against OpenCV on seeded sweeps.

``gaussian_blur_u8`` is held byte for byte. The float functions are held
byte for byte against OpenCV's own code (``cv2.ipp.setUseIPP(False)``) at
the perturbation engine's shapes: the blur of float32 and float64 images,
the motion filter on both of OpenCV's routes (its direct sum below 130 taps
for float32 and 50 for float64, its DFT from there: ``csrc/host_dft.cpp``,
whose transforms are also held to ``cv2.dft``) and the cubic blob field.
With IPP on (the wheel's default) the blur is held within 1e-4 absolute on
values in 0..255 and prints its worst |Δ| beside the tolerance; the DFT
filter's IPP-on differences are counted and printed, not asserted."""

import cv2
import numpy as np
import pytest

from twinvoice_tpu_torch.ops import host_filter as F

TOL = 1e-4


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


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


def motion_kernel(k, angle):
    """The engine's motion kernel (``augment.perturb``): a line rotated by
    ``angle`` degrees and normalised."""
    ker = np.zeros((k, k), np.float32)
    ker[k // 2] = 1.0 / k
    rot = cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5), angle, 1.0)
    ker = cv2.warpAffine(ker, rot, (k, k))
    ker /= max(ker.sum(), 1e-6)
    return ker


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 13])
def test_filter2d_within_tol(no_ipp, k):
    """Float32 and float64 images at every side, each equal to
    ``cv2.filter2D`` on whichever route OpenCV takes for it."""
    rng = np.random.default_rng(k)
    for i, (h, w) in enumerate(sizes(rng, 4)):
        x = rng.uniform(0, 255, (h, w, 3)).astype(np.float32 if i % 2 == 0 else np.float64)
        ker = rng.uniform(0, 1, (k, k)).astype(np.float32)
        if i < 2:  # a motion kernel: a line, zero elsewhere
            ker = np.zeros((k, k), np.float32)
            ker[k // 2] = 1.0 / k
        ker /= ker.sum()
        assert np.array_equal(F.filter2d_f32(x, ker), cv2.filter2D(x, -1, ker)), (h, w, x.dtype)


@pytest.mark.parametrize("dtype,k", [(np.float32, 13), (np.float64, 9), (np.float64, 11),
                                     (np.float64, 13)])
def test_dft_filter_equals_opencv(no_ipp, dtype, k):
    """OpenCV's DFT route bit for bit: the engine's frame (745×395×3), one
    channel, and frame sizes across the DFT's block boundaries (a 256-point
    block holds 256 − k + 1 output rows or columns: one tile, one tile and
    one more row or column, several tiles, frames narrower than a block)."""
    rng = np.random.default_rng(100 + k + (dtype == np.float64))
    b = 256 - k + 1
    shapes = [(745, 395, 3), (584, 450)]
    shapes += [(b + dh, b + dw, 3) for dh in (-1, 0, 1) for dw in (-1, 0, 1)]
    shapes += [(2 * b + 1, 17, 3), (9, 3 * b - 1), (1, 1, 3), (5, 7)]
    for shape in shapes:
        x = rng.uniform(0, 255, shape).astype(dtype)
        ker = motion_kernel(k, float(rng.uniform(0, 180)))
        assert np.array_equal(F.filter2d_f32(x, ker), cv2.filter2D(x, -1, ker)), (shape, k)


def test_dft_transforms_equal_opencv(no_ipp):
    """The library's complex 1-D DFT (radix 2, 3, 4, 5 and generic odd
    factors, forward and scaled inverse) and real 2-D DFT (CCS, and its
    inverse with odd and even sides) equal ``cv2.dft``."""
    lib = F.dft_library()
    rng = np.random.default_rng(7)
    for n in list(range(1, 41)) + [49, 77, 121, 128, 135, 256, 270, 375, 500]:
        x = rng.uniform(-100, 100, (1, n, 2))
        for inv in (0, 1):
            got = np.empty_like(x)
            assert lib.host_dft_complex(n, inv, 1.0 / n if inv else 1.0,
                                        x.ctypes.data, got.ctypes.data) == 0
            want = cv2.dft(x, flags=cv2.DFT_INVERSE | cv2.DFT_SCALE if inv else 0)
            assert np.array_equal(got, want), (n, inv)
    for h, w in [(2, 2), (3, 5), (8, 8), (27, 45), (81, 64), (100, 375), (256, 270), (250, 256)]:
        x = rng.uniform(-100, 100, (h, w))
        for inv in (0, 1):
            got = x.copy()
            assert lib.host_dft_real2d(h, w, inv, 0, got.ctypes.data) == 0
            want = cv2.dft(x, flags=cv2.DFT_INVERSE | cv2.DFT_SCALE if inv else 0)
            assert np.array_equal(got, want), (h, w, inv)


def test_dft_filter_ipp_on_is_counted():
    """With IPP on, cv2's float64 DFT filter differs from its own IPP-off
    result; its float32 one does not. Counted on the engine's frame and
    printed, not asserted."""
    was = cv2.ipp.useIPP()
    rng = np.random.default_rng(3)
    try:
        for dtype, k in ((np.float32, 13), (np.float64, 9), (np.float64, 11), (np.float64, 13)):
            x = rng.uniform(0, 255, (745, 395, 3)).astype(dtype)
            ker = motion_kernel(k, float(rng.uniform(0, 180)))
            cv2.ipp.setUseIPP(True)
            on = cv2.filter2D(x, -1, ker)
            cv2.ipp.setUseIPP(False)
            off = cv2.filter2D(x, -1, ker)
            assert np.array_equal(F.filter2d_f32(x, ker), off)
            d = np.abs(on.astype(np.float64) - off)
            print(f"cv2.filter2D {np.dtype(dtype).name} {k}×{k} 745×395×3, IPP on vs off: "
                  f"{int((d > 0).sum())} of {d.size} values differ, max |Δ| {float(d.max()):.3g}")
    finally:
        cv2.ipp.setUseIPP(was)


def test_resize_cubic_f32_within_tol(no_ipp):
    """The blob field: 6×8 in [-1, 1] up to the frame, equal to OpenCV's own
    code at every width (its 4-lane vertical loop and left-to-right tail)."""
    rng = np.random.default_rng(2)
    for h, w in sizes(rng, 20) + [(745, 395), (584, 450)]:
        g = rng.uniform(-1, 1, (6, 8)).astype(np.float32)
        want = cv2.resize(g, (w, h), interpolation=cv2.INTER_CUBIC)
        assert np.array_equal(F.resize_cubic_f32(g, w, h), want), (h, w)


@pytest.mark.parametrize("seed", range(3))
def test_float_stages_equal_opencv_without_ipp(no_ipp, seed):
    """The engine's float stages bit for bit: blurs of float32 and float64
    3-channel and 1-channel images at the engine's sigmas (0.4–2.2 and the
    scan PSF's 0.6, 3 to 19 taps), rows of every width mod 8, and motion
    kernels of 3 to 13 taps (OpenCV's DFT from 13 for float32, from 9 for
    float64)."""
    rng = np.random.default_rng(10 + seed)
    for i, (h, w) in enumerate(sizes(rng, 6)):
        dtype = np.float32 if i % 2 == 0 else np.float64
        for x in (rng.uniform(0, 255, (h, w, 3)).astype(dtype),
                  rng.uniform(0, 255, (h, w)).astype(dtype)):
            for sigma in (float(rng.uniform(0.4, 2.2)), 0.6, float(rng.uniform(0.05, 0.4))):
                assert np.array_equal(F.gaussian_blur_f32(x, sigma),
                                      cv2.GaussianBlur(x, (0, 0), sigma)), (h, w, sigma, dtype)
            for k in (3, 5, 7, 9, 11, 13):
                ker = motion_kernel(k, float(rng.uniform(0, 180)))
                assert np.array_equal(F.filter2d_f32(x, ker), cv2.filter2D(x, -1, ker)), (h, w, k, dtype)


def test_gaussian_kernel_is_opencvs():
    """``getGaussianKernel`` (its softdouble exp) bit for bit in float64."""
    rng = np.random.default_rng(4)
    for sigma in list(rng.uniform(0.05, 3.0, 60)) + [0.6, 2.0]:
        n = int(np.rint(sigma * 8 + 1)) | 1
        want = cv2.getGaussianKernel(n, float(sigma), cv2.CV_64F).ravel()
        assert np.array_equal(np.asarray(F.gaussian_kernel_bitexact(n, float(sigma))), want), sigma


def test_rejects_what_it_does_not_port():
    with pytest.raises(ValueError):
        F.filter2d_f32(np.zeros((8, 8), np.float32), np.ones((15, 15), np.float32))
    with pytest.raises(ValueError):
        F.gaussian_blur_f32(np.zeros((8, 8), np.uint8), 1.0)
