"""PyTorch port: ``ops.host_warp`` against OpenCV on seeded sweeps.

The matrices are those the perturbation engine makes (``_geometry_matrix``
at MILD and HARD severity, perspective on and off) on frames from 17×23 to
160×224, odd sizes included; widths that 16 divides and widths that it
does not, so both the AVX2 kernel's 16-pixel steps and its scalar tail are
held. The matrices and both uint8 warps are held bit for bit, the float32
affine warp too (a tolerance of 0)."""

from fractions import Fraction

import cv2
import numpy as np
import pytest

from twinvoice_tpu.data import augment as jax_augment
from twinvoice_tpu_torch.ops import host_warp as W


def frames(seed, n):
    """``n`` (image, matrix) pairs: sizes, severities and perspective from
    the seed; every other image quantised to multiples of 64 (large steps
    between neighbours make a one-ulp coordinate error show)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        h, w = int(rng.integers(17, 161)), int(rng.integers(23, 225))
        if t % 4 == 0:
            w = int(rng.integers(2, 14)) * 16
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if t % 2:
            img = (img // 64 * 64).astype(np.uint8)
        spec = jax_augment.sample_spec(rng, (jax_augment.MILD, jax_augment.HARD)[t % 2])
        spec.perspective = (0.0, 0.03, 0.06)[t % 3]
        out.append((img, jax_augment._geometry_matrix(spec, w, h, rng)))
    return out


def bits(a):
    return np.asarray(a, np.float64).view(np.int64)


@pytest.mark.parametrize("seed", range(4))
def test_matrices_bit_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        w, h = int(rng.integers(17, 800)), int(rng.integers(17, 800))
        j = rng.uniform(0, 0.06) * min(w, h)
        src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
        dst = src + rng.uniform(-j, j, (4, 2)).astype(np.float32)
        m = W.get_perspective_transform(src, dst)
        assert np.array_equal(bits(m), bits(cv2.getPerspectiveTransform(src, dst)))
        spec = jax_augment.sample_spec(rng, jax_augment.HARD)
        g = jax_augment._geometry_matrix(spec, w, h, rng)
        assert np.array_equal(bits(W.invert_3x3(g)), bits(cv2.invert(g)[1]))
        assert np.array_equal(bits(W.invert_affine(g[:2])),
                              bits(cv2.invertAffineTransform(g[:2])))
        k = int(rng.integers(3, 14)) | 1
        ang = float(rng.uniform(0, 180))
        c = (k / 2 - 0.5, k / 2 - 0.5)
        assert np.array_equal(bits(W.rotation_matrix_2d(c, ang, 1.0)),
                              bits(cv2.getRotationMatrix2D(c, ang, 1.0)))


def test_fma32_rounds_once():
    """Against the exact sum, on random triples and on triples built to land
    on a float32 midpoint (where a float64 sum rounds twice)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-300, 300, 4000).astype(np.float32)
    b = rng.uniform(-2, 2, 4000).astype(np.float32)
    c = rng.uniform(-300, 300, 4000).astype(np.float32)
    s = (a.astype(np.float64) * b + c).astype(np.float32)
    mid = (s.astype(np.float64) + np.nextafter(s, np.float32(np.inf))) / 2
    c[::2] = (mid - a.astype(np.float64) * b)[::2].astype(np.float32)
    got = W.fma32(a, b, c)
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        f = np.float32(float(exact))
        up = Fraction(float(f)) <= exact
        lo = f if up else np.nextafter(f, np.float32(-np.inf))
        hi = np.nextafter(f, np.float32(np.inf)) if up else f
        dl, dh = exact - Fraction(float(lo)), Fraction(float(hi)) - exact
        want = lo if dl < dh else hi if dh < dl else (lo if lo.view(np.int32) % 2 == 0 else hi)
        assert got[i] == want, (a[i], b[i], c[i])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("border", [W.BORDER_REPLICATE, W.BORDER_CONSTANT])
def test_warp_linear_byte_equal(seed, border):
    cv_border = {W.BORDER_REPLICATE: cv2.BORDER_REPLICATE, W.BORDER_CONSTANT: cv2.BORDER_CONSTANT}
    for img, m in frames(seed, 8):
        h, w = img.shape[:2]
        want = cv2.warpPerspective(img, m, (w, h), flags=cv2.INTER_LINEAR,
                                   borderMode=cv_border[border], borderValue=(1, 1, 1))
        got = W.warp_perspective_u8(img, m, (w, h), W.INTER_LINEAR, border, (1, 1, 1))
        assert np.array_equal(got, want), (h, w, int((got != want).sum()))


@pytest.mark.parametrize("seed", range(6))
def test_warp_nearest_byte_equal(seed):
    for img, m in frames(100 + seed, 8):
        h, w = img.shape[:2]
        for mask in (img, img[..., :1], img[..., 0]):
            want = cv2.warpPerspective(mask, m, (w, h), flags=cv2.INTER_NEAREST,
                                       borderMode=cv2.BORDER_CONSTANT, borderValue=0)
            got = W.warp_perspective_u8(mask, m, (w, h), W.INTER_NEAREST, W.BORDER_CONSTANT, 0)
            assert got.shape == want.shape and np.array_equal(got, want), (h, w)


def test_warp_affine_f32_motion_kernels():
    """The motion-blur kernels (a centred line of 1/k, rotated), k 3..13:
    tolerance 0."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(200):
        k = int(rng.integers(3, 14)) | 1
        ker = np.zeros((k, k), np.float32)
        ker[k // 2, :] = 1.0 / k
        ang = float(rng.uniform(0, 180))
        rot = cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5), ang, 1.0)
        want = cv2.warpAffine(ker, rot, (k, k))
        got = W.warp_affine_f32(ker, W.rotation_matrix_2d((k / 2 - 0.5, k / 2 - 0.5), ang, 1.0), (k, k))
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"warp_affine_f32 worst |Δ| {worst} (tolerance 0)")
    assert worst == 0.0


def test_warp_rejects_what_it_does_not_port():
    img = np.zeros((20, 30, 3), np.uint8)
    with pytest.raises(ValueError):
        W.warp_perspective_u8(img, np.eye(3), (30, 20), W.INTER_NEAREST, W.BORDER_REPLICATE)
    with pytest.raises(ValueError):
        W.warp_perspective_u8(img.astype(np.float32), np.eye(3), (30, 20))
    with pytest.raises(ValueError):
        W.warp_perspective_u8(img, np.zeros((3, 3)), (30, 20))
