"""PyTorch port: ``ops.host_jpeg.jpeg_roundtrip_u8`` against OpenCV's
``imencode``/``imdecode`` byte for byte, at every quality from 1 to 95, on
frames whose sides are mostly not multiples of 16 (1 to 160 rows, 1 to 224
columns: the edge replication, the odd chroma row and the two-sample
chroma that is not fancy-upsampled), smooth and noisy content."""

import cv2
import numpy as np
import pytest

from twinvoice_tpu_torch.ops.host_jpeg import jpeg_roundtrip_u8, quant_tables


def cv_roundtrip(rgb, q):
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1], [int(cv2.IMWRITE_JPEG_QUALITY), q])
    assert ok
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]


def frame(rng, h, w, noisy):
    if noisy:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("block", range(5))
def test_roundtrip_byte_equal(block):
    """Qualities 1..95 in five blocks of 19, each at its own size."""
    rng = np.random.default_rng(block)
    for q in range(1 + 19 * block, 20 + 19 * block):
        h, w = int(rng.integers(1, 161)), int(rng.integers(1, 225))
        img = frame(rng, h, w, noisy=q % 3 == 0)
        got = jpeg_roundtrip_u8(img, q)
        want = cv_roundtrip(img, q)
        assert np.array_equal(got, want), (q, h, w, int((got != want).sum()))


def test_roundtrip_fixture_size():
    """The gauntlet's 745×395 page size (neither side a multiple of 16)."""
    rng = np.random.default_rng(7)
    img = frame(rng, 745, 395, noisy=False)
    for q in (20, 84, 85, 88):
        assert np.array_equal(jpeg_roundtrip_u8(img, q), cv_roundtrip(img, q))


def test_quant_tables():
    y, c = quant_tables(50)
    assert y[0, 0] == 16 and c[0, 0] == 17 and y.max() == 121
    y, c = quant_tables(1)
    assert y.max() == 255 and c.min() == 255  # force_baseline clamps
    with pytest.raises(ValueError):
        quant_tables(0)
