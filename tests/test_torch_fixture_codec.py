"""PyTorch port: ``tests/data/torch_smoke_codec.npz`` (OpenCV's and the JAX
package's outputs, made by ``scripts/make_torch_smoke_codec.py``) against the
port on the CPU through the check functions of ``chip_smoke.py`` phase 30
and phase 27 (g), with OpenCV and Pillow blocked: every fixture file read by
``imread_rgb`` byte-equal to cv2's RGB, the two encodes byte-equal to
cv2's, the phone-photo round trips (at 403×302 here: the card's host runs
4032×3024) equal to ``jpeg_roundtrip_u8``, ``build-dataset`` writing JAX's
JPEG bytes and mask, and the training pages through files. Tolerance:
none.
"""

import os
import sys

import numpy as np
import pytest

import chip_smoke


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.codec_fixture()


@pytest.fixture
def no_cv2_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_fixture_holds_every_case(fix):
    names = fix["names"]
    assert len(names) == 44 and os.path.getsize(chip_smoke.CODEC_FIXTURE) < 1 << 20
    for kind in ("444", "422", "420", "440", "411", "gray", "rst3"):
        assert any(n.startswith(f"jpeg_{kind}") for n in names), kind
    assert sum(n.startswith("jpeg_exif") for n in names) == 16
    assert sum(n.startswith("png_c") for n in names) == 15
    assert fix["lm_mask"].shape == (512, 512, 3) and fix["lm_mask"].any()


def test_files_and_encodes_equal_cv2(fix, no_cv2_pil, tmp_path):
    n, read_ms, enc_ms = chip_smoke.codec_files_check(fix, str(tmp_path))
    assert n == 44 and read_ms > 0 and enc_ms > 0


def test_files_check_catches_a_wrong_pixel(fix, tmp_path):
    bad = dict(fix, want_0=fix["want_0"].copy())
    bad["want_0"][0, 0, 0] ^= 1
    with pytest.raises(AssertionError, match=fix["names"][0]):
        chip_smoke.codec_files_check(bad, str(tmp_path))


def test_phone_photo_round_trip(no_cv2_pil):
    """Both photos of (b) round-trip; the noisy one codes to more bytes
    than the smooth one; the C++ scan's time is a part of each call's;
    the timer leaves ``host_jpeg`` as it found it."""
    from twinvoice_tpu_torch.ops import host_jpeg

    page = chip_smoke.train_fixture()["pages"][0]
    codec = host_jpeg.codec
    sizes = {}
    for kind, photo in chip_smoke.phone_photos(page, size=(403, 302)).items():
        assert photo.shape == (302, 403, 3) and photo.dtype == np.uint8
        enc_ms, enc_scan, dec_ms, dec_scan, rt_ms, sizes[kind] = chip_smoke.phone_photo_check(
            photo)
        assert 0 < enc_scan < enc_ms and 0 < dec_scan < dec_ms and rt_ms > 0
    assert sizes["noisy page"] > 1.5 * sizes["upscaled page"] > 2000
    assert host_jpeg.codec is codec
    ms, size = chip_smoke.small_encode_ms(page, reps=2)
    assert ms > 0 and size > 1000


def test_build_dataset_writes_jaxs_files(fix, no_cv2_pil, tmp_path):
    assert chip_smoke.build_dataset_check(fix, str(tmp_path)) > 0
    assert sorted(os.listdir(tmp_path / "fixed_images")) == ["photo0.jpg"]


def test_training_pages_through_files(no_cv2_pil, tmp_path):
    """Phase 27 (g)'s files: the pages written by ``imwrite_jpeg`` and read
    back by ``load_invoice_dataset`` as their ``jpeg_roundtrip_u8``."""
    train = chip_smoke.train_fixture()
    img_dir, mask_dir, _ = chip_smoke.training_files(str(tmp_path), train["pages"],
                                                     train["masks"])
    assert sorted(os.listdir(img_dir)) == [f"page{i}.jpg" for i in range(4)]
    assert np.load(os.path.join(mask_dir, "page0.npy")).dtype == np.uint8
