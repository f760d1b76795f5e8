"""PyTorch port: ``tests/data/torch_smoke_jpegforms.npz`` (OpenCV's, Pillow's
and the JAX package's outputs, made by ``scripts/make_torch_smoke_jpegforms.py``)
against the port on the CPU through the check functions of ``chip_smoke.py``
phase 34, with OpenCV and Pillow blocked: (a) every fixture file read by
``imread_rgb`` byte-equal to cv2's RGB, the bad progression refused; (b) the
4032×3024 progressive photo decoded to the SHA-256 of cv2's RGB; (c)
``build-dataset`` on a progressive and a CMYK photo writing JAX's ``.jpg``
bytes and masks, and ``load_invoice_dataset`` returning JAX's arrays; (d)
the progressive photo served by the bundled w16 at fp32 through the raw path
with JAX's boxes, K1's plain version on the served logits giving the served
boxes. Tolerance: none.
"""

import os
import sys

import numpy as np
import pytest

import chip_smoke


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.jpegforms_fixture()


@pytest.fixture
def no_cv2_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_fixture_holds_every_case(fix):
    names = fix["names"]
    assert len(names) == 38 and os.path.getsize(chip_smoke.JPEGFORMS_FIXTURE) < 2 << 20
    for kind in ("prog_cv2_444", "prog_cv2_422", "prog_cv2_420", "prog_cv2_gray",
                 "prog_cv2_rst", "prog_cv2_exif", "prog_pil_optimize", "bad_", "bogus_",
                 "cmyk_q", "ycck_q", "cmyk_prog", "rgb_keep", "rgb_adobe0"):
        assert any(n.startswith(kind) for n in names), kind
    assert [n for n in names if n.startswith("prog_cut")] == [f"prog_cut{k}" for k in
                                                               range(1, 10)]
    assert [r for r in fix["reasons"] if r] == ["bad progression"]
    assert fix["photo"].size <= 4 << 20 and tuple(fix["photo_size"]) == (4032, 3024)
    assert fix["lm_names"] == ["prog", "cmyk"] and fix["serve_ok"].all()


def test_files_equal_cv2(fix, no_cv2_pil, tmp_path):
    n, refused, read_ms = chip_smoke.jpegforms_files_check(fix, str(tmp_path))
    assert (n, refused) == (38, 1) and read_ms > 0


def test_files_check_catches_a_wrong_pixel(fix, tmp_path):
    i = fix["names"].index("prog_cut5")
    bad = dict(fix, **{f"want_{i}": fix[f"want_{i}"].copy()})
    bad[f"want_{i}"][3, 4, 1] ^= 1
    with pytest.raises(AssertionError, match="prog_cut5: .* 1 bytes differ"):
        chip_smoke.jpegforms_files_check(bad, str(tmp_path))


def test_files_check_catches_a_missing_refusal(fix, tmp_path):
    i = fix["names"].index("bad_dc_se1")
    bad = dict(fix, **{f"file_{i}": fix[f"file_{i - 1}"]})
    with pytest.raises(AssertionError, match="bad_dc_se1: read, where cv2 reads nothing"):
        chip_smoke.jpegforms_files_check(bad, str(tmp_path))


def test_photo_decodes_to_cv2s_digest(fix, no_cv2_pil):
    ms, scan_ms, smooth_ms, size, nbytes = chip_smoke.jpegforms_photo_check(fix)
    assert 0 < scan_ms < ms and smooth_ms == 0  # a whole file: nothing smoothed
    assert size == (4032, 3024) and nbytes == fix["photo"].size
    i = fix["names"].index("prog_cut5")  # a small stand-in: its digest, then one byte off
    small = {"photo": fix[f"file_{i}"], "photo_size": np.array(fix[f"want_{i}"].shape[1::-1])}
    want = fix[f"want_{i}"].copy()
    small["photo_sha"] = np.array(chip_smoke.array_digest(want))
    assert chip_smoke.jpegforms_photo_check(small)[2] > 0  # cut: smoothed
    want[0, 0, 0] ^= 1
    small["photo_sha"] = np.array(chip_smoke.array_digest(want))
    with pytest.raises(AssertionError, match="not cv2's"):
        chip_smoke.jpegforms_photo_check(small)


def test_build_and_load_equal_jax(fix, no_cv2_pil, tmp_path):
    build_ms, load_ms = chip_smoke.jpegforms_build_check(fix, str(tmp_path))
    assert build_ms > 0 and load_ms > 0
    assert sorted(os.listdir(tmp_path / "fixed_images")) == ["cmyk.jpg", "prog.jpg"]


def test_served_boxes_equal_jax(fix, no_cv2_pil, tmp_path):
    assert chip_smoke.jpegforms_serve_check(fix, str(tmp_path), device="cpu") == {}
    bad = dict(fix, serve_boxes=fix["serve_boxes"] + 1)
    with pytest.raises(AssertionError, match="JAX's ok"):
        chip_smoke.jpegforms_serve_check(bad, str(tmp_path), device="cpu")
