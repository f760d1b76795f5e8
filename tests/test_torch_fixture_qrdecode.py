"""PyTorch port: ``tests/data/torch_smoke_qrdecode.npz`` (OpenCV's and the JAX
package's outputs, made by ``scripts/make_torch_smoke_qrdecode.py``) against
the port on the CPU, through the check functions of ``chip_smoke.py`` phase
35, with OpenCV and Pillow blocked: cv2's two decode calls on the fixture's
images (strings, ``ok`` flags and raises equal), the default
``QrPipeline().scan`` on the QR fixture's 14 pages and 82 sweep pages
(JAX's default scan, in order, no pass skipped), ``extract`` with the port's
bundled w16 at fp32 on the two pages cv2's decoder decides (JAX's records).
Tolerance: none. A fixture string changed by one character fails its check.
"""

import copy
import sys

import pytest
import torch

import chip_smoke


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.qrdecode_fixture()


@pytest.fixture(scope="module")
def qr_fix():
    return chip_smoke.qr_fixture()


@pytest.fixture
def blocked(monkeypatch):
    for name in ("cv2", "PIL"):
        monkeypatch.setitem(sys.modules, name, None)


def test_fixture_contents(fix):
    assert len(fix["names"]) == len(fix["images"]) == len(fix["cv2"]) == 55
    assert len(fix["sweep_default"]) == 82
    assert fix["extract_pages"] == ["qr:s0_x0.55", "sweep:5_0.49"]
    # the pages where the native scan reads one code and cv2's decoder the other
    assert [len(fix["sweep_default"][k]) for k in ("0_0.49", "5_0.55", "0_0.61")] == [2, 2, 2]
    assert sum(r["multi"][0] == "err" for r in fix["cv2"]) >= 2


def test_images_equal_cv2(fix, blocked):
    n, payloads, raises, ms = chip_smoke.qrdecode_images_check(fix)
    assert n == 55 and payloads >= 30 and raises >= 2 and ms > 0


def test_one_wrong_string_is_caught(fix, blocked):
    i = next(j for j, r in enumerate(fix["cv2"])
             if r["single"][0] == "ok" and len(r["single"][1]) > 2)
    bad = copy.deepcopy(fix)
    text = bad["cv2"][i]["single"][1]
    bad["cv2"][i]["single"][1] = text[:-1] + ("x" if text[-1] != "x" else "y")
    with pytest.raises(AssertionError, match="cv2's decoder on"):
        chip_smoke.qrdecode_images_check(bad)


def test_default_scans_equal_jax(fix, qr_fix, blocked, monkeypatch):
    monkeypatch.setattr(chip_smoke, "QRDECODE_REPS", 1)
    got = chip_smoke.qrdecode_scan_check(fix, qr_fix)
    assert len(got) == 14 + 82
    assert got["s0_x0.55"][0] == qr_fix["jax_default"][qr_fix["names"].index("s0_x0.55")]
    assert len(got["s0_x0.55"][0]) == 2 and got["blank"][0] == []


def test_extract_on_the_decoders_pages(fix, qr_fix, blocked):
    from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

    seg = load_pretrained_segmenter(torch.float32, variant="w16", device="cpu")
    pages, got, other, launches = chip_smoke.qrdecode_extract_check(
        fix, qr_fix, seg, TorchOcrEngine(device="cpu"), expect_k1=False)
    assert launches == {} and len(got) == len(pages) == 2 and other == []
    assert all(len(r["qr_raw"]) == 2 and r["items"] for r in got)
