"""PyTorch port: ``tests/data/torch_smoke_qr.npz`` (JAX's outputs, made by
``scripts/make_torch_smoke_qr.py``) against the port on the CPU, through the
check functions of ``chip_smoke.py`` phase 27, with no JAX and no OpenCV in
the port: the encoder's matrices, the enhanced crops, the locator's quads
against cv2's on the fixture's 14 pages and the sweep's 82 (corners within
1e-3 px, int boxes equal), the scans' payloads, the turns, ``extract`` with
the port's bundled w16 at fp32 (fields equal wherever the port's boxes are
JAX's: here on every page) and the labelme core. Tolerances as there.
"""

import sys

import pytest
import torch

import chip_smoke


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.qr_fixture()


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_fixture_pages(fix):
    assert len(fix["names"]) == len(fix["pages"]) == 14
    assert sum(p.shape[1] > p.shape[0] for p in fix["pages"]) == 4
    assert [fix["pages"][i].shape[:2] for i in range(len(fix["names"]))
            if "x0.45" in fix["names"][i]] == [(288, 198)] * 2


def test_encoder_and_enhance(fix, no_cv2):
    assert chip_smoke.qr_encode_check(fix) == 40
    assert chip_smoke.qr_enhance_check(fix) == 3


def test_locator_scan_and_turn(fix, no_cv2):
    located = chip_smoke.qr_locate_check(fix)
    assert len(located) == 14 + 82
    assert [[list(b) for b in located[n][1]] for n in fix["names"]] == fix["cv2_boxes"]
    scans = chip_smoke.qr_scan_check(fix)
    assert len(scans) == 14 + 82
    assert [len(scans[n][0]) for n in fix["names"]] == [
        1 if "x0.45" in n or n == "s0_x0.55" else 0 if n == "blank" else 2 for n in fix["names"]]
    assert chip_smoke.qr_turn_check(fix) == {"s0_rot90": -1, "s0_rot-90": 1,
                                             "s5_rot90": -1, "s5_rot-90": 1}


def test_extract_on_the_turned_and_small_pages(fix, no_cv2):
    from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

    seg = load_pretrained_segmenter(torch.float32, device="cpu")
    got, other, launches = chip_smoke.qr_extract_check(
        fix, seg, TorchOcrEngine(device="cpu"), expect_k1=False)
    assert other == [] and launches == {} and len(got) == 6
    assert all(r["meta"]["invoice_no"] == "AB12345678" for r in got)


def test_labelme_core(fix, no_cv2):
    assert chip_smoke.labelme_check(fix) == (256, 192)
