"""PyTorch port: the app's card fixture (``tests/data/torch_smoke_app.npz``,
made by ``scripts/make_torch_smoke_app.py``) and ``chip_smoke.py``'s phase-28
checks on the CPU.

Its provenance: its pages are ``tests/data/torch_smoke_fusion.npz``'s; the
store calls, the enhanced crops and the network engines' records recompute
from the JAX package here (OpenCV's IPP off) to the stored ones; the stored
rows and dashboard recompute from the stored JAX fields through JAX's store
and pandas dashboard. (The JAX app's fields themselves come from the bundled
w16 at bf16, which no test here compiles.) Then phase 28's checks pass with
the port on the CPU with OpenCV, Pillow, pandas and JAX blocked: (a) the
stores, (b) the enhancement, (c) the network engines, (d) the app's flow
through ``_build_engine("cpu")`` (every page on JAX's boxes here, so every
field, row and aggregate equal), (e) the CLI's ``app``. Tolerance: none.
"""

import os
import sys

import cv2
import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.app_fixture()


@pytest.fixture
def ipp_off():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.fixture
def blocked(monkeypatch):
    for name in ("cv2", "PIL", "pandas", "plotly", "streamlit", "requests", "supabase",
                 "easyocr"):
        monkeypatch.setitem(sys.modules, name, None)


def test_fixture_layout(fix):
    assert os.path.getsize(chip_smoke.APP_FIXTURE) < 1_000_000
    assert fix["pages"].shape == (4, 640, 440, 3)
    assert len(fix["crops"]) == 12 and fix["app_boxes"].shape == (4, 3, 4)
    assert fix["app_ok"].all()
    assert set(fix["enh"]) == {f"{k}_{p}_{f}" for (p, f) in fix["crops"]
                               for k in chip_smoke.ENHANCE_FNS}
    assert fix["ipp"]["crops"] == 12
    assert len(fix["flow"]["fields"]) == 4 and fix["flow"]["ids"] == [1, 2, 3, 4]
    assert fix["flow"]["dashboard"]["years"] == ["2025", "2024", "2023"]


def test_store_enhancement_and_engines_recompute_with_jax(fix, ipp_off):
    from PIL import Image

    from twinvoice_tpu.config import FusionConfig
    from twinvoice_tpu.fusion.extract import InvoiceExtractor
    from twinvoice_tpu.ocr import enhance
    from twinvoice_tpu.ocr.easyocr_engine import EasyOcrEngine
    from twinvoice_tpu.ocr.ocrspace import OcrSpaceEngine
    from twinvoice_tpu.store.memory import MemoryStore
    from twinvoice_tpu.store.supabase_store import SupabaseStore

    assert chip_smoke.store_record(MemoryStore, SupabaseStore) == fix["store"]
    for (p, f), crop in fix["crops"].items():
        for kind, v in chip_smoke.enhance_outputs(enhance, crop).items():
            assert np.array_equal(v, fix["enh"][f"{kind}_{p}_{f}"]), (kind, p, f)
    transport, reader = chip_smoke.RecordingTransport(), chip_smoke.RecordingReader()
    ex = InvoiceExtractor(
        chip_smoke.CropSegmenter(fix["crops"], fix["pages"], as_crop=Image.fromarray), None,
        [OcrSpaceEngine(api_key=chip_smoke.APP_KEY, transport=transport),
         EasyOcrEngine(reader=reader)], cfg=FusionConfig(use_qr=False, auto_rotate=False))
    got = chip_smoke.net_record(lambda p: ex.extract(Image.fromarray(p)), transport, reader,
                                fix["pages"])
    assert got == fix["net"]


def test_rows_and_dashboard_recompute_from_jax_fields(fix):
    from twinvoice_tpu.app import dashboard as jdash
    from twinvoice_tpu.store.memory import MemoryStore

    store = MemoryStore()
    flow = fix["flow"]
    for rec, cat in zip(flow["fields"], flow["categories"]):
        store.save_invoice(dict(rec["meta"], category=cat), rec["items"])
    assert chip_smoke.plain(store.list_invoices(500)) == flow["rows"]
    assert chip_smoke.dashboard_record(jdash, lambda f: f.to_dict("records"),
                                       store.list_invoices(500),
                                       store.list_items(5000)) == flow["dashboard"]


def test_phase28_checks_on_the_cpu(fix, blocked):
    assert chip_smoke.store_check(fix) > 40
    n, nbytes, _ = chip_smoke.enhance_check(fix)
    assert n == 12 and nbytes == 2 * fix["ipp"]["bytes"]
    assert chip_smoke.network_check(fix) == (12, 12)
    got, other, launches, ext_ms, _ = chip_smoke.app_flow_check(fix, device="cpu",
                                                                expect_k1=False)
    assert other == [] and launches == {} and len(ext_ms) == 4
    assert got["dashboard"] == fix["flow"]["dashboard"]
    assert chip_smoke.cli_app_check()[1:4] == ["-m", "streamlit", "run"]
