"""PyTorch port: the field-fusion card fixture (``tests/data/torch_smoke_fusion.npz``).
Its pages re-render from its script, and ``chip_smoke.py``'s phase-19 checks
pass on the CPU against the JAX extractor's outputs stored there (no JAX runs
in this file): on every route the port's fp32 boxes are JAX's, and
``(meta, items, qr_raw)`` equal JAX's on every page (failures as ``(stage,
error)``); no page needs the QR region pass. Tolerance: none."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke
from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter
from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine
from twinvoice_tpu_torch.qr import detect as qr_detect

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_smoke_fusion.py")
    spec = importlib.util.spec_from_file_location("make_torch_smoke_fusion", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.fusion_fixture()


@pytest.fixture(scope="module")
def parts(fix):
    seg = load_pretrained_segmenter(torch.float32, device="cpu")
    return seg, qr_detect.QrPipeline(), TorchOcrEngine(device="cpu")


def test_fixture_pages_reproduce_from_its_script(fix):
    assert os.path.getsize(chip_smoke.FUSION_FIXTURE) < 1_500_000
    np.testing.assert_array_equal(fix["pages"], _script().render_pages())
    assert fix["pages"].shape == (4, 640, 440, 3)
    from scripts.make_torch_smoke_pages import PAGES

    for route in chip_smoke.FUSION_ROUTES:  # JAX read every invoice number
        assert [r["meta"]["invoice_no"] for r in fix[f"jax_{route}"]] == [
            kw["invoice_no"] for kw in PAGES]


def test_port_boxes_are_jax_boxes(fix, parts):
    same = chip_smoke.fusion_same_boxes(fix, chip_smoke.fusion_boxes(parts[0], fix["pages"]))
    assert all(all(v) for v in same.values()), same


@pytest.mark.parametrize("route", sorted(chip_smoke.FUSION_ROUTES))
def test_route_equals_jax(fix, parts, route):
    qr_detect.passes.clear()
    got = chip_smoke.fusion_run(route, *parts, fix["pages"])
    assert chip_smoke.fusion_check(fix, route, got, [True] * len(got)) == []
    assert got == fix[f"jax_{route}"]
    passes = dict(qr_detect.passes)
    assert passes == ({"gray_0.75": len(got)} if route in ("batch", "single") else {})


def test_routes_check_counts_no_launch_on_the_cpu(fix, parts):
    out = chip_smoke.fusion_routes_check(fix, *parts, expect_k1=False)
    assert {r: (other, n) for r, (_, other, n) in out.items()} == {
        r: ([], {}) for r in chip_smoke.FUSION_ROUTES}
    eq, total = chip_smoke.meta_fields_agree(out["batch"][0], out["single"][0])
    assert eq == total
