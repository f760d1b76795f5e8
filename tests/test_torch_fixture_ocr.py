"""PyTorch port: the recognition stack's card fixture
(``tests/data/torch_smoke_ocr.npz``). Its crops re-render from its script,
and ``chip_smoke.py``'s phase-17 checks pass on the CPU against the JAX
outputs stored there (no JAX runs in this file): the device half on JAX's
prepared rows, ``read_batch`` under every decode policy, ``detect_lines``
and ``read_page`` on the four pages, and the chained path from the port's
fp32 segmenter. Tolerances are phase 17's (``chip_smoke.OCR_*``)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke
from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter
from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_smoke_ocr.py")
    spec = importlib.util.spec_from_file_location("make_torch_smoke_ocr", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.ocr_fixture()


@pytest.fixture(scope="module")
def pages_fix():
    with np.load(chip_smoke.FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def eng():
    return TorchOcrEngine(device="cpu")


def test_fixture_crops_reproduce_from_its_script(fix):
    assert os.path.getsize(chip_smoke.OCR_FIXTURE) < 1_500_000
    mod = _script()
    fcrops, where = mod.field_crops()
    rcrops, rmodes = mod.rendered_crops()
    crops = fcrops + rcrops
    assert len(fcrops) == 12 and len(rcrops) >= 40 and len(crops) == len(fix["crop_list"])
    for got, want in zip(fix["crop_list"], crops):
        np.testing.assert_array_equal(got, want)
    assert [str(m) for m in fix["crop_modes"]] == [
        mod.FIELD_MODES[j] for _, j in where] + rmodes
    assert {c.ndim for c in crops} == {2, 3}  # gray and RGB crops
    flat, shapes, offsets = mod.pack_crops(crops)
    for a, b in zip(mod.unpack_crops(flat, shapes, offsets), crops):
        np.testing.assert_array_equal(a, b)


def test_device_half_on_jax_rows(fix, eng):
    near, frames, lp_err, conf_err = chip_smoke.ocr_rows_check(fix, eng)
    assert frames == fix["row_ids"].size and near < frames // 100
    assert lp_err <= chip_smoke.OCR_LP_TOL and conf_err <= chip_smoke.OCR_CONF_TOL


def test_read_batch_texts_equal_jax(fix, eng):
    assert chip_smoke.ocr_crops_check(fix, eng) <= chip_smoke.OCR_CONF_TOL


def test_detect_lines_and_read_page_equal_jax(fix, pages_fix, eng):
    counts, n_lines = chip_smoke.ocr_pages_check(pages_fix["pages"], fix, eng)
    assert all(n > 20 for n in counts.values()) and n_lines > 40


def test_chained_path_on_jax_boxes(fix, pages_fix, eng):
    """On the CPU the port's fp32 boxes equal JAX's (test_torch_fixture.py),
    so every field is on JAX's box and reads JAX's text."""
    seg = load_pretrained_segmenter(variant="w16", dtype=torch.float32, device="cpu")
    rows = chip_smoke.ocr_chain(pages_fix, fix, eng, seg)
    assert len(rows) == 12
    for i, field, same_box, text, want in rows:
        assert same_box, (i, field)
        assert text == want, (i, field, text, want)
