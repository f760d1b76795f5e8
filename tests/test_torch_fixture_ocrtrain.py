"""PyTorch port, recognizer and textness-head training against the JAX
trainers' numbers in ``tests/data/torch_smoke_ocrtrain.npz`` (made by
``scripts/make_torch_smoke_ocrtrain.py``), with no JAX: ``chip_smoke.py``
phase 23's own checks and tolerances (``chip_smoke.OCR_TRAIN_TOLS``) with a
CPU device, and phase 24's save-and-serve check of the textness head."""

import os

import numpy as np
import torch

import chip_smoke
from twinvoice_tpu_torch.ocr.torchocr import data as TD
from twinvoice_tpu_torch.ocr.torchocr import textness as TX
from twinvoice_tpu_torch.ocr.torchocr.charset import cjk_charset

CPU = torch.device("cpu")


def test_fixture_holds_the_training_batches():
    assert os.path.getsize(chip_smoke.OCR_TRAIN_FIXTURE) < 2_000_000
    fix = chip_smoke.ocr_train_fixture()
    cs = cjk_charset()
    assert str(fix["charset"]) == cs.chars
    for prefix in ("", "eval_"):
        lines, labels, pad, texts = TD.read_line_npz(chip_smoke.OCR_TRAIN_FIXTURE, prefix)
        assert lines.shape == (64, 32, 256) and lines.dtype == np.uint8
        got_l, got_p, got_t = TD.encode_labels(texts, cs)
        np.testing.assert_array_equal(got_l, labels)
        np.testing.assert_array_equal(got_p, pad)
        assert got_t == texts
    assert fix["pages"].shape == fix["masks"].shape == (8, 256, 256)


def test_port_reproduces_the_jax_recognizer_steps():
    """3 steps of the port's recognizer ``make_train_step`` from the bundled
    weights on batch 0: losses, step-1 gradients, BN statistics and step
    norms within phase 23's tolerance of JAX's and the float64 step's."""
    fix = chip_smoke.ocr_train_fixture()
    got = chip_smoke.ocr_train_run(fix, CPU)
    assert chip_smoke.ocr_train_parity(fix, "rec", got) == []


def test_port_reproduces_the_jax_textness_steps():
    fix = chip_smoke.ocr_train_fixture()
    got = chip_smoke.textness_train_run(fix, CPU)
    np.testing.assert_array_equal(got["labels"], fix["page_labels"])
    assert chip_smoke.ocr_train_parity(fix, "tx", got) == []


def test_bundled_recognizer_reads_the_eval_batch_as_jax():
    fix = chip_smoke.ocr_train_fixture()
    ndiff, _, exact, cer = chip_smoke.ocr_eval_check(fix, CPU)
    assert ndiff == 0 and exact == float(fix["eval_exact"]) and cer == float(fix["eval_cer"])


def test_ctc_loss_on_infeasible_rows_equals_its_plain_version():
    infeasible, loss_err, grad_err = chip_smoke.ctc_infeasible_check(CPU)
    assert infeasible >= 2 and loss_err <= 1e-6 and grad_err <= 1e-3


def test_saved_textness_head_serves_as_the_in_memory_one(tmp_path):
    fix = chip_smoke.ocr_train_fixture()
    params = chip_smoke._copy_to(TX.load_textness(), CPU)
    chip_smoke.textness_save_serve(fix, str(tmp_path), params, CPU)
