"""PyTorch port, segmenter training on the bundled w16 weights: the fixture
that ``chip_smoke.py`` phase 21 holds the card against
(``tests/data/torch_smoke_train.npz``, made by
``scripts/make_torch_smoke_train.py``) is reproduced here on the CPU, with
phase 21's own checks and tolerances (``chip_smoke.TRAIN_TOLS``)."""

import importlib.util
import os

import numpy as np
import torch

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_smoke_train.py")
    spec = importlib.util.spec_from_file_location("make_torch_smoke_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_pages_and_masks_reproduce_from_the_script():
    assert os.path.getsize(chip_smoke.TRAIN_FIXTURE) < 3_000_000
    fix = chip_smoke.train_fixture()
    pages, masks = _script().render_batch()
    np.testing.assert_array_equal(pages, fix["pages"])
    np.testing.assert_array_equal(masks, fix["masks"])
    assert ((masks > 0).sum(axis=(1, 2)) > 0).all()  # every field has a box


def test_port_reproduces_the_jax_trainers_float32_numbers():
    """3 float32 steps of the port's ``make_train_step`` from the bundled w16
    weights: losses, step-1 gradients, BN statistics, step norms and the
    eval step, each within phase 21's tolerance of JAX's and the exact
    step's."""
    fix = chip_smoke.train_fixture()
    got = chip_smoke.train_run(fix, torch.device("cpu"), "float32")
    assert chip_smoke.train_parity(fix, "fp32", got) == []
