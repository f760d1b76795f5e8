"""PyTorch port, the JAX package's Orbax checkpoints: the committed
directories that ``chip_smoke.py`` phase 33 reads on the card
(``tests/data/torch_smoke_orbax/``, with ``tests/data/torch_smoke_orbax.npz``,
both made by ``scripts/make_torch_smoke_orbax.py``) are read here on the CPU
with phase 33's own checks: every leaf bit-equal to orbax's restore, the
resumed train state exact and its next step within phase 21's fp32
tolerances of JAX's and the float64 step's, and ``fit`` resuming at the saved
epoch. The port imports none of JAX, orbax, TensorStore or zstandard for it
(``tests/test_torch_imports.py`` reads a directory with them blocked)."""

import os

import torch

import chip_smoke


def test_fixture_directories_are_small_and_whole():
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(chip_smoke.ORBAX_DIR) for f in fs)
    assert total < 14_000_000 and os.path.getsize(chip_smoke.ORBAX_FIXTURE) < 500_000
    for name in chip_smoke.ORBAX_DIRS.values():
        assert os.path.isfile(os.path.join(chip_smoke.ORBAX_DIR, name, "manifest.ocdbt"))


def test_directories_read_as_orbax_restores_them():
    fix = chip_smoke.orbax_fixture()
    ms, trees = chip_smoke.orbax_read_check(fix)
    assert set(ms) == {"w16", "w8"}
    assert trees["w8"]["meta"] == {"epoch": 2, "best_loss": float(fix["best_loss"])}


def test_resumed_state_and_step_match_jax():
    fix = chip_smoke.orbax_fixture()
    _, trees = chip_smoke.orbax_read_check(fix)
    _, loss, line = chip_smoke.orbax_resume_check(fix, trees["w8"], torch.device("cpu"))
    print(line)
    assert abs(loss - float(fix["exact_loss"])) <= 1e-4 * float(fix["exact_loss"])


def test_fit_resumes_at_the_saved_epoch(tmp_path):
    fix = chip_smoke.orbax_fixture()
    history = chip_smoke.orbax_fit_check(fix, "cpu", str(tmp_path))
    assert [h["epoch"] for h in history] == [3]
