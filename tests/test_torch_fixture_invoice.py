"""PyTorch port: ``chip_smoke.py``'s phase-32 checks on the CPU, without JAX,
Pillow or OpenCV: the invoice fixture (``tests/data/torch_smoke_invoice.npz``,
made by the JAX package on the card's registries) held to the port with its
registries cut to the same bundled faces.

(a) the four pages of ``torch_smoke_pages.npz`` and the first knob-grid
pages (their digests, boxes and the stored pages); (b) the first base case
of each base and the first case of each of the eleven tiers (digests and
content); (c) the w16 fp32 route on the three clean first cases against
JAX's per-case results."""

import numpy as np
import pytest

import chip_smoke

GRID_CALLS = 8


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.invoice_fixture()


def test_registries_are_the_cards(fix):
    assert len(fix["train_registry"]) == 13 and len(fix["heldout_registry"]) == 6
    with chip_smoke.invoice_registries(fix) as paths:
        assert sorted(paths) == sorted(fix["train_registry"] + fix["heldout_registry"])


def test_pages_and_first_grid_calls(fix):
    with np.load(chip_smoke.FIXTURE) as z:
        pages = z["pages"]
    assert chip_smoke.invoice_pages_check(pages) == 4
    with chip_smoke.invoice_registries(fix) as paths:
        assert chip_smoke.invoice_grid_check(fix, paths, calls=GRID_CALLS) == GRID_CALLS


def test_first_cases_of_every_base_and_tier(fix):
    with chip_smoke.invoice_registries(fix):
        cases, tiers, case_ms, pert_ms = chip_smoke.invoice_cases_check(fix, n=1)
    assert tiers == list(dict.fromkeys(fix["tiers"]))
    assert len(cases) == 11 and set(case_ms) == {"std", "heldout", "dot"}
    print(f"{case_ms} ms a base case, {pert_ms:.0f} ms a perturbed case on this CPU")


def test_w16_fp32_route_on_the_clean_cases(fix):
    with chip_smoke.invoice_registries(fix):
        cases, tiers, _, _ = chip_smoke.invoice_cases_check(
            fix, n=1, level_sets=(("clean", "std"), ("clean", "heldout"), ("clean", "dot")))
    idx = [fix["tiers"].index(t) for t in tiers]
    port = {"cases": cases, "tiers": tiers, "int8_scales": fix["int8_scales"]}
    seg = chip_smoke.gauntlet_segmenter("w16_fp32", port, device="cpu")
    got = chip_smoke.gauntlet_run(seg, port)
    held = dict(port, **chip_smoke.invoice_route_fix(fix, "w16_fp32", idx))
    d_iou, px, eq, total = chip_smoke.gauntlet_compare("w16_fp32", held, got)
    print(f"w16_fp32: {eq}/{total} fields with JAX's boxes, max |dIoU| {d_iou:.3g}")
    assert px is None and total == 9 and d_iou <= chip_smoke.GAUNTLET_IOU_TOL["w16_fp32"]
