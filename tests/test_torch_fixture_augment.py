"""PyTorch port: ``chip_smoke.py``'s phase-29 checks on the CPU, without JAX.

(a) ``perturb_tiers_check`` rebuilds the gauntlet fixture's seven perturbed
tiers with the port's ``perturb_cases``: masks and images byte-equal to the
JAX package's (the fixture is made with OpenCV's own code, IPP off; phase
29 on the card keeps the bound ``chip_smoke.AUG_MAX_SHARE``/``AUG_MAX_DELTA``);
(b) the w16 fp32 route on those cases holds the JAX results stored in the
fixture, as phase 26 holds them on the fixture's own cases; (c)'s batch
timer draws an augmented batch."""

import numpy as np
import pytest

import chip_smoke


@pytest.fixture(scope="module")
def rebuilt():
    fix = chip_smoke.gauntlet_fixture()
    cases, rows = chip_smoke.perturb_tiers_check(fix)
    return fix, cases, rows


def test_perturb_tiers_check(rebuilt):
    fix, cases, rows = rebuilt
    assert [r[0] for r in rows] == [t for t in fix["tiers"] if not t.startswith("clean")]
    assert len(cases) == len(fix["cases"]) == 9
    for got, want, tier in zip(cases, fix["cases"], fix["tiers"]):
        assert np.array_equal(got.mask, want.mask), tier
        assert (got.level, got.invoice_no, got.font) == (want.level, want.invoice_no, want.font)
    for tier, n, size, delta, ms in rows:
        print(f"{tier}: {n}/{size} bytes differ, max |d| {delta}, {ms:.0f} ms on this CPU")
        assert n == 0 and delta == 0, tier


@pytest.mark.parametrize("route", ["w16_fp32"])
def test_routes_on_the_port_cases_hold_jax(rebuilt, route):
    fix, cases, _ = rebuilt
    port = dict(fix, cases=cases)
    seg = chip_smoke.gauntlet_segmenter(route, fix, device="cpu")
    got = chip_smoke.gauntlet_run(seg, port)
    d_iou, px, eq, total = chip_smoke.gauntlet_compare(route, port, got)
    print(f"{route}: {eq}/{total} fields equal, max |dIoU| {d_iou:.3g}, {px} mask pixels")
    assert total == 27 and d_iou <= chip_smoke.GAUNTLET_IOU_TOL[route]


def test_augment_batch_ms():
    rng = np.random.default_rng(0)
    pages = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    masks = np.zeros((4, 64, 64, 3), np.uint8)
    masks[:, 10:30, 10:40] = 255
    assert chip_smoke.augment_batch_ms(pages, masks, reps=2) > 0
