"""PyTorch port: the perturbation engine (``data.augment``), the gauntlet's
``perturb_cases`` and ``AugmentedDataset``, held against the JAX package's
(numpy and OpenCV; no JAX compile).

Masks are held byte for byte everywhere. Images are byte-equal wherever no
float32 OpenCV stage runs (the Gaussian blur of a float image, the motion
filter, the cubic blob field of crumple and thermal fade); where one runs,
a float32 value that OpenCV rounds a few ulp otherwise can flip a byte at
the truncation to uint8 (and the JPEG after it can spread it over its
block), so at most 0.5% of the bytes may differ, by at most 16. Each test
prints the worst it measured."""

import dataclasses
import time

import numpy as np
import pytest

from twinvoice_tpu.data import augment as J
from twinvoice_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from twinvoice_tpu.eval import gauntlet as jax_gauntlet
from twinvoice_tpu_torch.config import Config, TrainConfig, UNetConfig
from twinvoice_tpu_torch.data import augment as P
from twinvoice_tpu_torch.data.dataset import ArrayDataset, synthetic_dataset
from twinvoice_tpu_torch.eval import load_cases, perturb_cases
from twinvoice_tpu_torch.train.trainer import fit

FIXTURE = "tests/data/torch_smoke_gauntlet.npz"
MAX_SHARE, MAX_DELTA = 0.005, 16
FLOAT_STAGES = ("blur_sigma", "motion_blur", "halftone", "crumple", "thermal_fade")

H, W = 96, 128
EFFECTS = dict(rotate_deg=7.0, perspective=0.05, scale=0.9, translate=(0.04, -0.03),
               blur_sigma=1.3, motion_blur=9, noise_std=9.0, jpeg_quality=40,
               brightness=0.1, contrast=0.8, gamma=1.4, color_cast=(0.05, -0.04, 0.02),
               shadow=0.5, vignette=0.4, background=True, halftone=0.6, screen_moire=0.4,
               crumple=0.6, thermal_fade=0.6)


def page():
    """A 96×128 checkered page with noise, and its 3-channel field mask."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:H, :W]
    img = np.stack([200 - 60 * ((xx // 9 + yy // 7) % 2) + 10 * c for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 6, (H, W, 3)), 0, 255).astype(np.uint8)
    mask = np.zeros((H, W, 3), np.uint8)
    mask[20:40, 30:90, 0] = 255
    mask[50:70, 10:60, 1] = 255
    mask[75:90, 70:120, 2] = 255
    return img, mask


def image_gap(got, want):
    """→ (share of differing bytes, largest |Δ|)."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return float((d > 0).mean()), int(d.max())


def assert_image_bound(got, want, exact, what):
    share, delta = image_gap(got, want)
    print(f"{what}: {share:.4%} of bytes differ, max |Δ| {delta}"
          f" (bound: {'0' if exact else f'{MAX_SHARE:.1%}, {MAX_DELTA}'})")
    if exact:
        assert delta == 0, what
    else:
        assert share <= MAX_SHARE and delta <= MAX_DELTA, what


@pytest.mark.parametrize("severity", [J.MILD, J.HARD, 0.2])
def test_sample_spec_equal(severity):
    for seed in range(200):
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        assert dataclasses.asdict(P.sample_spec(rp, severity)) == dataclasses.asdict(
            J.sample_spec(rj, severity))
        assert rp.integers(0, 2**62) == rj.integers(0, 2**62)  # the same draws


def run_both(spec_kw, seed, mask):
    img, _ = page()
    sj, sp = J.PerturbSpec(**spec_kw), P.PerturbSpec(**spec_kw)
    out_j = J.apply_spec(img, mask, sj, np.random.default_rng(seed))
    out_p = P.apply_spec(img, mask, sp, np.random.default_rng(seed))
    return out_j, out_p


@pytest.mark.parametrize("effect", sorted(EFFECTS))
def test_apply_spec_each_effect(effect):
    _, mask3 = page()
    kw = {effect: EFFECTS[effect]}
    if effect == "background":
        kw["bg_seed"] = 12345
    for mask in (mask3, mask3[..., 1:2].copy()):
        (ij, mj), (ip, mp) = run_both(kw, 3, mask)
        assert mp.shape == mj.shape and np.array_equal(mp, mj), effect
        assert_image_bound(ip, ij, effect not in FLOAT_STAGES, f"{effect} ({mask.shape[-1]}-ch mask)")


@pytest.mark.parametrize("seed", range(5))
def test_apply_spec_hard_stacks(seed):
    _, mask3 = page()
    spec = J.sample_spec(np.random.default_rng(100 + seed), J.HARD)
    kw = dataclasses.asdict(spec)
    exact = not any(kw[f] for f in FLOAT_STAGES)
    for mask in (mask3, mask3[..., :1].copy()):
        (ij, mj), (ip, mp) = run_both(kw, 100 + seed, mask)
        assert np.array_equal(mp, mj)
        assert_image_bound(ip, ij, exact, f"hard spec {seed} ({mask.shape[-1]}-ch mask)")


def test_perturb_equal():
    img, mask = page()
    for seed in range(6):
        ij, mj = J.perturb(img, mask, np.random.default_rng(seed), J.HARD)
        ip, mp = P.perturb(img, mask, np.random.default_rng(seed), P.HARD)
        assert np.array_equal(mp, mj)
        assert_image_bound(ip, ij, False, f"perturb seed {seed}")


def test_perturb_cases_rebuild_the_fixture():
    """The port's ``perturb_cases(..., seed=7)`` on the fixture's two clean
    bases against its seven perturbed tiers (which the JAX package made)."""
    cases = load_cases(FIXTURE)
    with np.load(FIXTURE) as z:
        tiers = [str(t) for t in z["tiers"]]
    bases = {"": cases[tiers.index("clean")], "+heldoutfont": cases[tiers.index("clean+heldoutfont")]}
    n = 0
    for case, tier in zip(cases, tiers):
        level, _, font = tier.partition("+")
        if level == "clean":
            continue
        t0 = time.perf_counter()
        (got,) = perturb_cases([bases[("+" + font) if font else ""]], level, seed=7)
        ms = (time.perf_counter() - t0) * 1e3
        assert got.level == level and got.invoice_no == case.invoice_no
        assert np.array_equal(got.mask, case.mask), tier
        assert_image_bound(got.image, case.image, False, f"{tier} ({ms:.0f} ms on this CPU)")
        n += 1
    assert n == 7


def test_perturb_cases_levels_match_jax():
    img, mask = page()
    base = jax_gauntlet.GauntletCase(img, mask, "AB12345678", "2024-01-02", 5, font="f")
    for level in ("clean", "mild", "hard", "printscan", "screenshot", "crumple", "thermal"):
        (cj,) = jax_gauntlet.perturb_cases([base], level, seed=3)
        (cp,) = perturb_cases([base], level, seed=3)
        assert cp.level == cj.level and np.array_equal(cp.mask, cj.mask)
        assert_image_bound(cp.image, cj.image, level in ("clean", "screenshot"), f"level {level}")


def four_pages():
    rng = np.random.default_rng(5)
    imgs = rng.integers(60, 200, (4, 64, 64, 3), dtype=np.uint8)
    masks = np.zeros((4, 64, 64, 3), np.uint8)
    for i in range(4):
        for c in range(3):
            y, x = rng.integers(0, 40, 2)
            imgs[i, y:y + 12, x:x + 20] = 240 - 30 * c
            masks[i, y:y + 12, x:x + 20, c] = 255
    return imgs, masks


def test_augmented_dataset_batches_and_split():
    imgs, masks = four_pages()
    dj = J.AugmentedDataset(JaxArrayDataset(imgs, masks), severity=0.6, p_clean=0.3, seed=11)
    dp = P.AugmentedDataset(ArrayDataset(imgs, masks), severity=0.6, p_clean=0.3, seed=11)
    assert len(dp) == len(dj) == 4 and dp.images is imgs and dp.masks is masks
    for epoch in range(3):
        bj = list(dj.batches(2, rng=np.random.default_rng(epoch)))
        bp = list(dp.batches(2, rng=np.random.default_rng(epoch)))
        assert len(bp) == len(bj) == 2
        for (xj, yj), (xp, yp) in zip(bj, bp):
            assert xp.dtype == xj.dtype == np.float32 and np.array_equal(yp, yj)
            assert_image_bound((xp * 255).round().astype(np.uint8),
                               (xj * 255).round().astype(np.uint8), False, f"epoch {epoch} batch")
    (trj, vaj), (trp, vap) = dj.split(0.25, seed=1), dp.split(0.25, seed=1)
    assert isinstance(trp, P.AugmentedDataset) and isinstance(vap, ArrayDataset)
    assert np.array_equal(vap.images, vaj.images) and np.array_equal(trp.images, trj.images)
    for (xj, yj), (xp, yp) in zip(trj.batches(3, rng=np.random.default_rng(9)),
                                  trp.batches(3, rng=np.random.default_rng(9))):
        assert np.array_equal(yp, yj)
        assert_image_bound((xp * 255).round().astype(np.uint8),
                           (xj * 255).round().astype(np.uint8), False, "split train batch")


def test_fit_takes_an_augmented_dataset(tmp_path):
    """``fit`` runs on it unchanged (the trainer calls only ``split`` and
    ``batches``): a w4 U-Net, two epochs at 32² on the CPU."""
    ds = P.AugmentedDataset(synthetic_dataset(n=8, size=32), severity=0.6, p_clean=0.3, seed=2)
    cfg = Config(model=UNetConfig(base_width=4), train=TrainConfig(
        batch_size=4, epochs=2, val_fraction=0.25, checkpoint_dir=str(tmp_path / "ckpt"),
        visualize_dir=str(tmp_path / "vis"), visualize=False))
    state, history = fit(ds, cfg, device="cpu", log=lambda *_: None)
    assert state.epoch == 2 and len(history) == 2
    assert all(np.isfinite(r["loss"]) for r in history)
