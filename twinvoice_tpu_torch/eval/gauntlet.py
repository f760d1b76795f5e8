"""The perturbation gauntlet (``twinvoice_tpu.eval.gauntlet``): the quality
a segmenter and the whole extractor keep on held-out invoices, held-out
fonts and photographic perturbations.

Two measurements, the JAX package's formulas:

- segmenter: per-field IoU at the model grid and the box-hit rate (the
  padded predicted box covers ≥ 70% of the ground-truth text box), from one
  ``segment_batch`` call of the cases resized to the grid;
- end to end: the extractor's field exactness on the perturbed photos.

Everything is made here, without Pillow, FreeType or OpenCV:
:func:`make_base_cases` renders the held-out invoices with
``data.synthetic.render_invoice`` on the training fonts, the held-out fonts
or through the dot-matrix printhead, and :func:`perturb_cases` runs the
perturbation engine (``data.augment``, numpy) on them; one seed gives the
JAX package's cases byte for byte. The resizes are numpy, bit-equal to
OpenCV's (``ops.host_image``), and the extractor takes the uint8 page
arrays. Cases also travel as files (:func:`save_cases`/:func:`load_cases`,
an npz of uint8 arrays).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from twinvoice_tpu_torch import FIELDS
from twinvoice_tpu_torch.data import augment, synthetic
from twinvoice_tpu_torch.data.augment import boxes_from_mask
from twinvoice_tpu_torch.ops.host_image import resize_linear_u8, resize_nearest_u8

# severity per named level; None = untouched
LEVELS: Dict[str, Optional[float]] = {"clean": None, "mild": 0.35, "hard": 1.0}

# real-photo scenario tiers: each applies one degradation family at
# representative strength over a light photographic base
SCENARIOS = ("printscan", "screenshot", "crumple", "thermal")


def _scenario_spec(name: str, rng):
    spec = augment.sample_spec(rng, 0.2)  # light base photography
    spec.background = False               # isolate the scenario effect
    if name == "printscan":
        spec.halftone = float(rng.uniform(0.5, 0.8))
        spec.halftone_cell = float(rng.uniform(2.4, 4.0))
    elif name == "screenshot":
        spec.screen_moire = float(rng.uniform(0.35, 0.6))
    elif name == "crumple":
        spec.crumple = float(rng.uniform(0.55, 0.95))
    elif name == "thermal":
        spec.thermal_fade = float(rng.uniform(0.5, 0.85))
    else:
        raise KeyError(name)
    return spec

# content seeds are offset far away from the training generator's seed space
HELDOUT_SEED_BASE = 777_000


@dataclass
class GauntletCase:
    image: np.ndarray          # uint8 (H, W, 3), native resolution
    mask: np.ndarray           # uint8 (H, W, 3) 0/255, native resolution
    invoice_no: str
    date: str
    amount: int
    level: str = "clean"
    font: str = ""


def _random_content(rng):
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    inv_no = "".join(rng.choice(list(letters), 2)) + "".join(
        rng.choice(list("0123456789"), 8)
    )
    date = f"{rng.integers(2019, 2031)}-{rng.integers(1, 13):02d}-{rng.integers(1, 29):02d}"
    amount = int(rng.integers(1, 99999))
    return inv_no, date, amount


def make_base_cases(
    n: int,
    *,
    seed: int = HELDOUT_SEED_BASE,
    use_heldout_fonts: bool = False,
    layout_jitter: float = 0.6,
    items: Optional[List[dict]] = None,
    dot_print: bool = False,
) -> List[GauntletCase]:
    """Render n held-out invoices at native resolution (no perturbation):
    random content and page size, a font drawn from the training or the
    held-out registry, the field masks from the ground-truth boxes.
    ``dot_print`` renders the text through the dot-matrix printhead (the
    physical TW invoice medium). The font drawn depends on the registry's
    length, so the cases are JAX's where the registries hold the same
    faces."""
    rng = np.random.default_rng(seed)
    fonts = synthetic.heldout_fonts() if use_heldout_fonts else synthetic.train_fonts()
    cases = []
    for i in range(n):
        inv_no, date, amount = _random_content(rng)
        w = int(rng.integers(360, 560))
        h = int(rng.integers(560, 760))
        font = fonts[int(rng.integers(0, len(fonts)))]
        img, boxes = synthetic.render_invoice(
            inv_no, date, amount,
            items=items or [{"name": "測試品項", "qty": 1, "price": amount}],
            size=(w, h), seed=seed + i,
            font_path=font, font_size=int(rng.integers(18, 27)),
            layout_jitter=layout_jitter, dot_print=dot_print,
        )
        arr = img.array
        mask = np.zeros((h, w, 3), np.uint8)
        for c, f in enumerate(FIELDS):
            x1, y1, x2, y2 = boxes[f]
            mask[y1 : y2 + 1, x1 : x2 + 1, c] = 255
        cases.append(GauntletCase(arr, mask, inv_no, date, amount,
                                  font=font.rsplit("/", 1)[-1]))
    return cases


def perturb_cases(
    cases: Sequence[GauntletCase], level: str, seed: int = 0
) -> List[GauntletCase]:
    """Apply one named perturbation level or scenario to every case (native
    resolution). Levels are severity presets; scenarios (:data:`SCENARIOS`)
    apply one real-photo degradation family at representative strength.
    One seed gives the JAX package's cases byte for byte."""
    if level in SCENARIOS:
        rng = np.random.default_rng(seed + sum(map(ord, level)))
        out = []
        for c in cases:
            img, mask = augment.apply_spec(
                c.image, c.mask, _scenario_spec(level, rng), rng
            )
            out.append(replace(c, image=img, mask=mask, level=level))
        return out
    sev = LEVELS[level]
    if sev is None:
        return [replace(c, level="clean") for c in cases]
    rng = np.random.default_rng(seed + int(sev * 1000))
    out = []
    for c in cases:
        img, mask = augment.perturb(c.image, c.mask, rng, sev)
        out.append(replace(c, image=img, mask=mask, level=level))
    return out


def _resize_case(c: GauntletCase, size: int):
    """The case at the model grid: the image as OpenCV's INTER_LINEAR, the
    mask as its INTER_NEAREST."""
    img = resize_linear_u8(c.image, size, size)
    mask = resize_nearest_u8(c.mask, size, size)
    return img, mask


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array → a numpy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _case_scores(cases, gts, pred, boxes, ok):
    """Per case and field: the IoU at the grid and the box hit. ``gts``,
    ``pred``: (N, S, S, 3) bool; ``boxes`` (N, 3, 4), ``ok`` (N, 3) at the
    original size. → (iou (N, 3) float64, hits (N, 3) bool)."""
    inter = (pred & gts).sum((1, 2)).astype(np.float64)
    union = (pred | gts).sum((1, 2)).astype(np.float64)
    iou = inter / np.maximum(union, 1.0)

    hits = np.zeros((len(cases), 3), bool)
    for i, c in enumerate(cases):
        gt_boxes = boxes_from_mask(c.mask)  # native-res GT
        for f in range(3):
            if f not in gt_boxes:
                hits[i, f] = not ok[i, f]  # field gone: None is right
                continue
            if not ok[i, f]:
                continue
            gx1, gy1, gx2, gy2 = gt_boxes[f]
            px1, py1, px2, py2 = boxes[i, f]
            ix1, iy1 = max(gx1, px1), max(gy1, py1)
            ix2, iy2 = min(gx2, px2), min(gy2, py2)
            inter_a = max(0, ix2 - ix1) * max(0, iy2 - iy1)
            gt_a = max(1, (gx2 - gx1) * (gy2 - gy1))
            hits[i, f] = inter_a / gt_a >= 0.7
    return iou, hits


def run_segmenter_gauntlet(segmenter, cases: Sequence[GauntletCase]) -> dict:
    """Per-field IoU (at the model grid) + box-hit rate for one case list.

    box-hit: the model's padded predicted box (the ``Segmenter``'s scale/pad
    output) covers ≥ 70% of the ground-truth text box area, i.e. the OCR
    crop would contain the field. The segmenter's outputs come back from its
    device with ``.cpu()``.
    """
    size = segmenter.cfg.img_size
    imgs = np.zeros((len(cases), size, size, 3), np.uint8)
    gts = np.zeros((len(cases), size, size, 3), bool)
    sizes = np.zeros((len(cases), 2), np.int32)
    for i, c in enumerate(cases):
        img, mask = _resize_case(c, size)
        imgs[i], gts[i] = img, mask > 127
        sizes[i] = (c.image.shape[1], c.image.shape[0])  # (ow, oh)

    pred, boxes, ok = segmenter.segment_batch(imgs, sizes)
    iou, hits = _case_scores(cases, gts, _host(pred), _host(boxes), _host(ok))
    return {
        "n": len(cases),
        "iou": iou.mean(0).tolist(),
        "iou_mean": float(iou.mean()),
        "box_hit": hits.mean(0).tolist(),
        "box_hit_mean": float(hits.mean()),
    }


def run_e2e_gauntlet(extractor, cases: Sequence[GauntletCase]) -> dict:
    """Full-pipeline field exactness on perturbed photos; the extractor
    (``fusion.extract.InvoiceExtractor``) reads each case's uint8 page."""
    hits = {"invoice_no": 0, "date": 0, "amount": 0}
    for c in cases:
        extractor.clear_cache()
        meta, items, _ = extractor.extract(c.image)
        hits["invoice_no"] += meta.get("invoice_no") == c.invoice_no
        hits["date"] += meta.get("date") == c.date
        hits["amount"] += meta.get("total_amount") == str(c.amount)
    n = max(len(cases), 1)
    return {
        "n": len(cases),
        "invoice_no_acc": hits["invoice_no"] / n,
        "date_acc": hits["date"] / n,
        "amount_acc": hits["amount"] / n,
    }


# ------------------------------------------------------------- case files

_TEXT_FIELDS = ("invoice_no", "date", "amount", "level", "font")


def save_cases(path, cases: Sequence[GauntletCase], **extra):
    """Write cases to a compressed npz: each case's image and mask under
    ``case{i}_image``/``case{i}_mask`` (a mask of 0s and 255s as packed
    bits), the text fields as one JSON string under ``cases``. ``extra``
    arrays are stored beside them under their own names (results to hold a
    run to); :func:`load_cases` ignores them."""
    arrays, meta = {}, []
    for i, c in enumerate(cases):
        arrays[f"case{i}_image"] = np.asarray(c.image, np.uint8)
        mask = np.asarray(c.mask, np.uint8)
        binary = bool(np.isin(mask, (0, 255)).all())
        arrays[f"case{i}_mask"] = np.packbits(mask == 255) if binary else mask
        meta.append({**{f: getattr(c, f) for f in _TEXT_FIELDS},
                     "mask_shape": list(mask.shape) if binary else None})
    clash = set(extra) & set(arrays)
    if clash:
        raise ValueError(f"extra arrays clash with the cases' keys: {sorted(clash)}")
    np.savez_compressed(path, cases=np.asarray(json.dumps(meta, ensure_ascii=False)),
                        **arrays, **extra)


def load_cases(path) -> List[GauntletCase]:
    """The cases of a :func:`save_cases` file, equal to those written."""
    with np.load(path) as z:
        out = []
        for i, m in enumerate(json.loads(str(z["cases"]))):
            mask = z[f"case{i}_mask"]
            if m["mask_shape"] is not None:
                shape = tuple(m["mask_shape"])
                bits = np.unpackbits(mask, count=int(np.prod(shape)))
                mask = (bits.reshape(shape) * np.uint8(255)).astype(np.uint8)
            out.append(GauntletCase(z[f"case{i}_image"], mask,
                                    **{f: m[f] for f in _TEXT_FIELDS}))
    return out
