"""Make ``tests/data/torch_smoke_ocr.npz``: the fixture that holds the PyTorch
port's recognition stack against the JAX package's on the card.

The card's machine has no JAX, Pillow or OpenCV, so this script runs here
(JAX on the CPU, PIL and cv2 to render) and stores the inputs and the JAX
package's outputs. Deterministic: every crop comes from fixed seeds.

Crops (ragged, so stored as one flat uint8 buffer): ``crops`` (total bytes,),
``crop_shapes`` (N, 3) int32 (H, W, C; C = 0 for a grayscale crop),
``crop_offsets`` (N + 1,) int64, ``crop_modes`` (N,) str. The first 12 are
the field crops of ``torch_smoke_pages.npz``'s four pages, cut with its
stored JAX boxes (``field_page``, ``field_slot``; modes invoice, date,
amount); the rest are rendered crops of mixed modes and sizes: lines at
several scales and margins, dot-matrix lines, multi-line stacks, inverted
and low-contrast lines, and RGB field crops of ``render_invoice`` pages.

JAX outputs:
- ``rows_u8`` (R, 32, 256) uint8: ``prepare_crop`` of every crop, then its
  2×2-eroded and 3×3-blurred variants (``_variant_rescue``'s transforms);
  the prepared rows are ``rows_u8 / 255`` in float32, as JAX builds them;
- ``row_ids``, ``row_conf``, ``row_tk_ids``, ``row_tk_lp``, ``row_blank_lp``:
  ``JaxOcrEngine._infer`` on those rows, one batch;
- ``text_<policy>`` (N,) str and ``conf_<policy>`` (N,) float64 (NaN for
  None): ``read_batch(crops, modes)`` under "greedy", "beam_lm" and
  "cascade";
- ``boxes_<method>`` (n, 4) int32 and ``nboxes_<method>`` (4,): the pages'
  ``detect_lines`` boxes, "classical" and "hybrid";
- ``page_boxes`` (m, 4) int32, ``page_counts`` (4,), ``page_texts`` (m,)
  str, ``page_confs`` (m,) float64: ``read_page`` on the four pages.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_ocr.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_ocr.npz")
PAGES = os.path.join(ROOT, "tests", "data", "torch_smoke_pages.npz")

FIELD_MODES = ("invoice", "date", "amount")  # invoice_no, date, total_amount
POLICIES = ("greedy", "beam_lm", "cascade")
METHODS = ("classical", "hybrid")
BLACK_CROP_MEAN = 3.0  # InferConfig.black_crop_mean

# rendered lines: (text, mode, scale, margin, dot-matrix)
LINES = (
    ("AB12345678", "invoice", 1.0, 0, False),
    ("QK-80417265", "invoice", 0.7, 4, False),
    ("ZX00992471", "invoice", 2.0, 16, False),
    ("MN55120093", "invoice", 1.0, 0, True),
    ("2025-09-09", "date", 1.0, 3, False),
    ("2024/12/31", "date", 0.6, 0, False),
    ("2023.07.21", "date", 2.5, 24, False),
    ("2025-03-07", "date", 1.0, 0, True),
    ("4,580", "amount", 1.0, 2, False),
    ("NT$120", "amount", 1.5, 8, False),
    ("12999", "amount", 0.8, 0, False),
    ("36", "amount", 3.0, 30, False),
    ("$1,250", "amount", 1.0, 0, True),
    ("TOTAL 4580", "text", 1.0, 5, False),
    ("CASH 120", "text", 1.2, 0, False),
    ("TEL 02-2345", "text", 1.0, 0, True),
    ("JK-30551846", "invoice", 0.5, 6, False),
    ("2022/11/30", "date", 1.8, 0, True),
    ("7,305", "amount", 0.5, 0, False),
    ("NO. 58", "text", 2.0, 10, False),
)


def _scaled(img, f):
    import cv2

    h, w = img.shape
    return cv2.resize(img, (max(1, int(w * f)), max(1, int(h * f))),
                      interpolation=cv2.INTER_AREA if f < 1 else cv2.INTER_LINEAR)


def _tight(img):
    ys, xs = np.nonzero(img < 200)
    return img[max(0, ys.min() - 2):ys.max() + 3, max(0, xs.min() - 2):xs.max() + 3]


def field_crops():
    """→ (crops, page index, field slot) of the pages fixture's stored boxes."""
    with np.load(PAGES) as z:
        pages, boxes, ok = z["pages"], z["boxes"], z["ok"]
    crops, where = [], []
    for i, page in enumerate(pages):
        for j in range(3):
            x1, y1, x2, y2 = (int(v) for v in boxes[i, j])
            crop = page[y1:y2, x1:x2]
            if ok[i, j] and crop.size and crop.mean() >= BLACK_CROP_MEAN:
                crops.append(crop)
                where.append((i, j))
    return crops, where


def rendered_crops(seed=7):
    """→ (crops, modes): 41 crops of mixed modes and sizes."""
    from twinvoice_tpu.data.synthetic import render_invoice
    from twinvoice_tpu.ocr.jaxocr.data import render_line

    rng = np.random.default_rng(seed)
    crops, modes = [], []
    for text, mode, f, m, dot in LINES:
        line = render_line(text, rng, dot=dot)
        if not dot:
            line = _tight(line)
        crops.append(np.pad(_scaled(line, f), m, constant_values=255))
        modes.append(mode)
    stack = [_scaled(_tight(render_line(t, rng)), 1.6) for t in ("2025-01-02", "5,200", "AB123")]
    w = max(x.shape[1] for x in stack)
    stack = [np.pad(x, ((0, 0), (0, w - x.shape[1])), constant_values=255) for x in stack]
    gap = np.full((12, w), 255, np.uint8)
    for mode in ("amount", "date", "text"):
        crops.append(np.vstack([stack[0], gap, stack[1], gap, stack[2]]))
        modes.append(mode)
    crops.append(np.vstack([stack[1], gap, stack[2]]))
    modes.append("amount")
    line = _tight(render_line("AB12345678", rng))
    crops += [255 - line, (line.astype(np.float32) * 0.15 + 190).astype(np.uint8)]
    modes += ["invoice", "invoice"]
    for seed_inv, dot in ((5, False), (31, True), (8, False), (44, False), (52, True)):
        img, boxes = render_invoice(f"CD{seed_inv:08d}", "2024-05-06", 870 + seed_inv,
                                    seed=seed_inv, dot_print=dot, layout_jitter=0.5)
        rgb = np.asarray(img)
        for field, mode in zip(("invoice_no", "date", "total_amount"), FIELD_MODES):
            x1, y1, x2, y2 = boxes[field]
            crops.append(rgb[max(0, y1 - 4):y2 + 4, max(0, x1 - 4):x2 + 4])
            modes.append(mode)
    return crops, modes


def pack_crops(crops):
    shapes = np.asarray([c.shape if c.ndim == 3 else c.shape + (0,) for c in crops], np.int32)
    offsets = np.zeros(len(crops) + 1, np.int64)
    offsets[1:] = np.cumsum([c.size for c in crops])
    flat = np.concatenate([np.ascontiguousarray(c).ravel() for c in crops])
    return flat.astype(np.uint8), shapes, offsets


def unpack_crops(flat, shapes, offsets):
    """The inverse of :func:`pack_crops` (used by the readers too)."""
    out = []
    for (h, w, c), a, b in zip(shapes, offsets[:-1], offsets[1:]):
        shape = (int(h), int(w)) + ((int(c),) if c else ())
        out.append(flat[a:b].reshape(shape))
    return out


def jax_reference(crops, modes, pages):
    """The JAX package's outputs on the crops and pages (see the module doc)."""
    import cv2
    import jax.numpy as jnp

    from twinvoice_tpu.ocr.jaxocr import detector
    from twinvoice_tpu.ocr.jaxocr.engine import JaxOcrEngine, prepare_crop

    eng = JaxOcrEngine()
    assert eng.available()
    rows = []
    for c in crops:
        base = prepare_crop(c)
        if base is None:
            continue
        u8 = (base * 255.0).astype(np.uint8)
        rows += [u8, cv2.erode(u8, np.ones((2, 2), np.uint8)),
                 cv2.GaussianBlur(u8, (3, 3), 0.8)]
    rows_u8 = np.stack(rows)
    x = rows_u8.astype(np.float32)[..., None] / 255.0
    ids, conf, tk_ids, tk_lp, blank_lp = (
        np.asarray(a) for a in eng._infer(eng._params, eng._state, jnp.asarray(x)))
    out = {"rows_u8": rows_u8, "row_ids": ids.astype(np.int32), "row_conf": conf,
           "row_tk_ids": tk_ids.astype(np.int32), "row_tk_lp": tk_lp,
           "row_blank_lp": blank_lp}
    for policy in POLICIES:
        eng.decode = policy
        res = eng.read_batch(crops, modes=modes)
        out[f"text_{policy}"] = np.asarray([r.text for r in res], dtype=np.str_)
        out[f"conf_{policy}"] = np.asarray(
            [np.nan if r.confidence is None else r.confidence for r in res], np.float64)
    eng.decode = "cascade"
    for method in METHODS:
        per = [detector.detect_lines(p, method=method) for p in pages]
        out[f"boxes_{method}"] = np.asarray([b for bs in per for b in bs], np.int32).reshape(-1, 4)
        out[f"nboxes_{method}"] = np.asarray([len(bs) for bs in per], np.int32)
    read = [detector.read_page(p, eng) for p in pages]
    out["page_boxes"] = np.asarray([b for r in read for b, _ in r], np.int32).reshape(-1, 4)
    out["page_counts"] = np.asarray([len(r) for r in read], np.int32)
    out["page_texts"] = np.asarray([x.text for r in read for _, x in r], dtype=np.str_)
    out["page_confs"] = np.asarray([x.confidence for r in read for _, x in r], np.float64)
    return out


def build():
    """→ the fixture's arrays."""
    fcrops, where = field_crops()
    rcrops, rmodes = rendered_crops()
    crops = fcrops + rcrops
    modes = [FIELD_MODES[j] for _, j in where] + rmodes
    with np.load(PAGES) as z:
        pages = z["pages"]
    flat, shapes, offsets = pack_crops(crops)
    out = {"crops": flat, "crop_shapes": shapes, "crop_offsets": offsets,
           "crop_modes": np.asarray(modes, dtype=np.str_),
           "field_page": np.asarray([i for i, _ in where], np.int32),
           "field_slot": np.asarray([j for _, j in where], np.int32)}
    out.update(jax_reference(crops, modes, pages))
    return out


def main():
    sys.path.insert(0, ROOT)
    out = build()
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): {len(out['crop_modes'])} crops, "
          f"{len(out['rows_u8'])} rows")
    for policy in POLICIES:
        print(policy, out[f"text_{policy}"].tolist())
    print("pages", out["page_texts"].tolist())


if __name__ == "__main__":
    main()
