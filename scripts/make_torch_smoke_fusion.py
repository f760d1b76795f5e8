"""Make ``tests/data/torch_smoke_fusion.npz``: the fixture that holds the
PyTorch port's field fusion and QR pipeline against the JAX package's on the
card (``chip_smoke.py`` phase 19).

It renders the four invoices of ``make_torch_smoke_pages.py`` in RGB and
runs the JAX ``InvoiceExtractor`` on them with the bundled fp32 w16
segmenter, the default ``QrPipeline()`` and ``JaxOcrEngine()``, on each
route of ``chip_smoke.FUSION_ROUTES``:

- ``batch``: ``extract_batch`` under the default ``FusionConfig()`` (QR on,
  ``gray_h2d``, ``h2d_chunks=2``);
- ``batch_noqr``: ``extract_batch`` with ``use_qr=False``;
- ``single``: ``extract`` on each page;
- ``fallback``: ``extract`` with ``use_qr=False`` and a segmenter that finds
  no field (``chip_smoke.NoFieldSegmenter``), so the full-page read runs.

Stored:

- ``pages``  (4, 640, 440, 3) uint8 RGB
- ``boxes_batch`` (4, 3, 4) int32, ``ok_batch`` (4, 3) bool: the boxes of
  ``extract_batch``'s segmenter calls (the OpenCV gray INTER_AREA prep, two
  chunks of two)
- ``boxes_single``, ``ok_single``: those of ``extract``'s ``segment_pil``
  (Pillow's bicubic resize)
- ``jax_<route>``: a JSON string, per page ``chip_smoke.fusion_record`` of
  the route's ``(meta, items, qr_raw)`` (failures as ``[stage, error]``)

It asserts, for every page, that the default ``QrPipeline()`` and
``QrPipeline(decoders=[native_decode])`` give equal payloads and that the
scan never reached the region pass (``detect_qr_regions``): the port's QR
pipeline, which has no OpenCV on the card, must not need it.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_fusion.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_fusion.npz")


def render_pages() -> np.ndarray:
    """→ (4, 640, 440, 3) uint8 RGB pages."""
    sys.path.insert(0, ROOT)
    from scripts.make_torch_smoke_pages import PAGES
    from twinvoice_tpu.data.synthetic import render_invoice

    return np.stack([np.asarray(render_invoice(**kw)[0].convert("RGB"))
                     for kw in PAGES])


def check_qr(pages):
    """The default QrPipeline and the native decoder alone agree on every
    page, and no scan reaches the region pass. → the payloads."""
    import twinvoice_tpu.qr.detect as jdetect

    calls = []
    located = jdetect.detect_qr_regions
    jdetect.detect_qr_regions = lambda rgb: calls.append(1) or located(rgb)
    try:
        out = []
        for i, page in enumerate(pages):
            full = jdetect.QrPipeline().scan(page)
            alone = jdetect.QrPipeline(decoders=[jdetect.native_decode]).scan(page)
            if full != alone or len(full) != 2:
                raise AssertionError(f"page {i}: default {full} != native alone {alone}")
            out.append(full)
    finally:
        jdetect.detect_qr_regions = located
    if calls:
        raise AssertionError(f"the region pass ran {len(calls)} times")
    return out


def jax_boxes(seg, pages):
    """The boxes of the JAX extractor's segmenter calls: extract_batch's
    (gray INTER_AREA prep, chunks as ``np.linspace`` splits them) and
    extract's (``segment_pil``'s Pillow resize)."""
    import cv2
    import jax.numpy as jnp
    from PIL import Image

    from twinvoice_tpu.config import FusionConfig

    size = seg.cfg.img_size
    sizes = np.asarray([(p.shape[1], p.shape[0]) for p in pages], np.int32)
    bounds = np.linspace(0, len(pages), FusionConfig().h2d_chunks + 1).astype(int)
    boxes, ok = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        gray = np.stack([cv2.resize(cv2.cvtColor(p, cv2.COLOR_RGB2GRAY), (size, size),
                                    interpolation=cv2.INTER_AREA) for p in pages[a:b]])
        _, bx, o = seg._run_gray(seg._serve_params, jnp.asarray(gray),
                                 jnp.asarray(sizes[a:b]), return_masks=False)
        boxes.append(np.asarray(bx))
        ok.append(np.asarray(o))
    single = []
    for p, sz in zip(pages, sizes):
        small = np.asarray(Image.fromarray(p).resize((size, size)), np.uint8)[None]
        _, bx, o = seg._run(seg._serve_params, jnp.asarray(small), jnp.asarray(sz[None]))
        single.append((np.asarray(bx)[0], np.asarray(o)[0]))
    return {
        "boxes_batch": np.concatenate(boxes).astype(np.int32),
        "ok_batch": np.concatenate(ok).astype(bool),
        "boxes_single": np.stack([b for b, _ in single]).astype(np.int32),
        "ok_single": np.stack([o for _, o in single]).astype(bool),
    }


def jax_routes(seg, pages) -> dict:
    """Each route's records (module doc) as JSON strings."""
    from PIL import Image

    from chip_smoke import FUSION_ROUTES, NoFieldSegmenter, fusion_record
    from twinvoice_tpu.config import FusionConfig
    from twinvoice_tpu.fusion.extract import InvoiceExtractor
    from twinvoice_tpu.ocr.jaxocr.engine import JaxOcrEngine
    from twinvoice_tpu.qr.detect import QrPipeline

    imgs = [Image.fromarray(p) for p in pages]
    eng = JaxOcrEngine()
    out = {}
    for route, kw in FUSION_ROUTES.items():
        ex = InvoiceExtractor(NoFieldSegmenter() if route == "fallback" else seg,
                              QrPipeline(), [eng], cfg=FusionConfig(**kw))
        res = (ex.extract_batch(imgs) if route.startswith("batch")
               else [ex.extract(im) for im in imgs])
        out[f"jax_{route}"] = np.asarray(json.dumps(
            [fusion_record(*r) for r in res], ensure_ascii=False))
    return out


def main():
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp

    from twinvoice_tpu.models.pretrained import load_pretrained_segmenter

    pages = render_pages()
    payloads = check_qr(pages)
    seg = load_pretrained_segmenter(dtype=jnp.float32)
    boxes = jax_boxes(seg, pages)
    routes = jax_routes(seg, pages)
    np.savez_compressed(OUT, pages=pages, **boxes, **routes)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    print("payloads", payloads)
    for k, v in boxes.items():
        print(k, v.tolist())
    for k, v in routes.items():
        print(k, str(v))


if __name__ == "__main__":
    main()
