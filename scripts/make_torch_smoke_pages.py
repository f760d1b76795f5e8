"""Make ``tests/data/torch_smoke_pages.npz``: the fixture that holds the
PyTorch port against the JAX package on the bundled w16 segmenter.

It renders four synthetic invoice pages (``data.synthetic.render_invoice``,
fixed seeds, 440×640, stored as grayscale) and runs them through the JAX
package's fp32 ``Segmenter.segment_batch(pre_resized=False)`` with the
grayscale replicated to three channels. Stored:

- ``pages``      (4, 640, 440) uint8
- ``boxes``      (4, 3, 4) int32, original-pixel boxes; ``ok`` (4, 3) bool
- ``grid_boxes`` (4, 3, 4) int32, inclusive boxes of the returned 512² masks
  on the model grid; ``grid_valid`` (4, 3) bool

``chip_smoke.py`` reads it on the card, where neither JAX nor Pillow is
installed; ``tests/test_torch_fixture.py`` re-renders and recomputes it.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_pages.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_pages.npz")

# render_invoice arguments per page: content, seed, layout jitter
PAGES = (
    dict(invoice_no="AB12345678", date_iso="2025-09-09", amount=120, seed=11),
    dict(invoice_no="QK80417265", date_iso="2024-12-31", amount=4580, seed=12,
         layout_jitter=0.5),
    dict(invoice_no="ZX00992471", date_iso="2025-03-07", amount=36, seed=13,
         layout_jitter=1.0),
    dict(invoice_no="MN55120093", date_iso="2023-07-21", amount=12999, seed=14,
         layout_jitter=0.5, stylize=0.5),
)


def render_pages() -> np.ndarray:
    """→ (4, 640, 440) uint8 grayscale pages."""
    from twinvoice_tpu.data.synthetic import render_invoice

    return np.stack([np.asarray(render_invoice(**kw)[0].convert("L"))
                     for kw in PAGES])


def jax_reference(pages: np.ndarray) -> dict:
    """The JAX package's fp32 outputs for ``pages`` (see the module doc)."""
    import jax
    import jax.numpy as jnp

    from twinvoice_tpu.infer.postprocess import bbox_from_probs
    from twinvoice_tpu.models.pretrained import load_pretrained_segmenter

    seg = load_pretrained_segmenter(dtype=jnp.float32)
    rgb = np.repeat(pages[..., None], 3, axis=-1)
    mask, boxes, ok = seg.segment_batch(rgb, pre_resized=False)
    half = jnp.full((3,), 0.5, jnp.float32)
    gboxes, gvalid = jax.vmap(lambda m: bbox_from_probs(m, half))(
        jnp.asarray(mask, jnp.float32))
    return {
        "boxes": np.asarray(boxes, np.int32),
        "ok": np.asarray(ok, bool),
        "grid_boxes": np.asarray(gboxes, np.int32),
        "grid_valid": np.asarray(gvalid, bool),
    }


def main():
    sys.path.insert(0, ROOT)
    pages = render_pages()
    ref = jax_reference(pages)
    np.savez_compressed(OUT, pages=pages, **ref)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    for k, v in ref.items():
        print(k, v.tolist())


if __name__ == "__main__":
    main()
