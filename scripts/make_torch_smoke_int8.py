"""Make ``tests/data/torch_smoke_int8.npz``: the fixture that holds the
PyTorch port's int8 routes against the JAX package on the bundled w16
segmenter.

The four pages of ``tests/data/torch_smoke_pages.npz`` are resized to the
512² grid by the JAX package's own device resize (``ops.image.
resize_bilinear``, then round and clip to uint8, as ``Segmenter._run_from_raw``
does for int8) and serve as the calibration batch and as the pre-resized
input. One JAX int8 ``Segmenter`` (``int8_head="pallas"``, calibrated on that
batch, the grayscale replicated to three channels) runs three routes with the
pages' original size (440×640) as ``orig_sizes``:

- ``xla``: ``segment_batch(..., return_masks=True)``, the route of
  ``int8_head="xla"`` (every int8 masks path takes it);
- ``pallas``: ``return_masks=False``, the fused head (in interpret mode off
  the TPU);
- ``raw``: ``segment_batch(pages, pre_resized=False)`` (device resize).

Stored: ``calib`` (4, 512, 512) uint8; ``scales`` float64, JAX's calibrated
scales in ``twinvoice_tpu_torch.infer.quant.scales_to_array`` order; per
route ``<route>_boxes`` (4, 3, 4) int32 pixel boxes, ``<route>_ok`` (4, 3)
bool, and the grid boxes on the 512² grid ``<route>_grid_boxes`` (4, 3, 4)
int32 / ``<route>_grid_valid`` (4, 3) bool (from the masks; from the fused
head's row/col maxima on the ``pallas`` route).

``chip_smoke.py`` reads it on the card, where JAX is not installed;
``tests/test_torch_fixture_int8.py`` recomputes it.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_int8.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGES = os.path.join(ROOT, "tests", "data", "torch_smoke_pages.npz")
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_int8.npz")
ROUTES = ("xla", "pallas", "raw")


def load_pages() -> np.ndarray:
    """→ (4, 640, 440) uint8 grayscale pages of the slice-1 fixture."""
    with np.load(PAGES) as z:
        return z["pages"]


def calibration_batch(pages: np.ndarray) -> np.ndarray:
    """The JAX device resize of ``pages`` to 512², rounded: (4, 512, 512) uint8."""
    import jax.numpy as jnp

    from twinvoice_tpu.ops.image import resize_bilinear

    x = resize_bilinear(jnp.asarray(pages[..., None], jnp.float32), 512, 512)
    return np.asarray(jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8))[..., 0]


def jax_reference(pages: np.ndarray) -> dict:
    """The JAX package's int8 outputs for ``pages`` (see the module doc)."""
    import jax
    import jax.numpy as jnp

    from twinvoice_tpu.infer.postprocess import (
        bbox_from_probs,
        probability_to_logit_thresholds,
    )
    from twinvoice_tpu.infer import quant
    from twinvoice_tpu.models.pretrained import load_pretrained_segmenter, variant_path
    from twinvoice_tpu.models.unet import fold_unet
    from twinvoice_tpu.ops.pallas_head import bbox_from_rowcol_max
    from twinvoice_tpu.train.checkpoint import load_params_npz
    from twinvoice_tpu_torch.infer.quant import scales_to_array

    calib = calibration_batch(pages)
    rgb = np.repeat(calib[..., None], 3, axis=-1)
    raw = np.repeat(pages[..., None], 3, axis=-1)
    h, w = pages.shape[1:]
    sizes = np.tile(np.asarray([[w, h]], np.int32), (len(pages), 1))
    half = jnp.full((3,), 0.5, jnp.float32)

    def grid(mask):
        gb, gv = jax.vmap(lambda m: bbox_from_probs(m, half))(
            jnp.asarray(mask, jnp.float32))
        return np.asarray(gb, np.int32), np.asarray(gv, bool)

    seg = load_pretrained_segmenter(dtype=jnp.float32, int8_calib=[rgb],
                                    int8_head="pallas")
    # the scales before quantize_unet harmonises some of them
    params, state = load_params_npz(variant_path("w16"), seg.model_cfg)
    folded32 = fold_unet(params, state, cfg=seg.model_cfg)
    out = {"calib": calib,
           "scales": scales_to_array(quant.calibrate(folded32, [rgb]))}

    mask, boxes, ok = seg.segment_batch(rgb, sizes, return_masks=True)
    out["xla_grid_boxes"], out["xla_grid_valid"] = grid(mask)
    out["xla_boxes"], out["xla_ok"] = np.asarray(boxes), np.asarray(ok)

    mask, boxes, ok = seg.segment_batch(raw, pre_resized=False)
    out["raw_grid_boxes"], out["raw_grid_valid"] = grid(mask)
    out["raw_boxes"], out["raw_ok"] = np.asarray(boxes), np.asarray(ok)

    _, boxes, ok = seg.segment_batch(rgb, sizes, return_masks=False)
    out["pallas_boxes"], out["pallas_ok"] = np.asarray(boxes), np.asarray(ok)
    q = seg.qparams
    row_max, col_max = jax.jit(quant.unet_apply_quantized_rowcol_max)(
        q, jnp.asarray(rgb))
    thr_eff = probability_to_logit_thresholds(seg.cfg.thresholds) - q["out"]["bias"]
    gb, gv = bbox_from_rowcol_max(row_max, col_max, thr_eff)
    out["pallas_grid_boxes"], out["pallas_grid_valid"] = (
        np.asarray(gb, np.int32), np.asarray(gv, bool))
    return {k: (np.asarray(v, np.int32) if k.endswith("boxes") else v)
            for k, v in out.items()}


def main():
    sys.path.insert(0, ROOT)
    ref = jax_reference(load_pages())
    np.savez_compressed(OUT, **ref)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    for k, v in ref.items():
        if k not in ("calib",):
            print(k, v.tolist())


if __name__ == "__main__":
    main()
