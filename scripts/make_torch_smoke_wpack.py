"""Make ``tests/data/torch_smoke_wpack.npz``: the fixture that holds the
PyTorch port's W-phase int8 routes (``int8_wpack``) against the JAX package
on the bundled w16 segmenter.

The input and the calibration batch are those of
``tests/data/torch_smoke_int8.npz`` (``scripts/make_torch_smoke_int8.py``):
the four fixture pages resized to 512² by the JAX device resize, grayscale
replicated to three channels, with the pages' original size (440×640) as
``orig_sizes``. One JAX int8 ``Segmenter`` per value of ``int8_wpack``
("full", "enc", "nhwc"), calibrated on that batch, gives:

- ``<mode>_boxes`` (4, 3, 4) int32 and ``<mode>_ok`` (4, 3) bool from
  ``segment_batch(..., return_masks=False)``, the box-only route;
- ``<mode>_row_max`` (4, 512, 3) and ``<mode>_col_max`` (4, 512, 3) float32,
  the bias-free row/col logit maxima of that route's head
  (``infer.wpack.unet_apply_quantized_{wpack,nhwc}_rowcol_max`` under
  ``jit``);
- ``<mode>_fingerprint`` (4, 16) int64: per page and channel, the sum of the
  route's final int8 activations (unpacked), a fingerprint of the trunk;
- ``nhwc_masks_boxes`` / ``nhwc_masks_ok``: ``int8_wpack="nhwc"`` with
  ``return_masks=True``, which falls back to the "full" logits.

The port's trunks equal JAX's channel sums on all four pages (its epilogues
fuse a multiply and an add where XLA does, ``tests/test_torch_epilogue.py``),
so the card's trunks are held to JAX's sums exactly.

The "nhwc" trunk runs its Pallas kernel (``ops.nhwc_conv.qconv3x3_pair_requant``)
in interpret mode off the TPU, at the JAX package's default row tile
``th=16``. Measured with JAX on an 8-core x86 CPU: about 2 minutes in all;
the "nhwc" route, with its calibration, its box-only call, its features and
maxima in interpret mode at 512² on the four pages and its masks call, 35 to
38 s, against 27 to 55 s for "full" and "enc" (whose first call also pays
the shared compiles).

``chip_smoke.py`` reads it on the card, where JAX is not installed;
``tests/test_torch_fixture_wpack.py`` holds the port's CPU "nhwc" route on the
first page to it without JAX.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_wpack.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT8 = os.path.join(ROOT, "tests", "data", "torch_smoke_int8.npz")
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_wpack.npz")
MODES = ("full", "enc", "nhwc")


def fingerprint(h_nhwc) -> np.ndarray:
    """(B,H,W,C) int8 → (B,C) int64 per-channel sums."""
    return np.asarray(h_nhwc, np.int64).sum(axis=(1, 2))


def jax_reference(calib: np.ndarray, orig_hw) -> dict:
    """The JAX package's W-phase outputs for the 512² ``calib`` pages (see
    the module doc)."""
    import warnings

    import jax
    import jax.numpy as jnp

    from twinvoice_tpu.infer import wpack
    from twinvoice_tpu.models.pretrained import load_pretrained_segmenter

    rgb = np.repeat(calib[..., None], 3, axis=-1)
    h, w = orig_hw
    sizes = np.tile(np.asarray([[w, h]], np.int32), (len(calib), 1))
    imgs = jnp.asarray(rgb)
    out = {}
    for mode in MODES:
        t = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the "nhwc" fallback note
            seg = load_pretrained_segmenter(jnp.float32, int8_calib=[rgb],
                                            int8_wpack=mode)
        q = seg.qparams
        _, boxes, ok = seg.segment_batch(rgb, sizes, return_masks=False)
        out[f"{mode}_boxes"], out[f"{mode}_ok"] = np.asarray(boxes), np.asarray(ok)
        if mode == "nhwc":
            hp, _ = jax.jit(wpack.unet_apply_quantized_features_nhwc)(q, imgs)
            row, col = jax.jit(wpack.unet_apply_quantized_nhwc_rowcol_max)(q, imgs)
            mask, boxes, ok = seg.segment_batch(rgb, sizes, return_masks=True)
            out["nhwc_masks_boxes"] = np.asarray(boxes)
            out["nhwc_masks_ok"] = np.asarray(ok)
        else:
            hp, _ = jax.jit(wpack.unet_apply_quantized_features_wpack,
                            static_argnames="mode")(q, imgs, mode=mode)
            row, col = jax.jit(wpack.unet_apply_quantized_wpack_rowcol_max,
                               static_argnames="mode")(q, imgs, mode=mode)
        c = q["out"]["kernel"].shape[2]  # the final activations' channels
        hp = np.asarray(hp)
        out[f"{mode}_fingerprint"] = fingerprint(hp.reshape(*hp.shape[:2], -1, c))
        out[f"{mode}_row_max"] = np.asarray(row, np.float32)
        out[f"{mode}_col_max"] = np.asarray(col, np.float32)
        print(f"{mode}: {time.perf_counter() - t:.1f} s", flush=True)
    return {k: (np.asarray(v, np.int32) if k.endswith("boxes") else v)
            for k, v in out.items()}


def main():
    sys.path.insert(0, ROOT)
    with np.load(INT8) as z:
        calib = z["calib"]
    with np.load(os.path.join(ROOT, "tests", "data", "torch_smoke_pages.npz")) as z:
        orig_hw = z["pages"].shape[1:]
    ref = jax_reference(calib, orig_hw)
    np.savez_compressed(OUT, **ref)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    for k, v in ref.items():
        if "max" not in k:
            print(k, v.tolist())


if __name__ == "__main__":
    main()
