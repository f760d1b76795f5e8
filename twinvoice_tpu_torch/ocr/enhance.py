"""Crop enhancement ahead of OCR: the port of ``twinvoice_tpu/ocr/enhance.py``
without OpenCV.

The recipe (reference app_camera.py:572-598): 4× cubic upscale → 3×3
sharpen → CLAHE(4.0, 8×8); then Otsu binarization for *text* fields
(invoice number / date — thin strokes) but **never** for the *amount* field
(thick strokes, binarization destroys them). Each OpenCV call of the JAX
module is its ``ops.host_image`` counterpart, byte for byte equal to
OpenCV's own code (``cv2.ipp.setUseIPP(False)``): the gray conversion,
INTER_CUBIC, ``filter2D``, CLAHE, Otsu and the YCrCb conversions.
"""

from __future__ import annotations

import numpy as np

from twinvoice_tpu_torch.ops.host_image import (
    clahe_u8,
    filter2d_3x3_u8,
    otsu_threshold,
    resize_cubic_u8,
    rgb_to_gray,
    rgb_to_ycrcb_u8,
    ycrcb_to_rgb_u8,
)

_SHARPEN = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], np.float32)


def _to_rgb_array(image) -> np.ndarray:
    """A PIL image (or ``host_image.PilPixels``) through its own
    ``convert("RGB")``; an array as it is."""
    if hasattr(image, "convert"):
        return np.asarray(image.convert("RGB"))
    return np.asarray(image)


def _gray(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)``, which takes 3 or 4
    channels of uint8 and rejects anything else."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(f"an RGB(A) uint8 image, got {rgb.dtype} {rgb.shape}")
    if rgb.size == 0:
        raise ValueError(f"an empty image {rgb.shape}")
    return rgb_to_gray(rgb[..., :3])


def enhance_for_ocr(image, mode: str = "text", upscale: int = 4) -> np.ndarray:
    """Returns a uint8 grayscale array ready for an OCR engine."""
    gray = _gray(_to_rgb_array(image))
    gray = resize_cubic_u8(gray, fx=upscale, fy=upscale)
    gray = filter2d_3x3_u8(gray, _SHARPEN)
    gray = clahe_u8(gray, 4.0, (8, 8))
    if mode != "amount":  # text-like modes (text/invoice/date) get Otsu
        _, gray = otsu_threshold(gray)
    return gray


def grayscale_for_ocr(image) -> np.ndarray:
    """Plain grayscale prep (the reference's EasyOCR prep, app_camera.py:817-822)."""
    return _gray(_to_rgb_array(image))


def enhance_camera(image) -> np.ndarray:
    """Camera-frame enhancement that doesn't damage QR codes: CLAHE on the
    luma channel only (YCrCb), leaving chroma and high-frequency detail
    intact (reference app_camera.py:881-911). Returns RGB uint8."""
    rgb = _to_rgb_array(image)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.size == 0:
        raise ValueError(f"an RGB uint8 image, got {rgb.dtype} {rgb.shape}")
    ycrcb = rgb_to_ycrcb_u8(rgb)
    ycrcb[..., 0] = clahe_u8(np.ascontiguousarray(ycrcb[..., 0]), 2.0, (8, 8))
    return ycrcb_to_rgb_u8(ycrcb)
