"""On-device image ops (``twinvoice_tpu.ops.image``), NCHW."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x, h, w):
    """Bilinear resize of float NCHW to (h, w), half-pixel convention.

    ``jax.image.resize(method="bilinear")`` antialiases when it downscales
    (its triangle kernel widens by the scale factor) and renormalises the
    weights at the border; ``antialias=True`` does both, per axis, so a page
    that shrinks in H and grows in W matches too. Without it a 1080p→512
    resize is off by up to 136 gray levels.
    """
    return F.interpolate(x.to(torch.float32), size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)


def _nearest_index(m: int, n: int) -> np.ndarray:
    """The source row of each of ``n`` outputs from ``m`` inputs, as
    ``jax.image.resize(method="nearest")`` computes it under XLA: the
    half-pixel centre ``(i + 0.5)·m / n`` in float32, with the constant
    ``m·(1/n)`` folded first (XLA turns the division by a constant into a
    product and folds it; at centres that are whole numbers this floors one
    row lower than the exact quotient), floored and clamped as JAX's gather
    clamps. ``F.interpolate(mode="nearest")`` floors ``i·m / n`` instead."""
    step = np.float32(m) * (np.float32(1) / np.float32(n))
    f = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * step
    return np.minimum(np.floor(f).astype(np.int64), m - 1)


def resize_nearest(x, h, w):
    """Nearest resize of NCHW (or CHW) of any dtype to (h, w), the sample
    rule of JAX's (:func:`_nearest_index`; masks). This is the device
    resize; ``ops.host_image.resize_nearest_u8`` is OpenCV's
    ``INTER_NEAREST``, which samples at ``floor(i·m / n)``."""
    for dim, n in ((-2, h), (-1, w)):
        m = x.shape[dim]
        if m != n:
            idx = torch.from_numpy(_nearest_index(m, n)).to(x.device)
            x = x.index_select(dim % x.dim(), idx)
    return x


def normalize_uint8(x, dtype=torch.float32):
    """uint8 [0,255] → float [0,1], divided in ``dtype`` as the JAX op does."""
    return x.to(dtype) / 255.0
