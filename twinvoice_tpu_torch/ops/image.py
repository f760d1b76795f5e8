"""On-device image ops (``twinvoice_tpu.ops.image``), NCHW."""

from __future__ import annotations

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


def normalize_uint8(x, dtype=torch.float32):
    """uint8 [0,255] → float [0,1], divided in ``dtype`` as the JAX op does."""
    return x.to(dtype) / 255.0
