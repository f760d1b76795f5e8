"""Drop-in convenience API mirroring the reference's entry points
(``twinvoice_tpu.compat``).

Reference users call ``run_unet(pil_img, checkpoint_path)`` (reference
``inference.py:50``) and get ``(masks, crops)``; the reference rebuilds the
model and re-reads the checkpoint on every call. Here the same signature is
backed by a process-level ``Segmenter`` cache keyed on (checkpoint path,
mtime, dtype, device), so the model loads once. Pillow is needed only by
:func:`preprocess` and :func:`run_unet`, which take PIL images, and is not
imported here: they call the image's own methods.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from twinvoice_tpu_torch import resolve_device
from twinvoice_tpu_torch.config import InferConfig, UNetConfig

IMG_SIZE = 512
FIELDS = ["invoice_no", "date", "total_amount"]

_cache_lock = threading.Lock()
_segmenters: Dict[Tuple[str, float, str, str], object] = {}


def load_model(checkpoint_path: str, *, dtype=None, device=None):
    """The reference's ``load_model`` → a ``Segmenter`` (cached).

    A directory is a ``train.checkpoint`` directory (``Segmenter.from_checkpoint``:
    ``save_params``, or ``fit``'s ``best``/``latest``, the port's or the JAX
    package's Orbax ones); a file is a
    reference-schema ``.pth`` (``Segmenter.from_pth``). ``dtype`` defaults to
    float32 (the reference's); ``device=None`` means ``"cuda"``.
    """
    from twinvoice_tpu_torch.infer.pipeline import Segmenter

    dtype = dtype or torch.float32
    device = resolve_device(device)
    mtime = os.path.getmtime(checkpoint_path) if os.path.exists(checkpoint_path) else 0.0
    key = (os.path.abspath(checkpoint_path), mtime, str(dtype), str(device))
    with _cache_lock:
        seg = _segmenters.get(key)
        if seg is None:
            build = (Segmenter.from_checkpoint if os.path.isdir(checkpoint_path)
                     else Segmenter.from_pth)
            seg = build(checkpoint_path, UNetConfig(), InferConfig(), dtype,
                        device=device)
            _segmenters[key] = seg
    return seg


def preprocess(pil_img) -> np.ndarray:
    """The reference's ``preprocess`` (``inference.py:30-44``) in NHWC:
    RGB → 512×512 → float/255 → (1, 512, 512, 3)."""
    img = pil_img.convert("RGB").resize((IMG_SIZE, IMG_SIZE))
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"Invalid image shape: {arr.shape}")
    return arr[None]


def run_unet(pil_img, checkpoint_path: str, *, device=None):
    """The reference's ``run_unet`` (``inference.py:50-129``): →
    ``(masks: dict[field, bool (512,512)], crops: dict[field, PIL|None])``
    with its thresholds, padding and rejections; the model loads once a
    process."""
    return load_model(checkpoint_path, device=device).segment_pil(pil_img)
