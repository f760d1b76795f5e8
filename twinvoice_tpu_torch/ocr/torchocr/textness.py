"""The learned textness head: the port of the inference half of
``twinvoice_tpu/ocr/jaxocr/textness.py``.

A stride-4 fully-convolutional logit map (~33 k parameters): four 3×3
convs with ReLU, the first two of stride 2, and a 1×1 head. The bundled
weights (``twinvoice_tpu/ocr/jaxocr/textness.npz``) are read where they lie
with numpy. Training and its page renderer stay in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from twinvoice_tpu_torch import resolve_device
from twinvoice_tpu_torch.ops.host_image import resize_nearest
from twinvoice_tpu_torch.weights import _conv

DEFAULT_TEXTNESS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "twinvoice_tpu", "ocr", "jaxocr", "textness.npz",
)

_WIDTHS = (16, 32, 48, 32)  # conv ladder; first two stride 2
STRIDE = 4
PAGE_BUCKET = 64  # pages are white-padded to multiples of this


def _layer_shapes():
    shapes, cin = [], 1
    for co in _WIDTHS:
        shapes.append((3, 3, cin, co))
        cin = co
    shapes.append((1, 1, cin, 1))
    return shapes


def textness_params_from_jax(params):
    """JAX ``init_textness`` params, a list of ``{"kernel": HWIO, "bias"}``
    as numpy arrays → the port's list of ``{"weight": OIHW, "bias"}`` float32
    tensors on the CPU."""
    return [_conv({k: np.asarray(v, np.float32) for k, v in p.items()}) for p in params]


def load_textness(path: Optional[str] = None):
    """→ the port's params on the CPU, or None when no weights file exists.

    The file holds leaves ``l0…l9`` in ``jax.tree.leaves`` order, which sorts
    each layer's keys: ``bias`` (even ``l``) then ``kernel`` (odd ``l``)."""
    path = path or DEFAULT_TEXTNESS_PATH
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        layers = [{"bias": z[f"l{2 * i}"], "kernel": z[f"l{2 * i + 1}"]}
                  for i in range(len(_WIDTHS) + 1)]
    for layer, shape in zip(layers, _layer_shapes()):
        if layer["kernel"].shape != shape or layer["bias"].shape != shape[-1:]:
            raise ValueError(f"{path}: layer shapes {layer['kernel'].shape}, "
                             f"{layer['bias'].shape}; expected {shape}")
    return textness_params_from_jax(layers)


def textness_apply(params, x):
    """``x``: (B, 1, H, W) float32 in [0, 1], H and W multiples of 4 →
    logits (B, 1, H/4, W/4). XLA's ``"SAME"`` padding of a stride-2 3×3
    conv over an even axis is (0, 1), not PyTorch's ``padding=1``."""
    h = x
    for i, p in enumerate(params[:-1]):
        if i < 2:
            h = F.conv2d(F.pad(h, (0, 1, 0, 1)), p["weight"], p["bias"], stride=2)
        else:
            h = F.conv2d(h, p["weight"], p["bias"], padding=1)
        h = torch.relu(h)
    p = params[-1]
    return F.conv2d(h, p["weight"], p["bias"])


def pad_page(gray_u8: np.ndarray) -> np.ndarray:
    """uint8 (H, W) → the page white-padded (255) to multiples of 64."""
    h, w = gray_u8.shape
    hb, wb = -(-h // PAGE_BUCKET) * PAGE_BUCKET, -(-w // PAGE_BUCKET) * PAGE_BUCKET
    padded = np.full((hb, wb), 255, np.uint8)
    padded[:h, :w] = gray_u8
    return padded


def textness_logits(gray_u8: np.ndarray, params, *, device=None) -> np.ndarray:
    """uint8 (H, W) grayscale → float32 (H, W) textness LOGIT map at full
    resolution (nearest-upsampled from the stride-4 head output). ``params``
    must lie on ``device`` (None means ``"cuda"``)."""
    device = resolve_device(device)
    h, w = gray_u8.shape
    padded = pad_page(gray_u8)
    x = torch.from_numpy(padded).to(device)[None, None].float() / 255.0
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        logits = textness_apply(params, x)[0, 0].cpu().numpy()
    return resize_nearest(logits, STRIDE)[:h, :w]


def textness_map(gray_u8: np.ndarray, params, *, device=None) -> np.ndarray:
    """uint8 (H, W) grayscale → bool (H, W) learned text map."""
    return textness_logits(gray_u8, params, device=device) > 0.0  # sigmoid > 0.5
