"""The learned textness head: the port of
``twinvoice_tpu/ocr/jaxocr/textness.py``.

A stride-4 fully-convolutional logit map (~33 k parameters): four 3×3
convs with ReLU, the first two of stride 2, and a 1×1 head. The bundled
weights (``twinvoice_tpu/ocr/jaxocr/textness.npz``) are read where they lie
with numpy, and ``save_textness`` writes the same format.

Training (``init_textness``, ``textness_labels``, ``textness_loss``,
``make_train_step``, ``train``) is JAX's: class-balanced BCE against the
line boxes rasterised at stride 4, AdamW at optax's cosine decay. Its pages
come from the caller: the page renderer (``render_textpage``, Pillow,
OpenCV and ``data/augment``) stays in the JAX package, on the host.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from twinvoice_tpu_torch import resolve_device
from twinvoice_tpu_torch.models.unet import param_count as n_params  # noqa: F401
from twinvoice_tpu_torch.ops.host_image import resize_area_u8, resize_nearest
from twinvoice_tpu_torch.weights import _conv, _jax_conv

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


def textness_params_to_jax(params):
    """The inverse of :func:`textness_params_from_jax`: the port's params
    (on any device) → JAX's list of ``{"kernel": HWIO, "bias"}`` numpy
    copies."""
    return [_jax_conv(p, (2, 3, 1, 0)) for p in params]


def init_textness(generator: torch.Generator, *, device=None):
    """→ fresh params, JAX's ``init_textness`` distributions: He-normal
    kernels (N(0, 2/fan_in)), zero biases; drawn from ``generator`` on the
    CPU and moved to ``device``."""
    params = []
    for kh, kw, ci, co in _layer_shapes():
        w = torch.randn((co, ci, kh, kw), generator=generator, dtype=torch.float32)
        params.append({"weight": (w * math.sqrt(2.0 / (ci * kh * kw))).to(device),
                       "bias": torch.zeros(co, device=device)})
    return params


def textness_labels(masks_u8: np.ndarray) -> np.ndarray:
    """uint8 (B, H, W) line masks (0/255) → float32 (B, H/4, W/4) labels:
    each mask shrunk by OpenCV's INTER_AREA (``resize_area_u8``, bit-equal)
    then ``> 64``, as JAX's ``make_batch`` builds them."""
    return np.stack([
        resize_area_u8(m, m.shape[1] // STRIDE, m.shape[0] // STRIDE) > 64
        for m in masks_u8]).astype(np.float32)


def textness_loss(logits, y):
    """JAX's class-balanced BCE: text pixels are the minority, so each pixel
    is weighted ``y/pos + (1 − y)/(1 − pos)`` with ``pos = max(mean(y),
    1e-3)``; the mean of the weighted per-pixel BCE with logits."""
    pos = torch.clamp(torch.mean(y), min=1e-3)
    w = y / pos + (1 - y) / (1 - pos)
    return torch.mean(w * F.binary_cross_entropy_with_logits(logits, y, reduction="none"))


def make_train_step(*, device=None):
    """signature: (params, optimizer, images, labels, lr) → (params, loss) on
    ``device`` (``None`` means the card): ``images`` float32 (B, 1, H, W) in
    [0, 1], ``labels`` float32 (B, 1, H/4, W/4) (moved to ``device`` if
    elsewhere), ``lr`` a Python float. The params are updated in place, the
    loss stays a 0-d tensor on the device."""
    device = resolve_device(device)

    def step(params, optimizer, images, labels, lr):
        images = images.to(device, non_blocking=True)
        labels = labels.to(device, non_blocking=True)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        loss = textness_loss(textness_apply(params, images), labels)
        loss.backward()
        optimizer.step()
        return params, loss.detach()

    return step


def pages_to_batch(pages_u8, masks_u8, device):
    """uint8 pages and masks (B, H, W) → ``(images (B, 1, H, W) float32 =
    u8 / 255, labels (B, 1, H/4, W/4))`` on ``device``."""
    x = torch.as_tensor(np.ascontiguousarray(pages_u8)).to(device)[:, None].float() / 255.0
    y = torch.from_numpy(textness_labels(masks_u8)).to(device)[:, None]
    return x, y


def save_textness(path, params):
    """JAX's textness npz: leaves ``l0…l9`` in ``jax.tree.leaves`` order
    (each layer's ``bias``, then its HWIO ``kernel``)."""
    flat = {}
    for i, layer in enumerate(textness_params_to_jax(params)):
        flat[f"l{2 * i}"], flat[f"l{2 * i + 1}"] = layer["bias"], layer["kernel"]
    np.savez_compressed(path, **flat)


def train(steps: int = 1500, bs: int = 32, lr: float = 2e-3, seed: int = 0,
          out_path: Optional[str] = None, log=print, *, pages, masks, device=None):
    """Train a fresh head (``init_textness`` from ``seed``) for ``steps``
    steps of AdamW (weight decay 1e-5) at optax's ``cosine_decay_schedule(lr,
    steps)`` on a pool cut from ``pages``/``masks`` (uint8 (N, 256, 256),
    rendered on the host by the JAX package's ``render_textpage``) into
    N // bs batches held on the device; each step draws one with
    ``rng.integers(0, len(pool))``. Saves to ``out_path`` if given. → the
    params."""
    from twinvoice_tpu_torch.ocr.torchocr.train import cosine_decay, make_optimizer

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = init_textness(torch.Generator().manual_seed(seed), device=device)
    log(f"textness head: {n_params(params)} params")
    optimizer = make_optimizer(params)
    schedule = cosine_decay(lr, steps)
    step = make_train_step(device=device)
    pool = [pages_to_batch(pages[i:i + bs], masks[i:i + bs], device)
            for i in range(0, len(pages) - bs + 1, bs)]
    if not pool:
        raise ValueError(f"{len(pages)} pages make no batch of {bs}")
    log(f"pool of {len(pool)} batches of {bs} on {device}")
    t0 = time.time()
    for it in range(1, steps + 1):
        x, y = pool[int(rng.integers(0, len(pool)))]
        params, loss = step(params, optimizer, x, y, schedule(it - 1))
        if it % 200 == 0 or it == 1:
            log(f"step {it}/{steps} loss {float(loss):.4f} ({time.time() - t0:.0f}s)")
    if out_path:
        save_textness(out_path, params)
        log(f"saved {out_path}")
    return params


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
