"""The learned textness head: the port of
``twinvoice_tpu/ocr/jaxocr/textness.py``.

A stride-4 fully-convolutional logit map (~33 k parameters): four 3×3
convs with ReLU, the first two of stride 2, and a 1×1 head. The bundled
weights (``twinvoice_tpu/ocr/jaxocr/textness.npz``) are read where they lie
with numpy, and ``save_textness`` writes the same format.

Training (``init_textness``, ``textness_labels``, ``textness_loss``,
``make_train_step``, ``train``) is JAX's: class-balanced BCE against the
line boxes rasterised at stride 4, AdamW at optax's cosine decay. The page
renderer (``render_textpage``, ``make_batch``) is JAX's with the same
generator draws, drawn by ``ops/host_pildraw`` and the TrueType engine of
``ocr/fonts/truetype`` and perturbed by the ported ``data/augment``; given
no pages, ``train`` renders its cached pool of 48 batches as JAX's does.
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


def render_textpage(rng: np.random.Generator, size: int = 256,
                    severity: float = 0.5):
    """One synthetic training page: random text lines on paper + non-text
    distractors (QR-ish blocks, rules, blobs), perturbed photographically.
    Returns (gray uint8 (size,size), mask uint8 (size,size) 0/255): JAX's
    ``render_textpage`` with the same generator draws. The page before the
    perturbation and the mask equal JAX's byte for byte; the perturbation
    engine's float32 stages keep their own bound (``data/augment.py``)."""
    from twinvoice_tpu_torch.data import augment
    from twinvoice_tpu_torch.ocr.torchocr import data as rec_data
    from twinvoice_tpu_torch.ocr.torchocr.charset import CHARSET
    from twinvoice_tpu_torch.ops.host_image import resize_nearest_u8, rgb_to_gray
    from twinvoice_tpu_torch.ops.host_pildraw import Draw, Image

    fonts = rec_data._FONT_PATHS  # the registry, as render_line reads it
    paper = np.full((size, size, 3), int(rng.integers(225, 252)), np.uint8)
    paper += rng.integers(0, 6, paper.shape, dtype=np.uint8)
    img = Image.fromarray(paper)
    draw = Draw(img)
    mask = np.zeros((size, size), np.uint8)

    # non-text distractors FIRST (text may overlap them)
    for _ in range(int(rng.integers(0, 4))):
        kind = rng.integers(0, 3)
        x, y = int(rng.integers(0, size - 40)), int(rng.integers(0, size - 40))
        if kind == 0:  # QR-ish checkerboard
            n = int(rng.integers(6, 14))
            cell = int(rng.integers(2, 5))
            block = (rng.integers(0, 2, (n, n)) * 255).astype(np.uint8)
            block = resize_nearest_u8(block, n * cell, n * cell)
            bh, bw = block.shape
            y2, x2 = min(size, y + bh), min(size, x + bw)
            img.array[y:y2, x:x2] = block[: y2 - y, : x2 - x, None]
        elif kind == 1:  # horizontal rule
            draw.line((x, y, min(size, x + int(rng.integers(40, 200))), y),
                      fill=0, width=int(rng.integers(1, 3)))
        else:  # solid blob
            r = int(rng.integers(4, 16))
            draw.ellipse((x, y, x + r, y + r), fill=int(rng.integers(0, 120)))

    chars = list(CHARSET.strip())
    for _ in range(int(rng.integers(3, 9))):
        n = int(rng.integers(4, 14))
        text = "".join(rng.choice(chars, n))
        fs = int(rng.integers(10, 24))
        font = rec_data._font(fonts[int(rng.integers(0, len(fonts)))], fs)
        tw = int(draw.textlength(text, font=font))
        th = int(fs * 1.3)
        if tw >= size - 4:
            continue
        x = int(rng.integers(2, size - tw - 2))
        y = int(rng.integers(2, size - th - 2))
        draw.text((x, y), text, fill=int(rng.integers(0, 90)), font=font)
        mask[max(0, y - 1) : y + th + 1, max(0, x - 1) : x + tw + 1] = 255

    if severity > 0:
        arr, m = augment.perturb(img.array, mask[..., None], rng, severity)
        mask = m[..., 0]
        gray = rgb_to_gray(arr)
    else:
        gray = rgb_to_gray(img.array)
    return gray, mask


def make_batch(bs: int, rng: np.random.Generator, size: int = 256):
    """→ (imgs (bs, size, size, 1) float32, labels (bs, size/4, size/4, 1)
    float32), as JAX's ``make_batch``."""
    imgs = np.zeros((bs, size, size, 1), np.float32)
    labels = np.zeros((bs, size // 4, size // 4, 1), np.float32)
    for i in range(bs):
        g, m = render_textpage(rng, size)
        imgs[i, :, :, 0] = g / 255.0
        labels[i, :, :, 0] = resize_area_u8(m, size // 4, size // 4) > 64
    return imgs, labels


def render_pool(bs: int, rng: np.random.Generator, batches: int, size: int = 256):
    """JAX's cached pool, ``[make_batch(bs, rng) for _ in range(batches)]``,
    as uint8 pages and masks → (pages (batches·bs, size, size), masks)."""
    pages = np.zeros((batches * bs, size, size), np.uint8)
    masks = np.zeros((batches * bs, size, size), np.uint8)
    for i in range(batches * bs):
        pages[i], masks[i] = render_textpage(rng, size)
    return pages, masks


def save_textness(path, params):
    """JAX's textness npz: leaves ``l0…l9`` in ``jax.tree.leaves`` order
    (each layer's ``bias``, then its HWIO ``kernel``)."""
    flat = {}
    for i, layer in enumerate(textness_params_to_jax(params)):
        flat[f"l{2 * i}"], flat[f"l{2 * i + 1}"] = layer["bias"], layer["kernel"]
    np.savez_compressed(path, **flat)


def train(steps: int = 1500, bs: int = 32, lr: float = 2e-3, seed: int = 0,
          out_path: Optional[str] = None, log=print, cache_batches: int = 48, *,
          pages=None, masks=None, device=None):
    """Train a fresh head (``init_textness`` from ``seed``) for ``steps``
    steps of AdamW (weight decay 1e-5) at optax's ``cosine_decay_schedule(lr,
    steps)`` on a pool of batches held on the device; each step draws one
    with ``rng.integers(0, len(pool))``. Without ``pages``, the pool is
    JAX's: ``cache_batches`` batches of ``bs`` pages rendered by
    :func:`render_textpage` from ``default_rng(seed)``. Given ``pages`` and
    ``masks`` (uint8 (N, 256, 256)), it is cut from them into N // bs
    batches. Saves to ``out_path`` if given. → the params."""
    from twinvoice_tpu_torch.ocr.torchocr.train import cosine_decay, make_optimizer

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = init_textness(torch.Generator().manual_seed(seed), device=device)
    log(f"textness head: {n_params(params)} params")
    optimizer = make_optimizer(params)
    schedule = cosine_decay(lr, steps)
    step = make_train_step(device=device)
    if pages is None:
        pages, masks = render_pool(bs, rng, cache_batches)
        log(f"pre-rendered {cache_batches} batches")
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
