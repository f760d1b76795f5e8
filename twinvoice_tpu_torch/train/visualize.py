"""Per-epoch visual QA dumps (``twinvoice_tpu.train.visualize``): the first
train image, its true mask and the predicted mask as RGB PNGs, true-mask
threshold 0.5 and predicted-probability threshold 0.3. The PNGs are encoded
here with ``zlib`` and ``struct`` (no imaging library is needed)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

# class → display color
_COLORS = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)


def _mask_to_rgb(mask_hwc, threshold):
    h, w, c = mask_hwc.shape
    out = np.zeros((h, w, 3), np.uint8)
    for ch in range(min(c, 3)):
        out[mask_hwc[:, :, ch] > threshold] = _COLORS[ch]
    return out


def write_png(path, rgb):
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (filter 0 rows)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def dump_epoch_visual(image_hwc, true_mask_hwc, params, bn_state, model_cfg, out_dir, name):
    """Save {name}_img/true/pred.png under ``out_dir``; the prediction is the
    eval-mode float32 forward on the params' device."""
    from twinvoice_tpu_torch.models.unet import unet_apply

    os.makedirs(out_dir, exist_ok=True)
    img_u8 = np.clip(image_hwc * 255.0, 0, 255).astype(np.uint8)
    write_png(os.path.join(out_dir, f"{name}_img.png"), img_u8)
    write_png(os.path.join(out_dir, f"{name}_true.png"), _mask_to_rgb(true_mask_hwc, 0.5))
    device = params["out"]["weight"].device
    x = torch.as_tensor(np.asarray(image_hwc, np.float32), device=device)
    with torch.no_grad():
        logits, _ = unet_apply(params, bn_state, x.permute(2, 0, 1)[None],
                               cfg=model_cfg, train=False)
        prob = torch.sigmoid(logits[0].to(torch.float32)).permute(1, 2, 0).cpu().numpy()
    write_png(os.path.join(out_dir, f"{name}_pred.png"), _mask_to_rgb(prob, 0.3))
