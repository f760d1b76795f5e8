"""Labelme → training pairs: the port of ``twinvoice_tpu.data.labelme``
(the reference's offline label pipeline, rescue_masks_from_json_final.py).

Read labelme JSON (imageWidth/Height, shapes[].label/points), scale polygons
from the JSON's nominal size to the actual image size, burn each class's
polygons into its own mask channel (an even-odd scanline fill in numpy),
resize the image bilinearly and the mask with nearest to the training size,
and write ``fixed_images/{base}.jpg`` + ``fixed_masks/{base}.npy`` (H,W,3
uint8 0/255).

The polygon fill and the mask are numpy, copied. The two resizes are
``ops.host_image``'s, bit-equal to OpenCV's INTER_LINEAR and INTER_NEAREST.
``build_one`` reads the photo with ``ops.host_imageio.imread_rgb`` (the
pixels ``cv2.imread`` gives, EXIF orientation applied) and writes the JPEG
with ``imwrite_jpeg`` (``cv2.imwrite``'s bytes at quality 95), so it needs
no OpenCV.
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, Sequence, Tuple

import numpy as np

from twinvoice_tpu_torch.ops.host_image import resize_linear_u8, resize_nearest_u8
from twinvoice_tpu_torch.ops.host_imageio import imread_rgb, imwrite_jpeg

DEFAULT_LABELS = {"invoice_no": 0, "date": 1, "total_amount": 2}
IMG_EXT_CANDIDATES = (".jpg", ".jpeg", ".JPG", ".png")


def fill_polygon(points: Sequence[Tuple[float, float]], h: int, w: int) -> np.ndarray:
    """Even-odd scanline fill. ``points``: (x, y) vertices. Returns bool (h, w).

    A pixel is inside iff its center (x+.5, y+.5) is inside the polygon.
    """
    pts = np.asarray(points, np.float64)
    if len(pts) < 3:
        return np.zeros((h, w), bool)
    x0, y0 = pts[:, 0], pts[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)

    mask = np.zeros((h, w), bool)
    yc = np.arange(h, dtype=np.float64) + 0.5  # scanline at pixel centers
    # crossings[r] = sorted x-intersections of scanline r with polygon edges
    for ex0, ey0, ex1, ey1 in zip(x0, y0, x1, y1):
        if ey0 == ey1:
            continue  # horizontal edges never cross a scanline transversally
        lo, hi = (ey0, ey1) if ey0 < ey1 else (ey1, ey0)
        rows = np.nonzero((yc >= lo) & (yc < hi))[0]
        if rows.size == 0:
            continue
        xs = ex0 + (yc[rows] - ey0) * (ex1 - ex0) / (ey1 - ey0)
        # toggle parity right of each crossing: pixel centers x+.5 >= xs
        cols = np.ceil(xs - 0.5).astype(np.int64)
        cols = np.clip(cols, 0, w)
        for r, c in zip(rows, cols):
            if c < w:
                mask[r, c:] ^= True
    return mask


def rasterize_labelme(
    shapes,
    out_hw: Tuple[int, int],
    scale_xy: Tuple[float, float] = (1.0, 1.0),
    label_to_channel: Dict[str, int] = DEFAULT_LABELS,
    num_channels: int = 3,
) -> np.ndarray:
    """Burn labelme ``shapes`` into a (H, W, C) uint8 0/255 mask."""
    h, w = out_hw
    sx, sy = scale_xy
    mask = np.zeros((h, w, num_channels), np.uint8)
    for shape in shapes:
        ch = label_to_channel.get(shape.get("label"))
        if ch is None:
            continue
        pts = [(px * sx, py * sy) for px, py in shape["points"]]
        mask[:, :, ch] |= np.where(fill_polygon(pts, h, w), np.uint8(255), np.uint8(0))
    return mask


def _find_image(images_dir: str, base: str):
    for ext in IMG_EXT_CANDIDATES:
        p = os.path.join(images_dir, base + ext)
        if os.path.exists(p):
            return p
    return None


def build_one(json_path: str, img_path: str, out_img_dir: str, out_mask_dir: str,
              train_size=(512, 512), label_to_channel=DEFAULT_LABELS):
    """Process a single (JSON, image) pair; returns the sample base name."""
    with open(json_path, "r", encoding="utf-8") as f:
        meta = json.load(f)

    img = imread_rgb(img_path)
    if img is None:
        raise FileNotFoundError(img_path)
    h, w = img.shape[:2]
    sx = w / meta["imageWidth"]
    sy = h / meta["imageHeight"]

    mask = rasterize_labelme(meta.get("shapes", ()), (h, w), (sx, sy), label_to_channel)

    tw, th = train_size
    img_r = resize_linear_u8(img, tw, th)
    mask_r = resize_nearest_u8(mask, tw, th)

    os.makedirs(out_img_dir, exist_ok=True)
    os.makedirs(out_mask_dir, exist_ok=True)
    base = os.path.basename(img_path).rsplit(".", 1)[0]
    imwrite_jpeg(os.path.join(out_img_dir, base + ".jpg"), img_r)
    np.save(os.path.join(out_mask_dir, base + ".npy"), mask_r)
    return base


def build_dataset_from_labelme(
    json_dir="json",
    images_dir="images",
    out_img_dir="fixed_images",
    out_mask_dir="fixed_masks",
    train_size=(512, 512),
    label_to_channel=DEFAULT_LABELS,
    log=print,
):
    """Batch run over ``{json_dir}/*.json`` (reference rescue…py:66-84)."""
    done, missing = [], []
    for json_path in sorted(glob(os.path.join(json_dir, "*.json"))):
        base = os.path.basename(json_path)[: -len(".json")]
        img_path = _find_image(images_dir, base)
        if img_path is None:
            missing.append(base)
            log(f"missing image for {base}")
            continue
        done.append(
            build_one(json_path, img_path, out_img_dir, out_mask_dir, train_size, label_to_channel)
        )
        log(f"built {base}")
    return done, missing
