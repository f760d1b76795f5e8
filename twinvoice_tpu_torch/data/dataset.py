"""Invoice segmentation dataset: memory-resident arrays + batched iteration
(``twinvoice_tpu.data.dataset``, copied; numpy only: ``load_invoice_dataset``
reads its JPEG and PNG files with ``ops.host_imageio.imread_rgb``, the pixels
``cv2.imread`` gives, without OpenCV).

Pairs ``{img_dir}/{name}.jpg|png`` with ``{mask_dir}/{name}.npy`` (H,W,3
uint8 0/255), image → float/255, mask → 0/1. Arrays are NHWC on the host (the
trainer transposes on the device); the whole dataset is preloaded, and every
batch has the same shape (a partial tail batch wraps samples).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from twinvoice_tpu_torch.ops.host_imageio import imread_rgb


@dataclass
class ArrayDataset:
    images: np.ndarray  # (N, H, W, 3) uint8
    masks: np.ndarray   # (N, H, W, C) uint8 (0/255)
    names: Tuple[str, ...] = ()

    def __len__(self):
        return self.images.shape[0]

    def split(self, val_fraction: float, seed: int = 0):
        """Deterministic train/val split (absent in the reference; SURVEY §4)."""
        n = len(self)
        n_val = int(round(n * val_fraction))
        order = np.random.default_rng(seed).permutation(n)
        va, tr = order[:n_val], order[n_val:]
        return (
            ArrayDataset(self.images[tr], self.masks[tr], tuple(self.names[i] for i in tr) if self.names else ()),
            ArrayDataset(self.images[va], self.masks[va], tuple(self.names[i] for i in va) if self.names else ()),
        )

    def batches(
        self,
        batch_size: int,
        *,
        rng: Optional[np.random.Generator] = None,
        shuffle: bool = True,
        dtype=np.float32,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images float[B,H,W,3] in [0,1], masks float[B,H,W,C] in {0,1}).

        Every batch has exactly ``batch_size`` rows (tail wraps with resampled
        rows).
        """
        n = len(self)
        if n == 0:
            return
        order = (rng or np.random.default_rng()).permutation(n) if shuffle else np.arange(n)
        for start in range(0, n, batch_size):
            idx = order[start : start + batch_size]
            if len(idx) < batch_size:
                extra = order[: batch_size - len(idx)]
                idx = np.concatenate([idx, extra])
            yield (
                self.images[idx].astype(dtype) / dtype(255.0),
                self.masks[idx].astype(dtype) / dtype(255.0),
            )


def load_invoice_dataset(img_dir="fixed_images", mask_dir="fixed_masks") -> ArrayDataset:
    """Load the on-disk layout that ``data.labelme`` writes."""
    if not os.path.isdir(img_dir):
        return ArrayDataset(
            np.zeros((0, 512, 512, 3), np.uint8), np.zeros((0, 512, 512, 3), np.uint8)
        )
    names = sorted(
        f.rsplit(".", 1)[0]
        for f in os.listdir(img_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    imgs, msks, kept = [], [], []
    for name in names:
        img = None
        for ext in (".jpg", ".png", ".jpeg"):
            p = os.path.join(img_dir, name + ext)
            if os.path.exists(p):
                img = imread_rgb(p)
                break
        mp = os.path.join(mask_dir, name + ".npy")
        if img is None or not os.path.exists(mp):
            continue
        imgs.append(img)
        msks.append(np.load(mp))
        kept.append(name)
    if not imgs:
        return ArrayDataset(
            np.zeros((0, 512, 512, 3), np.uint8), np.zeros((0, 512, 512, 3), np.uint8)
        )
    return ArrayDataset(np.stack(imgs), np.stack(msks), tuple(kept))


def synthetic_dataset(n=8, size=64, classes=3, seed=0) -> ArrayDataset:
    """Procedural invoice-like dataset for tests/benchmarks: random background
    with one bright rectangle per class, mask = that rectangle."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(60, 200, (n, size, size, 3), dtype=np.uint8)
    masks = np.zeros((n, size, size, classes), np.uint8)
    for i in range(n):
        for c in range(classes):
            h = rng.integers(size // 8, size // 3)
            w = rng.integers(size // 4, size // 2)
            y = rng.integers(0, size - h)
            x = rng.integers(0, size - w)
            imgs[i, y : y + h, x : x + w] = 240 - 30 * c
            masks[i, y : y + h, x : x + w, c] = 255
    return ArrayDataset(imgs, masks, tuple(f"synthetic_{i}" for i in range(n)))
