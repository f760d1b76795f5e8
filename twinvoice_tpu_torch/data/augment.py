"""Photographic perturbation of invoice images (``twinvoice_tpu.data.augment``),
without OpenCV.

One engine serves the segmenter's training (:class:`AugmentedDataset`, a
drop-in for ``train.fit``) and the gauntlet's perturbed tiers
(``eval.perturb_cases``). It runs on the host in numpy, as the JAX package
runs it in its data loader: uint8 HWC images, every geometric effect
composed into one 3×3 matrix that warps the image (bilinear) and the mask
(nearest) together, so the ground truth stays exact.

This is the JAX package's module with each OpenCV call replaced by its
numpy port: the warps and matrices by ``ops.host_warp``, the blurs, the 2-D
filter and the cubic resize by ``ops.host_filter``, the clutter's
rectangles and lines by ``ops.host_draw`` and the JPEG round trip by
``ops.host_jpeg``. Every random draw is made in the same order with the
same numpy calls, so one seed gives the JAX package's spec, corners, noise
and clutter. Masks, the geometry and every uint8 stage are byte-equal to
the JAX package's; the float32 blurs, filter and resize agree with
OpenCV's to a few ulp, and an image byte flips where such a value lies
that close to an integer before its truncation to uint8
(``tests/test_torch_augment.py`` bounds how many).

Severity: ``severity ∈ [0, 1]`` scales every effect's sampling range;
named presets ``MILD`` (0.35) and ``HARD`` (1.0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from twinvoice_tpu_torch.ops.host_draw import fill_rect_u8, line_u8
from twinvoice_tpu_torch.ops.host_filter import (
    filter2d_f32,
    gaussian_blur_f32,
    gaussian_blur_u8,
    resize_cubic_f32,
)
from twinvoice_tpu_torch.ops.host_jpeg import jpeg_roundtrip_u8
from twinvoice_tpu_torch.ops.host_warp import (
    BORDER_CONSTANT,
    BORDER_REPLICATE,
    INTER_LINEAR,
    INTER_NEAREST,
    get_perspective_transform,
    rotation_matrix_2d,
    warp_affine_f32,
    warp_perspective_u8,
)

MILD = 0.35
HARD = 1.0


@dataclass
class PerturbSpec:
    """A concrete, reproducible perturbation (all effects off by default)."""

    rotate_deg: float = 0.0
    perspective: float = 0.0          # corner jitter, fraction of min(h,w)
    scale: float = 1.0
    translate: Tuple[float, float] = (0.0, 0.0)  # fraction of (w, h)
    blur_sigma: float = 0.0
    motion_blur: int = 0              # kernel length in px (0 = off)
    noise_std: float = 0.0            # gaussian noise, u8 units
    jpeg_quality: int = 0             # 0 = off, else 1..95
    brightness: float = 0.0           # additive, fraction of 255 (-1..1)
    contrast: float = 1.0             # multiplicative around 128
    gamma: float = 1.0
    color_cast: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # per-ch add, /255
    shadow: float = 0.0               # 0..1 darkening strength
    vignette: float = 0.0             # 0..1
    background: bool = False          # paste onto procedural clutter
    bg_seed: int = 0
    # real-photo degradations
    halftone: float = 0.0             # print-and-scan AM dot screen, 0..1
    halftone_cell: float = 3.0        # dot pitch in px
    screen_moire: float = 0.0         # screen-recapture subpixel gratings, 0..1
    crumple: float = 0.0              # fold/crumple illumination field, 0..1
    thermal_fade: float = 0.0         # thermal-paper ink fade, 0..1


def sample_spec(rng: np.random.Generator, severity: float = MILD) -> PerturbSpec:
    """Sample a random perturbation at the given severity.

    Each effect fires independently (harder at higher severity), so mild
    samples are mostly 1-2 light effects and hard samples stack several.
    """
    s = float(np.clip(severity, 0.0, 1.0))

    def on(p):
        return rng.uniform() < p

    spec = PerturbSpec()
    if on(0.8):
        spec.rotate_deg = float(rng.uniform(-12, 12) * s)
    if on(0.5 * s + 0.2):
        spec.perspective = float(rng.uniform(0.0, 0.06) * s)
    if on(0.6):
        spec.scale = float(1.0 + rng.uniform(-0.18, 0.12) * s)
        spec.translate = (
            float(rng.uniform(-0.06, 0.06) * s),
            float(rng.uniform(-0.06, 0.06) * s),
        )
    if on(0.5):
        spec.blur_sigma = float(rng.uniform(0.4, 2.2) * s)
    elif on(0.25 * s):
        spec.motion_blur = int(round(rng.uniform(3, 13) * s)) | 1
    if on(0.5):
        spec.noise_std = float(rng.uniform(2, 18) * s)
    if on(0.45):
        spec.jpeg_quality = int(round(95 - rng.uniform(20, 75) * s))
    if on(0.6):
        spec.brightness = float(rng.uniform(-0.25, 0.25) * s)
        spec.contrast = float(1.0 + rng.uniform(-0.45, 0.25) * s)
    if on(0.35):
        spec.gamma = float(np.exp(rng.uniform(-0.5, 0.5) * s))
    if on(0.35):
        spec.color_cast = tuple(float(rng.uniform(-0.10, 0.10) * s) for _ in range(3))
    if on(0.40 * s + 0.1):
        spec.shadow = float(rng.uniform(0.25, 0.65) * s)
    if on(0.25):
        spec.vignette = float(rng.uniform(0.2, 0.6) * s)
    if on(0.45 * s):
        spec.background = True
        spec.bg_seed = int(rng.integers(0, 2**31))
    # real-photo degradations: rarer, mutually light (each alone is hard)
    if on(0.15 * s):
        spec.halftone = float(rng.uniform(0.35, 0.85) * s)
        spec.halftone_cell = float(rng.uniform(2.2, 4.5))
    elif on(0.15 * s):
        spec.screen_moire = float(rng.uniform(0.25, 0.6) * s)
    if on(0.20 * s):
        spec.crumple = float(rng.uniform(0.3, 0.8) * s)
    if on(0.12 * s):
        spec.thermal_fade = float(rng.uniform(0.3, 0.8) * s)
    return spec


# ---------------------------------------------------------------- geometric


def _geometry_matrix(spec: PerturbSpec, w: int, h: int, rng: np.random.Generator):
    """Compose rotate/scale/translate/perspective into one 3×3 matrix."""
    cx, cy = w / 2.0, h / 2.0
    a = np.deg2rad(spec.rotate_deg)
    ca, sa = np.cos(a) * spec.scale, np.sin(a) * spec.scale
    tx = spec.translate[0] * w
    ty = spec.translate[1] * h
    # affine about the center
    m = np.array(
        [
            [ca, -sa, cx - ca * cx + sa * cy + tx],
            [sa, ca, cy - sa * cx - ca * cy + ty],
            [0.0, 0.0, 1.0],
        ],
        np.float64,
    )
    if spec.perspective > 0:
        j = spec.perspective * min(w, h)
        src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
        dst = src + rng.uniform(-j, j, (4, 2)).astype(np.float32)
        m = get_perspective_transform(src, dst) @ m
    return m


def _is_identity_geom(spec: PerturbSpec) -> bool:
    return (
        spec.rotate_deg == 0.0
        and spec.perspective == 0.0
        and spec.scale == 1.0
        and spec.translate == (0.0, 0.0)
        and not spec.background
    )


def _clutter_background(h: int, w: int, seed: int) -> np.ndarray:
    """Procedural desk-clutter background: gradients + texture + shapes."""
    rng = np.random.default_rng(seed)
    base = np.float32(rng.uniform(40, 180))
    gx = np.linspace(-1, 1, w, dtype=np.float32)[None, :]
    gy = np.linspace(-1, 1, h, dtype=np.float32)[:, None]
    tone = base + rng.uniform(-40, 40) * gx + rng.uniform(-40, 40) * gy
    img = np.stack([tone + rng.uniform(-18, 18) for _ in range(3)], -1)
    noise = rng.normal(0, rng.uniform(2, 10), (h, w, 1)).astype(np.float32)
    img = img + noise
    img = np.clip(img, 0, 255).astype(np.uint8)
    # clutter: random rectangles / lines (papers, table edges, pens)
    for _ in range(int(rng.integers(2, 7))):
        c = tuple(int(v) for v in rng.integers(30, 225, 3))
        x1, y1 = int(rng.integers(0, w)), int(rng.integers(0, h))
        x2, y2 = int(rng.integers(0, w)), int(rng.integers(0, h))
        if rng.uniform() < 0.5:
            fill_rect_u8(img, (x1, y1), (x2, y2), c)
        else:
            line_u8(img, (x1, y1), (x2, y2), c, int(rng.integers(1, 8)))
    return gaussian_blur_u8(img, 2.0)


def _apply_geometry(img, mask, spec, rng):
    h, w = img.shape[:2]
    m = _geometry_matrix(spec, w, h, rng)
    if spec.background:
        # sentinel ~black; composited below
        border, value = BORDER_CONSTANT, (1, 1, 1)
        bg = _clutter_background(h, w, spec.bg_seed)
    else:
        border, value = BORDER_REPLICATE, 0
        bg = None
    out = warp_perspective_u8(img, m, (w, h), INTER_LINEAR, border, value)
    if bg is not None:
        hole = (out == 1).all(axis=-1)
        out = np.where(hole[..., None], bg, out)
    new_mask = None
    if mask is not None:
        new_mask = warp_perspective_u8(mask, m, (w, h), INTER_NEAREST, BORDER_CONSTANT, 0)
        if new_mask.ndim == 2:
            new_mask = new_mask[..., None]
    return out, new_mask


# --------------------------------------------------------------- photometric


def _blob_field(h, w, rng, cells=(6, 8)):
    """Smooth random field in [-1, 1] (paper buckle / fade blotches)."""
    g = rng.uniform(-1, 1, cells).astype(np.float32)
    return resize_cubic_f32(g, w, h)


def _apply_photometric(img: np.ndarray, spec: PerturbSpec, rng) -> np.ndarray:
    h, w = img.shape[:2]
    x = img.astype(np.float32)
    if spec.crumple > 0.0:
        # folded/crumpled paper: broad buckle shading + sharp crease lines
        shade = 0.5 * _blob_field(h, w, rng)
        yy = np.arange(h, dtype=np.float32)[:, None]
        xx = np.arange(w, dtype=np.float32)[None, :]
        for _ in range(int(rng.integers(1, 4))):
            ang = rng.uniform(0, np.pi)
            off = rng.uniform(0.15, 0.85)
            d = (np.cos(ang) * (xx - w * off) + np.sin(ang) * (yy - h * off))
            width = rng.uniform(2.0, 8.0)
            crease = np.exp(-(d / width) ** 2)
            # a crease catches light on one side, shadows the other
            shade += rng.choice([-1.0, 1.0]) * 0.8 * crease * np.tanh(d / width)
        x = x * np.clip(1.0 + spec.crumple * 0.45 * shade, 0.45, 1.5)[..., None]
    if spec.thermal_fade > 0.0:
        # thermal receipt fade: ink density drops, worst in blotches/along
        # one direction; paper tone survives
        ang = rng.uniform(0, 2 * np.pi)
        gx = np.linspace(-0.5, 0.5, w, dtype=np.float32)[None, :]
        gy = np.linspace(-0.5, 0.5, h, dtype=np.float32)[:, None]
        field = (0.55 + 0.45 * (np.cos(ang) * gx + np.sin(ang) * gy)
                 + 0.35 * _blob_field(h, w, rng))
        field = np.clip(field, 0.0, 1.0) * spec.thermal_fade
        paper = float(np.percentile(x, 90))
        ink = paper - x
        x = paper - ink * (1.0 - field[..., None])
    if spec.contrast != 1.0 or spec.brightness != 0.0:
        x = (x - 128.0) * spec.contrast + 128.0 + spec.brightness * 255.0
    if spec.gamma != 1.0:
        x = np.clip(x, 0, 255)
        x = 255.0 * np.power(x / 255.0, spec.gamma)
    if any(c != 0.0 for c in spec.color_cast):
        x = x + np.asarray(spec.color_cast, np.float32) * 255.0
    if spec.shadow > 0.0:
        # soft-edged half-plane shadow with random orientation
        ang = rng.uniform(0, 2 * np.pi)
        d = (
            np.cos(ang) * (np.arange(w, dtype=np.float32)[None, :] - w / 2)
            + np.sin(ang) * (np.arange(h, dtype=np.float32)[:, None] - h / 2)
        )
        edge = rng.uniform(-0.25, 0.25) * min(h, w)
        soft = 1.0 / (1.0 + np.exp(-(d - edge) / (0.06 * min(h, w))))
        x = x * (1.0 - spec.shadow * soft)[..., None]
    if spec.vignette > 0.0:
        yy = (np.arange(h, dtype=np.float32)[:, None] - h / 2) / (h / 2)
        xx = (np.arange(w, dtype=np.float32)[None, :] - w / 2) / (w / 2)
        r2 = xx * xx + yy * yy
        x = x * (1.0 - spec.vignette * 0.5 * r2)[..., None]
    if spec.blur_sigma > 0.0:
        x = gaussian_blur_f32(x, spec.blur_sigma)
    if spec.motion_blur > 1:
        k = np.zeros((spec.motion_blur, spec.motion_blur), np.float32)
        k[spec.motion_blur // 2, :] = 1.0 / spec.motion_blur
        ang = float(rng.uniform(0, 180))
        rot = rotation_matrix_2d(
            (spec.motion_blur / 2 - 0.5, spec.motion_blur / 2 - 0.5), ang, 1.0
        )
        k = warp_affine_f32(k, rot, (spec.motion_blur, spec.motion_blur))
        k /= max(k.sum(), 1e-6)
        x = filter2d_f32(x, k)
    if spec.halftone > 0.0:
        # print-and-scan: amplitude-modulated dot screen on luminance,
        # blended in (desaturates like a photocopy), then a light scan PSF
        ang = rng.uniform(0, np.pi)
        yy = np.arange(h, dtype=np.float32)[:, None]
        xx = np.arange(w, dtype=np.float32)[None, :]
        u = (np.cos(ang) * xx + np.sin(ang) * yy) / spec.halftone_cell
        v = (-np.sin(ang) * xx + np.cos(ang) * yy) / spec.halftone_cell
        screen = 0.5 + 0.25 * (np.cos(2 * np.pi * u) + np.cos(2 * np.pi * v))
        lum = np.clip(x, 0, 255).mean(-1) / 255.0
        dots = 255.0 / (1.0 + np.exp(-(lum - screen) * 9.0))
        x = (1.0 - spec.halftone) * x + spec.halftone * dots[..., None]
        x = gaussian_blur_f32(x, 0.6)
    if spec.screen_moire > 0.0:
        # screen recapture: two subpixel gratings with per-channel phase
        # (RGB stripe) + a low-frequency refresh band over rows
        a = spec.screen_moire
        period = rng.uniform(2.2, 4.2)
        ang = rng.uniform(-0.2, 0.2)
        yy = np.arange(h, dtype=np.float32)[:, None]
        xx = np.arange(w, dtype=np.float32)[None, :]
        u = (np.cos(ang) * xx + np.sin(ang) * yy) / period
        v = (-np.sin(ang) * xx + np.cos(ang) * yy) / (period * rng.uniform(0.9, 1.2))
        mod = np.empty((h, w, 3), np.float32)
        for c in range(3):
            ph = c / 3.0
            mod[..., c] = (1.0
                           - a * 0.22 * (1 + np.sin(2 * np.pi * (u + ph)))
                           - a * 0.10 * (1 + np.sin(2 * np.pi * v)))
        band = 1.0 - a * 0.12 * (1 + np.sin(2 * np.pi * yy / rng.uniform(60, 180)))
        x = x * mod * band[..., None] + a * rng.uniform(4, 14)
    if spec.noise_std > 0.0:
        x = x + rng.normal(0, spec.noise_std, x.shape).astype(np.float32)
    x = np.clip(x, 0, 255).astype(np.uint8)
    if spec.jpeg_quality > 0:
        x = jpeg_roundtrip_u8(x, spec.jpeg_quality)
    return x


# ------------------------------------------------------------------- public


def apply_spec(
    img: np.ndarray,
    mask: Optional[np.ndarray],
    spec: PerturbSpec,
    rng: Optional[np.random.Generator] = None,
):
    """Apply one PerturbSpec to (image, mask). Returns (img_u8, mask_u8|None).

    Geometry moves image and mask identically; photometric/degradation ops
    touch only the image. ``rng`` drives the spec's *unparameterized* inner
    randomness (shadow angle, perspective corners, noise draw).
    """
    rng = rng or np.random.default_rng(spec.bg_seed or 0)
    if not _is_identity_geom(spec):
        img, mask = _apply_geometry(img, mask, spec, rng)
    img = _apply_photometric(img, spec, rng)
    return img, mask


def perturb(
    img: np.ndarray,
    mask: Optional[np.ndarray],
    rng: np.random.Generator,
    severity: float = MILD,
):
    """Sample + apply a random perturbation at ``severity``."""
    return apply_spec(img, mask, sample_spec(rng, severity), rng)


def boxes_from_mask(mask: np.ndarray) -> dict:
    """Per-channel tight bbox of a (H,W,C) 0/255 mask → {ch: (x1,y1,x2,y2)}.

    Channels with no positive pixels are omitted (the field left the
    frame)."""
    out = {}
    for c in range(mask.shape[-1]):
        ys, xs = np.nonzero(mask[..., c])
        if len(ys) == 0:
            continue
        out[c] = (int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max()))
    return out


class AugmentedDataset:
    """ArrayDataset wrapper: a fresh random perturbation per sample per epoch.

    Exposes the ``batches``/``split``/``__len__`` surface that
    ``train.fit`` consumes, so augmented training is a drop-in:
    ``fit(AugmentedDataset(ds, severity=0.6), cfg)``.
    """

    def __init__(
        self,
        base,
        severity: float = MILD,
        p_clean: float = 0.25,
        seed: int = 0,
    ):
        self.base = base
        self.severity = severity
        self.p_clean = p_clean
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.base)

    @property
    def images(self):
        return self.base.images

    @property
    def masks(self):
        return self.base.masks

    def split(self, val_fraction: float, seed: int = 0):
        """Split the base; only the TRAIN side stays augmented (val is clean,
        so val IoU measures the same thing across runs)."""
        tr, va = self.base.split(val_fraction, seed=seed)
        return (
            AugmentedDataset(tr, self.severity, self.p_clean,
                             seed=int(self._rng.integers(0, 2**31))),
            va,
        )

    def batches(self, batch_size, *, rng=None, shuffle=True, dtype=np.float32):
        for images, masks in self.base.batches(
            batch_size, rng=rng, shuffle=shuffle, dtype=dtype
        ):
            imgs_u8 = (images * 255.0).astype(np.uint8)
            msks_u8 = (masks * 255.0).astype(np.uint8)
            for i in range(imgs_u8.shape[0]):
                if self._rng.uniform() < self.p_clean:
                    continue
                im, mk = perturb(
                    imgs_u8[i], msks_u8[i], self._rng, self.severity
                )
                imgs_u8[i], msks_u8[i] = im, mk
            yield (
                imgs_u8.astype(dtype) / dtype(255.0),
                msks_u8.astype(dtype) / dtype(255.0),
            )
