"""Configuration for the ported slices: copies of ``twinvoice_tpu.config``'s
``UNetConfig``, ``LossConfig``, ``TrainConfig``, ``InferConfig``,
``DataConfig``, ``FusionConfig``, ``MeshConfig``, ``Config`` and ``replace``
(the port imports nothing of the JAX package, so it keeps its own). Defaults
are the same values."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class UNetConfig:
    """Architecture of the field segmenter."""

    in_channels: int = 3
    num_classes: int = 3
    base_width: int = 64          # encoder widths: 64,128,256,512; bottleneck 1024
    depth: int = 4                # number of down/up levels
    out_bias_init: float = -4.0   # background-biased logit init
    bn_eps: float = 1e-5          # torch BatchNorm2d defaults
    bn_momentum: float = 0.1

    def encoder_widths(self) -> Tuple[int, ...]:
        return tuple(self.base_width * (2 ** i) for i in range(self.depth))

    def bottleneck_width(self) -> int:
        return self.base_width * (2 ** self.depth)


@dataclass(frozen=True)
class LossConfig:
    """Dice+focal mixture (reference train.py:49-59)."""

    dice_weight: float = 0.85
    focal_weight: float = 0.15
    focal_alpha: float = 0.8
    focal_gamma: float = 2.0
    dice_smooth: float = 1.0
    focal_eps: float = 1e-7


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer/schedule/loop (reference train.py:99,119,121-123,129)."""

    batch_size: int = 4
    epochs: int = 50
    lr: float = 1e-3
    weight_decay: float = 1e-4
    warm_restart_t0: int = 10     # CosineAnnealingWarmRestarts(T_0=10, T_mult=2)
    warm_restart_tmult: int = 2
    eta_min: float = 0.0
    seed: int = 0
    loss: LossConfig = field(default_factory=LossConfig)
    checkpoint_dir: str = "checkpoints"
    visualize_dir: str = "visualize"
    visualize: bool = True
    val_fraction: float = 0.0     # reference has no val split; >0 enables one
    dtype: str = "float32"        # "float32" (parity) or "bfloat16" (fast)
    remat: bool = False           # recompute each DoubleConv in the backward
    # pass: about 1/3 more FLOPs for a large activation-memory cut
    fast_norm: bool = False       # BN normalize in the activation dtype
    # (stats stay fp32); only meaningful with bfloat16
    prefetch: int = 2             # host batches prepared and uploaded ahead on
    # a worker thread (0 = synchronous)
    sync_every: int = 0           # synchronise with the device every N steps
    # (0 = only at epoch end)


@dataclass(frozen=True)
class InferConfig:
    """The serving graph: grid size, per-field thresholds, box padding."""

    img_size: int = 512
    # per-field sigmoid thresholds, order (invoice_no, date, total_amount)
    thresholds: Tuple[float, float, float] = (0.25, 0.40, 0.30)
    pad_frac: float = 0.15        # bbox padding each side
    black_crop_mean: float = 3.0  # reject crops with mean pixel < 3 (all-black)
    dtype: str = "float32"        # serving default overridden to bfloat16 by Segmenter
    batch_size: int = 32


@dataclass(frozen=True)
class DataConfig:
    """Dataset build + loading (reference rescue_masks_from_json_final.py, dataset.py)."""

    train_size: Tuple[int, int] = (512, 512)
    img_dir: str = "fixed_images"
    mask_dir: str = "fixed_masks"
    label_to_channel: Tuple[Tuple[str, int], ...] = (
        ("invoice_no", 0),
        ("date", 1),
        ("total_amount", 2),
    )


@dataclass(frozen=True)
class FusionConfig:
    """Field-fusion behavior (reference app_camera.py:736-878)."""

    ocr_space_api_key: str = ""   # reference hardcodes a key (app_camera.py:68); we use env
    use_qr: bool = True
    use_ocr_space: bool = False   # network engine, off by default
    use_local_ocr: bool = True
    adjust_items_to_total: bool = True   # revived dead feature (app_camera.py:182)
    auto_rotate: bool = True             # revived dead feature (app_camera.py:655)
    full_page_fallback: bool = True      # detector+recognizer full-page scan
    # when field crops yield nothing (EasyOCR readtext analogue, :817-833)
    host_workers: int = 4                # extract_batch: QR scans run in a
    # thread pool overlapped with the segmenter's device call (the native
    # decoder releases the GIL)
    gray_h2d: bool = True                # extract_batch: upload luminance and
    # replicate it to RGB on the device — 3× fewer host→device bytes
    h2d_chunks: int = 2                  # extract_batch: split the segmenter
    # batch so that chunk k+1's host resize and upload run under chunk k's
    # device compute (identical results)


@dataclass(frozen=True)
class MeshConfig:
    """Rank grid shape (``core.mesh.make_mesh``). Axis sizes of 1 collapse
    that axis."""

    data: int = -1        # -1: all remaining ranks
    model: int = 1        # tensor-parallel conv out-channel sharding
    spatial: int = 1      # spatial (H) sharding with halo exchange


@dataclass(frozen=True)
class Config:
    model: UNetConfig = field(default_factory=UNetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    data: DataConfig = field(default_factory=DataConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def replace(cfg, **kw):
    """dataclasses.replace that reads naturally at call sites."""
    return dataclasses.replace(cfg, **kw)
