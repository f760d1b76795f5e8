"""Configuration for the ported slices: copies of ``twinvoice_tpu.config``'s
``UNetConfig``, ``InferConfig`` and ``FusionConfig`` (the port imports
nothing of the JAX package, so it keeps its own). Defaults are the same
values."""

from __future__ import annotations

from dataclasses import dataclass
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
