"""Configuration for the ported slice: copies of ``twinvoice_tpu.config``'s
``UNetConfig`` and ``InferConfig`` (the port imports nothing of the JAX
package, so it keeps its own). Defaults are the same values."""

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
