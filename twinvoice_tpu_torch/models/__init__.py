"""The U-Net field segmenter (``twinvoice_tpu.models``) and the bundled
weights (``pretrained``)."""

from twinvoice_tpu_torch.config import UNetConfig
from twinvoice_tpu_torch.models.unet import (
    init_unet,
    unet_apply,
    fold_unet,
    unet_apply_folded,
    param_count,
)
