"""The serving path (``twinvoice_tpu.infer``): box post-processing and the
``Segmenter``, with its int8 (``quant``) and W-phase (``wpack``) trunks."""

from twinvoice_tpu_torch.infer.postprocess import (
    bbox_from_probs,
    masks_and_boxes,
)
from twinvoice_tpu_torch.infer.pipeline import Segmenter
