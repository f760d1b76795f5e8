"""Segmenter training (``twinvoice_tpu.train``): losses, the learning-rate
schedule, metrics, checkpoints, visual dumps and the trainer."""

from twinvoice_tpu_torch.train.losses import dice_loss, focal_loss, invoice_loss
from twinvoice_tpu_torch.train.schedule import cosine_warm_restarts
from twinvoice_tpu_torch.train.metrics import per_class_iou, mean_iou
