"""Segmentation metrics (``twinvoice_tpu.train.metrics``) on NCHW masks."""

from __future__ import annotations

import torch


def per_class_iou(pred_mask, target_mask, eps=1e-7):
    """IoU per class. Inputs bool/0-1 tensors (N,C,H,W) → (C,) float32."""
    p = pred_mask.to(torch.float32)
    t = target_mask.to(torch.float32)
    inter = torch.sum(p * t, dim=(0, 2, 3))
    union = torch.sum(torch.maximum(p, t), dim=(0, 2, 3))
    return (inter + eps) / (union + eps)


def mean_iou(pred_mask, target_mask):
    return torch.mean(per_class_iou(pred_mask, target_mask))
