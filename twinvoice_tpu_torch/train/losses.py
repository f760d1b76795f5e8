"""Segmentation loss stack (``twinvoice_tpu.train.losses``): multilabel dice +
focal mixture on NCHW tensors.

Sigmoid on logits, then ``0.85·dice + 0.15·focal`` with dice smooth 1.0
computed per (batch, class) over the spatial dims, and BCE-based focal with
α 0.8, γ 2, probability clamp eps 1e-7 (``config.LossConfig``). It computes
in float32 whatever the activation dtype.
"""

from __future__ import annotations

import torch

from twinvoice_tpu_torch.config import LossConfig


def dice_loss(pred, target, smooth=1.0):
    """Mean (over batch×class) soft-dice loss; ``pred``/``target``:
    (N,C,H,W) probabilities in [0,1]."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    inter = torch.sum(pred * target, dim=(2, 3))      # (N, C)
    union = torch.sum(pred, dim=(2, 3)) + torch.sum(target, dim=(2, 3))
    dice = 1.0 - (2.0 * inter + smooth) / (union + smooth)
    return torch.mean(dice)


def focal_loss(pred, target, alpha=0.8, gamma=2.0, eps=1e-7):
    """Mean elementwise BCE-based focal loss on probabilities."""
    p = torch.clamp(pred.to(torch.float32), eps, 1.0 - eps)
    t = target.to(torch.float32)
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    pt = torch.exp(-bce)
    return torch.mean(alpha * (1.0 - pt) ** gamma * bce)


def invoice_loss(logits, target, cfg: LossConfig = LossConfig()):
    """sigmoid(logits) → dice+focal mixture. ``logits``: (N,C,H,W)."""
    pred = torch.sigmoid(logits.to(torch.float32))
    return (
        cfg.dice_weight * dice_loss(pred, target, cfg.dice_smooth)
        + cfg.focal_weight * focal_loss(pred, target, cfg.focal_alpha, cfg.focal_gamma,
                                        cfg.focal_eps)
    )
