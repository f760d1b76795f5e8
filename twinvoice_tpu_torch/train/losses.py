"""Segmentation loss stack (``twinvoice_tpu.train.losses``): multilabel dice +
focal mixture on NCHW tensors.

Sigmoid on logits, then ``0.85·dice + 0.15·focal`` with dice smooth 1.0
computed per (batch, class) over the spatial dims, and BCE-based focal with
α 0.8, γ 2, probability clamp eps 1e-7 (``config.LossConfig``). It computes
in float32 whatever the activation dtype.

With a ``mesh`` (``core.mesh.Mesh``) the arguments are this rank's block of
the global batch, and each loss returns this rank's part of the global mean:
the parts sum over the mesh's ``batch`` axis to the loss of the whole batch.
Dice's ``inter`` and ``union`` are summed over the ``spatial`` line before the
ratio (dice is per sample and class over the whole image); focal is a local
sum over the global count.
"""

from __future__ import annotations

import torch

from twinvoice_tpu_torch.config import LossConfig
from twinvoice_tpu_torch.core.collectives import sum_over


def _global_mean(x, mesh):
    """This rank's part of the global batch's mean of ``x``, a block of
    equal size on every rank of the ``batch`` axis. (Dice's (N, C) values are
    the same on the ranks of a ``spatial`` line, which the count includes:
    each is counted once.)"""
    if mesh is None:
        return torch.mean(x)
    return torch.sum(x) / (x.numel() * mesh.axis("batch").size)


def dice_loss(pred, target, smooth=1.0, *, mesh=None):
    """Mean (over batch×class) soft-dice loss; ``pred``/``target``:
    (N,C,H,W) probabilities in [0,1]."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    inter = torch.sum(pred * target, dim=(2, 3))      # (N, C)
    union = torch.sum(pred, dim=(2, 3)) + torch.sum(target, dim=(2, 3))
    if mesh is not None:
        ax = mesh.axis("spatial")
        inter, union = sum_over(inter, ax), sum_over(union, ax)
    dice = 1.0 - (2.0 * inter + smooth) / (union + smooth)
    return _global_mean(dice, mesh)


def focal_loss(pred, target, alpha=0.8, gamma=2.0, eps=1e-7, *, mesh=None):
    """Mean elementwise BCE-based focal loss on probabilities."""
    p = torch.clamp(pred.to(torch.float32), eps, 1.0 - eps)
    t = target.to(torch.float32)
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    pt = torch.exp(-bce)
    return _global_mean(alpha * (1.0 - pt) ** gamma * bce, mesh)


def invoice_loss(logits, target, cfg: LossConfig = LossConfig(), *, mesh=None):
    """sigmoid(logits) → dice+focal mixture. ``logits``: (N,C,H,W)."""
    pred = torch.sigmoid(logits.to(torch.float32))
    return (
        cfg.dice_weight * dice_loss(pred, target, cfg.dice_smooth, mesh=mesh)
        + cfg.focal_weight * focal_loss(pred, target, cfg.focal_alpha, cfg.focal_gamma,
                                        cfg.focal_eps, mesh=mesh)
    )
