"""PyTorch port, the losses, learning-rate schedule and metrics against the
JAX package's (under ``jit``) and against the reference formulas in
``tests/torch_oracle.invoice_loss``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twinvoice_tpu.train import losses as jlosses
from twinvoice_tpu.train import metrics as jmetrics
from twinvoice_tpu.train import schedule as jschedule
from twinvoice_tpu_torch.config import LossConfig
from twinvoice_tpu_torch.train import losses, metrics, schedule

from tests import torch_oracle


def case(seed, n=3, size=24, c=3):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((n, size, size, c))).astype(np.float32)
    logits[0, :4] = 40.0  # saturated probabilities: the focal clamp at 1 − 1e-7
    logits[1, :4] = -40.0
    masks = (rng.uniform(0, 1, (n, size, size, c)) > 0.7).astype(np.float32)
    return logits, masks


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(a).permute(0, 3, 1, 2).to(dtype)


# float32 sums over 24² elements in another order: 1e-6 relative
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_losses_match_jax_and_reference(dtype):
    logits, masks = case(0)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jl, jm = jnp.asarray(logits, jdt), jnp.asarray(masks, jdt)
    tl, tm = nchw(logits, dtype), nchw(masks, dtype)
    jpred = jax.nn.sigmoid(jl.astype(jnp.float32))
    tpred = torch.sigmoid(tl.to(torch.float32))
    pairs = [
        (losses.dice_loss(tpred, tm), jax.jit(jlosses.dice_loss)(jpred, jm)),
        (losses.focal_loss(tpred, tm), jax.jit(jlosses.focal_loss)(jpred, jm)),
        (losses.invoice_loss(tl, tm), jax.jit(jlosses.invoice_loss)(jl, jm)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    ref = torch_oracle.invoice_loss(tl.to(torch.float32).numpy(), tm.to(torch.float32).numpy())
    np.testing.assert_allclose(float(pairs[2][0]), ref, rtol=1e-6)
    other = LossConfig(dice_weight=0.3, focal_weight=0.7, focal_alpha=0.25, focal_gamma=3.0,
                       dice_smooth=0.5)
    from twinvoice_tpu.config import LossConfig as JaxLossConfig
    jother = JaxLossConfig(**other.__dict__)
    np.testing.assert_allclose(
        float(losses.invoice_loss(tl, tm, other)),
        float(jax.jit(lambda a, b: jlosses.invoice_loss(a, b, jother))(jl, jm)), rtol=1e-6)


def test_loss_gradient_matches_jax():
    """d loss / d logits within 1e-5 of JAX's scale (float32)."""
    logits, masks = case(1)
    jg = jax.jit(jax.grad(lambda l: jlosses.invoice_loss(l, masks)))(logits)
    tl = nchw(logits).requires_grad_()
    losses.invoice_loss(tl, nchw(masks)).backward()
    got = tl.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jg), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())


@pytest.mark.parametrize("t0,t_mult,eta_min", [(10, 2, 0.0), (3, 1, 1e-5), (2, 3, 1e-4)])
def test_schedule_equals_jax_and_torch_scheduler(t0, t_mult, eta_min):
    """Exactly JAX's values (the same Python arithmetic), and within 1e-12 of
    ``CosineAnnealingWarmRestarts`` stepped once an epoch (torch computes
    the same cosine by its own recurrence)."""
    mine = schedule.cosine_warm_restarts(1e-3, t0, t_mult, eta_min)
    theirs = jschedule.cosine_warm_restarts(1e-3, t0, t_mult, eta_min)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1e-3)
    sched = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(
        opt, T_0=t0, T_mult=t_mult, eta_min=eta_min)
    for e in range(80):
        assert mine(e) == theirs(e)
        assert schedule.warm_restart_position(e, t0, t_mult) == \
            jschedule.warm_restart_position(e, t0, t_mult)
        assert abs(mine(e) - opt.param_groups[0]["lr"]) <= 1e-12
        opt.step()
        sched.step()


def test_per_class_iou_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.uniform(0, 1, (4, 16, 16, 3)) > 0.5
    target = rng.uniform(0, 1, (4, 16, 16, 3)) > 0.6
    target[..., 2] = False
    pred[..., 2] = False  # an empty class: IoU (0 + eps) / (0 + eps) = 1
    want = np.asarray(jax.jit(jmetrics.per_class_iou)(pred, target))
    got = metrics.per_class_iou(nchw(pred.astype(np.float32)) > 0.5,
                                nchw(target.astype(np.float32)) > 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(metrics.mean_iou(nchw(pred.astype(np.float32)),
                                  nchw(target.astype(np.float32)))) == pytest.approx(
        float(jmetrics.mean_iou(pred, target)), rel=1e-7)
