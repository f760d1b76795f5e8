"""PyTorch port, the training U-Net (``models.unet.unet_apply``) against the
JAX package's on the CPU: logits and new BatchNorm state in train and eval
mode from the same weights (carried across with ``from_jax_params``),
recompute (``remat``) against the plain backward, the parameter count, and
the weight layouts both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twinvoice_tpu.models.unet import param_count as jax_param_count
from twinvoice_tpu.models.unet import init_unet as jax_init_unet
from twinvoice_tpu.models.unet import unet_apply as jax_unet_apply
from twinvoice_tpu_torch.config import UNetConfig
from twinvoice_tpu_torch.models.unet import init_unet, param_count, tree_leaves, unet_apply
from twinvoice_tpu_torch.train.losses import invoice_loss
from twinvoice_tpu_torch.weights import from_jax_params, keystr_items, to_jax_params

from chip_smoke import rel_dist
from tests.torch_port_cases import random_unet


def batch(seed, n=4, size=32):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (n, size, size, 3)) > 0.8).astype(np.float32)
    return images, masks


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(a).permute(0, 3, 1, 2).to(dtype)


# Tolerances against JAX (both in float32 or both in bf16; relative ‖·‖ of
# the difference over JAX's): float32 logits 1e-4 and BN state 1e-5 (XLA's
# CPU reductions add up the batch statistics one element after another, about
# 1e-6 relative at these sizes, and E[x²] − E[x]² amplifies that); bf16 logits
# 5e-2 (bf16 rounding of every activation, 2^-8, through 19 layers), BN
# state 2e-2.
TOLS = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (5e-2, 2e-2)}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype,fast", [
    (torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)])
def test_unet_apply_matches_jax(train, dtype, fast):
    jcfg, params, state = random_unet(7, base_width=4)
    images, _ = batch(1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jl, js = jax.jit(lambda p, s, x: jax_unet_apply(
        p, s, x, cfg=jcfg, train=train, fast_norm=fast))(params, state, jnp.asarray(images, jdt))
    tp, ts = from_jax_params(params, state)
    tl, tns = unet_apply(tp, ts, nchw(images, dtype), cfg=UNetConfig(base_width=4),
                         train=train, fast_norm=fast)
    assert tl.dtype == dtype and tl.shape == (4, 3, 32, 32)
    logits_tol, state_tol = TOLS[dtype]
    got = tl.detach().to(torch.float32).permute(0, 2, 3, 1).numpy()
    assert rel_dist(got, np.asarray(jl, np.float32)) <= logits_tol
    mine = dict(keystr_items(to_jax_params(tp, tns)[1]))
    for key, want in keystr_items(jax.tree.map(np.asarray, js)):
        assert rel_dist(mine[key], want) <= state_tol, key
    if not train:  # eval mode hands the running statistics back untouched
        got, given = dict(keystr_items(tns)), dict(keystr_items(ts))
        assert got.keys() == given.keys() and all(got[k] is given[k] for k in got)


def _loss_grads(tp, ts, images, masks, remat):
    leaves = tree_leaves(tp)
    for t in leaves:
        t.grad = None
        t.requires_grad_()
    logits, ns = unet_apply(tp, ts, nchw(images), cfg=UNetConfig(base_width=4),
                            train=True, remat=remat)
    loss = invoice_loss(logits, nchw(masks))
    loss.backward()
    return loss.detach(), [t.grad.clone() for t in leaves], tree_leaves(ns)


def test_remat_equals_plain_loss_gradients_and_state():
    """The recompute runs each block's BatchNorm again; with functional
    statistics nothing is counted twice, and on the CPU the recomputed
    backward is bit-equal to the stored one."""
    _, params, state = random_unet(8, base_width=4)
    tp, ts = from_jax_params(params, state)
    images, masks = batch(2)
    plain = _loss_grads(tp, ts, images, masks, remat=False)
    remat = _loss_grads(tp, ts, images, masks, remat=True)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(plain[1], remat[1]):
        assert torch.equal(a, b)
    for a, b in zip(plain[2], remat[2]):
        assert torch.equal(a, b)
    # the state passed in is unchanged: one step's statistics, counted once
    for key, want in keystr_items(state):
        np.testing.assert_array_equal(dict(keystr_items(to_jax_params(tp, ts)[1]))[key], want)


def test_param_count_is_the_reference_models():
    params, _ = init_unet(torch.Generator().manual_seed(0), device="cpu")
    assert param_count(params) == 31_043_651
    jp, _ = jax.eval_shape(lambda k: jax_init_unet(k), jax.random.key(0))
    assert jax_param_count(jp) == 31_043_651


@pytest.mark.parametrize("base_width", [4, 16])
def test_to_jax_params_inverts_from_jax_params_bit_for_bit(base_width):
    _, params, state = random_unet(9, base_width=base_width)
    back = to_jax_params(*from_jax_params(params, state))
    for tree, ref in zip(back, (params, state)):
        got = dict(keystr_items(tree))
        want = dict(keystr_items(ref))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
