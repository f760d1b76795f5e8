"""PyTorch port, the training ops against the JAX package's, on the CPU:
train- and eval-mode BatchNorm, the mixed-precision conv, the transpose
conv (one function for JAX's training and serving forms), max-pool gradients
on ties, and the initialisers. JAX runs under ``jit``, as the JAX trainer runs it."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from twinvoice_tpu.models.unet import init_unet as jax_init_unet
from twinvoice_tpu.ops import conv as jconv
from twinvoice_tpu.ops import norm as jnorm
from twinvoice_tpu_torch.config import UNetConfig
from twinvoice_tpu_torch.models.unet import init_unet
from twinvoice_tpu_torch.ops import conv as tconv
from twinvoice_tpu_torch.ops import norm as tnorm
from twinvoice_tpu_torch.weights import keystr_items, to_jax_params

from chip_smoke import rel_dist


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).permute(
        0, 3, 1, 2).to(dtype)


def nhwc(t):
    return t.detach().to(torch.float32).permute(0, 2, 3, 1).numpy()


def bn_case(seed, shape=(4, 8, 8, 6), mu=0.5):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (mu + rng.standard_normal(shape)).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.standard_normal(c).astype(np.float32)}
    state = {"mean": rng.standard_normal(c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return x, params, state


def jax_bn(x, params, state, train, dtype, fast):
    fn = jax.jit(lambda x, p, s: jnorm.batchnorm_apply(
        x, p, s, train=train, norm_in_compute_dtype=fast))
    y, ns = fn(jnp.asarray(x, dtype), params, state)
    return np.asarray(y, np.float32), {k: np.asarray(v) for k, v in ns.items()}


def port_bn(x, params, state, train, dtype, fast):
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    y, ns = tnorm.batchnorm_apply(nchw(x, dtype), tp, ts, train=train,
                                  norm_in_compute_dtype=fast)
    assert y.dtype == dtype
    for k in ts:  # functional: the state passed in is never written
        np.testing.assert_array_equal(ts[k].numpy(), state[k])
    return nhwc(y), {k: v.numpy() for k, v in ns.items()}


# y: float32 within 1e-5 (the batch statistics' float32 rounding, reduced in
# another order); bf16 within 2 bf16 ulps of |y| ≤ 8 (0.0625); state within 1e-5
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype,fast", [
    (torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)])
def test_batchnorm_matches_jax(train, dtype, fast):
    x, params, state = bn_case(1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jy, jstate = jax_bn(x, params, state, train, jdt, fast)
    ty, tstate = port_bn(x, params, state, train, dtype, fast)
    tol = 1e-5 if dtype == torch.float32 else 0.0625
    np.testing.assert_allclose(ty, jy, atol=tol, rtol=0)
    for k in jstate:
        np.testing.assert_allclose(tstate[k], jstate[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_batchnorm_variance_is_jax_formula_not_two_pass():
    """Channel means near 1e3, variances near 0.2: E[x²] − E[x]² in float32
    rounds E[x]² to 1/16, so it differs from the two-pass variance (what
    ``torch.var`` and ``F.batch_norm`` take) by up to 1/32. With integer
    inputs and 16 samples every sum is exact in any order, so the port's and
    JAX's statistics must be bit-equal, and both must differ from the
    two-pass ones."""
    rng = np.random.default_rng(2)
    x = (1000 + rng.integers(0, 2, (2, 2, 4, 5))).astype(np.float32)
    x[..., 0] = 1000  # a constant channel: variance 0 either way
    params = {"scale": np.ones(5, np.float32), "bias": np.zeros(5, np.float32)}
    state = {"mean": np.zeros(5, np.float32), "var": np.ones(5, np.float32)}
    jy, jstate = jax_bn(x, params, state, True, jnp.float32, False)
    ty, tstate = port_bn(x, params, state, True, torch.float32, False)
    np.testing.assert_array_equal(tstate["mean"], jstate["mean"])
    np.testing.assert_array_equal(tstate["var"], jstate["var"])
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
    two_pass = torch.var(nchw(x), dim=(0, 2, 3), unbiased=True).numpy()
    two_pass_state = 0.9 * 1.0 + 0.1 * two_pass
    assert np.abs(tstate["var"] - two_pass_state)[1:].max() > 1e-3
    fy = F.batch_norm(nchw(x), None, None, training=True, eps=1e-5)
    assert np.abs(nhwc(fy) - ty).max() > 1e-2


def test_conv2d_bf16_forward_and_gradient_reach_float32_master():
    """bf16 activations against float32 master weights: the output is bf16,
    the gradients land on the float32 weight and bias. The forward is held
    to JAX's within 2 bf16 ulps of the output scale. The gradients (sums of
    4·16² products of bf16 values) are held to their exact float64 value
    within 2^-7 of its norm (the bias elementwise within 1 bf16 ulp: a
    float32 sum rounded once), and to JAX's within JAX's own distance from
    that exact value plus the same 2^-7: XLA's CPU reduction sums the
    bias's bf16 cotangents in bf16, about 2 units off on values near 50."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 16, 8)).astype(np.float32)
    k = (0.2 * rng.standard_normal((3, 3, 8, 6))).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    g = rng.standard_normal((4, 16, 16, 6)).astype(np.float32)

    def jf(xx, kk, bb):
        y = jconv.conv2d(xx, kk, bb, padding=((1, 1), (1, 1)))
        return jnp.sum(y.astype(jnp.float32) * g), y

    (_, jy), (jgk, jgb) = jax.jit(jax.value_and_grad(jf, argnums=(1, 2), has_aux=True))(
        jnp.asarray(x, jnp.bfloat16), k, b)
    w = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()).requires_grad_()
    bias = torch.from_numpy(b).requires_grad_()
    ty = tconv.conv2d(nchw(x, torch.bfloat16), w, bias, padding=1)
    assert ty.dtype == torch.bfloat16
    (ty.to(torch.float32) * nchw(g)).sum().backward()
    assert w.grad.dtype == torch.float32 and bias.grad.dtype == torch.float32
    scale = np.abs(np.asarray(jy, np.float32)).max()
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy, np.float32), rtol=0,
                               atol=2 * scale * 2.0 ** -8)
    # exact: the same bf16 operands and bf16-rounded cotangent, summed in float64
    w64 = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()).to(
        torch.bfloat16).double().requires_grad_()
    b64 = torch.zeros(6, dtype=torch.float64, requires_grad=True)
    y64 = F.conv2d(nchw(x, torch.bfloat16).double(), w64, b64, padding=1)
    (y64 * nchw(g, torch.bfloat16).double()).sum().backward()
    exact_k = np.transpose(w64.grad.numpy(), (2, 3, 1, 0))
    exact_b = b64.grad.numpy()
    gk = np.transpose(w.grad.numpy(), (2, 3, 1, 0))
    tol = 2.0 ** -7
    assert rel_dist(gk, exact_k) <= tol
    np.testing.assert_allclose(bias.grad.numpy(), exact_b, rtol=2.0 ** -8, atol=1e-3)
    for got, jax_g, exact in ((gk, jgk, exact_k), (bias.grad.numpy(), jgb, exact_b)):
        assert rel_dist(got, jax_g) <= rel_dist(jax_g, exact) * 1.01 + tol


def test_conv_transpose2x2_training_form_forward_and_gradient():
    """The port's one transpose conv against JAX's training form (the
    product and reshape; forward and gradients) and its serving form
    (forward): within float32 rounding, 1e-5 of the scale."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    k = rng.standard_normal((2, 2, 6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    g = rng.standard_normal((2, 10, 14, 4)).astype(np.float32)

    def jf(xx, kk, bb):
        y = jconv.conv_transpose2x2(xx, {"kernel": kk, "bias": bb})
        return jnp.sum(y * g), y

    (_, jy), jgrads = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True))(
        x, k, b)
    jserve = jax.jit(jconv.conv_transpose2x2_serving)(x, {"kernel": k, "bias": b})
    xt = nchw(x).requires_grad_()
    w = torch.from_numpy(np.transpose(k, (2, 3, 0, 1)).copy()).requires_grad_()
    bias = torch.from_numpy(b).requires_grad_()
    y = tconv.conv_transpose2x2(xt, {"weight": w, "bias": bias})
    (y * nchw(g)).sum().backward()
    got = (nhwc(y), nhwc(y), nhwc(xt.grad), np.transpose(w.grad.numpy(), (2, 3, 0, 1)),
           bias.grad.numpy())
    want = [np.asarray(jy), np.asarray(jserve)] + [np.asarray(a) for a in jgrads]
    for a, ref in zip(got, want):
        np.testing.assert_allclose(a, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_conv_transpose2x2_bf16_gradient_reaches_float32_master():
    """bf16 activations against float32 master weights, as in a bf16 train
    step: the output is bf16 and within 2 bf16 ulps of the scale of JAX's;
    the gradients land on the float32 weight and bias, within 2^-7 of the
    norm of their exact float64 value (the same bf16 operands and
    cotangent)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    k = (0.2 * rng.standard_normal((2, 2, 16, 4))).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    g = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    jy = jax.jit(jconv.conv_transpose2x2)(jnp.asarray(x, jnp.bfloat16),
                                          {"kernel": k, "bias": b})
    w = torch.from_numpy(np.transpose(k, (2, 3, 0, 1)).copy()).requires_grad_()
    bias = torch.from_numpy(b).requires_grad_()
    ty = tconv.conv_transpose2x2(nchw(x, torch.bfloat16), {"weight": w, "bias": bias})
    assert ty.dtype == torch.bfloat16
    (ty.to(torch.float32) * nchw(g)).sum().backward()
    assert w.grad.dtype == torch.float32 and bias.grad.dtype == torch.float32
    scale = np.abs(np.asarray(jy, np.float32)).max()
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy, np.float32), rtol=0,
                               atol=2 * scale * 2.0 ** -8)
    w64 = torch.from_numpy(np.transpose(k, (2, 3, 0, 1)).copy()).to(
        torch.bfloat16).double().requires_grad_()
    b64 = torch.zeros(4, dtype=torch.float64, requires_grad=True)
    y64 = F.conv_transpose2d(nchw(x, torch.bfloat16).double(), w64, b64, stride=2)
    (y64 * nchw(g, torch.bfloat16).double()).sum().backward()
    assert rel_dist(w.grad.numpy(), w64.grad.numpy()) <= 2.0 ** -7
    assert rel_dist(bias.grad.numpy(), b64.grad.numpy()) <= 2.0 ** -7


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_max_pool_gradient_on_ties_goes_where_xla_sends_it(dtype):
    """Planted ties in every 2×2 window pattern (two, three or four equal
    maxima, at every pair of positions), bf16 and float32: the pool's
    gradient equals JAX's exactly (the first maximum in row-major order)."""
    rng = np.random.default_rng(5)
    patterns = range(1, 16)  # bit c set: window cell c (row-major) holds the max
    x = rng.uniform(-1, 0.5, (2, 8, 2 * len(patterns), 3)).astype(np.float32)
    for j, m in enumerate(patterns):  # the windows of pooled row 0
        for cell in range(4):
            if m >> cell & 1:
                x[:, cell // 2, 2 * j + cell % 2, :] = 0.75
    x[:, 4:] = np.round(x[:, 4:] * 4) / 4  # ties among random values too
    g = rng.standard_normal((2, 4, len(patterns), 3)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jg = jax.jit(jax.grad(lambda xx: jnp.sum(
        jconv.max_pool2(xx).astype(jnp.float32) * g)))(jnp.asarray(x, jdt))
    xt = nchw(x, dtype).requires_grad_()
    (tconv.max_pool2(xt).to(torch.float32) * nchw(g)).sum().backward()
    hits = nhwc(xt.grad)[:, :2] != 0
    assert hits.sum() == 2 * len(patterns) * 3  # one cell of each window
    np.testing.assert_array_equal(nhwc(xt.grad), np.asarray(jg, np.float32))


def test_initialisers_bounds_bias_and_tree():
    """U(−1/√fan_in, 1/√fan_in) weights and biases (the transpose conv's fan
    in is Co·4), the out conv's bias at ``out_bias_init``, BN at ones/zeros,
    and the tree of JAX's ``init_unet`` (shapes and key paths, from
    ``jax.eval_shape``)."""
    g = torch.Generator().manual_seed(0)
    c = tconv.init_conv(g, 3, 3, 5, 7, device="cpu")
    bound = 1 / math.sqrt(5 * 9)
    assert c["weight"].shape == (7, 5, 3, 3)
    for t in c.values():
        assert t.abs().max() <= bound and t.abs().max() > 0.8 * bound
    ct = tconv.init_conv_transpose(g, 6, 4, device="cpu")
    assert ct["weight"].shape == (6, 4, 2, 2)
    bound = 1 / math.sqrt(4 * 4)
    for t in ct.values():
        assert t.abs().max() <= bound and t.abs().max() > 0.5 * bound
    cfg = UNetConfig(base_width=4)
    params, state = init_unet(torch.Generator().manual_seed(1), cfg, device="cpu")
    assert torch.equal(params["out"]["bias"], torch.full((3,), -4.0))
    assert all(torch.equal(p["bn1"]["scale"], torch.ones_like(p["bn1"]["scale"]))
               for p in params["enc"])
    jp, js = jax.eval_shape(lambda k: jax_init_unet(k, cfg), jax.random.key(0))
    mine = to_jax_params(params, state)
    for tree, ref in zip(mine, (jp, js)):
        want = {k: v.shape for k, v in keystr_items(jax.tree.map(lambda a: a, ref))}
        assert {k: v.shape for k, v in keystr_items(tree)} == want
    again = init_unet(torch.Generator().manual_seed(1), cfg, device="cpu")[0]
    assert torch.equal(again["enc"][0]["conv1"]["weight"], params["enc"][0]["conv1"]["weight"])
