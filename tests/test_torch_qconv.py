"""PyTorch port: the int8 conv kernels' plain versions (K4a, K5, K6 and the
int8 pool) against the JAX Pallas kernels in interpret mode and the JAX XLA
int8 graph, on the same numpy inputs. Everything is integer-exact up to a
float32 epilogue that both sides round the same way, so outputs must be
bit-equal. Frames are converted to and from NHWC as
``tests/unit/test_qconv_pallas.py`` does."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from twinvoice_tpu.infer import quant as jquant
from twinvoice_tpu.ops import qconv_pallas as QP
from twinvoice_tpu.ops.conv import max_pool2 as jax_max_pool2
from twinvoice_tpu_torch.ops import qconv, qupsample


def _s8(rng, shape, lo=-40, hi=41):
    return rng.integers(lo, hi, shape).astype(np.int8)


def _frame(x_nhwc):
    return QP.to_frame(jnp.asarray(np.transpose(x_nhwc, (1, 3, 2, 0))))


def _unframe(xf):
    return np.transpose(np.asarray(QP.from_frame(xf)), (3, 0, 2, 1))


def _port_kernel(k_hwio):
    """JAX (kh,kw,Ci,Co) → the port's (Co,kh,kw,Ci)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k_hwio, (3, 0, 1, 2))))


def _epilogue_operands(rng, cout):
    w_scale = rng.uniform(1e-3, 2e-3, cout).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    return w_scale, bias


# (n, h, w, cin, cout, out_scale, relu, tiles): the cases of
# tests/unit/test_qconv_pallas.py, the chunked-Cin accumulation with
# tiles=(4, 8, 64), no ReLU, and odd H != W with Cin = 5 and Co = 3; the
# small out_scale clips at both ends.
K4A_CASES = [
    (4, 16, 16, 8, 8, 3.7, True, None),
    (4, 16, 16, 8, 16, 3.7, True, None),
    (4, 8, 8, 16, 8, 3.7, True, None),
    (2, 8, 8, 128, 8, 3.0, True, (4, 8, 64)),
    (2, 8, 8, 8, 8, 2.0, False, None),
    (2, 5, 7, 5, 3, 0.4, False, None),
]


@pytest.mark.parametrize("n,h,w,cin,cout,out_scale,relu,tiles", K4A_CASES)
def test_k4a_plain_equals_pallas(n, h, w, cin, cout, out_scale, relu, tiles):
    rng = np.random.default_rng(cin * 31 + cout)
    lo = -10 if cin >= 128 else -40
    x = _s8(rng, (n, h, w, cin), lo, -lo + 1)
    k = _s8(rng, (3, 3, cin, cout), -20, 21)
    w_scale, bias = _epilogue_operands(rng, cout)
    s_in = np.float32(0.83)
    a = s_in * w_scale  # the dequant factor the Pallas kernel takes, in float32
    cc = tiles[2] if tiles else QP._plan_tiles(h, cin, w, n, cout)[2]
    ref = QP.qconv3x3_requant(_frame(x), QP.pack_w3x3(k, cc), jnp.asarray(a),
                              jnp.asarray(bias), np.float32(out_scale), relu=relu,
                              tiles=tiles, interpret=True)
    got = qconv.qconv3x3_requant(torch.from_numpy(x), _port_kernel(k),
                                 torch.from_numpy(w_scale), torch.from_numpy(bias),
                                 s_in, out_scale, relu=relu)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), _unframe(ref))
    q = got.numpy()
    assert q.max() == 127 and q.min() == (0 if relu else -127)  # clips at both ends


@pytest.mark.parametrize("n,h,w,c", [(2, 16, 16, 8), (1, 7, 5, 6)])
def test_k5_plain_equals_pallas_split(n, h, w, c):
    """One s32 sum of both halves with one dequant factor (the Pallas K5)."""
    rng = np.random.default_rng(h * w + c)
    up, skip = _s8(rng, (n, h, w, c)), _s8(rng, (n, h, w, c))
    k = _s8(rng, (3, 3, 2 * c, c), -20, 21)
    w_scale, bias = _epilogue_operands(rng, c)
    s_cat, s1 = np.float32(0.031), np.float32(4.1)
    cc = QP._plan_tiles(h, c, w, n, c, two_inputs=True)[2]
    ref = QP.qconv3x3_split_requant(
        _frame(up), _frame(skip), QP.pack_w3x3(k[:, :, :c], cc),
        QP.pack_w3x3(k[:, :, c:], cc), jnp.asarray(s_cat * w_scale),
        jnp.asarray(bias), s1, interpret=True)
    got = qconv.qconv3x3_split_requant(
        torch.from_numpy(up), torch.from_numpy(skip), _port_kernel(k[:, :, :c]),
        _port_kernel(k[:, :, c:]), torch.from_numpy(w_scale), torch.from_numpy(bias),
        s_cat, s1)
    np.testing.assert_array_equal(got.numpy(), _unframe(ref))


@pytest.mark.parametrize("form", ["concat", "split"])
def test_decoder_conv1_forms_equal_xla(form):
    """The two XLA decoder-conv1 formulas of quant.py: ``(acc·s_up)·w + b`` on
    the concatenated halves (K4a with scale_first) and ``(acc₁·s_up +
    acc₂·s_skip)·w + b`` (K5 with two scales), float32 scalars as under jit."""
    rng = np.random.default_rng(5)
    n, h, w, c = 2, 9, 11, 8
    up, skip = _s8(rng, (n, h, w, c), -127, 128), _s8(rng, (n, h, w, c), 0, 128)
    k = _s8(rng, (3, 3, 2 * c, c), -127, 128)
    w1, bias = _epilogue_operands(rng, c)
    s_up, s_skip, s1 = np.float32(0.0213), np.float32(0.0187), 3.3

    def xla(up, skip, k, w1, bias, s_up, s_skip, s1):
        if form == "concat":
            part = jquant._conv3x3_i8(jnp.concatenate([up, skip], axis=-1),
                                      {"kernel": k}).astype(jnp.float32)
            y = part * s_up * w1 + bias
        else:
            pu = jquant._conv3x3_i8(up, {"kernel": k[:, :, :c]}).astype(jnp.float32)
            ps = jquant._conv3x3_i8(skip, {"kernel": k[:, :, c:]}).astype(jnp.float32)
            y = (pu * s_up + ps * s_skip) * w1 + bias
        return jquant._requant(jax.nn.relu(y), s1)

    ref = jax.jit(xla)(up, skip, k, w1, bias, s_up, s_skip, s1)
    args = (torch.from_numpy(w1), torch.from_numpy(bias))
    if form == "concat":
        got = qconv.qconv3x3_requant(
            torch.cat([torch.from_numpy(up), torch.from_numpy(skip)], dim=-1),
            _port_kernel(k), *args, s_up, s1, scale_first=True)
    else:
        got = qconv.qconv3x3_split_requant(
            torch.from_numpy(up), torch.from_numpy(skip), _port_kernel(k[:, :, :c]),
            _port_kernel(k[:, :, c:]), *args, s_up, s1, s_in2=s_skip)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,h,w,ci,co", [(2, 8, 8, 8, 8), (1, 3, 5, 5, 3)])
def test_k6_plain_equals_pallas_upsample(n, h, w, ci, co):
    rng = np.random.default_rng(ci + co)
    x = _s8(rng, (n, h, w, ci))
    k = _s8(rng, (2, 2, ci, co), -20, 21)
    w_scale = rng.uniform(1e-3, 2e-3, co).astype(np.float32)
    bias = rng.normal(0, 0.3, co).astype(np.float32)
    s, s_out = np.float32(0.021), np.float32(0.9)
    ref = QP.qupsample2x2_requant(_frame(x), QP.pack_wup(k), jnp.asarray(s * w_scale),
                                  jnp.asarray(bias), s_out, interpret=True)
    got = qupsample.qupsample2x2_requant(
        torch.from_numpy(x), _port_kernel(k), torch.from_numpy(w_scale),
        torch.from_numpy(bias), s, s_out)
    assert got.shape == (n, 2 * h, 2 * w, co)
    np.testing.assert_array_equal(got.numpy(), _unframe(ref))
    # and the XLA transpose conv of quant.py, flip included
    acc = jquant._conv_transpose2x2_i8(jnp.asarray(x), jnp.asarray(k))
    np.testing.assert_array_equal(
        qconv.conv_transpose2x2_i8(torch.from_numpy(x), _port_kernel(k)).numpy(),
        np.asarray(acc))


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (3, 7, 9, 5)])
def test_int8_pool_equals_jax(shape):
    x = _s8(np.random.default_rng(1), shape, -128, 128)
    got = qconv.max_pool2_i8(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_max_pool2(jnp.asarray(x))))
    if shape[1] % 2 == 0 and shape[2] % 2 == 0:
        frame = QP.max_pool2_hcwn(_frame(x), interpret=True)
        np.testing.assert_array_equal(got.numpy(), _unframe(frame))


def test_plain_conv_is_exact_past_float32():
    """Cin = 256 at full scale: the s32 sums pass 2^24, where float32 is not
    exact; the float64 plain conv equals JAX's int32 conv."""
    rng = np.random.default_rng(2)
    x = _s8(rng, (1, 4, 4, 256), -127, 128)
    k = np.full((3, 3, 256, 2), 127, np.int8)
    x[...] = 127
    got = qconv.conv3x3_i8(torch.from_numpy(x), _port_kernel(k))
    ref = np.asarray(jquant._conv3x3_i8(jnp.asarray(x), {"kernel": jnp.asarray(k)}))
    assert ref.max() == 127 * 127 * 9 * 256 > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("wrapper", ["k4a", "k5", "k6"])
def test_wrappers_launch_or_raise_off_the_cpu(wrapper):
    """A tensor that is not on the CPU goes to the kernel, never to the plain
    version: on a device without one the wrapper raises."""
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8, device="meta")
    k = torch.zeros((8, 3, 3, 8), dtype=torch.int8, device="meta")
    v = torch.zeros((8,), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        if wrapper == "k4a":
            qconv.qconv3x3_requant(x, k, v, v, 1.0, 1.0)
        elif wrapper == "k5":
            qconv.qconv3x3_split_requant(x, x, k, k, v, v, 1.0, 1.0)
        else:
            qupsample.qupsample2x2_requant(x, k[:, :2, :2].contiguous(), v, v, 1.0, 1.0)
