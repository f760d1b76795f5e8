"""PyTorch port: K3b (``qconv3x3_nhwc_requant``), K3a (``qconv3x3_nhwc_dma``),
K7a (``qconv3x3_pair_dma``) and ``pad_nhwc`` of ``ops/nhwc_conv.py`` against
the JAX package's, on the same numpy inputs.

The JAX kernels run in interpret mode at ``th=8``, as
``tests/unit/test_nhwc_conv.py`` runs them, and the port's wrappers take
their plain versions on these CPU tensors. Everything is integer-exact up to
the float32 epilogue, so outputs must be bit-equal. Each case also sets its
biases to searched requant ties (``tests/test_torch_epilogue.py``), so the
fused multiply-add of the epilogue is held too.

JAX's K7a cannot be traced with one row block (H = th): its first block
copies th + 1 rows, more than the image has, so its K7a cases use H ≥ 16. The
port takes any H.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from twinvoice_tpu.ops import nhwc_conv as JN
from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.ops import nhwc_conv

from tests.torch_port_cases import product_tie_biases

F32 = np.float32


def _s8(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_kernel(k_hwio):
    """JAX (3,3,C,Co) → the port's (Co,3,3,C)."""
    return _t(np.transpose(k_hwio, (3, 0, 1, 2)))


def _port_pair(wp):
    """JAX (3,2,Cpk,Co2) → the port's (Co2,3,2,Cpk)."""
    return _t(np.transpose(wp, (3, 0, 1, 2)))


def _operands(rng, acc_fn, co, os_, relu):
    """Per-channel ``a`` and biases on requant ties of the sums ``acc_fn()``."""
    a = rng.uniform(1e-3, 2e-3, co).astype(F32)
    acc = acc_fn().numpy().astype(F32)
    return a, product_tie_biases(acc, a, F32(127) / F32(os_), relu)


def test_pad_nhwc_equals_jax():
    rng = np.random.default_rng(0)
    x = _s8(rng, (2, 5, 7, 3))
    got = nhwc_conv.pad_nhwc(_t(x))
    assert got.is_contiguous() and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(JN.pad_nhwc(jnp.asarray(x))))


# (b, h, w, c, co, out_scale, relu, lo): tests/unit/test_nhwc_conv.py's two
# cases (three row blocks and no ReLU in the second), a 3-channel input and a
# 5-channel one whose words end past C
NHWC_CASES = [
    (2, 16, 24, 16, 8, 0.7, True, 0),
    (1, 24, 16, 8, 8, 1.3, False, -127),
    (2, 8, 24, 3, 16, 0.9, True, 0),
    (1, 16, 8, 5, 3, 1.1, False, -127),
]


@pytest.mark.parametrize("kind", ["k3b", "k3a"])
@pytest.mark.parametrize("b,h,w,c,co,os_,relu,lo", NHWC_CASES)
def test_nhwc_plain_equals_pallas(kind, b, h, w, c, co, os_, relu, lo):
    """Zero pads (``pad_nhwc``): K3b and K3a agree with their JAX kernels and
    with each other."""
    rng = np.random.default_rng(c * 7 + co)
    x = _s8(rng, (b, h, w, c), lo, 127)
    k = _s8(rng, (3, 3, c, co))
    x_pad = np.asarray(JN.pad_nhwc(jnp.asarray(x)))
    a, bias = _operands(rng, lambda: nhwc_conv.nhwc_conv_i8(_t(x_pad), _port_kernel(k),
                                                            drop_h_pad=False),
                        co, os_, relu)
    jfn = JN.qconv3x3_nhwc_requant if kind == "k3b" else JN.qconv3x3_nhwc_dma
    tfn = nhwc_conv.qconv3x3_nhwc_requant if kind == "k3b" else nhwc_conv.qconv3x3_nhwc_dma
    ref = jfn(jnp.asarray(x_pad), jnp.asarray(k), jnp.asarray(a), jnp.asarray(bias),
              F32(os_), relu=relu, th=8, interpret=True)
    got = tfn(_t(x_pad), _port_kernel(k), _t(a), _t(bias), os_, relu=relu)
    assert got.dtype == torch.int8 and got.is_contiguous() and got.shape == (b, h, w, co)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    q = got.numpy()
    assert q.max() == 127 and q.min() == lo  # clips at both ends


def test_nonzero_h_pad_splits_k3a_from_k3b():
    """Pad rows and columns that are not zero: K3b drops the H-pad rows and
    reads zeros in their place, K3a reads them; both read the W-pad columns.
    Each port function equals its own JAX kernel, and the two differ exactly
    on the first and last output rows (no ReLU, and an out scale that clips
    nothing, so every changed sum can show)."""
    rng = np.random.default_rng(3)
    b, h, w, c, co = 2, 16, 12, 8, 8
    x_pad = _s8(rng, (b, h + 2, w + 2, c), 0, 127)  # every pad row and column live
    k = _s8(rng, (3, 3, c, co))
    a = rng.uniform(1e-3, 2e-3, co).astype(F32)
    bias = rng.normal(0, 0.1, co).astype(F32)
    acc = nhwc_conv.nhwc_conv_i8(_t(x_pad), _port_kernel(k), drop_h_pad=False).numpy()
    os_ = float(np.abs(acc * a + bias).max())
    args = (jnp.asarray(x_pad), jnp.asarray(k), jnp.asarray(a), jnp.asarray(bias), F32(os_))
    j3b = np.asarray(JN.qconv3x3_nhwc_requant(*args, relu=False, th=8, interpret=True))
    j3a = np.asarray(JN.qconv3x3_nhwc_dma(*args, relu=False, th=8, interpret=True))
    targs = (_t(x_pad), _port_kernel(k), _t(a), _t(bias), os_)
    t3b = nhwc_conv.qconv3x3_nhwc_requant(*targs, relu=False).numpy()
    t3a = nhwc_conv.qconv3x3_nhwc_dma(*targs, relu=False).numpy()
    np.testing.assert_array_equal(t3b, j3b)
    np.testing.assert_array_equal(t3a, j3a)
    differ = (t3a != t3b).any(axis=(0, 2, 3))
    assert differ[0] and differ[-1] and not differ[1:-1].any()


@pytest.mark.parametrize("in_phase,h,w,c,co,relu,packed", [
    ("A", 16, 24, 8, 8, True, True),
    ("B", 16, 16, 8, 8, True, True),
    ("A", 24, 12, 6, 5, False, False),
    ("B", 16, 20, 6, 5, False, False),
])
def test_pair_dma_plain_equals_pallas(in_phase, h, w, c, co, relu, packed):
    """K7a A→B and B→A, with ``pack_w_pair`` weights and with random packed
    weights (Cpk and Co2 off the 16-wide tiles); a B→A output's pad
    half-pairs are zero."""
    rng = np.random.default_rng(h * 3 + w + c)
    x = _s8(rng, (2, h, w, c), 0 if relu else -127, 127)
    if in_phase == "A":
        xp = np.asarray(JN.to_phase_a(jnp.asarray(x)))
    else:
        xp = x.reshape(2, h, w // 2, 2 * c)
    wp = (np.asarray(JN.pack_w_pair(jnp.asarray(_s8(rng, (3, 3, c, co))))) if packed
          else _s8(rng, (3, 2, 2 * c, 2 * co)))
    a2, bias2 = _operands(rng, lambda: nhwc_conv.pair_conv_i8(_t(xp), _port_pair(wp),
                                                              in_phase),
                          2 * co, 0.9, relu)
    ref = JN.qconv3x3_pair_dma(jnp.asarray(xp), jnp.asarray(wp), jnp.asarray(a2),
                               jnp.asarray(bias2), F32(0.9), in_phase=in_phase,
                               relu=relu, th=8, interpret=True)
    got = nhwc_conv.qconv3x3_pair_dma(_t(xp), _port_pair(wp), _t(a2), _t(bias2), 0.9,
                                      in_phase=in_phase, relu=relu)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if in_phase == "B":
        assert not got[:, :, 0, :co].any() and not got[:, :, -1, co:].any()


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """CPU tensors go to the plain versions, and no launch is counted."""
    rng = np.random.default_rng(5)
    x_pad = _t(_s8(rng, (1, 6, 7, 4)))
    k = _t(_s8(rng, (3, 3, 3, 4)))
    a, bias = torch.full((3,), 1e-3), torch.zeros(3)
    before = dict(_build.launches)
    for fn, ref in ((nhwc_conv.qconv3x3_nhwc_requant,
                     nhwc_conv.qconv3x3_nhwc_requant_reference),
                    (nhwc_conv.qconv3x3_nhwc_dma, nhwc_conv.qconv3x3_nhwc_dma_reference)):
        assert torch.equal(fn(x_pad, k, a, bias, 0.5), ref(x_pad, k, a, bias, 0.5))
    xp = _t(_s8(rng, (1, 3, 5, 8)))
    wp = _t(_s8(rng, (4, 3, 2, 8)))
    a2, b2 = torch.full((4,), 1e-3), torch.zeros(4)
    assert torch.equal(nhwc_conv.qconv3x3_pair_dma(xp, wp, a2, b2, 0.5),
                       nhwc_conv.qconv3x3_pair_requant(xp, wp, a2, b2, 0.5))
    assert dict(_build.launches) == before
    with pytest.raises(ValueError):
        nhwc_conv.qconv3x3_pair_dma(xp[:, :, :4].contiguous(), wp, a2, b2, 0.5)
