"""PyTorch port: K4b (``ops/qconv.py:qconv3x3_requant_dma``) against the JAX
package's ``qconv_pallas.qconv3x3_requant_dma`` in interpret mode, on the same
numpy inputs, with ``mxu_bf16`` off and on.

The JAX kernel takes and returns frames: its input is made by ``to_frame``
and its output read back unframed, as ``tests/unit/test_qconv_pallas.py``
does. The port's wrapper takes its plain version on these CPU tensors. The
sums are integer-exact (JAX's bf16 mode too at these sizes), so outputs must
be bit-equal; each case's biases sit on searched requant ties, so the fused
multiply-add of the epilogue is held as well.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from twinvoice_tpu.ops import qconv_pallas as QP
from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.ops import qconv

from tests.torch_port_cases import product_tie_biases

F32 = np.float32


def _s8(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _frame(x_nhwc):
    return QP.to_frame(jnp.asarray(np.transpose(x_nhwc, (1, 3, 2, 0))))


def _unframe(xf):
    return np.transpose(np.asarray(QP.from_frame(xf)), (3, 0, 2, 1))


# (n, h, w, cin, cout, out_scale, relu): tests/unit/test_qconv_pallas.py's
# case, odd H != W with Cin 3 and Co 5, no ReLU, Cin 16 to 16
CASES = [
    (2, 16, 16, 8, 8, 3.7, True),
    (1, 7, 11, 3, 5, 0.6, True),
    (2, 9, 13, 16, 16, 1.3, False),
    (1, 8, 24, 12, 24, 2.0, True),
]


@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("n,h,w,cin,cout,os_,relu", CASES)
def test_k4b_plain_equals_pallas(mxu_bf16, n, h, w, cin, cout, os_, relu):
    rng = np.random.default_rng(cin * 13 + cout)
    x = _s8(rng, (n, h, w, cin), 0 if relu else -127, 127)
    k = _s8(rng, (3, 3, cin, cout))
    kp = _t(np.transpose(k, (3, 0, 1, 2)))
    a = rng.uniform(1e-3, 2e-3, cout).astype(F32)
    acc = qconv.conv3x3_i8(_t(x), kp).numpy().astype(F32)
    bias = product_tie_biases(acc, a, F32(127) / F32(os_), relu)
    ref = QP.qconv3x3_requant_dma(_frame(x), QP.pack_w3x3(k), jnp.asarray(a),
                                  jnp.asarray(bias), F32(os_), relu=relu,
                                  interpret=True, mxu_bf16=mxu_bf16)
    got = qconv.qconv3x3_requant_dma(_t(x), kp, _t(a), _t(bias), os_, relu=relu,
                                     mxu_bf16=mxu_bf16)
    assert got.dtype == torch.int8 and got.is_contiguous() and got.shape == (n, h, w, cout)
    np.testing.assert_array_equal(got.numpy(), _unframe(ref))
    # K4a computes the same from w_scale and s_in when a = s_in·w_scale
    s_in = F32(1.0)
    np.testing.assert_array_equal(
        got.numpy(),
        qconv.qconv3x3_requant(_t(x), kp, _t(a), _t(bias), s_in, os_, relu=relu).numpy())


def test_k4b_takes_one_cin_chunk_and_the_plain_version_on_the_cpu():
    """Cin > 128 raises, as JAX asserts one chunk; CPU tensors go to the
    plain version and no launch is counted."""
    rng = np.random.default_rng(9)
    a, bias = torch.full((4,), 1e-3), torch.zeros(4)
    with pytest.raises(ValueError, match="Cin 129"):
        qconv.qconv3x3_requant_dma(_t(_s8(rng, (1, 4, 4, 129))), _t(_s8(rng, (4, 3, 3, 129))),
                                   a, bias, 1.0)
    x, k = _t(_s8(rng, (1, 5, 6, 128))), _t(_s8(rng, (4, 3, 3, 128)))
    before = dict(_build.launches)
    got = qconv.qconv3x3_requant_dma(x, k, a, bias, 40.0, relu=False)
    assert torch.equal(got, qconv.qconv3x3_requant_dma_reference(x, k, a, bias, 40.0,
                                                                 relu=False))
    assert dict(_build.launches) == before
