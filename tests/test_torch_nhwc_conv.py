"""PyTorch port: the pair-packed weights, the phase views and K7b's plain
version (``twinvoice_tpu_torch.ops.nhwc_conv``) against
``twinvoice_tpu.ops.nhwc_conv``, its Pallas kernel run in interpret mode as
``tests/unit/test_nhwc_conv.py`` runs it (``th=8``, H a multiple of 8).

The port's packed weight is ``(Co2,3,2,Cpk)``, JAX's ``(3,2,Cpk,Co2)``. The
int8 outputs must be bit-equal: the s32 sums are exact in both and the
float32 epilogue rounds at the same steps."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from twinvoice_tpu.ops import nhwc_conv as jnc
from twinvoice_tpu_torch.ops import nhwc_conv as nc
from twinvoice_tpu_torch.ops.qconv import qconv3x3_requant_reference


def _port_k(k):
    """JAX (3,3,Ci,Co) → the port's (Co,3,3,Ci)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 0, 1, 2)))


def _port_wp(wp):
    """JAX (3,2,Cpk,Co2) → the port's (Co2,3,2,Cpk)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(wp).transpose(3, 0, 1, 2)))


def _case(rng, b, h, w, c, co, lo=0):
    x = rng.integers(lo, 127, (b, h, w, c), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, c, co), dtype=np.int8)
    a = rng.uniform(1e-3, 2e-3, (co,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (co,)).astype(np.float32)
    return x, k, a, bias


def _both(x, wp, a2, b2, out_scale, in_phase, relu=True):
    """The JAX kernel (interpret mode) and the port's plain version on the
    same packed input and weights → (jax, port) int8 arrays."""
    j = jnc.qconv3x3_pair_requant(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(a2),
                                  jnp.asarray(b2), jnp.float32(out_scale),
                                  in_phase=in_phase, relu=relu, th=8)
    t = nc.qconv3x3_pair_requant(torch.from_numpy(np.array(x)), _port_wp(wp),
                                 torch.from_numpy(a2), torch.from_numpy(b2), out_scale,
                                 in_phase=in_phase, relu=relu)
    assert t.dtype == torch.int8 and t.is_contiguous()
    return np.asarray(j), t.numpy()


def test_pack_w_pair_and_multi_equal_jax(rng):
    ka = rng.integers(-127, 128, (3, 3, 8, 4), dtype=np.int8)
    kb = rng.integers(-127, 128, (3, 3, 5, 4), dtype=np.int8)
    np.testing.assert_array_equal(nc.pack_w_pair(_port_k(ka)).numpy(),
                                  _port_wp(jnc.pack_w_pair(jnp.asarray(ka))).numpy())
    multi = nc.pack_w_pair_multi([_port_k(ka), _port_k(kb)])
    assert multi.shape == (8, 3, 2, 26)
    np.testing.assert_array_equal(
        multi.numpy(),
        _port_wp(jnc.pack_w_pair_multi([jnp.asarray(ka), jnp.asarray(kb)])).numpy())


def test_phase_views_equal_jax(rng):
    x = rng.integers(-127, 128, (2, 5, 12, 3), dtype=np.int8)
    a = nc.to_phase_a(torch.from_numpy(x))
    assert a.shape == (2, 5, 7, 6)
    np.testing.assert_array_equal(a.numpy(), np.asarray(jnc.to_phase_a(jnp.asarray(x))))
    t = x.reshape(2, 5, 6, 6)
    b = nc.from_phase_b(torch.from_numpy(t))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jnc.from_phase_b(jnp.asarray(t))))
    np.testing.assert_array_equal(b.numpy(), x)


# (b, h, w, c, co, relu, lo): w=24 and w=8 give P_out not a multiple of the
# TPU's 8-pair alignment (the odd-P paths of nhwc_conv.py:497-507)
SHAPES = [(2, 32, 24, 16, 8, True, 0), (1, 24, 16, 8, 8, True, 0),
          (1, 8, 8, 4, 8, True, 0), (2, 16, 40, 6, 10, False, -127)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("in_phase", ["A", "B"])
def test_k7b_plain_bit_equal_to_jax(rng, shape, in_phase):
    """One conv A→B (a to_phase_a input) or B→A (the NHWC tensor viewed as
    pairs), with pack_w_pair weights; relu=False takes signed inputs."""
    b, h, w, c, co, relu, lo = shape
    x, k, a, bias = _case(rng, b, h, w, c, co, lo)
    xin = (np.asarray(jnc.to_phase_a(jnp.asarray(x))) if in_phase == "A"
           else x.reshape(b, h, w // 2, 2 * c))
    wp = np.asarray(jnc.pack_w_pair(jnp.asarray(k)))
    j, t = _both(xin, wp, np.tile(a, 2), np.tile(bias, 2), 0.9, in_phase, relu)
    assert t.shape == (b, h, w // 2 + (1 if in_phase == "B" else 0), 2 * co)
    np.testing.assert_array_equal(t, j)
    lo_out = 0 if relu else -127
    assert (t == 127).any() and (t == lo_out).any()  # both clips are exercised


def test_k7b_plain_chain_a_b_a_bit_equal_to_jax(rng):
    """A→B then B→A with zero relayout: the second conv reads the first's
    output as it lies, and the B→A output's pad half-pairs are zero."""
    x, k1, a1, b1 = _case(rng, 1, 16, 16, 8, 8)
    _, k2, a2, b2 = _case(rng, 1, 16, 16, 8, 8)
    xa = np.asarray(jnc.to_phase_a(jnp.asarray(x)))
    wp1 = np.asarray(jnc.pack_w_pair(jnp.asarray(k1)))
    wp2 = np.asarray(jnc.pack_w_pair(jnp.asarray(k2)))
    j1, t1 = _both(xa, wp1, np.tile(a1, 2), np.tile(b1, 2), 0.8, "A")
    np.testing.assert_array_equal(t1, j1)
    j2, t2 = _both(t1, wp2, np.tile(a2, 2), np.tile(b2, 2), 1.2, "B")
    np.testing.assert_array_equal(t2, j2)
    assert t2.shape == (1, 16, 9, 16)
    assert not t2[:, :, 0, :8].any() and not t2[:, :, -1, 8:].any()
    assert t2[:, :, 0, 8:].any() and t2[:, :, -1, :8].any()


def test_k7b_plain_two_sources_bit_equal_to_jax(rng):
    """The decoder's conv1: the channel concat of two phase-B sources
    ([up(2p)|up(2p+1)|skip(2p)|skip(2p+1)]) with pack_w_pair_multi weights,
    B→A."""
    up, k, a, bias = _case(rng, 2, 16, 24, 8, 8, lo=-127)
    skip = rng.integers(0, 127, up.shape, dtype=np.int8)
    tcat = np.concatenate([up.reshape(2, 16, 12, 16), skip.reshape(2, 16, 12, 16)], -1)
    k2 = rng.integers(-127, 128, (3, 3, 8, 8), dtype=np.int8)
    wp = np.asarray(jnc.pack_w_pair_multi([jnp.asarray(k), jnp.asarray(k2)]))
    j, t = _both(tcat, wp, np.tile(a, 2), np.tile(bias, 2), 1.0, "B")
    np.testing.assert_array_equal(t, j)
    # the same sums as an unpacked conv over the NHWC concat [up|skip]
    kk = torch.from_numpy(np.concatenate([k, k2], 2).transpose(3, 0, 1, 2).copy())
    un = qconv3x3_requant_reference(torch.from_numpy(np.concatenate([up, skip], -1)), kk,
                                    torch.from_numpy(a), torch.from_numpy(bias), 1.0, 1.0)
    np.testing.assert_array_equal(t, nc.to_phase_a(un).numpy())


@pytest.mark.parametrize("in_phase", ["A", "B"])
def test_k7b_plain_random_packed_weights_bit_equal_to_jax(rng, in_phase):
    """Weights that pack_w_pair could not produce: every tap of both views
    live, for both output halves."""
    b, h, p, cpk, co2 = 2, 16, (7 if in_phase == "A" else 6), 12, 10
    x = rng.integers(-127, 128, (b, h, p, cpk), dtype=np.int8)
    wp = rng.integers(-127, 128, (3, 2, cpk, co2), dtype=np.int8)
    a2 = rng.uniform(1e-4, 3e-4, (co2,)).astype(np.float32)
    b2 = rng.normal(0, 0.1, (co2,)).astype(np.float32)
    j, t = _both(x, wp, a2, b2, 1.5, in_phase, relu=False)
    np.testing.assert_array_equal(t, j)
    if in_phase == "B":
        assert not t[:, :, 0, :5].any() and not t[:, :, -1, 5:].any()


def test_k7b_rejects_a_width_of_the_wrong_phase_and_a_device_without_kernel():
    x = torch.zeros((1, 8, 6, 4), dtype=torch.int8)
    wp = torch.zeros((4, 3, 2, 4), dtype=torch.int8)
    v = torch.ones(4)
    with pytest.raises(ValueError, match="phase-A width"):
        nc.qconv3x3_pair_requant(x, wp, v, v, 1.0, in_phase="A")
    with pytest.raises(ValueError, match="in_phase"):
        nc.qconv3x3_pair_requant(x, wp, v, v, 1.0, in_phase="C")
    with pytest.raises(ValueError, match="no kernel for meta"):
        nc.qconv3x3_pair_requant(x.to("meta"), wp, v, v, 1.0, in_phase="B")
