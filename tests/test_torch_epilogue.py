"""PyTorch port: the int8 epilogues round where JAX rounds.

Under ``jit`` on the CPU, XLA fuses a float32 multiply and the add that
consumes it into one fused multiply-add (FMA, one rounding). The port's
epilogues (``ops/qconv.py``: ``fma32``, ``dequant``, ``dequant_split``; the
CUDA sources in ``csrc/``) do the same. Where the fused and the unfused
roundings requantise to different int8 values (a requant tie, about once in
10^6 outputs of a real model), only the right rule agrees with JAX.

Each test below builds a small conv, computes its exact sums, and sets each
output channel's bias to a float32 value, searched one ulp at a time
(``torch_port_cases.tie_biases``), at which the formula's fused form and one
alternative rounding requantise apart at that channel's largest sum. Then it
shows what JAX computes there, under ``jit`` on the XLA route and with the
Pallas kernel in interpret mode where one exists, and holds the port's output
equal to it. The alternatives JAX does not follow are shown to differ from its
output, so each test finds JAX's rule and does not assume it.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from twinvoice_tpu.infer import quant as jquant
from twinvoice_tpu.ops import nhwc_conv as JN
from twinvoice_tpu.ops import qconv_pallas as QP
from twinvoice_tpu_torch.ops import nhwc_conv, qconv, qupsample

from tests.torch_port_cases import fma_f32, product_tie_biases, requant_np, tie_biases

F32 = np.float32
OUT_SCALE = F32(1.0)
INV = F32(127) / OUT_SCALE


def _mul(x, y):
    return (np.asarray(x, F32) * np.asarray(y, F32)).astype(F32)


def _add(x, y):
    return (np.asarray(x, F32) + np.asarray(y, F32)).astype(F32)


def _s8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_kernel(k_hwio):
    """JAX (kh,kw,Ci,Co) → the port's (Co,kh,kw,Ci)."""
    return _t(np.transpose(k_hwio, (3, 0, 1, 2)))


def _frame(x_nhwc):
    return QP.to_frame(jnp.asarray(np.transpose(x_nhwc, (1, 3, 2, 0))))


def _unframe(xf):
    return np.transpose(np.asarray(QP.from_frame(xf)), (3, 0, 2, 1))


def _exact_fma32(x, y, z):
    """The float32 nearest ``x·y + z`` (ties to even), from exact rationals."""
    fr = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
    c = F32(float(fr))
    best = None
    for cand in (np.nextafter(c, F32(-np.inf)), c, np.nextafter(c, F32(np.inf))):
        key = (abs(Fraction(float(cand)) - fr), int(cand.view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def test_fma32_is_the_exactly_rounded_fma():
    """``ops.qconv.fma32`` against exact rational arithmetic: random triples,
    triples that cancel, and products on a float32 midpoint plus or minus a
    tiny addend, where a float64 sum cast to float32 rounds twice and errs."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 100, 400).astype(F32)
    y = rng.uniform(1e-4, 2e-3, 400).astype(F32)
    z = np.concatenate([rng.normal(0, 2, 200), -(x[200:] * y[200:]) * 1.001]).astype(F32)
    mid = F32(1 + 2.0 ** -12)  # mid·mid = 1 + 2^-11 + 2^-24: a float32 midpoint
    tiny = F32(2.0 ** -80)
    x = np.concatenate([x, [mid, mid, mid, -mid]]).astype(F32)
    y = np.concatenate([y, [mid, mid, mid, mid]]).astype(F32)
    z = np.concatenate([z, [tiny, -tiny, 0, tiny]]).astype(F32)
    got = qconv.fma32(_t(x), _t(y), _t(z)).numpy()
    want = np.array([_exact_fma32(*v) for v in zip(x, y, z)], F32)
    np.testing.assert_array_equal(got, want)
    naive = (x.astype(np.float64) * y + z).astype(F32)
    assert (naive != want).any()  # the double rounding the TwoSum step repairs
    assert got[-4] == F32(1 + 2.0 ** -11 + 2.0 ** -23)


# -- the searched ties -----------------------------------------------------------


def _hold(jax_q, port_q, fused_q, others_q):
    """The port equals JAX; JAX equals the fused rule's emulation and differs
    from every alternative's somewhere (so the ties are real)."""
    jax_q = np.asarray(jax_q)
    np.testing.assert_array_equal(port_q, jax_q)
    np.testing.assert_array_equal(fused_q, jax_q)
    for name, q in others_q.items():
        assert (q != jax_q).any(), f"JAX's output is also the {name} form's"


def _product_case(seed, relu, co=8):
    rng = np.random.default_rng(seed)
    x, k = _s8(rng, (2, 6, 7, 8)), _s8(rng, (3, 3, 8, co))
    w_scale = rng.uniform(1e-3, 2e-3, co).astype(F32)
    s_in = F32(0.83)
    a = _mul(s_in, w_scale)
    acc = qconv.conv3x3_i8(_t(x), _port_kernel(k)).numpy().astype(F32)
    bias = product_tie_biases(acc, a, INV, relu)
    fused = requant_np(fma_f32(acc, a, bias), INV, relu)
    sep = requant_np(_add(_mul(acc, a), bias), INV, relu)
    return x, k, w_scale, s_in, a, bias, fused, sep


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_product_epilogue_is_one_fma(route):
    """``acc·(s_in·w_scale) + bias``: ``quant._qconv`` on the XLA route, K4a
    (``qconv_pallas.qconv3x3_requant``) in interpret mode; the port's K4a
    (product mode) computes ``fma(acc, s_in·w_scale, bias)``."""
    x, k, w_scale, s_in, a, bias, fused, sep = _product_case(11, True)
    if route == "xla":
        def f(x, k, w_scale, bias, s_in, s_out):
            qp = {"kernel": k, "w_scale": w_scale, "bias": bias}
            y = jquant._qconv(x, s_in, qp, jquant._conv3x3_i8)
            return jquant._requant(jax.nn.relu(y), s_out)

        jq = jax.jit(f)(x, k, w_scale, bias, s_in, OUT_SCALE)
    else:
        jq = _unframe(QP.qconv3x3_requant(_frame(x), QP.pack_w3x3(k), jnp.asarray(a),
                                          jnp.asarray(bias), OUT_SCALE, interpret=True))
    got = qconv.qconv3x3_requant(_t(x), _port_kernel(k), _t(w_scale), _t(bias), s_in,
                                 float(OUT_SCALE)).numpy()
    _hold(jq, got, fused, {"unfused": sep})


def test_chain_epilogue_fuses_the_last_multiply():
    """The concat decoder's ``part·s_up·w + bias`` (``quant.py:237``) is
    ``fma(part·s_up, w, bias)`` under ``jit``; the port's K4a with
    ``scale_first`` computes the same."""
    rng = np.random.default_rng(12)
    x, k = _s8(rng, (2, 6, 7, 16)), _s8(rng, (3, 3, 16, 8))
    w = rng.uniform(1e-3, 2e-3, 8).astype(F32)
    s_up = F32(0.0041)
    acc = qconv.conv3x3_i8(_t(x), _port_kernel(k)).numpy().astype(F32)
    p = _mul(acc, s_up)
    bias = product_tie_biases(p, w, INV, True)  # fma(p, w, b) against p·w + b

    def f(hcat, k, s_up, w1, bias, s1):
        part = jquant._conv3x3_i8(hcat, {"kernel": k}).astype(jnp.float32)
        y = part * s_up * w1 + bias
        return jquant._requant(jax.nn.relu(y), s1)

    jq = jax.jit(f)(x, k, s_up, w, bias, OUT_SCALE)
    got = qconv.qconv3x3_requant(_t(x), _port_kernel(k), _t(w), _t(bias), s_up,
                                 float(OUT_SCALE), scale_first=True).numpy()
    _hold(jq, got, requant_np(fma_f32(p, w, bias), INV, True),
          {"unfused": requant_np(_add(_mul(p, w), bias), INV, True)})


def test_split_epilogue_fuses_the_first_product():
    """The split decoder's ``(part_up·s_up + part_skip·s_skip)·w + bias``
    (``quant.py:242``) under ``jit``: XLA fuses the first product into the
    sum and the outer multiply into the bias add, ``fma(fma(part_up, s_up,
    part_skip·s_skip), w, bias)``. Each alternative (no fusion, only the
    outer, the second product instead of the first, only the inner) gets
    channels of its own whose bias sits on a tie between it and that rule,
    and JAX's output differs from each; the port's K5 with ``s_in2`` equals
    JAX's."""
    rng = np.random.default_rng(13)
    up, skip = _s8(rng, (2, 6, 7, 8)), _s8(rng, (2, 6, 7, 8))
    k = _s8(rng, (3, 3, 16, 8))
    w = rng.uniform(1e-3, 2e-3, 8).astype(F32)
    s_up, s_skip = F32(0.0041), F32(0.0037)
    kp = _port_kernel(k)
    k_up, k_skip = kp[..., :8].contiguous(), kp[..., 8:].contiguous()
    a1 = qconv.conv3x3_i8(_t(up), k_up).numpy().astype(F32)
    a2 = qconv.conv3x3_i8(_t(skip), k_skip).numpy().astype(F32)

    def rule(a1, a2, w, b):
        return fma_f32(fma_f32(a1, s_up, _mul(a2, s_skip)), w, b)

    others = {
        "unfused": lambda a1, a2, w, b: _add(_mul(_add(_mul(a1, s_up), _mul(a2, s_skip)),
                                                  w), b),
        "outer-only": lambda a1, a2, w, b: fma_f32(_add(_mul(a1, s_up), _mul(a2, s_skip)),
                                                   w, b),
        "second-product": lambda a1, a2, w, b: fma_f32(fma_f32(a2, s_skip,
                                                               _mul(a1, s_up)), w, b),
        "inner-only": lambda a1, a2, w, b: _add(_mul(fma_f32(a1, s_up, _mul(a2, s_skip)),
                                                     w), b),
    }
    names = list(others)
    # the channel's largest |sum| where the halves cancel, so the inner
    # roundings matter at the outer step
    mixed = np.where(np.sign(a1) != np.sign(a2), np.minimum(np.abs(a1), np.abs(a2)), 0)

    def forms_at(c, idx):
        alt = others[names[c % len(names)]]
        i = idx + (c,)
        return [lambda b: rule(a1[i], a2[i], w[c], b), lambda b: alt(a1[i], a2[i], w[c], b)]

    bias = tie_biases(forms_at, mixed, INV, True, 60)

    def f(up, skip, k, w1, bias, s_up, s_skip, s1):
        c = up.shape[-1]
        part_up = jquant._conv3x3_i8(up, {"kernel": k[:, :, :c]}).astype(jnp.float32)
        part_skip = jquant._conv3x3_i8(skip, {"kernel": k[:, :, c:]}).astype(jnp.float32)
        y = (part_up * s_up + part_skip * s_skip) * w1 + bias
        return jquant._requant(jax.nn.relu(y), s1)

    jq = jax.jit(f)(up, skip, k, w, bias, s_up, s_skip, OUT_SCALE)
    got = qconv.qconv3x3_split_requant(_t(up), _t(skip), k_up, k_skip, _t(w), _t(bias),
                                       s_up, float(OUT_SCALE), s_in2=s_skip).numpy()
    _hold(jq, got, requant_np(rule(a1, a2, w, bias), INV, True),
          {n: requant_np(g(a1, a2, w, bias), INV, True) for n, g in others.items()})


def test_shared_split_epilogue_is_one_fma():
    """K5 (``qconv_pallas.qconv3x3_split_requant``) in interpret mode: one s32
    sum of both halves, ``fma(acc, a, bias)``; the port's K5 without
    ``s_in2``."""
    rng = np.random.default_rng(14)
    x, x2 = _s8(rng, (2, 8, 8, 8)), _s8(rng, (2, 8, 8, 8))
    k, k2 = _s8(rng, (3, 3, 8, 8)), _s8(rng, (3, 3, 8, 8))
    w_scale = rng.uniform(1e-3, 2e-3, 8).astype(F32)
    s_in = F32(0.0041)
    a = _mul(s_in, w_scale)
    acc = (qconv.conv3x3_i8(_t(x), _port_kernel(k))
           + qconv.conv3x3_i8(_t(x2), _port_kernel(k2))).numpy().astype(F32)

    bias = product_tie_biases(acc, a, INV, True)
    cc = QP._plan_tiles(8, 8, 8, 2, 8, two_inputs=True)[2]
    jq = _unframe(QP.qconv3x3_split_requant(
        _frame(x), _frame(x2), QP.pack_w3x3(k, cc), QP.pack_w3x3(k2, cc), jnp.asarray(a),
        jnp.asarray(bias), OUT_SCALE, interpret=True))
    got = qconv.qconv3x3_split_requant(_t(x), _t(x2), _port_kernel(k), _port_kernel(k2),
                                       _t(w_scale), _t(bias), s_in,
                                       float(OUT_SCALE)).numpy()
    _hold(jq, got, requant_np(fma_f32(acc, a, bias), INV, True),
          {"unfused": requant_np(_add(_mul(acc, a), bias), INV, True)})


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_upsample_epilogue_is_one_fma(route):
    """K6's ``acc·(s·w_scale) + bias`` with its symmetric requant: the XLA
    transpose conv of ``quant.py:220-229`` and ``qupsample2x2_requant`` in
    interpret mode; the port's K6 computes ``fma(acc, s·w_scale, bias)``."""
    rng = np.random.default_rng(15)
    x, k = _s8(rng, (2, 4, 5, 32)), _s8(rng, (2, 2, 32, 8))
    w_scale = rng.uniform(1e-3, 2e-3, 8).astype(F32)
    s = F32(0.83)
    a = _mul(s, w_scale)
    kp = _port_kernel(k)
    acc = qconv.conv_transpose2x2_i8(_t(x), kp).numpy().astype(F32)

    bias = product_tie_biases(acc, a, INV, False)
    if route == "xla":
        def f(h, k, w_scale, bias, s, s_out):
            up = jquant._conv_transpose2x2_i8(h, k)
            up = up.astype(jnp.float32) * (s * w_scale)
            up = up + bias
            return jnp.clip(jnp.round(up * (127.0 / s_out)), -127, 127).astype(jnp.int8)

        jq = jax.jit(f)(x, k, w_scale, bias, s, OUT_SCALE)
    else:
        jq = _unframe(QP.qupsample2x2_requant(_frame(x), QP.pack_wup(k), jnp.asarray(a),
                                              jnp.asarray(bias), OUT_SCALE,
                                              interpret=True))
    got = qupsample.qupsample2x2_requant(_t(x), kp, _t(w_scale), _t(bias), s,
                                         float(OUT_SCALE)).numpy()
    _hold(jq, got, requant_np(fma_f32(acc, a, bias), INV, False),
          {"unfused": requant_np(_add(_mul(acc, a), bias), INV, False)})


@pytest.mark.parametrize("in_phase,p", [("A", 5), ("B", 4)])
def test_pair_epilogue_is_one_fma(in_phase, p):
    """K7b (``nhwc_conv.qconv3x3_pair_requant``) in interpret mode at
    ``th=8``: ``acc·a2 + bias2`` is ``fma(acc, a2, bias2)``; the port's K7b
    computes the same, A→B and B→A."""
    rng = np.random.default_rng(16 + p)
    x, wp = _s8(rng, (1, 8, p, 16)), _s8(rng, (3, 2, 16, 8))
    a2 = (rng.uniform(1e-3, 2e-3, 8) * 0.83).astype(F32)
    wpp = _t(np.transpose(wp, (3, 0, 1, 2)))
    acc = nhwc_conv.pair_conv_i8(_t(x), wpp, in_phase).numpy().astype(F32)
    if in_phase == "B":  # the pad half-pairs of a phase-A output are zero
        acc[:, :, 0, :4] = 0
        acc[:, :, -1, 4:] = 0

    bias = product_tie_biases(acc, a2, INV, True)
    jq = JN.qconv3x3_pair_requant(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(a2),
                                  jnp.asarray(bias), OUT_SCALE, in_phase=in_phase, th=8,
                                  interpret=True)
    got = nhwc_conv.qconv3x3_pair_requant(_t(x), wpp, _t(a2), _t(bias), float(OUT_SCALE),
                                          in_phase=in_phase).numpy()
    fused = nhwc_conv._zero_pad_pairs(torch.from_numpy(
        requant_np(fma_f32(acc, a2, bias), INV, True)), in_phase).numpy()
    sep = nhwc_conv._zero_pad_pairs(torch.from_numpy(
        requant_np(_add(_mul(acc, a2), bias), INV, True)), in_phase).numpy()
    _hold(jq, got, fused, {"unfused": sep})
