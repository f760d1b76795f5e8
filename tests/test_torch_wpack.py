"""PyTorch port: the W-phase int8 trunk (``twinvoice_tpu_torch.infer.wpack``)
against ``twinvoice_tpu.infer.wpack``.

The packing helpers and the packed XLA forms are held to JAX's on the cases
of ``tests/unit/test_wpack.py``; the trunks on a random base-width-8 U-Net at
32², with the JAX functions under ``jit`` and JAX's qparams carried across,
as ``tests/test_torch_quant.py`` does. The int8 features are bit-equal; the
float32 logits and maxima differ only in the order of the 1×1 head's sum
(within 1e-5, the bound of ``test_wpack.py``'s maxima)."""

import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from twinvoice_tpu.infer import quant as jquant
from twinvoice_tpu.infer import wpack as jw
from twinvoice_tpu_torch.infer import wpack as tw

from tests.test_torch_pipeline import pages
from tests.torch_port_cases import int8_unet

GRID = 32


def _i8(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int8)


def _port_k(k):
    """A JAX kernel (kh,kw,Ci,Co) → the port's (Co,kh,kw,Ci)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 0, 1, 2)))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_packed_kernels_and_tile2_equal_jax(rng):
    k = _i8(rng, (3, 3, 5, 4))
    k2 = _i8(rng, (3, 3, 3, 4))
    np.testing.assert_array_equal(tw.pack_kernel_out(_port_k(k)).numpy(),
                                  _port_k(jw.pack_kernel_out(jnp.asarray(k))).numpy())
    np.testing.assert_array_equal(
        tw.pack_kernel_in_out([_port_k(k), _port_k(k2)]).numpy(),
        _port_k(jw.pack_kernel_in_out([jnp.asarray(k), jnp.asarray(k2)])).numpy())
    v = rng.normal(size=6).astype(np.float32)
    np.testing.assert_array_equal(tw.tile2(_t(v)).numpy(),
                                  np.asarray(jw.tile2(jnp.asarray(v))))


def test_pack_out_conv_equals_jax(rng):
    x, k = _i8(rng, (2, 8, 12, 16)), _i8(rng, (3, 3, 16, 8))
    kp = jw.pack_kernel_out(jnp.asarray(k))
    ref = np.asarray(jw.conv3x3_pack_out_i8(jnp.asarray(x), kp))
    got = tw.conv3x3_pack_out_i8(_t(x), tw.pack_kernel_out(_port_k(k)))
    assert got.dtype == torch.float64 and got.shape == (2, 8, 6, 16)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_packed_in_conv_equals_jax(rng):
    xa, xb = _i8(rng, (2, 8, 12, 8)), _i8(rng, (2, 8, 12, 8))
    ka, kb = _i8(rng, (3, 3, 8, 8)), _i8(rng, (3, 3, 8, 8))
    t = np.concatenate([xa.reshape(2, 8, 6, 16), xb.reshape(2, 8, 6, 16)], -1)
    ref = np.asarray(jw.conv3x3_packed_i8(
        jnp.asarray(t), jw.pack_kernel_in_out([jnp.asarray(ka), jnp.asarray(kb)])))
    got = tw.conv3x3_packed_i8(_t(t), tw.pack_kernel_in_out([_port_k(ka), _port_k(kb)]))
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the unpacked sums of the concat conv, as test_wpack.py pins
    np.testing.assert_array_equal(
        tw.unpack(got).numpy(),
        np.asarray(jquant._conv3x3_i8(jnp.concatenate([xa, xb], -1),
                                      {"kernel": jnp.concatenate([ka, kb], 2)})))


def test_pack_out_transpose_conv_equals_jax(rng):
    x, k = _i8(rng, (2, 6, 10, 16)), _i8(rng, (2, 2, 16, 8))
    ref = np.asarray(jw.conv_transpose2x2_pack_out_i8(jnp.asarray(x), jnp.asarray(k)))
    got = tw.conv_transpose2x2_pack_out_i8(_t(x), _port_k(k))
    assert got.shape == (2, 12, 10, 16)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_max_pool2_packed_and_unpack_equal_jax(rng):
    t = _i8(rng, (2, 8, 6, 16))
    np.testing.assert_array_equal(tw.max_pool2_packed(_t(t)).numpy(),
                                  np.asarray(jw.max_pool2_packed(jnp.asarray(t))))
    np.testing.assert_array_equal(tw.unpack(_t(t)).numpy(),
                                  np.asarray(jw.unpack(jnp.asarray(t))))


@pytest.fixture(scope="module")
def model():
    return int8_unet(3, GRID)


def _imgs(seed=0, n=2):
    return pages(seed, n, GRID, GRID)


@pytest.mark.parametrize("mode", ["full", "enc"])
def test_wpack_features_bit_equal_to_jax(model, mode):
    imgs = _imgs()
    jh, js = jax.jit(jw.unet_apply_quantized_features_wpack, static_argnames="mode")(
        model["jq"], jnp.asarray(imgs), mode=mode)
    th, ts = tw.unet_apply_quantized_features_wpack(model["q"], _t(imgs), mode=mode)
    assert th.dtype == torch.int8 and th.shape == jh.shape
    assert th.shape == ((2, GRID, GRID // 2, 16) if mode == "full" else (2, GRID, GRID, 8))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert np.float32(ts) == np.asarray(js)


@pytest.mark.parametrize("mode", ["full", "enc"])
def test_wpack_logits_match_jax(model, mode):
    """float32 logits within 1e-5: the int8 trunk is bit-equal and only the
    1×1 head's float32 sum runs in another order than XLA's (as in
    ``test_torch_quant.test_logits_match_jax``)."""
    imgs = _imgs(1)
    jl = jax.jit(jw.unet_apply_quantized_wpack, static_argnames="mode")(
        model["jq"], jnp.asarray(imgs), mode=mode)
    tl = tw.unet_apply_quantized_wpack(model["q"], _t(imgs), mode=mode)
    assert tl.dtype == torch.float32 and tl.shape == (2, GRID, GRID, 3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["full", "enc"])
def test_wpack_rowcol_maxima_match_jax(model, mode):
    imgs = _imgs(2, 3)
    jr, jc = jax.jit(jw.unet_apply_quantized_wpack_rowcol_max, static_argnames="mode")(
        model["jq"], jnp.asarray(imgs), mode=mode)
    tr, tc = tw.unet_apply_quantized_wpack_rowcol_max(model["q"], _t(imgs), mode=mode)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_nhwc_features_bit_equal_to_jax(model):
    """The K7b trunk, JAX's kernel in interpret mode at th=8."""
    imgs = _imgs()
    jh, js = jax.jit(jw.unet_apply_quantized_features_nhwc, static_argnames="th")(
        model["jq"], jnp.asarray(imgs), th=8)
    th, ts = tw.unet_apply_quantized_features_nhwc(model["q"], _t(imgs))
    assert th.dtype == torch.int8 and th.shape == (2, GRID, GRID // 2, 16)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert np.float32(ts) == np.asarray(js)


def test_nhwc_rowcol_maxima_match_jax(model):
    imgs = _imgs(2, 3)
    jr, jc = jax.jit(jw.unet_apply_quantized_nhwc_rowcol_max, static_argnames="th")(
        model["jq"], jnp.asarray(imgs), th=8)
    tr, tc = tw.unet_apply_quantized_nhwc_rowcol_max(model["q"], _t(imgs))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_xla_cpu_contracts_the_concat_epilogue_into_an_fma():
    """Under ``jit`` on the CPU, XLA computes the concat decoder's
    ``part·s_up·w + b`` (``quant.py:237``) as ``fma(part·s_up, w, b)``, and
    so does the port (K4a's chain mode, and its plain version). At this
    requant tie the two roundings differ by one int8: JAX and the port give
    45, the unfused form 44. The scalars are level 2's decoder conv1 of the
    32² model of this file on ``pages(1, 8, 32, 32)``, image 7, row 11,
    column 10, channel 5."""
    from twinvoice_tpu_torch.infer.quant import act_scale
    from twinvoice_tpu_torch.ops.qconv import dequant, requant

    acc, w, b = -19749.0, 0.00047504977555945516, 0.130731001496315
    s_out, s1 = 0.4889596998691559, 0.2700120210647583

    def jax_epilogue(part, s_out, w1, bias, s1):
        y = part * (s_out / 127.0) * w1 + bias
        return jquant._requant(jax.nn.relu(y), s1)

    f32 = [jnp.float32(v) for v in (acc, s_out, w, b, s1)]
    jq = int(jax.jit(jax_epilogue)(*f32))
    y = dequant(torch.tensor([acc], dtype=torch.float64), torch.tensor([w]),
                torch.tensor([b]), act_scale(s_out), scale_first=True)
    tq = int(requant(y, s1)[0])
    # the exact fma of float32 operands, through float64 (exact at these values)
    p = np.float32(np.float32(acc) * (np.float32(s_out) / np.float32(127)))
    y_fma = np.float32(np.float64(p) * np.float64(np.float32(w)) + np.float64(np.float32(b)))
    inv = np.float32(127) / np.float32(s1)
    assert jq == tq == int(np.round(y_fma * inv)) == 45
    y_sep = np.float32(np.float32(p * np.float32(w)) + np.float32(b))
    assert int(np.round(y_sep * inv)) == 44


def test_each_route_keeps_its_epilogue_association(model):
    """At the level-0 decoder conv1 "full" computes ``(acc·s_up)·w + b`` (the
    concat graph) and "nhwc" K7b's ``acc·(s_up·w) + b``. The two round apart
    about once in 10^6 outputs, which no seed showed at 32²; so channel 0's
    bias is set to a float32 value, found by a search over that conv's exact
    sums on these images, that puts two outputs of that channel on a requant
    boundary between the two associations. The JAX routes then differ, and
    each port route equals its JAX route bit for bit."""
    bias = np.array(model["jq"]["dec"][-1]["conv1"]["bias"])
    bias[0] = np.float32(0.07837142050266266)
    jq = dict(model["jq"], dec=list(model["jq"]["dec"]))
    jq["dec"][-1] = dict(jq["dec"][-1], conv1=dict(jq["dec"][-1]["conv1"],
                                                    bias=jnp.asarray(bias)))
    q = dict(model["q"], dec=list(model["q"]["dec"]))
    q["dec"][-1] = dict(q["dec"][-1], conv1=dict(q["dec"][-1]["conv1"], bias=_t(bias)))
    imgs = _imgs()
    jn, _ = jax.jit(jw.unet_apply_quantized_features_nhwc, static_argnames="th")(
        jq, jnp.asarray(imgs), th=8)
    jf, _ = jax.jit(jw.unet_apply_quantized_features_wpack, static_argnames="mode")(
        jq, jnp.asarray(imgs), mode="full")
    tn, _ = tw.unet_apply_quantized_features_nhwc(q, _t(imgs))
    tf, _ = tw.unet_apply_quantized_features_wpack(q, _t(imgs), mode="full")
    assert (np.asarray(jn) != np.asarray(jf)).sum() == 2
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def _segmenter(model, **kw):
    from twinvoice_tpu_torch.config import InferConfig, UNetConfig
    from twinvoice_tpu_torch.infer.pipeline import Segmenter

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the "nhwc" fallback note
        return Segmenter(model["tp"], model["ts"], UNetConfig(base_width=8),
                         InferConfig(img_size=GRID), dtype=torch.float32, device="cpu",
                         int8_calib=model["calib"], **kw)


def test_prepacked_nhwc_trunk_equals_on_the_fly(model, monkeypatch):
    """The "nhwc" trunk on ``prepack_nhwc``'s operands, made once, equals the
    trunk that packs them on every call; the Segmenter's "nhwc" route packs
    nothing per batch."""
    q, imgs = model["q"], _t(_imgs(3))
    pn = tw.prepack_nhwc(q)
    h0, s0 = tw.unet_apply_quantized_features_nhwc(q, imgs)
    h1, s1 = tw.unet_apply_quantized_features_nhwc(q, imgs, pn)
    assert torch.equal(h0, h1) and s0 == s1
    for a, b in zip(tw.unet_apply_quantized_nhwc_rowcol_max(q, imgs),
                    tw.unet_apply_quantized_nhwc_rowcol_max(q, imgs, pn)):
        assert torch.equal(a, b)
    seg = _segmenter(model, int8_wpack="nhwc")
    want = seg.segment_batch(_imgs(3), return_masks=False)

    def no_packing(*args, **kw):
        raise AssertionError("packed per batch")

    for name in ("pack_w_pair_multi", "tile2", "_scaled"):
        monkeypatch.setattr(tw, name, no_packing)
    got = seg.segment_batch(_imgs(3), return_masks=False)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prepacked_logits_head_equals_on_the_fly(model, dtype, monkeypatch):
    """``logits_head`` on ``prepack_head``'s tensors, made once, equals the
    head that makes them on every call, at float32 and bf16; the Segmenter's
    logits routes make none per batch."""
    from twinvoice_tpu_torch.infer import quant as tq

    q, imgs = model["q"], _t(_imgs(4))
    h, s = tq.unet_apply_quantized_features(q, imgs)
    head = tq.prepack_head(q)
    assert torch.equal(tq.logits_head(q, h, s, dtype), tq.logits_head(q, h, s, dtype, head))
    want = tw.unet_apply_quantized_wpack(q, imgs, dtype, "full")
    assert torch.equal(want, tw.unet_apply_quantized_wpack(q, imgs, dtype, "full", head))
    segs = [_segmenter(model), _segmenter(model, int8_wpack="full")]
    wants = [seg.segment_batch(_imgs(4)) for seg in segs]

    def no_head(*args, **kw):
        raise AssertionError("head tensors made per batch")

    monkeypatch.setattr(tq, "_head_tensors", no_head)
    for seg, want in zip(segs, wants):
        for a, b in zip(seg.segment_batch(_imgs(4)), want):
            assert torch.equal(a, b)
