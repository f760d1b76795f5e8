"""int8 post-training quantization of the BN-folded serving U-Net, and the
int8 forwards (``twinvoice_tpu.infer.quant``).

- calibration: a float32 forward mirroring ``unet_apply_folded`` records each
  conv output's abs-max (TF32 off inside the call: cuDNN's default would move
  the scales by ~1e-3);
- weights: symmetric per-output-channel int8 (scale = absmax/127), computed
  with numpy float32 exactly as the JAX package does, and each skip's requant
  scale harmonised with its paired upsample's (``quant.py:141-145``);
- the trunk: every int8 conv is K4a (``ops.qconv``), the decoder conv1 K4a on
  the concatenated halves or K5 on the two halves, every upsample K6
  (``ops.qupsample``), the pool an exact int8 ``amax``; activations are
  NHWC-contiguous int8 tensors;
- heads: the float32/bf16 1×1 logit conv for K1, or K2 (``ops.head``), or
  the plain head of the Pallas trunk.

The qparams tree (``weights.from_jax_qparams`` carries the JAX one across):
``{"enc": [{"conv1", "conv2", "s1", "s2"}], "bottleneck": {...}, "up":
[{"kernel", "w_scale", "bias", "s_out"}], "dec": [...], "out": {"weight",
"bias"}}`` with each conv ``{"kernel": (Co,3,3,Ci) int8, "w_scale": (Co,),
"bias": (Co,)}`` float32, the upsample kernel (Co,2,2,Ci) int8, the out conv
``weight`` (C,3) float32, and the activation scales as Python floats.

Scalars follow the JAX serving graph, where the qparams are ``jit``
arguments and so float32: ``s = float32(s1) / float32(127)`` and every
product with a scale is one float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from twinvoice_tpu_torch.ops.conv import conv3x3, conv_transpose2x2, max_pool2
from twinvoice_tpu_torch.ops.head import head_rowcol_max, head_rowcol_max_reference
from twinvoice_tpu_torch.ops.image import normalize_uint8
from twinvoice_tpu_torch.ops.qconv import (
    max_pool2_i8,
    qconv3x3_requant,
    qconv3x3_split_requant,
)
from twinvoice_tpu_torch.ops.qupsample import qupsample2x2_requant

# input uint8 [0,255] → int8 [0,127] via >>1: this scale maps it back to the
# [0,1] domain of the float graph (x/255 ≈ q·2/255)
INPUT_SCALE = 2.0 / 255.0


# -- calibration ---------------------------------------------------------------


def _absmax(x):
    return float(x.abs().amax())


def collect_activation_scales(folded, x):
    """Float32 forward over (N,3,H,W) ``x`` mirroring ``unet_apply_folded``,
    recording each conv output's post-ReLU abs-max (the upsample's without a
    ReLU). → the scales tree ``{"enc": [{"c1","c2"}], "bottleneck":
    {"c1","c2"}, "up": [float], "dec": [{"c1","c2"}]}`` of host floats."""
    scales = {"enc": [], "up": [], "dec": []}
    skips = []
    h = x
    for p in folded["enc"]:
        h = torch.relu(conv3x3(h, p["conv1"]))
        s1 = _absmax(h)
        h = torch.relu(conv3x3(h, p["conv2"]))
        scales["enc"].append({"c1": s1, "c2": _absmax(h)})
        skips.append(h)
        h = max_pool2(h)
    bp = folded["bottleneck"]
    h = torch.relu(conv3x3(h, bp["conv1"]))
    s1 = _absmax(h)
    h = torch.relu(conv3x3(h, bp["conv2"]))
    scales["bottleneck"] = {"c1": s1, "c2": _absmax(h)}
    for up_p, dec_p, skip in zip(folded["up"], folded["dec"], reversed(skips)):
        h = conv_transpose2x2(h, up_p)
        scales["up"].append(_absmax(h))
        c = h.shape[1]
        k1 = dec_p["conv1"]["weight"]
        part_up = conv3x3(h, {"weight": k1[:, :c], "bias": dec_p["conv1"]["bias"]})
        part_skip = conv3x3(skip, {"weight": k1[:, c:]})
        h = torch.relu(part_up + part_skip)
        s1 = _absmax(h)
        h = torch.relu(conv3x3(h, dec_p["conv2"]))
        scales["dec"].append({"c1": s1, "c2": _absmax(h)})
    return scales


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def calibrate(folded, batches):
    """Scale collection over uint8 (B,H,W,3) batches (numpy or torch) on the
    device of the float32 ``folded`` tree; keeps the max, floors it at 1e-6.
    TF32 is off inside the call."""
    device = folded["out"]["weight"].device
    acc = None
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True,
                                                            allow_tf32=False):
        for imgs_u8 in batches:
            u8 = torch.as_tensor(imgs_u8, device=device)
            x = normalize_uint8(u8.permute(0, 3, 1, 2), torch.float32)
            s = collect_activation_scales(folded, x)
            acc = s if acc is None else _tree_map(max, acc, s)
    # guard against dead channels, as quant.py:90 does (1e-6 stays a float64)
    return _tree_map(lambda v: float(max(np.float32(v), 1e-6)), acc)


def scales_to_array(scales):
    """The scales tree → float64 (5·depth + 2,): per level enc c1, c2; the
    bottleneck's c1, c2; per level up; per level dec c1, c2. float64 holds
    every scale exactly (a float32 value, or the 1e-6 floor)."""
    vals = [v for e in scales["enc"] for v in (e["c1"], e["c2"])]
    vals += [scales["bottleneck"]["c1"], scales["bottleneck"]["c2"]]
    vals += list(scales["up"])
    vals += [v for d in scales["dec"] for v in (d["c1"], d["c2"])]
    return np.asarray(vals, np.float64)


def scales_from_array(a):
    """Inverse of :func:`scales_to_array`."""
    a = [float(v) for v in np.asarray(a, np.float64)]
    depth = (len(a) - 2) // 5
    enc = [{"c1": a[2 * i], "c2": a[2 * i + 1]} for i in range(depth)]
    o = 2 * depth
    bott = {"c1": a[o], "c2": a[o + 1]}
    up = a[o + 2: o + 2 + depth]
    o += 2 + depth
    dec = [{"c1": a[o + 2 * i], "c2": a[o + 2 * i + 1]} for i in range(depth)]
    return {"enc": enc, "bottleneck": bott, "up": up, "dec": dec}


# -- quantization ----------------------------------------------------------------


def _quant_weights(k_hwio, bias):
    """float32 kernel in the JAX layout (kh,kw,Ci,Co), numpy → JAX-layout
    qparams leaf, the arithmetic of ``quant.py:_quant_weights``."""
    k = np.asarray(k_hwio, np.float32)
    sw = np.maximum(np.abs(k).reshape(-1, k.shape[-1]).max(0), 1e-8) / 127.0
    kq = np.clip(np.round(k / sw), -127, 127).astype(np.int8)
    return {"kernel": kq, "w_scale": np.asarray(sw, np.float32),
            "bias": np.asarray(bias, np.float32)}


def _conv_hwio(p):
    return _quant_weights(p["weight"].cpu().numpy().transpose(2, 3, 1, 0),
                          p["bias"].cpu().numpy())


def quantize_unet(folded, calib_batches=None, *, scales=None):
    """The float32 ``folded`` tree → qparams (module doc) on the folded tree's
    device. ``scales`` (a scales tree) skips the calibration over
    ``calib_batches``."""
    from twinvoice_tpu_torch.weights import from_jax_qparams

    if scales is None:
        scales = calibrate(folded, calib_batches)

    def double(p, s):
        return {"conv1": _conv_hwio(p["conv1"]), "conv2": _conv_hwio(p["conv2"]),
                "s1": s["c1"], "s2": s["c2"]}

    q = {
        "enc": [double(p, s) for p, s in zip(folded["enc"], scales["enc"])],
        "bottleneck": double(folded["bottleneck"], scales["bottleneck"]),
        # (Ci,Co,2,2) → the JAX transpose-conv layout (2,2,Ci,Co)
        "up": [{**_quant_weights(p["weight"].cpu().numpy().transpose(2, 3, 0, 1),
                                 p["bias"].cpu().numpy()), "s_out": s}
               for p, s in zip(folded["up"], scales["up"])],
        "dec": [double(p, s) for p, s in zip(folded["dec"], scales["dec"])],
        "out": {"kernel": folded["out"]["weight"].cpu().numpy().transpose(2, 3, 1, 0),
                "bias": folded["out"]["bias"].cpu().numpy()},
    }
    # one input scale for the decoder conv1: each skip's requant scale becomes
    # the max of its own and its paired upsample's (quant.py:135-145)
    for j, uq in enumerate(q["up"]):
        i = len(q["enc"]) - 1 - j
        common = max(float(q["enc"][i]["s2"]), float(uq["s_out"]))
        q["enc"][i]["s2"] = common
        uq["s_out"] = common
    return from_jax_qparams(q, device=folded["out"]["weight"].device)


# -- the int8 forwards -------------------------------------------------------------


def act_scale(s):
    """An activation's dequant scale ``s/127`` in float32 (``q["s1"]/127.0``
    on a float32 scale)."""
    return np.float32(s) / np.float32(127.0)


def _qconv(x, s_in, qp, out_scale, *, relu=True):
    return qconv3x3_requant(x, qp["kernel"], qp["w_scale"], qp["bias"], s_in,
                            out_scale, relu=relu)


def _q_double_conv(q, x, s_in):
    h = _qconv(x, s_in, q["conv1"], q["s1"])
    h = _qconv(h, act_scale(q["s1"]), q["conv2"], q["s2"])
    return h, act_scale(q["s2"])


def _encoder(q, imgs_u8):
    """The int8 encoder and bottleneck → (h, s, skips); the input goes to int8
    [0,127] as ``imgs >> 1``."""
    h, s = (imgs_u8 >> 1).to(torch.int8).contiguous(), np.float32(INPUT_SCALE)
    skips = []
    for lq in q["enc"]:
        h, s = _q_double_conv(lq, h, s)
        skips.append((h, s))
        h = max_pool2_i8(h)
    h, s = _q_double_conv(q["bottleneck"], h, s)
    return h, s, skips


def _upsample(uq, h, s):
    return qupsample2x2_requant(h, uq["kernel"], uq["w_scale"], uq["bias"], s,
                                uq["s_out"])


def _halves(kernel):
    """A decoder conv1 kernel (Co,3,3,2C) → its upsample and skip halves."""
    c = kernel.shape[-1] // 2
    return kernel[..., :c].contiguous(), kernel[..., c:].contiguous()


def _concat_stage(up_q, dec_q, h, s, skip):
    """One decoder stage of the concat form: K6, then the conv1 as one K4a
    over the concatenated int8 halves, ``(acc·s_up)·w + b``, then conv2.
    → (h, s)."""
    upq = _upsample(up_q, h, s)
    c1 = dec_q["conv1"]
    h = qconv3x3_requant(torch.cat([upq, skip], dim=-1), c1["kernel"], c1["w_scale"],
                         c1["bias"], act_scale(up_q["s_out"]), dec_q["s1"],
                         scale_first=True)
    h = _qconv(h, act_scale(dec_q["s1"]), dec_q["conv2"], dec_q["s2"])
    return h, act_scale(dec_q["s2"])


def unet_apply_quantized_features(q, imgs_u8, concat=True):
    """uint8 (N,H,W,3) images → (final decoder activations (N,H,W,C) int8,
    their dequant scale as a float32 host scalar); ``quant.py:196-248``.

    ``concat=True`` (serving): the decoder conv1 is one K4a over the
    concatenated int8 halves, ``(acc·s_up)·w + b``. ``concat=False``: K5 over
    the two halves, each with its own scale, ``(acc₁·s_up + acc₂·s_skip)·w + b``.
    """
    h, s, skips = _encoder(q, imgs_u8)
    for up_q, dec_q, (skip, s_skip) in zip(q["up"], q["dec"], reversed(skips)):
        if concat:
            h, s = _concat_stage(up_q, dec_q, h, s, skip)
            continue
        upq = _upsample(up_q, h, s)
        c1 = dec_q["conv1"]
        h = qconv3x3_split_requant(upq, skip, *_halves(c1["kernel"]), c1["w_scale"],
                                   c1["bias"], act_scale(up_q["s_out"]), dec_q["s1"],
                                   s_in2=s_skip)
        h = _qconv(h, act_scale(dec_q["s1"]), dec_q["conv2"], dec_q["s2"])
        s = act_scale(dec_q["s2"])
    return h, s


def unet_apply_quantized(q, imgs_u8, concat=True, logits_dtype=torch.float32, head=None):
    """uint8 (N,H,W,3) images → (N,H,W,3) NHWC-contiguous logits in
    ``logits_dtype`` (``quant.py:251-263``): the activations dequantised in
    that dtype, then the 1×1 out conv and its bias in it (``head``: the
    tensors :func:`prepack_head` made once)."""
    h, s = unet_apply_quantized_features(q, imgs_u8, concat=concat)
    return logits_head(q, h, s, logits_dtype, head)


HEAD_DTYPES = (torch.float32, torch.bfloat16)


def _head_tensors(q, s, dtype):
    return (torch.tensor(s, device=q["out"]["weight"].device).to(dtype),
            q["out"]["weight"].to(dtype), q["out"]["bias"].to(dtype))


def prepack_head(q):
    """qparams → the logits head's tensors in each of ``HEAD_DTYPES``, made
    once: the final activations' dequant scale ``act_scale(q["dec"][-1]["s2"])``
    on the device, the 1×1 weight and the bias → {dtype: (scale, weight,
    bias)}. Made per batch, the scale is a host-to-device copy that the
    stream waits for."""
    s = act_scale(q["dec"][-1]["s2"])
    return {dt: _head_tensors(q, s, dt) for dt in HEAD_DTYPES}


def logits_head(q, h, s, logits_dtype=torch.float32, head=None):
    """(N,H,W,C) int8 activations at scale ``s`` → (N,H,W,3) logits: ``h``
    dequantised in ``logits_dtype``, then the 1×1 out conv and its bias.
    ``head`` (:func:`prepack_head`) gives the tensors made once, its scale
    the final activations' ``s``; without it they are made here."""
    scale, w, b = head[logits_dtype] if head is not None else _head_tensors(
        q, s, logits_dtype)
    return h.to(logits_dtype) * scale @ w + b


def unet_apply_quantized_rowcol_max(q, imgs_u8, concat=True):
    """uint8 images → (row_max (N,H,3), col_max (N,W,3)) of the *bias-free*
    logits through K2 (``quant.py:388-396``); the logits are never written.
    Callers fold ``q["out"]["bias"]`` into their thresholds."""
    h, s = unet_apply_quantized_features(q, imgs_u8, concat=concat)
    return head_rowcol_max(h, q["out"]["weight"], s)


def prepack_pallas(q):
    """qparams → the weights of the Pallas-trunk forward (``quant.py:266``):
    each decoder conv1 kernel split into its upsample and skip halves, both
    contiguous. The TPU's GEMM packing and Cin chunking are not needed: the
    kernels read the qparams layout."""
    dec = []
    for dq in q["dec"]:
        up, skip = _halves(dq["conv1"]["kernel"])
        dec.append({"w1_up": up, "w1_skip": skip})
    return {"dec": dec}


def unet_apply_quantized_pallas_rowcol_max(q, pq, imgs_u8):
    """The Pallas-trunk int8 forward (``quant.py:312-385``): the stem and
    every conv K4a, the pool the int8 ``amax``, every upsample K6, every
    decoder conv1 K5 with one shared s32 sum, then the plain head
    (JAX's ``head_rowcol_max_frame``, an XLA einsum: plain torch here, K2's
    plain version). → (row_max (N,H,3), col_max (N,W,3)) of the *bias-free*
    logits."""
    h, s, skips = _encoder(q, imgs_u8)
    for uq, dq, dp, (skip, _) in zip(q["up"], q["dec"], pq["dec"], reversed(skips)):
        h = _upsample(uq, h, s)
        # s_up == s_skip (harmonised), so both halves share one dequant factor
        c1 = dq["conv1"]
        h = qconv3x3_split_requant(h, skip, dp["w1_up"], dp["w1_skip"], c1["w_scale"],
                                   c1["bias"], act_scale(uq["s_out"]), dq["s1"])
        h = _qconv(h, act_scale(dq["s1"]), dq["conv2"], dq["s2"])
        s = act_scale(dq["s2"])
    return head_rowcol_max_reference(h, q["out"]["weight"], s)
