"""The W-phase-packed int8 trunk (``twinvoice_tpu.infer.wpack``).

On the TPU the packing is a lane-geometry trick: two neighbouring output
columns ride in the channels, so a 64-channel conv fills the 128 lanes of the
matrix unit. On the card most of it is a view, and this module maps each JAX
form onto the port's NHWC kernels:

- A phase-B packed tensor ``(B,H,W/2,2C)`` has the bytes of ``(B,H,W,C)``:
  :func:`unpack`, the packed skip, the pack-out upsample's output and
  :func:`max_pool2_packed` are views of what the concat trunk computes.
- ``mode="full"`` and ``"enc"`` compute the concat trunk's bits: the packed
  convs have the same s32 sums (zero taps add 0) and the JAX graph keeps the
  concat graph's epilogue association, ``acc·(s·w)+b`` at enc0 conv2 and
  ``(acc·s_up)·w+b`` at dec0 conv1. So :func:`unet_apply_quantized_features_wpack`
  runs K4a and K6 (``infer.quant``) and returns the phase-B view ("full") or
  the NHWC tensor ("enc"). The packed XLA convs of ``wpack.py`` are here as
  plain float64 functions with their tests (:func:`conv3x3_pack_out_i8`,
  :func:`conv3x3_packed_i8`, :func:`conv_transpose2x2_pack_out_i8`); no card
  path calls them, since in float64 they cost hundreds of ms a batch.
- ``"nhwc"`` runs K7b (``ops.nhwc_conv``) three times: enc0 conv2 A→B, dec0
  conv1 B→A on the channel concat of the packed upsample and skip, dec0 conv2
  A→B. Its dec0 conv1 epilogue is K7b's ``acc·a2+b`` with ``a2 =
  f32(s_up·w_scale)``, the ``acc·(s·w)+b`` association, so "nhwc" is not the
  concat graph's bits even in JAX; each route keeps its own association.
- The box-only heads compute the bias-free row/col maxima of the 1×1 head
  with K2 (``ops.head``) on the NHWC view, its weights in float32 (JAX's
  packed head is a float32 XLA conv; K2's bf16 weights would move the maxima
  by ~1e-3); the logits head is ``infer.quant``'s float32 head on the view.

Kernel layouts are the port's: a 3×3 kernel ``(Co,3,3,Ci)``, a pack-out
kernel ``(2Co,3,4,Ci)``, a packed-in kernel ``(2Co,3,3,2ΣCi)``, a transpose
kernel ``(Co,2,2,Ci)``. The TPU's row tiling ``th`` is not carried over.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from twinvoice_tpu_torch.infer.quant import (
    INPUT_SCALE,
    _concat_stage,
    _halves,
    _q_double_conv,
    _qconv,
    _upsample,
    act_scale,
    logits_head,
    unet_apply_quantized_features,
)
from twinvoice_tpu_torch.ops.head import head_rowcol_max
from twinvoice_tpu_torch.ops.nhwc_conv import (
    from_phase_b,
    pack_w_pair_multi,
    qconv3x3_pair_requant,
    to_phase_a,
)
from twinvoice_tpu_torch.ops.qconv import conv_transpose2x2_i8, max_pool2_i8

MODES = ("full", "enc")


# -- kernel packing ----------------------------------------------------------------


def pack_kernel_out(k):
    """(Co,3,3,Ci) → (2Co,3,4,Ci) for the stride-(1,2) pack-out conv
    (``wpack.py:52``): output phase 0 takes the taps at width offsets 0..2,
    phase 1 at 1..3."""
    co = k.shape[0]
    kp = k.new_zeros((2 * co, 3, 4, k.shape[3]))
    kp[:co, :, 0:3] = k
    kp[co:, :, 1:4] = k
    return kp


def pack_kernel_in_out(blocks):
    """Packed-in/packed-out kernel from one (Co,3,3,Ci) kernel per packed
    source, in channel order → (2Co,3,3,2ΣCi) (``wpack.py:66``): a width-3
    window over pairs, original tap kw at (pair tap, phase)
    do=0: kw0→(0,1) kw1→(1,0) kw2→(1,1); do=1: kw0→(1,0) kw1→(1,1) kw2→(2,0)."""
    co = blocks[0].shape[0]
    ci_tot = sum(k.shape[3] for k in blocks)
    kp = blocks[0].new_zeros((2 * co, 3, 3, 2 * ci_tot))
    ofs = 0
    for k in blocks:
        ci = k.shape[3]
        lo, hi = slice(ofs, ofs + ci), slice(ofs + ci, ofs + 2 * ci)
        kp[:co, :, 0, hi] = k[:, :, 0]
        kp[:co, :, 1, lo] = k[:, :, 1]
        kp[:co, :, 1, hi] = k[:, :, 2]
        kp[co:, :, 1, lo] = k[:, :, 0]
        kp[co:, :, 1, hi] = k[:, :, 1]
        kp[co:, :, 2, lo] = k[:, :, 2]
        ofs += 2 * ci
    return kp


def tile2(v):
    """A per-Co vector → its packed two-phase form ``[v|v]``."""
    return torch.cat([v, v])


# -- the packed XLA forms, plain (float64 sums, exact) ----------------------------


def _nchw64(x):
    return x.permute(0, 3, 1, 2).to(torch.float64)


def conv3x3_pack_out_i8(x, kp):
    """int8 (B,H,W,C) × (2Co,3,4,C) → float64 (B,H,W/2,2Co) exact sums:
    a stride-(1,2) conv with padding 1 (``wpack.py:107``)."""
    y = F.conv2d(_nchw64(x), _nchw64(kp), stride=(1, 2), padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_packed_i8(t, kp):
    """packed int8 (B,H,P,2C) × (2Co,3,3,2C) → float64 (B,H,P,2Co) exact
    sums (``wpack.py:116``)."""
    return F.conv2d(_nchw64(t), _nchw64(kp), padding=1).permute(0, 2, 3, 1)


def conv_transpose2x2_pack_out_i8(x, k):
    """int8 (B,H,W,C) × (Co,2,2,C) → packed float64 (B,2H,W,2Co) exact sums,
    ``packed[n,2i+a,j,b·Co+o] = Σ_c x[n,i,j,c]·K[o,a,b,c]`` (``wpack.py:125``):
    the unpacked transpose conv's sums, viewed as pairs."""
    n, h, w, _ = x.shape
    return conv_transpose2x2_i8(x, k).view(n, 2 * h, w, 2 * k.shape[0])


def max_pool2_packed(t):
    """packed (B,2I,P,2C) → UNPACKED (B,I,P,C) (``wpack.py:147``): the 2×2
    pool of the NHWC view."""
    return max_pool2_i8(unpack(t))


def unpack(t):
    """packed (B,H,P,2C) → (B,H,2P,C), a view (``wpack.py:155``)."""
    b, h, p, c2 = t.shape
    return t.view(b, h, 2 * p, c2 // 2)


def pack(x):
    """NHWC (B,H,W,C) → phase-B packed (B,H,W/2,2C), a view."""
    b, h, w, c = x.shape
    return x.view(b, h, w // 2, 2 * c)


# -- the trunks ---------------------------------------------------------------------


def unet_apply_quantized_features_wpack(q, imgs_u8, mode="full"):
    """uint8 (B,H,W,3) images → (final activations int8, their dequant scale)
    of ``wpack.py:165``: phase-B packed (B,H,W/2,2C) for ``mode="full"``,
    NHWC (B,H,W,C) for ``"enc"``. The bits are the concat trunk's (module
    doc), so it runs K4a and K6 and returns views."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    h, s = unet_apply_quantized_features(q, imgs_u8, concat=True)
    return (pack(h) if mode == "full" else h), s


def _head_input(hp, mode):
    return hp if mode == "enc" else unpack(hp)


def unet_apply_quantized_wpack(q, imgs_u8, logits_dtype=torch.float32, mode="full",
                               head=None):
    """uint8 images → (B,H,W,3) logits in ``logits_dtype`` (``wpack.py:270``):
    the activations unpacked (a view), dequantised in that dtype, then the 1×1
    out conv and its bias (``head``: ``quant.prepack_head``'s tensors)."""
    hp, s = unet_apply_quantized_features_wpack(q, imgs_u8, mode=mode)
    return logits_head(q, _head_input(hp, mode), s, logits_dtype, head)


def unet_apply_quantized_wpack_rowcol_max(q, imgs_u8, mode="full"):
    """uint8 images → (row_max (B,H,3), col_max (B,W,3)) of the *bias-free*
    float32 logits (``wpack.py:285``), through K2 with float32 weights.
    Callers fold ``q["out"]["bias"]`` into their thresholds."""
    hp, s = unet_apply_quantized_features_wpack(q, imgs_u8, mode=mode)
    return head_rowcol_max(_head_input(hp, mode), q["out"]["weight"], s,
                           compute_dtype=torch.float32)


def _scaled(s, w_scale):
    """``tile2(f32(s)·w_scale)``: K7b's ``a2``, one float32 product."""
    return tile2(torch.tensor(np.float32(s), device=w_scale.device) * w_scale)


def _pair_call(qp, blocks, s):
    return {"wp": pack_w_pair_multi(blocks), "a2": _scaled(s, qp["w_scale"]),
            "bias2": tile2(qp["bias"])}


def prepack_nhwc(q):
    """qparams → the operands of the "nhwc" trunk's three K7b calls, made
    once (as ``quant.prepack_pallas`` makes the Pallas trunk's): for enc0
    conv2, dec0 conv1 and dec0 conv2, the packed weights ``wp``, ``a2 =
    tile2(f32(s_in)·w_scale)`` (one float32 product, as JAX's) and ``bias2 =
    tile2(bias)``. Made per batch, the packing is a dozen small kernels a
    call and each ``a2`` a host-to-device copy that the stream waits for."""
    e0, up_q, dec_q = q["enc"][0], q["up"][-1], q["dec"][-1]
    return {
        "enc0_conv2": _pair_call(e0["conv2"], [e0["conv2"]["kernel"]], act_scale(e0["s1"])),
        # per pair: [up(2p) | up(2p+1) | skip(2p) | skip(2p+1)], not one NHWC pixel
        "dec0_conv1": _pair_call(dec_q["conv1"], list(_halves(dec_q["conv1"]["kernel"])),
                                 act_scale(up_q["s_out"])),
        "dec0_conv2": _pair_call(dec_q["conv2"], [dec_q["conv2"]["kernel"]],
                                 act_scale(dec_q["s1"])),
    }


def unet_apply_quantized_features_nhwc(q, imgs_u8, pn=None):
    """uint8 images → (phase-B packed final activations int8 (B,H,W/2,2C),
    their dequant scale) of ``wpack.py:320``: the full-resolution convs are
    K7b, A→B, B→A, A→B; everything else is the concat trunk's kernels.
    ``pn``: :func:`prepack_nhwc`'s operands, made here when not given."""
    pn = prepack_nhwc(q) if pn is None else pn
    xq = (imgs_u8 >> 1).to(torch.int8).contiguous()
    e0 = q["enc"][0]
    h = _qconv(xq, np.float32(INPUT_SCALE), e0["conv1"], e0["s1"])
    hp = qconv3x3_pair_requant(to_phase_a(h), **pn["enc0_conv2"], out_scale=e0["s2"],
                               in_phase="A")  # phase B
    skips = [hp]
    s = act_scale(e0["s2"])
    h = max_pool2_packed(hp)
    for lq in q["enc"][1:]:
        h, s = _q_double_conv(lq, h, s)
        skips.append(h)
        h = max_pool2_i8(h)
    h, s = _q_double_conv(q["bottleneck"], h, s)

    for up_q, dec_q, skip in zip(q["up"][:-1], q["dec"][:-1], reversed(skips[1:])):
        h, s = _concat_stage(up_q, dec_q, h, s, skip)
    up_q, dec_q = q["up"][-1], q["dec"][-1]
    upq = pack(_upsample(up_q, h, s))  # K6's NHWC output read as phase B
    tcat = torch.cat([upq, skips[0]], dim=-1)
    ha = qconv3x3_pair_requant(tcat, **pn["dec0_conv1"], out_scale=dec_q["s1"],
                               in_phase="B")  # phase A
    hp = qconv3x3_pair_requant(ha, **pn["dec0_conv2"], out_scale=dec_q["s2"],
                               in_phase="A")  # phase B
    return hp, act_scale(dec_q["s2"])


def unet_apply_quantized_nhwc_rowcol_max(q, imgs_u8, pn=None):
    """Box-only head on the K7b trunk (``wpack.py:419``): (row_max (B,H,3),
    col_max (B,W,3)) of the *bias-free* float32 logits, through K2 on the
    phase-B view with float32 weights (``pn``: :func:`prepack_nhwc`'s)."""
    hp, s = unet_apply_quantized_features_nhwc(q, imgs_u8, pn)
    return head_rowcol_max(from_phase_b(hp), q["out"]["weight"], s,
                           compute_dtype=torch.float32)
